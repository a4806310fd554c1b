"""The plain reference the benchmark's check compares the port with.

Plain PyTorch written from the reference library's definitions: a voxel
walk (``carve``), the ``CountsSeenAs`` filter (``fusion``) and an exact
EDT (``edt``). It imports nothing of the port and of the JAX package.
"""
