"""The repository's nine examples on the port, each a module run as

    python -m voxelized_geometry_tools_tpu_torch.examples.<name> [--device cpu]

with a ``main(argv=None)`` that returns the lines it printed. ``--device``
None (the default) means the CUDA card.
"""
