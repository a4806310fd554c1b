"""The benchmark of voxelized_geometry_tools_tpu_torch (see README.md)."""
