"""voxelized_geometry_tools_tpu_torch: the PyTorch/CUDA port of
``voxelized_geometry_tools_tpu``.

The package mirrors the JAX package's layout (``core/``, ``ops/``,
``kernels/``) and public names. It imports ``torch`` and numpy and never
``jax``: plain tensor code is PyTorch, and each of the JAX package's Pallas
kernels (the EDT's parabolic-envelope passes: best-first, full sweep,
windowed; the four primitive-rate probes) is a hand-written CUDA kernel for
Hopper (``kernels/csrc/``), built with ``nvcc`` at first use. Every
function runs on the device of its input tensors.

Ported so far (the main path): exact two-field EDT, dense or slab-streamed
(1024^3 on one card), with every envelope backend -> SignedDistanceField
-> corner-brick table -> sphere-traced depth render (the fixed-step march,
differentiable in voxel values and camera pose, and the shipped early-exit
schedule: cone prepass, block-sorted tail, sparse final sample). Then
pointcloud carving and fusion (``ops/voxelize.py``, ``ops/backends.py``:
the hand-written carve kernel ``kernels/csrc/carve.cu`` on the card, the
native C++ runtime in ``native/``) and the pipeline carve -> fuse -> EDT ->
render (``models/fusion_pipeline.reconstruct``), the z-pair corner table,
the pose and voxel fits (``models/fusion_pipeline``, with ``remat``) and
the online mapper (``models/online_mapper.OnlineMapper``). Transform
products take the JAX package's bits (``core/transforms.matmul``, float32
and float64). Then the SDF's other consumers: the mip skip, over-relaxed
and batched renders, ``render_occupancy_image`` and
``depth_to_pointcloud`` (``ops/render.py``); coarse and fine gradients,
the projections out of collision and the local-extrema map
(``ops/sdf_query.py``); the four occupancy map classes with cell access
(``core/maps.py``); float64 fields through the EDT, the maps and every
query.
"""

from .core.grid import GridSpec
from .core.maps import (
    FREE, UNKNOWN, FILLED, OccupancyComponentMap, OccupancyMap,
    SignedDistanceField, TaggedObjectOccupancyComponentMap,
    TaggedObjectOccupancyMap)

__all__ = [
    "GridSpec", "FREE", "UNKNOWN", "FILLED", "OccupancyMap",
    "OccupancyComponentMap", "TaggedObjectOccupancyMap",
    "TaggedObjectOccupancyComponentMap", "SignedDistanceField",
]
