"""voxelized_geometry_tools_tpu_torch: the PyTorch/CUDA port of
``voxelized_geometry_tools_tpu``.

The package mirrors the JAX package's layout (``core/``, ``ops/``,
``kernels/``) and public names. It imports ``torch`` and numpy and never
``jax``: plain tensor code is PyTorch, and each of the JAX package's Pallas
kernels (the EDT's parabolic-envelope passes: best-first, full sweep,
windowed; the four primitive-rate probes) is a hand-written CUDA kernel for
Hopper (``kernels/csrc/``), built with ``nvcc`` at first use. Every
function runs on the device of its input tensors.

The port covers every module and public name of the JAX package, each
with the same parameters (tests/test_torch_api_parity.py walks both
packages and lists every deliberate difference, such as the ``device``
keyword that entry points making tensors from host data take). In short:
exact two-field EDT, dense or slab-streamed (1024^3 on one card), with
every envelope backend -> SignedDistanceField -> corner-brick table ->
sphere-traced depth render (the fixed-step march, differentiable in voxel
values and camera pose, and the shipped early-exit schedule: cone
prepass, block-sorted tail, sparse final sample). Then pointcloud carving
and fusion (``ops/voxelize.py``, ``ops/backends.py``: the hand-written
carve kernel ``kernels/csrc/carve.cu`` on the card, the native C++ runtime
in ``native/``) and the pipeline carve -> fuse -> EDT -> render
(``models/fusion_pipeline.reconstruct``), the z-pair corner table, the
pose and voxel fits (``models/fusion_pipeline``, with ``remat``) and the
online mapper (``models/online_mapper.OnlineMapper``). Transform products
take the JAX package's bits (``core/transforms.matmul``, float32 and
float64). Then the SDF's other consumers: the mip skip, over-relaxed and
batched renders, ``render_occupancy_image`` and ``depth_to_pointcloud``
(``ops/render.py``); coarse and fine gradients, the projections out of
collision and the local-extrema map (``ops/sdf_query.py``); the four
occupancy map classes with cell access (``core/maps.py``); float64 fields
through the EDT, the maps and every query. Then the geometry and
host-side modules: mesh rasterization (``ops/mesh.py``),
marching-tetrahedra isosurfaces (``ops/isosurface.py``,
``OnlineMapper.extract_mesh``), connected components, surfaces, holes and
voids (``ops/topology.py``), the map methods with spatial segments
(``ops/map_ops.py``), map conversions, serialization and the dynamic
spatial-hashed map (``core/conversions.py``, ``core/serialization.py``,
``core/dsh.py``), messages, PointCloud2 parsing and display exports
(``io/``), and the profiling utilities (``utils/``). Then the sharded
paths on ``torch.distributed`` (``parallel/``: one process a rank, started
by ``parallel/launch.py``) and the repository's examples as modules
(``examples/``).
"""

from .version import __version__

from .core.dsh import (
    DSHGridSizes, DynamicSpatialHashedOccupancyMap, FillStatus, PackedDSHMap)
from .core.grid import GridSpec
from .core.maps import (
    FREE, UNKNOWN, FILLED, OccupancyComponentMap, OccupancyMap,
    SignedDistanceField, TaggedObjectOccupancyComponentMap,
    TaggedObjectOccupancyMap)

__all__ = [
    "__version__", "GridSpec", "FREE", "UNKNOWN", "FILLED", "OccupancyMap",
    "OccupancyComponentMap", "TaggedObjectOccupancyMap",
    "TaggedObjectOccupancyComponentMap", "SignedDistanceField",
    "DSHGridSizes", "DynamicSpatialHashedOccupancyMap", "FillStatus",
    "PackedDSHMap",
]
