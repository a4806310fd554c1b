"""Multi-rank sharded pipeline: carve -> fuse -> EDT -> render over a world.

The port of ``examples/sharded_pipeline.py``, on ``torch.distributed``
(``parallel/``): a world of ``--world-size`` rank processes
(:mod:`..parallel.launch`) in which

* rays are cut over the ranks for the carve, each camera's counters
  reduce-scattered into Z slabs (``sharded_voxelize_pointclouds``),
* the grid is cut into Z slabs for the EDT, the Z pass transposed through
  an all-to-all (``sharded_extract_sdf``), and compared with the
  single-device EDT,
* pixel rows are cut over the ranks for the render
  (``sharded_render_depth``),
* and the grid is cut into X slabs for the grid-sharded render
  (``sharded_render_depth_grid_sharded``), compared with the pixel rows.

``--world-size`` defaults to the number of cards with NCCL (one card a
rank); ``--backend gloo`` runs several ranks on one card (each collective
staged through host memory) or, with ``--device cpu``, on the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import GridSpec
from ..core import transforms
from ..ops import edt
from ..parallel import launch, targets
from ..parallel.mesh_utils import P
from ._common import Printer, device_of, parser

SLABS = P(None, None, "z")


def _scene():
    """A box room's floor observed by two depth cameras: the grid, its
    origin and the clouds ``(points, pose, max_range)``."""
    spec = GridSpec.from_voxel_counts(0.125, (32, 32, 16))
    origin = transforms.np_isometry_from_translation((-2.0, -2.0, 0.0))
    u, v = np.meshgrid(np.linspace(-0.6, 0.6, 64),
                       np.linspace(-0.45, 0.45, 48), indexing="ij")
    depth = 2.0 + 0.3 * np.exp(-((u / 0.2) ** 2 + (v / 0.2) ** 2))
    pts = np.stack([u * depth, v * depth, depth],
                   -1).reshape(-1, 3).astype(np.float32)
    pose1 = np.eye(4, dtype=np.float32)
    pose1[:3, 3] = (0.0, 0.0, 1.0)
    pose2 = np.eye(4, dtype=np.float32)
    pose2[:3, :3] = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)
    pose2[:3, 3] = (-1.8, 0.0, 1.0)
    inf = float("inf")
    return spec, origin, [(pts, pose1, inf), (pts, pose2, inf)]


def _camera():
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, 3.5)
    pose[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]], np.float32)
    return {"pose": pose, "width": 64, "height": 48, "fx": 60.0, "fy": 60.0,
            "cx": 31.5, "cy": 23.5}


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--world-size", type=int, default=None,
                   help="ranks (default: the number of cards; 2 on the CPU)")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                   help="default: nccl on the card, gloo on the CPU")
    args = p.parse_args(argv)
    dev = device_of(args)
    out = Printer()
    kind = dev.type
    n = args.world_size or (torch.cuda.device_count() if kind == "cuda"
                            else 2)
    backend = args.backend or ("nccl" if kind == "cuda" else "gloo")

    spec, origin, clouds = _scene()
    occ0 = np.zeros(spec.counts, np.float32)
    camera = _camera()
    with launch.World(n, backend, kind) as world:
        out(f"world: {n} ranks; {world.descriptions[0]}")

        # 1. Ray-sharded carving + fusion into Z slabs.
        occ = world.run(targets.voxelize_pointclouds, spec, origin, occ0,
                        (1.0, 1, 1), clouds, run_axis=2,
                        out_specs=SLABS if spec.counts[2] % n == 0 else P())
        out(f"carved over {n} ray shards: {int((occ == 1.0).sum())} filled "
            f"/ {int((occ == 0.0).sum())} free / {int((occ == 0.5).sum())} "
            f"unknown")

        # 2. Z-slab-sharded EDT against the single-device EDT.
        dist, _, _ = world.run(targets.extract_sdf, occ, spec, origin,
                               in_specs=(SLABS, None, None),
                               out_specs=(SLABS, P(), P()), frame="world")
        single = edt.extract_sdf_from_occupancy(
            torch.from_numpy(occ).to(dev), spec, origin)
        same = bool(np.array_equal(dist, single.distances.cpu().numpy()))
        out(f"sharded EDT == single-device EDT: {same}")

        # 3. Pixel rows over the ranks.
        depth_img = world.run(targets.render_pixels, dist, spec, origin,
                              camera, out_specs=P("z"), num_steps=48)
        hits = depth_img < 99.0
        out(f"rendered {int(hits.sum())} / {hits.size} hit pixels over "
            f"{n} pixel shards")

        # 4. The GRID in X slabs (perpendicular to this camera, which
        # looks along -z), rays on every rank: the same depths for any
        # schedule.
        depth_gs, phases = world.run(
            targets.render_grid, dist, spec, origin, camera,
            in_specs=(P("z"), None, None, None), out_specs=(P(), P()),
            grid_axis=0, num_steps=48, steps_per_exchange=32, ray_chunks=16)
        same_render = bool(np.allclose(depth_img, depth_gs, atol=1e-4))
        out(f"grid-sharded render == pixel-sharded render: {same_render} "
            f"({int(phases)} phases)")
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
