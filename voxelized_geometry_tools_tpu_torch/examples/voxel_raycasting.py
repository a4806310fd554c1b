"""Voxel raycasting example: random DDA rays + count invariants.

The port of ``examples/voxel_raycasting.py``: random origin/target pairs
raycast through a 40^3 grid at 0.125 m resolution with max_range 10,
checking the DDA invariants (each voxel counted at most once free, at most
once filled, never both) and exporting a colored marker of the traversed
voxels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import GridSpec
from ..io import viz
from ..ops import voxelize
from ._common import Printer, device_of, parser


def _color(f, fl):
    rgba = np.zeros(f.shape + (4,), np.float32)
    rgba[(f > 0)] = (0.0, 0.0, 1.0, 0.5)
    rgba[(fl > 0)] = (1.0, 0.0, 0.0, 0.5)
    rgba[(f > 0) & (fl > 0)] = (1.0, 0.0, 1.0, 0.5)
    return rgba


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--iterations", type=int, default=100)
    args = p.parse_args(argv)
    dev = device_of(args)
    out = Printer()

    resolution = 0.125
    spec = GridSpec.from_voxel_counts(resolution, (40, 40, 40))
    origin_transform = torch.eye(4, dtype=torch.float32, device=dev)
    max_range = 10.0
    rng = np.random.default_rng(42)

    warned = 0
    total_free = 0
    total_filled = 0
    last_marker = None
    for it in range(args.iterations):
        origin, point = rng.uniform(-2.0, 7.0, size=(2, 3))
        free, filled = voxelize.raycast_single_point(
            spec, origin_transform,
            torch.tensor(origin, dtype=torch.float32, device=dev),
            torch.tensor(point, dtype=torch.float32, device=dev), max_range)
        free = free.cpu().numpy()
        filled = filled.cpu().numpy()
        # The count invariants (each voxel once, never both).
        if (free > 1).any() or (filled > 1).any() or \
                ((free > 0) & (filled > 0)).any():
            warned += 1
            out(f"WARNING: iteration {it} violated raycast invariants")
        total_free += int(free.sum())
        total_filled += int(filled.sum())
        last_marker = viz.export_voxel_grid(
            spec, origin_transform, "world", _color, free, filled)

    out(f"{args.iterations} raycast cycles: {total_free} voxels seen free, "
        f"{total_filled} seen filled, {warned} invariant warnings")
    if last_marker is not None:
        out(f"Last-ray display: {last_marker.num_cells} cells")
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
