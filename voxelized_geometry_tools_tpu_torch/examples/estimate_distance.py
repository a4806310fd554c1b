"""Estimate-distance example: rotated grid, trilinear queries, fine gradients.

The port of ``examples/estimate_distance.py``: a 10x10x1 m grid rotated 45
deg about Z with a scattering of filled cells, SDF extraction, then
``EstimateLocationDistance`` queries over every cell center and over
subsampled points, and ``GetLocationFineGradient`` at every cell center,
each batched in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import GridSpec, OccupancyMap
from ..core import transforms
from ..io import viz
from ..ops import edt, sdf_query
from ._common import Printer, device_of, parser


def make_origin() -> np.ndarray:
    angle = np.pi / 4.0
    origin = np.eye(4, dtype=np.float32)
    origin[0, 0] = np.cos(angle)
    origin[0, 1] = -np.sin(angle)
    origin[1, 0] = np.sin(angle)
    origin[1, 1] = np.cos(angle)
    return origin


FILLED_LOCATIONS_GRID = [
    (5.0, 5.0, 0.0), (5.0, 6.0, 0.0), (6.0, 5.0, 0.0), (6.0, 6.0, 0.0),
    (7.0, 7.0, 0.0), (2.0, 2.0, 0.0), (3.0, 2.0, 0.0), (4.0, 2.0, 0.0),
    (2.0, 3.0, 0.0), (2.0, 4.0, 0.0), (2.0, 7.0, 0.0),
]  # grid-frame locations


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    out = Printer()

    resolution = 1.0
    spec = GridSpec.from_grid_sizes(resolution, (10.0, 10.0, 1.0))
    omap = OccupancyMap.create(spec, make_origin(), "world", device=dev)

    occ = np.zeros(spec.counts, np.float32)
    for p_grid in FILLED_LOCATIONS_GRID:
        idx = np.floor(np.asarray(p_grid) / resolution).astype(int)
        occ[tuple(idx)] = 1.0
    omap = omap.replace(occupancy=torch.from_numpy(occ).to(dev))

    sdf = edt.extract_sdf_from_occupancy(
        omap.occupancy, spec, omap.origin_transform, frame="world",
        oob_value=1e6, unknown_is_filled=True, add_virtual_border=False)
    sdf_marker = viz.export_sdf_for_display(sdf, alpha=0.05)
    out(f"SDF display: {sdf_marker.num_cells} cells")

    # Distance estimates over every cell center, one batch.
    n = spec.num_total
    all_indices = sdf.spec.unflatten_index(
        torch.arange(n, dtype=torch.int32, device=dev))
    centers = sdf.grid_index_to_location(all_indices)
    q = sdf_query.estimate_location_distance(sdf, centers)
    out(f"Estimated distance at {n} cell centers: "
        f"min {float(torch.nan_to_num(q.value, nan=np.inf).min()):.4f}, "
        f"max {float(torch.nan_to_num(q.value, nan=-np.inf).max()):.4f}")

    # Subsampled interior points: 4 per axis per cell.
    offsets = (np.arange(4) + 0.5) / 4.0 - 0.5  # within-cell offsets
    ox, oy, oz = np.meshgrid(offsets, offsets, [0.0], indexing="ij")
    sub = np.stack([ox, oy, oz], axis=-1).reshape(-1, 3) * resolution
    pts = centers[:, None, :] + torch.tensor(sub, dtype=torch.float32,
                                             device=dev)[None, :, :]
    q_sub = sdf_query.estimate_location_distance(sdf, pts)
    out(f"Subsampled queries: {int(q_sub.valid.sum())} valid of "
        f"{q_sub.value.numel()}")

    # Fine gradients at every cell center.
    g = sdf_query.get_location_fine_gradient(
        sdf, centers, nominal_window_size=resolution * 0.125)
    grad = torch.where(g.valid[..., None], g.gradient,
                       torch.zeros_like(g.gradient))
    norms = torch.sqrt((grad * grad).sum(dim=-1))
    out(f"Fine gradients: {int(g.valid.sum())} valid, "
        f"mean |grad| {float(norms.sum() / g.valid.sum()):.4f}")

    # A world-frame query point: the transform round trip.
    p_grid = torch.tensor([5.5, 5.5, 0.5], dtype=torch.float32, device=dev)
    p_world = transforms.apply_isometry(sdf.origin_transform, p_grid)
    q_world = sdf_query.estimate_location_distance(sdf, p_world)
    out(f"Query at grid (5.5,5.5,0.5) -> world {p_world.cpu().numpy()}: "
        f"distance {float(q_world.value):.4f} (inside the 2x2 block: "
        f"negative expected)")
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
