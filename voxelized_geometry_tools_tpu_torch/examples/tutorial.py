"""Tutorial: occupancy map -> connected components -> SDF -> queries.

The port of ``examples/tutorial.py``: a 10 m^3 quarter-filled
OccupancyComponentMap centered at the origin, its connected components, a
signed distance field, and index/location distance and gradient queries;
display output goes to VoxelMarker summaries.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from .. import GridSpec, OccupancyComponentMap
from ..core.maps import _bits
from ..io import viz
from ..ops import map_ops, sdf_query
from ._common import Printer, device_of, parser


def main(argv=None):
    args = parser(__doc__).parse_args(argv)
    dev = device_of(args)
    out = Printer()

    resolution = 0.25
    spec = GridSpec.from_grid_sizes(resolution, (10.0, 10.0, 10.0))
    origin = np.eye(4, dtype=np.float32)
    origin[:3, 3] = (-5.0, -5.0, -5.0)  # center the grid around the origin
    omap = OccupancyComponentMap.create(spec, origin, "tutorial_frame",
                                        device=dev)

    # Fill the bottom corner (low x, low y, low z) as an obstacle.
    occ = np.zeros(spec.counts, np.float32)
    nx, ny, nz = spec.counts
    occ[: nx // 2, : ny // 2, : nz // 2] = 1.0
    omap = omap.set_occupancy(torch.from_numpy(occ).to(dev))

    # Query by index and by location.
    idx_val = float(omap.occupancy[10, 10, 10])
    out(f"Index query result - stored value {idx_val} (occupancy)")
    loc_index = omap.location_to_grid_index(
        torch.tensor([0.0, 0.0, 0.0], device=dev)).tolist()
    loc_val = float(omap.occupancy[tuple(loc_index)])
    out(f"Location query result - stored value {loc_val} (occupancy)")

    # Connected components.
    t0 = time.monotonic()
    omap = map_ops.update_connected_components(omap)
    n_components = int(_bits(omap.number_of_components))
    out(f"Connected components took {time.monotonic() - t0:.4f} seconds")
    out(f"There are {n_components} connected components")

    # Display exports: marker payload summaries.
    occ_marker = viz.export_occupancy_for_display(omap)
    cc_marker = viz.export_connected_components_for_display(omap)
    out(f"Occupancy display: {occ_marker.num_cells} cells; "
        f"components display: {cc_marker.num_cells} cells")

    # SDF generation.
    t0 = time.monotonic()
    sdf = map_ops.extract_signed_distance_field(omap)
    mn, mx = sdf.get_minimum_maximum()
    out(f"SDF generation took {time.monotonic() - t0:.4f} seconds")
    out(f"Maximum distance in the SDF: {float(mx):.6f}")
    out(f"Minimum distance in the SDF: {float(mn):.6f}")

    # Distance + gradient queries.
    q_index = sdf_query.estimate_index_distance(
        sdf, torch.tensor([10, 10, 10], device=dev))
    out(f"Index query result - estimated distance {float(q_index.value):.6f}"
        f" (valid: {bool(q_index.valid)})")
    q_loc = sdf_query.estimate_location_distance(
        sdf, torch.tensor([0.0, 0.0, 0.0], device=dev))
    out(f"Location query result - estimated distance "
        f"{float(q_loc.value):.6f} (valid: {bool(q_loc.valid)})")
    g_index = sdf_query.get_index_coarse_gradient(
        sdf, torch.tensor([10, 10, 10], device=dev),
        enable_edge_gradients=True)
    out(f"Index gradient query result - gradient "
        f"{g_index.gradient.cpu().numpy()}")
    g_loc = sdf_query.get_location_coarse_gradient(
        sdf, torch.tensor([0.0, 0.0, 0.0], device=dev),
        enable_edge_gradients=True)
    out(f"Location gradient query result - gradient "
        f"{g_loc.gradient.cpu().numpy()}")
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
