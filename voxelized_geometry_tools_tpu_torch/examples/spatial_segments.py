"""Spatial segmentation example: tagged map -> SDF watershed -> segments.

The port of ``examples/spatial_segments.py``: a tagged-object map with
border walls (object 1) and a center block (object 2) split by empty
cross-channels, segmented by ``update_spatial_segments`` at
connected_threshold=1.75 without and with a virtual border, then
per-(object, segment) display exports. By default the 50x50x25 version of
the reference's 100x100x50 scene (``--full``).
"""

from __future__ import annotations

import time

import numpy as np

from .. import GridSpec, interop
from ..core.maps import _bits
from ..io import viz
from ..ops import map_ops
from ._common import Printer, device_of, parser


def build_scene(nx: int, ny: int, nz: int, device):
    spec = GridSpec.from_voxel_counts(1.0, (nx, ny, nz))
    wall = max(1, nx // 10)
    occ = np.zeros(spec.counts, np.float32)
    obj = np.zeros(spec.counts, np.uint32)
    xs, ys, _ = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                            indexing="ij")
    border = (xs < wall) | (ys < wall) | (xs >= nx - wall) | (ys >= ny - wall)
    occ[border] = 1.0
    obj[border] = 1
    block = ((xs >= int(0.4 * nx)) & (xs < int(0.6 * nx))
             & (ys >= int(0.4 * ny)) & (ys < int(0.6 * ny)))
    occ[block & ~border] = 1.0
    obj[block & ~border] = 2
    channel = (((xs >= int(0.45 * nx)) & (xs < int(0.55 * nx)))
               | ((ys >= int(0.45 * ny)) & (ys < int(0.55 * ny))))
    occ[channel] = 0.0
    obj[channel] = 0
    zeros = np.zeros(spec.counts, np.uint32)
    return interop.tagged_object_occupancy_component_map_from_numpy(
        spec, occ, obj, zeros, zeros, frame="world", device=device)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--full", action="store_true",
                   help="reference-size 100x100x50 grid")
    args = p.parse_args(argv)
    dev = device_of(args)
    out = Printer()
    nx, ny, nz = (100, 100, 50) if args.full else (50, 50, 25)

    tocmap = build_scene(nx, ny, nz, dev)
    env_marker = viz.export_occupancy_for_display(tocmap)
    out(f"Environment display: {env_marker.num_cells} cells")

    connected_threshold = 1.75
    for add_virtual_border in (False, True):
        t0 = time.monotonic()
        tocmap = map_ops.update_spatial_segments(
            tocmap.replace(spatial_segments_valid=False),
            connected_threshold, add_virtual_border=add_virtual_border)
        n_segments = int(_bits(tocmap.number_of_spatial_segments))
        label = ("virtual border" if add_virtual_border else "manual border")
        out(f"Spatial segments ({label}): {n_segments} segments in "
            f"{time.monotonic() - t0:.3f}s")
        seg_marker = viz.export_spatial_segments_for_display(tocmap)
        out(f"  segment display: {seg_marker.num_cells} cells")

        # Per-(object, segment) cell counts.
        seg = _bits(tocmap.spatial_segment).cpu().numpy()
        obj = _bits(tocmap.object_id).cpu().numpy()
        for object_id in range(0, 3):
            for segment in range(1, n_segments + 1):
                count = int(((obj == object_id) & (seg == segment)).sum())
                if count:
                    out(f"  object {object_id} segment {segment}: "
                        f"{count} voxels")
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
