"""Isosurface export: occupancy -> SDF -> triangle mesh -> OBJ file.

The port of ``examples/isosurface_export.py``: extract the zero level set
of a signed distance field as a watertight triangle mesh (marching
tetrahedra, ``ops/isosurface.py``), pack it as a TRIANGLE_LIST display
marker, weld it into an indexed mesh, write a Wavefront OBJ, and
rasterize the mesh back into a map (``ops/mesh.py``).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import GridSpec, OccupancyMap
from ..io import viz
from ..ops import edt, isosurface, mesh
from ._common import Printer, device_of, parser


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("output", nargs="?", default=None,
                   help="OBJ path (default: vgt_isosurface.obj in the "
                        "temporary directory)")
    args = p.parse_args(argv)
    dev = device_of(args)
    out = Printer()

    # A 5 m^3 grid with a 2 m box and a sphere poking out of its top.
    resolution = 0.125
    spec = GridSpec.from_grid_sizes(resolution, (5.0, 5.0, 5.0))
    omap = OccupancyMap.create(spec, frame="world", device=dev)
    occ = np.zeros(spec.counts, np.float32)
    occ[8:24, 8:24, 8:24] = 1.0
    ii = np.arange(spec.num_x)
    r2 = ((ii[:, None, None] - 16) ** 2 + (ii[None, :, None] - 16) ** 2
          + (ii[None, None, :] - 28) ** 2)
    occ[r2 <= 64] = 1.0
    omap = omap.replace(occupancy=torch.from_numpy(occ).to(dev))

    sdf = edt.extract_sdf_from_occupancy(
        omap.occupancy, spec, omap.origin_transform, frame="world")

    # Extract the zero level set (capacity is fixed).
    m = isosurface.extract_isosurface(sdf, max_triangles=1 << 15)
    out(f"extracted {int(m.num_triangles)} triangles "
        f"(overflowed={bool(m.overflowed)})")

    # Display marker (the TRIANGLE_LIST analogue of the CUBE_LIST export).
    marker = viz.export_isosurface_for_display(m, "world")
    out(f"TRIANGLE_LIST marker: {marker.num_triangles} triangles, "
        f"{marker.points.shape[0]} points")

    # Welded OBJ export.
    path = args.output or os.path.join(tempfile.gettempdir(),
                                       "vgt_isosurface.obj")
    n_faces = isosurface.save_obj(path, m)
    verts, faces = isosurface.weld_vertices(m)
    out(f"wrote {path}: {len(verts)} vertices, {n_faces} faces")

    # Round trip: rasterizing the mesh back marks the SDF's surface shell.
    omap2 = OccupancyMap.create(spec, frame="world", device=dev)
    back = mesh.rasterize_mesh(
        omap2, marker.points,
        np.arange(marker.points.shape[0]).reshape(-1, 3))
    marked = back.occupancy.cpu().numpy() > 0.5
    d = sdf.distances.cpu().numpy()
    # Voxelized-EDT boundary cells sit at exactly +-1 voxel of distance.
    near = np.abs(d) <= 1.0 * resolution
    if not near.any():
        raise AssertionError("no surface shell")
    out(f"round trip: {int(marked.sum())} voxels marked; surface-shell "
        f"coverage {float(marked[near].mean()):.3f} over {int(near.sum())}"
        " shell voxels")
    return out.lines


if __name__ == "__main__":
    main()
