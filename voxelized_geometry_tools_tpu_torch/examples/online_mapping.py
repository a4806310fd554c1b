"""Online mapping example: streaming depth frames -> live map -> queries.

The port of ``examples/online_mapping.py``: a robot-style loop where depth
frames of an orbiting camera around a box arrive one at a time, each
carved into the running occupancy map (``models/online_mapper.py``), then
the same frames integrated in one call (the recorded-log path), and the
final map's SDF queried and rendered from a novel view.
"""

from __future__ import annotations

import time

import numpy as np

from .. import GridSpec
from ..models.online_mapper import OnlineMapper
from ..ops import render, sdf_query, voxelize
from ._common import Printer, device_of, parser


def synth_frame(angle: float, device, width=96, height=72):
    """Depth camera on a circle of radius 2 m looking at the box at the
    grid center (camera-frame points + X_WC pose)."""
    center = np.array([1.2, 1.2, 0.6])
    eye = center + np.array([2.0 * np.cos(angle), 2.0 * np.sin(angle), 0.6])
    fwd = center - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, [0.0, 0.0, 1.0])
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2], pose[:3, 3] = right, down, fwd, eye

    # Analytic depth of the box [0.8,1.6]x[0.8,1.6]x[0.2,1.0] by slab
    # ray-box intersection per pixel; misses clip at max_range.
    u = (np.arange(width) - width / 2) / (0.8 * width)
    v = (np.arange(height) - height / 2) / (0.8 * height)
    uu, vv = np.meshgrid(u, v, indexing="xy")
    dirs_cam = np.stack([uu, vv, np.ones_like(uu)], -1)
    dirs_cam /= np.linalg.norm(dirs_cam, axis=-1, keepdims=True)
    dirs = dirs_cam @ pose[:3, :3].T
    lo, hi = np.array([0.8, 0.8, 0.2]), np.array([1.6, 1.6, 1.0])
    safe = np.where(np.abs(dirs) < 1e-9, 1e-9, dirs)
    t1 = (lo - eye) / safe
    t2 = (hi - eye) / safe
    t_enter = np.minimum(t1, t2).max(-1)
    t_exit = np.maximum(t1, t2).min(-1)
    hit = (t_exit > np.maximum(t_enter, 0.0))
    depth = np.where(hit, t_enter, 4.0)
    pts_cam = dirs_cam * depth[..., None]
    return voxelize.PointCloud.create(
        pts_cam.reshape(-1, 3).astype(np.float32), pose, max_range=3.5,
        device=device)


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--frames", type=int, default=8)
    args = p.parse_args(argv)
    dev = device_of(args)
    out = Printer()

    spec = GridSpec.from_voxel_counts(0.05, (48, 48, 32))
    mapper = OnlineMapper(spec, frame="world", device=dev)

    angles = np.linspace(0, 2 * np.pi, args.frames, endpoint=False)
    t0 = time.monotonic()
    for i, a in enumerate(angles):
        mapper.integrate(synth_frame(a, dev))
        occ = mapper.occupancy_map.occupancy
        out(f"frame {i}: filled={int((occ > 0.5).sum())} "
            f"free={int((occ < 0.5).sum())}")
    out(f"streamed {args.frames} frames in "
        f"{time.monotonic() - t0:.2f} s (incl. first-frame compile)")

    # The same frames in one call (the recorded-log replay path).
    replay = OnlineMapper(spec, frame="world", device=dev)
    replay.integrate_frames([synth_frame(a, dev) for a in angles])
    same = bool((replay.occupancy_map.occupancy
                 == mapper.occupancy_map.occupancy).all())
    out(f"scan-fold replay matches streaming integration: {same}")

    # Live SDF queries + a novel rendered view from the final map.
    sdf = mapper.sdf()
    q = sdf_query.estimate_location_distance(
        sdf, sdf.distances.new_tensor([[1.2, 1.2, 0.6], [0.2, 0.2, 1.4]]))
    out(f"SDF at box center: {float(q.value[0]):+.3f} m, "
        f"never-observed corner (unknown=filled): {float(q.value[1]):+.3f} m")

    table = sdf_query.build_corner_table(sdf)
    novel_pose = np.eye(4, dtype=np.float32)
    novel_pose[:3, 3] = (1.2, 1.2, 3.0)
    novel_pose[:3, :3] = np.array([[1, 0, 0], [0, -1, 0], [0, 0, -1]],
                                  np.float32)  # looking straight down
    cam = render.PinholeCamera.create(novel_pose, 64, 64, focal=64.0,
                                      device=dev)
    result = mapper.render_depth(cam, num_steps=48, corner_table=table,
                                 early_exit=True)
    hits = int(result.hit.sum())
    out(f"novel top-down view: {hits}/{64 * 64} pixels hit the map")
    if hits == 0:
        raise AssertionError("the novel view hit nothing")
    out("OK")
    return out.lines


if __name__ == "__main__":
    main()
