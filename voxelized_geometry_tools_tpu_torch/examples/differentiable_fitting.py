"""Flagship demo: mesh -> voxels -> SDF -> differentiable render -> pose fit.

The port of ``examples/differentiable_fitting.py``: rasterize a triangle
mesh into an occupancy grid, extract the EDT SDF, sphere-trace a depth
image, then recover a perturbed camera pose by gradient descent through
the renderer (pixel gradients -> se3 tangent).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..models import fusion_pipeline
from ..ops import edt, mesh, render
from ._common import Printer, device_of, parser


def make_box_mesh(lo, hi):
    """12-triangle axis-aligned box."""
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    corners = np.array([[lo[0], lo[1], lo[2]], [hi[0], lo[1], lo[2]],
                        [hi[0], hi[1], lo[2]], [lo[0], hi[1], lo[2]],
                        [lo[0], lo[1], hi[2]], [hi[0], lo[1], hi[2]],
                        [hi[0], hi[1], hi[2]], [lo[0], hi[1], hi[2]]],
                       np.float32)
    tris = np.array([
        (0, 2, 1), (0, 3, 2), (4, 5, 6), (4, 6, 7),   # bottom, top
        (0, 1, 5), (0, 5, 4), (2, 3, 7), (2, 7, 6),   # front, back
        (1, 2, 6), (1, 6, 5), (3, 0, 4), (3, 4, 7),   # right, left
    ], np.int32)
    return corners, tris


def main(argv=None):
    p = parser(__doc__)
    p.add_argument("--resolution", type=float, default=0.05)
    p.add_argument("--iters", type=int, default=100)
    args = p.parse_args(argv)
    dev = device_of(args)
    out = Printer()

    # Mesh -> occupancy map (auto-sized from the AABB + 1-voxel buffer).
    vertices, triangles = make_box_mesh((0.3, 0.3, 0.3), (1.1, 0.9, 0.7))
    omap = mesh.rasterize_mesh_into_occupancy_map(
        torch.from_numpy(vertices), torch.from_numpy(triangles),
        args.resolution, device=dev)
    filled = int((omap.occupancy > 0.5).sum())
    out(f"Rasterized mesh: {omap.spec.counts} grid, {filled} filled voxels")

    sdf = edt.extract_sdf_from_occupancy(
        omap.occupancy, omap.spec, omap.origin_transform, frame="world")
    mn, mx = sdf.get_minimum_maximum()
    out(f"SDF extrema: [{float(mn):.4f}, {float(mx):.4f}] m")

    # Ground-truth camera looking at the box center.
    center = omap.grid_index_to_location(torch.tensor(
        omap.spec.counts, dtype=torch.int32, device=dev) // 2).cpu().numpy()
    true_pose = np.eye(4, dtype=np.float32)
    true_pose[:3, 3] = center + np.array([0.0, 0.0, -1.6], np.float32)
    camera = render.PinholeCamera.create(true_pose, 96, 72, focal=90.0,
                                         device=dev)
    target = render.render_depth(sdf, camera, num_steps=48)
    out(f"Target render: {int(target.hit.sum())} / {target.hit.numel()} "
        f"pixels hit")

    # Perturb the pose and recover it by descending the depth loss.
    rng = np.random.default_rng(7)
    perturb = torch.tensor(
        np.concatenate([rng.uniform(-0.06, 0.06, 3),
                        rng.uniform(-0.08, 0.08, 3)]), dtype=torch.float32,
        device=dev)
    start_pose = fusion_pipeline.perturb_pose(camera.pose, perturb)
    start_camera = dataclasses.replace(camera, pose=start_pose)

    fit = fusion_pipeline.fit_camera_pose(
        sdf, start_camera, target.depth, num_iters=args.iters,
        num_steps=48)
    losses = fit.losses.cpu().numpy()
    pose_err_before = float(np.abs(start_pose.cpu().numpy()
                                   - true_pose).max())
    pose_err_after = float(np.abs(fit.pose.cpu().numpy() - true_pose).max())
    out(f"Loss: {losses[0]:.6f} -> {losses[-1]:.6f} over {args.iters} iters")
    out(f"Max pose-entry error: {pose_err_before:.4f} -> "
        f"{pose_err_after:.4f}")
    if pose_err_after < pose_err_before * 0.5:
        out("Pose fit CONVERGED (error halved or better)")
    else:
        out("Pose fit did not converge sufficiently")
    out("...done")
    return out.lines


if __name__ == "__main__":
    main()
