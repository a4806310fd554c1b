"""The port's flagship forward: a sphere-traced depth render over a voxel
SDF, differentiable in the voxel values and the camera pose (the port's
counterpart of ``entry()`` in the repository's ``__graft_entry__.py``)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .core.device import default_device
from .core.grid import GridSpec
from .core.maps import SignedDistanceField
from .ops import edt, render


def _build_scene(counts, resolution: float = 0.25, device=None):
    """A centered sphere of radius ``min(counts) // 4`` voxels, as a locked
    ``SignedDistanceField`` built by the exact EDT on ``device``."""
    spec = GridSpec.from_voxel_counts(resolution, counts)
    cx, cy, cz = [c // 2 for c in counts]
    r = min(counts) // 4
    xs, ys, zs = np.meshgrid(*[np.arange(c) for c in counts], indexing="ij")
    filled = ((xs - cx) ** 2 + (ys - cy) ** 2 + (zs - cz) ** 2) <= r * r
    sdf = edt.extract_signed_distance_field(
        torch.as_tensor(filled, device=default_device(device)), spec, None,
        frame="bench")
    return spec, sdf


def entry(device=None):
    """``(forward, (distances, pose))``: ``forward(distances, pose)``
    renders a 64x64 depth image of a 64^3 sphere SDF in 48 fixed march
    steps; both inputs are differentiable. Runs on ``device``; None means
    the CUDA card."""
    spec, sdf = _build_scene((64, 64, 64), device=device)
    width, height = 64, 64

    center = np.asarray(spec.grid_sizes) / 2.0
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = center + np.array([0.0, 0.0, -1.5 * spec.grid_sizes[2]])
    camera = render.PinholeCamera.create(pose, width, height, focal=64.0,
                                         device=sdf.distances.device)

    def forward(distances: torch.Tensor,
                camera_pose: torch.Tensor) -> torch.Tensor:
        cur_sdf = sdf.replace(distances=distances)
        cur_cam = dataclasses.replace(camera, pose=camera_pose)
        return render.render_depth(cur_sdf, cur_cam, num_steps=48).depth

    return forward, (sdf.distances, camera.pose)
