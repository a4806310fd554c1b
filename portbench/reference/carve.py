"""Plain voxel carving of one depth cloud: a walk from the camera's voxel
to the point's voxel, as the reference library's ``DoRaycastPointCloud``
defines it.

Each ray is walked voxel by voxel (Amanatides and Woo): at each step the
axis whose next voxel boundary lies nearest along the ray is crossed, ties
going to x, then y, then z, with the crossing times in closed form
(``t0 + k * dt``). Every voxel passed before the end voxel counts one in
``seen_free``; the walk also stops when the axis it is about to cross has
already reached the end voxel's coordinate. The end voxel counts one in
``seen_filled`` for a point within range, and one in ``seen_free`` for a
ray clipped at the range. Rays here start inside the grid, whose origin is
the world's.

``dtype`` is the precision of the ray geometry: float32 as the
configuration states, or a lower one for the control.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

_COMPACT_EVERY = 32


def _add(grid: Tensor, flat: Tensor) -> None:
    if flat.numel():
        grid.index_put_((flat.long(),),
                        torch.ones_like(flat, dtype=grid.dtype),
                        accumulate=True)


def carve(counts, resolution: float, pose: Tensor, points: Tensor,
          max_range: float, dtype=torch.float32):
    """``(seen_free, seen_filled)`` int32 ``counts`` grids of one cloud:
    ``points`` ``[N, 3]`` in the camera frame, ``pose`` its float32
    ``X_WC``."""
    dev = points.device
    nx, ny, nz = counts
    X = pose.to(device=dev, dtype=torch.float64)
    p = (points.double() @ X[:3, :3].T + X[:3, 3]).to(dtype)
    o = X[:3, 3].to(dtype)
    res = torch.tensor(resolution, dtype=dtype, device=dev)
    ray = p - o
    length = ray.double().norm(dim=-1).to(dtype)
    clipped = length > max_range
    scale = (torch.tensor(max_range, dtype=dtype, device=dev)
             / torch.clamp(length, min=1e-30))
    end = torch.where(clipped[:, None], o + ray * scale[:, None], p)
    start = torch.floor(o / res).to(torch.int64)
    final = torch.floor(end / res).to(torch.int64)
    if not bool(((start >= 0) & (start < torch.tensor(
            counts, device=dev))).all()):
        raise ValueError("the reference carve takes cameras inside the grid")
    size = torch.tensor(counts, device=dev)
    strides = torch.tensor([ny * nz, nz, 1], device=dev)
    free = torch.zeros(nx * ny * nz, dtype=torch.int32, device=dev)
    filled = torch.zeros_like(free)

    end_in = ((final >= 0) & (final < size)).all(dim=-1)
    end_flat = (final * strides).sum(-1)
    _add(filled, end_flat[end_in & ~clipped])
    _add(free, end_flat[end_in & clipped])

    step = torch.sign(final - start)
    half = res / 2
    center = (start.to(dtype) + 0.5) * res
    inf = torch.tensor(float("inf"), dtype=dtype, device=dev)
    t0 = torch.where(ray > 0, ((center + half) - o).div(ray).abs(),
                     torch.where(ray < 0, (o - (center - half)).div(ray)
                                 .abs(), inf))
    dt = torch.where(ray != 0, (res / ray).abs(),
                     torch.zeros((), dtype=dtype, device=dev))
    cell = start.expand_as(final).clone()
    k = torch.zeros_like(final)
    live = torch.ones(final.shape[0], dtype=torch.bool, device=dev)
    axis_rank = torch.arange(3, device=dev)
    steps = 0
    while True:
        if steps % _COMPACT_EVERY == 0:
            keep = live.nonzero().squeeze(1)
            if keep.numel() == 0:
                break
            cell, final, step, t0, dt, k, live = (
                v[keep] for v in (cell, final, step, t0, dt, k, live))
        steps += 1
        inside = ((cell >= 0) & (cell < size)).all(dim=-1)
        live = live & (cell != final).any(dim=-1) & inside
        _add(free, (cell * strides).sum(-1)[live])
        t = t0 + k.to(dtype) * dt
        # The smallest crossing time; among equal ones the lowest axis.
        tmin = t.amin(dim=-1, keepdim=True)
        axis = torch.where(t == tmin, axis_rank, 3).amin(dim=-1)
        pick = axis[:, None] == axis_rank
        live = live & ~(pick & (cell == final)).any(dim=-1)
        move = pick & live[:, None]
        cell = cell + step * move
        k = k + move
    return free.view(counts), filled.view(counts)
