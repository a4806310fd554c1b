"""The ``CountsSeenAs`` fusion filter of the reference library, per voxel.

For each camera a voxel is seen as filled, free or unknown from its two
counters: hits below ``outlier_points_threshold`` are ignored; a voxel
with both free passes and hits is free when the free share reaches
``percent_seen_free``, else filled. Over the cameras, a voxel that any
camera saw filled becomes 1.0, one that at least
``num_cameras_seen_free`` cameras saw free becomes 0.0, any other 0.5.
Voxels already filled in the running map (above 0.5) keep their value.
"""

from __future__ import annotations

import torch

Tensor = torch.Tensor

UNKNOWN, FILLED, FREE = 0, 1, 2


def seen_as(options: dict, free: Tensor, filled: Tensor) -> Tensor:
    hits = torch.where(filled >= options["outlier_points_threshold"],
                       filled, torch.zeros_like(filled))
    share = free.double() / (free + hits).clamp(min=1).double()
    both = torch.where(share >= options["percent_seen_free"], FREE, FILLED)
    return torch.where((free > 0) & (hits > 0), both,
                       torch.where(free > 0, FREE,
                                   torch.where(hits > 0, FILLED, UNKNOWN)))


def fuse(options: dict, frees, filleds, occupancy: Tensor) -> Tensor:
    """New float32 occupancy from per-camera counter grids and the running
    occupancy."""
    n_filled = torch.zeros(occupancy.shape, dtype=torch.int32,
                           device=occupancy.device)
    n_free = torch.zeros_like(n_filled)
    for free, filled in zip(frees, filleds):
        s = seen_as(options, free, filled)
        n_filled += s == FILLED
        n_free += s == FREE
    fused = torch.where(
        n_filled > 0, 1.0,
        torch.where(n_free >= options["num_cameras_seen_free"], 0.0, 0.5))
    return torch.where(occupancy > 0.5, occupancy,
                       fused.to(occupancy.dtype))
