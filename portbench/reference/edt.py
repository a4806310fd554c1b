"""Plain exact Euclidean distance transform and the two-field signed field.

The squared distance (in voxels) from each voxel to the nearest voxel of a
set is found one axis at a time (Saito and Toriwaki): along x the distance
to the nearest set voxel of the line, then along y and z the least of
``g(j) + (i - j)^2`` over the line, formed here as a minimum over shifted
copies, stopping at the offset ``d`` once ``d^2`` passes every value that
can still fall. Squared distances are whole numbers below ``2^24`` and so
exact in float32; a line with no set voxel stays ``+inf``.

The signed field is ``sqrt(d2 to filled) * res - sqrt(d2 to free) * res``:
negative inside filled space, in metres, each square root correctly
rounded. ``dtype`` is the precision the distances are formed in: float32
as the configuration states, or a lower one for the control.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_CHECK_EVERY = 8


def _nearest_along_first(mask: Tensor, dtype) -> Tensor:
    """Squared distance along axis 0 to the nearest True of each line."""
    n = mask.shape[0]
    shape = (n,) + (1,) * (mask.dim() - 1)
    idx = torch.arange(n, device=mask.device).view(shape)
    big = n * 4
    left = torch.where(mask, idx, -big).cummax(dim=0).values
    right = torch.where(mask, idx, n + big).flip(0).cummin(dim=0).values \
        .flip(0)
    d = torch.minimum(idx - left, right - idx)
    out = (d * d).to(dtype)
    return torch.where(d < big // 2, out,
                       torch.tensor(float("inf"), dtype=dtype,
                                    device=mask.device))


def _envelope(g: Tensor, axis: int) -> Tensor:
    """``out[i] = min_j g[j] + (i - j)^2`` along ``axis``."""
    g = g.movedim(axis, 0).contiguous()
    out = g.clone()
    n = g.shape[0]
    # Lines with no finite value stay +inf whatever the offset.
    reachable = torch.isfinite(g).any(dim=0, keepdim=True).expand_as(g)
    for d in range(1, n):
        if (d - 1) % _CHECK_EVERY == 0:
            top = torch.where(reachable, out, torch.zeros_like(out)).amax()
            if float(top) <= float(d * d):
                break
        dd = torch.tensor(d * d, dtype=g.dtype, device=g.device)
        torch.minimum(out[d:], g[:-d] + dd, out=out[d:])
        torch.minimum(out[:-d], g[d:] + dd, out=out[:-d])
    return out.movedim(0, axis)


def squared_distance(mask: Tensor, dtype=torch.float32) -> Tensor:
    """Squared voxel distance from every voxel to the nearest True."""
    d = _nearest_along_first(mask, dtype)
    for axis in range(1, mask.dim()):
        if mask.shape[axis] > 1:
            d = _envelope(d, axis)
    return d


def _sqrt(x: Tensor) -> Tensor:
    """Correctly rounded float32 square root (float64 and rounded; numpy's
    on the CPU, where PyTorch's is not correctly rounded)."""
    x = x.to(torch.float64)
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy())).float()
    return torch.sqrt(x).float()


def signed_distance(filled: Tensor, resolution: float,
                    dtype=torch.float32) -> Tensor:
    """float32 signed distance in metres of a filled mask."""
    res = torch.tensor(resolution, dtype=torch.float32, device=filled.device)
    to_filled = _sqrt(squared_distance(filled, dtype)) * res
    to_free = _sqrt(squared_distance(~filled, dtype)) * res
    return to_filled - to_free


def filled_from_occupancy(occupancy: Tensor,
                          unknown_is_filled: bool = True) -> Tensor:
    """Filled where the occupancy is above 0.5, and at 0.5 (unknown) when
    unknown space counts as filled."""
    filled = occupancy > 0.5
    if unknown_is_filled:
        filled = filled | (occupancy == 0.5)
    return filled
