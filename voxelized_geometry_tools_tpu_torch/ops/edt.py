"""Exact 3-D Euclidean distance transform + signed-distance-field generation.

Port of ``voxelized_geometry_tools_tpu/ops/edt.py`` (the dense path). The
math is the JAX package's:

* **Pass 1** (axis 0, binary seed field): squared distance to the nearest
  seed from two ``cummax`` prefix scans, O(n).
* **Passes 2 and 3** (axes 1 and 2, general ``f``): the exact min-plus
  ``d[q] = min_k (q-k)^2 + f[k]``. On a CUDA tensor ``backend="auto"``
  launches the best-first CUDA kernel
  (:mod:`..kernels.edt_bestfirst`); on a CPU tensor it runs the plain
  chunked min-plus beside it.

All intermediate values are squared integer distances, exact in float32,
so every backend gives the same bits as the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.grid import GridSpec
from ..core.maps import SignedDistanceField
from ..kernels import edt_bestfirst

Tensor = torch.Tensor

_INF = float("inf")

# Grids at or above this size take the JAX package's slab-streamed
# pipeline by default; that pipeline is not ported yet.
_STREAMING_AUTO_VOXELS = 640 ** 3
_STREAMING_TODO = ("the slab-streamed EDT is not ported yet "
                   "(ROADMAP.md queue 1 item 5e, streaming EDT)")


def _binary_squared_dist_last(seed: Tensor) -> Tensor:
    """Squared distance (in voxels) to the nearest True along the last
    axis; ``+inf`` on lines with no seed."""
    n = seed.shape[-1]
    idx = torch.arange(n, dtype=torch.int32, device=seed.device)

    def one_sided(s):
        marked = torch.where(s, idx, torch.tensor(-1, dtype=torch.int32,
                                                  device=s.device))
        last = torch.cummax(marked, dim=-1).values
        delta = (idx - last).to(torch.float32)
        return torch.where(last >= 0, delta * delta,
                           torch.tensor(_INF, device=s.device))

    d_left = one_sided(seed)
    d_right = torch.flip(one_sided(torch.flip(seed, dims=(-1,))), dims=(-1,))
    return torch.minimum(d_left, d_right)


def _parabolic_envelope_last(f: Tensor, block: int = 512) -> Tensor:
    """Exact 1-D squared-distance transform along the last axis, plain
    PyTorch (the blocked min-plus; chunked so eager intermediates stay
    bounded)."""
    return edt_bestfirst.parabolic_envelope_last_plain(f, block)


def _resolve_edt_backend(backend: str, f: Tensor) -> str:
    """``auto`` keys on the tensor's device: the CUDA kernel for a CUDA
    tensor at every size, the plain min-plus for a CPU tensor."""
    if backend != "auto":
        return backend
    return "cuda-bestfirst" if f.is_cuda else "plain"


def _envelope_last(f: Tensor, block: int, backend: str) -> Tensor:
    backend = _resolve_edt_backend(backend, f)
    if backend == "cuda-bestfirst":
        if not f.is_cuda:
            raise ValueError(
                "backend='cuda-bestfirst' needs a CUDA tensor, got one on "
                f"{f.device}")
        return edt_bestfirst.parabolic_envelope_last(f)
    if backend == "plain":
        return _parabolic_envelope_last(f, block)
    if backend in ("pallas", "pallas-windowed"):
        raise NotImplementedError(
            f"EDT backend {backend!r} is a TPU kernel not ported yet "
            "(ROADMAP.md queue 2)")
    raise ValueError(f"Unknown EDT backend {backend!r}")


def squared_edt(seed: Tensor, block: int = 512,
                backend: str = "auto") -> Tensor:
    """Exact squared Euclidean distance (voxel units) to the nearest True
    voxel; ``+inf`` everywhere if no seed is set. ``backend``: ``"auto"``,
    ``"plain"`` or ``"cuda-bestfirst"``."""
    seed = seed.bool()
    d = _binary_squared_dist_last(seed.movedim(0, -1)).movedim(-1, 0)
    if seed.shape[1] > 1:
        d = _envelope_last(d.movedim(1, -1), block, backend).movedim(-1, 1)
    if seed.shape[2] > 1:
        d = _envelope_last(d, block, backend)
    return d


def signed_distance_from_filled_mask(is_filled: Tensor, resolution: float,
                                     block: int = 512,
                                     dtype=torch.float32,
                                     backend: str = "auto") -> Tensor:
    """Two-field signed combine ``sqrt(d2_filled) - sqrt(d2_free)`` scaled
    by ``resolution``: negative inside filled space, positive outside,
    ``+/-inf`` for fully empty/filled grids.

    Both fields ride ONE envelope pass per axis (stacked along axis 0 after
    their binary axis-0 passes), so an EDT makes two envelope calls, not
    four. ``dtype`` governs only the final sqrt/scale combine."""
    is_filled = is_filled.bool()
    d_f = _binary_squared_dist_last(is_filled.movedim(0, -1)).movedim(-1, 0)
    d_e = _binary_squared_dist_last(
        (~is_filled).movedim(0, -1)).movedim(-1, 0)
    d = torch.cat([d_f, d_e], dim=0)
    del d_f, d_e
    if is_filled.shape[1] > 1:
        d = _envelope_last(d.movedim(1, -1), block, backend).movedim(-1, 1)
    if is_filled.shape[2] > 1:
        d = _envelope_last(d, block, backend)
    nx = is_filled.shape[0]
    res = torch.tensor(resolution, dtype=dtype, device=d.device)
    out = (_sqrt(d[:nx], dtype) * res - _sqrt(d[nx:], dtype) * res)
    return out.contiguous()


def _sqrt(x: Tensor, dtype) -> Tensor:
    """Correctly rounded ``sqrt`` in ``dtype``. PyTorch's float32 CPU sqrt
    is not always correctly rounded (measured: 5456 of the integers below
    3 * 512^2 differ by one ulp); a float64 sqrt rounded to float32 is, so
    the result matches the JAX package bit for bit on every device."""
    return torch.sqrt(x.to(torch.float64)).to(dtype)


def _pad_axis_flags(counts: Tuple[int, int, int]):
    """The virtual border is only added along axes with more than one
    voxel."""
    return tuple(1 if c > 1 else 0 for c in counts)


def signed_distance_with_virtual_border(is_filled: Tensor, resolution: float,
                                        block: int = 512,
                                        dtype=torch.float32,
                                        streaming: bool = False) -> Tensor:
    """Synthesize a 1-voxel border, compute a "free" SDF (border filled) and
    a "filled" SDF (border free) on the enlarged grid, crop, and merge."""
    if streaming:
        raise NotImplementedError(_STREAMING_TODO)
    is_filled = is_filled.bool()
    pads = _pad_axis_flags(tuple(is_filled.shape))
    big = tuple(s + 2 * p for s, p in zip(is_filled.shape, pads))
    inner = tuple(slice(p, s + p) for p, s in zip(pads, is_filled.shape))
    free_seeds = torch.ones(big, dtype=torch.bool, device=is_filled.device)
    free_seeds[inner] = is_filled
    filled_seeds = torch.zeros(big, dtype=torch.bool,
                               device=is_filled.device)
    filled_seeds[inner] = is_filled

    free_sdf = signed_distance_from_filled_mask(
        free_seeds, resolution, block, dtype)[inner]
    filled_sdf = signed_distance_from_filled_mask(
        filled_seeds, resolution, block, dtype)[inner]
    return merge_free_and_named_object_sdfs(free_sdf, filled_sdf)


def filled_mask_from_occupancy(occupancy: Tensor,
                               unknown_is_filled: bool = True) -> Tensor:
    """Filled iff occupancy > 0.5, or == 0.5 when unknown counts as
    filled."""
    filled = occupancy > 0.5
    if unknown_is_filled:
        filled = filled | (occupancy == 0.5)
    return filled


def extract_signed_distance_field(
        is_filled: Tensor,
        spec: GridSpec,
        origin_transform,
        frame: str = "",
        oob_value: float = float("inf"),
        add_virtual_border: bool = False,
        block: int = 512,
        dtype=torch.float32,
        streaming: Optional[bool] = None) -> SignedDistanceField:
    """Full SDF-generation entry point over a filled-voxel mask; returns the
    field *locked* with cached min/max, on the mask's device.

    ``streaming=None`` would pick the slab-streamed pipeline for grids of
    640^3 voxels and more, as in the JAX package; that pipeline is not
    ported, so such grids (and ``streaming=True``) raise."""
    spec.enforce_uniform_voxel_size()
    mask = torch.as_tensor(is_filled).bool()
    if streaming is None:
        streaming = spec.num_total >= _STREAMING_AUTO_VOXELS
    if streaming:
        raise NotImplementedError(_STREAMING_TODO)
    if add_virtual_border:
        values = signed_distance_with_virtual_border(
            mask, spec.resolution, block, dtype)
    else:
        values = signed_distance_from_filled_mask(
            mask, spec.resolution, block, dtype)
    return SignedDistanceField.create(
        spec=spec, distances=values, origin_transform=origin_transform,
        frame=frame, oob_value=oob_value, locked=True, dtype=dtype)


def extract_sdf_from_occupancy(
        occupancy: Tensor,
        spec: GridSpec,
        origin_transform,
        frame: str = "",
        oob_value: float = float("inf"),
        unknown_is_filled: bool = True,
        add_virtual_border: bool = False,
        block: int = 512,
        dtype=torch.float32,
        streaming: Optional[bool] = None) -> SignedDistanceField:
    """SDF from an occupancy channel (float32 or float64 ``dtype``)."""
    mask = filled_mask_from_occupancy(torch.as_tensor(occupancy),
                                      unknown_is_filled)
    return extract_signed_distance_field(
        mask, spec, origin_transform, frame=frame, oob_value=oob_value,
        add_virtual_border=add_virtual_border, block=block, dtype=dtype,
        streaming=streaming)


def merge_free_and_named_object_sdfs(free_sdf: Tensor,
                                     named_objects_sdf: Tensor) -> Tensor:
    """Combine rule: the free SDF where it is non-negative, else the named
    object's SDF where that is non-positive, else 0."""
    zero = torch.zeros((), dtype=free_sdf.dtype, device=free_sdf.device)
    return torch.where(free_sdf >= 0.0, free_sdf,
                       torch.where(named_objects_sdf <= -0.0,
                                   named_objects_sdf, zero))
