"""Exact 3-D Euclidean distance transform + signed-distance-field generation.

Port of ``voxelized_geometry_tools_tpu/ops/edt.py``. The math is the JAX
package's:

* **Pass 1** (axis 0, binary seed field): squared distance to the nearest
  seed, O(n): on a CUDA tensor one launch of the seed kernel
  (:mod:`..kernels.edt_seed`), both fields of the signed EDT from one read
  of the mask; on a CPU tensor two ``cummax`` prefix scans a field.
* **Passes 2 and 3** (axes 1 and 2, general ``f``): the exact min-plus
  ``d[q] = min_k (q-k)^2 + f[k]``, by one of four interchangeable
  backends: the plain chunked min-plus, or one of three CUDA kernels
  (best-first, full sweep, windowed; :mod:`..kernels`). On a CUDA tensor
  ``backend="auto"`` launches the best-first kernel; on a CPU tensor it
  runs the plain version.
* **The signed combine** ``sqrt(d2_filled) * res - sqrt(d2_free) * res``:
  on a CUDA tensor one launch of the combine kernel
  (:mod:`..kernels.edt_combine`); on a CPU tensor its plain version.

The slab-streamed pipeline (:func:`squared_edt_streamed`,
:func:`signed_distance_from_filled_mask_streamed`) runs the same passes
slab by slab, so a 1024^3 grid fits with slab-sized transients; grids of
640^3 voxels and more take it by default, as in the JAX package.

All intermediate values are squared integer distances, exact in float32,
so every backend and both pipelines give the same bits as the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.device import default_device
from ..core.grid import GridSpec
from ..core.maps import SignedDistanceField
from ..kernels import (edt_bestfirst, edt_combine, edt_envelope, edt_seed,
                       edt_windowed)
# The correctly rounded square root, shared with the combine's plain version
# and used by every module that must match the JAX package's roots.
from ..kernels.edt_combine import correctly_rounded_sqrt as _sqrt
from ..utils.profiling import _span

Tensor = torch.Tensor

_INF = float("inf")

# Grids at or above this size take the slab-streamed pipeline by default,
# as in the JAX package.
_STREAMING_AUTO_VOXELS = 640 ** 3

# The envelope backends that launch a CUDA kernel, by module (the module's
# ``parabolic_envelope_last`` is looked up at each call).
_KERNEL_BACKENDS = {
    "cuda-bestfirst": edt_bestfirst,
    "cuda-envelope": edt_envelope,
    "cuda-windowed": edt_windowed,
}
# The JAX package's backend names, accepted for their counterparts so that
# code written for it runs unchanged.
BACKEND_ALIASES = {
    "xla": "plain",
    "pallas": "cuda-envelope",
    "pallas-windowed": "cuda-windowed",
    "pallas-bestfirst": "cuda-bestfirst",
}

# Slabs the streamed passes walked: one per slab of each seed or envelope
# pass of each field.
streamed_slabs = 0


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
    """Maps the JAX package's names to their counterparts; ``auto`` keys on
    the tensor's device: the best-first kernel for a CUDA tensor at every
    size, the plain min-plus for a CPU tensor."""
    backend = BACKEND_ALIASES.get(backend, backend)
    if backend != "auto":
        return backend
    return "cuda-bestfirst" if f.is_cuda else "plain"


def _envelope_last(f: Tensor, block: int, backend: str) -> Tensor:
    backend = _resolve_edt_backend(backend, f)
    if backend == "plain":
        return _parabolic_envelope_last(f, block)
    kernel = _KERNEL_BACKENDS.get(backend)
    if kernel is None:
        raise ValueError(f"Unknown EDT backend {backend!r}")
    if not f.is_cuda:
        raise ValueError(f"backend={backend!r} needs a CUDA tensor, got one "
                         f"on {f.device}")
    return kernel.parabolic_envelope_last(f)


def squared_edt(seed: Tensor, block: int = 512,
                backend: str = "auto") -> Tensor:
    """Exact squared Euclidean distance (voxel units) to the nearest True
    voxel; ``+inf`` everywhere if no seed is set.

    ``backend`` selects the envelope pass of axes 1 and 2: ``"plain"`` (the
    chunked min-plus), ``"cuda-bestfirst"``, ``"cuda-envelope"`` (full
    sweep) or ``"cuda-windowed"`` (the CUDA kernels; a CPU tensor raises),
    or ``"auto"`` (best-first on a CUDA tensor, plain on a CPU tensor). The
    JAX package's names ``"xla"``, ``"pallas"``, ``"pallas-windowed"`` and
    ``"pallas-bestfirst"`` are aliases of the four. All give the same
    bits."""
    seed = seed.bool()
    d = edt_seed.seed_fields(seed)
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

    Both fields ride ONE envelope pass per axis (stacked along axis 0 by
    their binary axis-0 pass), so an EDT makes two envelope calls, not
    four. ``dtype`` governs only the final sqrt/scale combine: on a CUDA
    tensor one launch of the combine kernel (:mod:`..kernels.edt_combine`)
    over the stacked field's two halves."""
    is_filled = is_filled.bool()
    with _span("edt.seed_pass"):
        d = edt_seed.seed_fields(is_filled, 2)
    if is_filled.shape[1] > 1:
        with _span("edt.envelope"):
            d = _envelope_last(d.movedim(1, -1), block,
                               backend).movedim(-1, 1)
    if is_filled.shape[2] > 1:
        with _span("edt.envelope"):
            d = _envelope_last(d, block, backend)
    with _span("edt.combine"):
        return _combine_stacked(d, resolution, dtype)


def _combine_stacked(d: Tensor, resolution: float, dtype) -> Tensor:
    """The signed combine of a stacked field ``d`` (``[2 nx, ...]``: the
    squared distances to the filled set, then to the free set) into a new
    ``dtype`` tensor ``[nx, ...]``."""
    nx = d.shape[0] // 2
    out = torch.empty((nx,) + tuple(d.shape[1:]), dtype=dtype,
                      device=d.device)
    return edt_combine.signed_combine(d[:nx], d[nx:], resolution, out)


def _largest_divisor_at_most(n: int, target: int) -> int:
    for s in range(min(int(target), int(n)), 0, -1):
        if n % s == 0:
            return s
    return 1


def _slab_schedule(n: int, target: int):
    """``(slab, pad)`` with ``slab <= target`` and ``(n + pad) % slab == 0``,
    as in the JAX package: an exact divisor near the target, or for
    divisor-poor axes (primes) the target itself with the last slab
    ``pad`` short, instead of degrading to slab=1. Slabs never overlap: the
    envelope is not idempotent."""
    n, target = int(n), max(1, min(int(target), int(n)))
    s = _largest_divisor_at_most(n, target)
    if s >= max(1, target // 2):
        return s, 0
    return target, (-n) % target


def _slabs(n: int, target: int):
    """``(start, width)`` of each slab of ``_slab_schedule(n, target)``. The
    JAX package pads the axis by ``pad`` and slices it off afterwards; here
    the last slab is narrower instead. The padded lines are independent of
    the real ones, so the results and the slab count are the same and no
    padded copy of the grid is made."""
    slab, pad = _slab_schedule(n, target)
    return [(s, min(slab, n - s)) for s in range(0, n + pad, slab)]


def _streamed_slab_axis(shape, pass_axis: int) -> int:
    """Largest axis perpendicular to the pass axis (the first on a tie), so
    that anisotropic grids keep slab-sized transients."""
    return max((a for a in range(3) if a != pass_axis),
               key=lambda a: shape[a])


def _streamed_binary_axis0(seed: Tensor, slab_target: int) -> Tensor:
    """Axis-0 binary pass, slab by slab (transients slab-sized); each slab's
    copy into the field is a ``vgt.edt.slab_writeback`` span."""
    global streamed_slabs
    s_ax = _streamed_slab_axis(seed.shape, 0)
    out = torch.empty(seed.shape, dtype=torch.float32, device=seed.device)
    for start, width in _slabs(seed.shape[s_ax], slab_target):
        slab = edt_seed.seed_fields(seed.narrow(s_ax, start, width))
        with _span("edt.slab_writeback"):
            out.narrow(s_ax, start, width).copy_(slab)
        streamed_slabs += 1
    return out


def _streamed_envelope_axis(d: Tensor, axis: int, slab_target: int,
                            block: int, backend: str) -> Tensor:
    """Envelope along ``axis``, slab by slab over a perpendicular axis, each
    slab written back into ``d`` in place (a ``vgt.edt.slab_writeback``
    span): peak memory is one grid plus a slab's transients. Identical
    per-line math, identical bits."""
    global streamed_slabs
    s_ax = _streamed_slab_axis(d.shape, axis)
    for start, width in _slabs(d.shape[s_ax], slab_target):
        sl = d.narrow(s_ax, start, width)
        slab = _envelope_last(sl.movedim(axis, -1), block, backend)
        with _span("edt.slab_writeback"):
            sl.copy_(slab.movedim(-1, axis))
        streamed_slabs += 1
    return d


def squared_edt_streamed(seed: Tensor, slab: int = 128, block: int = 512,
                         backend: str = "auto") -> Tensor:
    """Exact squared EDT with slab-bounded transients, for grids whose dense
    pipeline would not fit (1024^3). Bit-identical to :func:`squared_edt`;
    ``backend`` as there. The seed pass and each envelope pass are the
    dense path's ``vgt.edt.seed_pass`` and ``vgt.edt.envelope`` spans."""
    seed = seed.bool()
    with _span("edt.seed_pass"):
        d = _streamed_binary_axis0(seed, slab)
    if seed.shape[1] > 1:
        with _span("edt.envelope"):
            d = _streamed_envelope_axis(d, 1, slab, block, backend)
    if seed.shape[2] > 1:
        with _span("edt.envelope"):
            d = _streamed_envelope_axis(d, 2, slab, block, backend)
    return d


def signed_distance_from_filled_mask_streamed(
        is_filled: Tensor, resolution: float, slab: int = 128,
        block: int = 512, dtype=torch.float32,
        backend: str = "auto") -> Tensor:
    """Two-field signed combine with slab-bounded memory: the fields run one
    after the other (not stacked), each pass streams slabs, and the combine
    is taken in place, so about 2 float32 grids stay resident instead of the
    dense path's 4 or more. Bit-identical to
    :func:`signed_distance_from_filled_mask`. In float32 both fields'
    squared distances are kept and one ``vgt.edt.combine`` span writes the
    signed field over the first (one kernel launch on a CUDA tensor); in
    float64 the first field's scaled root goes into the result before the
    second field is formed, and the second's is subtracted from it, each a
    ``vgt.edt.combine`` span, so the peak holds the result and one field."""
    is_filled = is_filled.bool()
    d2 = squared_edt_streamed(is_filled, slab, block, backend)
    if dtype == torch.float32:
        d2_free = squared_edt_streamed(~is_filled, slab, block, backend)
        with _span("edt.combine"):
            return edt_combine.signed_combine(d2, d2_free, resolution, d2)
    out = torch.empty(d2.shape, dtype=dtype, device=d2.device)
    with _span("edt.combine"):
        edt_combine.signed_combine(d2, None, resolution, out)
    del d2
    d2_free = squared_edt_streamed(~is_filled, slab, block, backend)
    with _span("edt.combine"):
        return edt_combine.signed_combine(None, d2_free, resolution, out)


def _pad_axis_flags(counts: Tuple[int, int, int]):
    """The virtual border is only added along axes with more than one
    voxel."""
    return tuple(1 if c > 1 else 0 for c in counts)


def signed_distance_with_virtual_border(is_filled: Tensor, resolution: float,
                                        block: int = 512,
                                        dtype=torch.float32,
                                        streaming: bool = False) -> Tensor:
    """Synthesize a 1-voxel border, compute a "free" SDF (border filled) and
    a "filled" SDF (border free) on the enlarged grid, crop, and merge.
    ``streaming`` takes the slab-streamed pipeline for both."""
    is_filled = is_filled.bool()
    pads = _pad_axis_flags(tuple(is_filled.shape))
    big = tuple(s + 2 * p for s, p in zip(is_filled.shape, pads))
    inner = tuple(slice(p, s + p) for p, s in zip(pads, is_filled.shape))
    free_seeds = torch.ones(big, dtype=torch.bool, device=is_filled.device)
    free_seeds[inner] = is_filled
    filled_seeds = torch.zeros(big, dtype=torch.bool,
                               device=is_filled.device)
    filled_seeds[inner] = is_filled

    if streaming:
        free_sdf = signed_distance_from_filled_mask_streamed(
            free_seeds, resolution, block=block, dtype=dtype)
        filled_sdf = signed_distance_from_filled_mask_streamed(
            filled_seeds, resolution, block=block, dtype=dtype)
    else:
        free_sdf = signed_distance_from_filled_mask(
            free_seeds, resolution, block, dtype)
        filled_sdf = signed_distance_from_filled_mask(
            filled_seeds, resolution, block, dtype)
    return merge_free_and_named_object_sdfs(free_sdf[inner],
                                            filled_sdf[inner])


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
    field *locked* with cached min/max, on the mask's device (a mask given
    as host data goes to the CUDA card).

    ``streaming`` selects the slab-streamed pipeline (bit-identical, with
    slab-bounded transients: how 1024^3 fits one card); ``None`` takes it
    for grids of 640^3 voxels and more, as in the JAX package."""
    with _span("edt"):
        with _span("edt.mask"):
            mask = torch.as_tensor(
                is_filled, device=default_device(like=is_filled)).bool()
        return _signed_distance_field(mask, spec, origin_transform, frame,
                                      oob_value, add_virtual_border, block,
                                      dtype, streaming)


def _signed_distance_field(mask: Tensor, spec: GridSpec, origin_transform,
                           frame: str, oob_value: float,
                           add_virtual_border: bool, block: int, dtype,
                           streaming: Optional[bool]) -> SignedDistanceField:
    """The locked SDF of a boolean mask on its device: the body of
    :func:`extract_signed_distance_field` and
    :func:`extract_sdf_from_occupancy`, inside their ``vgt.edt`` span."""
    spec.enforce_uniform_voxel_size()
    if streaming is None:
        streaming = spec.num_total >= _STREAMING_AUTO_VOXELS
    if add_virtual_border:
        values = signed_distance_with_virtual_border(
            mask, spec.resolution, block, dtype, streaming=streaming)
    elif streaming:
        values = signed_distance_from_filled_mask_streamed(
            mask, spec.resolution, block=block, dtype=dtype)
    else:
        values = signed_distance_from_filled_mask(
            mask, spec.resolution, block, dtype)
    with _span("edt.lock"):
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
    """SDF from an occupancy channel (float32 or float64 ``dtype``), on
    its device (host data goes to the CUDA card)."""
    with _span("edt"):
        with _span("edt.mask"):
            occupancy = torch.as_tensor(
                occupancy, device=default_device(like=occupancy))
            mask = filled_mask_from_occupancy(occupancy, unknown_is_filled)
        return _signed_distance_field(mask, spec, origin_transform, frame,
                                      oob_value, add_virtual_border, block,
                                      dtype, streaming)


def merge_free_and_named_object_sdfs(free_sdf: Tensor,
                                     named_objects_sdf: Tensor) -> Tensor:
    """Combine rule: the free SDF where it is non-negative, else the named
    object's SDF where that is non-positive, else 0."""
    zero = torch.zeros((), dtype=free_sdf.dtype, device=free_sdf.device)
    return torch.where(free_sdf >= 0.0, free_sdf,
                       torch.where(named_objects_sdf <= -0.0,
                                   named_objects_sdf, zero))
