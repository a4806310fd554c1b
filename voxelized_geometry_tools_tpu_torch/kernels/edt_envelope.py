"""Exact 1-D squared-distance transform along the last axis, full sweep: the
CUDA kernel ``csrc/edt_envelope.cu`` (the counterpart of the JAX package's
``parabolic_envelope_last_pallas``, backend ``"pallas"``) and its plain
PyTorch version.

Both compute ``d[..., q] = min_k (q - k)^2 + f[..., k]`` for a float32 ``f``
(``+inf`` and negative values allowed, NaN not) and agree bit for bit. The
plain version is :func:`.edt_bestfirst.parabolic_envelope_last_plain`,
re-exported here: all the envelope kernels compute the same function.

The kernel has two variants, chosen by shape up front (:func:`plan`): the
staged one copies each 32-line block into shared memory and reads and
writes both pass layouts in place, wherever the block fits
(:func:`envelope_warps`: n up to 1,440 with the positions contiguous, 1,696
with the lines contiguous); the global one reads ``f`` from global memory
with the lines on the contiguous axis (a transposed copy where they are
not). ``launches_staged`` and ``launches`` count the launches of each.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build, edt_seed
from .edt_bestfirst import (CHUNK, LINES_ARGTYPES, TILE_Q, WARP_LINES,
                            _check_input, _stream_args, fit_warps,
                            launch_on_lines, parabolic_envelope_last_plain,
                            plan_lines, staged_output)

Tensor = torch.Tensor

__all__ = ["parabolic_envelope_last", "parabolic_envelope_last_global",
           "parabolic_envelope_last_plain", "parabolic_envelope_last_staged",
           "squared_edt_envelope"]

# Kernel launches: the staged variant and the global variant.
launches_staged = 0
launches = 0


def envelope_smem_bytes(n: int, lines_contiguous: bool, warps: int) -> int:
    """Dynamic shared memory of one staged CTA (``envelope_layout`` of
    csrc/edt_envelope.cu): the block (as the staged best-first kernel's:
    rows ``[n16][32]`` with the lines contiguous, else lines ``[32][stride]``
    with ``stride`` = 4 mod 32), the squares table of ``2 * n16 + 16``
    floats, and, with the positions contiguous, one padded ``[32][33]``
    output tile per warp."""
    n16 = -(-n // CHUNK) * CHUNK
    if lines_contiguous:
        block, tile = n16 * WARP_LINES, 0
    else:
        stride = n16 + (4 if n16 % 32 == 0 else 20)
        block, tile = WARP_LINES * stride, TILE_Q * (TILE_Q + 1)
    return 4 * (block + 2 * n16 + 16 + warps * tile)


def envelope_warps(n: int, lines_contiguous: bool) -> int:
    """Warps per CTA of the staged variant for an axis of ``n``, or 0 where
    its block does not fit (the global variant runs):
    :func:`.edt_bestfirst.fit_warps` of :func:`envelope_smem_bytes`."""
    return fit_warps(lambda w: envelope_smem_bytes(n, lines_contiguous, w))


@functools.cache
def _library():
    lib = build.load_library("edt_envelope")
    smem = lib.edt_envelope_staged_smem
    smem.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    for n in (1, 37, 512, 513, 1024, 1500):
        for lc in (False, True):
            for warps in (8, 16):
                if smem(n, int(lc), warps) != envelope_smem_bytes(n, lc,
                                                                  warps):
                    raise RuntimeError("edt_envelope.cu and edt_envelope.py "
                                       "disagree on the staged layout")
    lib.edt_envelope_launch.argtypes = [ctypes.c_void_p] * 2 + LINES_ARGTYPES
    lib.edt_envelope_launch.restype = ctypes.c_int
    lib.edt_envelope_staged_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.edt_envelope_staged_launch.restype = ctypes.c_int
    return lib


def _launcher():
    """The global variant's C entry point."""
    return _library().edt_envelope_launch


def plan(f: Tensor):
    """``(line_plan, warps, f3)``: :func:`.edt_bestfirst.plan_lines` of a
    non-empty ``f``, the staged variant's warps per CTA for it (0: the
    global variant runs) and the ``[batch, lines, n]`` tensor it reads."""
    line_plan, f3 = plan_lines(f)
    return line_plan, envelope_warps(line_plan.n,
                                     line_plan.lines_contiguous), f3


def launch_staged(line_plan, warps: int, f3: Tensor, out3: Tensor) -> None:
    """One launch of the staged variant on the current stream: ``f3`` as
    :func:`plan` gives it, into ``out3``
    (:func:`.edt_bestfirst.staged_output`)."""
    global launches_staged
    s_b, s_l, s_k = f3.stride()
    o_b, o_l, o_k = out3.stride()
    err = _library().edt_envelope_staged_launch(
        f3.data_ptr(), out3.data_ptr(), line_plan.batch, line_plan.n,
        line_plan.lines, s_b, s_k, s_l, o_b, o_k, o_l,
        int(line_plan.lines_contiguous), warps, *_stream_args(f3))
    if err != 0:
        raise RuntimeError(f"edt_envelope staged kernel launch failed "
                           f"(cudaError_t {err})")
    launches_staged += 1


def _staged(f: Tensor, line_plan, warps: int, f3: Tensor) -> Tensor:
    out3 = staged_output(line_plan, f3)
    launch_staged(line_plan, warps, f3, out3)
    return out3.reshape(f.shape)


def parabolic_envelope_last_staged(f: Tensor) -> Tensor:
    """The staged variant on a CUDA tensor ``f``, on the current stream,
    without synchronizing; raises ``ValueError`` where the axis's line block
    does not fit shared memory. The result has ``f``'s strides where ``f``
    is dense."""
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    line_plan, warps, f3 = plan(f)
    if not warps:
        raise ValueError(f"axis length {line_plan.n}: the staged full "
                         "sweep's line block does not fit a block's shared "
                         "memory")
    return _staged(f, line_plan, warps, f3)


def parabolic_envelope_last_global(f: Tensor) -> Tensor:
    """The global variant on a CUDA tensor ``f``, on the current stream,
    without synchronizing."""

    def launch(ft, out, args):
        global launches
        err = _launcher()(ft.data_ptr(), out.data_ptr(), *args)
        if err == 0:
            launches += 1
        return err

    return launch_on_lines(f, "edt_envelope", launch)


def parabolic_envelope_last(f: Tensor) -> Tensor:
    """Exact squared-distance transform along the last axis of ``f``, every
    candidate visited. On a CUDA tensor this launches the kernel (building
    it at first use) on the current stream, without synchronizing, or
    raises: the staged variant wherever the axis's line block fits shared
    memory (:func:`plan`), the global one for longer axes. On a CPU tensor
    it runs :func:`parabolic_envelope_last_plain`."""
    if f.device.type == "cpu":
        return parabolic_envelope_last_plain(f)
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    line_plan, warps, f3 = plan(f)
    if warps:
        return _staged(f, line_plan, warps, f3)
    return parabolic_envelope_last_global(f)


def squared_edt_envelope(seed: Tensor) -> Tensor:
    """3-D squared EDT with the full-sweep envelope on axes 1 and 2 (the
    counterpart of the JAX package's ``squared_edt_pallas``): axis 0 takes
    the seed pass of :mod:`.edt_seed` (its kernel on a CUDA tensor)."""
    seed = seed.bool()
    d = edt_seed.seed_fields(seed)
    if seed.shape[1] > 1:
        d = parabolic_envelope_last(d.movedim(1, -1)).movedim(-1, 1)
    if seed.shape[2] > 1:
        d = parabolic_envelope_last(d)
    return d
