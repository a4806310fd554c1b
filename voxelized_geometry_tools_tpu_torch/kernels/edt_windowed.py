"""Exact 1-D squared-distance transform along the last axis for ``f >= 0``,
outward walk: the CUDA kernel ``csrc/edt_windowed.cu`` (the counterpart of
the JAX package's ``parabolic_envelope_last_pallas_windowed``, backend
``"pallas-windowed"``) and its plain PyTorch version.

The kernel computes ``d[..., q] = min_k (q - k)^2 + f[..., k]`` exactly for
a float32 ``f >= 0`` (``+inf`` allowed, NaN not): its stop bound is
geometric only, so a negative value outside a tile's window can be missed,
as in the JAX package's kernel. The kernel does not check the sign. Every
EDT field is a squared distance, so it is never negative there. The plain
version, :func:`.edt_bestfirst.parabolic_envelope_last_plain` re-exported
here, is exact for any sign, so it equals the kernel only on ``f >= 0``.

The kernel has two variants, chosen by shape up front (:func:`plan`): the
staged one copies each 32-line block into shared memory, reads and writes
both pass layouts in place and skips, within each chunk the walk visits,
the groups of positions that no lane can lower, wherever the block fits
(:func:`windowed_warps`: n up to 1,536 with the positions contiguous, 1,808
with the lines contiguous); the global one reads ``f`` from global memory
with the lines on the contiguous axis (a transposed copy where they are
not). ``launches_staged`` and ``launches`` count the launches of each.
:func:`walk_count` counts what the walk visits.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .edt_bestfirst import (CHUNK, LINES_ARGTYPES, TILE_Q, WARP_LINES,
                            _check_input, _stream_args, fit_warps,
                            launch_on_lines, parabolic_envelope_last_plain,
                            plan_lines, staged_output)

Tensor = torch.Tensor

__all__ = ["parabolic_envelope_last", "parabolic_envelope_last_global",
           "parabolic_envelope_last_plain", "parabolic_envelope_last_staged",
           "walk_count"]

# Kernel launches: the staged variant and the global variant.
launches_staged = 0
launches = 0


def windowed_smem_bytes(n: int, lines_contiguous: bool, warps: int) -> int:
    """Dynamic shared memory of one staged CTA (``windowed_layout`` of
    csrc/edt_windowed.cu): the block (as the staged best-first kernel's:
    rows ``[n16][32]`` with the lines contiguous, else lines ``[32][stride]``
    with ``stride`` = 4 mod 32) and, with the positions contiguous, one
    padded ``[32][33]`` output tile per warp."""
    n16 = -(-n // CHUNK) * CHUNK
    if lines_contiguous:
        block, tile = n16 * WARP_LINES, 0
    else:
        stride = n16 + (4 if n16 % 32 == 0 else 20)
        block, tile = WARP_LINES * stride, TILE_Q * (TILE_Q + 1)
    return 4 * (block + warps * tile)


def windowed_warps(n: int, lines_contiguous: bool) -> int:
    """Warps per CTA of the staged variant for an axis of ``n``, or 0 where
    its block does not fit (the global variant runs):
    :func:`.edt_bestfirst.fit_warps` of :func:`windowed_smem_bytes`."""
    return fit_warps(lambda w: windowed_smem_bytes(n, lines_contiguous, w))


def walk_count(f: Tensor, d: Tensor) -> dict:
    """What the outward walk over ``f`` (``[..., n]``, ``f >= 0``) with
    result ``d`` visits at least, in tiles of 32 positions x 32 lines and
    chunks of 16 rows, as the kernel tiles them: the tile's own chunks, then
    each step's lower and upper chunk while the step's geometric bound
    (float32, as the kernel rounds it) is below the tile's final largest
    ``d``. The kernel tests its running largest entry, which is never below
    the final one, so it walks at least these chunks: a lower bound.

    Returns ``tiles``, ``chunks`` (summed over tiles), ``dead`` (those of
    them that are +inf on every real line of their tile), ``whole_axis``
    (tiles that walk every chunk of the axis) and ``outputs``
    (``d.numel()``). Plain PyTorch, on ``f``'s device."""
    n = f.shape[-1]
    lines = f.shape[-2] if f.dim() > 1 else 1
    f3 = f.reshape(-1, lines, n)
    d3 = d.reshape(-1, lines, n)
    b = f3.shape[0]
    n_ch = -(-n // CHUNK)
    n_lb = -(-lines // WARP_LINES)
    n_qt = -(-n // TILE_Q)
    pad = torch.nn.functional.pad
    inf = float("inf")
    dead = pad(f3, (0, n_ch * CHUNK - n, 0, n_lb * WARP_LINES - lines),
               value=inf).reshape(b, n_lb, WARP_LINES, n_ch, CHUNK).amin(
        dim=(2, 4)) == inf
    dmax = pad(d3, (0, n_qt * TILE_Q - n, 0, n_lb * WARP_LINES - lines),
               value=-inf).reshape(b, n_lb, WARP_LINES, n_qt, TILE_Q).amax(
        dim=(2, 4))
    dev = f.device
    q0 = torch.arange(n_qt, device=dev)[:, None] * TILE_Q
    c = torch.arange(n_ch, device=dev)[None, :]
    lo0 = q0 // CHUNK
    hi0 = torch.clamp((q0 + TILE_Q + CHUNK - 1) // CHUNK, max=n_ch)
    # The step that visits chunk c of tile q0 (0: the tile's own chunks),
    # and that step's (lo, hi) window edges.
    step = torch.where(c < lo0, lo0 - c,
                       torch.where(c >= hi0, c - hi0 + 1, 0))
    lo, hi = lo0 - step, hi0 - 1 + step
    db = (q0 - (lo * CHUNK + CHUNK - 1)).to(torch.float32)
    dh = (hi * CHUNK - (q0 + TILE_Q - 1)).to(torch.float32)
    bound = torch.minimum(torch.where(lo >= 0, db * db, inf),
                          torch.where(hi < n_ch, dh * dh, inf))
    bound = torch.where(step == 0, -inf, bound)
    walked = bound < dmax[..., None]
    chunks = walked.sum(dim=-1)
    return {"tiles": b * n_lb * n_qt, "chunks": int(chunks.sum()),
            "dead": int((walked & dead[:, :, None, :]).sum()),
            "whole_axis": int((chunks == n_ch).sum()),
            "outputs": d.numel()}


@functools.cache
def _library():
    lib = build.load_library("edt_windowed")
    smem = lib.edt_windowed_staged_smem
    smem.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    for n in (1, 37, 512, 513, 1024, 1500):
        for lc in (False, True):
            for warps in (8, 16):
                if smem(n, int(lc), warps) != windowed_smem_bytes(n, lc,
                                                                  warps):
                    raise RuntimeError("edt_windowed.cu and edt_windowed.py "
                                       "disagree on the staged layout")
    lib.edt_windowed_launch.argtypes = [ctypes.c_void_p] * 2 + LINES_ARGTYPES
    lib.edt_windowed_launch.restype = ctypes.c_int
    lib.edt_windowed_staged_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.edt_windowed_staged_launch.restype = ctypes.c_int
    return lib


def _launcher():
    """The global variant's C entry point."""
    return _library().edt_windowed_launch


def plan(f: Tensor):
    """``(line_plan, warps, f3)``: :func:`.edt_bestfirst.plan_lines` of a
    non-empty ``f``, the staged variant's warps per CTA for it (0: the
    global variant runs) and the ``[batch, lines, n]`` tensor it reads."""
    line_plan, f3 = plan_lines(f)
    return line_plan, windowed_warps(line_plan.n,
                                     line_plan.lines_contiguous), f3


def launch_staged(line_plan, warps: int, f3: Tensor, out3: Tensor) -> None:
    """One launch of the staged variant on the current stream: ``f3`` as
    :func:`plan` gives it, into ``out3``
    (:func:`.edt_bestfirst.staged_output`)."""
    global launches_staged
    s_b, s_l, s_k = f3.stride()
    o_b, o_l, o_k = out3.stride()
    err = _library().edt_windowed_staged_launch(
        f3.data_ptr(), out3.data_ptr(), line_plan.batch, line_plan.n,
        line_plan.lines, s_b, s_k, s_l, o_b, o_k, o_l,
        int(line_plan.lines_contiguous), warps, *_stream_args(f3))
    if err != 0:
        raise RuntimeError(f"edt_windowed staged kernel launch failed "
                           f"(cudaError_t {err})")
    launches_staged += 1


def _staged(f: Tensor, line_plan, warps: int, f3: Tensor) -> Tensor:
    out3 = staged_output(line_plan, f3)
    launch_staged(line_plan, warps, f3, out3)
    return out3.reshape(f.shape)


def parabolic_envelope_last_staged(f: Tensor) -> Tensor:
    """The staged variant on a CUDA tensor ``f >= 0``, on the current
    stream, without synchronizing; raises ``ValueError`` where the axis's
    line block does not fit shared memory. The result has ``f``'s strides
    where ``f`` is dense."""
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    line_plan, warps, f3 = plan(f)
    if not warps:
        raise ValueError(f"axis length {line_plan.n}: the staged walk's line "
                         "block does not fit a block's shared memory")
    return _staged(f, line_plan, warps, f3)


def parabolic_envelope_last_global(f: Tensor) -> Tensor:
    """The global variant on a CUDA tensor ``f >= 0`` (any axis length), on
    the current stream, without synchronizing."""

    def launch(ft, out, args):
        global launches
        err = _launcher()(ft.data_ptr(), out.data_ptr(), *args)
        if err == 0:
            launches += 1
        return err

    return launch_on_lines(f, "edt_windowed", launch)


def parabolic_envelope_last(f: Tensor) -> Tensor:
    """Exact squared-distance transform along the last axis of ``f >= 0``.
    On a CUDA tensor this launches the kernel (building it at first use) on
    the current stream, without synchronizing, or raises: the staged
    variant wherever the axis's line block fits shared memory
    (:func:`plan`), the global one for longer axes. On a CPU tensor it runs
    :func:`parabolic_envelope_last_plain`."""
    if f.device.type == "cpu":
        return parabolic_envelope_last_plain(f)
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    line_plan, warps, f3 = plan(f)
    if warps:
        return _staged(f, line_plan, warps, f3)
    return parabolic_envelope_last_global(f)
