"""Exact 1-D squared-distance transform along the last axis: the CUDA
best-first kernel (``csrc/edt_bestfirst.cu``) and its plain PyTorch version.

Both compute ``d[..., q] = min_k (q - k)^2 + f[..., k]`` for a float32
``f`` of shape ``[..., n]`` (``+inf`` and negative values allowed, NaN not)
and agree bit for bit. :func:`parabolic_envelope_last` launches the kernel
for a CUDA tensor and takes the plain version only for a CPU tensor.

The kernel has three variants, chosen by shape up front (:func:`plan_lines`):
the staged one, which copies each 32-line block into shared memory, forms
the chunk minima there and reads and writes both pass layouts in place,
for every axis whose block fits a block's shared memory
(:func:`staged_warps`: n up to 1,536 with the positions contiguous, 1,776
with the lines contiguous); the clustered one, which spreads the block over
the shared memory of a thread block cluster of 2, 4 or 8 CTAs
(:func:`cluster_plan`), for longer axes up to a cluster's reach; and the
global one, which reads ``f`` from global memory with the lines on the
contiguous axis (a transposed copy where they are not) and takes its chunk
minima from :func:`_chunk_minima` or, with ``hoist_cmin=False``, reduces
them itself. The staged and clustered variants serve both ``hoist_cmin``
values. ``launches_staged``, ``launches_cluster``, ``launches`` and
``launches_inkernel`` count the launches of each, and ``elements_launched``
the float32 elements of ``f`` that all of them passed over.
:func:`visit_count` counts the chunks a pass ordered and stopped by
tile-level bounds visits.
The plain version and the launch plumbing here are shared with
:mod:`.edt_envelope` and :mod:`.edt_windowed`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from . import build

Tensor = torch.Tensor

# k rows per chunk, lines per warp and q positions per warp tile; must match
# csrc/edt_common.cuh.
CHUNK = 16
WARP_LINES = 32
TILE_Q = 32
# Axis length limit of every envelope kernel; it bounds the global
# best-first kernel's shared-memory bound table (4 warps x ceil(n / 16)
# floats).
MAX_N = 16384
# Cap on the plain version's [lines, n, block] candidate tensor (1 GiB f32).
PLAIN_CANDIDATES = 1 << 28
# Shared memory of an H100 (and H200) SM: what one block may opt into, what
# one SM holds, and what each resident block reserves of it.
SMEM_BLOCK_LIMIT = 232_448
SMEM_SM = 233_472
SMEM_BLOCK_RESERVED = 1024

# CTAs a cluster of the clustered variant may have (8 is the portable
# limit).
CLUSTER_SIZES = (2, 4, 8)

# Kernel launches: the staged and the clustered variants (either
# hoist_cmin), and the global variant with hoisted and with in-kernel chunk
# minima.
launches_staged = 0
launches_cluster = 0
launches = 0
launches_inkernel = 0
# float32 elements of ``f`` over every launch of every variant: each is read
# once and written once, so a launch on one slab of the streamed EDT counts
# that slab's elements.
elements_launched = 0


def parabolic_envelope_last_plain(f: Tensor, block: int = 512) -> Tensor:
    """Blocked min-plus, chunked over lines and over ``k`` so that the
    candidate tensor stays under ``PLAIN_CANDIDATES`` elements. Port of
    ``voxelized_geometry_tools_tpu/ops/edt.py::_parabolic_envelope_last``:
    each candidate is ``fl(fl((q - k)^2) + f)`` as there."""
    shape = f.shape
    n = shape[-1]
    f2 = f.reshape(-1, n)
    block = max(1, min(int(block), n))
    q = torch.arange(n, dtype=f.dtype, device=f.device)
    out = torch.empty_like(f2, memory_format=torch.contiguous_format)
    lines_per = max(1, PLAIN_CANDIDATES // (n * block))
    # Squared offsets (q - k)^2 per k block: exact small integers.
    dsq = []
    for k0 in range(0, n, block):
        k = torch.arange(k0, min(k0 + block, n), dtype=f.dtype,
                         device=f.device)
        delta = q[:, None] - k[None, :]
        dsq.append((k0, delta * delta))
    for s in range(0, f2.shape[0], lines_per):
        fl = f2[s:s + lines_per]
        d = None
        for k0, sq in dsq:
            fk = fl[:, None, k0:k0 + sq.shape[1]]
            cand = torch.amin(sq + fk, dim=-1)
            d = cand if d is None else torch.minimum(d, cand)
        out[s:s + lines_per] = d
    return out.reshape(shape)


def _chunk_minima(ft: Tensor) -> Tensor:
    """``min f`` over each (32-line block, 16-row chunk): ``[B, n_lb, n_ch]``.
    Ragged edges pad with ``+inf``, so each minimum is over real entries
    only. The counterpart of the XLA reduction that feeds the TPU kernel;
    the global variant's input."""
    b, n, lines = ft.shape
    n_ch = -(-n // CHUNK)
    n_lb = -(-lines // WARP_LINES)
    pad_n, pad_l = n_ch * CHUNK - n, n_lb * WARP_LINES - lines
    x = ft
    if pad_n or pad_l:
        x = torch.nn.functional.pad(x, (0, pad_l, 0, pad_n),
                                    value=float("inf"))
    cm = torch.amin(x.reshape(b, n_ch, CHUNK, n_lb, WARP_LINES), dim=(2, 4))
    return cm.transpose(1, 2).contiguous()


def visit_count(f: Tensor, d: Tensor, tile_q: int = TILE_Q,
                cluster: int = 0) -> dict:
    """What a best-first pass over ``f`` (``[..., n]``) with result ``d``
    visits when it orders and stops by tile-level bounds, in tiles of
    ``tile_q`` positions x 32 lines and chunks of 16 rows, as the kernel
    tiles them: the chunks whose admissible bound ``geom(tile, chunk)^2 +
    min f[chunk, tile's lines]`` (float32, rounded as the kernel rounds it)
    is below the tile's final largest ``d``. It is not a floor for every
    exact kernel: a finer test, as the staged kernel's per-lane test of
    8-position groups, computes fewer candidates than these chunks hold.

    Returns ``tiles``, ``chunks`` (visited, summed over tiles),
    ``candidates`` (visited chunk rows x tile positions x tile lines, real
    ones only) and ``outputs`` (``d.numel()``); with ``cluster`` CTAs
    sharing the axis as the clustered variant shares it
    (:func:`cluster_shares`), also ``remote``: the visited chunks that
    another CTA than the tile's holds. Plain PyTorch, on ``f``'s device."""
    n = f.shape[-1]
    lines = f.shape[-2] if f.dim() > 1 else 1
    f3 = f.reshape(-1, lines, n)
    d3 = d.reshape(-1, lines, n)
    b = f3.shape[0]
    n_ch = -(-n // CHUNK)
    n_lb = -(-lines // WARP_LINES)
    n_qt = -(-n // tile_q)
    pad = torch.nn.functional.pad
    cmin = pad(f3, (0, n_ch * CHUNK - n, 0, n_lb * WARP_LINES - lines),
               value=float("inf")).reshape(
        b, n_lb, WARP_LINES, n_ch, CHUNK).amin(dim=(2, 4))
    dmax = pad(d3, (0, n_qt * tile_q - n, 0, n_lb * WARP_LINES - lines),
               value=-float("inf")).reshape(
        b, n_lb, WARP_LINES, n_qt, tile_q).amax(dim=(2, 4))
    dev = f.device
    q0 = torch.arange(n_qt, device=dev)[:, None] * tile_q
    c0 = torch.arange(n_ch, device=dev)[None, :] * CHUNK
    gap = torch.clamp(torch.maximum(q0 - (c0 + CHUNK - 1),
                                    c0 - (q0 + tile_q - 1)), min=0)
    g = gap.to(torch.float32)
    geom = g * g
    visited = (geom + cmin[:, :, None, :]) < dmax[..., None]
    rows = torch.clamp(n - c0[0], max=CHUNK)
    qs = torch.clamp(n - q0[:, 0], max=tile_q)
    ls = torch.clamp(lines - torch.arange(n_lb, device=dev) * WARP_LINES,
                     max=WARP_LINES)
    per = visited.sum(dim=0, dtype=torch.int64)
    candidates = (per * ls[:, None, None] * qs[None, :, None]
                  * rows[None, None, :]).sum()
    out = {"tiles": b * n_lb * n_qt, "chunks": int(per.sum()),
           "candidates": int(candidates), "outputs": d.numel()}
    if cluster:
        share_ch = cluster_shares(n, cluster)[0]
        tile_cta = q0[:, 0] // (share_ch * CHUNK)
        chunk_cta = torch.arange(n_ch, device=dev) // share_ch
        remote = tile_cta[:, None] != chunk_cta[None, :]
        out["remote"] = int((per * remote).sum())
    return out


def staged_smem_bytes(n: int, lines_contiguous: bool, warps: int) -> int:
    """Dynamic shared memory of one staged CTA (``staged_layout`` of
    csrc/edt_bestfirst.cu): the block, rows ``[n16][32]`` with the lines
    contiguous, else lines ``[32][stride]`` with ``stride`` = 4 mod 32; the
    chunk minima; one region per warp for its bounds and, with the positions
    contiguous, its padded ``[32][33]`` output tile."""
    n_ch = -(-n // CHUNK)
    n16 = n_ch * CHUNK
    if lines_contiguous:
        block, region = n16 * WARP_LINES, n_ch
    else:
        stride = n16 + (4 if n16 % 32 == 0 else 20)
        block, region = WARP_LINES * stride, max(n_ch, TILE_Q * (TILE_Q + 1))
    return 4 * (block + n_ch + warps * region)


def fit_warps(smem_bytes) -> int:
    """Warps per CTA of a staged kernel whose CTA of ``w`` warps takes
    ``smem_bytes(w)`` bytes of shared memory, or 0 where none fits. At most
    128 registers a thread let 16 warps fill an SM: 8 per CTA where two
    CTAs fit an SM's shared memory (one stages while the other computes),
    else 16, else 8."""
    if 2 * (smem_bytes(8) + SMEM_BLOCK_RESERVED) <= SMEM_SM:
        return 8
    for warps in (16, 8):
        if smem_bytes(warps) <= SMEM_BLOCK_LIMIT:
            return warps
    return 0


def staged_warps(n: int, lines_contiguous: bool) -> int:
    """Warps per CTA of the staged kernel for an axis of ``n``, or 0 where
    its block does not fit (the global variant runs): :func:`fit_warps` of
    :func:`staged_smem_bytes`."""
    return fit_warps(lambda w: staged_smem_bytes(n, lines_contiguous, w))


def cluster_shares(n: int, cluster: int):
    """``(share_ch, chunk_ranges, tile_ranges)`` of the clustered variant on
    an axis of ``n`` over ``cluster`` CTAs: CTA ``r`` stages chunks
    ``[r * share_ch, (r + 1) * share_ch)`` (``share_ch = ceil(n_ch /
    cluster)``; the last shares may be short or empty) and takes the q
    tiles whose first row it holds. Both lists have one ``range`` per
    CTA."""
    n_ch = -(-n // CHUNK)
    n_qt = -(-n // TILE_Q)
    share_ch = -(-n_ch // cluster)
    chunks, tiles = [], []
    for r in range(cluster):
        c0 = min(r * share_ch, n_ch)
        chunks.append(range(c0, min(c0 + share_ch, n_ch)))
        row0, row1 = r * share_ch * CHUNK, (r + 1) * share_ch * CHUNK
        tiles.append(range(min(-(-row0 // TILE_Q), n_qt),
                           -(-min(row1, n) // TILE_Q)))
    return share_ch, chunks, tiles


def cluster_smem_bytes(n: int, lines_contiguous: bool, cluster: int,
                       warps: int) -> int:
    """Dynamic shared memory of one CTA of the clustered variant
    (``cluster_layout`` of csrc/edt_bestfirst.cu): its share of the block
    (``share_ch`` chunks of :func:`cluster_shares`, laid out as the staged
    block: rows ``[share16][32]``, or lines ``[32][stride]`` with
    ``stride`` = 4 mod 32), the minima of all ``n_ch`` chunks of the axis,
    and one region per warp for the bounds of ``n_ch`` chunks and, with the
    positions contiguous, its padded ``[32][33]`` output tile."""
    n_ch = -(-n // CHUNK)
    share16 = -(-n_ch // cluster) * CHUNK
    if lines_contiguous:
        block, region = share16 * WARP_LINES, n_ch
    else:
        stride = share16 + (4 if share16 % 32 == 0 else 20)
        block, region = WARP_LINES * stride, max(n_ch, TILE_Q * (TILE_Q + 1))
    return 4 * (block + n_ch + warps * region)


def cluster_warps(n: int, lines_contiguous: bool, cluster: int) -> int:
    """Warps per CTA of the clustered variant with ``cluster`` CTAs, or 0
    where a share does not fit (:func:`fit_warps`)."""
    return fit_warps(lambda w: cluster_smem_bytes(n, lines_contiguous,
                                                  cluster, w))


def smallest_cluster(n: int, lines_contiguous: bool):
    """``(cluster, warps)``: the smallest of ``CLUSTER_SIZES`` whose shares
    fit, with its warps per CTA, or ``(0, 0)`` where none does."""
    for cluster in CLUSTER_SIZES:
        warps = cluster_warps(n, lines_contiguous, cluster)
        if warps:
            return cluster, warps
    return 0, 0


def cluster_plan(n: int, lines_contiguous: bool):
    """``(cluster, warps)`` of the clustered variant for an axis of ``n``:
    :func:`smallest_cluster` wherever the staged block does not fit
    (:func:`staged_warps` is 0), ``(0, 0)`` where the staged variant runs
    or no cluster's shares fit (the global variant runs)."""
    if staged_warps(n, lines_contiguous):
        return 0, 0
    return smallest_cluster(n, lines_contiguous)


@dataclasses.dataclass(frozen=True)
class LinePlan:
    """How the kernel takes ``f`` (``[..., lines, n]``): as ``[batch, lines,
    n]``, with the lines (the y pass's layout) or the positions (the z
    pass's) on the contiguous axis; ``copy`` if that view needed a copy;
    ``warps`` per CTA of the staged variant (:func:`staged_warps`), 0 for
    the others; ``cluster`` CTAs of ``cluster_warps`` warps of the
    clustered variant (:func:`cluster_plan`), 0 for the others. Neither:
    the global variant."""
    batch: int
    lines: int
    n: int
    lines_contiguous: bool
    copy: bool
    warps: int
    cluster: int = 0
    cluster_warps: int = 0

    @property
    def staged(self) -> bool:
        return self.warps > 0

    @property
    def clustered(self) -> bool:
        return self.cluster > 0


def plan_lines(f: Tensor):
    """``(plan, f3)``: the :class:`LinePlan` of a non-empty ``f`` and the
    ``[batch, lines, n]`` tensor the staged and clustered kernels read, a view of ``f``
    wherever one exists. The positions' layout is taken where the positions
    are contiguous, the lines' where the lines are; otherwise ``f`` is
    copied into the positions' layout."""
    n = f.shape[-1]
    lines = f.shape[-2] if f.dim() > 1 else 1
    f3 = f.reshape(-1, lines, n)
    copy = f3.data_ptr() != f.data_ptr()
    _, s_line, s_pos = f3.stride()
    if n == 1 or s_pos == 1:
        lines_contiguous = False
    elif lines == 1 or s_line == 1:
        lines_contiguous = True
    else:
        f3, copy, lines_contiguous = f3.contiguous(), True, False
    return LinePlan(f3.shape[0], lines, n, lines_contiguous, copy,
                    staged_warps(n, lines_contiguous),
                    *cluster_plan(n, lines_contiguous)), f3


def staged_output(plan: LinePlan, like: Tensor) -> Tensor:
    """The staged (or clustered) kernel's ``[batch, lines, n]`` output,
    dense in the plan's layout, so a dense input gets its own strides back."""
    if plan.lines_contiguous:
        shape = (plan.batch, plan.n, plan.lines)
    else:
        shape = (plan.batch, plan.lines, plan.n)
    out = torch.empty(shape, dtype=like.dtype, device=like.device)
    return out.transpose(1, 2) if plan.lines_contiguous else out


# ctypes types of the arguments every envelope kernel's C entry point takes
# after its pointers: B, n, L, the three strides of f, device, stream.
LINES_ARGTYPES = [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _library():
    lib = build.load_library("edt_bestfirst")
    for name in ("edt_bestfirst_chunk_rows", "edt_bestfirst_tile_rows"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    if (lib.edt_bestfirst_chunk_rows() != CHUNK
            or lib.edt_bestfirst_tile_rows() != TILE_Q):
        raise RuntimeError("edt_bestfirst.cu and edt_bestfirst.py disagree "
                           "on the chunk or tile size")
    smem = lib.edt_bestfirst_staged_smem
    smem.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    smem.restype = ctypes.c_longlong
    for n in (1, 37, 512, 513, 1024, 1500):
        for lc in (False, True):
            for warps in (8, 16):
                if smem(n, int(lc), warps) != staged_smem_bytes(n, lc, warps):
                    raise RuntimeError("edt_bestfirst.cu and edt_bestfirst.py "
                                       "disagree on the staged layout")
    csmem = lib.edt_bestfirst_cluster_smem
    csmem.argtypes = [ctypes.c_longlong] + [ctypes.c_int] * 3
    csmem.restype = ctypes.c_longlong
    for n in (1, 37, 513, 1800, 2048, 4100, 12000):
        for lc in (False, True):
            for cluster in CLUSTER_SIZES:
                for warps in (8, 16):
                    if csmem(n, int(lc), cluster, warps) != \
                            cluster_smem_bytes(n, lc, cluster, warps):
                        raise RuntimeError(
                            "edt_bestfirst.cu and edt_bestfirst.py disagree "
                            "on the clustered layout")
    lib.edt_bestfirst_cluster_max_active.argtypes = (
        [ctypes.c_longlong] + [ctypes.c_int] * 4)
    lib.edt_bestfirst_cluster_max_active.restype = ctypes.c_int
    lib.edt_bestfirst_cluster_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.edt_bestfirst_cluster_launch.restype = ctypes.c_int
    lib.edt_bestfirst_launch.argtypes = [ctypes.c_void_p] * 3 + LINES_ARGTYPES
    lib.edt_bestfirst_launch.restype = ctypes.c_int
    lib.edt_bestfirst_staged_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 9
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.edt_bestfirst_staged_launch.restype = ctypes.c_int
    return lib


def _launcher():
    """The global variant's C entry point."""
    return _library().edt_bestfirst_launch


def _check_input(f: Tensor) -> None:
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    if f.dtype != torch.float32:
        raise TypeError(f"f must be float32, got {f.dtype}")
    if f.dim() == 0:
        raise ValueError("f must have at least one axis")
    n = f.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"axis length {n} outside [1, {MAX_N}]")


def _stream_args(f: Tensor):
    return (f.device.index or 0,
            torch.cuda.current_stream(f.device).cuda_stream)


def launch_on_lines(f: Tensor, name: str, launch) -> Tensor:
    """The wrapper plumbing of the kernels that read ``f`` from global
    memory (the global best-first variant, the full sweep, the windowed
    walk). Checks that ``f`` is a float32 CUDA tensor whose last axis is in
    ``[1, MAX_N]``, views it as ``[B, n, L]`` with the lines on the
    contiguous axis (a transposed copy only where they are not), allocates
    the contiguous output and calls ``launch(ft, out, args)`` once, where
    ``args`` are the trailing arguments of ``LINES_ARGTYPES``. ``launch``
    starts the kernel on the current stream and returns its
    ``cudaError_t``; a non-zero one raises. Returns the result in ``f``'s
    shape; its strides follow the kernel's layout. An empty ``f`` launches
    nothing."""
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    n = f.shape[-1]
    # [B, lines, n] -> [B, n, lines]: lines become the contiguous axis.
    f3 = f.reshape(-1, f.shape[-2] if f.dim() > 1 else 1, n)
    ft = f3.transpose(1, 2)
    if ft.stride(2) != 1 and ft.shape[2] > 1:
        ft = ft.contiguous()
    b, _, lines = ft.shape
    out = torch.empty((b, n, lines), dtype=torch.float32, device=f.device)
    err = launch(ft, out, (b, n, lines, *ft.stride(), *_stream_args(f)))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError_t {err})")
    return out.transpose(1, 2).reshape(f.shape)


def launch_staged(plan: LinePlan, f3: Tensor, out3: Tensor) -> None:
    """One launch of the staged kernel on the current stream: ``f3`` as
    :func:`plan_lines` gives it, into ``out3`` (:func:`staged_output`)."""
    global launches_staged, elements_launched
    s_b, s_l, s_k = f3.stride()
    o_b, o_l, o_k = out3.stride()
    err = _library().edt_bestfirst_staged_launch(
        f3.data_ptr(), out3.data_ptr(), plan.batch, plan.n, plan.lines,
        s_b, s_k, s_l, o_b, o_k, o_l, int(plan.lines_contiguous),
        plan.warps, *_stream_args(f3))
    if err != 0:
        raise RuntimeError(f"edt_bestfirst staged kernel launch failed "
                           f"(cudaError_t {err})")
    launches_staged += 1
    elements_launched += f3.numel()


def _staged(f: Tensor, plan: LinePlan, f3: Tensor) -> Tensor:
    out3 = staged_output(plan, f3)
    launch_staged(plan, f3, out3)
    return out3.reshape(f.shape)


def parabolic_envelope_last_staged(f: Tensor) -> Tensor:
    """The staged variant on a CUDA tensor ``f``, on the current stream,
    without synchronizing; raises ``ValueError`` where the axis's line block
    does not fit shared memory. The result has ``f``'s strides where ``f``
    is dense."""
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    plan, f3 = plan_lines(f)
    if not plan.staged:
        raise ValueError(f"axis length {plan.n}: the staged kernel's line "
                         "block does not fit a block's shared memory")
    return _staged(f, plan, f3)


@functools.cache
def _resident_clusters(n: int, lines_contiguous: bool, cluster: int,
                       warps: int, device: int) -> int:
    return _library().edt_bestfirst_cluster_max_active(
        n, int(lines_contiguous), cluster, warps, device)


def launch_cluster(plan: LinePlan, f3: Tensor, out3: Tensor) -> None:
    """One launch of the clustered variant on the current stream: ``f3`` as
    :func:`plan_lines` gives it, into ``out3`` (:func:`staged_output`), with
    ``plan.cluster`` CTAs of ``plan.cluster_warps`` warps. Raises where the
    device cannot hold one such cluster (``cudaOccupancyMaxActiveClusters``,
    checked once per shape) or the launch fails."""
    global launches_cluster, elements_launched
    device = f3.device.index or 0
    held = _resident_clusters(plan.n, plan.lines_contiguous, plan.cluster,
                              plan.cluster_warps, device)
    if held <= 0:
        raise RuntimeError(
            f"the device holds {held} clusters of {plan.cluster} CTAs of "
            f"{plan.cluster_warps} warps for an axis of {plan.n}")
    s_b, s_l, s_k = f3.stride()
    o_b, o_l, o_k = out3.stride()
    err = _library().edt_bestfirst_cluster_launch(
        f3.data_ptr(), out3.data_ptr(), plan.batch, plan.n, plan.lines,
        s_b, s_k, s_l, o_b, o_k, o_l, int(plan.lines_contiguous),
        plan.cluster, plan.cluster_warps, *_stream_args(f3))
    if err != 0:
        raise RuntimeError(f"edt_bestfirst cluster kernel launch failed "
                           f"(cudaError_t {err})")
    launches_cluster += 1
    elements_launched += f3.numel()


def _clustered(f: Tensor, plan: LinePlan, f3: Tensor) -> Tensor:
    out3 = staged_output(plan, f3)
    launch_cluster(plan, f3, out3)
    return out3.reshape(f.shape)


def parabolic_envelope_last_cluster(f: Tensor,
                                    cluster: int | None = None) -> Tensor:
    """The clustered variant on a CUDA tensor ``f``, on the current stream,
    without synchronizing: with :func:`plan_lines`' cluster where it plans
    one, else (an axis the staged variant takes) :func:`smallest_cluster`;
    ``cluster`` forces a size of ``CLUSTER_SIZES``. Raises ``ValueError``
    where the shares do not fit. The result has ``f``'s strides where ``f``
    is dense."""
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    plan, f3 = plan_lines(f)
    lc = plan.lines_contiguous
    if cluster is not None:
        if cluster not in CLUSTER_SIZES:
            raise ValueError(f"cluster {cluster} not in {CLUSTER_SIZES}")
        size = (cluster, cluster_warps(plan.n, lc, cluster))
    elif plan.clustered:
        size = (plan.cluster, plan.cluster_warps)
    else:
        size = smallest_cluster(plan.n, lc)
    if not size[1]:
        raise ValueError(f"axis length {plan.n}: the clustered kernel's "
                         "shares do not fit a cluster's shared memory")
    plan = dataclasses.replace(plan, cluster=size[0], cluster_warps=size[1])
    return _clustered(f, plan, f3)


def parabolic_envelope_last_global(f: Tensor,
                                   hoist_cmin: bool = True) -> Tensor:
    """The global variant on a CUDA tensor ``f`` (any axis length), on the
    current stream, without synchronizing: with ``hoist_cmin`` the chunk minima come from
    :func:`_chunk_minima`, without it the kernel reduces them itself."""

    def launch(ft, out, args):
        global launches, launches_inkernel, elements_launched
        cmin = _chunk_minima(ft) if hoist_cmin else None
        err = _launcher()(ft.data_ptr(),
                          None if cmin is None else cmin.data_ptr(),
                          out.data_ptr(), *args)
        if err == 0:
            elements_launched += ft.numel()
            if hoist_cmin:
                launches += 1
            else:
                launches_inkernel += 1
        return err

    return launch_on_lines(f, "edt_bestfirst", launch)


def parabolic_envelope_last(f: Tensor, hoist_cmin: bool = True) -> Tensor:
    """Exact squared-distance transform along the last axis of ``f``.

    On a CUDA tensor this launches the kernel (building it at first use) on
    the current stream, without synchronizing, or raises; it never falls
    back. The staged variant runs wherever the axis's line block fits
    shared memory, the clustered one on longer axes up to a cluster's reach
    (:func:`plan_lines`), both for either ``hoist_cmin``; longer axes still
    take the global variant, whose ``hoist_cmin`` (as in the JAX package's
    ``parabolic_envelope_last_pallas_bestfirst``) takes the chunk minima
    from :func:`_chunk_minima` or, when False, has the kernel reduce them.
    All give the same bits. On a CPU tensor it runs
    :func:`parabolic_envelope_last_plain`."""
    if f.device.type == "cpu":
        return parabolic_envelope_last_plain(f)
    _check_input(f)
    if f.numel() == 0:
        return torch.empty_like(f)
    plan, f3 = plan_lines(f)
    if plan.staged:
        return _staged(f, plan, f3)
    if plan.clustered:
        return _clustered(f, plan, f3)
    return parabolic_envelope_last_global(f, hoist_cmin)
