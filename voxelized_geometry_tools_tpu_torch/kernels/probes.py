"""Primitive-rate probes: the CUDA kernels of ``csrc/probes.cu`` and their
plain PyTorch versions. Port of ``benchmarks/inkernel_microbench.py``, whose
four Pallas kernels measure the TPU rates of the primitives a fused render
march or carve kernel would be built from:

* :func:`vmem_gather`: ``out = sum_i table[idx_i]`` over ``n_iters`` rows
  of a table kept in fast memory (shared memory here);
* :func:`vmem_scatter`: ``acc[idx_i] += mask`` into a zeroed accumulator
  in fast memory;
* :func:`hbm_dma`: a ``depth``-deep ring of row copies from device memory;
  the output is the sum of the first ``n_iters - depth`` rows (the last
  ``depth`` copies are started and not summed, as on the TPU);
* :func:`vmem_batch_march`: per step, gather ``batch`` rows and advance
  every ray by ``t += max(sum_w row * 0.125, 0.001)``.

Row indices come from :func:`lcg_indices`, the TPU kernels' generator. Each
function takes ``replicas``: replica ``r`` runs the probe with seed
``seed + r`` into row ``r`` of the output, so ``replicas=1`` computes
exactly the TPU kernel's result and more replicas measure the whole card.
On the card the scatter runs one thread block cluster per replica
(:func:`scatter_plan`), both gathers spread each replica's rows over many
CTAs (:func:`gather_plan`, :func:`dma_plan`), and the march spreads each
replica's rays over CTAs and their steps over threads (:func:`march_plan`);
all four jump ahead in the LCG (:func:`lcg_jump`). On a
CUDA tensor a wrapper launches its kernel (building it at first use) or
raises; on a CPU tensor it runs the plain version. With integer-valued
tables every sum is exact, so kernels, plain versions and the JAX kernels
agree bit for bit; the scatter is exact for any mask, since every add into
a cell adds the same value, in whatever order its remote reductions land.
``launches`` counts kernel launches by probe name.

Run ``python -m voxelized_geometry_tools_tpu_torch.kernels.probes`` on a
card for the H100's rates (one JSON line; see :func:`main`).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import json
import time

import numpy as np
import torch

from . import build

Tensor = torch.Tensor

LCG_A = 1664525
LCG_C = 1013904223
# The TPU kernels' seeds.
GATHER_SEED = 12345
SCATTER_SEED = 54321
DMA_SEED = 99991
MARCH_SEED = 777
# Floor of the march probe's step, as on the TPU.
MARCH_MIN_STEP = 0.001
# Threads of a block: the column of a gather or scatter, the ray of a march.
MAX_THREADS = 1024
# The HBM probe moves a row with one warp in 16-byte pieces.
DMA_MAX_WIDTH = 128
DMA_MAX_DEPTH = 16
# The scatter kernel's threads per CTA and CTAs per cluster (the portable
# size), and the device-memory kernel's warps per CTA; csrc/probes.cu
# reports them, and loading the library checks them.
SCATTER_THREADS = 1024
SCATTER_CLUSTER = 8
DMA_WARPS = 16
# The shared-memory gather kernel's threads per CTA, and the march kernel's
# most threads per CTA and rows a thread loads before it sums any (checked
# as those are).
GATHER_THREADS = 1024
MARCH_THREADS = 1024
MARCH_UNROLL = 4
# The march kernel's routes to the table's rows: staged in each CTA's shared
# memory, or read from device memory (through L1 and L2).
MARCH_ROUTES = ("direct", "staged")
# Shared memory a march CTA keeps for its static variables, besides the
# staged table and its buffer of step values.
MARCH_STATIC_BYTES = 64
# An H100's opt-in shared memory a block (plans made without a device).
H100_BLOCK_BYTES = 232_448
# march_plan's defaults: the staged route from this many replicas for each
# SM on (where the table fits), and each route's CTAs for one replica,
# divided among the replicas (on an H100 at the probe's shape, one replica
# ran fastest direct over 64 CTAs, staged over 16, and 132 replicas over
# one CTA a replica by either route).
MARCH_STAGED_REPLICAS_PER_SM = 0.5
MARCH_CTAS = {"direct": 64, "staged": 16}
# Seeds of successive timed launches lie this far apart (more than any
# replica count), so each launch of the device-memory probe reads rows the
# launches before it mostly did not, and finds them cold in L2.
SEED_STRIDE = 1 << 16

launches = {"vmem_gather": 0, "vmem_scatter": 0, "hbm_dma": 0,
            "vmem_batch_march": 0}


def _lcg_terms(n: int):
    """``(A^i, A^(i-1) + ... + 1)`` for i = 1..n, uint32 (mod 2^32): state i
    after seed s0 of ``state = state * LCG_A + LCG_C`` is
    ``A^i s0 + C (A^(i-1) + ... + 1)``."""
    a_pow = np.cumprod(np.full(n, LCG_A, np.uint32), dtype=np.uint32)
    geo = np.cumsum(np.concatenate([np.ones(1, np.uint32), a_pow[:-1]]),
                    dtype=np.uint32)
    return a_pow, geo


def _lcg_states(seeds, n: int) -> np.ndarray:
    """``[len(seeds), n]`` uint32: states 1..n after each seed."""
    s0 = np.asarray(seeds, np.int64).astype(np.uint32).reshape(-1, 1)
    if n == 0:
        return np.zeros((s0.shape[0], 0), np.uint32)
    a_pow, geo = _lcg_terms(n)
    return a_pow * s0 + np.uint32(LCG_C) * geo


def lcg_jump(steps):
    """``(a, c)``, uint32 arrays shaped like ``steps``: ``k`` steps of the
    LCG are the map ``s -> a s + c`` (mod 2^32), for each ``k`` of
    ``steps``. Composed from the maps of 2^b steps, which commute."""
    k = np.asarray(steps, np.int64)
    a = np.ones(k.shape, np.uint32)
    c = np.zeros(k.shape, np.uint32)
    pa, pc = np.uint32(LCG_A), np.uint32(LCG_C)
    with np.errstate(over="ignore"):
        for bit in range(int(k.max(initial=0)).bit_length()):
            on = ((k >> bit) & 1).astype(bool)
            a, c = np.where(on, pa * a, a), np.where(on, pa * c + pc, c)
            pa, pc = pa * pa, pa * pc + pc
    return a, c


def magic_divisor(d: int):
    """``(m, shift)`` with ``floor(a / d) == (a * m) >> shift`` for every
    ``0 <= a < 2^31`` and ``m < 2^32``: ``shift = 31 + ceil(log2 d)``,
    ``m = ceil(2^shift / d)``. The error ``m d - 2^shift`` is below ``d <=
    2^(shift - 31)``, so it shifts no quotient of a 31-bit ``a``."""
    if not 1 <= d < 1 << 31:
        raise ValueError(f"divisor {d} outside [1, 2^31)")
    shift = 31 + (d - 1).bit_length()
    return -(-(1 << shift) // d), shift


def lcg_indices(seed, n: int, n_rows: int) -> np.ndarray:
    """Row indices of the TPU probes' generator, in int64: ``n`` of them for
    an int ``seed`` (``[len(seed), n]`` for a sequence of seeds). Each is
    ``abs(state) % n_rows`` of the state read as int32, after ``state =
    state * 1664525 + 1013904223`` in wrapping 32-bit arithmetic. Raises
    ``ValueError`` where a state is ``INT_MIN``, whose ``abs`` the TPU
    kernels would take as negative."""
    states = _lcg_states(np.atleast_1d(seed), n).view(np.int32)
    if (states == np.iinfo(np.int32).min).any():
        raise ValueError(f"the LCG sequence of seed {seed} reaches INT_MIN "
                         f"within {n} states")
    idx = (np.abs(states) % n_rows).astype(np.int64)
    return idx[0] if np.ndim(seed) == 0 else idx


@functools.lru_cache(maxsize=None)
def _check_sequences(seed: int, replicas: int, n: int) -> None:
    """Raises ``ValueError`` where one of the seeds ``seed .. seed +
    replicas - 1`` reaches ``INT_MIN`` within ``n`` states. Only one seed
    has ``INT_MIN`` as its state i, ``(INT_MIN - C (A^(i-1) + ... + 1))
    A^-i``, so a run of seeds is checked in O(n)."""
    if n == 0:
        return
    inv_pow = np.cumprod(np.full(n, pow(LCG_A, -1, 1 << 32), np.uint32),
                         dtype=np.uint32)
    _, geo = _lcg_terms(n)
    bad = (np.uint32(1 << 31) - np.uint32(LCG_C) * geo) * inv_pow
    if ((bad - np.uint32(seed % (1 << 32))) < replicas).any():
        raise ValueError(f"the LCG sequence of a seed in [{seed}, "
                         f"{seed + replicas}) reaches INT_MIN within {n} "
                         "states")


def fresh_seeds(seed: int, count: int, replicas: int, n: int):
    """An iterator over ``count`` seeds ``SEED_STRIDE`` apart, their
    sequences (``replicas`` of ``n`` states each) checked beforehand, so
    that taking one costs a timed loop nothing."""
    seeds = [seed + i * SEED_STRIDE for i in range(count)]
    for s in seeds:
        _check_sequences(s, replicas, n)
    return iter(seeds)


def _replica_indices(seed: int, replicas: int, n: int, n_rows: int,
                     device) -> Tensor:
    seeds = [seed + r for r in range(replicas)]
    return torch.from_numpy(lcg_indices(seeds, n, n_rows)).to(device)


# -- Plain versions -----------------------------------------------------------


def vmem_gather_plain(table: Tensor, n_iters: int, replicas: int = 1,
                      seed: int = GATHER_SEED) -> Tensor:
    """``[replicas, width]``: the sum of ``n_iters`` LCG rows of ``table``
    per replica."""
    idx = _replica_indices(seed, replicas, n_iters, table.shape[0],
                           table.device)
    return table[idx].sum(dim=1)


def vmem_scatter_plain(mask: Tensor, n_iters: int, n_rows: int,
                       replicas: int = 1, seed: int = SCATTER_SEED) -> Tensor:
    """``[replicas, n_rows, width]``: ``mask`` ([1, width]) added into a
    zeroed accumulator at ``n_iters`` LCG rows per replica."""
    width = mask.shape[-1]
    idx = _replica_indices(seed, replicas, n_iters, n_rows, mask.device)
    rows = idx + n_rows * torch.arange(replicas, device=mask.device)[:, None]
    acc = torch.zeros(replicas * n_rows, width, dtype=mask.dtype,
                      device=mask.device)
    acc.index_add_(0, rows.reshape(-1),
                   mask.reshape(1, width).expand(rows.numel(), width))
    return acc.reshape(replicas, n_rows, width)


def hbm_dma_plain(table: Tensor, n_iters: int, depth: int,
                  replicas: int = 1, seed: int = DMA_SEED) -> Tensor:
    """``[replicas, width]``: the sum of the first ``n_iters - depth`` LCG
    rows of ``table`` per replica."""
    _check_dma_args(table, n_iters, depth)
    idx = _replica_indices(seed, replicas, n_iters, table.shape[0],
                           table.device)
    return table[idx[:, :n_iters - depth]].sum(dim=1)


def vmem_batch_march_plain(table: Tensor, t0: Tensor, n_steps: int,
                           replicas: int = 1,
                           seed: int = MARCH_SEED) -> Tensor:
    """``[replicas, batch]``: ``t0`` ([1, batch]) advanced ``n_steps`` times
    by ``max(sum_w row * 0.125, 0.001)`` of the ray's LCG row; ray ``j`` of
    step ``k`` takes state ``k * batch + j + 1`` of its replica's
    sequence."""
    batch = t0.shape[-1]
    idx = _replica_indices(seed, replicas, n_steps * batch, table.shape[0],
                           table.device).reshape(replicas, n_steps, batch)
    floor = torch.tensor(MARCH_MIN_STEP, dtype=table.dtype,
                         device=table.device)
    t = t0.reshape(1, batch).expand(replicas, batch)
    for k in range(n_steps):
        d = (table[idx[:, k]] * 0.125).sum(dim=-1)
        t = t + torch.maximum(d, floor)
    return t


# -- Plans --------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ScatterPlan:
    """One replica's accumulator over a cluster of ``SCATTER_CLUSTER`` CTAs:
    CTA ``k`` owns rows ``[k * rows_per_cta, (k + 1) * rows_per_cta)``
    (clipped to ``n_rows``; ``rows_per_cta`` a multiple of 4, so each slice
    starts on 16 bytes) as a float32 slice in its ``smem_bytes`` of shared
    memory. Thread ``t`` of the cluster adds column ``t % width`` of
    iterations ``t // width + j * rows_per_pass``."""
    n_rows: int
    width: int
    rows_per_cta: int
    smem_bytes: int

    def slices(self):
        """``(lo, hi)`` of each CTA's rows (empty where ``lo == hi``)."""
        r = self.rows_per_cta
        return [(min(k * r, self.n_rows), min((k + 1) * r, self.n_rows))
                for k in range(SCATTER_CLUSTER)]

    @property
    def rows_per_pass(self) -> int:
        """Iterations the cluster's threads take at once, a row each."""
        return SCATTER_CLUSTER * SCATTER_THREADS // self.width


def scatter_plan(n_rows: int, width: int, block_limit: int) -> ScatterPlan:
    """The slices of a ``[n_rows, width]`` float32 accumulator over a
    cluster, each within ``block_limit`` bytes (the device's opt-in shared
    memory per block). Raises ``ValueError`` where a slice does not fit."""
    if n_rows < 1 or width < 1:
        raise ValueError(f"accumulator {n_rows} x {width} is empty")
    rows = -(-n_rows // SCATTER_CLUSTER)
    rows += -rows % 4
    smem = -(-rows * width // 4) * 16
    if smem > block_limit:
        raise ValueError(
            f"the accumulator of {n_rows} x {width} float32 "
            f"({4 * n_rows * width} bytes) does not fit a cluster of "
            f"{SCATTER_CLUSTER} CTAs of {block_limit} bytes of shared memory "
            "each")
    return ScatterPlan(n_rows, width, rows, smem)


@dataclasses.dataclass(frozen=True)
class DmaPlan:
    """One replica's ``n_iters`` rows over ``ctas`` CTAs of ``DMA_WARPS``
    warps. ``shares[w] = (a, c, rows, summed)`` for warp ``w = cta *
    DMA_WARPS + warp``: its first state is ``a * seed + c`` (mod 2^32), it
    reads the ``rows`` iterations from ``lo[w]`` on, and sums the first
    ``summed`` of them."""
    ctas: int
    lo: np.ndarray
    shares: np.ndarray


def dma_plan(n_iters: int, depth: int, replicas: int,
             sm_count: int) -> DmaPlan:
    """Splits each replica's sequence into contiguous, balanced shares over
    enough warps to fill the card: one CTA of ``DMA_WARPS`` warps per SM
    for one replica (at depth 8 that keeps 16,896 rows in flight), divided
    among the replicas, and no more CTAs than the rows fill. Only
    iterations below ``n_iters - depth`` are summed."""
    ctas = max(1, min(sm_count // replicas, -(-n_iters // DMA_WARPS)))
    warps = ctas * DMA_WARPS
    bounds = np.arange(warps + 1, dtype=np.int64) * n_iters // warps
    lo, rows = bounds[:-1], np.diff(bounds)
    a, c = lcg_jump(lo + 1)
    summed = np.clip(n_iters - depth - lo, 0, rows)
    shares = np.stack([a, c, rows.astype(np.uint32),
                       summed.astype(np.uint32)], axis=1)
    return DmaPlan(ctas, lo, shares)


@dataclasses.dataclass(frozen=True)
class GatherPlan:
    """One replica's ``n_iters`` rows over ``ctas`` CTAs of
    ``GATHER_THREADS`` threads, each CTA holding the table in its shared
    memory. A row group of ``group`` threads takes one row a step, each
    thread ``vec`` float4 pieces of it (2, for a width that is a multiple
    of 8; 0: one float); a CTA has ``groups`` groups. ``shares[k] = (a, c,
    lo, rows)`` for group ``k = cta * groups + g``: its first state is ``a *
    seed + c`` (mod 2^32), and it sums the ``rows`` iterations from ``lo``
    on, in order."""
    vec: int
    group: int
    groups: int
    ctas: int
    shares: np.ndarray

    @property
    def pieces(self) -> int:
        """Pieces of a row: float4s, or floats where ``vec`` is 0."""
        return self.group * max(self.vec, 1)


def gather_plan(n_iters: int, width: int, replicas: int, sm_count: int,
                ctas: int | None = None) -> GatherPlan:
    """Splits each replica's sequence into contiguous, balanced shares over
    the row groups of ``ctas`` CTAs: by default one CTA for every two SMs
    for one replica (on an H100 the one-replica probe ran fastest there:
    fewer CTAs pay less stage and reduction, more share the rows), divided
    among the replicas, and no more CTAs than give every group a row. A
    thread takes two float4s of a row where the width is a
    multiple of 8 (the whole corner row of width 8), else one float."""
    if width % 8 == 0:
        vec, pieces = 2, width // 4
    else:
        vec, pieces = 0, width
    group = pieces // max(vec, 1)
    if not 1 <= group <= GATHER_THREADS:
        raise ValueError(f"width {width} outside [1, {MAX_THREADS}]")
    groups = GATHER_THREADS // group
    if ctas is None:
        ctas = max(1, min(sm_count // (2 * replicas),
                          -(-n_iters // groups)))
    if ctas < 1:
        raise ValueError(f"ctas={ctas} must be at least 1")
    total = ctas * groups
    bounds = np.arange(total + 1, dtype=np.int64) * n_iters // total
    lo, rows = bounds[:-1], np.diff(bounds)
    a, c = lcg_jump(lo + 1)
    shares = np.stack([a, c, lo.astype(np.uint32), rows.astype(np.uint32)],
                      axis=1)
    return GatherPlan(vec, group, groups, ctas, shares)


@dataclasses.dataclass(frozen=True)
class MarchPlan:
    """One replica's ``batch`` rays over ``ctas`` CTAs of ``rays * group``
    threads: CTA ``c`` takes rays ``[c * rays, (c + 1) * rays)`` (clipped to
    the batch), thread ``t`` ray ``t % rays`` and step lane ``g = t //
    rays``. The steps go in chunks of ``chunk = per_thread * group``: of the
    chunk from ``c0``, lane ``g`` takes steps ``c0 + g + u * group`` for ``u
    < per_thread`` (those below ``n_steps``), so a thread's successive steps
    lie ``group`` apart. ``starts`` is ``[batch + group, 2]`` uint32: the
    ray maps ``lcg_jump(j + 1)``, then the step maps ``lcg_jump(g *
    batch)``; a thread's first state is its step map applied after its ray
    map to the replica's seed (state ``g * batch + j + 1``), each later one
    ``stride = lcg_jump(group * batch)`` of the one before. Route
    ``"staged"`` copies the table into each CTA's shared memory,
    ``"direct"`` reads rows from device memory."""
    route: str
    ctas: int
    rays: int
    group: int
    per_thread: int
    starts: np.ndarray
    stride: tuple

    @property
    def threads(self) -> int:
        return self.rays * self.group

    @property
    def chunk(self) -> int:
        return self.per_thread * self.group

    def smem_bytes(self, table_bytes: int) -> int:
        """A CTA's dynamic shared memory: the staged table (rounded up to
        16 bytes) and the ``[chunk][rays]`` float32 step values."""
        table = -(-table_bytes // 16) * 16 if self.route == "staged" else 0
        return table + 4 * self.chunk * self.rays


def march_plan(batch: int, n_steps: int, replicas: int, sm_count: int,
               route: str | None = None, ctas: int | None = None,
               table_bytes: int = 0,
               block_limit: int = H100_BLOCK_BYTES) -> MarchPlan:
    """Splits each replica's rays over CTAs and their steps over threads,
    for a table of ``table_bytes`` and ``block_limit`` bytes of shared
    memory a block. By default the route is ``"staged"`` from
    ``MARCH_STAGED_REPLICAS_PER_SM`` replicas an SM on, where the table
    fits beside a step value a ray, else ``"direct"``, and the CTAs a
    replica are the route's ``MARCH_CTAS`` over the replicas (at least 1);
    ``ctas``, forced or not, is rounded to what gives every CTA a ray. A
    ray has up to ``n_steps / MARCH_UNROLL`` threads (as many as the CTA's
    MARCH_THREADS allow), each ``MARCH_UNROLL`` rows in flight; a chunk
    holds every step where its values fit shared memory. Raises
    ``ValueError`` for an unknown route, or a staged table that leaves no
    room for one step value a ray."""
    if route not in (None,) + MARCH_ROUTES:
        raise ValueError(f"route {route!r} is none of {MARCH_ROUTES}")
    if not 1 <= batch <= MARCH_THREADS:
        raise ValueError(f"batch {batch} outside [1, {MARCH_THREADS}]")
    staged_table = -(-table_bytes // 16) * 16
    if route is None:
        fits = staged_table + MARCH_STATIC_BYTES + 4 * batch <= block_limit
        many = replicas >= MARCH_STAGED_REPLICAS_PER_SM * sm_count
        route = "staged" if fits and many else "direct"
    if ctas is None:
        ctas = max(1, round(MARCH_CTAS[route] / replicas))
    if ctas < 1:
        raise ValueError(f"ctas={ctas} must be at least 1")
    rays = -(-batch // min(ctas, batch))
    ctas = -(-batch // rays)
    room = block_limit - MARCH_STATIC_BYTES
    if route == "staged":
        room -= staged_table
    group = max(1, min(MARCH_THREADS // rays, -(-n_steps // MARCH_UNROLL),
                       room // (4 * rays)))
    per_thread = max(1, min(-(-n_steps // group),
                            room // (4 * rays * group)))
    if 4 * rays * group * per_thread > room:
        raise ValueError(
            f"a table of {table_bytes} bytes staged in shared memory leaves "
            f"{room} of {block_limit} bytes, less than one step value for "
            f"each of {rays} rays")
    a, c = lcg_jump(np.r_[np.arange(1, batch + 1),
                          np.arange(group) * batch])
    stride = tuple(int(x) for x in lcg_jump(group * batch))
    return MarchPlan(route, ctas, rays, group, per_thread,
                     np.stack([a, c], axis=1), stride)


# -- Kernels ------------------------------------------------------------------


@functools.cache
def _library():
    lib = build.load_library("probes")
    lib.probes_max_shared_bytes.argtypes = [ctypes.c_int]
    lib.probes_max_shared_bytes.restype = ctypes.c_int
    for fn, want in ((lib.probes_scatter_threads, SCATTER_THREADS),
                     (lib.probes_scatter_cluster, SCATTER_CLUSTER),
                     (lib.probes_dma_warps, DMA_WARPS),
                     (lib.probes_gather_threads, GATHER_THREADS),
                     (lib.probes_march_threads, MARCH_THREADS),
                     (lib.probes_march_unroll, MARCH_UNROLL)):
        fn.argtypes = []
        fn.restype = ctypes.c_int
        if fn() != want:
            raise RuntimeError(f"csrc/probes.cu has {fn()} where probes.py "
                               f"plans with {want}")
    lib.probe_vmem_scatter_max_clusters.argtypes = [ctypes.c_longlong,
                                                     ctypes.c_int]
    lib.probe_vmem_scatter_max_clusters.restype = ctypes.c_int
    lib.probe_empty_launch.argtypes = [ctypes.c_int, ctypes.c_void_p]
    # replicas, device, stream
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe_vmem_gather_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
        + [ctypes.c_uint32] * 2 + [ctypes.c_int] + tail)
    lib.probe_vmem_scatter_launch.argtypes = (
        [ctypes.c_void_p] * 3
        + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
           ctypes.c_int, ctypes.c_int, ctypes.c_int]
        + [ctypes.c_uint32] * 6 + [ctypes.c_longlong, ctypes.c_int,
                                   ctypes.c_void_p])
    lib.probe_hbm_dma_launch.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int] + tail)
    lib.probe_vmem_batch_march_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_uint32] * 4
        + [ctypes.c_int] + tail)
    for fn in (lib.probe_empty_launch, lib.probe_vmem_gather_launch,
               lib.probe_vmem_scatter_launch, lib.probe_hbm_dma_launch,
               lib.probe_vmem_batch_march_launch):
        fn.restype = ctypes.c_int
    return lib


def scatter_starts(rows_per_pass: int):
    """``([rows_per_pass, 2] uint32, a, c)``: the LCG map of ``i + 1`` steps
    for each iteration ``i`` a scatter thread starts at, and the map of
    ``rows_per_pass`` steps by which it goes on."""
    a, c = lcg_jump(np.arange(1, rows_per_pass + 1))
    return np.stack([a, c], 1), int(a[-1]), int(c[-1])


@functools.lru_cache(maxsize=64)
def _scatter_launch_args(n_rows: int, width: int, device: torch.device):
    """The scatter kernel's plan-dependent launch arguments for one shape
    and device, made once: the start maps on ``device`` and the ints from
    ``rows_per_cta`` to ``smem`` of ``probe_vmem_scatter_launch``. Raises
    ``ValueError`` where the accumulator does not fit a cluster or the
    device holds no such cluster."""
    plan = scatter_plan(n_rows, width, max_shared_bytes(device))
    held = _library().probe_vmem_scatter_max_clusters(plan.smem_bytes,
                                                      device.index or 0)
    if held < 1:
        raise ValueError(
            f"the device holds {held} clusters of {SCATTER_CLUSTER} CTAs "
            f"with {plan.smem_bytes} bytes of shared memory each "
            f"(accumulator {n_rows} x {width})")
    starts, stride_a, stride_c = scatter_starts(plan.rows_per_pass)
    starts = torch.from_numpy(starts.view(np.int32)).to(device)
    return starts, (plan.rows_per_cta, plan.rows_per_pass,
                    *magic_divisor(n_rows), *magic_divisor(plan.rows_per_cta),
                    stride_a, stride_c, plan.smem_bytes)


@functools.lru_cache(maxsize=64)
def _dma_shares(n_iters: int, depth: int, replicas: int,
                device: torch.device):
    """The :func:`dma_plan` of a launch and its shares as int32 on
    ``device`` (made once per shape and device)."""
    plan = dma_plan(n_iters, depth, replicas,
                    torch.cuda.get_device_properties(device)
                    .multi_processor_count)
    return plan, torch.from_numpy(plan.shares.view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _gather_shares(n_iters: int, width: int, replicas: int, ctas,
                   device: torch.device):
    """The :func:`gather_plan` of a launch and its shares as int32 on
    ``device`` (made once per shape and device)."""
    plan = gather_plan(n_iters, width, replicas,
                       torch.cuda.get_device_properties(device)
                       .multi_processor_count, ctas)
    return plan, torch.from_numpy(plan.shares.view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _march_starts(batch: int, n_steps: int, replicas: int, route, ctas,
                  table_bytes: int, device: torch.device):
    """The :func:`march_plan` of a launch and its start maps as int32 on
    ``device`` (made once per shape and device)."""
    plan = march_plan(batch, n_steps, replicas,
                      torch.cuda.get_device_properties(device)
                      .multi_processor_count, route, ctas, table_bytes,
                      max_shared_bytes(device))
    return plan, torch.from_numpy(plan.starts.view(np.int32)).to(device)


@functools.lru_cache(maxsize=64)
def _split_scratch(replicas: int, ctas: int, width: int,
                   device: torch.device, stream: int):
    """The scratch of the kernels that split a replica over CTAs (both
    gathers) for launches on one stream: the CTAs' partial sums, which each
    launch writes before it reads them, and the arrival counters, zeroed
    once and left at 0 again by each launch. Launches on one stream do not
    overlap, so they share it."""
    return (torch.empty(replicas * ctas * width, dtype=torch.float32,
                        device=device),
            torch.zeros(replicas, dtype=torch.int32, device=device))


def max_shared_bytes(device: torch.device) -> int:
    """Dynamic shared memory a block may opt into on ``device`` (232,448
    bytes, 227 KiB, on an H100)."""
    return _library().probes_max_shared_bytes(device.index or 0)


def _check_input(x: Tensor, name: str, ndim: int) -> None:
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.dim() != ndim or not x.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {ndim}-D tensor, got "
                         f"shape {tuple(x.shape)}")


def _check_shared(n_rows: int, width: int, device, what: str) -> None:
    need = n_rows * width * 4
    limit = max_shared_bytes(device)
    if need > limit:
        raise ValueError(f"{what} of {n_rows} x {width} float32 ({need} "
                         f"bytes) does not fit the {limit} bytes of shared "
                         "memory a block may use")


def _check_replicas(replicas: int) -> None:
    if replicas < 1:
        raise ValueError(f"replicas={replicas} must be at least 1")


def _check_dma_args(table: Tensor, n_iters: int, depth: int) -> None:
    width = table.shape[-1]
    if not 1 <= depth <= DMA_MAX_DEPTH:
        raise ValueError(f"depth={depth} outside [1, {DMA_MAX_DEPTH}]")
    if n_iters < depth:
        raise ValueError(f"n_iters={n_iters} is below depth={depth}")
    if width % 4 or not 4 <= width <= DMA_MAX_WIDTH:
        raise ValueError(f"width {width} must be a multiple of 4 in [4, "
                         f"{DMA_MAX_WIDTH}] (one warp, 16 bytes a lane)")


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _launch(name: str, fn, *args, device, stream=None) -> None:
    err = fn(*args, device.index or 0,
             _stream(device) if stream is None else stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError_t {err})")
    launches[name] += 1


def vmem_gather(table: Tensor, n_iters: int, replicas: int = 1,
                seed: int = GATHER_SEED) -> Tensor:
    """:func:`vmem_gather_plain` of a ``[n_rows, width]`` float32 table, by
    the kernel on a CUDA tensor: each replica's rows split over the CTAs of
    :func:`gather_plan`, each CTA with the table in its shared memory, the
    sums reduced in a fixed order (the same bits on every run)."""
    if table.device.type == "cpu":
        return vmem_gather_plain(table, n_iters, replicas, seed)
    return vmem_gather_split(table, n_iters, None, replicas, seed)


def vmem_gather_split(table: Tensor, n_iters: int, ctas: int | None,
                      replicas: int = 1, seed: int = GATHER_SEED) -> Tensor:
    """:func:`vmem_gather` on a CUDA tensor with ``ctas`` CTAs a replica
    (``None``: :func:`gather_plan`'s choice), for timing the split."""
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    _check_input(table, "table", 2)
    _check_replicas(replicas)
    n_rows, width = table.shape
    if width > MAX_THREADS:
        raise ValueError(f"width {width} above {MAX_THREADS}")
    if n_iters >= 2 ** 31:
        raise ValueError(f"{n_iters} iterations above the int32 range")
    dev = table.device
    _check_shared(n_rows, width, dev, "the table")
    _check_sequences(seed, replicas, n_iters)
    plan, shares = _gather_shares(n_iters, width, replicas, ctas, dev)
    stream = _stream(dev)
    partials, arrivals = _split_scratch(replicas, plan.ctas, width, dev,
                                        stream)
    out = torch.empty(replicas, width, dtype=torch.float32, device=dev)
    _launch("vmem_gather", _library().probe_vmem_gather_launch,
            table.data_ptr(), out.data_ptr(), partials.data_ptr(),
            arrivals.data_ptr(), shares.data_ptr(), n_rows, width, plan.vec,
            plan.group, plan.groups, plan.ctas, *magic_divisor(n_rows), seed,
            replicas, device=dev, stream=stream)
    return out


def vmem_scatter(mask: Tensor, n_iters: int, n_rows: int, replicas: int = 1,
                 seed: int = SCATTER_SEED) -> Tensor:
    """:func:`vmem_scatter_plain` of a ``[1, width]`` float32 mask, by the
    cluster kernel on a CUDA tensor (one cluster per replica, the
    accumulator in its CTAs' shared memory, :func:`scatter_plan`). Raises
    ``ValueError`` where the accumulator does not fit a cluster or the
    device holds no such cluster."""
    if mask.device.type == "cpu":
        return vmem_scatter_plain(mask, n_iters, n_rows, replicas, seed)
    _check_input(mask, "mask", 2)
    _check_replicas(replicas)
    width = mask.shape[1]
    if mask.shape[0] != 1 or width > MAX_THREADS:
        raise ValueError(f"mask must be [1, width <= {MAX_THREADS}], got "
                         f"{tuple(mask.shape)}")
    dev = mask.device
    starts, plan_args = _scatter_launch_args(n_rows, width, dev)
    _check_sequences(seed, replicas, n_iters)
    out = torch.empty(replicas, n_rows, width, dtype=torch.float32,
                      device=dev)
    _launch("vmem_scatter", _library().probe_vmem_scatter_launch,
            mask.data_ptr(), out.data_ptr(), starts.data_ptr(), n_rows, width,
            n_iters, seed, replicas, *plan_args, device=dev)
    return out


def hbm_dma(table: Tensor, n_iters: int, depth: int, replicas: int = 1,
            seed: int = DMA_SEED) -> Tensor:
    """:func:`hbm_dma_plain` of a ``[n_rows, width]`` float32 table in device
    memory, by the kernel on a CUDA tensor: each replica's rows split over
    the CTAs of :func:`dma_plan`, ``depth`` rows in flight per warp through
    a ``cp.async`` ring, partial sums reduced in a fixed order (the same
    bits on every run)."""
    if table.device.type == "cpu":
        return hbm_dma_plain(table, n_iters, depth, replicas, seed)
    _check_input(table, "table", 2)
    _check_replicas(replicas)
    _check_dma_args(table, n_iters, depth)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    n_rows, width = table.shape
    if n_rows >= 2 ** 31 or n_iters >= 2 ** 31:
        raise ValueError(f"{n_rows} rows or {n_iters} iterations above the "
                         "int32 range")
    _check_sequences(seed, replicas, n_iters)
    dev = table.device
    plan, shares = _dma_shares(n_iters, depth, replicas, dev)
    stream = _stream(dev)
    partials, arrivals = _split_scratch(replicas, plan.ctas, width, dev,
                                        stream)
    out = torch.empty(replicas, width, dtype=torch.float32, device=dev)
    _launch("hbm_dma", _library().probe_hbm_dma_launch, table.data_ptr(),
            out.data_ptr(), partials.data_ptr(), arrivals.data_ptr(),
            shares.data_ptr(), n_rows, width, plan.ctas, depth, seed,
            replicas, device=dev, stream=stream)
    return out


def empty_kernel(device: torch.device) -> None:
    """Launches ``csrc/probes.cu``'s empty kernel (one warp) on the current
    stream: what a launch costs the card, the floor under every probe's
    time. Counted nowhere."""
    err = _library().probe_empty_launch(device.index or 0, _stream(device))
    if err != 0:
        raise RuntimeError(f"empty kernel launch failed (cudaError_t {err})")


def vmem_batch_march(table: Tensor, t0: Tensor, n_steps: int,
                     replicas: int = 1, seed: int = MARCH_SEED) -> Tensor:
    """:func:`vmem_batch_march_plain` of a ``[n_rows, width]`` float32 table
    and ``[1, batch]`` start depths, by the kernel on a CUDA tensor: each
    replica's rays over the CTAs of :func:`march_plan`, their steps' rows
    read by many threads at once (from the table staged in shared memory or
    from device memory, as the plan picks), each ray's adds in step order
    (the sequential chain's bits)."""
    if table.device.type == "cpu":
        return vmem_batch_march_plain(table, t0, n_steps, replicas, seed)
    return vmem_batch_march_split(table, t0, n_steps, None, None, replicas,
                                  seed)


def vmem_batch_march_split(table: Tensor, t0: Tensor, n_steps: int,
                           route: str | None, ctas: int | None,
                           replicas: int = 1,
                           seed: int = MARCH_SEED) -> Tensor:
    """:func:`vmem_batch_march` on a CUDA tensor by ``route`` (one of
    ``MARCH_ROUTES``) with ``ctas`` CTAs a replica (``None``: the plan's
    choice), for timing each. Raises ``ValueError`` where the table does
    not fit a block's shared memory (either route, as the probe has always
    taken it) or a forced staged table leaves no room for the steps."""
    if table.device.type != "cuda":
        raise ValueError(f"unsupported device {table.device}")
    _check_input(table, "table", 2)
    _check_input(t0, "t0", 2)
    _check_replicas(replicas)
    n_rows, width = table.shape
    batch = t0.shape[1]
    if t0.shape[0] != 1 or not 1 <= batch <= MAX_THREADS:
        raise ValueError(f"t0 must be [1, batch <= {MAX_THREADS}], got "
                         f"{tuple(t0.shape)}")
    if not 0 <= n_steps < 2 ** 31:
        raise ValueError(f"n_steps={n_steps} outside [0, 2^31)")
    dev = table.device
    _check_shared(n_rows, width, dev, "the table")
    _check_sequences(seed, replicas, n_steps * batch)
    plan, starts = _march_starts(batch, n_steps, replicas, route, ctas,
                                 n_rows * width * 4, dev)
    out = torch.empty(replicas, batch, dtype=torch.float32, device=dev)
    _launch("vmem_batch_march", _library().probe_vmem_batch_march_launch,
            table.data_ptr(), t0.data_ptr(), out.data_ptr(),
            starts.data_ptr(), n_rows, width, batch, n_steps, plan.rays,
            plan.group, plan.per_thread, plan.ctas, plan.route == "staged",
            *magic_divisor(n_rows), *plan.stride, seed, replicas, device=dev)
    return out


# -- Entry point --------------------------------------------------------------

# The card's shapes: the corner row's real width (8 float32) for the
# shared-memory probes (the TPU's 4096 x 128 table, 2 MiB, does not fit a
# block's 227 KiB; the scatter's accumulator spans a cluster, so the TPU's
# 8192-row one runs at this width), the TPU's 2^20 x 128 table for the
# device-memory probe.
WIDTH = 8
TABLE_ROWS = 4096
GATHER_ITERS = 100_000
SCATTER_ITERS = 100_000
ACC_ROWS = (2048, 4096, 8192)
# The TPU's own width, 128, over a cluster (1 MiB).
WIDE_ACC_ROWS = 2048
DMA_ROWS, DMA_WIDTH, DMA_ITERS = 1 << 20, 128, 20_000
DMA_DEPTHS = (2, 8, 16)
# CTAs a replica of the one-replica gather's sweep (gather_plan takes 66 on a
# 132-SM card).
GATHER_CTA_SWEEP = (132, 98, 66, 33, 16, 8, 1)
MARCH_STEPS = 64
MARCH_BATCHES = (64, 256)


def integer_table(n_rows: int, width: int, device, seed: int = 0) -> Tensor:
    """Random integers in [-8, 8] as float32, made on ``device``: every sum
    the probes take of them is exact."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-8, 9, (n_rows, width), generator=gen,
                         device=device).to(torch.float32)


TIMED_CALLS = 10
# Cycles per second the card's spin is sized by (above the H100's 1.98 GHz
# boost clock, so a spin lasts at least as long as asked), and the longest
# spin a queued timing asks for, in seconds.
SPIN_HZ = 2.0e9
MAX_SPIN_S = 0.2


def cuda_ms(fn, reps: int = TIMED_CALLS) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``reps`` calls, after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def queued_ms(fn, reps: int = TIMED_CALLS) -> float:
    """Mean milliseconds per call of ``fn`` as the card runs it: as
    :func:`cuda_ms`, with the timed calls queued behind a spin of the card
    (``torch.cuda._sleep``) that outlasts the host's time to enqueue them,
    so the launches' host cost does not pace the card. For ``fn`` that does
    not synchronize. Raises ``RuntimeError`` where the host still fell
    behind the card."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    fn()
    host_s = time.perf_counter() - t
    torch.cuda.synchronize()
    # 20 ms to spare: the host's cores are shared, and one call's host time
    # does not bound a stall among the next ``reps``.
    spin_s = min(4 * reps * host_s + 0.02, MAX_SPIN_S)
    queued = torch.cuda.Event()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(spin_s * SPIN_HZ))
    queued.record()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    ran_dry = queued.query()
    torch.cuda.synchronize()
    if ran_dry:
        raise RuntimeError(f"the host took longer to enqueue {reps} calls "
                           f"than the card's {spin_s:.4f} s spin")
    return start.elapsed_time(stop) / reps


def launch_floor_ms(device: torch.device, reps: int = 100) -> float:
    """The empty kernel's time per launch, timed as the probes are."""
    return queued_ms(lambda: empty_kernel(device), reps)


def main() -> dict:
    """The probes at the card's shapes, for one replica (the TPU kernels'
    own measurement, the keys of ``inkernel_microbench.main()``: on the card
    the scatter spans one cluster and the device-memory gather the whole
    card) and for one replica per SM (``full_card``), as ns per row (per
    ray-step for the march), timed by :func:`queued_ms`; the full-card
    numbers are the aggregate time per row over all replicas. Each timed
    launch of the device-memory probe reads a fresh row sequence.
    ``launch_floor_ms`` is the empty kernel's time, ``fixed_ms`` what a
    scatter or gather launch costs besides its rows, and
    ``vmem_gather_cta_sweep_ms`` the one-replica gather's time by CTAs a
    replica. Prints
    the dict as one JSON line and returns it."""
    if not torch.cuda.is_available():
        raise SystemExit("probes: no CUDA device; the probes run only on a "
                         "CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    replicas_full = torch.cuda.get_device_properties(
        dev).multi_processor_count
    table = integer_table(TABLE_ROWS, WIDTH, dev)
    mask = integer_table(1, WIDTH, dev, seed=1)
    wide_mask = integer_table(1, DMA_WIDTH, dev, seed=1)
    big = integer_table(DMA_ROWS, DMA_WIDTH, dev, seed=2)
    results = {"device": torch.cuda.get_device_name(dev),
               "replicas_full": replicas_full,
               "shapes": {"table": [TABLE_ROWS, WIDTH],
                          "gather_iters": GATHER_ITERS,
                          "scatter_acc": [[r, WIDTH] for r in ACC_ROWS]
                          + [[WIDE_ACC_ROWS, DMA_WIDTH]],
                          "scatter_iters": SCATTER_ITERS,
                          "dma_table": [DMA_ROWS, DMA_WIDTH],
                          "dma_iters": DMA_ITERS,
                          "march_steps": MARCH_STEPS,
                          "march_batches": list(MARCH_BATCHES)},
               "launch_floor_ms": launch_floor_ms(dev)}
    full = {}
    for reps, out in ((1, results), (replicas_full, full)):
        ms = queued_ms(lambda: vmem_gather(table, GATHER_ITERS, reps))
        out["vmem_gather_ns_per_row"] = ms * 1e6 / (GATHER_ITERS * reps)
        for acc_rows in ACC_ROWS:
            ms = queued_ms(lambda: vmem_scatter(mask, SCATTER_ITERS,
                                                acc_rows, reps))
            out[f"vmem_scatter_ns_per_row_{acc_rows}"] = (
                ms * 1e6 / (SCATTER_ITERS * reps))
        ms = queued_ms(lambda: vmem_scatter(wide_mask, SCATTER_ITERS,
                                            WIDE_ACC_ROWS, reps))
        out[f"vmem_scatter_ns_per_row_{WIDE_ACC_ROWS}x{DMA_WIDTH}"] = (
            ms * 1e6 / (SCATTER_ITERS * reps))
        for depth in DMA_DEPTHS:
            # A fresh sequence per launch: one replica's 20,000 rows (10 MB)
            # would otherwise stay in L2 from one launch to the next.
            seeds = fresh_seeds(DMA_SEED, TIMED_CALLS + 2, reps, DMA_ITERS)
            ms = queued_ms(lambda: hbm_dma(big, DMA_ITERS, depth, reps,
                                           next(seeds)))
            out[f"hbm_dma_ns_per_row_depth{depth}"] = (
                ms * 1e6 / (DMA_ITERS * reps))
        for batch in MARCH_BATCHES:
            t0 = torch.zeros(1, batch, device=dev)
            ms = queued_ms(lambda: vmem_batch_march(table, t0, MARCH_STEPS,
                                                    reps))
            out[f"march_step_ns_per_ray_batch{batch}"] = (
                ms * 1e6 / (MARCH_STEPS * batch * reps))
    results["full_card"] = full
    # The one-replica gather with fewer CTAs: less staging and a shorter
    # reduction against fewer threads on the rows.
    results["vmem_gather_cta_sweep_ms"] = {
        str(ctas): queued_ms(lambda: vmem_gather_split(table, GATHER_ITERS,
                                                       ctas))
        for ctas in GATHER_CTA_SWEEP}
    # What a launch costs besides its rows, at one replica: the scatter with
    # one iteration (cluster launch, zeroing, both barriers, write-out), the
    # device-memory gather over the card with one row a warp (launch, one
    # row's latency, the fixed-order reduction over every CTA), and the
    # shared-memory gather over its plan's CTAs with one row a thread
    # (launch, the table's stage, both fixed-order reductions), then the
    # gather with no rows: over the plan's CTAs, and, with a 64-row table
    # that costs no stage, over them and over one CTA.
    one_row = replicas_full * DMA_WARPS
    ctas = gather_plan(GATHER_ITERS, WIDTH, 1, replicas_full).ctas
    tiny = integer_table(64, WIDTH, dev)
    seeds = fresh_seeds(DMA_SEED + 1, TIMED_CALLS + 2, 1, one_row)
    results["fixed_ms"] = {
        "vmem_scatter_4096_one_iteration": queued_ms(
            lambda: vmem_scatter(mask, 1, 4096)),
        "hbm_dma_depth8_one_row_a_warp": queued_ms(
            lambda: hbm_dma(big, one_row, 8, 1, next(seeds))),
        "vmem_gather_one_row_a_thread": queued_ms(
            lambda: vmem_gather(table, GATHER_THREADS * ctas)),
        "vmem_gather_no_rows": queued_ms(
            lambda: vmem_gather_split(table, 0, ctas)),
        "vmem_gather_no_rows_64_row_table": queued_ms(
            lambda: vmem_gather_split(tiny, 0, ctas)),
        "vmem_gather_no_rows_64_row_table_one_cta": queued_ms(
            lambda: vmem_gather_split(tiny, 0, 1))}
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
