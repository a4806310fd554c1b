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
``seed + r`` into row ``r`` of the output (one block per replica on the
card), so ``replicas=1`` computes exactly the TPU kernel's result and more
replicas measure the whole card. On a CUDA tensor a wrapper launches its
kernel (building it at first use) or raises; on a CPU tensor it runs the
plain version. With integer-valued tables every sum is exact, so kernels,
plain versions and the JAX kernels agree bit for bit. ``launches`` counts
kernel launches by probe name.

Run ``python -m voxelized_geometry_tools_tpu_torch.kernels.probes`` on a
card for the H100's rates (one JSON line; see :func:`main`).
"""

from __future__ import annotations

import ctypes
import functools
import json

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


# -- Kernels ------------------------------------------------------------------


@functools.cache
def _library():
    lib = build.load_library("probes")
    lib.probes_max_shared_bytes.argtypes = [ctypes.c_int]
    lib.probes_max_shared_bytes.restype = ctypes.c_int
    # replicas, device, stream
    tail = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.probe_vmem_gather_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int] + tail)
    lib.probe_vmem_scatter_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int] + tail)
    lib.probe_hbm_dma_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_longlong, ctypes.c_int,
                                 ctypes.c_int] + tail)
    lib.probe_vmem_batch_march_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + tail)
    for fn in (lib.probe_vmem_gather_launch, lib.probe_vmem_scatter_launch,
               lib.probe_hbm_dma_launch, lib.probe_vmem_batch_march_launch):
        fn.restype = ctypes.c_int
    return lib


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


def _launch(name: str, fn, *args, device) -> None:
    err = fn(*args, device.index or 0,
             torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError_t {err})")
    launches[name] += 1


def vmem_gather(table: Tensor, n_iters: int, replicas: int = 1,
                seed: int = GATHER_SEED) -> Tensor:
    """:func:`vmem_gather_plain` of a ``[n_rows, width]`` float32 table, by
    the kernel on a CUDA tensor (the table in shared memory)."""
    if table.device.type == "cpu":
        return vmem_gather_plain(table, n_iters, replicas, seed)
    _check_input(table, "table", 2)
    _check_replicas(replicas)
    n_rows, width = table.shape
    if width > MAX_THREADS:
        raise ValueError(f"width {width} above {MAX_THREADS}")
    _check_shared(n_rows, width, table.device, "the table")
    _check_sequences(seed, replicas, n_iters)
    out = torch.empty(replicas, width, dtype=torch.float32,
                      device=table.device)
    _launch("vmem_gather", _library().probe_vmem_gather_launch,
            table.data_ptr(), out.data_ptr(), n_rows, width, n_iters, seed,
            replicas, device=table.device)
    return out


def vmem_scatter(mask: Tensor, n_iters: int, n_rows: int, replicas: int = 1,
                 seed: int = SCATTER_SEED) -> Tensor:
    """:func:`vmem_scatter_plain` of a ``[1, width]`` float32 mask, by the
    kernel on a CUDA tensor (the accumulator in shared memory)."""
    if mask.device.type == "cpu":
        return vmem_scatter_plain(mask, n_iters, n_rows, replicas, seed)
    _check_input(mask, "mask", 2)
    _check_replicas(replicas)
    width = mask.shape[1]
    if mask.shape[0] != 1 or width > MAX_THREADS:
        raise ValueError(f"mask must be [1, width <= {MAX_THREADS}], got "
                         f"{tuple(mask.shape)}")
    _check_shared(n_rows, width, mask.device, "the accumulator")
    _check_sequences(seed, replicas, n_iters)
    out = torch.empty(replicas, n_rows, width, dtype=torch.float32,
                      device=mask.device)
    _launch("vmem_scatter", _library().probe_vmem_scatter_launch,
            mask.data_ptr(), out.data_ptr(), n_rows, width, n_iters, seed,
            replicas, device=mask.device)
    return out


def hbm_dma(table: Tensor, n_iters: int, depth: int, replicas: int = 1,
            seed: int = DMA_SEED) -> Tensor:
    """:func:`hbm_dma_plain` of a ``[n_rows, width]`` float32 table in device
    memory, by the kernel's ``depth``-stage ``cp.async`` ring on a CUDA
    tensor."""
    if table.device.type == "cpu":
        return hbm_dma_plain(table, n_iters, depth, replicas, seed)
    _check_input(table, "table", 2)
    _check_replicas(replicas)
    _check_dma_args(table, n_iters, depth)
    if table.data_ptr() % 16:
        raise ValueError("table must be 16-byte aligned")
    n_rows, width = table.shape
    if n_rows >= 2 ** 31:
        raise ValueError(f"{n_rows} rows above the int32 row index")
    _check_sequences(seed, replicas, n_iters)
    out = torch.empty(replicas, width, dtype=torch.float32,
                      device=table.device)
    _launch("hbm_dma", _library().probe_hbm_dma_launch, table.data_ptr(),
            out.data_ptr(), n_rows, width, n_iters, depth, seed, replicas,
            device=table.device)
    return out


def vmem_batch_march(table: Tensor, t0: Tensor, n_steps: int,
                     replicas: int = 1, seed: int = MARCH_SEED) -> Tensor:
    """:func:`vmem_batch_march_plain` of a ``[n_rows, width]`` float32 table
    and ``[1, batch]`` start depths, by the kernel on a CUDA tensor (the
    table in shared memory, one thread per ray)."""
    if table.device.type == "cpu":
        return vmem_batch_march_plain(table, t0, n_steps, replicas, seed)
    _check_input(table, "table", 2)
    _check_input(t0, "t0", 2)
    _check_replicas(replicas)
    n_rows, width = table.shape
    batch = t0.shape[1]
    if t0.shape[0] != 1 or not 1 <= batch <= MAX_THREADS:
        raise ValueError(f"t0 must be [1, batch <= {MAX_THREADS}], got "
                         f"{tuple(t0.shape)}")
    _check_shared(n_rows, width, table.device, "the table")
    _check_sequences(seed, replicas, n_steps * batch)
    out = torch.empty(replicas, batch, dtype=torch.float32,
                      device=table.device)
    _launch("vmem_batch_march", _library().probe_vmem_batch_march_launch,
            table.data_ptr(), t0.data_ptr(), out.data_ptr(), n_rows, width,
            n_steps, batch, seed, replicas, device=table.device)
    return out


# -- Entry point --------------------------------------------------------------

# The card's shapes: the corner row's real width (8 float32) for the
# shared-memory probes (the TPU's 4096 x 128 table and 2048/8192-row
# accumulators, 1-4 MiB, do not fit a block's 227 KiB), the TPU's
# 2^20 x 128 table for the device-memory probe.
WIDTH = 8
TABLE_ROWS = 4096
GATHER_ITERS = 100_000
SCATTER_ITERS = 100_000
ACC_ROWS = (2048, 4096)
DMA_ROWS, DMA_WIDTH, DMA_ITERS = 1 << 20, 128, 20_000
DMA_DEPTHS = (2, 8, 16)
# Warps per SM of the device-memory probe's extra full-card runs: one warp
# is bound by its own serial latency per row, more hide it.
DMA_WARPS_PER_SM = (4, 16)
MARCH_STEPS = 64
MARCH_BATCHES = (64, 256)


def integer_table(n_rows: int, width: int, device, seed: int = 0) -> Tensor:
    """Random integers in [-8, 8] as float32, made on ``device``: every sum
    the probes take of them is exact."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(-8, 9, (n_rows, width), generator=gen,
                         device=device).to(torch.float32)


TIMED_CALLS = 10


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


def main() -> dict:
    """The probes at the card's shapes, for one replica (the TPU kernels'
    own measurement, the keys of ``inkernel_microbench.main()``) and for
    one replica per SM (``full_card``), as ns per row (per ray-step for the
    march); the full-card numbers are the aggregate time per row over all
    replicas. Each timed launch of the device-memory probe reads
    a fresh row sequence. Prints the dict as one JSON line and returns
    it."""
    if not torch.cuda.is_available():
        raise SystemExit("probes: no CUDA device; the probes run only on a "
                         "CUDA card")
    dev = torch.device("cuda", torch.cuda.current_device())
    replicas_full = torch.cuda.get_device_properties(
        dev).multi_processor_count
    table = integer_table(TABLE_ROWS, WIDTH, dev)
    mask = integer_table(1, WIDTH, dev, seed=1)
    big = integer_table(DMA_ROWS, DMA_WIDTH, dev, seed=2)
    results = {"device": torch.cuda.get_device_name(dev),
               "replicas_full": replicas_full,
               "shapes": {"table": [TABLE_ROWS, WIDTH],
                          "gather_iters": GATHER_ITERS,
                          "scatter_acc": [[r, WIDTH] for r in ACC_ROWS],
                          "scatter_iters": SCATTER_ITERS,
                          "dma_table": [DMA_ROWS, DMA_WIDTH],
                          "dma_iters": DMA_ITERS,
                          "march_steps": MARCH_STEPS,
                          "march_batches": list(MARCH_BATCHES)}}
    full = {}
    for reps, out in ((1, results), (replicas_full, full)):
        ms = cuda_ms(lambda: vmem_gather(table, GATHER_ITERS, reps))
        out["vmem_gather_ns_per_row"] = ms * 1e6 / (GATHER_ITERS * reps)
        for acc_rows in ACC_ROWS:
            ms = cuda_ms(lambda: vmem_scatter(mask, SCATTER_ITERS, acc_rows,
                                              reps))
            out[f"vmem_scatter_ns_per_row_{acc_rows}"] = (
                ms * 1e6 / (SCATTER_ITERS * reps))
        for depth in DMA_DEPTHS:
            # A fresh sequence per launch: one replica's 20,000 rows (10 MB)
            # would otherwise stay in L2 from one launch to the next.
            seeds = fresh_seeds(DMA_SEED, TIMED_CALLS + 1, reps, DMA_ITERS)
            ms = cuda_ms(lambda: hbm_dma(big, DMA_ITERS, depth, reps,
                                         next(seeds)))
            out[f"hbm_dma_ns_per_row_depth{depth}"] = (
                ms * 1e6 / (DMA_ITERS * reps))
        for batch in MARCH_BATCHES:
            t0 = torch.zeros(1, batch, device=dev)
            ms = cuda_ms(lambda: vmem_batch_march(table, t0, MARCH_STEPS,
                                                  reps))
            out[f"march_step_ns_per_ray_batch{batch}"] = (
                ms * 1e6 / (MARCH_STEPS * batch * reps))
    for per_sm in DMA_WARPS_PER_SM:
        reps = per_sm * replicas_full
        seeds = fresh_seeds(DMA_SEED, TIMED_CALLS + 1, reps, DMA_ITERS)
        ms = cuda_ms(lambda: hbm_dma(big, DMA_ITERS, DMA_DEPTHS[-1], reps,
                                     next(seeds)))
        full[f"hbm_dma_ns_per_row_depth{DMA_DEPTHS[-1]}_warps_per_sm"
             f"{per_sm}"] = ms * 1e6 / (DMA_ITERS * reps)
    results["full_card"] = full
    print(json.dumps(results), flush=True)
    return results


if __name__ == "__main__":
    main()
