"""The shared-memory gather probe's split over CTAs (``kernels/probes.py``'s
``gather_plan`` and ``vmem_gather``): its shares of the LCG sequence, their
jump-ahead first states, and a torch emulation of the kernel's split and
fixed order of adds (each row group's rows in order, the CTA's groups by a
fixed tree, the CTAs by the last CTA's strided sets and a fixed tree)
against the plain version: bit for bit on integer tables (every partial sum
is an exact integer), within 1e-6 of a float64 sum on random float tables,
and the same bits from two runs. The wrapper on a CPU tensor against the
TPU kernel in interpret mode. No card needed: the SM count is passed in as
a number; the kernel itself runs in the ``cuda``-marked test and in
``chip_smoke.py``."""

import functools
import importlib.util
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from voxelized_geometry_tools_tpu_torch.kernels import probes

SM_COUNT = 132
U32 = 1 << 32
# A float32 sum of the rows against a float64 one, relative to the rows'
# absolute sum: float32 rounding of a few hundred terms stays near 1e-7.
REL_TOL = 1e-6
MICROBENCH = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
              / "inkernel_microbench.py")
CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_entry_size_bytes",
                 "jax_persistent_cache_min_compile_time_secs")


def _lcg_row(s):
    s = np.asarray(s, np.uint32)
    return np.where(s & np.uint32(1 << 31), np.uint32(0) - s, s)


@pytest.mark.parametrize("width", [8, 12, 37, 128])
@pytest.mark.parametrize("n_iters", [1, 7, 100_000])
@pytest.mark.parametrize("replicas", [1, 3, 132])
def test_gather_plan_shares_partition_iterations(replicas, n_iters, width):
    plan = probes.gather_plan(n_iters, width, replicas, SM_COUNT)
    a, c, lo, rows = plan.shares.T.astype(np.int64)
    assert plan.shares.shape == (plan.ctas * plan.groups, 4)
    assert plan.shares.dtype == np.uint32
    assert lo[0] == 0 and lo[-1] + rows[-1] == n_iters
    np.testing.assert_array_equal(lo[1:], lo[:-1] + rows[:-1])
    assert rows.max() - rows.min() <= 1
    # One CTA for every two SMs for one replica, divided among the
    # replicas; no more CTAs than give every group a row.
    assert plan.ctas == max(1, min(SM_COUNT // (2 * replicas),
                                   -(-n_iters // plan.groups)))


@pytest.mark.parametrize("seed", [probes.GATHER_SEED, 0, 7, U32 - 1])
@pytest.mark.parametrize("n_iters,ctas", [(100_000, None), (7, 5),
                                          (3001, 132)])
def test_gather_plan_first_states_reproduce_lcg_indices(seed, n_iters, ctas):
    """Group k's first state is state lo + 1 of the seed's sequence, and
    stepping it gives every row of its share as lcg_indices gives it."""
    plan = probes.gather_plan(n_iters, 8, 1, SM_COUNT, ctas)
    a, c, lo, rows = plan.shares.T
    ref = probes._lcg_states([seed], n_iters)[0]
    idx = probes.lcg_indices(seed, n_iters, 4096)
    s = a * np.uint32(seed % U32) + c
    live = rows > 0
    np.testing.assert_array_equal(s[live], ref[lo[live]])
    for i in range(int(rows.max())):
        ok = i < rows
        np.testing.assert_array_equal(_lcg_row(s[ok]) % 4096,
                                      idx[lo[ok].astype(np.int64) + i])
        s = s * np.uint32(probes.LCG_A) + np.uint32(probes.LCG_C)


@pytest.mark.parametrize("width,vec,group", [
    (8, 2, 1), (16, 2, 2), (128, 2, 16), (1024, 2, 128), (4, 0, 4),
    (12, 0, 12), (1, 0, 1), (37, 0, 37), (1023, 0, 1023)])
def test_gather_plan_row_groups_by_width(width, vec, group):
    """Two float4s a thread where the width is a multiple of 8 (the corner
    row of width 8 is one thread's), else one float; as many whole groups a
    CTA as its threads hold."""
    plan = probes.gather_plan(1000, width, 1, SM_COUNT)
    assert (plan.vec, plan.group) == (vec, group)
    assert plan.groups == probes.GATHER_THREADS // group
    assert plan.pieces * (4 if vec else 1) == width
    with pytest.raises(ValueError, match="width"):
        probes.gather_plan(1000, 1025, 1, SM_COUNT)


def _tree(x, dim=0):
    """The kernel's tree_sum (and warp_tree, over a power of two) along
    ``dim`` of x."""
    x = x.movedim(dim, 0).clone()
    count = x.shape[0]
    h = (1 << (count - 1).bit_length()) >> 1 if count > 1 else 0
    while h:
        m = min(h, count - h)
        x[:m] = x[:m] + x[h:h + m]
        count, h = h, h >> 1
    return x[0]


def _block_tree(x, span):
    """The kernel's sum of a CTA's rows x ([rows, width], row r on threads
    r * span ...): where ``span`` divides 32, a tree over each warp's rows
    (warp_tree) and then one over the 32 warps, else a tree over the
    rows."""
    if 32 % span:
        return _tree(x)
    per_warp = _tree(x.reshape(32, 32 // span, -1), dim=1)
    return _tree(per_warp)


def emulate_gather(table, n_iters, seed, plan, replica=0):
    """The split kernel's arithmetic for one replica in float32 torch: each
    group sums its share's rows in order from +0, the CTA's groups are
    summed by _block_tree, and with several CTAs the last CTA's set k sums
    CTAs k, k + sets, ... in order from +0 before _block_tree of the sets
    (all GATHER_THREADS / pieces sets where a set spans a divisor of 32
    threads, the ones past the CTAs summing nothing)."""
    n_rows, width = table.shape
    a, c, _, rows = plan.shares.T
    s = a * np.uint32((seed + replica) % U32) + c
    acc = torch.zeros(len(rows), width, dtype=torch.float32)
    for i in range(int(rows.max(initial=0))):
        ok = torch.from_numpy(i < rows)
        idx = torch.from_numpy((_lcg_row(s) % n_rows).astype(np.int64))
        acc[ok] = acc[ok] + table[idx[ok]]
        s = s * np.uint32(probes.LCG_A) + np.uint32(probes.LCG_C)
    per_cta = torch.stack([_block_tree(g, plan.group) for g in
                           acc.reshape(plan.ctas, plan.groups, width)])
    if plan.ctas == 1:
        return per_cta[0]
    sets = probes.GATHER_THREADS // plan.pieces
    if 32 % plan.pieces:
        sets = min(sets, plan.ctas)
    set_sums = torch.zeros(sets, width, dtype=torch.float32)
    for k in range(sets):
        for cta in range(k, plan.ctas, sets):
            set_sums[k] = set_sums[k] + per_cta[cta]
    return _block_tree(set_sums, plan.pieces)


def _integer_table(n_rows, width, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-8, 9, (n_rows, width))
                            .astype(np.float32))


@pytest.mark.parametrize("n_iters", [1, 7, 100_000])
@pytest.mark.parametrize("replicas", [1, 3, 132])
def test_gather_emulation_matches_plain_on_integer_tables(replicas, n_iters):
    """The TPU's corner-row width 8 on a 4096-row table: the emulated split
    equals the plain version bit for bit for every replica (sums below 2^24
    are exact in any order)."""
    table = _integer_table(4096, 8, n_iters)
    plan = probes.gather_plan(n_iters, 8, replicas, SM_COUNT)
    ref = probes.vmem_gather_plain(table, n_iters, replicas)
    for r in sorted({0, replicas // 2, replicas - 1}):
        got = emulate_gather(table, n_iters, probes.GATHER_SEED, plan, r)
        assert torch.equal(got, ref[r]), (r, got, ref[r])


@pytest.mark.parametrize("width", [12, 37, 128])
@pytest.mark.parametrize("ctas", [None, 1, 132])
def test_gather_emulation_other_widths_and_ctas(width, ctas):
    """Widths of one float a thread (12 threads a row, not a divisor of a
    warp; 37) and of two float4s a thread over 16 threads a row (128), with
    the plan's CTAs, one CTA, and more CTAs than the rows fill (groups with
    no rows)."""
    table = _integer_table(1000, width, width)
    seed = 424242
    plan = probes.gather_plan(20_000, width, 1, SM_COUNT, ctas)
    got = emulate_gather(table, 20_000, seed, plan)
    ref = probes.vmem_gather_plain(table, 20_000, seed=seed)[0]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("replicas,ctas", [(1, None), (1, 8), (132, None)])
def test_gather_emulation_on_a_float_table(replicas, ctas):
    """Random float rows: within REL_TOL of a float64 sum of the same rows,
    relative to their absolute sum, and the same bits from a second run."""
    rng = np.random.default_rng(ctas or 0)
    table = torch.from_numpy(rng.standard_normal((4096, 8))
                             .astype(np.float32))
    plan = probes.gather_plan(100_000, 8, replicas, SM_COUNT, ctas)
    got = emulate_gather(table, 100_000, probes.GATHER_SEED, plan)
    again = emulate_gather(table, 100_000, probes.GATHER_SEED, plan)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    rows = table.double()[torch.from_numpy(
        probes.lcg_indices(probes.GATHER_SEED, 100_000, 4096))]
    err = (got.double() - rows.sum(0)).abs() / rows.abs().sum(0)
    assert float(err.max()) < REL_TOL


@pytest.fixture(scope="module")
def mb():
    """benchmarks/inkernel_microbench.py imported by its path, with the
    jax.config options and sys.path it changes restored after import."""
    saved = {k: getattr(jax.config, k) for k in CACHE_OPTIONS}
    path = list(sys.path)
    spec = importlib.util.spec_from_file_location("inkernel_microbench",
                                                  MICROBENCH)
    module = importlib.util.module_from_spec(spec)
    try:
        spec.loader.exec_module(module)
    finally:
        for k, v in saved.items():
            jax.config.update(k, v)
        sys.path[:] = path
    return module


@pytest.mark.parametrize("n_rows,width,n_iters", [(64, 8, 50), (40, 37, 9)])
def test_wrapper_on_cpu_matches_tpu_kernel(mb, n_rows, width, n_iters):
    """On a CPU tensor the wrapper runs the plain version, equal to the TPU
    kernel's body in interpret mode."""
    table = _integer_table(n_rows, width, n_rows).numpy()
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    ref = np.asarray(pl.pallas_call(
        functools.partial(mb._vmem_gather_kernel, n_iters=n_iters,
                          n_rows=n_rows),
        in_specs=[vmem], out_specs=vmem,
        out_shape=jax.ShapeDtypeStruct((1, width), jnp.float32),
        interpret=True)(jnp.asarray(table)))
    before = probes.launches["vmem_gather"]
    got = probes.vmem_gather(torch.from_numpy(table), n_iters)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert probes.launches["vmem_gather"] == before


def test_forced_split_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="unsupported device"):
        probes.vmem_gather_split(torch.zeros(16, 8), 10, 4)


@pytest.mark.cuda
def test_cuda_gather_split_matches_plain():
    """On a card: the kernel equals the plain version bit for bit on
    integer tables of widths 8, 12, 37 and 128, one replica and one per SM,
    the plan's CTAs and forced ones; on float tables it equals the
    emulation of its order of adds bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    full = torch.cuda.get_device_properties(dev).multi_processor_count
    for n_rows, width in ((4096, 8), (1000, 12), (1000, 37), (256, 128)):
        table = probes.integer_table(n_rows, width, dev, seed=width)
        for reps, ctas in ((1, None), (full, None), (1, 1), (1, 7)):
            got = probes.vmem_gather_split(table, 30_000, ctas, reps)
            ref = probes.vmem_gather_plain(table, 30_000, reps)
            torch.cuda.synchronize()
            assert torch.equal(got, ref), (width, reps, ctas)
    # On a float table the kernel's order of adds is the emulation's: the
    # same bits, for the plan's CTAs, one CTA and one per SM.
    gen = torch.Generator().manual_seed(3)
    for width in (8, 12, 37):
        table = torch.randn(1000, width, generator=gen)
        for ctas in (None, 1, full):
            plan = probes.gather_plan(20_000, width, 1, full, ctas)
            got = probes.vmem_gather_split(table.to(dev), 20_000, ctas)
            ref = emulate_gather(table, 20_000, probes.GATHER_SEED, plan)
            assert torch.equal(got[0].cpu().view(torch.int32),
                               ref.view(torch.int32)), (width, ctas)
