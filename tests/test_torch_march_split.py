"""The batched-march probe's split (``kernels/probes.py``'s ``march_plan``
and ``vmem_batch_march``): every (ray, step) pair taken exactly once by the
plan's CTAs, threads and chunks, the jump-ahead first states and stride
map, and a torch emulation of the kernel's split and order of adds (each
pair's row summed w = 0, 1, ... and floored, each ray's values added into
its depth in step order, chunk by chunk) against the plain version: bit for
bit on integer tables (every sum exact), and the same bits from two runs
and from a sequential march on float tables. The wrapper on a CPU tensor
against the TPU kernel in interpret mode. No card needed: the SM count and
the shared-memory limit are passed in as numbers; the kernel itself runs in
the ``cuda``-marked test and in ``chip_smoke.py``."""

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
# The card's table: 4096 rows of the corner row's 8 float32.
TABLE_BYTES = 4096 * 8 * 4
MICROBENCH = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
              / "inkernel_microbench.py")
CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_entry_size_bytes",
                 "jax_persistent_cache_min_compile_time_secs")


def _lcg_row(s):
    s = np.asarray(s, np.uint32)
    return np.where(s & np.uint32(1 << 31), np.uint32(0) - s, s)


def _lanes(plan, batch):
    """Ray ``j`` and step lane ``g`` of each thread of one replica that
    holds a ray (the kernel's thread t of CTA c: j = c * rays + t % rays,
    g = t // rays)."""
    cta, t = np.divmod(np.arange(plan.ctas * plan.threads), plan.threads)
    j = cta * plan.rays + t % plan.rays
    g = t // plan.rays
    live = j < batch
    return j[live], g[live]


def _steps(plan, g, n_steps):
    """Yields ``(c0, u, k, ok)`` in the kernel's order: chunk ``c0``, then
    a thread's ``u``-th step ``k`` of it, and which threads take it."""
    for c0 in range(0, n_steps, plan.chunk):
        for u in range(plan.per_thread):
            k = c0 + g + u * plan.group
            yield c0, u, k, k < n_steps


def _first_states(plan, j, g, batch, seed):
    """Each thread's first state: its step map after its ray map, applied
    to ``seed`` (mod 2^32)."""
    ray_a, ray_c = plan.starts[j].T
    step_a, step_c = plan.starts[batch + g].T
    with np.errstate(over="ignore"):
        return step_a * (ray_a * np.uint32(seed % U32) + ray_c) + step_c


def _advance(plan, s):
    with np.errstate(over="ignore"):
        return np.uint32(plan.stride[0]) * s + np.uint32(plan.stride[1])


def _plan(batch, n_steps, replicas, route=None, ctas=None,
          table_bytes=TABLE_BYTES, block=probes.H100_BLOCK_BYTES):
    return probes.march_plan(batch, n_steps, replicas, SM_COUNT, route, ctas,
                             table_bytes, block)


@pytest.mark.parametrize("ctas", [None, 1, 7])
@pytest.mark.parametrize("route", probes.MARCH_ROUTES)
@pytest.mark.parametrize("replicas", [1, 3, 132])
@pytest.mark.parametrize("n_steps", [0, 1, 63, 64])
@pytest.mark.parametrize("batch", [1, 64, 256, 1000])
def test_march_plan_covers_every_pair_once(batch, n_steps, replicas, route,
                                           ctas):
    plan = _plan(batch, n_steps, replicas, route, ctas)
    assert plan.route == route
    assert plan.threads <= probes.MARCH_THREADS
    assert plan.smem_bytes(TABLE_BYTES) + probes.MARCH_STATIC_BYTES <= \
        probes.H100_BLOCK_BYTES
    # Every CTA holds a ray, and the CTAs hold every ray.
    assert (plan.ctas - 1) * plan.rays < batch <= plan.ctas * plan.rays
    if ctas is not None:
        assert plan.ctas <= ctas
    j, g = _lanes(plan, batch)
    seen = np.zeros((n_steps, batch), np.int64)
    for c0, _, k, ok in _steps(plan, g, n_steps):
        # A step's value lands in its chunk's buffer.
        assert (k[ok] - c0 < plan.chunk).all()
        np.add.at(seen, (k[ok], j[ok]), 1)
    np.testing.assert_array_equal(seen, 1)


@pytest.mark.parametrize("route,table_bytes", [
    ("direct", TABLE_BYTES), ("staged", TABLE_BYTES), ("staged", 200_000)])
def test_march_plan_chunks_when_steps_outgrow_shared_memory(route,
                                                            table_bytes):
    """One CTA of 1,024 rays: 200 steps' values do not fit beside the
    table, so they go in chunks that do, still every pair once."""
    plan = _plan(1024, 200, 1, route, 1, table_bytes)
    assert (plan.rays, plan.group) == (1024, 1)
    assert plan.chunk < 200
    assert plan.smem_bytes(table_bytes) + probes.MARCH_STATIC_BYTES <= \
        probes.H100_BLOCK_BYTES
    j, g = _lanes(plan, 1024)
    seen = np.zeros((200, 1024), np.int64)
    for _, _, k, ok in _steps(plan, g, 200):
        np.add.at(seen, (k[ok], j[ok]), 1)
    np.testing.assert_array_equal(seen, 1)


def test_march_plan_defaults():
    """Direct over 64 CTAs for one replica, staged over one CTA a replica
    for one replica an SM; a table that leaves no room beside the step
    values goes direct."""
    one = _plan(256, 64, 1)
    assert (one.route, one.ctas, one.rays, one.group) == ("direct", 64, 4, 16)
    full = _plan(256, 64, SM_COUNT)
    assert (full.route, full.ctas, full.threads) == ("staged", 1, 1024)
    assert full.chunk == 64
    assert _plan(256, 64, SM_COUNT, table_bytes=232_000).route == "direct"


def test_march_plan_rejects_bad_arguments():
    with pytest.raises(ValueError, match="route"):
        _plan(256, 64, 1, "shared")
    with pytest.raises(ValueError, match="batch"):
        _plan(1025, 64, 1)
    with pytest.raises(ValueError, match="ctas"):
        _plan(256, 64, 1, "direct", 0)
    with pytest.raises(ValueError, match="leaves"):
        _plan(256, 64, 1, "staged", 1, table_bytes=232_400)


@pytest.mark.parametrize("seed", [probes.MARCH_SEED, 0, 7, U32 - 1])
@pytest.mark.parametrize("batch,n_steps,ctas,route", [
    (256, 64, None, "direct"), (256, 64, 1, "staged"), (64, 63, 7, None),
    (1000, 1, None, None), (1024, 200, 1, "staged")])
def test_march_first_states_reproduce_lcg_indices(seed, batch, n_steps, ctas,
                                                  route):
    """Thread (j, g)'s first state is state g * batch + j + 1 of the seed's
    sequence, and stepping it by the stride map gives every row of its
    steps as lcg_indices gives them."""
    plan = _plan(batch, n_steps, 1, route, ctas)
    j, g = _lanes(plan, batch)
    ref = probes._lcg_states([seed], n_steps * batch)[0]
    idx = probes.lcg_indices(seed, n_steps * batch, 3001)
    s = _first_states(plan, j, g, batch, seed)
    live = g < n_steps
    np.testing.assert_array_equal(s[live], ref[g[live] * batch + j[live]])
    for _, u, k, ok in _steps(plan, g, n_steps):
        np.testing.assert_array_equal(_lcg_row(s[ok]) % 3001,
                                      idx[k[ok] * batch + j[ok]])
        if u < plan.per_thread:
            s = _advance(plan, s)


def emulate_march(table, t0, n_steps, seed, plan, replica=0):
    """The kernel's arithmetic for one replica in float32 torch: each
    thread's rows from its jump-ahead states (the row by the magic pair of
    n_rows), each summed w = 0, 1, ... from +0 times 0.125 and floored at
    0.001 into its chunk's buffer, then each ray's buffered values added
    into its depth in step order, chunk by chunk."""
    n_rows, width = table.shape
    batch = t0.shape[-1]
    m, shift = probes.magic_divisor(n_rows)
    j, g = _lanes(plan, batch)
    s = _first_states(plan, j, g, batch, seed + replica)
    floor = torch.tensor(probes.MARCH_MIN_STEP, dtype=torch.float32)
    t = t0.reshape(batch).clone()
    buf = torch.full((plan.chunk, batch), float("nan"))
    for c0, u, k, ok in _steps(plan, g, n_steps):
        if u == 0:
            buf.fill_(float("nan"))
        a = _lcg_row(s[ok]).astype(np.uint64)
        row = a - ((a * np.uint64(m)) >> np.uint64(shift)) * np.uint64(n_rows)
        rows = table[torch.from_numpy(row.astype(np.int64))]
        d = torch.zeros(len(row), dtype=torch.float32)
        for w in range(width):
            d = d + rows[:, w] * 0.125
        buf[torch.from_numpy(k[ok] - c0), torch.from_numpy(j[ok])] = \
            torch.maximum(d, floor)
        s = _advance(plan, s)
        if u == plan.per_thread - 1:
            for i in range(min(plan.chunk, n_steps - c0)):
                t = t + buf[i]
    return t


def march_in_order(table, t0, n_steps, seed, replica=0):
    """A sequential march of one replica in float32: step by step, each
    ray's row summed w = 0, 1, ... (the kernel's order), no split."""
    batch = t0.shape[-1]
    idx = torch.from_numpy(probes.lcg_indices(seed + replica, n_steps * batch,
                                              table.shape[0]))
    floor = torch.tensor(probes.MARCH_MIN_STEP, dtype=torch.float32)
    t = t0.reshape(batch).clone()
    for k in range(n_steps):
        rows = table[idx[k * batch:(k + 1) * batch]]
        d = torch.zeros(batch, dtype=torch.float32)
        for w in range(table.shape[1]):
            d = d + rows[:, w] * 0.125
        t = t + torch.maximum(d, floor)
    return t


def _integer_table(n_rows, width, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-8, 9, (n_rows, width))
                            .astype(np.float32))


def _t0(batch, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy((rng.integers(-8, 9, (1, batch)) * 0.25)
                            .astype(np.float32))


@pytest.mark.parametrize("route", probes.MARCH_ROUTES)
@pytest.mark.parametrize("n_steps", [0, 1, 63, 64])
@pytest.mark.parametrize("batch", [1, 64, 256])
@pytest.mark.parametrize("replicas", [1, 132])
def test_march_emulation_matches_plain_on_integer_tables(replicas, batch,
                                                         n_steps, route):
    """The card's 4096 x 8 table: the emulated split equals the plain
    version bit for bit for the first, a middle and the last replica."""
    table = _integer_table(4096, 8, batch + n_steps)
    t0 = _t0(batch, batch)
    plan = _plan(batch, n_steps, replicas, route)
    ref = probes.vmem_batch_march_plain(table, t0, n_steps, replicas)
    for r in sorted({0, replicas // 2, replicas - 1}):
        got = emulate_march(table, t0, n_steps, probes.MARCH_SEED, plan, r)
        assert torch.equal(got, ref[r]), (r, got, ref[r])


@pytest.mark.parametrize("n_rows,width", [(3001, 8), (1000, 12), (500, 37)])
@pytest.mark.parametrize("ctas", [None, 1, 7])
def test_march_emulation_other_tables_and_ctas(n_rows, width, ctas):
    """Row counts that are not powers of two and widths of one float a
    load (12, 37), over the plan's CTAs, one CTA and seven."""
    table = _integer_table(n_rows, width, width)
    t0 = _t0(100, 3)
    plan = _plan(100, 63, 1, "direct", ctas, n_rows * width * 4)
    got = emulate_march(table, t0, 63, 424242, plan)
    ref = probes.vmem_batch_march_plain(table, t0, 63, seed=424242)[0]
    assert torch.equal(got, ref)


@pytest.mark.parametrize("route,ctas,batch,n_steps", [
    ("direct", None, 256, 64), ("staged", None, 256, 64),
    ("staged", 1, 1024, 200), ("direct", 7, 64, 63)])
def test_march_emulation_on_a_float_table(route, ctas, batch, n_steps):
    """Random float rows: the emulated split gives the same bits twice and
    the bits of a sequential march with the same order of adds (the split
    changes no sum), within float32 rounding of the plain version."""
    rng = np.random.default_rng(batch)
    table = torch.from_numpy(rng.standard_normal((4096, 8))
                             .astype(np.float32))
    t0 = torch.from_numpy(rng.standard_normal((1, batch)).astype(np.float32))
    plan = _plan(batch, n_steps, 1, route, ctas)
    got = emulate_march(table, t0, n_steps, probes.MARCH_SEED, plan)
    again = emulate_march(table, t0, n_steps, probes.MARCH_SEED, plan)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    seq = march_in_order(table, t0, n_steps, probes.MARCH_SEED)
    assert torch.equal(got.view(torch.int32), seq.view(torch.int32))
    plain = probes.vmem_batch_march_plain(table, t0, n_steps)[0]
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)


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


@pytest.mark.parametrize("n_rows,width,batch,n_steps", [
    (40, 12, 16, 5), (33, 37, 8, 3)])
def test_wrapper_on_cpu_matches_tpu_kernel(mb, n_rows, width, batch,
                                           n_steps):
    """On a CPU tensor the wrapper runs the plain version, equal to the TPU
    kernel's body in interpret mode at widths other than the probes'."""
    table = _integer_table(n_rows, width, n_rows).numpy()
    t0 = _t0(batch, width).numpy()
    vmem = pl.BlockSpec(memory_space=pltpu.VMEM)
    ref = np.asarray(pl.pallas_call(
        functools.partial(mb._vmem_batch_march_kernel, n_steps=n_steps,
                          n_rows=n_rows, batch=batch),
        in_specs=[vmem, vmem], out_specs=vmem,
        out_shape=jax.ShapeDtypeStruct((1, batch), jnp.float32),
        scratch_shapes=[pltpu.VMEM((batch, width), jnp.float32)],
        interpret=True)(jnp.asarray(table), jnp.asarray(t0)))
    before = probes.launches["vmem_batch_march"]
    got = probes.vmem_batch_march(torch.from_numpy(table),
                                  torch.from_numpy(t0), n_steps)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert probes.launches["vmem_batch_march"] == before


def test_forced_split_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="unsupported device"):
        probes.vmem_batch_march_split(torch.zeros(16, 8), torch.zeros(1, 4),
                                      3, "direct", None)


@pytest.mark.cuda
def test_cuda_march_routes_match_plain():
    """On a card: each route, with the plan's CTAs and forced ones, equals
    the plain version bit for bit on integer tables (ragged shapes, one
    replica and one per SM); on a float table two launches give the same
    bits, those of the sequential march."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    full = torch.cuda.get_device_properties(dev).multi_processor_count
    for n_rows, width in ((4096, 8), (3001, 8), (1000, 12)):
        table = probes.integer_table(n_rows, width, dev, seed=width)
        for batch, n_steps in ((256, 64), (64, 63), (1, 1), (1000, 200)):
            t0 = probes.integer_table(1, batch, dev, seed=batch) * 0.25
            for reps in (1, full):
                ref = probes.vmem_batch_march_plain(table, t0, n_steps, reps)
                for route in probes.MARCH_ROUTES:
                    for ctas in (None, 1, 7):
                        got = probes.vmem_batch_march_split(
                            table, t0, n_steps, route, ctas, reps)
                        torch.cuda.synchronize()
                        assert torch.equal(got, ref), (n_rows, width, batch,
                                                       n_steps, reps, route,
                                                       ctas)
    gen = torch.Generator().manual_seed(3)
    table = torch.randn(4096, 8, generator=gen)
    t0 = torch.randn(1, 256, generator=gen)
    seq = march_in_order(table, t0, 64, probes.MARCH_SEED)
    for route in probes.MARCH_ROUTES:
        first = probes.vmem_batch_march_split(table.to(dev), t0.to(dev), 64,
                                              route, None)
        second = probes.vmem_batch_march_split(table.to(dev), t0.to(dev), 64,
                                               route, None)
        assert torch.equal(first, second)
        assert torch.equal(first[0].cpu().view(torch.int32),
                           seq.view(torch.int32))
