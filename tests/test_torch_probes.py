"""The primitive-rate probes of the port (``kernels/probes.py``) against the
TPU kernels of benchmarks/inkernel_microbench.py, run through
``pl.pallas_call(..., interpret=True)`` on the kernel bodies of that file:
the LCG index sequence, and each plain version bit for bit on integer
tables (every sum exact). On a CUDA card only: each kernel against its
plain version."""

import functools
import importlib.util
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from voxelized_geometry_tools_tpu_torch.kernels import probes

MICROBENCH = (pathlib.Path(__file__).resolve().parents[1] / "benchmarks"
              / "inkernel_microbench.py")
# The jax.config options that importing the microbenchmark sets.
CACHE_OPTIONS = ("jax_compilation_cache_dir",
                 "jax_persistent_cache_min_entry_size_bytes",
                 "jax_persistent_cache_min_compile_time_secs")
N_ROWS, WIDTH, N_ITERS = 64, 128, 50


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


def _int_table(rows, width, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-8, 9, (rows, width)).astype(np.float32)


def _interpret(kernel, *args, out_shape, in_specs, scratch=(), **params):
    return np.asarray(pl.pallas_call(
        kernel, in_specs=in_specs,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        scratch_shapes=list(scratch), interpret=True, **params)(
            *[jnp.asarray(a) for a in args]))


VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


@pytest.mark.parametrize("seed", [probes.GATHER_SEED, probes.SCATTER_SEED,
                                  probes.DMA_SEED, probes.MARCH_SEED])
def test_lcg_indices_match_jax(mb, seed):
    """The states and indices of lcg_indices are the TPU kernels' int32
    recurrence, and a sequence of seeds gives one row per seed."""
    def body(i, carry):
        s, out = carry
        s = s * mb._LCG_A + mb._LCG_C
        return s, out.at[i].set(s)

    states = np.asarray(lax.fori_loop(
        0, 2000, body, (jnp.int32(seed), jnp.zeros(2000, jnp.int32)))[1])
    assert (mb._LCG_A, mb._LCG_C) == (probes.LCG_A, probes.LCG_C)
    np.testing.assert_array_equal(
        probes._lcg_states([seed], 2000)[0].view(np.int32), states)
    for n_rows in (N_ROWS, 4096, 3001):
        np.testing.assert_array_equal(probes.lcg_indices(seed, 2000, n_rows),
                                      np.abs(states) % n_rows)
    rows = probes.lcg_indices([seed, seed + 1], 10, 77)
    assert rows.shape == (2, 10)
    np.testing.assert_array_equal(rows[0], probes.lcg_indices(seed, 10, 77))


def test_lcg_rejects_int_min():
    """A seed whose next state is INT_MIN (abs of it is negative on the
    TPU) raises."""
    int_min = np.uint32(1 << 31)
    # Solve s * A + C == INT_MIN (mod 2^32) for s: A is odd, so invertible.
    a_inv = pow(probes.LCG_A, -1, 1 << 32)
    s = int((int(int_min) - probes.LCG_C) * a_inv % (1 << 32))
    with pytest.raises(ValueError, match="INT_MIN"):
        probes.lcg_indices(s, 3, 10)


def test_vmem_gather_plain_matches_tpu_kernel(mb):
    table = _int_table(N_ROWS, WIDTH, 0)
    ref = _interpret(functools.partial(mb._vmem_gather_kernel,
                                       n_iters=N_ITERS, n_rows=N_ROWS),
                     table, out_shape=(1, WIDTH), in_specs=[VMEM])
    got = probes.vmem_gather(torch.from_numpy(table), N_ITERS)
    assert tuple(got.shape) == (1, WIDTH)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_vmem_scatter_plain_matches_tpu_kernel(mb):
    mask = _int_table(1, WIDTH, 1)
    ref = _interpret(functools.partial(mb._vmem_scatter_kernel,
                                       n_iters=N_ITERS, n_rows=N_ROWS),
                     mask, out_shape=(N_ROWS, WIDTH), in_specs=[VMEM])
    got = probes.vmem_scatter(torch.from_numpy(mask), N_ITERS, N_ROWS)
    assert tuple(got.shape) == (1, N_ROWS, WIDTH)
    np.testing.assert_array_equal(got[0].numpy(), ref)


@pytest.mark.parametrize("depth", [2, 4])
def test_hbm_dma_plain_matches_tpu_kernel(mb, depth):
    """The TPU kernel sums the first n_iters - depth rows; the last depth
    copies are started and never waited on."""
    table = _int_table(N_ROWS, WIDTH, 2)
    ref = _interpret(
        functools.partial(mb._hbm_dma_kernel, n_iters=N_ITERS,
                          n_rows=N_ROWS, depth=depth),
        table, out_shape=(1, WIDTH),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY)],
        scratch=[pltpu.VMEM((depth, WIDTH), jnp.float32),
                 pltpu.SemaphoreType.DMA((depth,))],
        compiler_params=pltpu.CompilerParams(has_side_effects=True))
    got = probes.hbm_dma(torch.from_numpy(table), N_ITERS, depth)
    np.testing.assert_array_equal(got.numpy(), ref)
    idx = probes.lcg_indices(probes.DMA_SEED, N_ITERS, N_ROWS)
    np.testing.assert_array_equal(ref[0],
                                  table[idx[:N_ITERS - depth]].sum(axis=0))


def test_vmem_batch_march_plain_matches_tpu_kernel(mb):
    batch, n_steps = 8, 3
    table = _int_table(N_ROWS, WIDTH, 3)
    t0 = (_int_table(1, batch, 4) * 0.25).astype(np.float32)
    ref = _interpret(
        functools.partial(mb._vmem_batch_march_kernel, n_steps=n_steps,
                          n_rows=N_ROWS, batch=batch),
        table, t0, out_shape=(1, batch), in_specs=[VMEM, VMEM],
        scratch=[pltpu.VMEM((batch, WIDTH), jnp.float32)])
    got = probes.vmem_batch_march(torch.from_numpy(table),
                                  torch.from_numpy(t0), n_steps)
    np.testing.assert_array_equal(got.numpy(), ref)


def test_replicas_run_seed_plus_r():
    """Replica r is the probe with seed + r; replica 0 is the TPU
    kernel's result."""
    table = torch.from_numpy(_int_table(N_ROWS, WIDTH, 5))
    mask = table[:1]
    t0 = torch.zeros(1, 16)
    cases = [
        (probes.vmem_gather(table, N_ITERS, 3),
         lambda r: probes.vmem_gather(table, N_ITERS,
                                      seed=probes.GATHER_SEED + r)),
        (probes.vmem_scatter(mask, N_ITERS, 40, 3),
         lambda r: probes.vmem_scatter(mask, N_ITERS, 40,
                                       seed=probes.SCATTER_SEED + r)),
        (probes.hbm_dma(table, N_ITERS, 4, 3),
         lambda r: probes.hbm_dma(table, N_ITERS, 4,
                                  seed=probes.DMA_SEED + r)),
        (probes.vmem_batch_march(table, t0, 5, 3),
         lambda r: probes.vmem_batch_march(table, t0, 5,
                                           seed=probes.MARCH_SEED + r)),
    ]
    for many, one in cases:
        assert many.shape[0] == 3
        for r in range(3):
            assert torch.equal(many[r], one(r)[0])


def test_dma_shape_rules():
    table = torch.zeros(16, 128)
    with pytest.raises(ValueError, match="depth"):
        probes.hbm_dma(table, 50, 17)
    with pytest.raises(ValueError, match="below depth"):
        probes.hbm_dma(table, 3, 4)
    with pytest.raises(ValueError, match="multiple of 4"):
        probes.hbm_dma(torch.zeros(16, 130), 50, 2)


@pytest.mark.cuda
def test_cuda_probe_kernels_match_plain_versions():
    """On a CUDA card: each kernel equals its plain version bit for bit,
    for one replica and one per SM (the scatter also at the TPU's 8192 x 8
    accumulator, over a cluster), a table beyond a block's shared memory
    raises, and so does an accumulator beyond a cluster's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    full = torch.cuda.get_device_properties(dev).multi_processor_count
    table = probes.integer_table(3001, 8, dev)
    mask = probes.integer_table(1, 8, dev, seed=1)
    big = probes.integer_table(1 << 16, 128, dev, seed=2)
    t0 = torch.zeros(1, 64, device=dev)
    for reps in (1, full):
        pairs = [
            (probes.vmem_gather(table, 5000, reps),
             probes.vmem_gather_plain(table, 5000, reps)),
            (probes.vmem_scatter(mask, 5000, 3001, reps),
             probes.vmem_scatter_plain(mask, 5000, 3001, reps)),
            (probes.vmem_scatter(mask, 5000, 8192, reps),
             probes.vmem_scatter_plain(mask, 5000, 8192, reps)),
            (probes.hbm_dma(big, 5000, 8, reps),
             probes.hbm_dma_plain(big, 5000, 8, reps)),
            (probes.vmem_batch_march(table, t0, 16, reps),
             probes.vmem_batch_march_plain(table, t0, 16, reps)),
        ]
        torch.cuda.synchronize()
        for got, ref in pairs:
            assert torch.equal(got, ref)
    with pytest.raises(ValueError, match="shared memory"):
        probes.vmem_gather(probes.integer_table(4096, 128, dev), 10)
    with pytest.raises(ValueError, match="does not fit a cluster"):
        probes.vmem_scatter(probes.integer_table(1, 128, dev), 10, 8192)


def test_fresh_seeds_are_spaced_and_checked():
    """fresh_seeds spaces the seeds of timed launches SEED_STRIDE apart and
    checks their sequences before any launch."""
    seeds = list(probes.fresh_seeds(probes.DMA_SEED, 3, 4, 100))
    assert seeds == [probes.DMA_SEED + i * probes.SEED_STRIDE
                     for i in range(3)]
    a_inv = pow(probes.LCG_A, -1, 1 << 32)
    bad = int(((1 << 31) - probes.LCG_C) * a_inv % (1 << 32))
    with pytest.raises(ValueError, match="INT_MIN"):
        probes.fresh_seeds(bad - 2, 1, 4, 3)
