"""The host-side plans of the cluster scatter and the card-wide row gather
(``kernels/probes.py``): the LCG jump-ahead every thread and warp starts
from, the magic divisors, the scatter's row slices and start maps and the
gather's iteration shares. Each plan is also run through a numpy emulation of its
kernel's index arithmetic and order of adds, held against the plain
version. No card needed: device limits are passed in as numbers."""

import numpy as np
import pytest
import torch

from voxelized_geometry_tools_tpu_torch.kernels import probes

TPU_SEEDS = (probes.GATHER_SEED, probes.SCATTER_SEED, probes.DMA_SEED,
             probes.MARCH_SEED)
# The H100's opt-in shared memory per block, and a smaller card's.
H100_BLOCK = 232_448
SMALL_BLOCK = 101_376
U32 = 1 << 32


def _lcg_row(s):
    """abs(int32(s)) % n_rows's dividend, as the kernels form it."""
    s = np.asarray(s, np.uint32)
    return np.where(s & np.uint32(1 << 31), np.uint32(0) - s, s)


@pytest.mark.parametrize("seed", TPU_SEEDS + (0, 7, U32 - 1))
@pytest.mark.parametrize("stride", [1, 7, 8 * 1024, 132 * 256])
def test_jump_ahead_reproduces_lcg_states(seed, stride):
    """Thread t starts at state t + 1 and steps by the stride map: every
    state it visits is _lcg_states' and gives lcg_indices' row."""
    n = 3 * stride + 5
    ref = probes._lcg_states([seed], n)[0]
    threads = np.unique(np.r_[np.arange(min(stride, 40)), stride - 1])
    a0, c0 = probes.lcg_jump(threads + 1)
    sa, sc = probes.lcg_jump(stride)
    s = a0 * np.uint32(seed % U32) + c0
    rows = probes.lcg_indices(seed, n, 3001)
    for m in range((n - 1) // stride + 1):
        i = threads + m * stride
        ok = i < n
        np.testing.assert_array_equal(s[ok], ref[i[ok]])
        np.testing.assert_array_equal(_lcg_row(s[ok]) % 3001, rows[i[ok]])
        s = sa * s + sc


def test_lcg_jump_matches_lcg_terms():
    a, c = probes.lcg_jump(np.arange(1, 5001))
    a_pow, geo = probes._lcg_terms(5000)
    np.testing.assert_array_equal(a, a_pow)
    np.testing.assert_array_equal(c, np.uint32(probes.LCG_C) * geo)
    a, c = probes.lcg_jump(0)
    assert (int(a), int(c)) == (1, 0)


@pytest.mark.parametrize("d", [1, 2, 3, 7, 125, 128, 1000, 1024, 3001, 4096,
                               8192, 1_000_003, (1 << 20) + 3, (1 << 30) + 1,
                               (1 << 31) - 1])
def test_magic_divisor_is_exact_below_2_31(d):
    m, shift = probes.magic_divisor(d)
    assert 0 < m < U32
    rng = np.random.default_rng(d)
    edges = [0, 1, d - 1, d, d + 1, (1 << 31) - 1, (1 << 31) - 2,
             ((1 << 31) - 1) // d * d, ((1 << 31) - 1) // d * d - 1]
    a = np.r_[np.array([e for e in edges if 0 <= e < 1 << 31], np.uint64),
              rng.integers(0, 1 << 31, 20_000, dtype=np.uint64)]
    np.testing.assert_array_equal((a * np.uint64(m)) >> np.uint64(shift),
                                  a // np.uint64(d))


def test_magic_divisor_rejects_out_of_range():
    for d in (0, 1 << 31):
        with pytest.raises(ValueError, match="divisor"):
            probes.magic_divisor(d)


@pytest.mark.parametrize("block", [H100_BLOCK, SMALL_BLOCK])
@pytest.mark.parametrize("width", [8, 37, 128])
@pytest.mark.parametrize("n_rows", [1000, 2048, 3001, 4096, 8192])
def test_scatter_plan_slices_partition_rows(n_rows, width, block):
    try:
        plan = probes.scatter_plan(n_rows, width, block)
    except ValueError as err:
        assert "does not fit a cluster" in str(err)
        # A slice of an eighth of the rows exceeds the block.
        assert 4 * (n_rows // probes.SCATTER_CLUSTER * width) > block
        return
    slices = plan.slices()
    assert len(slices) == probes.SCATTER_CLUSTER
    assert slices[0][0] == 0 and slices[-1][1] == n_rows
    for (_, hi), (lo, _) in zip(slices, slices[1:]):
        assert hi == lo
    assert plan.rows_per_cta % 4 == 0
    assert all(hi - lo <= plan.rows_per_cta for lo, hi in slices)
    assert 4 * plan.rows_per_cta * width <= plan.smem_bytes
    assert plan.smem_bytes <= block and plan.smem_bytes % 16 == 0
    assert plan.rows_per_pass * width <= (probes.SCATTER_CLUSTER
                                          * probes.SCATTER_THREADS)


def test_scatter_plan_shapes_of_the_probes():
    """The TPU's 8192 x 8 accumulator and its width-128 2048-row one fit a
    cluster of 8 CTAs of an H100; 4096 x 128 (2 MiB) does not."""
    for n_rows, width, smem in ((4096, 8, 16_384), (8192, 8, 32_768),
                                (2048, 128, 131_072)):
        assert probes.scatter_plan(n_rows, width, H100_BLOCK).smem_bytes == smem
    with pytest.raises(ValueError, match="does not fit a cluster"):
        probes.scatter_plan(4096, 128, H100_BLOCK)


@pytest.mark.parametrize("n_rows,width,block", [
    (8192, 128, H100_BLOCK), (4096, 128, H100_BLOCK), (4096, 8, 1000),
    (1 << 20, 8, H100_BLOCK)])
def test_scatter_plan_raises_past_the_cluster(n_rows, width, block):
    with pytest.raises(ValueError, match=f"{4 * n_rows * width} bytes"):
        probes.scatter_plan(n_rows, width, block)


@pytest.mark.parametrize("width", [1, 3, 8, 37, 128, 1024])
def test_scatter_starts_reproduce_lcg_states(width):
    """Iteration i of the first pass starts at state i + 1, and the stride
    map takes it to iteration i + rows_per_pass: every state a scatter
    thread visits is _lcg_states'."""
    rows_per_pass = probes.scatter_plan(64, width, H100_BLOCK).rows_per_pass
    assert rows_per_pass == 8 * 1024 // width
    starts, sa, sc = probes.scatter_starts(rows_per_pass)
    seed = probes.SCATTER_SEED
    ref = probes._lcg_states([seed], 3 * rows_per_pass)[0]
    s = starts[:, 0] * np.uint32(seed) + starts[:, 1]
    for k in range(3):
        np.testing.assert_array_equal(
            s, ref[k * rows_per_pass:(k + 1) * rows_per_pass])
        s = np.uint32(sa) * s + np.uint32(sc)


@pytest.mark.parametrize("m", [0.0, -0.0, 1.0, -8.0, 3.0, 0.1, -0.3,
                               1.5, 2.0 ** -140, -(2.0 ** -149), 3.0e38,
                               -2.5e38, np.inf, -np.inf, np.nan, 1e-3])
def test_identical_addends_sum_alike_in_any_order(m):
    """n float32 adds of one value m into +0 give the same bits however the
    adds of different threads interleave, since each add is v -> v + m:
    the reason the scatter kernel's remote reductions, in whatever order
    they land, equal the plain version's sequential adds. Checked for
    zeros of both signs, subnormals, overflow, infinities and NaN against
    torch's index_add_ (the plain version)."""
    for n in (0, 1, 2, 3, 7, 24, 100, 1000, 4097):
        v = np.float32(0.0)
        with np.errstate(over="ignore", invalid="ignore"):
            for _ in range(n):
                v = np.float32(v + np.float32(m))
        acc = torch.zeros(1, 1).index_add_(
            0, torch.zeros(n, dtype=torch.int64),
            torch.full((n, 1), float(np.float32(m))))
        got = acc.numpy()[0, 0]
        assert np.array(got).view(np.uint32) == np.array(v).view(
            np.uint32) or (np.isnan(got) and np.isnan(v)), (m, n, got, v)


def emulate_scatter(mask, n_iters, n_rows, seed, plan, order_seed):
    """The cluster kernel's arithmetic for one replica in numpy: thread t
    adds column t % width of iterations t // width + j * rows_per_pass
    (start maps, stride map, row by the magic divisor of n_rows) into the
    owning CTA's slice (owner by the slice's magic divisor), the adds of
    all threads applied in a random order (``order_seed``), as remote
    reductions may land. Returns the CTAs' slices written out."""
    width = mask.shape[-1]
    rm, rs = probes.magic_divisor(n_rows)
    sm, ss = probes.magic_divisor(plan.rows_per_cta)
    p = plan.rows_per_pass
    threads = probes.SCATTER_CLUSTER * probes.SCATTER_THREADS
    t = np.arange(threads)
    first, column = t // width, t % width
    active = first < p
    starts, sa, sc = probes.scatter_starts(p)
    s = (starts[first[active], 0] * np.uint32(seed)
         + starts[first[active], 1])
    owners, locals_, columns = [], [], []
    for k in range(-(-n_iters // p)):
        it = first[active] + k * p
        a = _lcg_row(s).astype(np.uint64)
        row = a - ((a * np.uint64(rm)) >> np.uint64(rs)) * np.uint64(n_rows)
        owner = (row * np.uint64(sm)) >> np.uint64(ss)
        local = row - owner * np.uint64(plan.rows_per_cta)
        ok = it < n_iters
        owners.append(owner[ok])
        locals_.append(local[ok])
        columns.append(column[active][ok])
        s = np.uint32(sa) * s + np.uint32(sc)
    owners, locals_, columns = (np.concatenate(v).astype(np.int64)
                                for v in (owners, locals_, columns))
    assert (owners < probes.SCATTER_CLUSTER).all()
    assert (locals_ < plan.rows_per_cta).all()
    slices = np.zeros((probes.SCATTER_CLUSTER, plan.rows_per_cta, width),
                      np.float32)
    order = np.random.default_rng(order_seed).permutation(len(owners))
    with np.errstate(over="ignore", invalid="ignore"):
        for j in order:
            o, r, c = owners[j], locals_[j], columns[j]
            slices[o, r, c] = np.float32(slices[o, r, c] + mask[c])
    return slices.reshape(-1, width)[:n_rows]


@pytest.mark.parametrize("n_rows,width,n_iters", [
    (64, 8, 1), (64, 8, 1001), (1000, 37, 700), (96, 128, 90), (5, 3, 300),
    (2048, 8, 20_000)])
@pytest.mark.parametrize("integer", [True, False])
def test_scatter_emulation_matches_plain(n_rows, width, n_iters, integer):
    """Adding each iteration's mask column by column into the owning CTA's
    slice, in a random order, gives the plain version's accumulator bit for
    bit, on a non-integer mask too (every add into a cell adds the same
    value)."""
    rng = np.random.default_rng(n_rows)
    mask = (rng.integers(-8, 9, (1, width)) if integer
            else rng.uniform(-1, 1, (1, width))).astype(np.float32)
    seed = probes.SCATTER_SEED + 1
    plan = probes.scatter_plan(n_rows, width, H100_BLOCK)
    got = emulate_scatter(mask[0], n_iters, n_rows, seed, plan,
                          order_seed=n_iters)
    ref = probes.vmem_scatter_plain(torch.from_numpy(mask), n_iters, n_rows,
                                    seed=seed)[0].numpy()
    np.testing.assert_array_equal(got, ref)


def _dma_cases():
    for depth in range(1, 17):
        for n_iters in (depth, depth + 1, 1_000, 20_000, 100_003):
            for replicas in (1, 132):
                yield n_iters, depth, replicas


@pytest.mark.parametrize("n_iters,depth,replicas", list(_dma_cases()))
def test_dma_plan_shares_partition_iterations(n_iters, depth, replicas):
    plan = probes.dma_plan(n_iters, depth, replicas, 132)
    warps = plan.ctas * probes.DMA_WARPS
    assert plan.shares.shape == (warps, 4)
    assert plan.shares.dtype == np.uint32
    a, c, rows, summed = plan.shares.T.astype(np.int64)
    assert plan.lo[0] == 0 and plan.lo[-1] + rows[-1] == n_iters
    np.testing.assert_array_equal(plan.lo[1:], plan.lo[:-1] + rows[:-1])
    assert rows.max() - rows.min() <= 1
    # Exactly the first n_iters - depth iterations are summed.
    marked = np.zeros(n_iters, bool)
    for lo, k in zip(plan.lo, summed):
        marked[lo:lo + k] = True
    np.testing.assert_array_equal(np.flatnonzero(marked),
                                  np.arange(n_iters - depth))
    # Each warp starts at its first iteration's state.
    seed = probes.DMA_SEED
    ref = probes._lcg_states([seed], n_iters)[0]
    first = (a * seed + c) % U32
    np.testing.assert_array_equal(first, ref[plan.lo])
    # One replica fills the card (a CTA per SM); more divide it; no CTA
    # beyond the rows.
    assert plan.ctas == max(1, min(132 // replicas,
                                   -(-n_iters // probes.DMA_WARPS)))


def emulate_dma(table, n_iters, depth, seed, plan):
    """The row-gather kernel's order of adds for one replica in numpy (rows
    read in the order a warp starts them, warps summed in order per CTA,
    CTAs summed by the last CTA's warps in strides, then in order). Returns
    the sum and every row read."""
    n_rows = table.shape[0]
    width = table.shape[1]
    partial = np.zeros((plan.ctas, width), np.float32)
    read = []
    for cta in range(plan.ctas):
        warp_sums = []
        for w in range(probes.DMA_WARPS):
            a, c, rows, summed = (int(v) for v in
                                  plan.shares[cta * probes.DMA_WARPS + w])
            s = (a * seed + c) % U32
            acc = np.zeros(width, np.float32)
            for i in range(rows):
                row = int(_lcg_row(s)) % n_rows
                read.append(row)
                if i < summed:
                    acc += table[row]
                s = (s * probes.LCG_A + probes.LCG_C) % U32
            warp_sums.append(acc)
        partial[cta] = warp_sums[0]
        for v in warp_sums[1:]:
            partial[cta] += v
    groups = []
    for g in range(probes.DMA_WARPS):
        v = np.zeros(width, np.float32)
        for c in range(g, plan.ctas, probes.DMA_WARPS):
            v += partial[c]
        groups.append(v)
    out = groups[0]
    for v in groups[1:]:
        out = out + v
    return out, np.array(read)


@pytest.mark.parametrize("n_iters,depth", [(8, 8), (9, 8), (1, 1), (30, 16),
                                           (1_001, 2), (3_000, 8)])
def test_dma_emulation_matches_plain(n_iters, depth):
    """Every row of the sequence is read once, and the kernel's order of
    adds gives the plain version's sum on an integer table (zeros where
    n_iters == depth); on a non-integer table its order is fixed by the
    plan alone."""
    table = probes.integer_table(1000, 8, "cpu", seed=n_iters)
    seed = probes.DMA_SEED + 3
    plan = probes.dma_plan(n_iters, depth, 1, 4)
    got, read = emulate_dma(table.numpy(), n_iters, depth, seed, plan)
    np.testing.assert_array_equal(np.sort(read),
                                  np.sort(probes.lcg_indices(seed, n_iters,
                                                             1000)))
    ref = probes.hbm_dma_plain(table, n_iters, depth, seed=seed)[0].numpy()
    np.testing.assert_array_equal(got, ref)
    if n_iters == depth:
        assert not got.any()
