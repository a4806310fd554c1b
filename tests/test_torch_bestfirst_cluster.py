"""The best-first kernel's clustered variant (``kernels/edt_bestfirst.py``):
its plan by axis length and layout, the per-CTA shared-memory bytes against
the kernel's layout, the chunk and q-tile shares of the CTAs, a torch
emulation of the kernel's order (the minima formed per share, each tile's
best-first walk reading every chunk from the CTA that holds it, the stop)
against the plain version, the visit count's remote chunks against brute
force, and the plain version against the JAX package's in-kernel-minima
best-first Pallas kernel (``_bestfirst_kernel``) in interpret mode at an
axis above the staged limit. Bit-exact comparisons have tolerance 0 (each
candidate is one rounding and min is exact). The kernel itself runs only
on a card (the ``cuda``-marked test and ``chip_smoke.py``). Inputs come
from numpy seeds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu.kernels import edt_pallas
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as eb

CH, TQ, WL = eb.CHUNK, eb.TILE_Q, eb.WARP_LINES


def _field(shape, seed, lo=-40.0, hi=300.0, p_inf=0.4, p_inf_line=0.2):
    rng = np.random.default_rng(seed)
    f = rng.uniform(lo, hi, shape).astype(np.float32)
    f[rng.uniform(size=shape) < p_inf] = np.inf
    if len(shape) > 1 and p_inf_line:
        f[..., rng.uniform(size=shape[-2]) < p_inf_line, :] = np.inf
    return f


def _layout(n, lines_contiguous, lines=3):
    if lines_contiguous:
        return torch.zeros(2, n, lines).movedim(1, -1)
    return torch.zeros(2, lines, n)


# -- The plan ----------------------------------------------------------------


@pytest.mark.parametrize("n,lines_contiguous,plan", [
    (512, False, (0, 0)), (1536, False, (0, 0)), (1537, False, (2, 16)),
    (2048, False, (2, 16)), (2496, False, (2, 16)), (2497, False, (2, 8)),
    (3073, False, (4, 16)), (6145, False, (8, 16)), (12032, False, (8, 8)),
    (12033, False, (0, 0)), (16384, False, (0, 0)),
    (512, True, (0, 0)), (1776, True, (0, 0)), (1777, True, (2, 16)),
    (2048, True, (2, 16)), (3393, True, (2, 8)), (3489, True, (4, 16)),
    (6785, True, (8, 16)), (12672, True, (8, 8)), (12673, True, (0, 0)),
    (16384, True, (0, 0))])
def test_cluster_plan_by_axis_and_layout(n, lines_contiguous, plan):
    """None up to the staged limits (the staged variant runs), a cluster of
    2 at 2048, the smallest of 2, 4, 8 whose shares fit beyond, and none
    above an 8-CTA cluster's reach (the global variant runs)."""
    assert eb.cluster_plan(n, lines_contiguous) == plan
    staged = eb.staged_warps(n, lines_contiguous)
    line_plan, _ = eb.plan_lines(_layout(n, lines_contiguous))
    assert (line_plan.cluster, line_plan.cluster_warps) == plan
    assert line_plan.staged == bool(staged)
    assert line_plan.clustered == bool(plan[0])
    assert not (line_plan.staged and line_plan.clustered)
    if not staged and not plan[0]:
        for w in (8, 16):
            assert (eb.cluster_smem_bytes(n, lines_contiguous, 8, w)
                    > eb.SMEM_BLOCK_LIMIT)
    if plan[0]:
        c, w = plan
        assert eb.cluster_smem_bytes(n, lines_contiguous, c, w) <= \
            eb.SMEM_BLOCK_LIMIT
        for smaller in eb.CLUSTER_SIZES[:eb.CLUSTER_SIZES.index(c)]:
            assert eb.cluster_warps(n, lines_contiguous, smaller) == 0


def test_the_main_paths_axes_take_no_cluster():
    for n in (512, 1024):
        for lc in (False, True):
            assert eb.cluster_plan(n, lc) == (0, 0)
            assert eb.staged_warps(n, lc) > 0


def test_cluster_smem_bytes_mirror_the_layout():
    """A CTA's share of the block (rows [share16][32], or lines
    [32][stride] with stride = 4 mod 32), the minima of all n_ch chunks, and
    one region per warp (the bounds of n_ch chunks; in the z layout at
    least a padded 32 x 33 output tile)."""
    # n = 2048, C = 2, 16 warps: 1,024 rows a CTA, 128 chunks.
    assert eb.cluster_smem_bytes(2048, True, 2, 16) == \
        131_072 + 512 + 16 * 512 == 139_776
    assert eb.cluster_smem_bytes(2048, False, 2, 16) == \
        32 * 1028 * 4 + 512 + 16 * 4224 == 199_680
    # n = 1800: 113 chunks, 57 a share (912 rows = 16 mod 32: stride 932).
    assert eb.cluster_smem_bytes(1800, False, 2, 16) == 4 * (
        32 * 932 + 113 + 16 * 1056)
    assert eb.cluster_smem_bytes(1800, True, 2, 8) == 4 * (
        912 * 32 + 113 + 8 * 113)
    # n = 12000, C = 8: 750 chunks, 94 a share (1,504 rows: stride 1,508);
    # the region holds the 1,056-float tile in the z layout.
    assert eb.cluster_smem_bytes(12000, False, 8, 8) == 4 * (
        32 * 1508 + 750 + 8 * 1056)
    assert eb.cluster_smem_bytes(12000, True, 8, 8) == 4 * (
        1504 * 32 + 750 + 8 * 750)
    # Where there is one CTA's worth of chunks, the share equals the staged
    # block and the rest is the staged layout's.
    for n in (37, 300, 513):
        for lc in (False, True):
            assert eb.cluster_smem_bytes(n, lc, 2, 8) <= \
                eb.staged_smem_bytes(n, lc, 8)


@pytest.mark.parametrize("cluster", [2, 4, 8])
@pytest.mark.parametrize("n", [1, 16, 37, 100, 513, 1537, 2048, 2050, 4100])
def test_shares_partition_the_axis(cluster, n):
    """The chunk shares are consecutive, at most share_ch long, and cover
    every chunk once; each q tile belongs to the CTA holding its first row,
    and the tile shares cover every tile once."""
    share_ch, chunks, tiles = eb.cluster_shares(n, cluster)
    n_ch, n_qt = -(-n // CH), -(-n // TQ)
    assert len(chunks) == len(tiles) == cluster
    assert [c for r in chunks for c in r] == list(range(n_ch))
    assert [t for r in tiles for t in r] == list(range(n_qt))
    for r in range(cluster):
        assert len(chunks[r]) <= share_ch
        assert all(c // share_ch == r for c in chunks[r])
        for t in tiles[r]:
            assert (t * TQ) // (share_ch * CH) == r


# -- The clustered order, emulated -------------------------------------------


def _chunk_bound(q0, c, cmin):
    """chunk_bound of csrc/edt_bestfirst.cu: float32, rounded as there."""
    gap = max(q0 - (c * CH + CH - 1), c * CH - (q0 + TQ - 1), 0)
    g = torch.tensor(float(gap), dtype=torch.float32)
    return g * g + cmin


def _emulate_cluster(f, cluster):
    """The clustered kernel's arithmetic on ``f`` ([B, lines, n] float32
    tensor), one (b, 32-line block) at a time: CTA r stages its share of
    rows (+inf past the real rows and lines), forms its chunks' minima,
    which every CTA's tiles then read; each tile of CTA r walks best-first
    (the smallest remaining bound, the lowest chunk on a tie) until that
    bound is >= every real entry, reading each chunk from the share of the
    CTA that holds it. Returns the result and the chunk loads, all and
    remote."""
    b, lines, n = f.shape
    n_ch = -(-n // CH)
    share_ch, chunks, tiles = eb.cluster_shares(n, cluster)
    share16 = share_ch * CH
    out = torch.empty_like(f)
    loads = remote = 0
    inf = float("inf")
    for i in range(b):
        for l0 in range(0, lines, WL):
            nl = min(WL, lines - l0)
            shares = []
            for r in range(cluster):
                s = torch.full((WL, share16), inf)
                rows = f[i, l0:l0 + nl, r * share16:(r + 1) * share16]
                s[:nl, :rows.shape[1]] = rows
                shares.append(s)
            cmin = torch.empty(n_ch)
            for r in range(cluster):
                for c in chunks[r]:
                    k = (c - r * share_ch) * CH
                    cmin[c] = shares[r][:, k:k + CH].min()
            for r in range(cluster):
                for qt in tiles[r]:
                    q0 = qt * TQ
                    qc = min(TQ, n - q0)
                    bounds = torch.stack([_chunk_bound(q0, c, cmin[c])
                                          for c in range(n_ch)])
                    d = torch.full((WL, TQ), inf)
                    d[:, qc:] = -inf
                    q = torch.arange(q0, q0 + TQ, dtype=torch.float32)
                    while True:
                        c = int(torch.argmin(bounds))
                        if bool(d[:nl].max() <= bounds[c]):
                            break
                        owner = c // share_ch
                        loads += 1
                        remote += owner != r
                        k0 = (c - owner * share_ch) * CH
                        fk = shares[owner][:, k0:k0 + CH]
                        for u in range(CH):
                            sq = (q - float(c * CH + u)) ** 2
                            d = torch.minimum(d, sq[None, :] + fk[:, u:u + 1])
                        bounds[c] = inf
                    out[i, l0:l0 + nl, q0:q0 + qc] = d[:nl, :qc]
    return out, loads, remote


@pytest.mark.parametrize("shape,cluster", [
    ((2, 40, 100), 2), ((1, 35, 100), 4), ((1, 33, 100), 8),
    ((1, 5, 300), 2), ((1, 7, 37), 8), ((2, 3, 1), 2)])
def test_emulated_cluster_order_gives_plain_bits(shape, cluster):
    """Negative values, +inf holes and whole +inf lines, ragged lines and
    n, shares that are short or empty (n_ch = 3 over 8 CTAs); the loads
    include remote ones, and at least the chunks visit_count counts."""
    f = torch.from_numpy(_field(shape, sum(shape) + cluster))
    ref = eb.parabolic_envelope_last_plain(f)
    got, loads, remote = _emulate_cluster(f, cluster)
    assert torch.equal(got, ref)
    vc = eb.visit_count(f, ref, cluster=cluster)
    assert loads >= vc["chunks"] and remote >= vc["remote"]
    if shape[-1] >= 100:
        assert remote > 0


def _brute_remote(f, d, cluster):
    """Visited chunks (bound below the tile's final largest entry) that
    another CTA than the tile's holds, by loops in numpy float32."""
    b, lines, n = f.shape
    share_ch = eb.cluster_shares(n, cluster)[0]
    remote = 0
    for i in range(b):
        for l0 in range(0, lines, WL):
            ls = min(WL, lines - l0)
            for q0 in range(0, n, TQ):
                dmax = d[i, l0:l0 + ls, q0:q0 + TQ].max()
                for k0 in range(0, n, CH):
                    cmin = f[i, l0:l0 + ls, k0:k0 + CH].min()
                    gap = max(q0 - (k0 + CH - 1), k0 - (q0 + TQ - 1), 0)
                    g = np.float32(gap)
                    if np.float32(g * g) + np.float32(cmin) < dmax:
                        remote += (k0 // CH) // share_ch != \
                            q0 // (share_ch * CH)
    return remote


@pytest.mark.parametrize("cluster", [2, 4, 8])
def test_visit_count_remote_matches_brute_force(cluster):
    f = _field((2, 37, 150), cluster, lo=-30.0)
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f))
    got = eb.visit_count(torch.from_numpy(f), d, cluster=cluster)
    assert got["remote"] == _brute_remote(f, d.numpy(), cluster)
    without = eb.visit_count(torch.from_numpy(f), d)
    assert "remote" not in without
    assert {k: got[k] for k in without} == without


# -- The plain version against the JAX package -------------------------------


@pytest.mark.parametrize("lines_contiguous", [False, True])
def test_plain_matches_pallas_inkernel_minima_above_the_staged_limit(
        lines_contiguous):
    """n = 1,800, above both staged limits (a cluster of 2 on the card): the
    plain version equals ``_bestfirst_kernel`` (hoist_cmin=False) in
    interpret mode, on a few lines with negative values and +inf, in both
    pass layouts."""
    n = 1800
    assert eb.cluster_plan(n, lines_contiguous)[0] == 2
    f = _field((1, 3, n), 11 + int(lines_contiguous), lo=-50.0, p_inf=0.6,
               p_inf_line=0.0)
    f[0, 1] = np.inf
    ref = np.asarray(edt_pallas.parabolic_envelope_last_pallas_bestfirst(
        jnp.asarray(f), tile_lines=8, tile_q=32, interpret=True,
        hoist_cmin=False))
    x = torch.from_numpy(f)
    if lines_contiguous:
        x = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 2, 1)))
        x = x.movedim(1, -1)
        assert x.stride(-2) == 1
    before = (eb.launches_cluster, eb.launches_inkernel)
    got = eb.parabolic_envelope_last(x, hoist_cmin=False)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (eb.launches_cluster, eb.launches_inkernel) == before


def test_forced_cluster_refuses_a_cpu_tensor():
    with pytest.raises(ValueError, match="unsupported device"):
        eb.parabolic_envelope_last_cluster(torch.zeros(3, 4))


@pytest.mark.cuda
def test_cuda_cluster_matches_plain_in_both_layouts():
    """On a card: the clustered variant (its plan's cluster and each forced
    size) against the plain version, bitwise, positions contiguous and
    lines contiguous, ragged edges, negative values and +inf; 2048 takes
    it through the wrapper with either hoist_cmin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (37, 513, 1800, 2048):
        for shape in [(3, 45, n), (2, n, 70)]:
            x = torch.from_numpy(_field(shape, n)).cuda()
            if shape[1] == n:
                x = x.movedim(1, -1)
            ref = eb.parabolic_envelope_last_plain(x)
            for cluster in (None,) + eb.CLUSTER_SIZES:
                got = eb.parabolic_envelope_last_cluster(x, cluster=cluster)
                torch.cuda.synchronize()
                assert got.stride() == x.stride()
                assert torch.equal(got, ref)
            if n == 2048:
                for hoist in (True, False):
                    before = eb.launches_cluster
                    got = eb.parabolic_envelope_last(x, hoist_cmin=hoist)
                    torch.cuda.synchronize()
                    assert eb.launches_cluster == before + 1
                    assert torch.equal(got, ref)
