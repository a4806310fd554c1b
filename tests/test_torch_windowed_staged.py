"""The windowed walk's staged and global variants
(``kernels/edt_windowed.py``): the choice between them by axis length and
layout, the staged CTA's shared-memory bytes against the kernel's layout,
the forced variants' refusal of a CPU tensor, ``walk_count`` against a
brute-force walk over tiles, and the plain version (what the wrapper runs
on a CPU tensor) against the JAX package's windowed Pallas kernel in
interpret mode, bit for bit (tolerance 0: each candidate is one rounding and
min is exact), in both pass layouts, with +inf holes and all-+inf lines on
ragged axis lengths. The kernels themselves run only on a card (the
``cuda``-marked test and ``chip_smoke.py``). Inputs come from numpy
seeds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu.kernels import edt_pallas
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as eb
from voxelized_geometry_tools_tpu_torch.kernels import edt_windowed as ew

CH, TQ, WL = eb.CHUNK, eb.TILE_Q, eb.WARP_LINES


def _field(shape, seed, hi=300.0, p_inf=0.4, p_inf_line=0.2):
    """f >= 0 with +inf holes and whole +inf lines (the windowed kernel's
    contract)."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.0, hi, shape).astype(np.float32)
    f[rng.uniform(size=shape) < p_inf] = np.inf
    if len(shape) > 1 and p_inf_line:
        f[..., rng.uniform(size=shape[-2]) < p_inf_line, :] = np.inf
    return f


def _layout(n, lines_contiguous, lines=3):
    """A [2, lines, n] field in the z pass's layout (positions contiguous)
    or a moved view in the y pass's (lines contiguous)."""
    if lines_contiguous:
        return torch.zeros(2, n, lines).movedim(1, -1)
    return torch.zeros(2, lines, n)


@pytest.mark.parametrize("n,lines_contiguous,warps", [
    (37, False, 8), (512, False, 8), (608, False, 8), (609, False, 16),
    (1024, False, 16), (1280, False, 16), (1281, False, 8), (1536, False, 8),
    (1537, False, 0), (2048, False, 0), (37, True, 8), (512, True, 8),
    (896, True, 8), (897, True, 16), (1024, True, 16), (1808, True, 16),
    (1809, True, 0), (2048, True, 0)])
def test_staged_or_global_by_axis_length_and_layout(n, lines_contiguous,
                                                    warps):
    """Two 8-warp CTAs an SM where they fit (one stages while the other
    walks), else one of 16 warps, else one of 8, else the global variant:
    the z layout's per-warp output tiles make its staged axes shorter."""
    assert ew.windowed_warps(n, lines_contiguous) == warps
    line_plan, got, _ = ew.plan(_layout(n, lines_contiguous))
    assert got == warps
    assert line_plan.lines_contiguous == lines_contiguous
    assert not line_plan.copy
    if warps:
        assert (ew.windowed_smem_bytes(n, lines_contiguous, warps)
                <= eb.SMEM_BLOCK_LIMIT)
    two_fit = 2 * (ew.windowed_smem_bytes(n, lines_contiguous, 8)
                   + eb.SMEM_BLOCK_RESERVED) <= eb.SMEM_SM
    assert two_fit == (warps == 8 and n < 1024)
    if not warps:
        for w in (8, 16):
            assert (ew.windowed_smem_bytes(n, lines_contiguous, w)
                    > eb.SMEM_BLOCK_LIMIT)


def test_the_main_paths_axes_are_staged():
    """The 512^3 EDT's y and z passes and the streamed 1024^3 slabs take
    the staged variant in both layouts."""
    for n in (512, 1024):
        for lc in (False, True):
            assert ew.windowed_warps(n, lc) > 0


def test_staged_smem_layout():
    """The block as the staged best-first kernel stages it (rows
    [n16][32], or lines [32][stride] with stride = 4 mod 32) and, in the z
    layout, one padded 32 x 33 output tile per warp; nothing else."""
    assert ew.windowed_smem_bytes(512, True, 8) == 4 * 512 * 32
    assert ew.windowed_smem_bytes(512, True, 16) == 4 * 512 * 32
    assert ew.windowed_smem_bytes(512, False, 8) == 4 * (
        32 * 516 + 8 * 32 * 33)
    assert ew.windowed_smem_bytes(500, False, 16) == 4 * (
        32 * 516 + 16 * 32 * 33)
    # n = 37: n16 = 48 = 16 mod 32, so the stride is 48 + 20.
    assert ew.windowed_smem_bytes(37, False, 8) == 4 * (32 * 68 + 8 * 1056)
    assert ew.windowed_smem_bytes(37, True, 16) == 4 * 48 * 32
    # The staged best-first CTA's block, without its minima and bounds.
    for n in (1, 37, 300, 513, 1500):
        n_ch = -(-n // CH)
        for w in (8, 16):
            assert ew.windowed_smem_bytes(n, True, w) == (
                eb.staged_smem_bytes(n, True, w) - 4 * (n_ch + w * n_ch))


@pytest.mark.parametrize("fn", [ew.parabolic_envelope_last_staged,
                                ew.parabolic_envelope_last_global])
def test_forced_variants_refuse_a_cpu_tensor(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros(3, 4))


def test_wrapper_runs_plain_on_cpu_without_launching():
    f = torch.from_numpy(_field((3, 5, 70), 2))
    before = (ew.launches_staged, ew.launches)
    got = ew.parabolic_envelope_last(f)
    assert torch.equal(got, eb.parabolic_envelope_last_plain(f))
    assert (ew.launches_staged, ew.launches) == before


# -- The walk count ---------------------------------------------------------


def _tiles(f, d):
    """Every (real f block, real d tile, q0) of [B, lines, n] arrays, as the
    kernel tiles them."""
    b, lines, n = f.shape
    for i in range(b):
        for l0 in range(0, lines, WL):
            ls = slice(l0, min(l0 + WL, lines))
            for q0 in range(0, n, TQ):
                yield f[i, ls], d[i, ls, q0:q0 + TQ], q0


def _steps(q0, n):
    """The walk of the tile at q0: its own chunks, then per step the
    step's geometric bound and its chunks (lo first)."""
    n_ch = -(-n // CH)
    lo0, hi0 = q0 // CH, min((q0 + TQ + CH - 1) // CH, n_ch)
    own = list(range(lo0, hi0))
    steps = []
    lo, hi = lo0 - 1, hi0
    while lo >= 0 or hi < n_ch:
        db = np.float32(q0 - (lo * CH + CH - 1))
        dh = np.float32(hi * CH - (q0 + TQ - 1))
        bound = min(db * db if lo >= 0 else np.float32(np.inf),
                    dh * dh if hi < n_ch else np.float32(np.inf))
        steps.append((bound, [c for c in (lo, hi) if 0 <= c < n_ch]))
        lo, hi = lo - 1, hi + 1
    return own, steps


def _walked(q0, n, dmax):
    """The chunks the walk of the tile at q0 takes while each step's bound
    is below dmax."""
    own, steps = _steps(q0, n)
    walked = list(own)
    for bound, cs in steps:
        if not bound < dmax:
            break
        walked += cs
    return walked


def _brute_walk_count(f, d):
    n = f.shape[-1]
    n_ch = -(-n // CH)
    tiles = chunks = dead = whole = 0
    for fb, dt, q0 in _tiles(f, d):
        tiles += 1
        walked = _walked(q0, n, dt.max())
        chunks += len(walked)
        dead += sum(bool(np.all(np.isinf(fb[:, c * CH:(c + 1) * CH])))
                    for c in walked)
        whole += len(walked) == n_ch
    return {"tiles": tiles, "chunks": chunks, "dead": dead,
            "whole_axis": whole, "outputs": d.size}


@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 70, 100), (3, 5, 16),
                                   (1, 33, 1), (2, 1, 50), (1, 40, 300)])
def test_walk_count_matches_brute_force(shape):
    """+inf holes and whole +inf lines, ragged n and ragged line counts."""
    f = _field(shape, sum(shape), p_inf=0.6, p_inf_line=0.2)
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f))
    got = ew.walk_count(torch.from_numpy(f), d)
    assert got == _brute_walk_count(f, d.numpy())


def test_walk_count_on_an_all_finite_field_has_no_dead_chunks():
    f = _field((2, 40, 200), 9, p_inf=0.0, p_inf_line=0.0)
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f))
    got = ew.walk_count(torch.from_numpy(f), d)
    assert got["dead"] == 0 and got["whole_axis"] == 0
    assert got == _brute_walk_count(f, d.numpy())


def test_walk_count_of_an_all_inf_line_walks_the_whole_axis():
    """A tile holding one all-+inf line walks every chunk, none of them
    dead (the other lines are finite); chunks that are +inf on every line
    of a block count as dead."""
    f = _field((1, 40, 96), 4, p_inf=0.0, p_inf_line=0.0)
    f[0, 3] = np.inf  # in the first 32-line block only
    f[0, 32:, 48:] = np.inf  # the second block's last three chunks
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f))
    first = ew.walk_count(torch.from_numpy(f[:, :32]), d[:, :32])
    assert first["whole_axis"] == 3 and first["chunks"] == 3 * 6
    assert first["dead"] == 0
    got = ew.walk_count(torch.from_numpy(f), d)
    assert got["dead"] > 0
    assert got == _brute_walk_count(f, d.numpy())


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_running_walk_visits_at_least_the_count_and_is_exact(seed):
    """The walk as the kernel runs it, with its running largest entry in
    the stop test (numpy float32, full chunk visits): it gives the plain
    version's bits on f >= 0 and visits, tile by tile, at least the chunks
    walk_count counts."""
    f = _field((2, 35, 150), seed, p_inf=0.7, p_inf_line=0.1)
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f)).numpy()
    n = f.shape[-1]
    ran = 0
    for fb, dt, q0 in _tiles(f, d):
        qs = np.arange(q0, q0 + dt.shape[1], dtype=np.float32)
        cur = np.full(dt.shape, np.inf, np.float32)

        def visit(c):
            for k in range(c * CH, min((c + 1) * CH, n)):
                sq = (qs - np.float32(k)) ** 2
                np.minimum(cur, sq[None, :] + fb[:, k:k + 1], out=cur)

        own, steps = _steps(q0, n)
        walked = len(own)
        for c in own:
            visit(c)
        for bound, cs in steps:
            if not bound < cur.max():
                break
            walked += len(cs)
            for c in cs:
                visit(c)
        np.testing.assert_array_equal(cur, dt)
        assert walked >= len(_walked(q0, n, dt.max()))
        ran += walked
    assert ran >= ew.walk_count(torch.from_numpy(f),
                                torch.from_numpy(d))["chunks"]


# -- The plain version against the JAX package's windowed kernel -------------


@pytest.mark.parametrize("n", [37, 300, 513])
@pytest.mark.parametrize("lines_contiguous", [False, True])
def test_plain_matches_pallas_windowed_in_both_layouts(n, lines_contiguous):
    """The plain version, on the z layout's field or on the y layout's
    moved view of its transpose, equals the JAX package's windowed kernel
    in interpret mode on the same values: f >= 0, +inf holes, whole +inf
    lines (the tiles that walk every chunk)."""
    f = _field((2, 5, n), n + int(lines_contiguous), p_inf_line=0.3)
    f[1, 2] = np.inf
    ref = np.asarray(edt_pallas.parabolic_envelope_last_pallas_windowed(
        jnp.asarray(f), tile_lines=8, tile_q=16, interpret=True))
    x = torch.from_numpy(f)
    if lines_contiguous:
        x = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 2, 1)))
        x = x.movedim(1, -1)
        assert x.stride(-2) == 1
    got = ew.parabolic_envelope_last(x)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.cuda
def test_cuda_both_variants_match_plain_in_both_layouts():
    """On a card: the staged and the global variant against the plain
    version, bitwise, positions contiguous and lines contiguous, ragged
    edges, +inf holes and all-+inf lines; the staged output keeps the
    input's strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (37, 300, 513, 1800):
        for shape in [(3, 45, n), (2, n, 70)]:
            x = torch.from_numpy(_field(shape, n)).cuda()
            if shape[1] == n:
                x = x.movedim(1, -1)
            ref = eb.parabolic_envelope_last_plain(x)
            glob = ew.parabolic_envelope_last_global(x)
            if ew.plan(x)[1]:
                staged = ew.parabolic_envelope_last_staged(x)
                torch.cuda.synchronize()
                assert staged.stride() == x.stride()
                assert torch.equal(staged, ref)
            torch.cuda.synchronize()
            assert torch.equal(glob, ref)
