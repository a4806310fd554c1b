"""The full-sweep envelope kernel's staged and global variants
(``kernels/edt_envelope.py``): the choice between them by axis length and
layout, the staged CTA's shared-memory bytes against the kernel's layout,
the forced variants' refusal of a CPU tensor, and the plain version (what
the wrapper runs on a CPU tensor) against the JAX package's full-sweep
Pallas kernel in interpret mode, bit for bit (tolerance 0: each candidate
is one rounding and min is exact), in both pass layouts, with +inf,
negative values and ragged axis lengths. The kernels themselves run only on
a card (the ``cuda``-marked test and ``chip_smoke.py``). Inputs come from
numpy seeds."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu.kernels import edt_pallas
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as eb
from voxelized_geometry_tools_tpu_torch.kernels import edt_envelope as ee


def _field(shape, seed, lo=-60.0, hi=300.0, p_inf=0.4, p_inf_line=0.2):
    rng = np.random.default_rng(seed)
    f = rng.uniform(lo, hi, shape).astype(np.float32)
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
    (37, False, 8), (512, False, 8), (576, False, 8), (577, False, 16),
    (1024, False, 16), (1184, False, 16), (1185, False, 8), (1440, False, 8),
    (1441, False, 0),
    (2048, False, 0), (512, True, 8), (848, True, 8), (849, True, 16),
    (1024, True, 16), (1696, True, 16), (1697, True, 0), (2048, True, 0)])
def test_staged_or_global_by_axis_length_and_layout(n, lines_contiguous,
                                                    warps):
    """Two 8-warp CTAs an SM where they fit (one stages while the other
    sweeps), else one of 16 warps, else one of 8, else the global variant:
    the z layout's per-warp output tiles make its staged axes shorter."""
    assert ee.envelope_warps(n, lines_contiguous) == warps
    line_plan, got, f3 = ee.plan(_layout(n, lines_contiguous))
    assert got == warps
    assert line_plan.lines_contiguous == lines_contiguous
    assert not line_plan.copy
    if warps:
        assert (ee.envelope_smem_bytes(n, lines_contiguous, warps)
                <= eb.SMEM_BLOCK_LIMIT)
    two_fit = 2 * (ee.envelope_smem_bytes(n, lines_contiguous, 8)
                   + eb.SMEM_BLOCK_RESERVED) <= eb.SMEM_SM
    assert two_fit == (warps == 8 and n < 1024)
    if not warps:
        for w in (8, 16):
            assert (ee.envelope_smem_bytes(n, lines_contiguous, w)
                    > eb.SMEM_BLOCK_LIMIT)


def test_the_main_paths_axes_are_staged():
    """The 512^3 EDT's y and z passes and the streamed 1024^3 slabs take
    the staged variant in both layouts."""
    for n in (512, 1024):
        for lc in (False, True):
            assert ee.envelope_warps(n, lc) > 0


def test_staged_smem_layout():
    """The block as the staged best-first kernel stages it (rows
    [n16][32], or lines [32][stride] with stride = 4 mod 32), the squares
    table sq[i] = (i - n16 + 1)^2 of 2 n16 + 16 floats, and in the z layout
    one padded 32 x 33 output tile per warp."""
    assert ee.envelope_smem_bytes(512, True, 8) == 4 * (512 * 32 + 1040)
    assert ee.envelope_smem_bytes(512, False, 8) == 4 * (
        32 * 516 + 1040 + 8 * 32 * 33)
    assert ee.envelope_smem_bytes(500, False, 16) == 4 * (
        32 * 516 + 1040 + 16 * 32 * 33)
    # n = 37: n16 = 48 = 16 mod 32, so the stride is 48 + 20.
    assert ee.envelope_smem_bytes(37, False, 8) == 4 * (
        32 * 68 + 112 + 8 * 1056)
    assert ee.envelope_smem_bytes(37, True, 16) == 4 * (48 * 32 + 112)
    # The squares table covers every read: the last chunk's 48 squares
    # start at most at 2 n16 - 32 for any tile.
    for n in (1, 16, 17, 37, 300, 512, 513, 1024):
        n16 = -(-n // 16) * 16
        q0_max = (-(-n // 32) - 1) * 32
        assert q0_max + n16 - 16 + 48 <= 2 * n16 + 16


@pytest.mark.parametrize("fn", [ee.parabolic_envelope_last_staged,
                                ee.parabolic_envelope_last_global])
def test_forced_variants_refuse_a_cpu_tensor(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros(3, 4))


@pytest.mark.parametrize("n", [37, 300, 513])
@pytest.mark.parametrize("lines_contiguous", [False, True])
@pytest.mark.parametrize("lo", [-60.0, 0.0])
def test_plain_matches_pallas_full_sweep_in_both_layouts(n, lines_contiguous,
                                                         lo):
    """The plain version, on the z layout's field or on the y layout's
    moved view of its transpose, equals the JAX package's full sweep in
    interpret mode on the same values."""
    f = _field((2, 5, n), n - int(lo), lo=lo)
    ref = np.asarray(edt_pallas.parabolic_envelope_last_pallas(
        jnp.asarray(f), tile_lines=8, interpret=True))
    x = torch.from_numpy(f)
    if lines_contiguous:
        x = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 2, 1)))
        x = x.movedim(1, -1)
        assert x.stride(-2) == 1
    before = (ee.launches_staged, ee.launches)
    got = ee.parabolic_envelope_last(x)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ee.launches_staged, ee.launches) == before


@pytest.mark.parametrize("fill", [np.inf, 0.0, -3.0])
def test_plain_matches_pallas_on_constant_fields(fill):
    f = np.full((3, 40), fill, np.float32)
    ref = np.asarray(edt_pallas.parabolic_envelope_last_pallas(
        jnp.asarray(f), tile_lines=8, interpret=True))
    np.testing.assert_array_equal(
        ee.parabolic_envelope_last(torch.from_numpy(f)).numpy(), ref)


@pytest.mark.cuda
def test_cuda_both_variants_match_plain_in_both_layouts():
    """On a card: the staged and the global variant against the plain
    version, bitwise, positions contiguous and lines contiguous, ragged
    edges, negative values and +inf; the staged output keeps the input's
    strides."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (37, 300, 513):
        for shape in [(3, 45, n), (2, n, 70)]:
            x = torch.from_numpy(_field(shape, n)).cuda()
            if shape[1] == n:
                x = x.movedim(1, -1)
            ref = eb.parabolic_envelope_last_plain(x)
            staged = ee.parabolic_envelope_last_staged(x)
            glob = ee.parabolic_envelope_last_global(x)
            torch.cuda.synchronize()
            assert staged.stride() == x.stride()
            assert torch.equal(staged, ref)
            assert torch.equal(glob, ref)
