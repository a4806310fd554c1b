"""The fusion filter (``kernels/fusion_filter.py``) against the JAX
package's ``combine_and_filter``, bit for bit.

On the CPU the wrapper takes the plain version; the card's kernel is held
against it by ``chip_smoke.py`` and by the card test below. Here a numpy
model of the kernel's walk (``csrc/fusion_filter.cu``: its launch plan,
each thread's 4-voxel groups by the grid-stride loop, the camera loop with
two tallies a voxel, the wrapping int32 add, then the scalar tail) is held
against both, so its index arithmetic and its rounding are checked before
the card runs it. Inputs come from numpy seeds.
"""

import re

import numpy as np
import pytest
import torch

from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch.kernels import build, fusion_filter
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

_SRC = (build.SRC_DIR / "fusion_filter.cu").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", _SRC).group(1))
UNROLL = int(re.search(r"constexpr int UNROLL = (\d+);", _SRC).group(1))

# Counter values beside the small ones: beyond 2^24 (where int -> float
# rounds), near the int32 ends, negative.
SPECIAL = np.array([2 ** 24 + 1, 2 ** 24 + 3, 2 ** 25 - 1, 123_456_789,
                    2 ** 30 + 7, 2 ** 31 - 5, 2 ** 31 - 1, -1, -5, -2 ** 31],
                   np.int64).astype(np.int32)
# (free, filled) pairs put first in camera 0: sums that wrap past 2^31 - 1,
# that round, and each vote.
PAIRS = [(2 ** 31 - 1, 5), (2 ** 30 + 7, 2 ** 30 + 9), (3, 2 ** 31 - 1),
         (2 ** 24 + 1, 2 ** 24 + 3), (2 ** 24 + 3, 1), (1, 1), (2, 3),
         (0, 3), (5, 0), (-3, 4), (0, 0), (4, -2)]
OCCUPANCY = np.array([0.0, 0.25, 0.5, np.nextafter(np.float32(0.5),
                                                   np.float32(1.0)),
                      1.0, np.nan, -0.0, 0.75], np.float32)
# Voxel shapes: a multiple of 4 voxels and a ragged one, both longer than
# one block's tile of groups, so the grid-stride loop turns.
SHAPES = {"whole": (5, 24, 40), "ragged": (5, 23, 41)}


def _inputs(cameras, shape, seed):
    rng = np.random.default_rng(seed)
    size = (cameras,) + shape

    def counters():
        small = rng.integers(-2, 7, size).astype(np.int32)
        return np.where(rng.random(size) < 0.3, rng.choice(SPECIAL, size),
                        small)

    free, filled = counters(), counters()
    flat_free, flat_filled = free.reshape(cameras, -1), filled.reshape(
        cameras, -1)
    for i, (f, h) in enumerate(PAIRS):
        flat_free[0, i], flat_filled[0, i] = f, h
    return free, filled, rng.choice(OCCUPANCY, shape)


def plan(cameras, n, aligned, sms, per_sm):
    """``fusion_filter_launch``'s plan: the 4-voxel groups the 16-byte path
    takes and the grid's blocks."""
    vec = aligned and (cameras <= 1 or n % 4 == 0)
    groups = n // 4 if vec else 0
    work, per_block = (groups, THREADS * UNROLL) if groups else (n, THREADS)
    return groups, max(1, min(-(-work // per_block), sms * per_sm))


def _votes(free, filled, pct_min, threshold):
    """One camera's votes (filled, free) on a set of voxels, as ``vote``
    forms them."""
    kept = np.where(filled >= threshold, filled, np.int32(0))
    seen_free, seen_filled = free > 0, kept > 0
    total = (free.view(np.uint32) + kept.view(np.uint32)).view(np.int32)
    pct = free.astype(np.float32) / np.maximum(total.astype(np.float32),
                                               np.float32(1.0))
    both = seen_free & seen_filled
    keep_free = pct >= np.float32(pct_min)
    return (np.where(both, ~keep_free, ~seen_free & seen_filled),
            np.where(both, keep_free, seen_free))


def _fuse(occ, n_filled, n_free, cameras_min):
    fused = np.where(n_filled > 0, np.float32(1.0),
                     np.where(n_free >= cameras_min, np.float32(0.0),
                              np.float32(0.5)))
    return np.where(occ <= np.float32(0.5), fused, occ)


def model(options, free, filled, occ, aligned=True, sms=1, per_sm=1):
    """The kernel's walk over ``sms * per_sm`` resident blocks: every
    thread's groups, then its tail voxels. Checks that each voxel is
    written exactly once."""
    cameras, n = free.shape[0], occ.size
    free, filled = free.reshape(cameras, n), filled.reshape(cameras, n)
    flat = occ.reshape(n)
    pct_min, threshold, cameras_min = fusion_filter.kernel_options(options)
    groups, blocks = plan(cameras, n, aligned, sms, per_sm)
    out = np.zeros(n, np.float32)
    written = np.zeros(n, np.int64)

    def walk(idx):
        n_filled = np.zeros(idx.shape, np.int32)
        n_free = np.zeros(idx.shape, np.int32)
        for c in range(cameras):
            vf, vr = _votes(free[c, idx], filled[c, idx], pct_min, threshold)
            n_filled += vf
            n_free += vr
        out[idx] = _fuse(flat[idx], n_filled, n_free, cameras_min)
        np.add.at(written, idx, 1)

    thread = (np.arange(blocks)[:, None] * THREADS
              + np.arange(THREADS)[None, :]).ravel()
    g0 = (np.arange(blocks)[:, None] * THREADS * UNROLL
          + np.arange(THREADS)[None, :]).ravel()
    while (g0 < groups).any():
        for u in range(UNROLL):
            g = g0 + u * THREADS
            g = g[g < groups]
            walk((4 * g[:, None] + np.arange(4)).ravel())
        g0 += blocks * THREADS * UNROLL
    i = 4 * groups + thread
    while (i < n).any():
        walk(i[i < n])
        i += blocks * THREADS
    assert (written == 1).all()
    return out.reshape(occ.shape)


def _plain(options, free, filled, occ):
    return fusion_filter.combine_and_filter_plain(
        options, torch.from_numpy(free), torch.from_numpy(filled),
        torch.from_numpy(occ)).numpy()


def _same_bits(a, b):
    np.testing.assert_array_equal(np.asarray(a, np.float32).view(np.uint32),
                                  np.asarray(b, np.float32).view(np.uint32))


@pytest.mark.parametrize("cameras_min", [1, 2, 3])
@pytest.mark.parametrize("threshold", [1, 3])
@pytest.mark.parametrize("pct_min", [1 / 3, 0.5, 0.7, 1.0])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cameras", [1, 2, 4])
def test_model_matches_plain_and_jax(cameras, shape, pct_min, threshold,
                                     cameras_min):
    """The kernel's model, the plain version and the JAX package's
    ``combine_and_filter`` agree bit for bit."""
    options = (pct_min, threshold, cameras_min)
    seed = int(1000 * pct_min) * 100 + 10 * threshold + cameras_min
    free, filled, occ = _inputs(cameras, SHAPES[shape], seed + cameras)
    got = model(tv.FilterOptions(*options), free, filled, occ)
    _same_bits(got, _plain(tv.FilterOptions(*options), free, filled, occ))
    _same_bits(got, jv.combine_and_filter(jv.FilterOptions(*options), free,
                                          filled, occ))
    # Kept NaNs and filled voxels occur, and free ones where enough
    # cameras look.
    assert np.isnan(got).any() and (got == 1.0).any()
    assert (got == 0.0).any() == (cameras >= cameras_min)


@pytest.mark.parametrize("grid", [(1, 1), (3, 2), (132, 8)])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("cameras", [1, 2, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_model_walk_any_plan(aligned, cameras, shape, grid):
    """The 16-byte path and the scalar one (an unaligned pointer), over
    one block, a few, and more than the groups need: each voxel written
    once, with the plain version's bits."""
    options = tv.FilterOptions(0.7, 3, 2)
    free, filled, occ = _inputs(cameras, SHAPES[shape], 7 + cameras)
    _same_bits(model(options, free, filled, occ, aligned, *grid),
               _plain(options, free, filled, occ))


@pytest.mark.parametrize("options", [(0.5, 2 ** 32 + 3, 2 ** 32 + 2),
                                     (0.5, 2 ** 31, 1),
                                     (1 / 3, 2, -(2 ** 31) - 1)])
def test_kernel_options_compare_as_plain(options):
    """Options beyond int32: the kernel's arguments (the low 32 bits)
    compare as the plain version's int32 tensors do."""
    options = tv.FilterOptions(*options)
    free, filled, occ = _inputs(2, SHAPES["ragged"], 11)
    _same_bits(model(options, free, filled, occ),
               _plain(options, free, filled, occ))


@pytest.mark.parametrize("cameras", [0, 1, 3])
def test_wrapper_takes_plain_on_cpu(cameras):
    """On CPU tensors the wrapper and ``combine_and_filter`` return the
    plain version's bits in a new tensor, launch nothing and leave the
    occupancy as it was."""
    options = tv.FilterOptions(0.5, 2, 1)
    free, filled, occ = _inputs(max(cameras, 1), SHAPES["ragged"], 5)
    free, filled = free[:cameras], filled[:cameras]
    t_occ = torch.from_numpy(occ.copy())
    before = fusion_filter.launches
    for fn in (fusion_filter.combine_and_filter_fused, tv.combine_and_filter):
        got = fn(options, torch.from_numpy(free), torch.from_numpy(filled),
                 t_occ)
        assert got.data_ptr() != t_occ.data_ptr()
        _same_bits(got.numpy(), _plain(options, free, filled, occ))
    _same_bits(t_occ.numpy(), occ)
    assert fusion_filter.launches == before


def _bad_inputs():
    free, filled, occ = (torch.from_numpy(a)
                         for a in _inputs(2, (3, 4, 5), 3))
    return {
        "free_int64": (TypeError, (free.long(), filled, occ)),
        "filled_int16": (TypeError, (free, filled.short(), occ)),
        "occupancy_float64": (TypeError, (free, filled, occ.double())),
        "counters_other_shape": (ValueError, (free[:, :2], filled[:, :2],
                                              occ)),
        "counters_without_cameras": (ValueError, (free[0], filled[0], occ)),
        "cameras_differ": (ValueError, (free, filled[:1], occ)),
        "mixed_devices": (ValueError, (free, filled, occ.to("meta"))),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_raises(case):
    error, args = _bad_inputs()[case]
    with pytest.raises(error):
        fusion_filter.combine_and_filter_fused(tv.FilterOptions(), *args)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """On the card: the kernel against the plain version, bitwise, for 1,
    2 and 4 cameras, whole and ragged grids, an unaligned and a
    non-contiguous input; one launch a call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cameras in (1, 2, 4):
        for shape in SHAPES.values():
            for options in (tv.FilterOptions(), tv.FilterOptions(0.7, 3, 2)):
                free, filled, occ = (torch.from_numpy(a).cuda() for a in
                                     _inputs(cameras, shape, cameras))
                cases = {"contiguous": (free, filled, occ),
                         "non-contiguous occupancy": (
                             free, filled,
                             occ.transpose(0, 2).contiguous().transpose(0, 2)),
                         "unaligned": tuple(
                             torch.cat([t.flatten()[:1], t.flatten()])[1:]
                             .view(t.shape) for t in (free, filled, occ))}
                want = fusion_filter.combine_and_filter_plain(
                    options, free, filled, occ)
                for name, args in cases.items():
                    before = fusion_filter.launches
                    got = fusion_filter.combine_and_filter_fused(options,
                                                                 *args)
                    torch.cuda.synchronize()
                    assert fusion_filter.launches == before + 1, name
                    assert torch.equal(got.view(torch.int32),
                                       want.view(torch.int32)), (
                        cameras, shape, options, name)
