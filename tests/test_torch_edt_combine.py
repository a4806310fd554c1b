"""The EDT's signed combine (``kernels/edt_combine.py``), bit for bit.

On the CPU the wrapper takes the plain version, which is held here against
the combine as the EDT formed it before the kernel, ``_sqrt(a) * res -
_sqrt(b) * res`` in eager operations, and against numpy; the dense and
streamed EDTs, which both combine through it, against each other. A model
of the kernel's walk (``csrc/edt_combine.cu``: its launch plan, each
thread's 4-voxel groups by the grid-stride loop, then the scalar tail)
checks its index arithmetic before the card runs it. The card tests hold
the kernel against the plain version on the card and count its launches.
Inputs are every squared integer distance of a grid, ``+inf`` and seeded
masks.
"""

import re

import numpy as np
import pytest
import torch

from voxelized_geometry_tools_tpu_torch.kernels import build, edt_combine
from voxelized_geometry_tools_tpu_torch.ops import edt

_SRC = (build.SRC_DIR / "edt_combine.cu").read_text()
THREADS = int(re.search(r"constexpr int THREADS = (\d+);", _SRC).group(1))
UNROLL = int(re.search(r"constexpr int UNROLL = (\d+);", _SRC).group(1))

# Resolutions: the cells' pitches (1 cm, 6 mm), the streamed tests' 5 cm,
# one exact in binary and one that rounds differently in float32 and
# float64.
RESOLUTIONS = [0.01, 0.006, 0.05, 1.0, 1 / 3]
# The streamed reference tests' shapes (prime axes take the pad branch).
SHAPES = [(13, 17, 19), (24, 10, 6), (6, 23, 16), (9, 8, 40)]
DTYPES = {"float32": torch.float32, "float64": torch.float64}


def squared_distances(n):
    """Every squared integer distance of an ``n^3`` grid (the integers
    below ``3 n^2``) and ``+inf``, as float32."""
    d = torch.arange(3 * n * n + 1, dtype=torch.float32)
    d[-1] = float("inf")
    return d


def _pairs(n):
    """Each squared distance against another (reversed), against itself
    and against ``+inf``; ``+inf`` against ``+inf`` too."""
    d = squared_distances(n)
    a = torch.cat([d, d, d, torch.full_like(d, float("inf"))])
    b = torch.cat([d.flip(0), d, torch.full_like(d, float("inf")), d])
    return a, b


def today(a, b, resolution, dtype):
    """The combine as the EDT wrote it in eager operations before the
    kernel."""
    res = torch.tensor(resolution, dtype=dtype)
    return edt._sqrt(a, dtype) * res - edt._sqrt(b, dtype) * res


def _same_bits(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}[got.dtype]
    assert torch.equal(got.view(ints), want.view(ints))


@pytest.mark.parametrize("resolution", RESOLUTIONS)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_plain_matches_eager_combine_on_every_distance(dtype, resolution):
    """Every squared integer distance below 3 * 512^2 and +inf, in both
    types: the plain version, the wrapper on CPU tensors, its one-field
    forms in order (as the float64 streamed EDT takes them) and numpy's
    correctly rounded roots give today's bits."""
    dtype = DTYPES[dtype]
    a, b = _pairs(512)
    want = today(a, b, resolution, dtype)
    assert bool(want.isnan().any()) and bool(want.isinf().any())
    _same_bits(edt_combine.signed_combine_plain(
        a, b, resolution, torch.empty(a.shape, dtype=dtype)), want)
    before = edt_combine.launches
    _same_bits(edt_combine.signed_combine(
        a, b, resolution, torch.empty(a.shape, dtype=dtype)), want)
    out = torch.empty(a.shape, dtype=dtype)
    edt_combine.signed_combine(a, None, resolution, out)
    _same_bits(edt_combine.signed_combine(None, b, resolution, out), want)
    assert edt_combine.launches == before
    npt = np.float32 if dtype == torch.float32 else np.float64
    res = npt(resolution)
    with np.errstate(invalid="ignore"):
        ref = (np.sqrt(a.double().numpy()).astype(npt) * res
               - np.sqrt(b.double().numpy()).astype(npt) * res)
    np.testing.assert_array_equal(want.numpy(), ref)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_in_place_forms_on_cpu(dtype):
    """``out`` may be ``a`` or ``b`` itself; a float32 field is combined in
    place as the float32 streamed EDT does it."""
    dtype = DTYPES[dtype]
    a, b = _pairs(64)
    want = today(a, b, 0.006, dtype)
    if dtype == torch.float32:
        x = a.clone()
        assert edt_combine.signed_combine(x, b, 0.006, x) is x
        _same_bits(x, want)
        y = b.clone()
        _same_bits(edt_combine.signed_combine(a, y, 0.006, y), want)
    out = torch.zeros(a.shape, dtype=dtype)
    assert edt_combine.signed_combine(a, None, 0.006, out) is out
    _same_bits(out, edt._sqrt(a, dtype) * torch.tensor(0.006, dtype=dtype))


def _mask(shape, seed, p):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < p
    mask[tuple(s // 2 for s in shape)] = True
    return torch.from_numpy(mask)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", SHAPES)
def test_dense_and_streamed_agree(shape, dtype):
    """The dense EDT (one combine over the stacked field's halves) and the
    streamed one (float32 in place over the first field; float64 one field
    at a time) give the same bits, and the eager combine's."""
    dtype = DTYPES[dtype]
    mask = _mask(shape, 2024 + sum(shape), 0.2)
    dense = edt.signed_distance_from_filled_mask(mask, 0.05, dtype=dtype)
    streamed = edt.signed_distance_from_filled_mask_streamed(
        mask, 0.05, slab=8, dtype=dtype)
    _same_bits(streamed, dense)
    assert dense.is_contiguous() and streamed.is_contiguous()
    want = today(edt.squared_edt(mask), edt.squared_edt(~mask), 0.05, dtype)
    _same_bits(dense, want)


def _bad_inputs():
    a, b = torch.zeros(2, 3), torch.ones(2, 3)
    out = torch.empty(2, 3)
    return {
        "no_field": (ValueError, (None, None, out)),
        "a_float64": (TypeError, (a.double(), b, out)),
        "b_int32": (TypeError, (a, b.int(), out)),
        "b_other_shape": (ValueError, (a, b[:1], out)),
        "out_other_shape": (ValueError, (a, b, out[:, :2])),
        "mixed_devices": (ValueError, (a, b, out.to("meta"))),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_wrapper_raises(case):
    error, (a, b, out) = _bad_inputs()[case]
    with pytest.raises(error):
        edt_combine.signed_combine(a, b, 0.01, out)


def plan(n, aligned, sms, per_sm):
    """``launch``'s plan: the 4-voxel groups the 16-byte path takes and the
    grid's blocks."""
    groups = n // 4 if aligned else 0
    work, per_block = (groups, THREADS * UNROLL) if groups else (n, THREADS)
    return groups, max(1, min(-(-work // per_block), sms * per_sm))


def walk(n, groups, blocks):
    """How often ``edt_combine_kernel`` writes each voxel: the grid-stride
    loop over groups (UNROLL of them a thread a step), then the tail."""
    written = np.zeros(n, np.int64)
    tile = THREADS * UNROLL
    first = (np.arange(blocks)[:, None, None] * tile
             + np.arange(THREADS)[None, :, None]
             + np.arange(UNROLL)[None, None, :] * THREADS).ravel()
    step = 0
    while True:
        g0 = (np.arange(blocks)[:, None] * tile + np.arange(THREADS)
              ).ravel() + step * blocks * tile
        live = np.repeat(g0 < groups, UNROLL)
        if not live.any():
            break
        g = first + step * blocks * tile
        g = g[live & (g < groups)]
        np.add.at(written, (4 * g[:, None] + np.arange(4)).ravel(), 1)
        step += 1
    i = 4 * groups + np.arange(blocks * THREADS)
    while (i < n).any():
        np.add.at(written, i[i < n], 1)
        i = i + blocks * THREADS
    return written


@pytest.mark.parametrize("grid", [(1, 1), (3, 2), (132, 8)])
@pytest.mark.parametrize("n", [1, 3, 4, 7, 1024, 4097,
                               3 * THREADS * UNROLL * 4 + 5])
@pytest.mark.parametrize("aligned", [True, False])
def test_walk_writes_every_voxel_once(aligned, n, grid):
    """The 16-byte path and the scalar one (an unaligned pointer), over
    one block, a few, and more than the groups need."""
    groups, blocks = plan(n, aligned, *grid)
    assert (walk(n, groups, blocks) == 1).all()


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernel_matches_plain(card):
    """On the card: every squared integer distance below 3 * 1024^2 and
    +inf, each form and both types, against the plain version on the card,
    bitwise; odd lengths, an unaligned start and the alias ``out is a``;
    one launch a call."""
    a, b = (t.to(card) for t in _pairs(1024))
    for dtype in DTYPES.values():
        for resolution in (0.01, 0.006, 1 / 3):
            for lo, hi in ((0, a.numel()), (1, a.numel()), (0, 4101),
                           (3, 4102), (0, 7), (5, 6)):
                x, y = a[lo:hi], b[lo:hi]
                want = edt_combine.signed_combine_plain(
                    x, y, resolution, torch.empty(x.shape, dtype=dtype,
                                                  device=card))
                first = edt_combine.signed_combine_plain(
                    x, None, resolution, torch.empty(x.shape, dtype=dtype,
                                                     device=card))
                cases = [("both", x, y), ("first", x, None)]
                if dtype == torch.float32:
                    cases.append(("in place", x, y))
                for name, p, q in cases:
                    out = (x.clone() if name == "in place"
                           else torch.empty(x.shape, dtype=dtype,
                                            device=card))
                    p = out if name == "in place" else p
                    before = edt_combine.launches
                    got = edt_combine.signed_combine(p, q, resolution, out)
                    torch.cuda.synchronize()
                    assert edt_combine.launches == before + 1
                    _same_bits(got, first if name == "first" else want)
                out = first.clone()
                edt_combine.signed_combine(None, y, resolution, out)
                torch.cuda.synchronize()
                _same_bits(out, want)


@pytest.mark.cuda
def test_cuda_edts_launch_the_kernel_once(card):
    """One launch a dense EDT and a float32 streamed EDT, two a float64
    streamed EDT (one a field); the same bits as the CPU's."""
    mask = _mask((40, 36, 44), 7, 0.2)
    for dtype, streamed_launches in ((torch.float32, 1), (torch.float64, 2)):
        want = edt.signed_distance_from_filled_mask(mask, 0.006, dtype=dtype)
        before = edt_combine.launches
        dense = edt.signed_distance_from_filled_mask(mask.to(card), 0.006,
                                                     dtype=dtype)
        torch.cuda.synchronize()
        assert edt_combine.launches == before + 1
        _same_bits(dense.cpu(), want)
        before = edt_combine.launches
        streamed = edt.signed_distance_from_filled_mask_streamed(
            mask.to(card), 0.006, slab=8, dtype=dtype)
        torch.cuda.synchronize()
        assert edt_combine.launches == before + streamed_launches
        _same_bits(streamed.cpu(), want)
