"""The EDT's axis-0 seed pass (``kernels/edt_seed.py``) against the JAX
package's, bit for bit.

On the CPU the wrapper takes the plain prefix scans; the card's kernel is
held against them by ``chip_smoke.py``. Here a numpy model of the kernel's
walk (``csrc/edt_seed.cu``: each line's mask packed into 32-bit words, runs
found by their first differing bit, one step of x at a time for every line;
or, in its global variant for long lines, runs found in the mask itself)
is held against both, so its index arithmetic is checked before the card
runs it. Inputs come from numpy seeds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu_torch.kernels import edt_seed
from voxelized_geometry_tools_tpu_torch.ops import edt

_INF = np.float32(np.inf)


def _jax_fields(mask, fields):
    """The JAX package's seed pass of ``mask`` (and ``~mask``) along axis
    0, stacked."""
    return np.concatenate([
        np.moveaxis(np.asarray(jedt._binary_squared_dist_last(
            jnp.asarray(np.moveaxis(m, 0, -1)))), -1, 0)
        for m in (mask, ~mask)[:fields]])


def _run_end(bits, x, v):
    """``run_end`` of csrc/edt_seed.cu for every line of ``bits`` ([lines,
    words] uint32) at once: the first index beyond ``x`` whose bit differs
    from the line's ``v``, or ``nx`` (the caller clamps)."""
    lines, words = bits.shape
    flip = np.where(v, np.uint32(0xFFFFFFFF), np.uint32(0))
    w = np.full(lines, x >> 5)
    keep = np.uint32(((0xFFFFFFFF << (x & 31)) << 1) & 0xFFFFFFFF)
    word = (bits[np.arange(lines), w] ^ flip) & keep
    end = np.full(lines, -1)
    while True:
        found = (word != 0) & (end < 0)
        low = word & (~word + np.uint32(1))  # lowest set bit
        end[found] = (w[found] << 5) + np.log2(
            low[found].astype(np.float64)).astype(np.int64)
        todo = (end < 0) & (w + 1 < words)
        if not todo.any():
            break
        w[todo] += 1
        word[todo] = bits[np.flatnonzero(todo), w[todo]] ^ flip[todo]
    return np.where(end < 0, 1 << 30, end)


def _run_end_global(lines, x, v):
    """``run_end`` of the global variant for every line of ``lines``
    ([lines, nx] bool): the first index beyond ``x`` whose voxel differs
    from the line's ``v``, or ``nx``, found a voxel at a time."""
    nx = lines.shape[1]
    i = np.full(lines.shape[0], x + 1)
    while True:
        step = (i < nx) & (lines[np.arange(lines.shape[0]),
                                 np.minimum(i, nx - 1)] == v)
        if not step.any():
            return i
        i[step] += 1


def _kernel_model(mask, fields, packed=True):
    """The kernel's two phases on a bool [nx, ny, nz] array: pack (the
    packed variant only), then walk x with every line's run state (value,
    s - 1, e) in lockstep."""
    nx, ny, nz = mask.shape
    lines = mask.reshape(nx, ny * nz).T
    words = (nx + 31) // 32
    padded = np.zeros((ny * nz, words * 32), bool)
    padded[:, :nx] = lines
    bits = (padded.reshape(ny * nz, words, 32).astype(np.uint32)
            << np.arange(32, dtype=np.uint32)).sum(-1, dtype=np.uint32)

    def run_end(x, v, at):
        """``run_end`` of the lines ``at`` (indices), whose values are
        ``v[at]``."""
        if packed:
            return np.minimum(nx, _run_end(bits[at], x, v[at]))
        return _run_end_global(lines[at], x, v[at])

    out = np.empty((fields * nx, ny * nz), np.float32)
    v = lines[:, 0].copy()
    left = np.full(ny * nz, -1)
    e = run_end(0, v, np.arange(ny * nz))
    for x in range(nx):
        new = np.flatnonzero(e == x)
        if new.size:
            v[new] = ~v[new]
            left[new] = x - 1
            e[new] = run_end(x, v, new)
        m = np.where(e < nx, e - x, np.iinfo(np.int32).max)
        m = np.where(left >= 0, np.minimum(m, x - left), m)
        fm = m.astype(np.float32)
        d = np.where(m == np.iinfo(np.int32).max, _INF, fm * fm)
        out[x] = np.where(v, 0.0, d)
        if fields == 2:
            out[nx + x] = np.where(v, d, 0.0)
    return out.reshape(fields * nx, ny, nz)


def _random(shape, fill, seed):
    return np.random.default_rng(seed).random(shape) < fill


def _lines_without_seeds():
    """Random lines beside lines with no filled voxel and lines with no
    free one (+inf in one field)."""
    m = _random((40, 9, 12), 0.5, 3)
    m[:, ::3] = False
    m[:, 1::3] = True
    return m


_CASES = {
    **{f"random-{fill}-nx{nx}": (lambda fill=fill, nx=nx: _random(
        (nx, 5, 7) if nx < 1024 else (nx, 3, 4), fill, nx))
       for fill in (0.1, 0.5, 0.9) for nx in (1, 2, 33, 1024)},
    "lines-without-seeds": _lines_without_seeds,
    "all-filled": lambda: np.ones((17, 4, 6), bool),
    "all-free": lambda: np.zeros((17, 4, 6), bool),
    "runs-across-words": lambda: np.repeat(
        _random((9, 6, 5), 0.5, 4), 23, axis=0)[:200],
}


@pytest.mark.parametrize("fields", [1, 2])
@pytest.mark.parametrize("name", sorted(_CASES))
def test_seed_fields_match_plain_jax_and_kernel_model(name, fields):
    mask = _CASES[name]()
    got = edt_seed.seed_fields(torch.from_numpy(mask), fields)
    assert got.dtype == torch.float32 and got.is_contiguous()
    assert tuple(got.shape) == (fields * mask.shape[0],) + mask.shape[1:]
    ref = _jax_fields(mask, fields)
    np.testing.assert_array_equal(got.numpy(), ref)
    plain = torch.cat([
        edt._binary_squared_dist_last(m.movedim(0, -1)).movedim(-1, 0)
        for m in (torch.from_numpy(mask), torch.from_numpy(~mask))[:fields]])
    assert torch.equal(got, plain)
    np.testing.assert_array_equal(_kernel_model(mask, fields), ref)


@pytest.mark.parametrize("name", sorted(_CASES))
def test_global_variant_model_matches(name):
    """The kernel's global variant (lines too long for their bits to fit
    shared memory) walks the same runs, found in the mask itself."""
    mask = _CASES[name]()
    np.testing.assert_array_equal(_kernel_model(mask, 2, packed=False),
                                  _jax_fields(mask, 2))


@pytest.mark.parametrize("view", ["movedim", "narrow"])
def test_seed_fields_take_strided_views(view):
    """A permuted view (the streamed and envelope callers' ``movedim``) and
    a slab (``narrow``) give the fields of their contiguous copies."""
    base = torch.from_numpy(_random((30, 26, 22), 0.4, 5))
    mask = base.movedim(2, 0) if view == "movedim" else base.narrow(1, 5, 9)
    assert not mask.is_contiguous()
    for fields in (1, 2):
        got = edt_seed.seed_fields(mask, fields)
        want = edt_seed.seed_fields(mask.contiguous(), fields)
        assert got.is_contiguous() and torch.equal(got, want)
        np.testing.assert_array_equal(
            got.numpy(), _jax_fields(mask.numpy(), fields))


def test_two_fields_stack_filled_then_free():
    mask = torch.from_numpy(_random((25, 6, 8), 0.3, 6))
    two = edt_seed.seed_fields(mask, 2)
    assert torch.equal(two[:25], edt_seed.seed_fields(mask, 1))
    assert torch.equal(two[25:], edt_seed.seed_fields(~mask, 1))
    assert bool((two[:25][mask] == 0).all())
    assert bool((two[25:][~mask] == 0).all())


@pytest.mark.parametrize("bad", ["uint8", "float32", "2-D", "4-D",
                                 "nx-over-int32", "fields-3"])
def test_seed_fields_reject(bad):
    mask = torch.zeros((4, 3, 2), dtype=torch.bool)
    fields = 1
    if bad in ("uint8", "float32"):
        mask = mask.to(getattr(torch, bad))
    elif bad == "2-D":
        mask = mask[0]
    elif bad == "4-D":
        mask = mask[None]
    elif bad == "nx-over-int32":
        # A stride-0 view: the check reads the shape before any work.
        mask = torch.zeros((1, 1, 2), dtype=torch.bool).expand(
            edt_seed.MAX_NX + 1, 1, 2)
    else:
        fields = 3
    with pytest.raises((TypeError, ValueError)):
        edt_seed.seed_fields(mask, fields)


@pytest.mark.parametrize("packed", [True, False])
def test_long_lines_round_as_the_plain_version(packed):
    """Past 4,096 voxels a squared distance can exceed 2**24 and round in
    float32; the kernel's square of the least distance rounds as the plain
    version's least square does, in both variants."""
    nx = 14_530  # one past the H100's longest packed line; odd squares
    mask = np.zeros((nx, 2, 3), bool)
    mask[0, 0, 0] = mask[-1, 0, 1] = mask[nx // 2, 1, 0] = True
    mask[:, 1, 1] = True
    mask[7, 1, 1] = False
    got = edt_seed.seed_fields(torch.from_numpy(mask), 2).numpy()
    assert got[nx - 1, 0, 0] == np.float32(nx - 1) * np.float32(nx - 1)
    assert int(got[nx - 1, 0, 0]) != (nx - 1) ** 2  # rounded
    np.testing.assert_array_equal(got, _jax_fields(mask, 2))
    np.testing.assert_array_equal(_kernel_model(mask, 2, packed), got)


def test_cpu_routing_launches_nothing_and_keeps_any_nx():
    """A CPU tensor takes the plain version on every caller of the seed
    pass (no launch), and the EDT's own route has no axis limit there."""
    mask = torch.from_numpy(_random((24, 10, 12), 0.3, 7))
    before = edt_seed.launches
    edt_seed.seed_fields(mask, 2)
    edt.squared_edt(mask)
    edt.signed_distance_from_filled_mask(mask, 0.1)
    edt.squared_edt_streamed(mask, slab=4)
    edt.signed_distance_with_virtual_border(mask, 0.1)
    assert edt_seed.launches == before == 0
    long = torch.from_numpy(_random((20_000, 1, 2), 0.01, 8))
    np.testing.assert_array_equal(edt_seed.seed_fields(long, 2).numpy(),
                                  _jax_fields(long.numpy(), 2))
