"""The staged best-first EDT kernel's host side, the port's device default,
and the plain min-plus against the JAX package.

On the CPU (no card, no ``nvcc``): the wrapper's layout plan (which
orientation template the staged kernel takes, that no copy is made, that
the output keeps the caller's strides, and the staged/global choice by
axis length), the visit count behind the kernel's arithmetic bound against
a brute-force count, the entry points' device default (the card, or a
clear error naming ``device="cpu"``), and the plain version against JAX
``backend="xla"`` in both pass layouts. Bit-exact comparisons have
tolerance 0 (every value is an exact integer or one rounding of one). The
kernel itself runs only on a card (the ``cuda``-marked test here and
``chip_smoke.py``). Inputs come from numpy seeds.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu import OccupancyMap as JOccupancyMap
from voxelized_geometry_tools_tpu.core import transforms as jtransforms
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu_torch import (
    GridSpec, OccupancyMap, SignedDistanceField, entry, interop)
from voxelized_geometry_tools_tpu_torch.core import transforms
from voxelized_geometry_tools_tpu_torch.core.device import default_device
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as eb
from voxelized_geometry_tools_tpu_torch.ops import edt
from voxelized_geometry_tools_tpu_torch.ops.render import PinholeCamera


def _field(shape, seed, lo=-40.0, hi=300.0, p_inf=0.4, p_inf_line=0.0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(lo, hi, shape).astype(np.float32)
    f[rng.uniform(size=shape) < p_inf] = np.inf
    if len(shape) > 1 and p_inf_line:
        f[..., rng.uniform(size=shape[-2]) < p_inf_line, :] = np.inf
    return f


# -- The device default ------------------------------------------------------

_POSE = np.eye(4, dtype=np.float32)
_SPEC = GridSpec.from_voxel_counts(0.25, (4, 5, 6))

# Every entry point that makes tensors from host data or from nothing.
_HOST_ENTRY_POINTS = {
    "entry": lambda **kw: entry.entry(**kw),
    "OccupancyMap.create": lambda **kw: OccupancyMap.create(_SPEC, **kw),
    "SignedDistanceField.create": lambda **kw: SignedDistanceField.create(
        _SPEC, np.zeros((4, 5, 6), np.float32), **kw),
    "PinholeCamera.create": lambda **kw: PinholeCamera.create(
        _POSE, 8, 6, focal=5.0, **kw),
    "interop.sdf_from_numpy": lambda **kw: interop.sdf_from_numpy(
        _SPEC, np.zeros((4, 5, 6), np.float32), _POSE, **kw),
    "interop.camera_from_numpy": lambda **kw: interop.camera_from_numpy(
        _POSE, 5.0, 5.0, 3.5, 2.5, 8, 6, **kw),
    "interop.corner_table_from_numpy": lambda **kw:
        interop.corner_table_from_numpy(np.zeros((3, 8), np.float32), **kw),
    "transforms.identity_isometry": lambda **kw:
        transforms.identity_isometry(**kw),
    "transforms.isometry_from_translation": lambda **kw:
        transforms.isometry_from_translation((1.0, 2.0, 3.0), **kw),
}

# Entry points whose data may be host data or a tensor (a tensor keeps its
# device): the EDT's, given a numpy mask or occupancy.
_DATA_ENTRY_POINTS = {
    "extract_signed_distance_field":
        lambda x: edt.extract_signed_distance_field(x, _SPEC, None),
    "extract_sdf_from_occupancy": lambda x: edt.extract_sdf_from_occupancy(
        x.astype(np.float32) if isinstance(x, np.ndarray) else x.float(),
        _SPEC, None),
}


def _mask():
    m = np.zeros((4, 5, 6), bool)
    m[1:3, 2:4, 1:5] = True
    return m


def _tensors(result):
    if isinstance(result, torch.Tensor):
        return [result]
    if isinstance(result, tuple):
        return [t for r in result for t in _tensors(r)]
    return [v for v in vars(result).values() if isinstance(v, torch.Tensor)]


@pytest.mark.parametrize("name", sorted(_HOST_ENTRY_POINTS))
def test_default_device_is_the_card(name, monkeypatch):
    """Without a card, the default raises and names device="cpu"; it never
    falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _HOST_ENTRY_POINTS[name]()


@pytest.mark.parametrize("name", sorted(_HOST_ENTRY_POINTS))
def test_explicit_cpu_device_runs_on_the_cpu(name):
    result = _HOST_ENTRY_POINTS[name](device="cpu")
    tensors = _tensors(result)
    assert tensors and all(t.device.type == "cpu" for t in tensors)


@pytest.mark.parametrize("name", sorted(_DATA_ENTRY_POINTS))
def test_host_data_goes_to_the_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        _DATA_ENTRY_POINTS[name](_mask())


@pytest.mark.parametrize("name", sorted(_DATA_ENTRY_POINTS))
def test_cpu_tensor_keeps_its_device_and_matches_jax(name, monkeypatch):
    """A CPU tensor stays on the CPU even where no card is, and the result
    equals the JAX package's bit for bit."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mask = _mask()
    got = _DATA_ENTRY_POINTS[name](torch.from_numpy(mask))
    jspec = JGridSpec.from_voxel_counts(0.25, (4, 5, 6))
    if name == "extract_signed_distance_field":
        ref = jedt.extract_signed_distance_field(jnp.asarray(mask), jspec, None)
    else:
        ref = jedt.extract_sdf_from_occupancy(mask.astype(np.float32), jspec,
                                              None)
    assert got.distances.device.type == "cpu"
    np.testing.assert_array_equal(got.distances.numpy(),
                                  np.asarray(ref.distances))


def test_given_tensors_keep_their_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    sdf = SignedDistanceField.create(_SPEC, torch.zeros(4, 5, 6))
    cam = PinholeCamera.create(torch.eye(4), 8, 6, focal=5.0)
    iso = transforms.isometry_from_translation(torch.ones(3))
    assert {t.device.type for t in (sdf.distances, sdf.origin_transform,
                                    cam.pose, cam.fx, iso)} == {"cpu"}
    assert default_device(like=torch.zeros(1)) == torch.device("cpu")
    assert default_device("cpu") == torch.device("cpu")


def test_cpu_occupancy_map_and_isometry_match_jax():
    jspec = JGridSpec.from_voxel_counts(0.25, (4, 5, 6))
    jm = JOccupancyMap.create(jspec, None, "world")
    tm = OccupancyMap.create(_SPEC, None, "world", device="cpu")
    np.testing.assert_array_equal(tm.occupancy.numpy(),
                                  np.asarray(jm.occupancy))
    np.testing.assert_array_equal(tm.origin_transform.numpy(),
                                  np.asarray(jm.origin_transform))
    np.testing.assert_array_equal(
        transforms.identity_isometry(device="cpu").numpy(),
        np.asarray(jtransforms.identity_isometry()))


# -- The staged kernel's layout plan -----------------------------------------


def _plan_and_output(f):
    plan, f3 = eb.plan_lines(f)
    return plan, f3, eb.staged_output(plan, f3).reshape(f.shape)


def test_plan_y_pass_view_reads_lines_in_place():
    """The y pass's input, d.movedim(1, -1) of a contiguous [2x, y, z]
    field: lines (z) contiguous, read and written in place."""
    d = torch.zeros(6, 40, 24)
    f = d.movedim(1, -1)
    plan, f3, out = _plan_and_output(f)
    assert plan.lines_contiguous and not plan.copy and plan.staged
    assert (plan.batch, plan.lines, plan.n) == (6, 24, 40)
    assert f3.data_ptr() == f.data_ptr()
    assert out.shape == f.shape and out.stride() == f.stride()
    assert out.movedim(-1, 1).is_contiguous()


def test_plan_z_pass_tensor_reads_positions_in_place():
    d = torch.zeros(6, 40, 24)
    plan, f3, out = _plan_and_output(d)
    assert not plan.lines_contiguous and not plan.copy and plan.staged
    assert (plan.batch, plan.lines, plan.n) == (6, 40, 24)
    assert f3.data_ptr() == d.data_ptr()
    assert out.stride() == d.stride() and out.is_contiguous()


def _streamed_inputs(shape, axis):
    """What the streamed pipeline hands the envelope for ``axis`` of a
    contiguous grid of ``shape``, slab by slab."""
    seen = []
    real = edt._envelope_last

    def record(f, block, backend):
        seen.append(f)
        return real(f, block, backend)

    d = torch.from_numpy(_field(shape, 5, lo=0.0))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(edt, "_envelope_last", record)
        edt._streamed_envelope_axis(d, axis, 8, 512, "auto")
    return seen


@pytest.mark.parametrize("axis", [1, 2])
def test_plan_streamed_cube_slabs_keep_their_strides(axis):
    """A cube's slabs are narrowed along axis 0 (dense): each is read in
    place, in the y layout for axis 1 and the z layout for axis 2, and its
    output has the slab's own strides."""
    slabs = _streamed_inputs((20, 20, 20), axis)
    assert len(slabs) == 4  # slabs of 5 (the largest divisor of 20 <= 8)
    for f in slabs:
        plan, f3, out = _plan_and_output(f)
        assert plan.lines_contiguous == (axis == 1)
        assert not plan.copy and f3.data_ptr() == f.data_ptr()
        assert out.stride() == f.stride()


@pytest.mark.parametrize("axis", [1, 2])
def test_plan_strided_slabs_are_read_in_place(axis):
    """An anisotropic grid's slabs are narrowed along a later axis, so
    they are strided views: still no copy, the right template, and an
    output dense in the same layout."""
    slabs = _streamed_inputs((6, 40, 20), axis)
    assert len(slabs) > 1
    for f in slabs:
        assert not f.is_contiguous()
        plan, f3, out = _plan_and_output(f)
        assert plan.lines_contiguous == (axis == 1)
        assert not plan.copy and f3.data_ptr() == f.data_ptr()
        inner = (-2,) if plan.lines_contiguous else (-1,)
        assert all(out.stride(i) == 1 == f.stride(i) for i in inner)


def test_plan_copies_only_when_neither_axis_is_contiguous():
    x = torch.zeros(5, 6, 7).permute(1, 2, 0)[:, ::2]  # no unit stride
    plan, f3, _ = _plan_and_output(x)
    assert plan.copy and not plan.lines_contiguous and f3.is_contiguous()
    plan, _, _ = _plan_and_output(torch.zeros(9))
    assert (plan.batch, plan.lines, plan.n) == (1, 1, 9)


@pytest.mark.parametrize("n,warps", [(512, 8), (1024, 16), (1792, 0),
                                     (2048, 0)])
@pytest.mark.parametrize("lines_contiguous", [True, False])
def test_staged_or_global_by_axis_length(n, warps, lines_contiguous):
    """The choice is made by shape: 512 stages with two 8-warp CTAs per SM,
    1024 with one 16-warp CTA, 1792 and 2048 take the clustered variant (a
    cluster of 2 CTAs of 16 warps; the global variant runs only above a
    cluster's reach). The staged block fits a block's opt-in shared memory
    whenever it is chosen."""
    assert eb.staged_warps(n, lines_contiguous) == warps
    assert eb.cluster_plan(n, lines_contiguous) == ((0, 0) if warps else
                                                    (2, 16))
    if warps:
        assert (eb.staged_smem_bytes(n, lines_contiguous, warps)
                <= eb.SMEM_BLOCK_LIMIT)
    if warps == 8:
        assert 2 * (eb.staged_smem_bytes(n, lines_contiguous, 8)
                    + eb.SMEM_BLOCK_RESERVED) <= eb.SMEM_SM
    for w in (8, 16):
        if not warps:
            assert (eb.staged_smem_bytes(n, lines_contiguous, w)
                    > eb.SMEM_BLOCK_LIMIT)
    f = torch.zeros(2, 3, n) if not lines_contiguous else \
        torch.zeros(2, n, 3).movedim(1, -1)
    plan = eb.plan_lines(f)[0]
    assert plan.staged == bool(warps)
    assert plan.clustered == (not warps)


def test_staged_smem_layout():
    """The block: 32 lines of n16 rows, a z-layout line stride of 4 mod 32
    words (so 16-byte loads are conflict-free), the minima, and a region
    per warp (the bounds; in the z layout also a padded 32 x 33 tile)."""
    n_ch = 32
    assert eb.staged_smem_bytes(512, True, 8) == 4 * (
        512 * 32 + n_ch + 8 * n_ch)
    assert eb.staged_smem_bytes(512, False, 8) == 4 * (
        32 * 516 + n_ch + 8 * 32 * 33)
    assert eb.staged_smem_bytes(500, False, 8) == 4 * (
        32 * 516 + n_ch + 8 * 32 * 33)
    # n = 37: 3 chunks, n16 = 48 = 16 mod 32, so the stride is 48 + 20.
    assert eb.staged_smem_bytes(37, False, 8) == 4 * (32 * 68 + 3 + 8 * 1056)


@pytest.mark.parametrize("fn", [eb.parabolic_envelope_last_staged,
                                eb.parabolic_envelope_last_global])
def test_forced_variants_refuse_a_cpu_tensor(fn):
    with pytest.raises(ValueError, match="unsupported device"):
        fn(torch.zeros(3, 4))


# -- The visit count ---------------------------------------------------------


def _brute_visit_count(f, d, tile_q):
    """Loops over every (batch, line block, q tile, chunk) of ``f``
    ([B, lines, n]) with numpy float32 arithmetic."""
    b, lines, n = f.shape
    ch, wl = eb.CHUNK, eb.WARP_LINES
    chunks = cand = tiles = 0
    for i in range(b):
        for l0 in range(0, lines, wl):
            ls = min(wl, lines - l0)
            for q0 in range(0, n, tile_q):
                tiles += 1
                qs = min(tile_q, n - q0)
                dmax = d[i, l0:l0 + ls, q0:q0 + qs].max()
                for k0 in range(0, n, ch):
                    rows = min(ch, n - k0)
                    cmin = f[i, l0:l0 + ls, k0:k0 + rows].min()
                    gap = max(q0 - (k0 + ch - 1), k0 - (q0 + tile_q - 1), 0)
                    g = np.float32(gap)
                    if np.float32(g * g) + np.float32(cmin) < dmax:
                        chunks += 1
                        cand += rows * qs * ls
    return {"tiles": tiles, "chunks": chunks, "candidates": cand,
            "outputs": d.size}


@pytest.mark.parametrize("shape", [(2, 37, 45), (1, 70, 100), (3, 5, 16),
                                   (1, 33, 1), (2, 1, 50)])
@pytest.mark.parametrize("tile_q", [32, 16])
def test_visit_count_matches_brute_force(shape, tile_q):
    """+inf holes and whole +inf lines, negative values, ragged n and
    ragged line counts."""
    f = _field(shape, sum(shape) + tile_q, lo=-30.0, p_inf_line=0.2)
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f))
    got = eb.visit_count(torch.from_numpy(f), d, tile_q=tile_q)
    assert got == _brute_visit_count(f, d.numpy(), tile_q)


@pytest.mark.parametrize("seed", [1, 2])
def test_visit_count_geometric_and_layouts(seed):
    """A non-negative field, whose zero minima leave the geometric term of
    the bound alone, against brute force; and a y-layout view counted as its
    [B, lines, n] values."""
    f = _field((2, 50, 70), seed, lo=0.0, p_inf_line=0.3)
    f[:, ::3, ::5] = 0.0
    d = eb.parabolic_envelope_last_plain(torch.from_numpy(f))
    assert eb.visit_count(torch.from_numpy(f), d) == \
        _brute_visit_count(f, d.numpy(), eb.TILE_Q)
    view = torch.from_numpy(np.ascontiguousarray(f.transpose(0, 2, 1)))
    fy = view.movedim(1, -1)
    assert eb.visit_count(fy, eb.parabolic_envelope_last_plain(fy)) == \
        eb.visit_count(torch.from_numpy(f), d)


def test_visit_count_degenerate_fields():
    """All +inf, or all equal: no bound is below the final largest entry, so
    nothing counts (a tie does not). One seed per line at k = 0: each tile
    needs chunk 0 alone (the others hold only +inf)."""
    inf = torch.full((1, 40, 64), float("inf"))
    assert eb.visit_count(inf, inf)["chunks"] == 0
    flat = torch.full((1, 40, 64), 5.0)
    assert eb.visit_count(flat, eb.parabolic_envelope_last_plain(flat))[
        "chunks"] == 0
    seeds = inf.clone()
    seeds[..., 0] = 0.0
    got = eb.visit_count(seeds, eb.parabolic_envelope_last_plain(seeds))
    assert got == {"tiles": 4, "chunks": 4, "outputs": 40 * 64,
                   "candidates": 2 * 16 * 32 * (32 + 8)}


# -- The plain version against JAX, both layouts -----------------------------


@pytest.mark.parametrize("shape", [(7, 13, 37), (3, 50), (1, 1, 4), (64,),
                                   (5, 48), (260, 33), (64, 160), (7, 96)])
@pytest.mark.parametrize("lo", [0.0, -80.0])
def test_plain_matches_jax_xla_in_both_layouts(shape, lo):
    """The shapes of tests/test_torch_edt.py: the plain version on the
    contiguous field (the z pass's layout) and on a moved view of its
    transpose (the y pass's) equals JAX's XLA min-plus."""
    f = _field(shape, 31 + len(shape), lo=lo)
    ref = np.asarray(jedt._parabolic_envelope_last(jnp.asarray(f)))
    np.testing.assert_array_equal(
        eb.parabolic_envelope_last_plain(torch.from_numpy(f)).numpy(), ref)
    if len(shape) > 1 and shape[-2] > 1:
        t = torch.from_numpy(np.ascontiguousarray(np.swapaxes(f, -1, -2)))
        view = t.transpose(-1, -2)
        assert view.stride(-2) == 1
        np.testing.assert_array_equal(
            eb.parabolic_envelope_last(view).numpy(), ref)


@pytest.mark.parametrize("name", ["center", "corner", "random",
                                  "random_sparse", "empty"])
def test_plain_squared_edt_matches_jax_xla(name):
    rng = np.random.default_rng(21)
    masks = {"random": rng.random((24, 17, 33)) < 0.3,
             "random_sparse": rng.random((19, 30, 26)) < 0.02,
             "empty": np.zeros((4, 8, 12), bool)}
    for key, box in (("center", np.s_[1:3, 2:6, 3:9]),
                     ("corner", np.s_[0:2, 0:4, 0:6])):
        masks[key] = np.zeros((4, 8, 12), bool)
        masks[key][box] = True
    mask = masks[name]
    np.testing.assert_array_equal(
        edt.squared_edt(torch.from_numpy(mask), backend="plain").numpy(),
        np.asarray(jedt.squared_edt(jnp.asarray(mask), backend="xla")))


@pytest.mark.cuda
def test_cuda_staged_kernel_matches_plain_in_both_layouts():
    """On a card: the staged variant against the plain version, bitwise,
    positions contiguous and lines contiguous, ragged edges, negative
    values and +inf."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (37, 300, 513):
        for shape in [(3, 45, n), (2, n, 70)]:
            x = torch.from_numpy(_field(shape, n, p_inf_line=0.2)).cuda()
            if shape[1] == n:
                x = x.movedim(1, -1)
            got = eb.parabolic_envelope_last_staged(x)
            torch.cuda.synchronize()
            assert got.stride() == x.stride()
            assert torch.equal(got, eb.parabolic_envelope_last_plain(x))
