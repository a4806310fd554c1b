"""The port's early-exit render schedule (cone prepass, block-sorted tail,
sparse final sample, work counters) against the JAX package, on the sphere
fixture of tests/test_fast_render.py (40x40x24 at 0.05 m, built by each
package's EDT: bitwise equal fields), and the port's own invariants bit
for bit.

Against JAX the contract is tests/test_fast_render.py's ``_check_cone_equiv``
and not bitwise equality: cone depths come from f32 chains (norms, cross
products, divisions) that XLA and PyTorch's CPU kernels may round
differently by an ulp."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import render as jr
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.ops import edt
from voxelized_geometry_tools_tpu_torch.ops import render as tr
from voxelized_geometry_tools_tpu_torch.ops import sdf_query as tq

# tests/test_fast_render.py's cone contract: hits of the plain march are
# hits of the cone-started one except tangent grazers (query within this
# band of the threshold, in voxels), and common depths agree within twice
# the threshold.
GRAZER_BAND = 0.08
# Gradients as tests/test_torch_render.py: each term is a chain of
# ulp-level different samples; scatter-adds sum in another order.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# The widths of the counters, which depend on shapes and the schedule only.
STATIC_KEYS = ("fine_head_width", "fine_tail_chunk_width",
               "fine_sort_blocks", "fine_sort_arrays", "final_sort_blocks",
               "final_sort_arrays")
CONE_STATIC_KEYS = ("head_width", "sort_rows", "sort_arrays",
                    "tail_chunk_width")
ITER_KEYS = ("fine_head_iters", "fine_tail_iters", "final_sample_rows")

SHIPPED = dict(num_steps=64, early_exit=True, coarse_factor=8, head_steps=0,
               tail_chunks=32, cone_steps=32, cone_tail_chunks=8)


@pytest.fixture(scope="module")
def scene():
    n = 40
    xs, ys, zs = np.meshgrid(np.arange(n), np.arange(n), np.arange(24),
                             indexing="ij", sparse=True)
    mask = ((xs - 20) ** 2 + (ys - 20) ** 2 + (zs - 12) ** 2) <= 81
    js = jedt.extract_signed_distance_field(
        jnp.asarray(mask), JGridSpec.from_voxel_counts(0.05, mask.shape),
        None, frame="t")
    ts = edt.extract_signed_distance_field(
        torch.from_numpy(mask), GridSpec.from_voxel_counts(0.05, mask.shape),
        None, frame="t")
    return js, ts, jq.build_corner_table(js), tq.build_corner_table(ts)


def _cameras(sdf, w=48, h=32, focal=45.0, back=1.5):
    sizes = np.asarray(sdf.spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, back * sizes[2]])
    jc = jr.PinholeCamera.create(pose, w, h, focal=focal)
    tc = interop.camera_from_numpy(np.asarray(jc.pose), jc.fx, jc.fy, jc.cx,
                                   jc.cy, w, h, device="cpu")
    return jc, tc


def _wide_cameras(sdf):
    """tests/test_fast_render.py:528-556: the sphere small in the frame, so
    most block cones fly through empty grid and escape."""
    return _cameras(sdf, 64, 48, focal=30.0, back=2.5)


_JRENDER = {}


def _jrender(sdf, cam, table, **kw):
    """The JAX render, jitted once per schedule (sdf, camera and table are
    traced arguments)."""
    key = tuple(sorted(kw.items()))
    if key not in _JRENDER:
        _JRENDER[key] = jax.jit(lambda s, c, t, kw=kw: jr.render_depth(
            s, c, corner_table=t, **kw))
    out = _JRENDER[key](sdf, cam, table)
    return jax.tree.map(np.asarray, out)


def _numpy(result):
    return jr.RenderResult(*(np.asarray(v) for v in result))


def _check_cone_equiv(base, cone, resolution):
    """tests/test_fast_render.py's ``_check_cone_equiv`` on numpy results:
    every base hit is a cone hit except tangent grazers; common depths
    agree within twice the threshold."""
    thresh = 0.25 * resolution
    divergent = base.hit & ~cone.hit
    graze = np.abs(base.distance - thresh) <= GRAZER_BAND * resolution
    assert not (divergent & ~graze).any(), "a non-grazer surface was lost"
    m = base.hit & cone.hit
    assert m.any()
    np.testing.assert_allclose(cone.depth[m], base.depth[m],
                               atol=2.0 * thresh + 1e-6)


def _check_stats_equal(jst, tst):
    """Static widths equal exactly; iteration counts equal."""
    for key in STATIC_KEYS:
        assert (key in jst) == (key in tst), key
        if key in jst:
            assert int(jst[key]) == tst[key], key
    for key in ITER_KEYS:
        if key in jst:
            np.testing.assert_array_equal(np.asarray(tst[key]),
                                          np.asarray(jst[key]), err_msg=key)
    assert len(jst.get("cone_stages", [])) == len(tst.get("cone_stages", []))
    for js, ts in zip(jst.get("cone_stages", []), tst.get("cone_stages", [])):
        assert set(js) == set(ts)
        for key in CONE_STATIC_KEYS:
            if key in js:
                assert int(js[key]) == ts[key], key
        for key in ("head_iters", "tail_iters"):
            if key in js:
                np.testing.assert_array_equal(np.asarray(ts[key]),
                                              np.asarray(js[key]),
                                              err_msg=key)


SCHEDULES = {
    "cf2": dict(num_steps=128, early_exit=True, coarse_factor=2),
    "cf4": dict(num_steps=128, early_exit=True, coarse_factor=4),
    "cf8": dict(num_steps=128, early_exit=True, coarse_factor=8),
    "block_tail": dict(num_steps=128, early_exit=True, coarse_factor=4,
                       head_steps=0, tail_chunks=8),
    "cone_steps4": dict(num_steps=128, early_exit=True, coarse_factor=4,
                        head_steps=0, tail_chunks=8, cone_steps=4),
    "cone_steps12": dict(num_steps=128, early_exit=True, coarse_factor=4,
                         head_steps=0, tail_chunks=8, cone_steps=12),
    "cone_refine": dict(num_steps=128, early_exit=True, coarse_factor=8,
                        head_steps=0, tail_chunks=8, cone_refine=4),
    "shipped": SHIPPED,
}


# Schedules whose JAX reference runs eagerly: on this one, the jitted JAX
# render's sparse final sample reads inf at 60 points where its own dense
# resample of the returned points is finite, and samples one chunk more
# (576 rows against the eager render's 384, which the port matches).
EAGER = {"cone_refine"}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedule_matches_jax(scene, name):
    """Port and JAX under the cone contract, each against the other and
    against the JAX package's plain early-exit march (the masks equal the
    plain march's on this grazer-free fixture, as in
    tests/test_fast_render.py), and the same counters."""
    js, ts, jt, tt = scene
    kw = SCHEDULES[name]
    w, h = (64, 48) if "cone_steps" in kw and name != "shipped" else (48, 32)
    jc, tc = _cameras(js, w, h)
    base = _numpy(_jrender(js, jc, jt, num_steps=kw["num_steps"],
                           early_exit=True))
    if name in EAGER:
        jres, jst = jax.tree.map(np.asarray, jr.render_depth(
            js, jc, corner_table=jt, with_stats=True, **kw))
    else:
        jres, jst = _jrender(js, jc, jt, with_stats=True, **kw)
    jres = _numpy(jres)
    got, tst = tr.render_depth(ts, tc, corner_table=tt, with_stats=True,
                               **kw)
    got = _numpy(got)
    _check_cone_equiv(base, got, js.resolution)
    _check_cone_equiv(jres, got, js.resolution)
    _check_cone_equiv(got, jres, js.resolution)
    np.testing.assert_array_equal(got.hit, base.hit)
    _check_stats_equal(jst, tst)
    assert tr.gather_rows_from_stats(tst) == jr.gather_rows_from_stats(jst)


def test_shipped_schedule_counters(scene):
    """bench.py's schedule: the port's counters have the JAX package's keys
    and static widths, the cone head marched, and gather_rows_from_stats
    reads both packages' counters (JAX's as numpy) the same; on the dense
    8-gather count each sample costs 8 rows."""
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    _, jst = _jrender(js, jc, jt, with_stats=True, **SHIPPED)
    _, tst = tr.render_depth(ts, tc, corner_table=tt, with_stats=True,
                             **SHIPPED)
    assert set(tst) == set(jst)
    assert int(tst["cone_stages"][0]["head_iters"]) > 0
    assert 0 < int(tst["final_sample_rows"]) <= 48 * 32
    rows = tr.gather_rows_from_stats(tst)
    assert rows == tr.gather_rows_from_stats(jst) > 0
    assert tr.gather_rows_from_stats(tst, gathers_per_sample=8.0) > rows


def test_miss_certificate_fires(scene):
    """tests/test_fast_render.py:528-556 in the port: on a miss-heavy frame
    the escape certificate covers more than a tenth of the rays, and the
    block-tail schedule's hit mask equals the JAX package's (plain march
    and the same schedule)."""
    js, ts, jt, tt = scene
    jc, tc = _wide_cameras(js)
    kw = dict(num_steps=128, early_exit=True, coarse_factor=4, head_steps=0,
              tail_chunks=8)
    base = _numpy(_jrender(js, jc, jt, num_steps=128, early_exit=True))
    jres = _numpy(_jrender(js, jc, jt, **kw))
    got = _numpy(tr.render_depth(ts, tc, corner_table=tt, **kw))
    _check_cone_equiv(base, got, js.resolution)
    np.testing.assert_array_equal(got.hit, base.hit)
    np.testing.assert_array_equal(got.hit, jres.hit)
    _, _, _, esc = tr._cone_prepass(ts, tc, 4, 128, 0.25 * ts.resolution,
                                    100.0, tt)
    assert float(esc.float().mean()) > 0.1
    assert got.hit.any()


@pytest.mark.parametrize("chunks", [4, 8])
def test_cone_tail_chunks_bitwise_invariant(scene, chunks):
    """The chunked cone tail never changes a cone's sample sequence: the
    four prepass images, and the render that uses them, equal the one-chunk
    results bit for bit."""
    _, ts, _, tt = scene
    _, tc = _cameras(ts)
    thresh = 0.25 * ts.resolution
    ref = tr._cone_prepass(ts, tc, 4, 64, thresh, 100.0, tt)
    out = tr._cone_prepass(ts, tc, 4, 64, thresh, 100.0, tt,
                           cone_tail_chunks=chunks)
    for a, b, name in zip(ref, out, ["t", "valid_from", "slow", "esc"]):
        assert torch.equal(a, b), name
    kw = dict(num_steps=64, corner_table=tt, early_exit=True,
              coarse_factor=4, head_steps=1, tail_chunks=8)
    r1 = tr.render_depth(ts, tc, **kw)
    r2 = tr.render_depth(ts, tc, cone_tail_chunks=chunks, **kw)
    for a, b in zip(r1, r2):
        assert torch.equal(a, b)


def test_with_stats_is_bitwise_free(scene):
    """The counters ride the loops' carries: the frame is bit for bit the
    same with and without them."""
    _, ts, _, tt = scene
    _, tc = _cameras(ts)
    plain = tr.render_depth(ts, tc, corner_table=tt, **SHIPPED)
    result, stats = tr.render_depth(ts, tc, corner_table=tt,
                                    with_stats=True, **SHIPPED)
    for a, b in zip(plain, result):
        assert torch.equal(a, b)
    assert stats["fine_tail_iters"].dtype == torch.int32
    assert tuple(stats["fine_tail_iters"].shape) == (32,)


@pytest.mark.parametrize("head,table", [(0, True), (4, True), (0, False)])
def test_sparse_final_sample_equals_dense_resample(scene, head, table):
    """The sparse final sample equals sampling the field densely at the
    returned points, bit for bit: converged rays reuse the march's sample
    of the same position, rays outside the grid read inf, the rest are
    sampled (wide camera: some rays miss the grid)."""
    _, ts, _, tt = scene
    _, tc = _cameras(ts, 64, 48, focal=24.0)
    ct = tt if table else None
    res, st = tr.render_depth(
        ts, tc, num_steps=48, corner_table=ct, early_exit=True,
        coarse_factor=8, head_steps=head, tail_chunks=8, cone_steps=24,
        cone_tail_chunks=4, with_stats=True)
    if ct is not None:
        q = tq.estimate_location_distance_fast(ts, ct, res.points)
    else:
        q = tq.estimate_location_distance(ts, res.points)
    dense = torch.where(q.valid, q.value, torch.tensor(float("inf")))
    assert torch.equal(res.distance, dense)
    n_rays = 64 * 48
    assert 0 <= int(st["final_sample_rows"]) <= n_rays
    if head == 0:
        # The block tail engages (cone-slowness key): the final sample is
        # sparse.
        assert st["final_sort_blocks"] > 0
        assert int(st["final_sample_rows"]) < n_rays
    else:
        assert "final_sort_blocks" not in st


@pytest.mark.parametrize("batch", [None, 3])
def test_block_relayout_round_trip(batch):
    """to_blocks lays each factor x factor block out contiguously, as the
    JAX package's block_relayout does, and from_blocks inverts it."""
    h, w, f = 24, 40, 8
    shape = (h, w, 3) if batch is None else (batch, h, w, 3)
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    to_b, from_b = tr.block_relayout(h, w, f, batch=batch)
    jto, _ = jr.block_relayout(h, w, f, batch=batch)
    blocks = to_b(torch.from_numpy(x))
    np.testing.assert_array_equal(blocks.numpy(), np.asarray(jto(x)))
    assert torch.equal(from_b(blocks), torch.from_numpy(x))
    first = x[:f, :f] if batch is None else x[0, :f, :f]
    np.testing.assert_array_equal(blocks[:f * f].numpy(),
                                  first.reshape(f * f, 3))


@pytest.mark.parametrize("table", [False, True])
def test_cone_started_fixed_march_gradients_match_jax(scene, table):
    """d mean(depth) / d distances and / d pose through the fixed march
    started at the cone prepass's (detached) depths, against jax.grad."""
    js, ts, _, _ = scene
    jc, tc = _cameras(js, 24, 16, focal=22.0)

    def jloss(d, pose):
        s = js.replace(distances=d)
        cam = dataclasses.replace(jc, pose=pose)
        t = jq.build_corner_table(s) if table else None
        return jnp.mean(jr.render_depth(s, cam, num_steps=24,
                                        corner_table=t,
                                        coarse_factor=4).depth)

    jg_d, jg_p = jax.jit(jax.grad(jloss, argnums=(0, 1)))(js.distances,
                                                          jc.pose)
    d = ts.distances.clone().requires_grad_(True)
    pose = tc.pose.clone().requires_grad_(True)
    s = ts.replace(distances=d)
    cam = dataclasses.replace(tc, pose=pose)
    t = tq.build_corner_table(s) if table else None
    torch.mean(tr.render_depth(s, cam, num_steps=24, corner_table=t,
                               coarse_factor=4).depth).backward()
    assert float(torch.abs(d.grad).sum()) > 0.0
    assert bool(torch.isfinite(d.grad).all())
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg_d),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(pose.grad.numpy(), np.asarray(jg_p),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


def test_cone_prepass_scan_path_matches_jax(scene):
    """The cone prepass with the differentiable fixed march (no early
    exit), under the cone contract against the JAX package's."""
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    base = _numpy(jr.render_depth(js, jc, num_steps=128, corner_table=jt))
    jres = _numpy(jr.render_depth(js, jc, num_steps=128, corner_table=jt,
                                  coarse_factor=4))
    got = _numpy(tr.render_depth(ts, tc, num_steps=128, corner_table=tt,
                                 coarse_factor=4))
    _check_cone_equiv(base, got, js.resolution)
    _check_cone_equiv(jres, got, js.resolution)


def test_schedule_option_errors(scene):
    _, ts, _, tt = scene
    _, tc = _cameras(ts)
    with pytest.raises(ValueError, match="coarse_factor"):
        tr.render_depth(ts, tc, corner_table=tt, coarse_factor=7)
    with pytest.raises(ValueError, match="must divide"):
        tr.render_depth(ts, tc, corner_table=tt, early_exit=True,
                        coarse_factor=8, head_steps=0, cone_refine=3)
    with pytest.raises(ValueError, match="smaller than"):
        tr.render_depth(ts, tc, corner_table=tt, early_exit=True,
                        coarse_factor=4, head_steps=0, cone_refine=4)
