"""The port's mip skip, over-relaxed and batched renders, soft silhouette
and render-to-cloud against the JAX package, on the sphere fixture of
tests/test_fast_render.py (40x40x24 at 0.05 m, bitwise equal fields from
each package's EDT).

Renders are held to ``check_render_contract`` of tests/test_torch_render.py
against the JAX package, and to the JAX package's own contracts against
the port's plain render (tests/test_fast_render.py: the mip skip's hits
equal with depths within 2 voxels; over-relaxation's flips only in the
grazer band with common depths within 2 thresholds). The batch is bitwise
equal to each view's own render on the same schedule. The mip table and
``depth_to_pointcloud`` (against the JAX package op by op) are bitwise.
"""

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

from test_torch_render import check_render_contract

# Soft silhouette: the same final samples through XLA's and PyTorch's
# sigmoid (an ulp apart), and final samples an ulp apart amplified by
# 1 / (softness * resolution).
OCCUPANCY_RTOL = 1e-6
OCCUPANCY_ATOL = 1e-6


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


def _cameras(sdf, w=48, h=36, focal=45.0, pose=None):
    if pose is None:
        sizes = np.asarray(sdf.spec.grid_sizes)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.5 * sizes[2]])
    jc = jr.PinholeCamera.create(pose, w, h, focal=focal)
    tc = interop.camera_from_numpy(np.asarray(jc.pose), jc.fx, jc.fy, jc.cx,
                                   jc.cy, w, h, device="cpu")
    return jc, tc


def _check_vs_jax(ref, got, resolution):
    check_render_contract(np.asarray(ref.hit), np.asarray(ref.depth),
                          np.asarray(ref.distance), got, resolution)


@pytest.mark.parametrize("factor", [4, 8, 3])
def test_mip_table_bitwise(scene, factor):
    """Factor 3 pads every axis with +inf blocks."""
    js, ts, _, _ = scene
    ref = jr.build_sdf_mip(js, factor)
    got = tr.build_sdf_mip(ts, factor)
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(ref.values))
    assert got.coarse_counts == ref.coarse_counts
    assert (got.factor, got.block_size) == (ref.factor, ref.block_size)


def test_mip_lower_bound_property(scene):
    """Every mip entry lower-bounds the corrected distance of every cell
    of its block (the whole grid, not a sample)."""
    _, ts, _, _ = scene
    for factor in (3, 4):
        mip = tr.build_sdf_mip(ts, factor)
        d = ts.distances
        half = 0.5 * ts.resolution
        corrected = torch.where(d >= 0.0, d - half, d + half)
        vals = mip.values.reshape(mip.coarse_counts)
        f = mip.factor
        lower = vals.repeat_interleave(f, 0).repeat_interleave(
            f, 1).repeat_interleave(f, 2)[:d.shape[0], :d.shape[1],
                                          :d.shape[2]]
        assert bool((lower <= corrected + 1e-6).all())


@pytest.mark.parametrize("factor", [4, 8])
def test_mip_skip_matches_plain_and_jax(scene, factor):
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    base = tr.render_depth(ts, tc, num_steps=64)
    fast = tr.render_depth(ts, tc, num_steps=64, corner_table=tt,
                           early_exit=True, mip=tr.build_sdf_mip(ts, factor))
    assert torch.equal(base.hit, fast.hit)
    m = base.hit
    np.testing.assert_allclose(fast.depth[m].numpy(), base.depth[m].numpy(),
                               atol=2 * ts.resolution)
    ref = jr.render_depth(js, jc, num_steps=64, corner_table=jt,
                          early_exit=True, mip=jr.build_sdf_mip(js, factor))
    _check_vs_jax(ref, fast, js.resolution)


@pytest.mark.parametrize("factor", [2, 4])
def test_mip_skip_advances(scene, factor):
    """Looking along +x, the sphere lies 11 voxels past the grid's face:
    the skip moves the starts (fewer gather rows), and the render keeps
    the plain render's hits and JAX's contract."""
    js, ts, jt, tt = scene
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]]
    pose[:3, 3] = (-1.0, 1.0, 0.6)
    jc, tc = _cameras(js, pose=pose)
    kw = dict(num_steps=64, early_exit=True, with_stats=True)
    fast, stats = tr.render_depth(ts, tc, corner_table=tt,
                                  mip=tr.build_sdf_mip(ts, factor), **kw)
    plain, plain_stats = tr.render_depth(ts, tc, corner_table=tt, **kw)
    assert tr.gather_rows_from_stats(stats) < tr.gather_rows_from_stats(
        plain_stats)
    assert torch.equal(fast.hit, plain.hit) and bool(fast.hit.any())
    ref = jr.render_depth(js, jc, num_steps=64, corner_table=jt,
                          early_exit=True, mip=jr.build_sdf_mip(js, factor))
    _check_vs_jax(ref, fast, js.resolution)


def test_mip_skip_on_block_schedule(scene):
    """The mip skip composes with the cone prepass and block-sorted tail."""
    js, ts, jt, tt = scene
    jc, tc = _cameras(js, 64, 48)
    sched = dict(num_steps=64, early_exit=True, coarse_factor=8,
                 head_steps=0, tail_chunks=8, cone_steps=32,
                 cone_tail_chunks=4)
    ref = jr.render_depth(js, jc, corner_table=jt,
                          mip=jr.build_sdf_mip(js, 4), **sched)
    got = tr.render_depth(ts, tc, corner_table=tt,
                          mip=tr.build_sdf_mip(ts, 4), **sched)
    _check_vs_jax(ref, got, js.resolution)


def _check_relaxed(base, rx, om, sdf):
    """tests/test_fast_render.py's relax contract."""
    thresh = 0.25 * sdf.resolution
    bh, rh = base.hit.numpy(), rx.hit.numpy()
    if (bh != rh).any():
        band = om * 0.2 * sdf.resolution
        dist = np.where(bh, base.distance.numpy(), rx.distance.numpy())
        assert not ((bh != rh) & ~(np.abs(dist - thresh) <= band)).any()
    m = bh & rh
    dd = np.abs(base.depth.numpy()[m] - rx.depth.numpy()[m])
    assert float(dd.max()) <= 2 * thresh + 1e-6


@pytest.mark.parametrize("om", [1.3, 1.9])
@pytest.mark.parametrize("table", [False, True])
def test_relax_matches_plain_and_jax(scene, om, table):
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    kw = dict(num_steps=64, early_exit=True)
    base = tr.render_depth(ts, tc, corner_table=tt if table else None, **kw)
    got = tr.render_depth(ts, tc, relax=om,
                          corner_table=tt if table else None, **kw)
    _check_relaxed(base, got, om, ts)
    ref = jr.render_depth(js, jc, relax=om,
                          corner_table=jt if table else None, **kw)
    _check_vs_jax(ref, got, js.resolution)


def test_relax_on_shipped_schedule(scene):
    """Cone prepass + block tail + sparse final sample, relaxed: each tail
    chunk starts its relaxed carries afresh, as the JAX package's."""
    js, ts, jt, tt = scene
    jc, tc = _cameras(js, 64, 48)
    sched = dict(num_steps=64, early_exit=True, coarse_factor=8,
                 head_steps=0, tail_chunks=8, cone_steps=32,
                 cone_tail_chunks=4)
    base = tr.render_depth(ts, tc, corner_table=tt, **sched)
    got, stats = tr.render_depth(ts, tc, corner_table=tt, relax=1.6,
                                 with_stats=True, **sched)
    _check_relaxed(base, got, 1.6, ts)
    ref, jstats = jr.render_depth(js, jc, corner_table=jt, relax=1.6,
                                  with_stats=True, **sched)
    _check_vs_jax(ref, got, js.resolution)
    np.testing.assert_array_equal(stats["fine_tail_iters"].numpy(),
                                  np.asarray(jstats["fine_tail_iters"]))


def test_relax_with_head_and_tail(scene):
    """A full-width relaxed head, then a sorted relaxed tail."""
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    kw = dict(num_steps=64, corner_table=None, early_exit=True,
              head_steps=4, tail_chunks=4, relax=1.5)
    _check_vs_jax(jr.render_depth(js, jc, **kw),
                  tr.render_depth(ts, tc, **kw), js.resolution)


def test_relax_needs_early_exit(scene):
    _, ts, _, tt = scene
    _, tc = _cameras(ts, 8, 8)
    with pytest.raises(ValueError, match="early_exit"):
        tr.render_depth(ts, tc, num_steps=4, corner_table=tt, relax=1.5)


def _rig(sdf, w=32, h=24, focal=30.0):
    sizes = np.asarray(sdf.spec.grid_sizes)
    jcs, tcs = [], []
    for dx, dz in [(0.0, 1.5), (0.3, 1.8), (-0.4, 1.2)]:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = sizes / 2.0 - np.array([dx, 0.0, dz * sizes[2]])
        jc, tc = _cameras(sdf, w, h, focal, pose)
        jcs.append(jc)
        tcs.append(tc)
    return jcs, tcs


@pytest.mark.parametrize("table", [False, True])
def test_batch_bitwise_per_view_and_matches_jax(scene, table):
    js, ts, jt, tt = scene
    jcs, tcs = _rig(js)
    kw = dict(num_steps=48, coarse_factor=4, tail_chunks=8)
    got = tr.render_depth_batch(ts, tr.PinholeCamera.stack(tcs),
                                corner_table=tt if table else None, **kw)
    assert tuple(got.depth.shape) == (3, 24, 32)
    ref = jr.render_depth_batch(
        js, jax.tree.map(lambda *x: jnp.stack(x), *jcs),
        corner_table=jt if table else None, **kw)
    for i, tc in enumerate(tcs):
        single = tr.render_depth(
            ts, tc, num_steps=48, corner_table=tt if table else None,
            early_exit=True, coarse_factor=4, head_steps=0, tail_chunks=8,
            cone_steps=32, cone_tail_chunks=8)
        assert torch.equal(got.depth[i], single.depth)
        assert torch.equal(got.hit[i], single.hit)
        _check_vs_jax(jr.RenderResult(*(x[i] for x in ref)),
                      tr.RenderResult(*(x[i] for x in got)), js.resolution)


def test_batch_camera_stack_and_checks(scene):
    _, ts, _, tt = scene
    _, tcs = _rig(ts)
    cam = tr.PinholeCamera.stack(tcs)
    assert tuple(cam.pose.shape) == (3, 4, 4) and tuple(cam.fx.shape) == (3,)
    assert torch.equal(cam.view(1).pose, tcs[1].pose)
    with pytest.raises(ValueError, match="image size"):
        tr.PinholeCamera.stack([tcs[0], _cameras(ts, 16, 8)[1]])
    with pytest.raises(ValueError, match="coarse_factor"):
        tr.render_depth_batch(ts, cam, num_steps=8, corner_table=tt,
                              coarse_factor=5)


def test_occupancy_image_matches_jax(scene):
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    for kw in (dict(), dict(corner_table=True, early_exit=True,
                            tail_chunks=1)):
        jkw = dict(kw, corner_table=jt) if kw else kw
        tkw = dict(kw, corner_table=tt) if kw else kw
        ref = np.asarray(jr.render_occupancy_image(js, jc, num_steps=64,
                                                   softness=2.0, **jkw))
        got = tr.render_occupancy_image(ts, tc, num_steps=64, softness=2.0,
                                        **tkw)
        assert got.dtype == torch.float32 and 0.0 < float(got.mean()) < 1.0
        np.testing.assert_allclose(got.numpy(), ref, rtol=OCCUPANCY_RTOL,
                                   atol=OCCUPANCY_ATOL)


def test_depth_to_pointcloud_bitwise_op_by_op(scene):
    """The same render result through both packages (JAX op by op, as the
    port rounds each operation): bitwise points, NaN where missed."""
    js, ts, jt, _ = scene
    c, s = np.cos(0.2), np.sin(0.2)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    pose[:3, 3] = np.asarray(js.spec.grid_sizes) / 2.0 - np.array(
        [0.2, 0.0, 1.4])
    jc, tc = _cameras(js, pose=pose)
    ref_render = jr.render_depth(js, jc, num_steps=64, corner_table=jt)
    with jax.disable_jit():
        ref = jr.depth_to_pointcloud(ref_render, jc, max_range=3.0)
    result = tr.RenderResult(*(torch.from_numpy(np.array(x))
                               for x in ref_render))
    got = tr.depth_to_pointcloud(result, tc, max_range=3.0)
    assert got.points.shape == (48 * 36, 3)
    np.testing.assert_array_equal(got.points.numpy(), np.asarray(ref.points))
    np.testing.assert_array_equal(got.origin_transform.numpy(),
                                  np.asarray(ref.origin_transform))
    assert float(got.max_range) == 3.0
    missed = ~result.hit.reshape(-1)
    assert missed.any() and torch.isnan(got.points[missed]).all()
    assert float(tr.depth_to_pointcloud(result, tc).max_range) == np.inf


def test_render_to_cloud_to_carve_loop(scene):
    """The cloud of a render, carved into a grid, marks voxels filled where
    the sphere's surface is (the loop render -> sensor model -> carve)."""
    js, ts, _, tt = scene
    _, tc = _cameras(ts)
    res = tr.render_depth(ts, tc, num_steps=64, corner_table=tt)
    cloud = tr.depth_to_pointcloud(res, tc)
    from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv
    grids = tv.raycast_pointcloud(ts.spec, ts.origin_transform, cloud)
    filled = grids.seen_filled > 0
    assert int(filled.sum()) > 100
    near = ts.distances[filled].abs() <= 2 * ts.resolution
    assert float(near.float().mean()) > 0.99


def test_interop_mip_round_trip(scene):
    js, ts, jt, tt = scene
    jm = jr.build_sdf_mip(js, 4)
    mip = interop.sdf_mip_from_numpy(np.asarray(jm.values), jm.coarse_counts,
                                     jm.factor, jm.block_size, device="cpu")
    assert torch.equal(mip.values, tr.build_sdf_mip(ts, 4).values)
    _, tc = _cameras(ts)
    a = tr.render_depth(ts, tc, num_steps=64, corner_table=tt,
                        early_exit=True, mip=mip)
    b = tr.render_depth(ts, tc, num_steps=64, corner_table=tt,
                        early_exit=True, mip=tr.build_sdf_mip(ts, 4))
    assert torch.equal(a.depth, b.depth)
    with pytest.raises(ValueError, match="blocks"):
        interop.sdf_mip_from_numpy(np.zeros(7), (2, 2, 2), 4, 0.2,
                                   device="cpu")


@pytest.mark.cuda
def test_cuda_mip_relax_batch_match_cpu(scene):
    """On the card: the mip table is the CPU's, the mip and relaxed
    renders are within check_render_contract of the CPU's with the same
    options, and the batch is bitwise its views' own renders."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ts, _, _ = scene
    card = ts.replace(distances=ts.distances.cuda(),
                      origin_transform=ts.origin_transform.cuda())
    table = tq.build_corner_table(card)
    _, tc = _cameras(ts)
    cam = tr.PinholeCamera.create(tc.pose, 48, 36, focal=45.0,
                                  device="cuda")
    assert torch.equal(tr.build_sdf_mip(card, 4).values.cpu(),
                       tr.build_sdf_mip(ts, 4).values)
    cpu_table = tq.build_corner_table(ts)
    for kw, card_kw in ((dict(mip=tr.build_sdf_mip(ts, 4)),
                         dict(mip=tr.build_sdf_mip(card, 4))),
                        (dict(relax=1.5), dict(relax=1.5))):
        ref = tr.render_depth(ts, tc, num_steps=64, corner_table=cpu_table,
                              early_exit=True, **kw)
        got = tr.render_depth(card, cam, num_steps=64, corner_table=table,
                              early_exit=True, **card_kw)
        got = tr.RenderResult(*(x.cpu() for x in got))
        check_render_contract(ref.hit.numpy(), ref.depth.numpy(),
                              ref.distance.numpy(), got, ts.resolution)
    _, tcs = _rig(ts)
    cams = [tr.PinholeCamera.create(c.pose, 32, 24, focal=30.0,
                                    device="cuda") for c in tcs]
    batch = tr.render_depth_batch(card, tr.PinholeCamera.stack(cams),
                                  num_steps=48, corner_table=table,
                                  coarse_factor=4, tail_chunks=8)
    for i, c in enumerate(cams):
        single = tr.render_depth(card, c, num_steps=48, corner_table=table,
                                 early_exit=True, coarse_factor=4,
                                 head_steps=0, tail_chunks=8, cone_steps=32,
                                 cone_tail_chunks=8)
        assert torch.equal(batch.depth[i], single.depth)


@pytest.fixture(scope="module")
def bench_sphere():
    """bench.py's sphere and camera at 64^3 (64x48, focal 52)."""
    n = 64
    ax = np.arange(n, dtype=np.float32)
    mask = ((ax[:, None, None] - n / 2) ** 2 + (ax[None, :, None] - n / 2) ** 2
            + (ax[None, None, :] - n / 2) ** 2) <= (n / 4) ** 2
    res = 5.12 / n
    js = jedt.extract_signed_distance_field(
        jnp.asarray(mask), JGridSpec.from_voxel_counts(res, mask.shape), None)
    ts = edt.extract_signed_distance_field(
        torch.from_numpy(mask), GridSpec.from_voxel_counts(res, mask.shape),
        None)
    sizes = np.asarray(js.spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    jc, tc = _cameras(js, 64, 48, 52.0, pose)
    return (js, ts, jq.build_corner_table(js), tq.build_corner_table(ts), jc,
            tc)


@pytest.mark.parametrize("case", ["mip4", "relax1.9", "relax1.6_schedule"])
def test_bench_sphere_grazer_exceptions_are_the_jax_packages(bench_sphere,
                                                             case):
    """On bench.py's sphere the mip skip loses tangent-grazer hits and the
    relaxed march moves grazers' depths past tests/test_fast_render.py's
    contracts (chip_smoke.py excepts them): the JAX package does the same,
    on the same pixels."""
    js, ts, jt, tt, jc, tc = bench_sphere
    kw = dict(num_steps=64, early_exit=True)
    if case == "mip4":
        jx = dict(mip=jr.build_sdf_mip(js, 4))
        tx = dict(mip=tr.build_sdf_mip(ts, 4))
        tol = 2 * ts.resolution
    else:
        om = 1.9 if case == "relax1.9" else 1.6
        jx = tx = dict(relax=om)
        tol = 0.5 * ts.resolution
        if case == "relax1.6_schedule":
            kw.update(coarse_factor=8, head_steps=0, tail_chunks=32,
                      cone_steps=32, cone_tail_chunks=8)
    jb, tb = (jr.render_depth(js, jc, corner_table=jt, **kw),
              tr.render_depth(ts, tc, corner_table=tt, **kw))
    jr_, tr_ = (jr.render_depth(js, jc, corner_table=jt, **kw, **jx),
                tr.render_depth(ts, tc, corner_table=tt, **kw, **tx))

    def exceptions(base, got):
        bh, gh = np.asarray(base.hit), np.asarray(got.hit)
        diff = np.abs(np.asarray(base.depth) - np.asarray(got.depth))
        return bh != gh, bh & gh & (diff > tol + 1e-6)

    jflip, jpast = exceptions(jb, jr_)
    tflip, tpast = exceptions(tb, tr_)
    assert (jflip | jpast).any()
    np.testing.assert_array_equal(tflip, jflip)
    np.testing.assert_array_equal(tpast, jpast)
    _check_vs_jax(jr_, tr_, js.resolution)
