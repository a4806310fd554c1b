"""The port's pointcloud carve and fusion filter against the JAX package:
the voxel walk, the column carve (every run axis, split, rows and diff,
with and without a step budget), the filter and ``voxelize_pointclouds``
on the two-camera oracle, bit for bit on the same numpy inputs.

The JAX package runs op by op here (``jax.disable_jit()``): compiled XLA
CPU code contracts ``a * b + c`` into one fused multiply-add, while the
port, like the JAX package run op by op, rounds each operation. Where two
crossing times lie within a rounding of each other the two pick different
voxels, so the JAX package's own compiled and op-by-op walks differ on the
two-camera oracle (both pass it).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_voxelize import (check_empty_voxelization, check_voxelization,
                           make_scene)
from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core import transforms as jtransforms
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.kernels import carve
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv


def _rotz(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], np.float32)


def _tspec(jspec):
    return GridSpec(jspec.counts, jspec.resolution)


def _tcloud(cloud):
    return interop.pointcloud_from_numpy(
        np.asarray(cloud.points), np.asarray(cloud.origin_transform),
        np.asarray(cloud.max_range), device="cpu")


def _tmat(m):
    return torch.from_numpy(np.array(m, np.float32))


def _eager(fn, *args, **kwargs):
    with jax.disable_jit():
        out = fn(*args, **kwargs)
    return jax.tree_util.tree_map(np.asarray, out)


def _assert_grids(ref, got):
    np.testing.assert_array_equal(got.seen_free.numpy(),
                                  np.asarray(ref.seen_free))
    np.testing.assert_array_equal(got.seen_filled.numpy(),
                                  np.asarray(ref.seen_filled))


def _scene_inside():
    """Camera inside a 20x24x28 grid, omnidirectional rays, some ending
    beyond the grid."""
    rng = np.random.default_rng(42)
    spec = JGridSpec.from_voxel_counts(0.05, (20, 24, 28))
    o = rng.uniform(0.2, 0.9, 3)
    pts = rng.uniform(-0.3, 1.6, (600, 3))
    cloud = jv.PointCloud.create(
        (pts - o).astype(np.float32),
        np.asarray(jtransforms.isometry_from_translation(o)), max_range=3.0)
    return spec, np.eye(4, dtype=np.float32), cloud


def _scene_long():
    """Camera below a 6x6x90 column looking up through it: walks of 90 to
    100 voxels, so budgets of 5 and 64 steps cut them and 100 (rounded to
    128) does not."""
    rng = np.random.default_rng(5)
    spec = JGridSpec.from_voxel_counts(0.05, (6, 6, 90))
    pts = np.stack([rng.uniform(-0.2, 0.2, 400), rng.uniform(-0.2, 0.2, 400),
                    rng.uniform(4.6, 5.0, 400)], -1).astype(np.float32)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.15, 0.15, -0.1)
    return spec, np.eye(4, dtype=np.float32), jv.PointCloud.create(pts, pose)


def _scene_outside():
    """Rotated camera outside a translated 25^3 grid; NaN points, 1e9 and
    FLT_MAX sentinels, clipped rays, final voxels beyond the grid."""
    rng = np.random.default_rng(3)
    spec = JGridSpec.from_voxel_counts(0.04, (25, 25, 25))
    origin = np.asarray(jtransforms.isometry_from_translation(
        (0.2, -0.1, 0.05)))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = _rotz(0.4)
    pose[:3, 3] = (-0.4, 0.5, 0.5)
    pts = rng.uniform(-0.2, 1.8, (600, 3)).astype(np.float32)
    pts[:4] = np.nan
    pts[4, 0] = np.inf
    pts[5:8] = (1e9, 2e9, -1e9)
    pts[8] = (3.4e38, 1e-6, 2.0)
    pts[9] = (0.0, 0.0, -3.4e38)
    cloud = jv.PointCloud.create(pts, pose, max_range=1.1)
    return spec, origin, cloud


SCENES = {"inside": _scene_inside, "long": _scene_long,
          "outside": _scene_outside}


@pytest.fixture(scope="module")
def walk_refs():
    """The JAX package's walk, op by op, per (scene, max_steps)."""
    cache = {}

    def get(name, max_steps):
        key = (name, max_steps)
        if key not in cache:
            spec, origin, cloud = SCENES[name]()
            cache[key] = _eager(jv.raycast_pointcloud, spec, origin, cloud,
                                max_steps=max_steps)
        return cache[key]

    return get


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("max_steps,ray_chunk", [
    (None, 16384), (None, 256), (5, 16384), (64, 16384), (100, 16384)])
def test_walk_matches_jax(walk_refs, scene, max_steps, ray_chunk):
    """raycast_pointcloud, bitwise: origins inside and outside the grid,
    clipped range, NaN and huge sentinels, step budgets below, at and
    above a segment, and a ray chunk that splits the cloud."""
    spec, origin, cloud = SCENES[scene]()
    got = tv.raycast_pointcloud(_tspec(spec), _tmat(origin), _tcloud(cloud),
                                max_steps=max_steps, ray_chunk=ray_chunk)
    _assert_grids(walk_refs(scene, max_steps), got)


def test_budget_truncates_and_rounds_to_segments(walk_refs):
    """The long scene's walks exceed a 64-step budget, so 5 and 64 carve
    less than the default, 5 is rounded up to 64, and 100 to 128."""
    full = walk_refs("long", None).seen_free
    assert walk_refs("long", 5).seen_free.sum() < full.sum()
    np.testing.assert_array_equal(walk_refs("long", 5).seen_free,
                                  walk_refs("long", 64).seen_free)
    np.testing.assert_array_equal(walk_refs("long", 100).seen_free, full)


@pytest.mark.parametrize("scene", sorted(SCENES))
@pytest.mark.parametrize("accumulate", ["rows", "diff"])
@pytest.mark.parametrize("run_axis", [0, 1, 2, "split"])
def test_columns_match_jax(walk_refs, scene, accumulate, run_axis):
    """raycast_pointcloud_columns against the JAX package's walk, bitwise,
    for every run axis and both accumulators, and on the outside scene
    (every special ray) against the JAX package's columns too; the port's
    ray chunk of 256 sorts and splits the cloud."""
    spec, origin, cloud = SCENES[scene]()
    got = tv.raycast_pointcloud_columns(
        _tspec(spec), _tmat(origin), _tcloud(cloud), run_axis=run_axis,
        accumulate=accumulate, ray_chunk=256)
    _assert_grids(walk_refs(scene, None), got)
    if scene == "outside":
        _assert_grids(_eager(jv.raycast_pointcloud_columns, spec, origin,
                             cloud, run_axis=run_axis,
                             accumulate=accumulate), got)


@pytest.mark.parametrize("max_steps", [5, 64, 100])
@pytest.mark.parametrize("run_axis", [0, 1, 2, "split"])
def test_columns_with_max_steps_match_jax(walk_refs, max_steps, run_axis):
    """A step budget truncates the column runs at the walk's voxel."""
    spec, origin, cloud = SCENES["long"]()
    got = tv.raycast_pointcloud_columns(_tspec(spec), _tmat(origin),
                                        _tcloud(cloud), max_steps=max_steps,
                                        run_axis=run_axis)
    _assert_grids(walk_refs("long", max_steps), got)


def test_columns_max_steps_with_diff_raises():
    spec, origin, cloud = SCENES["inside"]()
    with pytest.raises(ValueError, match="max_steps"):
        jv.raycast_pointcloud_columns(spec, origin, cloud, max_steps=5,
                                      accumulate="diff")
    with pytest.raises(ValueError, match="max_steps"):
        tv.raycast_pointcloud_columns(_tspec(spec), _tmat(origin),
                                      _tcloud(cloud), max_steps=5,
                                      accumulate="diff")
    with pytest.raises(ValueError, match="Unknown run_axis"):
        tv.raycast_pointcloud_columns(_tspec(spec), _tmat(origin),
                                      _tcloud(cloud), run_axis="bogus")
    with pytest.raises(ValueError, match="Unknown accumulate"):
        tv.raycast_pointcloud_columns(_tspec(spec), _tmat(origin),
                                      _tcloud(cloud), accumulate="bogus")


def test_ray_setup_matches_jax():
    """The kernel's per-ray inputs equal the JAX package's walk setup
    (start and final voxels, safe deltas, hit, endpoint), bitwise; the
    walks above hold t0."""
    spec, origin, cloud = SCENES["outside"]()
    with jax.disable_jit():
        X_GC = jtransforms.invert_isometry(jnp.asarray(origin)) \
            @ cloud.origin_transform
        (p_start, start, p_final, final, ray, hit,
         clipped) = jv._prepare_rays(spec, X_GC, cloud.points,
                                     cloud.max_range)
        _, _, end_flat, end_filled = jv._ray_visits(
            spec, p_start, start, p_final, final, ray, hit, clipped)
        delta = jnp.where(ray != 0.0, jnp.abs(jnp.float32(spec.resolution)
                                              / ray), jnp.inf)
        dt = jnp.where(jnp.isfinite(delta), delta, 0.0)
    got = tv.ray_setup(_tspec(spec), _tmat(origin), _tcloud(cloud))
    h = np.asarray(hit)
    np.testing.assert_array_equal(got.hit.numpy(), h)
    # Rays that are not walked may carry any indices (a float to int
    # conversion of NaN differs between XLA and PyTorch).
    np.testing.assert_array_equal(got.start.numpy()[h],
                                  np.asarray(start)[h])
    np.testing.assert_array_equal(got.final.numpy()[h],
                                  np.asarray(final)[h])
    np.testing.assert_array_equal(got.dt.numpy()[h], np.asarray(dt)[h])
    np.testing.assert_array_equal(got.end_flat.numpy(), np.asarray(end_flat))
    np.testing.assert_array_equal(got.end_filled.numpy(),
                                  np.asarray(end_filled))
    assert bool(h.any()) and not bool(h[:5].any())


def test_sentinel_points_carve_toward_the_point():
    """Huge finite sentinels with max_range = inf carve toward the point
    and mark nothing filled (the far-endpoint clamp), as in the JAX
    package; NaN points mark nothing."""
    spec = JGridSpec.from_voxel_counts(1.0, (8, 8, 8))
    for cam_z, want_z in [(4.5, [0, 1, 2, 3, 4]), (0.5, [0])]:
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = (4.5, 4.5, cam_z)
        pts = np.array([[0.0, 0.0, -1e10], [0.0, 1e-6, -3.4e38],
                        [np.nan, 0.0, 0.0]], np.float32)
        cloud = jv.PointCloud.create(pts, pose)
        ref = _eager(jv.raycast_pointcloud, spec, np.eye(4), cloud)
        for got in (tv.raycast_pointcloud(_tspec(spec), _tmat(np.eye(4)),
                                          _tcloud(cloud)),
                    tv.raycast_pointcloud_columns(
                        _tspec(spec), _tmat(np.eye(4)), _tcloud(cloud))):
            _assert_grids(ref, got)
            marked_z = sorted(
                np.argwhere(got.seen_free.numpy() > 0)[:, 2].tolist())
            assert marked_z == want_z
            assert int(got.seen_filled.sum()) == 0


def test_single_point_rays():
    """raycast_single_point: an axis-aligned ray, a ray from outside the
    grid, a miss, and a range clip (the JAX package's expectations)."""
    spec = GridSpec.from_voxel_counts(1.0, (8, 1, 1))
    eye = torch.eye(4)
    g = tv.raycast_single_point(spec, eye, (0.5, 0.5, 0.5), (6.5, 0.5, 0.5),
                                device="cpu")
    assert g.seen_free[:, 0, 0].tolist() == [1, 1, 1, 1, 1, 1, 0, 0]
    assert g.seen_filled[:, 0, 0].tolist() == [0, 0, 0, 0, 0, 0, 1, 0]
    g = tv.raycast_single_point(spec, eye, (0.5, 0.5, 0.5), (6.5, 0.5, 0.5),
                                max_range=3.0, device="cpu")
    assert int(g.seen_filled.sum()) == 0 and int(g.seen_free[3, 0, 0]) == 1
    spec4 = GridSpec.from_voxel_counts(1.0, (4, 4, 4))
    g = tv.raycast_single_point(spec4, eye, (-3.5, 2.5, 2.5),
                                (2.5, 2.5, 2.5), device="cpu")
    assert g.seen_free[:, 2, 2].tolist() == [1, 1, 0, 0]
    assert g.seen_filled[:, 2, 2].tolist() == [0, 0, 1, 0]
    g = tv.raycast_single_point(spec4, eye, (-3.5, 10.0, 2.5),
                                (2.5, 10.0, 2.5), device="cpu")
    assert int(g.seen_free.sum()) == 0 and int(g.seen_filled.sum()) == 0


def test_count_invariants_match_jax():
    """voxel_raycasting_test.cpp's invariants on random single rays (a
    voxel sees a ray at most once, never both free and filled), each equal
    to the JAX package's ray."""
    spec = JGridSpec.from_voxel_counts(0.125, (40, 40, 40))
    rng = np.random.default_rng(42)
    eye = np.eye(4, dtype=np.float32)
    origins = rng.uniform(-2.0, 7.0, size=(3, 3))
    targets = rng.uniform(-2.0, 7.0, size=(3, 3))
    for origin, target in zip(origins, targets):
        ref = _eager(jv.raycast_single_point, spec, eye, origin, target,
                     max_range=10.0)
        got = tv.raycast_single_point(_tspec(spec), _tmat(eye), origin,
                                      target, max_range=10.0, device="cpu")
        _assert_grids(ref, got)
        free, filled = got.seen_free, got.seen_filled
        assert int(free.max()) <= 1 and int(filled.max()) <= 1
        assert not bool(((free > 0) & (filled > 0)).any())


def test_empty_cloud_and_empty_list():
    env, _ = make_scene()
    spec = _tspec(env.spec)
    empty = tv.PointCloud.create(np.zeros((0, 3), np.float32), device="cpu")
    for fn in (tv.raycast_pointcloud, tv.raycast_pointcloud_columns):
        g = fn(spec, torch.eye(4), empty)
        assert g.seen_free.shape == spec.counts
        assert int(g.seen_free.abs().sum() + g.seen_filled.abs().sum()) == 0
    tenv = interop.occupancy_map_from_numpy(
        spec, np.asarray(env.occupancy), np.asarray(env.origin_transform),
        env.frame, device="cpu")
    out = tv.voxelize_pointclouds(tenv, tv.FilterOptions(1.0, 1, 1), [])
    check_empty_voxelization(out.occupancy.numpy())


@pytest.fixture(scope="module")
def oracle():
    """The two-camera oracle scene and the JAX package's fused occupancy,
    op by op."""
    env, clouds = make_scene()
    options = jv.FilterOptions(1.0, 1, 1)
    ref = _eager(jv.voxelize_pointclouds, env, options, clouds)
    return env, clouds, ref


def test_voxelize_pointclouds_oracle_matches_jax(oracle):
    """The reference oracle through the port's voxelize_pointclouds, equal
    to the JAX package's occupancy, with the runtime split filled."""
    env, clouds, ref = oracle
    tenv = interop.occupancy_map_from_numpy(
        _tspec(env.spec), np.asarray(env.occupancy),
        np.asarray(env.origin_transform), env.frame, device="cpu")
    runtimes = []
    out = tv.voxelize_pointclouds(tenv, tv.FilterOptions(1.0, 1, 1),
                                  [_tcloud(c) for c in clouds],
                                  runtime_log_fn=runtimes.append)
    check_voxelization(out.occupancy.numpy())
    np.testing.assert_array_equal(out.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    assert len(runtimes) == 1 and min(runtimes[0]) >= 0.0


def test_oracle_columns_by_policy(oracle):
    """The oracle's clouds through the column carve along pick_run_axis's
    and dominant_ray_axis's choices (equal to the JAX package's policies)
    give the walk's grids and the oracle's occupancy."""
    env, clouds, ref = oracle
    spec, G = _tspec(env.spec), _tmat(env.origin_transform)
    frees, filleds = [], []
    for c in clouds:
        tc = _tcloud(c)
        axis = tv.pick_run_axis(tc, G)
        assert axis == jv.pick_run_axis(c, env.origin_transform)
        assert tv.dominant_ray_axis(tc, G) == jv.dominant_ray_axis(
            c, env.origin_transform)
        walk = tv.raycast_pointcloud(spec, G, tc)
        cols = tv.raycast_pointcloud_columns(spec, G, tc, run_axis=axis)
        _assert_grids(tv.TrackingGrid(walk.seen_free.numpy(),
                                      walk.seen_filled.numpy()), cols)
        frees.append(cols.seen_free)
        filleds.append(cols.seen_filled)
    occ = tv.combine_and_filter(tv.FilterOptions(1.0, 1, 1),
                                torch.stack(frees), torch.stack(filleds),
                                torch.from_numpy(np.array(env.occupancy)))
    np.testing.assert_array_equal(occ.numpy(), np.asarray(ref.occupancy))


@pytest.mark.parametrize("options", [(1.0, 1, 1), (0.5, 2, 1), (0.8, 1, 2),
                                     (0.3, 3, 3)])
def test_filter_matches_jax(options):
    """counts_seen_as and combine_and_filter on random counter grids and a
    random static occupancy, bitwise."""
    rng = np.random.default_rng(sum(int(10 * o) for o in options))
    free = rng.integers(0, 5, (3, 6, 7, 8)).astype(np.int32)
    filled = rng.integers(0, 5, (3, 6, 7, 8)).astype(np.int32)
    occ = rng.choice(np.array([0.0, 0.5, 1.0, 0.25, 0.75], np.float32),
                     (6, 7, 8))
    jo, to = jv.FilterOptions(*options), tv.FilterOptions(*options)
    np.testing.assert_array_equal(
        tv.counts_seen_as(to, torch.from_numpy(free),
                          torch.from_numpy(filled)).numpy(),
        np.asarray(jv.counts_seen_as(jo, free, filled)))
    np.testing.assert_array_equal(
        tv.combine_and_filter(to, torch.from_numpy(free),
                              torch.from_numpy(filled),
                              torch.from_numpy(occ)).numpy(),
        np.asarray(jv.combine_and_filter(jo, free, filled, occ)))


def test_filter_options_validation():
    for bad in [(0.0, 1, 1), (1.5, 1, 1), (1.0, 0, 1), (1.0, 1, 0)]:
        with pytest.raises(ValueError):
            tv.FilterOptions(*bad).validate()
    assert tv.FilterOptions().validate() == tv.FilterOptions(1.0, 1, 1)


def test_kernel_raises_off_the_card():
    """The kernel's wrapper and the walk's kernel backend refuse CPU
    tensors: nothing falls back to the plain walk."""
    spec, origin, cloud = SCENES["inside"]()
    tspec, tcloud = _tspec(spec), _tcloud(cloud)
    with pytest.raises(ValueError, match="CUDA"):
        tv.raycast_pointcloud(tspec, _tmat(origin), tcloud, backend="cuda")
    setup = tv.ray_setup(tspec, _tmat(origin), tcloud)
    grid = torch.zeros(tspec.num_total, dtype=torch.int32)
    before = carve.launches
    with pytest.raises(ValueError, match="CUDA"):
        carve.carve_kernel(tspec.counts, setup, 64, grid, grid.clone())
    assert carve.launches == before
    with pytest.raises(ValueError, match="Unknown carve backend"):
        tv.raycast_pointcloud(tspec, _tmat(origin), tcloud, backend="bogus")
    non_uniform = GridSpec.from_voxel_sizes((0.1, 0.2, 0.1), (4, 4, 4))
    with pytest.raises(ValueError, match="uniform"):
        tv.raycast_pointcloud(non_uniform, _tmat(origin), tcloud)


def test_count_visits_counts_the_walk():
    """count_visits (the kernel's bound) equals the free marks of the walk
    less the clipped endpoints."""
    spec, origin, cloud = SCENES["outside"]()
    tspec = _tspec(spec)
    setup = tv.ray_setup(tspec, _tmat(origin), _tcloud(cloud))
    n_steps = carve.segment_steps(sum(tspec.counts) + 2)
    grid = tv.raycast_pointcloud(tspec, _tmat(origin), _tcloud(cloud))
    clipped_ends = int(((setup.end_flat >= 0) & ~setup.end_filled).sum())
    assert carve.count_visits(tspec.counts, setup, n_steps) == \
        int(grid.seen_free.sum()) - clipped_ends


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_walk():
    """On the card: the carve kernel (the tiled one, which
    raycast_pointcloud launches) against the plain walk and the plain
    column carve, bitwise, on both scenes and every step budget, and the
    card's setup against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for name, scene in SCENES.items():
        spec, origin, cloud = scene()
        tspec = _tspec(spec)
        cpu = _tcloud(cloud)
        dev = interop.pointcloud_from_numpy(
            np.asarray(cloud.points), np.asarray(cloud.origin_transform),
            np.asarray(cloud.max_range), device="cuda")
        for max_steps in (None, 5, 64, 100):
            before = carve.launches_tiled
            got = tv.raycast_pointcloud(tspec, _tmat(origin).cuda(), dev,
                                        max_steps=max_steps)
            torch.cuda.synchronize()
            assert carve.launches_tiled == before + 1
            plain = tv.raycast_pointcloud(tspec, _tmat(origin).cuda(), dev,
                                          max_steps=max_steps,
                                          backend="plain")
            host = tv.raycast_pointcloud(tspec, _tmat(origin), cpu,
                                         max_steps=max_steps)
            cols = tv.raycast_pointcloud_columns(
                tspec, _tmat(origin).cuda(), dev, max_steps=max_steps,
                run_axis="split")
            for ref in (plain, host, cols):
                assert torch.equal(got.seen_free.cpu(), ref.seen_free.cpu())
                assert torch.equal(got.seen_filled.cpu(),
                                   ref.seen_filled.cpu())
