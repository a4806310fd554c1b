"""The port's transform products against the JAX package, bit for bit.

XLA's CPU dot forms each element as a fused multiply-add chain in ``k``
order, jitted and op by op alike; the port's ``core/transforms.matmul``
reproduces it from exact float64 operations. These tests hold
``invert_isometry`` and ``compose`` bitwise against the JAX package on
random rotated isometries, and the carves, the native voxelizer and the
queries built on them under rotated grid origins (fault F1: before the
exact product, a rotated origin flipped ``seen_free`` voxels). The JAX
carve runs op by op (``jax.disable_jit()``), as in
tests/test_torch_voxelize.py.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu import native as jnative
from voxelized_geometry_tools_tpu.core import transforms as jt
from voxelized_geometry_tools_tpu.core.maps import (
    SignedDistanceField as JSignedDistanceField)
from voxelized_geometry_tools_tpu.ops import backends as jb
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import GridSpec, interop, native
from voxelized_geometry_tools_tpu_torch.core import transforms as tt
from voxelized_geometry_tools_tpu_torch.ops import backends as tb
from voxelized_geometry_tools_tpu_torch.ops import sdf_query as tq
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

# Gradients of the exact product are the matmul's: float32 sums of the
# same three or four terms, in another order than jax.grad's.
GRAD_RTOL = 1e-6

F1_RES = 0.02


def quat_rotation(q):
    """Rotation matrix of the unit quaternion ``q / |q|`` (w, x, y, z)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def random_isometry(rng, spread=2.0):
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = quat_rotation(rng.normal(size=4))
    m[:3, 3] = rng.uniform(-spread, spread, 3)
    return m


def f1_scene(n, n_points, seed):
    """ROADMAP fault F1's input: an ``n^3`` grid at 0.02 m whose origin is
    rotated about all three axes, and one camera inside it with
    ``n_points`` rays. Draws, from ``default_rng(seed)``: the origin's
    quaternion and translation, the camera's grid-frame position and
    quaternion, then the float32 points in [-2, 2)^3 (max range 5 m)."""
    rng = np.random.default_rng(seed)
    origin = np.eye(4, dtype=np.float32)
    origin[:3, :3] = quat_rotation(rng.normal(size=4))
    origin[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    cam_grid = np.full(3, n) * F1_RES * rng.uniform(0.3, 0.7, 3)
    cam_rot = quat_rotation(rng.normal(size=4))
    pts = rng.uniform(-2, 2, (n_points, 3)).astype(np.float32)
    o = origin.astype(np.float64)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = o[:3, :3] @ cam_rot
    pose[:3, 3] = o[:3, :3] @ cam_grid + o[:3, 3]
    spec = JGridSpec.from_voxel_counts(F1_RES, (n,) * 3)
    return spec, origin, jv.PointCloud.create(pts, pose, max_range=5.0)


def _tcloud(cloud):
    return interop.pointcloud_from_numpy(
        np.asarray(cloud.points), np.asarray(cloud.origin_transform),
        np.asarray(cloud.max_range), device="cpu")


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_invert_isometry_matches_jax(seed):
    """100 random rotated isometries a seed: the port's inverse equals the
    JAX package's bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        m = random_isometry(rng)
        ref = np.asarray(jt.invert_isometry(jnp.asarray(m)))
        got = tt.invert_isometry(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("seed", [10, 11, 12, 13])
def test_compose_matches_jax(seed):
    """``X_GC = inverse(X_WG) @ X_WC`` as the carve forms it, and a plain
    product of two isometries, on 100 random pairs a seed, bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(100):
        a, b = random_isometry(rng), random_isometry(rng)
        ref = np.asarray(jt.invert_isometry(jnp.asarray(a)) @ jnp.asarray(b))
        got = tt.compose(tt.invert_isometry(torch.from_numpy(a)),
                         torch.from_numpy(b))
        np.testing.assert_array_equal(got.numpy(), ref)
        np.testing.assert_array_equal(
            tt.compose(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(jt.compose(jnp.asarray(a), jnp.asarray(b))))


def test_matmul_takes_special_values():
    """Infinities, NaNs, signed zeros and subnormal products go through
    the chain as through XLA's dot."""
    a = np.array([[np.inf, 1.0, 0.0], [-0.0, 1e-30, 3.0],
                  [np.nan, 2.0, 1.0], [1.0, -1.0, 1e-20]], np.float32)
    b = np.array([[1.0, 0.0], [-0.0, 1e-10], [2.0, -np.inf]], np.float32)
    ref = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
    got = tt.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert np.array_equal(np.signbit(got), np.signbit(ref))


def test_exact_product_gradients_match_jax():
    """The product's backward is the matmul's gradient: ``jax.grad`` of a
    loss through ``invert_isometry`` and ``compose``."""
    rng = np.random.default_rng(7)
    a, b = random_isometry(rng), random_isometry(rng)
    w = rng.normal(size=(4, 4)).astype(np.float32)

    def jloss(a, b):
        return jnp.sum(jnp.sin(jt.invert_isometry(a) @ b) * w)

    ga, gb = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(a), jnp.asarray(b))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb_ = torch.from_numpy(b).requires_grad_(True)
    torch.sum(torch.sin(tt.compose(tt.invert_isometry(ta), tb_))
              * torch.from_numpy(w)).backward()
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga),
                               rtol=GRAD_RTOL, atol=1e-6)
    np.testing.assert_allclose(tb_.grad.numpy(), np.asarray(gb),
                               rtol=GRAD_RTOL, atol=1e-6)


@pytest.fixture(scope="module")
def f1_refs():
    """The JAX package's op-by-op walk on each F1 input, by seed."""
    cache = {}

    def get(seed):
        if seed not in cache:
            spec, origin, cloud = f1_scene(64, 20_000, seed)
            with jax.disable_jit():
                ref = jv.raycast_pointcloud(spec, origin, cloud)
            cache[seed] = (spec, origin, cloud,
                           jax.tree_util.tree_map(np.asarray, ref))
        return cache[seed]

    return get


# Seeds 200 and 204 flip 16 and 14 seen_free voxels with products rounded
# term by term.
@pytest.mark.parametrize("seed", [200, 204])
@pytest.mark.parametrize("carve", ["walk", "columns"])
def test_rotated_origin_carve_matches_jax(f1_refs, seed, carve):
    """F1: a 64^3 grid under an origin rotated about all three axes, 20,000
    rays from a rotated camera inside it. The port's plain walk and its
    column carve (run axis 2) equal the JAX package's walk, bitwise."""
    spec, origin, cloud, ref = f1_refs(seed)
    tspec = GridSpec(spec.counts, spec.resolution)
    if carve == "walk":
        got = tv.raycast_pointcloud(tspec, torch.from_numpy(origin),
                                    _tcloud(cloud))
    else:
        got = tv.raycast_pointcloud_columns(tspec, torch.from_numpy(origin),
                                            _tcloud(cloud), run_axis=2)
    assert int(ref.seen_free.sum()) > 0 and int(ref.seen_filled.sum()) > 0
    np.testing.assert_array_equal(got.seen_free.numpy(), ref.seen_free)
    np.testing.assert_array_equal(got.seen_filled.numpy(), ref.seen_filled)


def test_rotated_origin_grid_frame_transform_matches_jax(f1_refs):
    """The carve's ``X_GC`` and its ray setup's grid-frame points against
    the JAX package's, bitwise."""
    spec, origin, cloud, _ = f1_refs(200)
    with jax.disable_jit():
        ref = np.asarray(jt.invert_isometry(jnp.asarray(origin))
                         @ cloud.origin_transform)
    got = tv._grid_frame_transform(torch.from_numpy(origin), _tcloud(cloud))
    np.testing.assert_array_equal(got.numpy(), ref)


def test_native_voxelizer_rotated_origin_matches_jax(f1_refs):
    """The native voxelizer under the rotated F1 origin (its inverse is the
    port's exact one) equals the JAX package's native voxelizer."""
    if not native.available() or not jnative.available():
        pytest.skip("no native toolchain")
    spec, origin, cloud, _ = f1_refs(200)
    from voxelized_geometry_tools_tpu import OccupancyMap as JOccupancyMap
    env = JOccupancyMap.create(spec, origin, "w", default_occupancy=0.5)
    ref = jb.NativeCpuPointCloudVoxelizer().voxelize_pointclouds(
        env, jv.FilterOptions(), [cloud])
    tenv = interop.occupancy_map_from_numpy(
        GridSpec(spec.counts, spec.resolution), np.asarray(env.occupancy),
        origin, "w", device="cpu")
    got = tb.NativeCpuPointCloudVoxelizer().voxelize_pointclouds(
        tenv, tv.FilterOptions(), [_tcloud(cloud)])
    occ = np.asarray(ref.occupancy)
    assert {0.0, 0.5, 1.0} <= set(np.unique(occ).tolist())
    np.testing.assert_array_equal(got.occupancy.numpy(), occ)


def test_rotated_origin_queries_match_jax():
    """Queries of a field under a rotated origin take the map's exact
    inverse: plain and table queries equal the JAX package's op-by-op
    queries bit for bit."""
    rng = np.random.default_rng(3)
    dist = rng.uniform(-0.3, 0.6, (12, 10, 14)).astype(np.float32)
    origin = random_isometry(rng, spread=0.5)
    jspec = JGridSpec.from_voxel_counts(0.05, dist.shape)
    js = JSignedDistanceField.create(jspec, jnp.asarray(dist), origin)
    ts = interop.sdf_from_numpy(GridSpec(jspec.counts, 0.05), dist, origin,
                                device="cpu")
    pts = (origin[:3, :3] @ rng.uniform(-0.1, 0.8, (3, 3000))
           + origin[:3, 3:]).T.astype(np.float32)
    with jax.disable_jit():
        ref_plain = jq.estimate_location_distance(js, jnp.asarray(pts))
        ref_fast = jq.estimate_location_distance_fast(
            js, jq.build_corner_table(js), jnp.asarray(pts))
    got_plain = tq.estimate_location_distance(ts, torch.from_numpy(pts))
    got_fast = tq.estimate_location_distance_fast(
        ts, tq.build_corner_table(ts), torch.from_numpy(pts))
    for ref, got in ((ref_plain, got_plain), (ref_fast, got_fast)):
        assert bool(np.asarray(ref.valid).any())
        np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
        np.testing.assert_array_equal(got.value.numpy(), np.asarray(ref.value))


def test_map_keeps_its_inverse():
    """A map forms its inverse once and forms it again after its transform
    changes in place; under autograd the inverse carries the gradient."""
    rng = np.random.default_rng(4)
    origin = torch.from_numpy(random_isometry(rng))
    ts = interop.sdf_from_numpy(GridSpec((4, 4, 4), 0.1),
                                np.zeros((4, 4, 4), np.float32),
                                origin.numpy(), device="cpu")
    first = ts.inverse_origin_transform()
    assert ts.inverse_origin_transform() is first
    ts.origin_transform[:3, 3] += 1.0
    again = ts.inverse_origin_transform()
    assert again is not first
    np.testing.assert_array_equal(
        again.numpy(), tt.invert_isometry(ts.origin_transform).numpy())
    pose = ts.origin_transform.clone().requires_grad_(True)
    moved = ts.replace(origin_transform=pose)
    moved.inverse_origin_transform().sum().backward()
    assert pose.grad is not None and bool(torch.isfinite(pose.grad).all())


@pytest.mark.cuda
def test_cuda_rotated_origin_carve_matches_cpu(f1_refs):
    """On the card: X_GC bitwise equal to the CPU's, and the tiled carve
    kernel's grids equal to the JAX package's walk, under F1's rotated
    origin."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spec, origin, cloud, ref = f1_refs(200)
    cpu = _tcloud(cloud)
    card = interop.pointcloud_from_numpy(
        np.asarray(cloud.points), np.asarray(cloud.origin_transform),
        np.asarray(cloud.max_range), device="cuda")
    origin_card = torch.from_numpy(origin).cuda()
    x_card = tv._grid_frame_transform(origin_card, card).cpu()
    x_cpu = tv._grid_frame_transform(torch.from_numpy(origin), cpu)
    assert torch.equal(x_card.view(torch.int32), x_cpu.view(torch.int32))
    got = tv.raycast_pointcloud(GridSpec(spec.counts, spec.resolution),
                                origin_card, card)
    np.testing.assert_array_equal(got.seen_free.cpu().numpy(), ref.seen_free)
    np.testing.assert_array_equal(got.seen_filled.cpu().numpy(),
                                  ref.seen_filled)
