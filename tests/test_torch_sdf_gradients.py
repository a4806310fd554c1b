"""The port's SDF gradients, projections and local-extrema map against the
JAX package, on the same fields and the same points from numpy seeds, and
ports of tests/test_sdf_query.py's gradient, projection and extrema tests.

The coarse gradient is a difference times a constant and the fine
gradient differences of trilinear estimates, both formed op by op in the
two packages: bitwise. The projection walks under the JAX package's
``lax.while_loop``, which XLA compiles and contracts into fused
multiply-adds, while the port rounds each operation: positions agree
within ``PROJECTION_ATOL``. The extrema map is integer pointer jumping
over the gradients' steps: bitwise.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core.maps import (
    SignedDistanceField as JSignedDistanceField)
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, SignedDistanceField
from voxelized_geometry_tools_tpu_torch.ops import edt, sdf_query as tq

# Fine gradients: test_torch_sdf_query.py's gradient tolerance (they are
# bitwise equal in fact, the test holds them to it).
FINE_ATOL = 1e-5
# Projected points after up to ~50 steps of 0.1 voxel: a few ulp of FMA
# contraction a step in the JAX package's compiled loop (measured 4.9e-6 m
# at 0.05 m voxels).
PROJECTION_ATOL = 2e-5


def _sphere_fields():
    xs, ys, zs = np.meshgrid(np.arange(40), np.arange(40), np.arange(24),
                             indexing="ij", sparse=True)
    mask = ((xs - 20) ** 2 + (ys - 20) ** 2 + (zs - 12) ** 2) <= 81
    js = jedt.extract_signed_distance_field(
        jnp.asarray(mask), JGridSpec.from_voxel_counts(0.05, mask.shape),
        None)
    ts = edt.extract_signed_distance_field(
        torch.from_numpy(mask), GridSpec.from_voxel_counts(0.05, mask.shape),
        None)
    return js, ts


@pytest.fixture(scope="module")
def sphere():
    return _sphere_fields()


def _rotated_pose(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = q
    pose[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    return pose


def _random_fields(shape, seed, posed=True):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    pose = _rotated_pose(rng) if posed else None
    js = JSignedDistanceField.create(
        JGridSpec.from_voxel_counts(0.1, shape), d, pose)
    ts = SignedDistanceField.create(
        GridSpec.from_voxel_counts(0.1, shape), torch.from_numpy(d), pose)
    return js, ts


def _planar_fields(n=8, resolution=0.5):
    filled = np.zeros((n, n, n), dtype=bool)
    filled[:, :, 0:2] = True
    js = jedt.extract_sdf_from_occupancy(
        filled.astype(np.float32), JGridSpec.from_voxel_counts(
            resolution, (n, n, n)), None, unknown_is_filled=True)
    ts = edt.extract_sdf_from_occupancy(
        torch.from_numpy(filled.astype(np.float32)),
        GridSpec.from_voxel_counts(resolution, (n, n, n)), None,
        unknown_is_filled=True)
    return js, ts


def _equal(got, ref):
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _check_gradient(ref, got):
    _equal(got.valid, ref.valid)
    _equal(got.gradient, ref.gradient)  # NaN where invalid, in both


@pytest.mark.parametrize("edge", [False, True])
@pytest.mark.parametrize("field", ["sphere", "random_posed"])
def test_coarse_gradients_bitwise(sphere, field, edge):
    js, ts = sphere if field == "sphere" else _random_fields((9, 11, 7), 4)
    rng = np.random.default_rng(1)
    counts = np.asarray(js.spec.counts)
    idx = rng.integers(-2, counts + 2, (4000, 3)).astype(np.int32)
    _check_gradient(
        jq.get_grid_aligned_index_coarse_gradient(js, jnp.asarray(idx), edge),
        tq.get_grid_aligned_index_coarse_gradient(ts, torch.from_numpy(idx),
                                                  edge))
    _check_gradient(jq.get_index_coarse_gradient(js, jnp.asarray(idx), edge),
                    tq.get_index_coarse_gradient(ts, torch.from_numpy(idx),
                                                 edge))
    hi = np.asarray(js.spec.grid_sizes)
    pts = (rng.uniform(-0.2, 1.2, (4000, 3)) * hi).astype(np.float32)
    pts[:4] = [[np.nan, 0, 0], [np.inf, 0, 0], [0, -np.inf, 0], [0, 0, 0]]
    if field == "random_posed":
        pts = pts - np.float32(0.3)
    _check_gradient(
        jq.get_location_coarse_gradient(js, jnp.asarray(pts), edge),
        tq.get_location_coarse_gradient(ts, torch.from_numpy(pts), edge))


@pytest.mark.parametrize("window", [0.05, 0.02, 0.3])
@pytest.mark.parametrize("field", ["sphere", "random_posed"])
def test_fine_gradients_match_jax(sphere, field, window):
    """Windows of one voxel, less, and several (one-sided fall-backs at the
    faces); location and index forms."""
    js, ts = sphere if field == "sphere" else _random_fields((9, 11, 7), 6)
    rng = np.random.default_rng(2)
    hi = np.asarray(js.spec.grid_sizes)
    pts = (rng.uniform(-0.1, 1.1, (3000, 3)) * hi).astype(np.float32)
    if field == "random_posed":
        pts = pts - np.float32(0.3)
    idx = rng.integers(-1, 12, (500, 3))
    for ref, got in (
            (jq.get_location_fine_gradient(js, jnp.asarray(pts), window),
             tq.get_location_fine_gradient(ts, torch.from_numpy(pts),
                                           window)),
            (jq.get_index_fine_gradient(js, jnp.asarray(idx), window),
             tq.get_index_fine_gradient(ts, torch.from_numpy(idx), window))):
        _equal(got.valid, ref.valid)
        m = np.asarray(ref.valid)
        assert m.any() and not m.all()
        assert np.isnan(got.gradient.numpy()[~m]).all()
        np.testing.assert_allclose(got.gradient.numpy()[m],
                                   np.asarray(ref.gradient)[m], rtol=0,
                                   atol=FINE_ATOL)
        _equal(got.gradient, ref.gradient)


def test_estimate_index_distance_bitwise():
    js, ts = _random_fields((9, 11, 7), 7)
    idx = np.random.default_rng(3).integers(-2, 12, (2000, 3)).astype(
        np.int32)
    ref = jq.estimate_index_distance(js, jnp.asarray(idx))
    got = tq.estimate_index_distance(ts, torch.from_numpy(idx))
    _equal(got.valid, ref.valid)
    _equal(got.value, ref.value)


def _shell_points(js, count, seed, r_lo=0.2, r_hi=0.45):
    """Points drawn in a shell inside the sphere (its radius is 0.45 m)."""
    rng = np.random.default_rng(seed)
    dirs = rng.normal(size=(count, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    r = rng.uniform(r_lo, r_hi, count)
    c = np.array([20.5, 20.5, 12.5]) * 0.05
    return (c + dirs * r[:, None]).astype(np.float32)


@pytest.mark.parametrize("minimum_distance", [0.0, 0.1])
def test_projections_match_jax(sphere, minimum_distance):
    js, ts = sphere
    pts = _shell_points(js, 1500, 4)
    pts[:3] = [[-1.0, 0.5, 0.5], [0.5, 0.5, 0.02], [1.0, 1.0, 0.6]]
    ref = jq.project_out_of_collision_to_minimum_distance(
        js, jnp.asarray(pts), minimum_distance)
    got = tq.project_out_of_collision_to_minimum_distance(
        ts, torch.from_numpy(pts), minimum_distance)
    _equal(got.valid, ref.valid)
    # Outside the grid, outside the sphere: valid as they are; the centre's
    # gradient is flat: invalid.
    assert got.valid[:2].all() and not got.valid[2] and got.valid[3:].all()
    np.testing.assert_allclose(got.position.numpy(), np.asarray(ref.position),
                               rtol=0, atol=PROJECTION_ATOL)
    d = tq.estimate_location_distance(ts, got.position[got.valid])
    inside = d.valid.numpy()
    assert (d.value.numpy()[inside] > minimum_distance).all()
    # The point outside the grid is returned as it is.
    np.testing.assert_array_equal(got.position.numpy()[0], pts[0])


def test_projection_step_budget_and_flat_gradient_fail():
    """Walks that run out of steps, or stand on a flat gradient, are
    invalid in both packages."""
    js, ts = _sphere_fields()
    pts = _shell_points(js, 200, 5, 0.0, 0.1)
    ref = jq.project_out_of_collision(js, jnp.asarray(pts), max_steps=3)
    got = tq.project_out_of_collision(ts, torch.from_numpy(pts), max_steps=3)
    _equal(got.valid, ref.valid)
    assert not got.valid.any()
    np.testing.assert_allclose(got.position.numpy(), np.asarray(ref.position),
                               rtol=0, atol=PROJECTION_ATOL)
    flat = np.full((6, 6, 6), -0.3, np.float32)
    jf = JSignedDistanceField.create(JGridSpec.from_voxel_counts(0.1, flat.shape),
                                     flat)
    tf = SignedDistanceField.create(GridSpec.from_voxel_counts(0.1, flat.shape),
                                    torch.from_numpy(flat))
    p = np.array([[0.31, 0.32, 0.33]], np.float32)
    assert not bool(jq.project_out_of_collision(jf, jnp.asarray(p)).valid[0])
    assert not bool(tq.project_out_of_collision(tf, torch.from_numpy(p)).valid[0])


def _cycle_and_escape_counts(ts, extrema):
    """(cells whose walk leaves the grid, finite targets that are not flat
    cells: cycle representatives)."""
    spec = ts.spec
    n = spec.num_total
    cells = torch.arange(n, dtype=torch.int32)
    grad = tq.get_index_coarse_gradient(ts, spec.unflatten_index(cells),
                                        enable_edge_gradients=True)
    flat = tq._gradient_is_effectively_flat(grad.gradient, spec.resolution)
    e = extrema.reshape(-1, 3)
    finite = torch.isfinite(e).all(dim=-1)
    target = spec.location_in_grid_frame_to_grid_index(e[finite])
    target_flat = flat[spec.flat_index(target.long())]
    return int((~finite).sum()), int((~target_flat).sum())


@pytest.mark.parametrize("field", ["sphere", "planar", "random", "posed"])
def test_local_extrema_map_bitwise(sphere, field):
    if field == "sphere":
        js, ts = sphere
    elif field == "planar":
        js, ts = _planar_fields()
    else:
        js, ts = _random_fields((10, 9, 8), 9, posed=field == "posed")
    ref = np.asarray(jq.compute_local_extrema_map(js))
    got = tq.compute_local_extrema_map(ts)
    assert got.shape == tuple(js.spec.counts) + (3,)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref)
    escapes, cycles = _cycle_and_escape_counts(ts, got)
    assert escapes > 0
    if field in ("random", "posed"):
        assert cycles > 0


def test_local_extrema_map_chunked_jump_rounds(monkeypatch):
    """Forming the next-cell field in several chunks, and a capped round
    count, give the JAX package's bits."""
    js, ts = _random_fields((7, 6, 5), 10)
    monkeypatch.setattr(tq, "_EXTREMA_CHUNK", 37)
    for rounds in (1, 3, 64):
        np.testing.assert_array_equal(
            tq.compute_local_extrema_map(ts, rounds).numpy(),
            np.asarray(jq.compute_local_extrema_map(js, rounds)))


# -- ports of tests/test_sdf_query.py ---------------------------------------


def test_coarse_gradient_interior_and_edges():
    _, sdf = _planar_fields()
    g = tq.get_index_coarse_gradient(sdf, torch.tensor([4, 4, 4]))
    assert bool(g.valid)
    np.testing.assert_allclose(g.gradient.numpy(), [0, 0, 1], atol=1e-5)
    g2 = tq.get_index_coarse_gradient(sdf, torch.tensor([0, 4, 4]))
    assert not bool(g2.valid)
    g3 = tq.get_index_coarse_gradient(sdf, torch.tensor([0, 4, 4]),
                                      enable_edge_gradients=True)
    assert bool(g3.valid)
    np.testing.assert_allclose(g3.gradient.numpy(), [0, 0, 1], atol=1e-5)


def test_coarse_gradient_rotated_frame():
    # 90 degrees about x: grid +z maps to world -y.
    _, sdf0 = _planar_fields()
    c, s = np.cos(np.pi / 2), np.sin(np.pi / 2)
    rot = np.array([[1, 0, 0, 0], [0, c, -s, 0], [0, s, c, 0], [0, 0, 0, 1]],
                   np.float32)
    sdf = sdf0.replace(origin_transform=torch.from_numpy(rot))
    g = tq.get_index_coarse_gradient(sdf, torch.tensor([4, 4, 4]))
    np.testing.assert_allclose(g.gradient.numpy(), [0, -1, 0], atol=1e-5)


def test_fine_gradient_matches_finite_difference_of_estimate():
    _, sdf = _planar_fields()
    p = np.array([1.8, 2.2, 2.6], np.float32)
    g = tq.get_location_fine_gradient(sdf, torch.from_numpy(p), 0.05)
    assert bool(g.valid)
    eps = 0.05
    fd = []
    for axis in range(3):
        pp, pm = p.copy(), p.copy()
        pp[axis] += eps
        pm[axis] -= eps
        vp = float(tq.estimate_location_distance(sdf, torch.from_numpy(pp))
                   .value)
        vm = float(tq.estimate_location_distance(sdf, torch.from_numpy(pm))
                   .value)
        fd.append((vp - vm) / (2 * eps))
    np.testing.assert_allclose(g.gradient.numpy(), fd, atol=1e-4)


def test_project_out_of_collision():
    _, sdf = _planar_fields()
    pts = np.array([[1.1, 1.2, 0.4], [2.0, 2.0, 0.7], [3.0, 3.0, 2.5]],
                   np.float32)
    result = tq.project_out_of_collision(sdf, torch.from_numpy(pts))
    assert result.valid.all()
    vals = tq.estimate_location_distance(sdf, result.position).value.numpy()
    assert np.all(vals > 0.0)
    np.testing.assert_allclose(result.position.numpy()[2], pts[2], atol=1e-6)


def test_project_to_minimum_distance():
    _, sdf = _planar_fields()
    p = torch.tensor([2.0, 2.0, 1.2])
    result = tq.project_out_of_collision_to_minimum_distance(
        sdf, p, minimum_distance=0.6)
    assert bool(result.valid)
    assert float(tq.estimate_location_distance(sdf, result.position).value) \
        > 0.6


def test_local_extrema_map_planar():
    _, sdf = _planar_fields()
    extrema = tq.compute_local_extrema_map(sdf).numpy()
    assert extrema.shape == sdf.spec.counts + (3,)
    assert np.all(np.isinf(extrema[:, :, 5]))
    assert np.all(np.isfinite(extrema) | (extrema == np.inf))


def test_local_extrema_map_double_box():
    spec = GridSpec.from_voxel_counts(1.0, (12, 4, 4))
    filled = np.zeros(spec.counts, dtype=bool)
    filled[1:3, 1:3, 1:3] = True
    filled[9:11, 1:3, 1:3] = True
    sdf = edt.extract_signed_distance_field(torch.from_numpy(filled), spec,
                                            None)
    extrema = tq.compute_local_extrema_map(sdf).numpy()
    left = extrema[1:3, 1:3, 1:3]
    right = extrema[9:11, 1:3, 1:3]
    assert np.all(np.isfinite(left)) and np.all(np.isfinite(right))
    assert np.all(left[..., 0] < 6.0) and np.all(right[..., 0] > 6.0)


@pytest.mark.cuda
def test_cuda_gradients_and_extrema_match_cpu():
    """On the card: coarse and fine gradients and the extrema map are the
    CPU's bits; projections agree within PROJECTION_ATOL."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    js, ts = _sphere_fields()
    card = ts.replace(distances=ts.distances.cuda(),
                      origin_transform=ts.origin_transform.cuda())
    pts = torch.from_numpy(_shell_points(js, 2000, 6, 0.0, 0.7))
    for fn in (lambda s, p: tq.get_location_coarse_gradient(s, p, True),
               lambda s, p: tq.get_location_fine_gradient(s, p, 0.05)):
        a, b = fn(ts, pts), fn(card, pts.cuda())
        assert torch.equal(a.valid, b.valid.cpu())
        assert torch.equal(a.gradient.nan_to_num(7.0),
                           b.gradient.cpu().nan_to_num(7.0))
    assert torch.equal(tq.compute_local_extrema_map(ts),
                       tq.compute_local_extrema_map(card).cpu())
    inside = torch.from_numpy(_shell_points(js, 2000, 7))
    a = tq.project_out_of_collision(ts, inside)
    b = tq.project_out_of_collision(card, inside.cuda())
    assert torch.equal(a.valid, b.valid.cpu())
    np.testing.assert_allclose(b.position.cpu().numpy(), a.position.numpy(),
                               rtol=0, atol=PROJECTION_ATOL)
