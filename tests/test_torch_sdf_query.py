"""The PyTorch port's SDF queries and corner-brick table against the JAX
package, on the same fields (built by each package's own EDT, which agree
bit for bit) and the same points from numpy seeds."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core.maps import (
    SignedDistanceField as JSignedDistanceField)
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, SignedDistanceField
from voxelized_geometry_tools_tpu_torch import interop
from voxelized_geometry_tools_tpu_torch.ops import edt, sdf_query as tq

# Query values: atol 1e-6 is the JAX package's own contract between its
# 8-gather and 1-gather paths (float reassociation; sdf_query.py:215-217).
QUERY_ATOL = 1e-6
# Gradients: autograd and jax.grad accumulate the same terms in another
# order (scatter-adds into voxels), so a few ulp of the summed values.
GRAD_ATOL = 1e-5


def _sphere_mask():
    xs, ys, zs = np.meshgrid(np.arange(40), np.arange(40), np.arange(24),
                             indexing="ij", sparse=True)
    return ((xs - 20) ** 2 + (ys - 20) ** 2 + (zs - 12) ** 2) <= 81


@pytest.fixture(scope="module")
def fields():
    """(jax sdf, port sdf) of the 40x40x24 sphere at 0.05 m."""
    mask = _sphere_mask()
    js = jedt.extract_signed_distance_field(
        jnp.asarray(mask), JGridSpec.from_voxel_counts(0.05, mask.shape),
        None, frame="t")
    ts = edt.extract_signed_distance_field(
        torch.from_numpy(mask), GridSpec.from_voxel_counts(0.05, mask.shape),
        None, frame="t")
    np.testing.assert_array_equal(ts.distances.numpy(),
                                  np.asarray(js.distances))
    return js, ts


@pytest.fixture(scope="module")
def tables(fields):
    js, ts = fields
    return jq.build_corner_table(js), tq.build_corner_table(ts)


def _points(spec_sizes, seed, count=5000):
    """Points over the grid box and past its faces by 0.3 m."""
    hi = np.asarray(spec_sizes)
    rng = np.random.default_rng(seed)
    return (rng.uniform(-0.3, 1.0, size=(count, 3)) * (hi + 0.6)
            - 0.3).astype(np.float32)


def _random_field(shape, seed, pose=None):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    js = JSignedDistanceField.create(
        JGridSpec.from_voxel_counts(0.1, shape), d, pose)
    ts = SignedDistanceField.create(
        GridSpec.from_voxel_counts(0.1, shape), torch.from_numpy(d), pose)
    return js, ts


def _rotated_pose():
    c, s = np.cos(0.4), np.sin(0.4)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]]
    pose[:3, 3] = [0.3, -0.2, 0.1]
    return pose


def test_corner_table_rows_bitwise(fields, tables):
    jt, tt = tables
    np.testing.assert_array_equal(tt.rows.numpy(), np.asarray(jt.rows))


@pytest.mark.parametrize("shape", [(5, 7, 9), (1, 3, 4), (33, 2, 1)])
def test_corner_table_rows_bitwise_odd_shapes(shape):
    """Degenerate axes clamp the +1 neighbour onto the same cell; 33 X
    planes cross two build slabs."""
    js, ts = _random_field(shape, 3)
    np.testing.assert_array_equal(tq.build_corner_table(ts).rows.numpy(),
                                  np.asarray(jq.build_corner_table(js).rows))


def _check_query(ref, got):
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(ref.valid))
    m = np.asarray(ref.valid)
    assert np.isnan(got.value.numpy()[~m]).all()
    np.testing.assert_allclose(got.value.numpy()[m], np.asarray(ref.value)[m],
                               rtol=0, atol=QUERY_ATOL)


@pytest.mark.parametrize("fast", [False, True])
def test_queries_match_jax(fields, tables, fast):
    js, ts = fields
    jt, tt = tables
    pts = _points(js.spec.grid_sizes, 0)
    if fast:
        ref = jq.estimate_location_distance_fast(js, jt, jnp.asarray(pts))
        got = tq.estimate_location_distance_fast(ts, tt,
                                                 torch.from_numpy(pts))
    else:
        ref = jq.estimate_location_distance(js, jnp.asarray(pts))
        got = tq.estimate_location_distance(ts, torch.from_numpy(pts))
    _check_query(ref, got)


@pytest.mark.parametrize("fast", [False, True])
def test_queries_match_jax_posed_random_field(fast):
    """A rotated, translated grid and a rough field exercise the transform
    and the edge extrapolation."""
    js, ts = _random_field((9, 11, 7), 4, _rotated_pose())
    pts = _points(js.spec.grid_sizes, 1, 2000) + np.float32(0.2)
    if fast:
        ref = jq.estimate_location_distance_fast(
            js, jq.build_corner_table(js), jnp.asarray(pts))
        got = tq.estimate_location_distance_fast(
            ts, tq.build_corner_table(ts), torch.from_numpy(pts))
    else:
        ref = jq.estimate_location_distance(js, jnp.asarray(pts))
        got = tq.estimate_location_distance(ts, torch.from_numpy(pts))
    _check_query(ref, got)


def test_fast_query_matches_slow_query(fields, tables):
    _, ts = fields
    _, tt = tables
    pts = torch.from_numpy(_points(ts.spec.grid_sizes, 5))
    _check_query(tq.estimate_location_distance(ts, pts),
                 tq.estimate_location_distance_fast(ts, tt, pts))


def test_location_query_valid_matches_queries(fields, tables):
    _, ts = fields
    _, tt = tables
    pts = torch.from_numpy(_points(ts.spec.grid_sizes, 6))
    assert torch.equal(tq.location_query_valid(ts, pts),
                       tq.estimate_location_distance(ts, pts).valid)
    assert torch.equal(
        tq.location_query_valid(ts, pts, tt.rows.dtype),
        tq.estimate_location_distance_fast(ts, tt, pts).valid)


@pytest.mark.parametrize("fast", [False, True])
def test_nonfinite_points(fields, tables, fast):
    _, ts = fields
    _, tt = tables
    pts = torch.tensor([[np.nan, 0.1, 0.1], [np.inf, 0.1, 0.1],
                        [0.1, -np.inf, 0.1], [0.1, 0.1, 0.1]])
    pts.requires_grad_(True)
    q = (tq.estimate_location_distance_fast(ts, tt, pts) if fast
         else tq.estimate_location_distance(ts, pts))
    assert q.valid.tolist() == [False, False, False, True]
    torch.nansum(q.value).backward()
    assert torch.isfinite(pts.grad).all()
    assert (pts.grad[:3] == 0).all()


@pytest.mark.parametrize("fast", [False, True])
def test_gradients_match_jax(fields, fast):
    """d(sum of values)/d(distances) and d/d(points) against jax.grad; with
    ``fast`` the table is built inside the differentiated function."""
    js, ts = fields
    pts = np.random.default_rng(1).uniform(0.2, 1.0, (64, 3)).astype(
        np.float32)

    def jloss(d, p):
        s = js.replace(distances=d)
        if fast:
            return jnp.nansum(jq.estimate_location_distance_fast(
                s, jq.build_corner_table(s), p).value)
        return jnp.nansum(jq.estimate_location_distance(s, p).value)

    jg_d, jg_p = jax.grad(jloss, argnums=(0, 1))(js.distances,
                                                  jnp.asarray(pts))
    d = ts.distances.clone().requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    s = ts.replace(distances=d)
    if fast:
        loss = torch.nansum(tq.estimate_location_distance_fast(
            s, tq.build_corner_table(s), p).value)
    else:
        loss = torch.nansum(tq.estimate_location_distance(s, p).value)
    loss.backward()
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg_d),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg_p),
                               atol=GRAD_ATOL)


def test_pair_table_not_ported(fields, tables):
    """The pair table is ported (tests/test_torch_corner_pair.py holds it
    against the JAX package): its queries are the brick table's bits, and
    a table of any other type raises."""
    _, ts = fields
    _, tt = tables
    pts = torch.from_numpy(_points(ts.spec.grid_sizes, 0))
    pair = tq.estimate_location_distance_fast(
        ts, tq.build_corner_pair_table(ts), pts)
    brick = tq.estimate_location_distance_fast(ts, tt, pts)
    assert torch.equal(pair.valid, brick.valid)
    assert torch.equal(pair.value.view(torch.int32),
                       brick.value.view(torch.int32))
    with pytest.raises(TypeError, match="CornerPairTable"):
        tq.estimate_location_distance_fast(
            ts, (torch.zeros(4, 8),), torch.zeros(1, 3))


def test_interop_state_round_trip(fields, tables):
    js, ts = fields
    jt, _ = tables
    spec = interop.grid_spec_from_fields(js.spec.counts, js.spec.resolution,
                                         js.spec.voxel_sizes)
    assert spec == ts.spec
    sdf = interop.sdf_from_numpy(
        spec, np.asarray(js.distances), np.asarray(js.origin_transform),
        frame=js.frame, locked=js.locked, oob_value=js.oob_value,
        minimum=np.asarray(js.minimum), maximum=np.asarray(js.maximum),
        device="cpu")
    assert sdf.locked and float(sdf.minimum) == float(js.minimum)
    assert torch.equal(sdf.distances, ts.distances)
    table = interop.corner_table_from_numpy(np.asarray(jt.rows), device="cpu")
    pts = torch.from_numpy(_points(js.spec.grid_sizes, 2, 500))
    a = tq.estimate_location_distance_fast(sdf, table, pts)
    b = tq.estimate_location_distance_fast(ts, tq.build_corner_table(ts),
                                           pts)
    assert torch.equal(a.valid, b.valid)
    assert torch.equal(a.value[a.valid], b.value[b.valid])


def test_locked_field_unlocks_on_replace(fields):
    _, ts = fields
    assert ts.locked
    moved = ts.replace(distances=ts.distances + 1.0)
    assert not moved.locked
    lo, hi = moved.get_minimum_maximum()
    assert float(lo) == float(ts.minimum) + 1.0
    assert moved.lock().locked


def test_origin_transform_must_be_isometry():
    bad = np.eye(4, dtype=np.float32)
    bad[0, 0] = 2.0
    with pytest.raises(ValueError, match="isometry"):
        SignedDistanceField.create(GridSpec.from_voxel_counts(0.1, (2, 2, 2)),
                                   torch.zeros(2, 2, 2), bad)


def test_query_constants_are_cached_and_differentiable_after_inference():
    """The hot-path constants are made once per (value, dtype, device) and
    stay usable by autograd when first made under inference mode."""
    from voxelized_geometry_tools_tpu_torch.core.constants import constant

    spec = GridSpec.from_voxel_counts(0.1, (4, 5, 6))
    sdf = SignedDistanceField.create(spec, torch.rand(4, 5, 6), None)
    table = tq.build_corner_table(sdf)
    pts = torch.tensor([[0.15, 0.2, 0.33]])
    with torch.inference_mode():
        tq.estimate_location_distance_fast(sdf, table, pts * 1.01)
    assert constant(float("nan"), torch.float64, "cpu") is constant(
        float("nan"), torch.float64, "cpu")
    p = pts.clone().requires_grad_(True)
    q = tq.estimate_location_distance_fast(sdf, table, p)
    q.value.sum().backward()
    assert bool(torch.isfinite(p.grad).all())
