"""The port's z-pair table (``CornerPairTable``) against the JAX package's
and against the port's own brick table: rows bit for bit (a plane size
that is a multiple of 4 and odd ones), queries through the pair table bit
for bit equal to the brick table's and to the JAX package's op-by-op pair
queries (NaN, infinite and out-of-bounds points among them), gradients
through the build, and the fixed and early-exit renders with a pair
table."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core.maps import (
    SignedDistanceField as JSignedDistanceField)
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import render as jr
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.ops import edt
from voxelized_geometry_tools_tpu_torch.ops import render as tr
from voxelized_geometry_tools_tpu_torch.ops import sdf_query as tq

from test_torch_render import _cameras, check_render_contract

# Gradients: autograd and jax.grad accumulate the same terms in another
# order (scatter-adds into voxels), as in tests/test_torch_sdf_query.py.
GRAD_ATOL = 1e-5

# (8, 8, 12): plane 96, a multiple of 4 (the JAX package's packed branch);
# (5, 7, 9): plane 63 and 315 cells (its flat branch, one padded row);
# (4, 3, 5): plane 15 but 60 cells (flat branch, no padding);
# (33, 2, 1): two build slabs, a degenerate z axis.
SHAPES = [(8, 8, 12), (5, 7, 9), (4, 3, 5), (33, 2, 1)]


def _pose(rng):
    c, s = np.cos(0.5), np.sin(0.5)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    pose[:3, 3] = rng.uniform(-0.3, 0.3, 3)
    return pose


def _fields(shape, seed):
    rng = np.random.default_rng(seed)
    d = rng.uniform(-0.5, 0.5, shape).astype(np.float32)
    pose = _pose(rng)
    jspec = JGridSpec.from_voxel_counts(0.1, shape)
    js = JSignedDistanceField.create(jspec, jnp.asarray(d), pose)
    ts = interop.sdf_from_numpy(GridSpec(jspec.counts, 0.1), d, pose,
                                device="cpu")
    return js, ts


def _points(ts, seed, count=4000):
    """Points over the posed grid box and 0.3 m past its faces, with NaN,
    infinite and far out-of-bounds ones."""
    rng = np.random.default_rng(seed)
    hi = np.asarray(ts.spec.grid_sizes)
    g = rng.uniform(-0.3, 1.0, (count, 3)) * (hi + 0.6) - 0.3
    pose = ts.origin_transform.numpy().astype(np.float64)
    pts = (g @ pose[:3, :3].T + pose[:3, 3]).astype(np.float32)
    pts[:3] = np.nan
    pts[3, 1] = np.inf
    pts[4] = (-np.inf, 0.0, 0.0)
    pts[5] = (1e9, 0.0, 0.0)
    return pts


@pytest.mark.parametrize("shape", SHAPES)
def test_pair_rows_match_jax(shape):
    js, ts = _fields(shape, 1)
    ref = np.asarray(jq.build_corner_pair_table(js).rows)
    got = tq.build_corner_pair_table(ts).rows
    assert got.shape == ref.shape == (-(-np.prod(shape) // 4), 8)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_pair_queries_match_brick_and_jax(shape):
    """Pair-table queries equal the port's brick-table queries and the JAX
    package's op-by-op pair-table queries bit for bit, valid masks too."""
    js, ts = _fields(shape, 2)
    pts = _points(ts, 3)
    pair = tq.build_corner_pair_table(ts)
    got = tq.estimate_location_distance_fast(ts, pair, torch.from_numpy(pts))
    brick = tq.estimate_location_distance_fast(
        ts, tq.build_corner_table(ts), torch.from_numpy(pts))
    with jax.disable_jit():
        ref = jq.estimate_location_distance_fast(
            js, jq.build_corner_pair_table(js), jnp.asarray(pts))
    assert 0 < int(got.valid.sum()) < len(pts)
    for other in (brick, ref):
        np.testing.assert_array_equal(got.valid.numpy(),
                                      np.asarray(other.valid))
        np.testing.assert_array_equal(
            got.value.numpy().view(np.uint32),
            np.asarray(other.value).view(np.uint32))


def test_pair_table_gradients_match_jax():
    """Gradients of summed pair-table queries, the table built from the
    distances inside the loss, in the distances and the points."""
    js, ts = _fields((6, 5, 7), 4)
    pts = _points(ts, 5, 500)[6:]

    def jloss(d, p):
        s = js.replace(distances=d)
        return jnp.nansum(jq.estimate_location_distance_fast(
            s, jq.build_corner_pair_table(s), p).value)

    jg_d, jg_p = jax.grad(jloss, argnums=(0, 1))(js.distances,
                                                  jnp.asarray(pts))
    d = ts.distances.clone().requires_grad_(True)
    p = torch.from_numpy(pts).requires_grad_(True)
    s = ts.replace(distances=d)
    torch.nansum(tq.estimate_location_distance_fast(
        s, tq.build_corner_pair_table(s), p).value).backward()
    assert float(torch.abs(d.grad).sum()) > 0.0
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg_d),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg_p),
                               atol=GRAD_ATOL)


def test_unknown_table_type_rejected():
    _, ts = _fields((4, 4, 4), 6)
    with pytest.raises(TypeError, match="CornerPairTable"):
        tq.estimate_location_distance_fast(ts, (torch.zeros(16, 8),),
                                           torch.zeros(1, 3))


def test_pair_table_interop_round_trip():
    js, ts = _fields((5, 7, 9), 7)
    rows = np.asarray(jq.build_corner_pair_table(js).rows)
    table = interop.corner_pair_table_from_numpy(rows, device="cpu")
    assert isinstance(table, tq.CornerPairTable)
    np.testing.assert_array_equal(table.rows.numpy(), rows)
    with pytest.raises(ValueError, match="pair table rows"):
        interop.corner_pair_table_from_numpy(rows.reshape(-1, 4),
                                             device="cpu")


@pytest.fixture(scope="module")
def sphere():
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
    return js, ts


@pytest.mark.parametrize("schedule", [
    dict(),
    dict(early_exit=True, tail_chunks=1),
    dict(early_exit=True, coarse_factor=4, head_steps=0, tail_chunks=4),
])
def test_pair_table_renders(sphere, schedule):
    """Fixed, early-exit and cone-prepass renders through a pair table are
    the brick table's renders bit for bit, and hold the render contract of
    tests/test_torch_render.py against the JAX package's pair-table
    render."""
    js, ts = sphere
    jc, tc = _cameras(js)
    got = tr.render_depth(ts, tc, num_steps=64,
                          corner_table=tq.build_corner_pair_table(ts),
                          **schedule)
    brick = tr.render_depth(ts, tc, num_steps=64,
                            corner_table=tq.build_corner_table(ts),
                            **schedule)
    for a, b in zip(got, brick):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ref = jr.render_depth(js, jc, num_steps=64,
                          corner_table=jq.build_corner_pair_table(js),
                          **schedule)
    check_render_contract(np.asarray(ref.hit), np.asarray(ref.depth),
                          np.asarray(ref.distance), got, ts.resolution)
    assert 0.0 < got.hit.numpy().mean() < 1.0


@pytest.mark.cuda
def test_cuda_pair_queries_match_brick():
    """On the card: pair-table rows equal the CPU's, and pair-table queries
    equal brick-table queries bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _, ts = _fields((8, 8, 12), 8)
    card = ts.replace(distances=ts.distances.cuda(),
                      origin_transform=ts.origin_transform.cuda())
    pair = tq.build_corner_pair_table(card)
    assert torch.equal(pair.rows.cpu(), tq.build_corner_pair_table(ts).rows)
    pts = torch.from_numpy(_points(ts, 9)).cuda()
    got = tq.estimate_location_distance_fast(card, pair, pts)
    ref = tq.estimate_location_distance_fast(
        card, tq.build_corner_table(card), pts)
    assert torch.equal(got.valid, ref.valid)
    assert torch.equal(got.value.view(torch.int32), ref.value.view(torch.int32))
