"""Double-precision parity through the port: every case of
tests/test_double_precision.py for float32 and float64, each held against
the JAX package under ``jax.enable_x64()`` (the EDT, the maps' cached
inverse, queries, the corner table, gradients, projections and the
extrema map), and the float64 transform products against XLA's on 400
random products each.

XLA's CPU dot in float64 is a fused multiply-add chain where ``K <= 3``
(``invert_isometry``'s ``-R^T t``) and rounded products summed in ``k``
order for a 4x4 product (``compose``); ``core/transforms.matmul``
reproduces both, so these are bitwise.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core import transforms as jt
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, SignedDistanceField
from voxelized_geometry_tools_tpu_torch.core import transforms as tt
from voxelized_geometry_tools_tpu_torch.ops import edt, sdf_query as tq

DTYPES = [torch.float32, torch.float64]
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
# Projected points: the JAX walk is a compiled loop (fused multiply-adds),
# as in tests/test_torch_sdf_gradients.py.
PROJECTION_ATOL = {torch.float32: 2e-5, torch.float64: 1e-12}


def _equal(got, ref):
    got = got.numpy()
    ref = np.asarray(ref)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("dtype", DTYPES)
def test_linear_exact_both_dtypes(dtype):
    filled = np.zeros((1, 1, 4), dtype=bool)
    filled[0, 0, 0:2] = True
    sdf = edt.extract_signed_distance_field(
        torch.from_numpy(filled), GridSpec.from_voxel_counts(1.0, (1, 1, 4)),
        None, dtype=dtype)
    assert sdf.distances.dtype == dtype
    assert sdf.origin_transform.dtype == dtype
    np.testing.assert_allclose(sdf.distances.numpy()[0, 0],
                               [-2.0, -1.0, 1.0, 2.0], rtol=1e-6)
    with jax.enable_x64():
        ref = jedt.extract_signed_distance_field(
            filled, JGridSpec.from_voxel_counts(1.0, (1, 1, 4)), None,
            dtype=JAX_DTYPE[dtype])
        _equal(sdf.distances, ref.distances)


@pytest.mark.parametrize("dtype", DTYPES)
def test_planar_and_cube_exact_both_dtypes(dtype):
    filled = np.zeros((1, 4, 4), dtype=bool)
    filled[0, 0:2, 0:2] = True
    vals = edt.signed_distance_from_filled_mask(torch.from_numpy(filled), 1.0,
                                                dtype=dtype)
    assert vals.dtype == dtype
    expected = np.array([
        [-2.0, -1.0, 1.0, 2.0],
        [-1.0, -1.0, 1.0, 2.0],
        [1.0, 1.0, np.sqrt(2.0), np.sqrt(5.0)],
        [2.0, 2.0, np.sqrt(5.0), np.sqrt(8.0)],
    ])
    np.testing.assert_allclose(vals.numpy()[0], expected, rtol=1e-6)
    cube = np.zeros((2, 2, 2), dtype=bool)
    cube[0, 0, 0] = True
    cvals = edt.signed_distance_from_filled_mask(torch.from_numpy(cube), 1.0,
                                                 dtype=dtype)
    expected = np.array([
        [[-1.0, 1.0], [1.0, np.sqrt(2.0)]],
        [[1.0, np.sqrt(2.0)], [np.sqrt(2.0), np.sqrt(3.0)]],
    ])
    np.testing.assert_allclose(cvals.numpy(), expected, rtol=1e-6)
    with jax.enable_x64():
        _equal(vals, jedt.signed_distance_from_filled_mask(
            filled, 1.0, dtype=JAX_DTYPE[dtype]))
        _equal(cvals, jedt.signed_distance_from_filled_mask(
            cube, 1.0, dtype=JAX_DTYPE[dtype]))


@pytest.mark.parametrize("dtype", DTYPES)
def test_virtual_border_both_dtypes(dtype):
    filled = np.zeros((4, 4, 4), dtype=bool)
    filled[1:3, 1:3, 1:3] = True
    vals = edt.signed_distance_with_virtual_border(torch.from_numpy(filled),
                                                   0.5, dtype=dtype)
    assert vals.dtype == dtype
    assert torch.isfinite(vals).all()
    with jax.enable_x64():
        _equal(vals, jedt.signed_distance_with_virtual_border(
            filled, 0.5, dtype=JAX_DTYPE[dtype]))


def _planar(dtype, n=8, resolution=0.5, origin=None):
    filled = np.zeros((n, n, n), dtype=bool)
    filled[:, :, 0:2] = True
    occ = filled.astype(np.float32)
    ts = edt.extract_sdf_from_occupancy(
        torch.from_numpy(occ), GridSpec.from_voxel_counts(resolution,
                                                          (n, n, n)),
        origin, unknown_is_filled=True, dtype=dtype)
    with jax.enable_x64():
        js = jedt.extract_sdf_from_occupancy(
            occ, JGridSpec.from_voxel_counts(resolution, (n, n, n)), origin,
            unknown_is_filled=True, dtype=JAX_DTYPE[dtype])
    return js, ts


def _posed():
    """A rotated origin whose translation float32 cannot hold."""
    c, s = np.cos(0.7), np.sin(0.7)
    m = np.eye(4)
    m[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    m[:3, 3] = (0.1 + 2.0 ** -30, -0.3, 0.2)
    return m


@pytest.mark.parametrize("dtype", DTYPES)
def test_estimate_distance_both_dtypes(dtype):
    js, sdf = _planar(dtype)
    res = sdf.resolution
    p = torch.tensor([2.25, 2.25, 2.25], dtype=torch.float64)
    q = tq.estimate_location_distance(sdf, p)
    assert q.value.dtype == dtype
    stored = float(sdf.distances[4, 4, 4])
    np.testing.assert_allclose(float(q.value), stored - res / 2, rtol=1e-6)
    pts = np.random.default_rng(1).uniform(-0.5, 4.5, (500, 3))
    with jax.enable_x64():
        ref = jq.estimate_location_distance(js, pts)
        _equal(tq.estimate_location_distance(sdf, torch.from_numpy(pts))
               .value, ref.value)


@pytest.mark.parametrize("dtype", DTYPES)
def test_posed_field_inverse_and_queries_bitwise(dtype):
    """The maps' cached inverse, index and location queries under a
    rotated origin: JAX's bits in each dtype."""
    js, sdf = _planar(dtype, origin=_posed())
    with jax.enable_x64():
        _equal(sdf.inverse_origin_transform(), js.inverse_origin_transform())
        rng = np.random.default_rng(2)
        pts = rng.uniform(-1.0, 5.0, (800, 3))
        idx = rng.integers(-1, 9, (300, 3)).astype(np.int32)
        _equal(sdf.location_to_grid_index(torch.from_numpy(pts)),
               js.location_to_grid_index(pts))
        _equal(tq.estimate_location_distance(sdf, torch.from_numpy(pts))
               .value, jq.estimate_location_distance(js, pts).value)
        _equal(tq.estimate_index_distance(sdf, torch.from_numpy(idx)).value,
               jq.estimate_index_distance(js, jnp.asarray(idx)).value)


@pytest.mark.parametrize("dtype", DTYPES)
def test_corner_table_fast_path_keeps_dtype(dtype):
    js, sdf = _planar(dtype)
    table = tq.build_corner_table(sdf)
    assert table.rows.dtype == dtype
    pts = torch.from_numpy(np.random.default_rng(3).uniform(0.1, 3.9,
                                                            (256, 3)))
    slow = tq.estimate_location_distance(sdf, pts)
    fast = tq.estimate_location_distance_fast(sdf, table, pts)
    assert fast.value.dtype == dtype
    assert torch.equal(slow.valid, fast.valid)
    tol = 1e-12 if dtype == torch.float64 else 1e-6
    np.testing.assert_allclose(fast.value.numpy(), slow.value.numpy(),
                               rtol=tol, atol=tol)
    with jax.enable_x64():
        jt_ = jq.build_corner_table(js)
        _equal(table.rows, jt_.rows)
        _equal(fast.value,
               jq.estimate_location_distance_fast(js, jt_, pts.numpy()).value)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_and_projection_both_dtypes(dtype):
    js, sdf = _planar(dtype)
    idx = torch.tensor([[4, 4, 4], [4, 4, 2]])
    g = tq.get_index_coarse_gradient(sdf, idx)
    assert g.gradient.dtype == dtype
    np.testing.assert_allclose(g.gradient.numpy()[0], [0, 0, 1], atol=1e-6)
    fg = tq.get_index_fine_gradient(sdf, idx, sdf.resolution)
    assert fg.gradient.dtype == dtype
    np.testing.assert_allclose(fg.gradient.numpy()[0], [0, 0, 1], atol=1e-5)
    p = torch.tensor([2.1, 2.1, 0.3], dtype=torch.float64)
    proj = tq.project_out_of_collision(sdf, p, max_steps=200)
    assert bool(proj.valid)
    assert proj.position.dtype == dtype
    assert float(tq.estimate_location_distance(sdf, proj.position).value) > 0
    with jax.enable_x64():
        _equal(g.gradient, jq.get_index_coarse_gradient(js, idx.numpy())
               .gradient)
        _equal(fg.gradient, jq.get_index_fine_gradient(
            js, idx.numpy(), js.resolution).gradient)
        ref = jq.project_out_of_collision(js, p.numpy(), max_steps=200)
        assert bool(ref.valid)
        np.testing.assert_allclose(proj.position.numpy(),
                                   np.asarray(ref.position), rtol=0,
                                   atol=PROJECTION_ATOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_extrema_map_both_dtypes(dtype):
    js, sdf = _planar(dtype, n=6)
    extrema = tq.compute_local_extrema_map(sdf)
    assert extrema.dtype == dtype
    assert tuple(extrema.shape) == (6, 6, 6, 3)
    with jax.enable_x64():
        _equal(extrema, jq.compute_local_extrema_map(js))


def _random_isometry(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    m = np.eye(4)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-50.0, 50.0, 3)
    return m


@pytest.mark.parametrize("seed", [0, 1])
def test_float64_transform_products_bitwise(seed):
    """400 inverses (``-R^T t``: a K = 3 FMA chain) and 400 products
    (``compose``: rounded products summed in k order) in float64, and 3x3
    products (K = 3), against XLA's."""
    rng = np.random.default_rng(seed)
    with jax.enable_x64():
        for _ in range(200):
            a, b = _random_isometry(rng), _random_isometry(rng)
            _equal(tt.invert_isometry(torch.from_numpy(a)),
                   jt.invert_isometry(jnp.asarray(a)))
            _equal(tt.compose(torch.from_numpy(a), torch.from_numpy(b)),
                   jt.compose(jnp.asarray(a), jnp.asarray(b)))
            k = rng.normal(size=(3, 3))
            _equal(tt.matmul(torch.from_numpy(k), torch.from_numpy(k)),
                   jnp.asarray(k) @ jnp.asarray(k))


def _chain(a, b, fused):
    """``a @ b`` elementwise from exact ``Fraction`` steps in k order: each
    step a fused multiply-add rounded once, or a rounded product added."""
    from fractions import Fraction
    out = np.empty((a.shape[0], b.shape[1]))
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            acc = float(Fraction(a[i, 0]) * Fraction(b[0, j]))
            for k in range(1, a.shape[1]):
                p = Fraction(a[i, k]) * Fraction(b[k, j])
                acc = float(p + Fraction(acc)) if fused else acc + float(p)
            out[i, j] = acc
    return out


@pytest.mark.parametrize("shapes,fused", [
    (((3, 3), (3, 1)), True), (((3, 3), (3, 3)), True),
    (((4, 4), (4, 4)), False)])
def test_xla_float64_dot_order(shapes, fused):
    """What ``core/transforms.matmul`` reproduces: XLA's CPU float64 dot is
    the FMA chain in k order for K = 3 and rounded products summed in k
    order for a 4x4 product (on 100 random products; the other rule
    differs on some element)."""
    rng = np.random.default_rng(12)
    other = 0
    with jax.enable_x64():
        for _ in range(100):
            a, b = rng.normal(size=shapes[0]), rng.normal(size=shapes[1])
            got = np.asarray(jnp.asarray(a) @ jnp.asarray(b))
            np.testing.assert_array_equal(got, _chain(a, b, fused))
            other += int((got != _chain(a, b, not fused)).sum())
            np.testing.assert_array_equal(
                tt.matmul(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
                got)
    assert other > 0


def test_float64_product_special_values():
    """Infinite and NaN operands give the rounded chain's results."""
    m = np.eye(4)
    m[:3, 3] = (np.inf, 1.0, -2.0)
    with jax.enable_x64():
        _equal(tt.invert_isometry(torch.from_numpy(m)),
               jt.invert_isometry(jnp.asarray(m)))


def test_f64_sdf_create_keeps_f64_origin():
    spec = GridSpec.from_voxel_counts(1.0, (4, 4, 4))
    t = np.eye(4)
    t[:3, 3] = (2.0 ** 24 + 1.0, 0.0, 0.0)
    sdf = SignedDistanceField.create(spec, torch.zeros(4, 4, 4,
                                                       dtype=torch.float64),
                                     t, dtype=torch.float64)
    assert sdf.origin_transform.dtype == torch.float64
    assert float(sdf.origin_transform[0, 3]) == 2.0 ** 24 + 1.0


@pytest.mark.cuda
def test_cuda_float64_field_matches_cpu():
    """On the card: a float64 SDF's distances, inverse, queries and
    gradients are the CPU's bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    xs, ys, zs = np.meshgrid(np.arange(24), np.arange(20), np.arange(28),
                             indexing="ij", sparse=True)
    mask = torch.from_numpy(((xs - 11) ** 2 + (ys - 9) ** 2
                             + (zs - 15) ** 2) <= 36)
    spec = GridSpec.from_voxel_counts(0.05, tuple(mask.shape))
    cpu = edt.extract_signed_distance_field(mask, spec, _posed(),
                                            dtype=torch.float64)
    card = edt.extract_signed_distance_field(mask.cuda(), spec, _posed(),
                                             dtype=torch.float64)
    assert torch.equal(card.distances.cpu(), cpu.distances)
    assert torch.equal(card.inverse_origin_transform().cpu(),
                       cpu.inverse_origin_transform())
    pts = torch.from_numpy(np.random.default_rng(4).uniform(-0.5, 1.5,
                                                            (5000, 3)))
    a = tq.estimate_location_distance(cpu, pts)
    b = tq.estimate_location_distance(card, pts.cuda())
    assert torch.equal(a.value.nan_to_num(7.0), b.value.cpu().nan_to_num(7.0))
    ga = tq.get_location_coarse_gradient(cpu, pts, True)
    gb = tq.get_location_coarse_gradient(card, pts.cuda(), True)
    assert torch.equal(ga.gradient.nan_to_num(7.0),
                       gb.gradient.cpu().nan_to_num(7.0))
