"""The PyTorch port's EDT against the JAX package, bit for bit.

Every squared distance in the EDT is an exact integer in float32 and min
is exact, so the port's plain min-plus, the JAX XLA min-plus and the JAX
best-first Pallas kernel (run in interpret mode, as tests/
test_pallas_kernels.py runs it) must agree exactly; so must the signed
fields built from them. Inputs come from numpy seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.kernels import edt_pallas
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst
from voxelized_geometry_tools_tpu_torch.ops import edt


def _field(shape, seed, lo=0.0, hi=300.0, p_inf=0.4):
    rng = np.random.default_rng(seed)
    f = rng.uniform(lo, hi, shape).astype(np.float32)
    f[rng.uniform(size=shape) < p_inf] = np.inf
    return f


def _port_envelope(f, **kw):
    return edt._parabolic_envelope_last(torch.from_numpy(f), **kw).numpy()


@pytest.mark.parametrize("shape", [(7, 13, 37), (3, 50), (1, 1, 4), (64,)])
@pytest.mark.parametrize("lo", [0.0, -80.0])
def test_envelope_matches_jax_xla_and_pallas(shape, lo):
    f = _field(shape, 3, lo=lo)
    got = _port_envelope(f)
    np.testing.assert_array_equal(
        got, np.asarray(jedt._parabolic_envelope_last(jnp.asarray(f))))
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas_bestfirst(
            jnp.asarray(f), tile_lines=8, tile_q=16, interpret=True)))


@pytest.mark.parametrize("fill", [np.inf, 0.0, 1e6])
def test_envelope_degenerate_fields(fill):
    f = np.full((6, 40), fill, np.float32)
    got = _port_envelope(f)
    np.testing.assert_array_equal(
        got, np.asarray(jedt._parabolic_envelope_last(jnp.asarray(f))))
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas_bestfirst(
            jnp.asarray(f), tile_lines=8, tile_q=8, interpret=True)))


@pytest.mark.parametrize("lines,n", [(5, 48), (260, 33), (64, 160), (7, 96)])
def test_envelope_ragged_line_counts(lines, n):
    """Line counts that are not multiples of any tile, with +inf holes."""
    rng = np.random.default_rng(77 + lines)
    f = (rng.random((lines, n)).astype(np.float32) * 100.0) - 20.0
    f[rng.random((lines, n)) < 0.3] = np.inf
    f[:, n // 3] = 0.0
    got = _port_envelope(f)
    np.testing.assert_array_equal(
        got, np.asarray(jedt._parabolic_envelope_last(jnp.asarray(f), 64)))
    np.testing.assert_array_equal(
        got, np.asarray(edt_pallas.parabolic_envelope_last_pallas_bestfirst(
            jnp.asarray(f), tile_lines=128, tile_q=16, interpret=True)))


def test_envelope_sparse_seeds_long_axis():
    rng = np.random.default_rng(5)
    f = np.where(rng.random((8, 96, 300)) < 0.02, 0.0, np.inf)
    f = f.astype(np.float32)
    f[0, 0, 17] = 0.0
    np.testing.assert_array_equal(
        _port_envelope(f),
        np.asarray(jedt._parabolic_envelope_last(jnp.asarray(f))))


@pytest.mark.parametrize("block", [1, 8, 64, 512])
def test_envelope_block_and_line_chunking_invariant(block, monkeypatch):
    """The plain version chunks over k (``block``) and over lines (capped
    candidate tensor); neither may change a bit."""
    f = _field((9, 11, 45), 9, lo=-10.0)
    ref = np.asarray(jedt._parabolic_envelope_last(jnp.asarray(f)))
    np.testing.assert_array_equal(_port_envelope(f, block=block), ref)
    monkeypatch.setattr(edt_bestfirst, "PLAIN_CANDIDATES", 45 * 8 * 7)
    np.testing.assert_array_equal(_port_envelope(f, block=block), ref)


def test_wrapper_takes_plain_version_on_cpu():
    f = _field((4, 5, 21), 1)
    before = edt_bestfirst.launches
    got = edt_bestfirst.parabolic_envelope_last(torch.from_numpy(f))
    assert edt_bestfirst.launches == before
    np.testing.assert_array_equal(got.numpy(), _port_envelope(f))


@pytest.mark.parametrize("shape", [(3, 16, 32), (2, 37, 45), (1, 5, 1)])
def test_chunk_minima_over_ragged_edges(shape):
    """The kernel's per-(line block, chunk) bound minima: the minimum over
    real entries only (ragged edges never lower or hide a minimum)."""
    f = _field(shape, 11, lo=-5.0, p_inf=0.5)
    b, n, lines = shape
    cm = edt_bestfirst._chunk_minima(torch.from_numpy(f)).numpy()
    n_ch = -(-n // edt_bestfirst.CHUNK)
    n_lb = -(-lines // edt_bestfirst.WARP_LINES)
    assert cm.shape == (b, n_lb, n_ch)
    for i in range(b):
        for lb in range(n_lb):
            for c in range(n_ch):
                blk = f[i, c * 16:(c + 1) * 16, lb * 32:(lb + 1) * 32]
                assert cm[i, lb, c] == blk.min()


@pytest.mark.parametrize("seed", [7, 8, 9])
def test_squared_edt_matches_jax(seed):
    mask = np.random.default_rng(seed).uniform(size=(24, 17, 33)) < 0.1
    np.testing.assert_array_equal(
        edt.squared_edt(torch.from_numpy(mask)).numpy(),
        np.asarray(jedt.squared_edt(jnp.asarray(mask), backend="xla")))


@pytest.mark.parametrize("full", [False, True])
def test_squared_edt_empty_and_full(full):
    mask = np.full((4, 5, 6), full)
    got = edt.squared_edt(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jedt.squared_edt(jnp.asarray(mask), backend="xla")))
    assert np.all(got == 0.0) if full else np.all(np.isinf(got))


def _fixture_masks():
    masks = {}
    m = np.zeros((1, 1, 4), bool)
    m[0, 0, 0:2] = True
    masks["linear"] = (m, 1.0)
    m = np.zeros((1, 4, 4), bool)
    m[0, 0:2, 0:2] = True
    masks["planar"] = (m, 1.0)
    m = np.zeros((2, 2, 2), bool)
    m[0, 0, 0] = True
    masks["cube"] = (m, 1.0)
    for name, box in [("center", np.s_[1:3, 2:6, 3:9]),
                      ("corner", np.s_[0:2, 0:4, 0:6]),
                      ("face", np.s_[:, :, 0])]:
        m = np.zeros((4, 8, 12), bool)
        m[box] = True
        masks[name] = (m, 0.25)
    masks["empty"] = (np.zeros((4, 8, 12), bool), 0.25)
    masks["full"] = (np.ones((4, 8, 12), bool), 0.25)
    rng = np.random.default_rng(21)
    masks["random"] = (rng.random((24, 17, 33)) < 0.3, 0.05)
    masks["random_sparse"] = (rng.random((19, 30, 26)) < 0.02, 0.01)
    return masks


_MASKS = _fixture_masks()


@pytest.mark.parametrize("name", sorted(_MASKS))
def test_signed_distance_matches_jax(name):
    mask, res = _MASKS[name]
    np.testing.assert_array_equal(
        edt.signed_distance_from_filled_mask(
            torch.from_numpy(mask), res).numpy(),
        np.asarray(jedt.signed_distance_from_filled_mask(
            jnp.asarray(mask), res)))


@pytest.mark.parametrize("name", ["center", "empty", "full", "random"])
def test_virtual_border_matches_jax(name):
    mask, res = _MASKS[name]
    np.testing.assert_array_equal(
        edt.signed_distance_with_virtual_border(
            torch.from_numpy(mask), res).numpy(),
        np.asarray(jedt.signed_distance_with_virtual_border(
            jnp.asarray(mask), res)))


@pytest.mark.parametrize("border", [False, True])
def test_extract_sdf_from_occupancy_tutorial_grid(border):
    """The tutorial grid: 1 x 2 x 3 m at 0.25 m -> (4, 8, 12) voxels with a
    center box filled: min -0.25, max sqrt(14) * 0.25 (without border)."""
    jspec = JGridSpec.from_grid_sizes(0.25, (1.0, 2.0, 3.0))
    spec = GridSpec.from_grid_sizes(0.25, (1.0, 2.0, 3.0))
    assert spec.counts == jspec.counts == (4, 8, 12)
    occ = np.zeros(spec.counts, np.float32)
    occ[1:3, 2:6, 3:9] = 1.0
    occ[0, 0, 0] = 0.5  # unknown counts as filled by default
    ref = jedt.extract_sdf_from_occupancy(occ, jspec, None,
                                          add_virtual_border=border)
    got = edt.extract_sdf_from_occupancy(torch.from_numpy(occ), spec, None,
                                         add_virtual_border=border)
    assert got.locked
    np.testing.assert_array_equal(got.distances.numpy(),
                                  np.asarray(ref.distances))
    assert float(got.minimum) == float(ref.minimum)
    assert float(got.maximum) == float(ref.maximum)
    if not border:
        occ[0, 0, 0] = 0.0
        got = edt.extract_sdf_from_occupancy(torch.from_numpy(occ), spec,
                                             None)
        assert abs(float(got.minimum) - (-0.25)) < 1e-6
        assert abs(float(got.maximum) - np.sqrt(14.0) * 0.25) < 1e-6


@pytest.mark.parametrize("unknown_is_filled", [False, True])
def test_extract_unknown_handling_matches_jax(unknown_is_filled):
    occ = np.array([1.0, 0.5, 0.0, 0.0], np.float32).reshape(1, 1, 4)
    ref = jedt.extract_sdf_from_occupancy(
        occ, JGridSpec.from_voxel_counts(1.0, (1, 1, 4)), None,
        unknown_is_filled=unknown_is_filled)
    got = edt.extract_sdf_from_occupancy(
        torch.from_numpy(occ), GridSpec.from_voxel_counts(1.0, (1, 1, 4)),
        None, unknown_is_filled=unknown_is_filled)
    np.testing.assert_array_equal(got.distances.numpy(),
                                  np.asarray(ref.distances))


def test_float64_combine():
    mask, res = _MASKS["center"]
    got = edt.signed_distance_from_filled_mask(torch.from_numpy(mask), res,
                                               dtype=torch.float64)
    assert got.dtype == torch.float64
    f32 = edt.signed_distance_from_filled_mask(torch.from_numpy(mask), res)
    np.testing.assert_allclose(got.numpy(), f32.numpy(), atol=1e-6)


def test_backend_errors():
    """The JAX package's backend names resolve to their counterparts; a
    kernel backend on a CPU tensor raises ValueError, an unknown name
    too."""
    mask = torch.from_numpy(_MASKS["random"][0])
    for backend in ("cuda-bestfirst", "cuda-envelope", "cuda-windowed",
                    "pallas", "pallas-windowed", "pallas-bestfirst"):
        with pytest.raises(ValueError, match="CUDA tensor"):
            edt.squared_edt(mask, backend=backend)
        with pytest.raises(ValueError, match="CUDA tensor"):
            edt.signed_distance_from_filled_mask(mask, 0.1, backend=backend)
    with pytest.raises(ValueError, match="Unknown EDT backend"):
        edt.squared_edt(mask, backend="bogus")
    for backend in ("plain", "xla"):
        np.testing.assert_array_equal(
            edt.squared_edt(mask, backend=backend).numpy(),
            edt.squared_edt(mask).numpy())
    assert edt._resolve_edt_backend("pallas-windowed", mask) == "cuda-windowed"


def test_streaming_raises():
    """Streaming no longer raises: ``streaming=True`` and a grid at the
    640^3 switch (lowered here so a small grid reaches it) take the
    slab-streamed pipeline and give the dense bits."""
    mask, res = _MASKS["random"]
    spec = GridSpec.from_voxel_counts(res, mask.shape)
    dense = edt.extract_signed_distance_field(torch.from_numpy(mask), spec,
                                              None, streaming=False)
    streamed = edt.extract_signed_distance_field(torch.from_numpy(mask), spec,
                                                 None, streaming=True)
    np.testing.assert_array_equal(streamed.distances.numpy(),
                                  dense.distances.numpy())
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(edt, "_STREAMING_AUTO_VOXELS", spec.num_total)
        auto = edt.extract_signed_distance_field(torch.from_numpy(mask), spec,
                                                 None)
    np.testing.assert_array_equal(auto.distances.numpy(),
                                  dense.distances.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_sqrt_is_correctly_rounded(dtype):
    """The combine's sqrt against numpy's (correctly rounded) on every
    squared distance of a 512-voxel axis; PyTorch's own CPU sqrt misses
    thousands of them in both types."""
    x = np.arange(3 * 512 * 512, dtype=np.float32)
    got = edt._sqrt(torch.from_numpy(x), getattr(torch, dtype)).numpy()
    np.testing.assert_array_equal(
        got, np.sqrt(x.astype(np.float64)).astype(dtype))


@pytest.mark.parametrize("name", ["center", "random", "random_sparse"])
def test_float64_signed_distance_matches_jax(name):
    """The float64 combine bit for bit against the JAX package's (with
    PyTorch's CPU sqrt it differed by one ulp on some voxels)."""
    mask, res = _MASKS[name]
    got = edt.signed_distance_from_filled_mask(torch.from_numpy(mask), res,
                                               dtype=torch.float64).numpy()
    with jax.enable_x64(True):
        ref = np.asarray(jedt.signed_distance_from_filled_mask(
            jnp.asarray(mask), res, dtype=jnp.float64))
    assert got.dtype == ref.dtype == np.float64
    np.testing.assert_array_equal(got, ref)


def test_non_uniform_spec_rejected():
    spec = GridSpec.from_voxel_sizes((0.5, 1.0, 2.0), (2, 2, 2))
    with pytest.raises(ValueError, match="uniform"):
        edt.extract_sdf_from_occupancy(torch.zeros((2, 2, 2)), spec, None)
