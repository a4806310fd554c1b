"""The port's slab-streamed EDT against the JAX package's and against the
port's dense path, bit for bit (tolerance 0).

The streamed pipeline runs the dense path's per-line math slab by slab, so
its results must equal the dense ones exactly, and the JAX package's
streamed results (``backend="xla"``). Its schedule (slab sizes, the pad
branch for divisor-poor axes, the slab axis) must be the JAX package's, so
the number of envelope calls per field is what that schedule implies.
Shapes follow tests/test_edt.py's streamed tests; inputs come from numpy
seeds.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.ops import edt


def _seed(shape, seed, p=0.02):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < p
    mask[tuple(s // 2 for s in shape)] = True
    return mask


@pytest.mark.parametrize("target", [1, 3, 8, 128])
def test_slab_schedule_matches_jax(target):
    for n in range(1, 65):
        assert edt._slab_schedule(n, target) == jedt._slab_schedule(n, target)
        assert (edt._largest_divisor_at_most(n, target)
                == jedt._largest_divisor_at_most(n, target))
        slab, pad = edt._slab_schedule(n, target)
        slabs = edt._slabs(n, target)
        assert len(slabs) == (n + pad) // slab
        assert sum(w for _, w in slabs) == n
        assert [s for s, _ in slabs] == list(range(0, n + pad, slab))
    # The pad branch is taken for a prime axis.
    assert edt._slab_schedule(13, 8) == (8, 3)
    assert edt._slabs(13, 8) == [(0, 8), (8, 5)]


def test_streamed_slab_axis_matches_jax():
    for shape in [(8, 8, 8), (4, 40, 6), (40, 4, 6), (6, 4, 40), (5, 9, 9),
                  (9, 5, 9), (1, 1, 4)]:
        for axis in range(3):
            assert (edt._streamed_slab_axis(shape, axis)
                    == jedt._streamed_slab_axis(shape, axis))


@pytest.mark.parametrize("slab", [3, 7, 8, 28])
def test_streamed_squared_edt_matches_jax_and_dense(slab):
    mask = _seed((20, 24, 28), 11)
    got = edt.squared_edt_streamed(torch.from_numpy(mask), slab=slab).numpy()
    np.testing.assert_array_equal(
        got, edt.squared_edt(torch.from_numpy(mask)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jedt.squared_edt_streamed(
            jnp.asarray(mask), slab=slab, backend="xla")))


@pytest.mark.parametrize("shape", [(13, 17, 19), (4, 40, 6), (40, 4, 6),
                                   (6, 4, 40)])
def test_streamed_prime_and_anisotropic_shapes(shape):
    """Prime axes take the pad branch; anisotropic grids slab over their
    largest perpendicular axis."""
    mask = _seed(shape, 13, p=0.05)
    got = edt.squared_edt_streamed(torch.from_numpy(mask), slab=8).numpy()
    np.testing.assert_array_equal(
        got, edt.squared_edt(torch.from_numpy(mask)).numpy())
    np.testing.assert_array_equal(
        got, np.asarray(jedt.squared_edt_streamed(
            jnp.asarray(mask), slab=8, backend="xla")))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_streamed_signed_distance_matches_jax_and_dense(dtype, monkeypatch):
    """Both dtypes of the combine; a small combine step makes the chunked
    in-place sqrt take several steps, with a ragged last one."""
    monkeypatch.setattr(edt, "_COMBINE_CHUNK", 1000)
    mask, res = _seed((20, 24, 28), 17, p=0.3), 0.05
    tdtype = getattr(torch, dtype)
    got = edt.signed_distance_from_filled_mask_streamed(
        torch.from_numpy(mask), res, slab=5, dtype=tdtype)
    assert got.dtype == tdtype
    np.testing.assert_array_equal(
        got.numpy(), edt.signed_distance_from_filled_mask(
            torch.from_numpy(mask), res, dtype=tdtype).numpy())
    with jax.enable_x64(dtype == "float64"):
        ref = np.asarray(jedt.signed_distance_from_filled_mask_streamed(
            jnp.asarray(mask), res, slab=5, dtype=getattr(jnp, dtype),
            backend="xla"))
    assert ref.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(got.numpy(), ref)


@pytest.mark.parametrize("border", [False, True])
def test_extract_streaming_matches_dense_and_jax(border):
    mask, res = _seed((20, 24, 28), 19, p=0.1), 0.05
    spec = GridSpec.from_voxel_counts(res, mask.shape)
    streamed = edt.extract_signed_distance_field(
        torch.from_numpy(mask), spec, None, add_virtual_border=border,
        streaming=True)
    dense = edt.extract_signed_distance_field(
        torch.from_numpy(mask), spec, None, add_virtual_border=border,
        streaming=False)
    ref = jedt.extract_signed_distance_field(
        jnp.asarray(mask), JGridSpec.from_voxel_counts(res, mask.shape), None,
        add_virtual_border=border, streaming=True)
    np.testing.assert_array_equal(streamed.distances.numpy(),
                                  dense.distances.numpy())
    np.testing.assert_array_equal(streamed.distances.numpy(),
                                  np.asarray(ref.distances))
    assert float(streamed.minimum) == float(ref.minimum)
    assert float(streamed.maximum) == float(ref.maximum)


def test_streaming_auto_switch(monkeypatch):
    """``streaming=None`` streams at and above ``_STREAMING_AUTO_VOXELS``
    (640^3 in the JAX package; lowered here so a small grid crosses it)."""
    calls = []
    streamed = edt.signed_distance_from_filled_mask_streamed

    def spy(*args, **kwargs):
        calls.append(args[0].shape)
        return streamed(*args, **kwargs)

    monkeypatch.setattr(edt, "signed_distance_from_filled_mask_streamed", spy)
    assert edt._STREAMING_AUTO_VOXELS == jedt._STREAMING_AUTO_VOXELS
    mask = _seed((12, 10, 14), 23, p=0.1)
    spec = GridSpec.from_voxel_counts(0.1, mask.shape)
    monkeypatch.setattr(edt, "_STREAMING_AUTO_VOXELS", spec.num_total + 1)
    below = edt.extract_signed_distance_field(torch.from_numpy(mask), spec,
                                              None)
    assert calls == []
    monkeypatch.setattr(edt, "_STREAMING_AUTO_VOXELS", spec.num_total)
    at = edt.extract_signed_distance_field(torch.from_numpy(mask), spec, None)
    assert calls == [mask.shape]
    np.testing.assert_array_equal(at.distances.numpy(),
                                  below.distances.numpy())


def _jax_envelope_calls(shape, slab):
    """Envelope calls of one streamed field under the JAX schedule."""
    calls = 0
    for axis in (1, 2):
        if shape[axis] > 1:
            n_s = shape[jedt._streamed_slab_axis(shape, axis)]
            size, pad = jedt._slab_schedule(n_s, slab)
            calls += (n_s + pad) // size
    return calls


@pytest.mark.parametrize("shape,slab", [((20, 24, 28), 8), ((13, 17, 19), 8),
                                        ((6, 4, 40), 3), ((5, 1, 9), 4)])
def test_streamed_envelope_calls_follow_the_jax_schedule(shape, slab,
                                                         monkeypatch):
    calls = []
    envelope = edt._envelope_last

    def spy(f, block, backend):
        calls.append(f.shape)
        return envelope(f, block, backend)

    monkeypatch.setattr(edt, "_envelope_last", spy)
    mask = _seed(shape, 29, p=0.1)
    edt.signed_distance_from_filled_mask_streamed(torch.from_numpy(mask), 0.1,
                                                  slab=slab)
    assert len(calls) == 2 * _jax_envelope_calls(shape, slab)


def test_streamed_backend_names():
    """The streamed path takes the same backend names; a kernel backend
    refuses a CPU tensor there too."""
    mask = torch.from_numpy(_seed((9, 10, 11), 31, p=0.1))
    ref = edt.squared_edt(mask).numpy()
    for backend in ("xla", "plain", "auto"):
        np.testing.assert_array_equal(
            edt.squared_edt_streamed(mask, slab=4, backend=backend).numpy(),
            ref)
    for backend in ("pallas-bestfirst", "cuda-windowed"):
        with pytest.raises(ValueError, match="needs a CUDA tensor"):
            edt.squared_edt_streamed(mask, slab=4, backend=backend)
