"""The port's slab-streamed signed EDT against the benchmark's plain
reference (``portbench/reference/edt.py``, plain PyTorch that imports
nothing of the port), and the mapper's own ``sdf()`` on the streamed path.

Every tolerance is 0, for the reason the benchmark's check on the card
uses: squared distances in voxels are whole numbers below 2^24, exact in
float32 in both programs, and each square root is correctly rounded in
both (a float64 square root, rounded once to float32 where the field is
float32), so the signed fields must agree bit for bit. The float64 field
has no float64 twin in the reference; it is held against the reference's
exact squared distances combined in float64 with the same formula,
``sqrt(d2 to filled) * res - sqrt(d2 to free) * res``.

Masks are seeded; the grids are anisotropic, and the prime axes (13, 17,
19, 23) take ``_slab_schedule``'s pad branch at slab 8.
"""

import numpy as np
import pytest
import torch

from portbench.reference import edt as ref_edt
from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
    OnlineMapper)
from voxelized_geometry_tools_tpu_torch.ops import edt, voxelize

SHAPES = [(13, 17, 19), (24, 10, 6), (6, 23, 16), (9, 8, 40)]
RES = 0.05


def _mask(shape, seed, p):
    rng = np.random.default_rng(seed)
    mask = rng.random(shape) < p
    mask[tuple(s // 2 for s in shape)] = True
    return torch.from_numpy(mask)


def test_shapes_take_the_pad_branch():
    """At least one slab axis of the shapes is divisor-poor at slab 8."""
    padded = [shape for shape in SHAPES for axis in range(3)
              if edt._slab_schedule(
                  shape[edt._streamed_slab_axis(shape, axis)], 8)[1]]
    assert padded


@pytest.mark.parametrize("p", [0.05, 0.4])
@pytest.mark.parametrize("shape", SHAPES)
def test_streamed_signed_distance_matches_reference(shape, p):
    mask = _mask(shape, 2011 + sum(shape), p)
    got = edt.signed_distance_from_filled_mask_streamed(mask, RES, slab=8)
    ref = ref_edt.signed_distance(mask, RES)
    assert got.dtype == ref.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), ref.numpy())


@pytest.mark.parametrize("shape", SHAPES)
def test_streamed_float64_matches_reference_squares(shape):
    mask = _mask(shape, 2012 + sum(shape), 0.2)
    got = edt.signed_distance_from_filled_mask_streamed(
        mask, RES, slab=8, dtype=torch.float64)
    res = np.float64(RES)
    to_filled = np.sqrt(ref_edt.squared_distance(mask).double().numpy())
    to_free = np.sqrt(ref_edt.squared_distance(~mask).double().numpy())
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), to_filled * res - to_free * res)


@pytest.mark.parametrize("fill", [False, True])
def test_streamed_uniform_masks_match_reference(fill):
    """An empty grid is +inf everywhere, a full one -inf."""
    mask = torch.full((13, 9, 6), fill)
    got = edt.signed_distance_from_filled_mask_streamed(mask, RES, slab=8)
    np.testing.assert_array_equal(got.numpy(),
                                  ref_edt.signed_distance(mask, RES).numpy())
    assert bool(torch.isinf(got).all())


def _clouds(n):
    g = torch.Generator().manual_seed(21)
    clouds = []
    for c in range(n):
        pts = torch.rand(300, 3, generator=g) * torch.tensor([6.0, 5.0, 3.0])
        pose = torch.eye(4)
        pose[:3, 3] = torch.tensor([1.0 + 0.5 * c, 1.0, 0.5])
        clouds.append(voxelize.PointCloud.create(pts, pose, max_range=6.0,
                                                 device="cpu"))
    return clouds


@pytest.mark.parametrize("unknown_is_filled", [True, False])
def test_mapper_sdf_on_the_streamed_path(monkeypatch, unknown_is_filled):
    """With the size rule lowered to 0, ``OnlineMapper.sdf()`` takes the
    streamed EDT by its own choice; its field equals the reference's EDT of
    the mapper's occupancy and the dense path's field."""
    monkeypatch.setattr(edt, "_STREAMING_AUTO_VOXELS", 0)
    spec = GridSpec.from_voxel_counts(0.25, (40, 32, 24))
    mapper = OnlineMapper(spec, device="cpu", carve_run_axis=-1)
    for cloud in _clouds(2):
        mapper.integrate(cloud)
    occupancy = mapper.occupancy_map.occupancy
    assert bool((occupancy == 0.0).any()) and bool((occupancy == 1.0).any())

    slabs = edt.streamed_slabs
    got = mapper.sdf(unknown_is_filled=unknown_is_filled).distances
    assert edt.streamed_slabs > slabs

    filled = ref_edt.filled_from_occupancy(occupancy, unknown_is_filled)
    np.testing.assert_array_equal(
        got.numpy(), ref_edt.signed_distance(filled, spec.resolution).numpy())
    dense = edt.extract_sdf_from_occupancy(
        occupancy, spec, mapper.occupancy_map.origin_transform,
        unknown_is_filled=unknown_is_filled, streaming=False)
    np.testing.assert_array_equal(got.numpy(), dense.distances.numpy())
