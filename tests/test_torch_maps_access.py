"""The port's map classes and cell access against the JAX package: ports
of tests/test_cell_access.py's map tests, and the three component and
tagged classes held bit for bit against their JAX twins through random
``set_index`` / ``get_index`` / ``set_location`` / ``get_location`` calls
(duplicate lanes, out-of-bounds and negative lanes, a rotated origin)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import voxelized_geometry_tools_tpu as jvgt
from voxelized_geometry_tools_tpu_torch import (
    GridSpec, OccupancyComponentMap, OccupancyMap, SignedDistanceField,
    TaggedObjectOccupancyComponentMap, TaggedObjectOccupancyMap, interop)


def make_map():
    spec = GridSpec.from_voxel_counts(0.5, (4, 5, 6))
    return OccupancyMap.create(spec, None, "f", device="cpu")


def test_get_set_index_roundtrip():
    m = make_map()
    idx = torch.tensor([[1, 2, 3], [0, 0, 0]])
    m2 = m.set_index(idx, occupancy=torch.tensor([1.0, 0.5]))
    values, valid = m2.get_index(idx)
    assert bool(valid.all())
    np.testing.assert_allclose(values["occupancy"].numpy(), [1.0, 0.5])
    assert float(m.occupancy[1, 2, 3]) == 0.0  # functional


def test_out_of_bounds_get_set():
    m = make_map()
    oob = torch.tensor([[9, 9, 9]])
    _, valid = m.get_index(oob)
    assert not bool(valid[0])
    m2 = m.set_index(oob, occupancy=1.0)
    assert torch.equal(m2.occupancy, m.occupancy)


def test_location_accessors_respect_origin():
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    origin = np.eye(4, dtype=np.float32)
    origin[:3, 3] = (10.0, 0.0, 0.0)
    m = OccupancyMap.create(spec, origin, "f", device="cpu")
    m = m.set_location(torch.tensor([10.1, 0.1, 0.1]), occupancy=1.0)
    values, valid = m.get_location(torch.tensor([10.1, 0.1, 0.1, 1.0]))
    assert bool(valid)
    assert float(values["occupancy"]) == 1.0
    assert float(m.occupancy[0, 0, 0]) == 1.0


def test_component_cache_invalidation_on_set():
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    m = OccupancyComponentMap.create(spec, None, "f", device="cpu")
    m = m.replace(components_valid=True)
    m2 = m.set_index(torch.tensor([1, 1, 1]), occupancy=1.0)
    assert not m2.components_valid
    assert not m.replace(components_valid=True).set_occupancy(
        m.occupancy).components_valid


def test_tagged_multichannel_set():
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    m = TaggedObjectOccupancyMap.create(spec, None, "f", device="cpu")
    m = m.set_index(torch.tensor([2, 2, 2]), occupancy=1.0, object_id=7)
    values, _ = m.get_index(torch.tensor([2, 2, 2]))
    assert float(values["occupancy"]) == 1.0
    assert int(values["object_id"]) == 7
    assert values["object_id"].dtype == torch.uint32


def test_sdf_get_index_still_distance_specific():
    spec = GridSpec.from_voxel_counts(0.5, (3, 3, 3))
    sdf = SignedDistanceField.create(spec, torch.ones(spec.counts), None, "f")
    assert np.isinf(float(sdf.get_index(torch.tensor([9, 9, 9]))))


def test_oob_set_does_not_clobber_valid_duplicate():
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    m = OccupancyMap.create(spec, None, "f", device="cpu")
    m2 = m.set_index(torch.tensor([[3, 3, 3], [5, 3, 3]]),
                     occupancy=torch.tensor([1.0, 0.7]))
    assert float(m2.occupancy[3, 3, 3]) == 1.0


def test_negative_index_set_dropped():
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    m = OccupancyMap.create(spec, None, "f", device="cpu")
    m2 = m.set_index(torch.tensor([[-1, 0, 0]]), occupancy=1.0)
    assert torch.equal(m2.occupancy, m.occupancy)


def test_locked_sdf_set_index_raises():
    spec = GridSpec.from_voxel_counts(0.5, (3, 3, 3))
    sdf = SignedDistanceField.create(spec, torch.ones(spec.counts), None, "f",
                                     locked=True)
    with pytest.raises(ValueError, match="locked"):
        sdf.set_index(torch.tensor([0, 0, 0]), distances=-5.0)
    sdf2 = sdf.unlock().set_index(torch.tensor([0, 0, 0]), distances=-5.0)
    mn, _ = sdf2.get_minimum_maximum()
    assert float(mn) == -5.0


def test_sdf_get_location_keeps_dict_contract():
    spec = GridSpec.from_voxel_counts(0.5, (3, 3, 3))
    sdf = SignedDistanceField.create(spec, torch.ones(spec.counts), None, "f")
    values, valid = sdf.get_location(torch.tensor([0.1, 0.1, 0.1]))
    assert bool(valid)
    assert float(values["distances"]) == 1.0


def test_unknown_channel_and_negative_uint32_raise():
    spec = GridSpec.from_voxel_counts(0.5, (4, 4, 4))
    m = TaggedObjectOccupancyMap.create(spec, None, "f", device="cpu")
    with pytest.raises(ValueError, match="Unknown channel"):
        m.set_index(torch.tensor([0, 0, 0]), color=1)
    with pytest.raises(OverflowError):  # as numpy (and JAX) convert it
        m.set_index(torch.tensor([0, 0, 0]), object_id=-1)


def test_map_geometry_members_match_jax():
    """``counts``, ``num_total_voxels`` and the world-frame
    ``grid_index_to_location`` (elementwise, in JAX's order: bitwise)."""
    rng = np.random.default_rng(11)
    origin = _rotated_origin(rng)
    jm = jvgt.OccupancyMap.create(
        jvgt.GridSpec.from_voxel_counts(0.1, (5, 6, 7)), origin, "w")
    tm = OccupancyMap.create(GridSpec.from_voxel_counts(0.1, (5, 6, 7)),
                             origin, "w", device="cpu")
    assert tm.counts == jm.counts and tm.num_total_voxels == 210
    idx = rng.integers(-2, 9, (300, 3)).astype(np.int32)
    ref = np.asarray(jm.grid_index_to_location(jnp.asarray(idx)))
    got = tm.grid_index_to_location(torch.from_numpy(idx)).numpy()
    np.testing.assert_array_equal(got, ref)
    flat = torch.arange(210, dtype=torch.int32)
    unflat = tm.spec.unflatten_index(flat)
    assert unflat.dtype == torch.int32
    np.testing.assert_array_equal(
        unflat.numpy(), np.asarray(jm.spec.unflatten_index(jnp.arange(210))))


def _rotated_origin(rng):
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = q
    m[:3, 3] = rng.uniform(-1.0, 1.0, 3)
    return m


CLASSES = {
    "component": (jvgt.OccupancyComponentMap, OccupancyComponentMap,
                  ("occupancy", "component")),
    "tagged": (jvgt.TaggedObjectOccupancyMap, TaggedObjectOccupancyMap,
               ("occupancy", "object_id")),
    "tagged_component": (jvgt.TaggedObjectOccupancyComponentMap,
                         TaggedObjectOccupancyComponentMap,
                         ("occupancy", "object_id", "component",
                          "spatial_segment")),
}


def _check_map(jm, tm, channels):
    for name in channels:
        ref = np.asarray(getattr(jm, name))
        got = getattr(tm, name).numpy()
        assert got.dtype == ref.dtype, name
        np.testing.assert_array_equal(got, ref, err_msg=name)
    for flag in ("components_valid", "spatial_segments_valid"):
        assert getattr(tm, flag, None) == getattr(jm, flag, None)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_three_classes_bitwise_against_jax(kind):
    """Random writes with duplicate, out-of-bounds and negative lanes (the
    last valid lane of a cell wins, as in the JAX package's scatter), then
    reads by index and by world location under a rotated origin."""
    jcls, tcls, channels = CLASSES[kind]
    rng = np.random.default_rng(5)
    counts = (6, 5, 7)
    origin = _rotated_origin(rng)
    kwargs = dict(default_occupancy=0.5)
    if "object_id" in channels:
        kwargs["default_object_id"] = 4_000_000_000
    jm = jcls.create(jvgt.GridSpec.from_voxel_counts(0.2, counts), origin,
                     "w", **kwargs)
    tm = tcls.create(GridSpec.from_voxel_counts(0.2, counts), origin, "w",
                     device="cpu", **kwargs)
    if hasattr(jm, "components_valid"):
        jm = jm.replace(components_valid=True)
        tm = tm.replace(components_valid=True)
    _check_map(jm, tm, channels)
    for step in range(4):
        idx = rng.integers(-2, 8, (500, 3)).astype(np.int32)
        values = {"occupancy": rng.uniform(0, 1, 500).astype(np.float32)}
        for name in channels[1:]:
            values[name] = rng.integers(0, 2 ** 32, 500, dtype=np.uint32)
        jm = jm.set_index(jnp.asarray(idx),
                          **{k: jnp.asarray(v) for k, v in values.items()})
        tm = tm.set_index(torch.from_numpy(idx),
                          **{k: torch.from_numpy(v)
                             for k, v in values.items()})
        _check_map(jm, tm, channels)
        # A scalar broadcast over every lane.
        jm = jm.set_index(jnp.asarray(idx[:40]), occupancy=0.25)
        tm = tm.set_index(torch.from_numpy(idx[:40]), occupancy=0.25)
        _check_map(jm, tm, channels)
    probe = rng.integers(-2, 8, (400, 3)).astype(np.int32)
    jv, jvalid = jm.get_index(jnp.asarray(probe))
    tv, tvalid = tm.get_index(torch.from_numpy(probe))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    assert sorted(tv) == sorted(jv)
    for name in jv:
        np.testing.assert_array_equal(tv[name].numpy(), np.asarray(jv[name]))
    pts = rng.uniform(-1.5, 2.5, (400, 3)).astype(np.float32)
    jv, jvalid = jm.get_location(jnp.asarray(pts))
    tv, tvalid = tm.get_location(torch.from_numpy(pts))
    np.testing.assert_array_equal(tvalid.numpy(), np.asarray(jvalid))
    for name in jv:
        np.testing.assert_array_equal(tv[name].numpy(), np.asarray(jv[name]))
    jm = jm.set_location(jnp.asarray(pts), occupancy=1.0)
    tm = tm.set_location(torch.from_numpy(pts), occupancy=1.0)
    _check_map(jm, tm, channels)


@pytest.mark.parametrize("kind", sorted(CLASSES))
def test_three_classes_interop_round_trip(kind):
    """A JAX map's arrays, as numpy, make an equal port map."""
    jcls, tcls, channels = CLASSES[kind]
    rng = np.random.default_rng(8)
    kwargs = {"default_object_id": 3} if "object_id" in channels else {}
    jm = jcls.create(jvgt.GridSpec.from_voxel_counts(0.2, (4, 5, 3)),
                     _rotated_origin(rng), "w", **kwargs)
    jm = jm.set_index(jnp.asarray([[1, 2, 1], [3, 0, 2]]), occupancy=1.0,
                      **{name: 2 ** 31 + 5 for name in channels[1:]})
    if hasattr(jm, "components_valid"):
        jm = jm.replace(components_valid=True)
    state = {name: np.asarray(getattr(jm, name)) for name in channels}
    spec = interop.grid_spec_from_fields(jm.spec.counts, jm.spec.resolution)
    fn = getattr(interop, {
        "component": "occupancy_component_map_from_numpy",
        "tagged": "tagged_object_occupancy_map_from_numpy",
        "tagged_component":
            "tagged_object_occupancy_component_map_from_numpy"}[kind])
    counters = {k: np.asarray(getattr(jm, k)) for k in (
        "number_of_components", "number_of_spatial_segments")
        if hasattr(jm, k)}
    flags = {k: getattr(jm, k) for k in (
        "components_valid", "spatial_segments_valid") if hasattr(jm, k)}
    tm = fn(spec, origin_transform=np.asarray(jm.origin_transform),
            frame=jm.frame, device="cpu", **state, **counters, **flags)
    assert isinstance(tm, tcls)
    _check_map(jm, tm, channels)
    for name, value in counters.items():
        assert int(getattr(tm, name)) == int(value)


@pytest.mark.cuda
def test_cuda_cell_access_matches_cpu():
    """On the card: the same writes (duplicate lanes included) and reads
    give the CPU's bits, uint32 channels too."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(3)
    spec = GridSpec.from_voxel_counts(0.2, (6, 5, 7))
    maps = [TaggedObjectOccupancyComponentMap.create(spec, None, "w",
                                                     device=d)
            for d in ("cpu", "cuda")]
    for _ in range(3):
        idx = torch.from_numpy(rng.integers(-2, 8, (5000, 3)))
        occ = torch.from_numpy(rng.uniform(0, 1, 5000).astype(np.float32))
        oid = torch.from_numpy(rng.integers(0, 2 ** 32, 5000,
                                            dtype=np.uint32))
        maps = [m.set_index(idx.to(m.occupancy.device), occupancy=occ,
                            object_id=oid) for m in maps]
    cpu, card = maps
    for name in ("occupancy", "object_id"):
        assert torch.equal(getattr(card, name).cpu().view(torch.int32),
                           getattr(cpu, name).view(torch.int32))
    probe = torch.from_numpy(rng.integers(-2, 8, (1000, 3)))
    a, va = cpu.get_index(probe)
    b, vb = card.get_index(probe.cuda())
    assert torch.equal(va, vb.cpu())
    for name in a:
        assert torch.equal(a[name].view(torch.int32),
                           b[name].cpu().view(torch.int32))
