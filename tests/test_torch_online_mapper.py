"""The port's online mapper (``models/online_mapper.py``) against the JAX
package's: the port's versions of tests/test_online_mapper.py's tests that
do not mesh, the occupancy and SDF bit for bit against the JAX mapper run
op by op (``jax.disable_jit()``, as in tests/test_torch_voxelize.py) after
``integrate`` and after ``integrate_frames`` under a rotated grid origin,
the carve route on each device, and a JAX mapper's state continued in the
port."""

import numpy as np
import jax
import pytest
import torch

from test_online_mapper import _plane_cloud
from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core import transforms as jt
from voxelized_geometry_tools_tpu.models.online_mapper import (
    OnlineMapper as JOnlineMapper)
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.core import transforms as tt
from voxelized_geometry_tools_tpu_torch.kernels import carve
from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
    OnlineMapper)
from voxelized_geometry_tools_tpu_torch.ops import render
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

from test_torch_transforms_exact import quat_rotation


def _cloud(pts, pose, device="cpu"):
    return tv.PointCloud.create(pts, pose, device=device)


def _mapper(device="cpu"):
    spec = GridSpec.from_voxel_counts(0.25, (8, 8, 8))
    origin = tt.isometry_from_translation((-1.0, -1.0, -1.0), device=device)
    return OnlineMapper(spec, origin, "world", device=device)


# -- The port's versions of tests/test_online_mapper.py -----------------------


def test_incremental_integration_latches_filled():
    m = _mapper()
    cam_pose = np.eye(4)
    m.integrate(_cloud(_plane_cloud(0.85), cam_pose))
    occ1 = m.occupancy_map.occupancy.numpy()
    assert (occ1 == 1.0).sum() > 0
    filled_before = occ1 == 1.0
    m.integrate(_cloud(_plane_cloud(0.35), cam_pose))
    occ2 = m.occupancy_map.occupancy.numpy()
    assert (occ2[filled_before] == 1.0).all(), "filled cells must latch"
    assert (occ2 == 1.0).sum() > filled_before.sum()
    assert m.frames_integrated == 2


def test_scan_fold_matches_sequential():
    clouds = [_cloud(_plane_cloud(z), np.eye(4)) for z in (0.85, 0.6, 0.35)]
    seq = _mapper()
    for c in clouds:
        seq.integrate(c)
    fold = _mapper()
    fold.integrate_frames(clouds)
    assert torch.equal(seq.occupancy_map.occupancy,
                       fold.occupancy_map.occupancy)
    assert fold.frames_integrated == 3


def test_sdf_cache_invalidation():
    m = _mapper()
    m.integrate(_cloud(_plane_cloud(0.85), np.eye(4)))
    s1 = m.sdf()
    assert m.sdf() is s1
    m.integrate(_cloud(_plane_cloud(0.35), np.eye(4)))
    s2 = m.sdf()
    assert s2 is not s1
    assert not torch.equal(s1.distances, s2.distances)


def test_render_and_localize():
    m = _mapper()
    m.integrate(_cloud(_plane_cloud(0.6, n=24), np.eye(4)))
    pose = np.eye(4, dtype=np.float32)
    cam = render.PinholeCamera.create(pose, 16, 12, focal=14.0,
                                      device="cpu")
    target = m.render_depth(cam, num_steps=24).depth
    assert float(target.min()) > 0.0
    bad_pose = pose.copy()
    bad_pose[2, 3] += 0.08
    bad_cam = render.PinholeCamera.create(bad_pose, 16, 12, focal=14.0,
                                          device="cpu")
    fit = m.localize(bad_cam, target, num_iters=40, learning_rate=0.02,
                     num_steps=24)
    losses = fit.losses.numpy()
    assert fit.valid_fraction > 0.5
    assert losses[-1] < 0.5 * losses[0]


# -- Against the JAX mapper, bit for bit --------------------------------------

N = 20
RES = 0.1


def _rotated_scene():
    """A 20^3 grid at 0.1 m whose origin is rotated about all three axes,
    and four 400-point depth frames from a camera moving inside it (the
    same point count, so they fold)."""
    rng = np.random.default_rng(11)
    origin = np.eye(4, dtype=np.float32)
    origin[:3, :3] = quat_rotation(rng.normal(size=4))
    origin[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    frames = []
    for _ in range(4):
        cam_grid = N * RES * rng.uniform(0.3, 0.7, 3)
        rot = quat_rotation(rng.normal(size=4))
        o = origin.astype(np.float64)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, :3] = o[:3, :3] @ rot
        pose[:3, 3] = o[:3, :3] @ cam_grid + o[:3, 3]
        uv = rng.uniform(-0.6, 0.6, (400, 2))
        depth = rng.uniform(0.4, 1.6, (400, 1))
        pts = np.concatenate([uv * depth, depth], -1).astype(np.float32)
        frames.append((pts, pose))
    return origin, frames


@pytest.fixture(scope="module")
def jax_mappers():
    """The JAX mappers' occupancy and SDF, op by op, by (run axis, how the
    frames went in)."""
    origin, frames = _rotated_scene()
    spec = JGridSpec.from_voxel_counts(RES, (N,) * 3)
    out = {}
    for run_axis in (None, -1):
        for how in ("integrate", "integrate_frames"):
            with jax.disable_jit():
                m = JOnlineMapper(spec, origin, "world",
                                  carve_run_axis=run_axis)
                clouds = [jv.PointCloud.create(p, pose)
                          for p, pose in frames]
                if how == "integrate":
                    for c in clouds:
                        m.integrate(c)
                else:
                    m.integrate_frames(clouds)
                sdf = m.sdf()
            out[run_axis, how] = (np.asarray(m.occupancy_map.occupancy),
                                  np.asarray(sdf.distances),
                                  m.frames_integrated, m._run_axis)
    return origin, frames, out


@pytest.mark.parametrize("run_axis", [None, -1])
@pytest.mark.parametrize("how", ["integrate", "integrate_frames"])
def test_mapper_matches_jax(jax_mappers, run_axis, how):
    origin, frames, refs = jax_mappers
    occ_ref, sdf_ref, frames_ref, axis_ref = refs[run_axis, how]
    m = OnlineMapper(GridSpec.from_voxel_counts(RES, (N,) * 3),
                     origin, "world", carve_run_axis=run_axis, device="cpu")
    clouds = [_cloud(p, pose) for p, pose in frames]
    if how == "integrate":
        for c in clouds:
            m.integrate(c)
    else:
        m.integrate_frames(clouds)
    assert (occ_ref == 1.0).any() and (occ_ref == 0.0).any()
    np.testing.assert_array_equal(m.occupancy_map.occupancy.numpy(), occ_ref)
    np.testing.assert_array_equal(m.sdf().distances.numpy(), sdf_ref)
    assert m.frames_integrated == frames_ref
    assert m._run_axis == axis_ref


def test_integrate_frames_rejects_mixed_shapes():
    m = _mapper()
    with pytest.raises(ValueError, match="uniform cloud shapes"):
        m.integrate_frames([_cloud(_plane_cloud(0.5, n=4), np.eye(4)),
                            _cloud(_plane_cloud(0.5, n=5), np.eye(4))])
    assert m.integrate_frames([]) is m.occupancy_map
    assert m.frames_integrated == 0


def test_cloud_on_another_device_rejected():
    m = _mapper()
    cloud = _cloud(_plane_cloud(0.5), np.eye(4))
    m._map = m._map.replace(occupancy=m._map.occupancy.to("meta"))
    with pytest.raises(ValueError, match="the map on meta"):
        m.integrate(cloud)


def test_extract_mesh_raises_naming_item_10():
    m = _mapper()
    m.integrate(_cloud(_plane_cloud(0.35), np.eye(4)))
    with pytest.raises(NotImplementedError, match="item 10"):
        m.extract_mesh(max_triangles=4096)


@pytest.mark.parametrize("run_axis,route", [
    (None, "raycast_pointcloud_columns"), (1, "raycast_pointcloud_columns"),
    (-1, "raycast_pointcloud")])
def test_cpu_carve_route(monkeypatch, run_axis, route):
    """On the CPU the mapper carves as the JAX package does: the column
    carve on the resolved axis (the first frame's dominant ray axis, z for
    a camera looking along z), the walk for -1."""
    calls = []
    for name in ("raycast_pointcloud", "raycast_pointcloud_columns"):
        fn = getattr(tv, name)
        monkeypatch.setattr(tv, name, lambda *a, _n=name, _f=fn, **k: (
            calls.append((_n, k.get("run_axis"))), _f(*a, **k))[1])
    spec = GridSpec.from_voxel_counts(0.25, (8, 8, 8))
    origin = tt.isometry_from_translation((-1.0, -1.0, -1.0), device="cpu")
    m = OnlineMapper(spec, origin, carve_run_axis=run_axis, device="cpu")
    m.integrate_frames([_cloud(_plane_cloud(z), np.eye(4))
                        for z in (0.85, 0.35)])
    want_axis = {None: 2, 1: 1, -1: None}[run_axis]
    assert calls == [(route, want_axis)] * 2


def test_mapper_state_continues_from_jax():
    """A JAX mapper's state (pose, frame, occupancy, frame count) carried
    into the port with interop.online_mapper_from_numpy, then one more
    frame in each: the same occupancy."""
    origin = np.asarray(jt.isometry_from_translation((-1.0, -1.0, -1.0)))
    spec = JGridSpec.from_voxel_counts(0.25, (8, 8, 8))
    with jax.disable_jit():
        jm = JOnlineMapper(spec, origin, "world")
        jm.integrate(jv.PointCloud.create(_plane_cloud(0.85), np.eye(4)))
        state = jm.occupancy_map
        tm = interop.online_mapper_from_numpy(
            interop.grid_spec_from_fields(spec.counts, spec.resolution),
            np.asarray(state.origin_transform), state.frame,
            np.asarray(state.occupancy), jm.frames_integrated, device="cpu")
        jm.integrate(jv.PointCloud.create(_plane_cloud(0.35), np.eye(4)))
    assert tm.frames_integrated == 1 and tm.occupancy_map.frame == "world"
    tm.integrate(_cloud(_plane_cloud(0.35), np.eye(4)))
    assert tm.frames_integrated == 2
    np.testing.assert_array_equal(tm.occupancy_map.occupancy.numpy(),
                                  np.asarray(jm.occupancy_map.occupancy))
    np.testing.assert_array_equal(tm.sdf().distances.numpy(),
                                  np.asarray(jm.sdf().distances))


@pytest.mark.cuda
def test_cuda_mapper_carves_with_the_tiled_kernel():
    """On the card the mapper carves every frame with the tiled carve
    kernel, one launch a frame, and its occupancy and SDF equal the CPU
    mapper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    origin, frames = _rotated_scene()
    spec = GridSpec.from_voxel_counts(RES, (N,) * 3)
    got = OnlineMapper(spec, origin, "world", device="cuda")
    ref = OnlineMapper(spec, origin, "world", device="cpu")
    before = carve.launches_tiled
    got.integrate_frames([_cloud(p, pose, "cuda") for p, pose in frames])
    torch.cuda.synchronize()
    assert carve.launches_tiled == before + len(frames)
    ref.integrate_frames([_cloud(p, pose) for p, pose in frames])
    assert torch.equal(got.occupancy_map.occupancy.cpu(),
                       ref.occupancy_map.occupancy)
    assert torch.equal(got.sdf().distances.cpu(), ref.sdf().distances)
