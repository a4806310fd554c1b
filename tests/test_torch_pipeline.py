"""The port's end-to-end pipeline (``models/fusion_pipeline.reconstruct``:
carve -> fuse -> EDT -> render) against the JAX package's on a small
two-camera scene: occupancy and SDF bit for bit, depth within the render
contract of tests/test_torch_render.py; and the fits take the JAX
package's parameters (tests/test_torch_fits.py holds their values)."""

import numpy as np
import jax
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu import OccupancyMap as JOccupancyMap
from voxelized_geometry_tools_tpu.models import fusion_pipeline as jfp
from voxelized_geometry_tools_tpu.ops import render as jr
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.models import fusion_pipeline as tfp
from voxelized_geometry_tools_tpu_torch.ops import backends as tb
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

# The render contract of tests/test_torch_render.py, for the same reasons:
# depth within 1e-4 m on pixels both hit, hit flips only on tangent grazers
# (a band of the surface threshold), at most 0.5% of pixels.
DEPTH_ATOL = 1e-4
MAX_HIT_FLIPS = 0.005
GRAZER_BAND = 0.08

N = (32, 32, 24)
RES = 0.05
CENTER = np.array([0.8, 0.8, 0.6])
RADIUS = 0.35
# Fewer march steps than reconstruct's 64, to keep the JAX package's op by
# op render short; the camera's hits converge well within them.
RENDER_STEPS = 32


def _look_at(position, forward):
    """Camera pose (+z forward, +y down) at ``position`` looking along
    ``forward``."""
    fwd = np.asarray(forward, np.float64)
    fwd /= np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0]) if abs(fwd[2]) < 0.9 \
        else np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, np.cross(fwd, right), fwd
    pose[:3, 3] = position
    return pose


def _depth_cloud(pose, w=24, h=18, focal=20.0):
    """Camera-frame points of a sphere seen by a pinhole camera; pixels
    that miss it read 3 m, beyond the grid (they carve free space)."""
    u, v = np.meshgrid((np.arange(w) - (w - 1) / 2) / focal,
                       (np.arange(h) - (h - 1) / 2) / focal, indexing="xy")
    d_cam = np.stack([u, v, np.ones_like(u)], -1).reshape(-1, 3)
    d_world = d_cam @ pose[:3, :3].T.astype(np.float64)
    o = pose[:3, 3].astype(np.float64)
    oc = o - CENTER
    a = np.sum(d_world * d_world, -1)
    b = 2.0 * d_world @ oc
    c = oc @ oc - RADIUS ** 2
    disc = b * b - 4 * a * c
    t = np.where(disc > 0, (-b - np.sqrt(np.maximum(disc, 0))) / (2 * a),
                 3.0 / np.sqrt(a))
    return (d_cam * t[:, None]).astype(np.float32)


@pytest.fixture(scope="module")
def scene():
    spec = JGridSpec.from_voxel_counts(RES, N)
    env = JOccupancyMap.create(spec, np.eye(4, dtype=np.float32), "world",
                               default_occupancy=0.5)
    poses = [_look_at(CENTER - np.array([0.0, 0.0, 1.3]), (0, 0, 1)),
             _look_at(CENTER - np.array([1.4, 0.0, 0.0]), (1, 0, 0))]
    clouds = [jv.PointCloud.create(_depth_cloud(p), p, max_range=2.5)
              for p in poses]
    cam_pose = _look_at(CENTER - np.array([0.0, 1.3, 0.2]), (0, 1, 0.15))
    jcam = jr.PinholeCamera.create(cam_pose, 40, 30, focal=36.0)
    with jax.disable_jit():
        ref = jfp.reconstruct(env, clouds, jcam,
                              num_render_steps=RENDER_STEPS)
    ref = jax.tree_util.tree_map(np.asarray, ref)
    tspec = GridSpec(spec.counts, spec.resolution)
    tenv = interop.occupancy_map_from_numpy(
        tspec, np.asarray(env.occupancy), np.asarray(env.origin_transform),
        env.frame, device="cpu")
    tclouds = [interop.pointcloud_from_numpy(
        np.asarray(c.points), np.asarray(c.origin_transform),
        np.asarray(c.max_range), device="cpu") for c in clouds]
    tcam = interop.camera_from_numpy(np.asarray(jcam.pose), jcam.fx, jcam.fy,
                                     jcam.cx, jcam.cy, 40, 30, device="cpu")
    return ref, tenv, tclouds, tcam, env, clouds


def _check(ref, got):
    np.testing.assert_array_equal(got.occupancy_map.occupancy.numpy(),
                                  ref.occupancy_map.occupancy)
    np.testing.assert_array_equal(got.sdf.distances.numpy(),
                                  ref.sdf.distances)
    r, g = ref.render_result, got.render_result
    ref_hit, got_hit = r.hit, g.hit.numpy()
    flips = ref_hit != got_hit
    assert flips.mean() <= MAX_HIT_FLIPS
    hitter = np.where(ref_hit, r.distance, g.distance.numpy())
    graze = np.abs(hitter - 0.25 * RES) <= GRAZER_BAND * RES
    assert not (flips & ~graze).any()
    both = ref_hit & got_hit
    assert both.mean() > 0.2
    np.testing.assert_allclose(g.depth.numpy()[both], r.depth[both], rtol=0,
                               atol=DEPTH_ATOL)


def test_reconstruct_matches_jax(scene):
    """The scene carves free, filled and unknown voxels, and the port's
    reconstruct equals the JAX package's."""
    ref, tenv, tclouds, tcam, _, _ = scene
    occ = ref.occupancy_map.occupancy
    assert {0.0, 0.5, 1.0} <= set(np.unique(occ).tolist())
    runtimes = []
    got = tfp.reconstruct(tenv, tclouds, tcam, num_render_steps=RENDER_STEPS,
                          runtime_log_fn=runtimes.append)
    _check(ref, got)
    assert len(runtimes) == 1


def test_reconstruct_through_the_accelerator_backend(scene):
    """reconstruct with the accelerator backend's voxelizer on the CPU
    gives the same result."""
    ref, tenv, tclouds, tcam, _, _ = scene
    vox = tb.AcceleratorPointCloudVoxelizer(device="cpu")
    got = tfp.reconstruct(tenv, tclouds, tcam, voxelizer=vox,
                          num_render_steps=RENDER_STEPS)
    _check(ref, got)


def test_reconstruct_through_the_native_backend(scene):
    """reconstruct with the native voxelizer: the occupancy of the JAX
    package's native backend (its float64 walk is not the float32 walk's,
    as the reference's CPU and CUDA backends differ), bitwise."""
    from voxelized_geometry_tools_tpu.ops import backends as jb
    from voxelized_geometry_tools_tpu_torch import native
    if not native.available():
        pytest.skip("no native toolchain")
    _, tenv, tclouds, tcam, env, clouds = scene
    ref = jb.NativeCpuPointCloudVoxelizer().voxelize_pointclouds(
        env, jv.FilterOptions(), clouds)
    got = tfp.reconstruct(tenv, tclouds, tcam,
                          voxelizer=tb.NativeCpuPointCloudVoxelizer(),
                          num_render_steps=RENDER_STEPS)
    np.testing.assert_array_equal(got.occupancy_map.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    assert bool(got.render_result.hit.any())


@pytest.mark.parametrize("name", ["se3_exp", "perturb_pose", "depth_loss",
                                  "PoseFitResult", "fit_camera_pose",
                                  "fit_voxels"])
def test_fits_raise_naming_their_item(name):
    """The fits are ported (tests/test_torch_fits.py holds them against the
    JAX package): each takes the JAX package's parameters, in its order,
    and none raises NotImplementedError any more."""
    import inspect
    got = inspect.signature(getattr(tfp, name)).parameters
    ref = inspect.signature(getattr(jfp, name)).parameters
    assert list(got) == list(ref)
    assert "NotImplementedError" not in inspect.getsource(getattr(tfp, name))


def test_pipeline_output_fields():
    assert tfp.PipelineOutput._fields == jfp.PipelineOutput._fields


def test_device_defaults_to_the_card(monkeypatch):
    """Without a card, making a cloud or a map from host data with
    device=None raises, naming device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tv.PointCloud.create(np.zeros((1, 3), np.float32))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        interop.occupancy_map_from_numpy(
            GridSpec(N, RES), np.zeros(N, np.float32), np.eye(4))
    with pytest.raises(RuntimeError, match='device="cpu"'):
        interop.pointcloud_from_numpy(np.zeros((1, 3)), np.eye(4))
