"""The port's pose and voxel fits (``models/fusion_pipeline.py``: se3_exp,
perturb_pose, depth_loss, PoseFitResult, fit_camera_pose, fit_voxels)
against the JAX package on the scene of tests/test_fusion_pipeline.py, and
the port's versions of that file's tests.

Tolerances, each measured on this scene (the JAX fits run jitted, as the
package runs them):
* ``se3_exp`` and ``perturb_pose``: atol 1e-7 for rotations up to 0.5 rad
  (measured 6.0e-8 over 300 random tangents; XLA's float32 sin and cos
  and the port's float64 ones rounded once differ by an ulp on about 1% of
  angles, and the product is bitwise); 2.4e-7 (two ulp of 1.0) for
  rotations up to 1.5 rad * sqrt(3) (measured 1.8e-7);
* ``depth_loss``: rtol 1e-6 (measured 1.8e-7);
* the first loss and gradient of ``fit_camera_pose``: rtol 1e-5 and 1e-4
  (measured 2.4e-7 and about 1e-6);
* the 6-iteration loss history: rtol 2e-4 (measured 4.8e-5: Adam in
  ``torch.optim`` rounds its update in another order than optax, and each
  step's pose moves the next render);
* ``fit_voxels``' 3-iteration history: rtol 1e-4 (measured 5.0e-6), and
  its refined distances atol 5e-5 (measured 2.1e-5, a thousandth of Adam's
  0.05 step: a voxel whose gradient is near zero moves by a ratio of
  rounding-sized moments).
"""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_fusion_pipeline import make_scene
from voxelized_geometry_tools_tpu.models import fusion_pipeline as jfp
from voxelized_geometry_tools_tpu.ops import render as jr
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, OccupancyMap
from voxelized_geometry_tools_tpu_torch import interop
from voxelized_geometry_tools_tpu_torch.core import transforms as tt
from voxelized_geometry_tools_tpu_torch.models import fusion_pipeline as tfp
from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

SE3_ATOL = 1e-7
LARGE_ROTATION_ATOL = 2.4e-7
LOSS_RTOL = 1e-6
FIRST_LOSS_RTOL, FIRST_GRAD_RTOL = 1e-5, 1e-4
HISTORY_RTOL = 2e-4
VOXEL_HISTORY_RTOL = 1e-4
VOXEL_DISTANCE_ATOL = 5e-5

TANGENTS = [
    (0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
    (1e-5, 2e-5, -1e-5, 0.1, 0.2, 0.3),
    (0.02, 0.0, 0.0, 0.0, 0.01, 0.0),
    (0.3, -0.2, 0.1, 1.0, 2.0, 3.0),
]
BASE_TANGENT = (0.02, 0.0, 0.0, 0.0, 0.01, 0.0)


@pytest.fixture(scope="module")
def scene():
    """(jax sdf, jax cameras, port sdf, port cameras): the 24^3 sphere of
    tests/test_fusion_pipeline.py, each package's EDT of the same mask
    (bitwise equal fields), and its two 32x24 cameras."""
    jsdf, jcams = make_scene()
    n = 24
    xs, ys, zs = np.meshgrid(*[np.arange(n)] * 3, indexing="ij",
                             sparse=True)
    filled = ((xs - n / 2) ** 2 + (ys - n / 2) ** 2
              + (zs - n / 2) ** 2) <= (n / 4) ** 2
    tsdf = edt.extract_signed_distance_field(
        torch.from_numpy(filled), GridSpec.from_voxel_counts(0.1, (n,) * 3),
        None)
    np.testing.assert_array_equal(tsdf.distances.numpy(),
                                  np.asarray(jsdf.distances))
    tcams = [interop.camera_from_numpy(np.asarray(c.pose), c.fx, c.fy, c.cx,
                                       c.cy, c.width, c.height, device="cpu")
             for c in jcams]
    return jsdf, jcams, tsdf, tcams


def _np(x):
    return np.array(x)


def _perturbed(scene, steps=24):
    """The JAX and port base cameras of the pose fit, and the target
    depth rendered by the JAX package from the unperturbed camera."""
    jsdf, jcams, _, tcams = scene
    target = _np(jr.render_depth(jsdf, jcams[0], num_steps=steps).depth)
    jbase = dataclasses.replace(jcams[0], pose=jfp.perturb_pose(
        jcams[0].pose, jnp.asarray(BASE_TANGENT, jnp.float32)))
    tbase = dataclasses.replace(tcams[0], pose=tfp.perturb_pose(
        tcams[0].pose, torch.tensor(BASE_TANGENT)))
    return jbase, tbase, target


@pytest.mark.parametrize("tangent", TANGENTS)
def test_se3_exp_matches_jax(tangent):
    tan = np.asarray(tangent, np.float32)
    ref = _np(jfp.se3_exp(jnp.asarray(tan)))
    got = tfp.se3_exp(torch.from_numpy(tan)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SE3_ATOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_se3_exp_large_rotations_match_jax(seed):
    rng = np.random.default_rng(seed)
    for _ in range(50):
        tan = rng.uniform(-1.5, 1.5, 6).astype(np.float32)
        ref = _np(jfp.se3_exp(jnp.asarray(tan)))
        got = tfp.se3_exp(torch.from_numpy(tan)).numpy()
        np.testing.assert_allclose(got, ref, rtol=0, atol=LARGE_ROTATION_ATOL)


def test_se3_exp_jacobian_at_zero_matches_jax():
    """The Taylor branch keeps the Jacobian at the identity finite; it is
    the JAX package's."""
    ref = _np(jax.jacobian(jfp.se3_exp)(jnp.zeros(6)))
    got = torch.autograd.functional.jacobian(tfp.se3_exp,
                                             torch.zeros(6)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SE3_ATOL)


@pytest.mark.parametrize("tangent", TANGENTS)
def test_perturb_pose_matches_jax(scene, tangent):
    _, jcams, _, tcams = scene
    tan = np.asarray(tangent, np.float32)
    ref = _np(jfp.perturb_pose(jcams[1].pose, jnp.asarray(tan)))
    got = tfp.perturb_pose(tcams[1].pose, torch.from_numpy(tan)).numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=SE3_ATOL)


def test_depth_loss_matches_jax(scene):
    jsdf, _, tsdf, _ = scene
    jbase, tbase, target = _perturbed(scene)
    ref = float(jfp.depth_loss(jsdf, jbase, jnp.asarray(target),
                               num_steps=24))
    got = float(tfp.depth_loss(tsdf, tbase, torch.from_numpy(target),
                               num_steps=24))
    assert ref > 0.0
    np.testing.assert_allclose(got, ref, rtol=LOSS_RTOL)


def test_fit_camera_pose_first_loss_and_gradient_match_jax(scene):
    """The loss and its tangent gradient at the first step, the JAX one
    jitted as ``fit_camera_pose`` runs it."""
    jsdf, _, tsdf, _ = scene
    jbase, tbase, target = _perturbed(scene)

    def jloss(tan):
        cam = dataclasses.replace(jbase,
                                  pose=jfp.perturb_pose(jbase.pose, tan))
        return jfp.depth_loss(jsdf, cam, jnp.asarray(target), num_steps=24)

    ref_loss, ref_grad = jax.jit(jax.value_and_grad(jloss))(jnp.zeros(6))
    tan = torch.zeros(6, requires_grad=True)
    cam = dataclasses.replace(tbase, pose=tfp.perturb_pose(tbase.pose, tan))
    loss = tfp.depth_loss(tsdf, cam, torch.from_numpy(target), num_steps=24)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss),
                               rtol=FIRST_LOSS_RTOL)
    assert np.abs(_np(ref_grad)).max() > 1e-3
    np.testing.assert_allclose(tan.grad.numpy(), _np(ref_grad),
                               rtol=FIRST_GRAD_RTOL, atol=1e-7)


def test_fit_camera_pose_history_matches_jax(scene):
    jsdf, _, tsdf, _ = scene
    jbase, tbase, target = _perturbed(scene)
    ref = jfp.fit_camera_pose(jsdf, jbase, jnp.asarray(target), num_iters=6,
                              num_steps=24)
    got = tfp.fit_camera_pose(tsdf, tbase, torch.from_numpy(target),
                              num_iters=6, num_steps=24)
    assert isinstance(got, tfp.PoseFitResult)
    np.testing.assert_allclose(got.losses.numpy(), _np(ref.losses),
                               rtol=HISTORY_RTOL)
    np.testing.assert_allclose(got.tangent.numpy(), _np(ref.tangent),
                               rtol=HISTORY_RTOL, atol=1e-7)
    np.testing.assert_allclose(got.pose.numpy(), _np(ref.pose),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.valid_fraction, ref.valid_fraction,
                               rtol=1e-6)


def test_pose_fit_result_fields_are_jaxs():
    assert ([f.name for f in dataclasses.fields(tfp.PoseFitResult)]
            == [f.name for f in dataclasses.fields(jfp.PoseFitResult)])


@pytest.mark.parametrize("table", [None, "brick", "pair"])
def test_fit_voxels_history_matches_jax(scene, table):
    """Three voxel-fit steps from a noisy field, without a table and with
    a table request of each type (rebuilt from the current distances)."""
    jsdf, jcams, tsdf, tcams = scene
    targets = [_np(jr.render_depth(jsdf, c, num_steps=32).depth)
               for c in jcams]
    noise = 0.04 * np.random.default_rng(0).standard_normal(
        tsdf.distances.shape).astype(np.float32)
    jnoisy = jsdf.replace(distances=jsdf.distances + noise)
    tnoisy = tsdf.replace(distances=tsdf.distances + torch.from_numpy(noise))
    jkw, tkw = {}, {}
    if table == "brick":
        jkw["corner_table"] = jq.build_corner_table(jnoisy)
        tkw["corner_table"] = sdf_query.build_corner_table(tnoisy)
    elif table == "pair":
        jkw["corner_table"] = jq.build_corner_pair_table(jnoisy)
        tkw["corner_table"] = sdf_query.build_corner_pair_table(tnoisy)
    ref_sdf, ref = jfp.fit_voxels(jnoisy, jcams, [jnp.asarray(t)
                                                  for t in targets],
                                  num_iters=3, num_steps=32, **jkw)
    got_sdf, got = tfp.fit_voxels(tnoisy, tcams, [torch.from_numpy(t)
                                                  for t in targets],
                                  num_iters=3, num_steps=32, **tkw)
    np.testing.assert_allclose(got.numpy(), _np(ref),
                               rtol=VOXEL_HISTORY_RTOL)
    assert got_sdf.locked
    np.testing.assert_allclose(got_sdf.distances.numpy(),
                               _np(ref_sdf.distances), rtol=0,
                               atol=VOXEL_DISTANCE_ATOL)


def test_remat_is_bitwise_on_cpu(scene):
    """remat=True rematerializes each fixed-march step; on the CPU the
    losses, tangent and pose are the same bits as without it, and so is the
    voxel gradient of a render."""
    _, _, tsdf, tcams = scene
    _, tbase, target = _perturbed(scene)
    fits = [tfp.fit_camera_pose(tsdf, tbase, torch.from_numpy(target),
                                num_iters=4, num_steps=24, remat=rm)
            for rm in (False, True)]
    for a, b in ((fits[0].losses, fits[1].losses),
                 (fits[0].tangent, fits[1].tangent),
                 (fits[0].pose, fits[1].pose)):
        assert torch.equal(a, b)
    grads = []
    for rm in (False, True):
        d = tsdf.distances.clone().requires_grad_(True)
        res = render.render_depth(tsdf.replace(distances=d), tcams[1],
                                  num_steps=32, remat=rm)
        torch.sum(res.depth).backward()
        grads.append(d.grad)
    assert float(grads[0].abs().sum()) > 0.0
    assert torch.equal(grads[0], grads[1])


# -- The port's versions of tests/test_fusion_pipeline.py ---------------------


def test_se3_exp_identity_and_smoothness():
    m = tfp.se3_exp(torch.zeros(6))
    np.testing.assert_allclose(m.numpy(), np.eye(4), atol=1e-6)
    g = torch.autograd.functional.jacobian(tfp.se3_exp, torch.zeros(6))
    assert bool(torch.all(torch.isfinite(g)))


def test_fit_voxels_reduces_loss(scene):
    _, _, sdf, cams = scene
    targets = [render.render_depth(sdf, c, num_steps=32).depth for c in cams]
    noise = 0.04 * np.random.default_rng(0).standard_normal(
        sdf.distances.shape).astype(np.float32)
    noisy = sdf.replace(distances=sdf.distances + torch.from_numpy(noise))
    refined, losses = tfp.fit_voxels(noisy, cams, targets, num_iters=25,
                                     num_steps=32)
    losses = losses.numpy()
    assert losses[-1] < 0.5 * losses[0]
    assert refined.locked


def test_fit_camera_pose_remat_matches(scene):
    _, _, sdf, cams = scene
    target = render.render_depth(sdf, cams[0], num_steps=24).depth
    base = dataclasses.replace(cams[0], pose=tfp.perturb_pose(
        cams[0].pose, torch.tensor([0.02, 0, 0, 0, 0.01, 0])))
    fits = [tfp.fit_camera_pose(sdf, base, target, num_iters=6,
                                num_steps=24, remat=rm)
            for rm in (False, True)]
    np.testing.assert_allclose(fits[0].losses.numpy(),
                               fits[1].losses.numpy(), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(fits[0].tangent.numpy(),
                               fits[1].tangent.numpy(), rtol=1e-4, atol=1e-7)
    assert float(fits[0].losses[-1]) < float(fits[0].losses[0])


def test_reconstruct_pipeline_runs():
    spec = GridSpec.from_voxel_counts(0.25, (8, 8, 8))
    origin = tt.isometry_from_translation((-1.0, -1.0, -1.0), device="cpu")
    env = OccupancyMap.create(spec, origin, "w", device="cpu")
    pts = np.stack(np.meshgrid(np.linspace(-0.9, 0.9, 12),
                               np.linspace(-0.9, 0.9, 12),
                               indexing="ij"), -1)
    pts = np.concatenate([pts, np.full((12, 12, 1), 0.8)], -1).reshape(-1, 3)
    cloud = tv.PointCloud.create(pts.astype(np.float32), np.eye(4),
                                 device="cpu")
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (0.0, 0.0, -2.0)
    cam = render.PinholeCamera.create(pose, 16, 12, focal=14.0, device="cpu")
    out = tfp.reconstruct(env, [cloud], cam, num_render_steps=24)
    assert out.sdf.locked
    assert tuple(out.render_result.depth.shape) == (12, 16)


@pytest.mark.parametrize("table_type", ["brick", "pair"])
def test_fit_voxels_corner_table_gradient_is_live(scene, table_type):
    """A table passed to fit_voxels is a request: the fitter rebuilds a
    table of the same type from the current values in each evaluation, so
    the data term moves the voxels (zero smoothness weight: any loss
    decrease is the data term). The fit's best loss is held to half the
    first: at lr 0.05 the 25-step history is not monotone (the JAX
    package's own ends at 0.49 of its first loss with a table and at 1.28
    without one, on the same noise), so its last loss is no measure of
    whether the gradient is live."""
    _, _, sdf, cams = scene
    targets = [render.render_depth(sdf, c, num_steps=32).depth for c in cams]
    noise = 0.04 * np.random.default_rng(1).standard_normal(
        sdf.distances.shape).astype(np.float32)
    noisy = sdf.replace(distances=sdf.distances + torch.from_numpy(noise))
    build = (sdf_query.build_corner_table if table_type == "brick"
             else sdf_query.build_corner_pair_table)
    refined, losses = tfp.fit_voxels(noisy, cams, targets, num_iters=25,
                                     num_steps=32, smoothness_weight=0.0,
                                     corner_table=build(noisy))
    losses = losses.numpy()
    assert losses.min() < 0.5 * losses[0]
    assert not np.allclose(refined.distances.numpy(),
                           noisy.distances.numpy())


def test_fit_voxels_rejects_mismatched_inputs(scene):
    _, _, sdf, cams = scene
    with pytest.raises(ValueError, match="at least one"):
        tfp.fit_voxels(sdf, [], [], num_iters=1)
    with pytest.raises(ValueError, match="cameras"):
        tfp.fit_voxels(sdf, cams, [torch.zeros((2, 2))], num_iters=1)


def test_depth_loss_ignores_zero_depth_holes(scene):
    _, _, sdf, cams = scene
    target = render.render_depth(sdf, cams[0], num_steps=24).depth.numpy()
    l_ref = float(tfp.depth_loss(sdf, cams[0], torch.from_numpy(target),
                                 num_steps=24))
    holes = target.copy()
    holes[::2, ::2] = 0.0
    l_holes = float(tfp.depth_loss(sdf, cams[0], torch.from_numpy(holes),
                                   num_steps=24))
    assert l_holes <= l_ref + 1e-6
