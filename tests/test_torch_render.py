"""The PyTorch port's sphere-traced depth render against the JAX package,
on the sphere fixture of tests/test_fast_render.py (40x40x24 at 0.05 m)
built by each package's EDT (bitwise equal fields)."""

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import render as jr
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.ops import edt
from voxelized_geometry_tools_tpu_torch.ops import render as tr
from voxelized_geometry_tools_tpu_torch.ops import sdf_query as tq

# Ray directions: one normalisation (sqrt of a 3-term sum) whose rounding
# may differ by an ulp between XLA and PyTorch's CPU kernels.
RAYS_ATOL = 1e-6
# Depth on pixels both renders hit: ulp-level sample differences compound
# over up to 64 march steps; 1e-4 m is 0.2% of a voxel here.
DEPTH_ATOL = 1e-4
# Hit masks may differ only on tangent grazers (render.py:200-211 of the
# JAX package): pixels whose converged query sits within a band of the
# surface threshold; at most this share of pixels.
MAX_HIT_FLIPS = 0.005
GRAZER_BAND = 0.08  # in voxels, as tests/test_fast_render.py
# Gradients through 48 march steps and the Newton refine: each term is a
# chain of ulp-level different samples; scatter-adds sum in another order.
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


@pytest.fixture(scope="module")
def scene():
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
    return js, ts, jq.build_corner_table(js), tq.build_corner_table(ts)


def _cameras(sdf, w=48, h=36, focal=45.0, pose=None):
    if pose is None:
        sizes = np.asarray(sdf.spec.grid_sizes)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.5 * sizes[2]])
    jc = jr.PinholeCamera.create(pose, w, h, focal=focal)
    tc = interop.camera_from_numpy(np.asarray(jc.pose), jc.fx, jc.fy, jc.cx,
                                   jc.cy, w, h, device="cpu")
    return jc, tc


def check_render_contract(ref_hit, ref_depth, ref_dist, got, resolution):
    """Hit masks equal up to tangent grazers; depths close on common hits."""
    got_hit = got.hit.numpy()
    got_dist = got.distance.numpy()
    flips = ref_hit != got_hit
    assert flips.mean() <= MAX_HIT_FLIPS
    thresh = 0.25 * resolution
    hitter_dist = np.where(ref_hit, ref_dist, got_dist)
    graze = np.abs(hitter_dist - thresh) <= GRAZER_BAND * resolution
    assert not (flips & ~graze).any(), "hit flip outside the grazer band"
    m = ref_hit & got_hit
    assert m.any()
    np.testing.assert_allclose(got.depth.numpy()[m], ref_depth[m], rtol=0,
                               atol=DEPTH_ATOL)
    assert (got.depth.numpy()[~got_hit] == 100.0).all()


def _check_vs_jax(ref, got, resolution):
    check_render_contract(np.asarray(ref.hit), np.asarray(ref.depth),
                          np.asarray(ref.distance), got, resolution)


def test_camera_rays_match_jax(scene):
    js, _, _, _ = scene
    jc, tc = _cameras(js)
    jo, jd = jr.camera_rays(jc)
    to, td = tr.camera_rays(tc)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=RAYS_ATOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), atol=RAYS_ATOL)


@pytest.mark.parametrize("table", [False, True])
def test_fixed_step_render_matches_jax(scene, table):
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    ref = jr.render_depth(js, jc, num_steps=64,
                          corner_table=jt if table else None)
    got = tr.render_depth(ts, tc, num_steps=64,
                          corner_table=tt if table else None)
    _check_vs_jax(ref, got, js.resolution)
    assert 0.0 < got.hit.numpy().mean() < 1.0


@pytest.mark.parametrize("table", [False, True])
def test_early_exit_matches_fixed_step_and_jax(scene, table):
    js, ts, jt, tt = scene
    jc, tc = _cameras(js)
    kw = dict(num_steps=64, corner_table=tt if table else None)
    fixed = tr.render_depth(ts, tc, **kw)
    early = tr.render_depth(ts, tc, early_exit=True, tail_chunks=1, **kw)
    check_render_contract(fixed.hit.numpy(), fixed.depth.numpy(),
                          fixed.distance.numpy(), early, ts.resolution)
    ref = jr.render_depth(js, jc, num_steps=64, early_exit=True,
                          tail_chunks=1, corner_table=jt if table else None)
    _check_vs_jax(ref, early, js.resolution)


def test_posed_grid_render_matches_jax():
    """A rotated, translated grid origin and an oblique camera exercise the
    isometry inverse and the slab clip off the axes."""
    c, s = np.cos(0.3), np.sin(0.3)
    origin = np.eye(4, dtype=np.float32)
    origin[:3, :3] = [[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]]
    origin[:3, 3] = [0.2, -0.1, 0.3]
    xs, ys, zs = np.meshgrid(np.arange(24), np.arange(20), np.arange(28),
                             indexing="ij", sparse=True)
    mask = ((xs - 11) ** 2 + (ys - 9) ** 2 + (zs - 15) ** 2) <= 36
    mask[:, :, :3] = True
    js = jedt.extract_signed_distance_field(
        jnp.asarray(mask), JGridSpec.from_voxel_counts(0.05, mask.shape),
        origin)
    ts = edt.extract_signed_distance_field(
        torch.from_numpy(mask), GridSpec.from_voxel_counts(0.05, mask.shape),
        origin)
    cam = np.eye(4, dtype=np.float32)
    a = -0.5
    cam[:3, :3] = [[np.cos(a), 0.0, np.sin(a)], [0.0, 1.0, 0.0],
                   [-np.sin(a), 0.0, np.cos(a)]]
    cam[:3, 3] = [0.0, 0.4, 2.6]
    cam[:3, :3] = cam[:3, :3] @ np.diag([1.0, -1.0, -1.0])  # look down -z
    jc, tc = _cameras(js, 40, 30, focal=40.0, pose=cam)
    ref = jr.render_depth(js, jc, num_steps=64,
                          corner_table=jq.build_corner_table(js))
    got = tr.render_depth(ts, tc, num_steps=64,
                          corner_table=tq.build_corner_table(ts))
    _check_vs_jax(ref, got, js.resolution)


@pytest.mark.parametrize("table", [False, True])
def test_render_gradients_match_jax(scene, table):
    """d mean(depth) / d distances and / d pose against jax.grad on the
    differentiable fixed-step march (the table, when used, is built inside
    the differentiated function)."""
    js, ts, _, _ = scene
    jc, tc = _cameras(js, 24, 18, focal=22.0)

    def jloss(d, pose):
        s = js.replace(distances=d)
        cam = dataclasses.replace(jc, pose=pose)
        t = jq.build_corner_table(s) if table else None
        return jnp.mean(jr.render_depth(s, cam, num_steps=48,
                                        corner_table=t).depth)

    jg_d, jg_p = jax.jit(jax.grad(jloss, argnums=(0, 1)))(js.distances,
                                                          jc.pose)
    d = ts.distances.clone().requires_grad_(True)
    pose = tc.pose.clone().requires_grad_(True)
    s = ts.replace(distances=d)
    cam = dataclasses.replace(tc, pose=pose)
    t = tq.build_corner_table(s) if table else None
    torch.mean(tr.render_depth(s, cam, num_steps=48,
                               corner_table=t).depth).backward()
    assert float(torch.abs(d.grad).sum()) > 0.0
    np.testing.assert_allclose(d.grad.numpy(), np.asarray(jg_d),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)
    np.testing.assert_allclose(pose.grad.numpy(), np.asarray(jg_p),
                               rtol=GRAD_RTOL, atol=GRAD_ATOL)


@pytest.mark.parametrize("kwargs", [
    dict(mip=object()),
    dict(coarse_factor=4, head_steps=0, tail_chunks=4, relax=2.0),
    dict(early_exit=True, tail_chunks=1, relax=1.5),
])
def test_unported_options_raise(scene, kwargs):
    """The options that once raised as unported are ported: a mip that is
    not an ``SdfMip`` fails as in the JAX package, ``relax > 1`` without
    early exit raises the JAX package's ``ValueError``, and a relaxed
    early-exit render is within check_render_contract of the JAX
    package's, and within tests/test_fast_render.py's relax contract of
    the fixed march (flips only in the grazer band widened by ``relax``,
    common depths within two thresholds)."""
    js, ts, _, _ = scene
    if "mip" in kwargs:
        _, tc = _cameras(ts, 8, 8)
        with pytest.raises((TypeError, AttributeError)):
            tr.render_depth(ts, tc, num_steps=4, **kwargs)
    elif not kwargs.get("early_exit"):
        _, tc = _cameras(ts, 8, 8)
        with pytest.raises(ValueError, match="early_exit"):
            tr.render_depth(ts, tc, num_steps=4, **kwargs)
    else:
        jc, tc = _cameras(js)
        got = tr.render_depth(ts, tc, num_steps=64, **kwargs)
        _check_vs_jax(jr.render_depth(js, jc, num_steps=64, **kwargs), got,
                      js.resolution)
        fixed = tr.render_depth(ts, tc, num_steps=64)
        thresh = 0.25 * ts.resolution
        flips = (fixed.hit != got.hit).numpy()
        dist = torch.where(fixed.hit, fixed.distance, got.distance).numpy()
        band = kwargs["relax"] * 0.2 * ts.resolution
        assert not (flips & ~(np.abs(dist - thresh) <= band)).any()
        m = fixed.hit & got.hit
        assert bool(m.any())
        assert float((fixed.depth[m] - got.depth[m]).abs().max()) \
            <= 2 * thresh + 1e-6


def test_relax_below_one_rejected(scene):
    _, ts, _, _ = scene
    _, tc = _cameras(ts, 8, 8)
    with pytest.raises(ValueError, match="relax"):
        tr.render_depth(ts, tc, num_steps=4, relax=0.5)
