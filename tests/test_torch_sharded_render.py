"""The port's sharded renders and multichip dryrun in gloo worlds of 2 and
4 CPU ranks, on tests/test_sharded.py's scene (a 16^3 grid with a box,
a 24-pixel-wide camera at (2, 2, -3)): the pixel-row render (fixed march,
brick and pair tables, the cone prepass inside the rank and replicated,
the block tail with escape certificates), the grid-sharded render over
``grid_axis`` x ``steps_per_exchange`` x ``ray_chunks``, the slab corner
table and one grid-sharded render against the JAX package's sharded
functions on a 4-device slice of the virtual mesh, the cone contract, the
guards, and ``dryrun_multichip`` against a one-rank world. Tolerances are
tests/test_sharded.py's: 1e-6 on the fixed march, 1e-5 with a table or
the schedule, 1e-4 for the grid-sharded march without a table."""

import jax
import numpy as np
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu.core import transforms as jtransforms
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import render as jrender
from voxelized_geometry_tools_tpu.ops import sdf_query as jsq
from voxelized_geometry_tools_tpu.parallel import mesh_utils as jmesh_utils
from voxelized_geometry_tools_tpu.parallel import sharded as jsharded
from voxelized_geometry_tools_tpu_torch import GridSpec, entry
from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query
from voxelized_geometry_tools_tpu_torch.parallel import (
    launch, mesh_utils, sharded, targets)

import _torch_rank_targets as rank_targets

P = mesh_utils.P
SLABS = P(None, None, "z")
SIZES = (2, 4)
N_STEPS = 32
FOCAL = 20.0


@pytest.fixture(scope="module")
def worlds():
    opened = {n: launch.World(n, device="cpu") for n in SIZES}
    yield opened
    for w in opened.values():
        w.close()


def _filled():
    filled = np.zeros((16, 16, 16), bool)
    filled[6:10, 6:10, 6:10] = True
    return filled


@pytest.fixture(scope="module")
def scene():
    """``(distances, port sdf, JAX sdf, spec)``: the box's field, the same
    bits in both packages."""
    jspec = JGridSpec.from_voxel_counts(0.25, (16, 16, 16))
    jsdf = jedt.extract_signed_distance_field(_filled(), jspec, None)
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 16))
    sdf = edt.extract_signed_distance_field(torch.from_numpy(_filled()),
                                            spec, None)
    np.testing.assert_array_equal(sdf.distances.numpy(),
                                  np.asarray(jsdf.distances))
    return sdf.distances.numpy(), sdf, jsdf, spec


def _pose():
    return np.asarray(jtransforms.isometry_from_translation((2.0, 2.0, -3.0)),
                      np.float32)


def _camera_dict(height, width=24):
    return {"pose": _pose(), "width": width, "height": height, "fx": FOCAL,
            "fy": FOCAL, "cx": (width - 1) / 2.0, "cy": (height - 1) / 2.0}


def _cameras(height, width=24):
    return (render.PinholeCamera.create(_pose(), width, height, focal=FOCAL,
                                        device="cpu"),
            jrender.PinholeCamera.create(_pose(), width, height,
                                         focal=FOCAL))


def _singles(scene, height, table=None, width=24, **knobs):
    """The port's and the JAX package's single-device renders."""
    _, sdf, jsdf, _ = scene
    cam, jcam = _cameras(height, width)
    ptable = jtable = None
    if table == "brick":
        ptable = sdf_query.build_corner_table(sdf)
        jtable = jsq.build_corner_table(jsdf)
    elif table == "pair":
        ptable = sdf_query.build_corner_pair_table(sdf)
        jtable = jsq.build_corner_pair_table(jsdf)
    port = render.render_depth(sdf, cam, num_steps=N_STEPS,
                               corner_table=ptable, **knobs).depth.numpy()
    ref = np.asarray(jax.jit(lambda d: jrender.render_depth(
        jsdf.replace(distances=d), jcam, num_steps=N_STEPS,
        corner_table=jtable, **knobs).depth)(jsdf.distances))
    return port, ref


def _pixels(worlds, scene, n, height, table=None, width=24, **knobs):
    d, _, _, spec = scene
    return worlds[n].run(targets.render_pixels, d, spec, np.eye(4),
                         _camera_dict(height, width), table=table,
                         out_specs=P("z"), num_steps=N_STEPS, **knobs)


@pytest.fixture(scope="module")
def fixed_refs(scene):
    return _singles(scene, 16)


# -- Pixel rows -----------------------------------------------------------------


@pytest.mark.parametrize("n", SIZES)
def test_pixel_render_fixed_march(worlds, scene, fixed_refs, n):
    port, ref = fixed_refs
    got = _pixels(worlds, scene, n, 16)
    np.testing.assert_allclose(got, ref, atol=1e-6)
    np.testing.assert_array_equal(got, port)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("table", ["brick", "pair"])
def test_pixel_render_tables(worlds, scene, fixed_refs, n, table):
    got = _pixels(worlds, scene, n, 16, table=table, early_exit=True)
    port, _ = _singles(scene, 16, table=table, early_exit=True)
    np.testing.assert_allclose(got, fixed_refs[1], atol=1e-5)
    np.testing.assert_array_equal(got, port)


# (height, width, knobs): the prepass inside each rank (f | H / n), the
# block tail with escape certificates (head_steps=0), and a camera whose
# blocks straddle the 4-rank row cut (f | H only: replicated prepass).
CONE_CASES = {
    "inside": (32, 24, dict(early_exit=True, head_steps=2, tail_chunks=4,
                            coarse_factor=2)),
    "block_tail": (32, 24, dict(early_exit=True, head_steps=0,
                                tail_chunks=4, coarse_factor=2)),
    "replicated": (24, 24, dict(early_exit=True, head_steps=2,
                                tail_chunks=4, coarse_factor=4)),
    "replicated_block_tail": (24, 24, dict(early_exit=True, head_steps=0,
                                           tail_chunks=4, coarse_factor=4)),
}


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("case", sorted(CONE_CASES))
def test_pixel_render_cone_schedules(worlds, scene, n, case):
    height, width, knobs = CONE_CASES[case]
    got = _pixels(worlds, scene, n, height, table="brick", width=width,
                  **knobs)
    port, ref = _singles(scene, height, table="brick", width=width, **knobs)
    np.testing.assert_allclose(got, ref, atol=1e-5)
    np.testing.assert_allclose(got, port, atol=1e-5)
    # The cone contract against the plain march: no surface skipped.
    base, _ = _singles(scene, height, table="brick", width=width,
                       early_exit=True)
    assert ((base < 99.0) <= (got < 99.0)).all()


def test_block_tail_escape_certificates_fire(scene):
    """The escape certificate retires rays on the block-tail frame (most
    rays pass the small box), or the block-tail case would be vacuous."""
    _, sdf, _, _ = scene
    cam, _ = _cameras(32)
    _, _, _, esc = render._cone_prepass(
        sdf, cam, 2, N_STEPS, 0.25 * sdf.resolution, 100.0,
        sdf_query.build_corner_table(sdf))
    assert float(esc.float().mean()) > 0.1


def test_cone_prepass_raw_sample_fn(scene):
    """``raw_sample_fn`` replaces the prepass's sampler: the table's own
    sampler through it gives the same certificates."""
    _, sdf, _, _ = scene
    cam, _ = _cameras(16)
    table = sdf_query.build_corner_table(sdf)
    calls = []

    def sampler(pos):
        calls.append(pos.shape)
        return sdf_query.estimate_location_distance_fast(sdf, table, pos)

    args = (sdf, cam, 8, N_STEPS, 0.25 * sdf.resolution, 100.0)
    ref = render._cone_prepass(*args, table, max_cone_steps=16,
                               cone_tail_chunks=4)
    got = render._cone_prepass(*args, None, max_cone_steps=16,
                               cone_tail_chunks=4, raw_sample_fn=sampler)
    assert calls
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# -- Grid-sharded ---------------------------------------------------------------


def _slabs_along(axis):
    spec = [None, None, None]
    spec[axis] = "z"
    return P(*spec)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gax,k,rc", [(2, 1, 1), (2, 4, 16), (2, 8, 4),
                                      (0, 8, 16), (0, 32, 4), (1, 8, 16)])
def test_grid_sharded_render_every_schedule(worlds, scene, fixed_refs, n,
                                            gax, k, rc):
    """A ray's samples and budget do not depend on the schedule: every
    (grid_axis, steps_per_exchange, ray_chunks) gives the single-device
    depths."""
    d, _, _, spec = scene
    depth, phases = worlds[n].run(
        targets.render_grid, d, spec, np.eye(4), _camera_dict(16),
        in_specs=(_slabs_along(gax), None, None, None),
        out_specs=(P(), P()), grid_axis=gax, num_steps=N_STEPS,
        steps_per_exchange=k, ray_chunks=rc)
    port, ref = fixed_refs
    np.testing.assert_allclose(depth, ref, atol=1e-4, err_msg=f"{gax} {k}")
    np.testing.assert_allclose(depth, port, atol=1e-4)
    assert phases > 0


@pytest.fixture(scope="module")
def mesh4():
    return jmesh_utils.make_mesh(("z",), (4,), jax.devices()[:4])


@pytest.fixture(scope="module")
def table_single(scene):
    """The single-device table march (the JAX and the port's)."""
    _, sdf, jsdf, _ = scene
    cam, jcam = _cameras(16)
    port = render.sphere_trace(
        sdf, *render.camera_rays(cam), num_steps=N_STEPS,
        corner_table=sdf_query.build_corner_table(sdf), early_exit=True,
        tail_chunks=1).depth.numpy()
    ref = np.asarray(jrender.sphere_trace(
        jsdf, *jrender.camera_rays(jcam), num_steps=N_STEPS,
        corner_table=jsq.build_corner_table(jsdf), early_exit=True,
        tail_chunks=1).depth)
    return port, ref


@pytest.mark.parametrize("gax", [0, 2])
def test_slab_table_matches_jax_sharded(worlds, scene, mesh4, gax):
    d, _, jsdf, spec = scene
    rows = worlds[4].run(rank_targets.slab_table, d, spec, np.eye(4), gax,
                         in_specs=(_slabs_along(gax), None, None, None),
                         out_specs=P("z"))
    ref = jax.jit(lambda x: jsharded.sharded_build_corner_table(
        jsdf.replace(distances=x), mesh4, grid_axis=gax).rows)(
            jsdf.distances)
    # Every row, the last rank's wrapped top row included.
    np.testing.assert_array_equal(rows, np.asarray(ref))


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("gax", [0, 2])
def test_grid_sharded_slab_table_render(worlds, scene, table_single, n,
                                        gax):
    """With the slab table the grid-sharded march is the single-device
    table march bit for bit, whatever its schedule."""
    d, _, _, spec = scene
    outs = []
    for k, rc in [(32, 1), (4, 16), (8, 4)]:
        depth, _ = worlds[n].run(
            targets.render_grid, d, spec, np.eye(4), _camera_dict(16),
            in_specs=(_slabs_along(gax), None, None, None),
            out_specs=(P(), P()), grid_axis=gax, table=True,
            num_steps=N_STEPS, steps_per_exchange=k, ray_chunks=rc)
        outs.append(depth)
    port, ref = table_single
    np.testing.assert_allclose(outs[0], ref, atol=1e-5)
    np.testing.assert_array_equal(outs[0], port)
    for o in outs[1:]:
        np.testing.assert_array_equal(outs[0], o)


def test_grid_sharded_render_matches_jax_sharded(worlds, scene, mesh4):
    d, _, jsdf, spec = scene
    _, jcam = _cameras(16)
    depth, _ = worlds[4].run(
        targets.render_grid, d, spec, np.eye(4), _camera_dict(16),
        in_specs=(P("z"), None, None, None), out_specs=(P(), P()),
        grid_axis=0, table=True, num_steps=N_STEPS, steps_per_exchange=8,
        ray_chunks=4)
    ref = jax.jit(lambda x: jsharded.sharded_render_depth_grid_sharded(
        jsdf.replace(distances=x), jcam, mesh4, grid_axis=0,
        num_steps=N_STEPS, steps_per_exchange=8, ray_chunks=4,
        corner_rows=jsharded.sharded_build_corner_table(
            jsdf.replace(distances=x), mesh4, grid_axis=0)))(jsdf.distances)
    np.testing.assert_allclose(depth, np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("n", SIZES)
def test_grid_sharded_cone_prepass_contract(worlds, scene, table_single, n):
    """The cone prepass with every sample summed over the ranks: hits a
    superset of the plain march's, common depths within the convergence
    band, and the hit mask of the single-device cone render."""
    d, sdf, jsdf, spec = scene
    depth, _ = worlds[n].run(
        targets.render_grid, d, spec, np.eye(4), _camera_dict(16),
        in_specs=(P("z"), None, None, None), out_specs=(P(), P()),
        grid_axis=0, table=True, num_steps=N_STEPS, coarse_factor=8,
        cone_steps=16, cone_tail_chunks=4)
    plain, _ = table_single
    base_hit, cone_hit = plain < 99.0, depth < 99.0
    assert (base_hit <= cone_hit).all(), "prepass skipped a surface"
    m = base_hit & cone_hit
    np.testing.assert_allclose(depth[m], plain[m],
                               atol=2.0 * 0.25 * sdf.resolution + 1e-6)
    knobs = dict(early_exit=True, coarse_factor=8, head_steps=0,
                 tail_chunks=8, cone_steps=16, cone_tail_chunks=4)
    port, ref = _singles(scene, 16, table="brick", **knobs)
    np.testing.assert_array_equal(cone_hit, port < 99.0)
    np.testing.assert_array_equal(cone_hit, ref < 99.0)


# -- Guards ---------------------------------------------------------------------


def _guard_mesh(n=4):
    return mesh_utils.Mesh("z", n, 0, "cpu")


def test_pixel_render_guards(scene):
    _, sdf, _, _ = scene
    cam, _ = _cameras(18)
    with pytest.raises(ValueError, match="must divide camera height"):
        sharded.sharded_render_depth(sdf, cam, _guard_mesh())
    cam, _ = _cameras(16)
    with pytest.raises(ValueError, match="must divide the image"):
        sharded.sharded_render_depth(sdf, cam, _guard_mesh(), coarse_factor=5)


def test_slab_table_guards(scene):
    _, sdf, _, _ = scene
    cam, _ = _cameras(16)
    slab = sdf.replace(distances=sdf.distances[:4])
    with pytest.raises(ValueError, match="grid_axis must be"):
        sharded.sharded_build_corner_table(slab, _guard_mesh(), grid_axis=3)
    with pytest.raises(ValueError, match="must divide counts"):
        sharded.sharded_build_corner_table(sdf, _guard_mesh(3), grid_axis=0)
    with pytest.raises(ValueError, match="this rank's slab"):
        sharded.sharded_build_corner_table(sdf, _guard_mesh(), grid_axis=0)
    with pytest.raises(ValueError, match="grid_axis must be"):
        sharded.sharded_render_depth_grid_sharded(slab, cam, _guard_mesh(),
                                                  grid_axis=-1)
    with pytest.raises(ValueError, match="must divide counts"):
        sharded.sharded_render_depth_grid_sharded(sdf, cam, _guard_mesh(3),
                                                  grid_axis=0)
    with pytest.raises(ValueError, match="must divide the image"):
        sharded.sharded_render_depth_grid_sharded(
            slab, cam, _guard_mesh(), grid_axis=0, coarse_factor=5)
    table = sharded.SlabCornerTable(rows=torch.zeros(4 * 256, 8),
                                    grid_axis=0)
    with pytest.raises(ValueError, match="grid_axis"):
        sharded.sharded_render_depth_grid_sharded(
            sdf.replace(distances=sdf.distances[:, :, :4]), cam,
            _guard_mesh(), grid_axis=2, corner_rows=table)
    with pytest.raises(TypeError, match="SlabCornerTable"):
        sharded.sharded_render_depth_grid_sharded(
            slab, cam, _guard_mesh(), grid_axis=0, corner_rows=table.rows)
    with pytest.raises(ValueError, match="does not match"):
        sharded.sharded_render_depth_grid_sharded(
            slab, cam, _guard_mesh(), grid_axis=0,
            corner_rows=sharded.SlabCornerTable(torch.zeros(8, 8), 0))


# -- The multichip dryrun -------------------------------------------------------

DRYRUN_SPECS = {"loss": P(), "grad_d": SLABS, "new_d": SLABS, "grad_t": P(),
                "new_t": P(), "depth_gs": P()}


@pytest.fixture(scope="module")
def one_rank():
    world = launch.World(1, device="cpu")
    yield world
    world.close()


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_multichip_matches_one_rank(one_rank, n):
    """dryrun_multichip(n) at its own shapes against the same step in a
    one-rank world. At n < 8 the scene's field holds +inf, whose
    interpolation makes the pose gradient NaN in the JAX package's step
    as in the port's (its own dryrun asserts a finite update only at its
    n = 8): the NaNs must sit in the same places."""
    out = entry.dryrun_multichip(n, device="cpu")
    one = one_rank.run(entry._dryrun_rank, out_specs=DRYRUN_SPECS, scene_n=n)
    assert np.isfinite(out["loss"])
    for key in DRYRUN_SPECS:
        np.testing.assert_allclose(out[key], one[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


@pytest.mark.parametrize("n", SIZES)
def test_dryrun_step_gradients_match_one_rank(worlds, one_rank, n):
    """The 8-rank scene of the JAX package's own dryrun, whose pose
    gradient is finite, in worlds of 2 and 4 against one rank."""
    out = worlds[n].run(entry._dryrun_rank, out_specs=DRYRUN_SPECS,
                        scene_n=8)
    one = one_rank.run(entry._dryrun_rank, out_specs=DRYRUN_SPECS, scene_n=8)
    assert np.isfinite(out["grad_t"]).all() and np.abs(out["grad_t"]).max()
    assert np.abs(out["grad_d"]).max() > 0
    for key in DRYRUN_SPECS:
        np.testing.assert_allclose(out[key], one[key], rtol=1e-5, atol=1e-5,
                                   err_msg=key)


def _jax_dryrun(mesh, scene_n):
    """The JAX package's multichip training step (``dryrun_multichip`` of
    the repository's ``__graft_entry__.py``), rebuilt from its sharded
    functions on ``mesh`` for ``scene_n``'s scene, with the gradients
    returned beside the updates."""
    import dataclasses

    import jax.numpy as jnp
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as JP

    from voxelized_geometry_tools_tpu import OccupancyMap as JOccupancyMap
    from voxelized_geometry_tools_tpu.models.fusion_pipeline import (
        perturb_pose)
    from voxelized_geometry_tools_tpu.ops import voxelize as jvoxelize

    n = scene_n
    counts = (2 * n, 8, 2 * n)
    spec = JGridSpec.from_voxel_counts(0.25, counts)
    env = JOccupancyMap.create(spec, None, "world")
    grid_sizes = np.asarray(spec.grid_sizes)
    uv = np.stack(np.meshgrid(np.linspace(-0.4, 0.4, 8),
                              np.linspace(-0.4, 0.4, 8), indexing="ij"), -1)
    pts = np.concatenate(
        [uv, np.full((8, 8, 1), 0.6 * grid_sizes[2])], -1).reshape(-1, 3)
    cam_pose = np.eye(4, dtype=np.float32)
    cam_pose[:3, 3] = grid_sizes / 2.0 - np.array([0, 0, grid_sizes[2]])
    cloud = jvoxelize.PointCloud.create(pts.astype(np.float32), cam_pose)
    height = max(2 * n, 8)
    camera = jrender.PinholeCamera.create(cam_pose, width=8, height=height,
                                          focal=8.0)
    target = jnp.full((height, 8), 0.6 * float(grid_sizes[2]), jnp.float32)
    lr = 0.05

    def train_step(occupancy, points, distances_prev, tangent):
        carved = jsharded.sharded_voxelize_pointclouds(
            env.replace(occupancy=occupancy), jvoxelize.FilterOptions(),
            [dataclasses.replace(cloud, points=points)], mesh)
        sdf = jsharded.sharded_extract_sdf(
            carved.occupancy, spec, carved.origin_transform, mesh)
        distances = 0.5 * sdf.distances + 0.5 * distances_prev

        def loss_fn(params):
            d, t = params
            cam = dataclasses.replace(camera,
                                      pose=perturb_pose(camera.pose, t))
            depth = jsharded.sharded_render_depth(
                sdf.replace(distances=d), cam, mesh, num_steps=16)
            return jnp.mean((depth - target) ** 2)

        loss, grads = jax.value_and_grad(loss_fn)((distances, tangent))
        return (loss, grads[0], distances - lr * grads[0], grads[1],
                tangent - lr * grads[1])

    slabs = NamedSharding(mesh, JP(None, None, "z"))
    repl = NamedSharding(mesh, JP())
    loss, grad_d, new_d, grad_t, new_t = jax.jit(train_step)(
        jax.device_put(env.occupancy, repl),
        jax.device_put(cloud.points, NamedSharding(mesh, JP("z"))),
        jax.device_put(jnp.zeros(spec.counts, jnp.float32), slabs),
        jax.device_put(jnp.zeros(6, jnp.float32), repl))

    filled = np.zeros(counts, bool)
    filled[counts[0] // 4: counts[0] // 2, 2:6,
           counts[2] // 4: counts[2] // 2] = True
    occ2 = jax.device_put(jnp.asarray(filled, jnp.float32), slabs)
    sdf2 = jax.jit(lambda o: jsharded.sharded_extract_sdf(
        o, spec, jnp.eye(4), mesh))(occ2)
    table = jax.jit(lambda d: jsharded.sharded_build_corner_table(
        sdf2.replace(distances=d), mesh, grid_axis=0))(sdf2.distances)
    cf = 4 if (camera.width % 4 == 0 and height % 4 == 0) else 2
    depth_gs = jax.jit(
        lambda d, r: jsharded.sharded_render_depth_grid_sharded(
            sdf2.replace(distances=d), camera, mesh, grid_axis=0,
            num_steps=16, corner_rows=r, coarse_factor=cf, cone_steps=8,
            cone_tail_chunks=2, steps_per_exchange=16, ray_chunks=4))(
                sdf2.distances, table)
    return {k: np.asarray(v) for k, v in dict(
        loss=loss, grad_d=grad_d, new_d=new_d, grad_t=grad_t, new_t=new_t,
        depth_gs=depth_gs).items()}


@pytest.mark.parametrize("scene_n", [4, 8])
def test_dryrun_step_matches_jax_train_step(worlds, scene_n):
    """The port's sharded training step in a world of 4 against the JAX
    package's on ``scene_n`` virtual devices (its own dryrun's mesh):
    loss, gradients, SGD updates and the grid-sharded depth image within
    1e-5. At ``scene_n`` 4 every pixel misses, the voxels' gradient is
    zero and the pose gradient NaN in both (the field holds +inf), in the
    same places."""
    out = worlds[4].run(entry._dryrun_rank, out_specs=DRYRUN_SPECS,
                        scene_n=scene_n)
    ref = _jax_dryrun(jmesh_utils.make_mesh(
        ("z",), (scene_n,), jax.devices()[:scene_n]), scene_n)
    assert np.isfinite(ref["loss"])
    # At scene_n 8 the step moves both the voxels and the pose.
    assert (np.abs(ref["grad_d"]).max() > 0) == (scene_n == 8)
    assert np.isfinite(ref["new_t"]).all() == (scene_n == 8)
    for key in DRYRUN_SPECS:
        np.testing.assert_allclose(out[key], ref[key], rtol=1e-5, atol=1e-5,
                                   equal_nan=True, err_msg=key)

