"""The port's sharded functions (``parallel/``) in gloo worlds of 2 and 4
CPU ranks, against the JAX package's single-device functions (which
tests/test_sharded.py holds equal to its sharded ones) and the port's own
single-device functions, on the inputs of tests/test_sharded.py: the
collectives against numpy models, the EDT, signed EDT, SDF, carve and
voxelize pipeline bit for bit, the isosurface's counts, flags and order
exactly, every guard, and the launcher's handling of a failing rank.

The renders and the multichip dryrun are in test_torch_sharded_render.py.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxelized_geometry_tools_tpu import GridSpec as JGridSpec
from voxelized_geometry_tools_tpu import OccupancyMap as JOccupancyMap
from voxelized_geometry_tools_tpu.core.maps import (
    SignedDistanceField as JSignedDistanceField)
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import isosurface as jiso
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import GridSpec, interop
from voxelized_geometry_tools_tpu_torch.core.maps import (OccupancyMap,
                                                          SignedDistanceField)
from voxelized_geometry_tools_tpu_torch.ops import edt, isosurface, voxelize
from voxelized_geometry_tools_tpu_torch.parallel import (
    launch, mesh_utils, sharded, targets)

import _torch_rank_targets as rank_targets

P = mesh_utils.P
SLABS = P(None, None, "z")
SIZES = (2, 4)


@pytest.fixture(scope="module")
def worlds():
    """A gloo world of each size, shared by the module's tests."""
    opened = {n: launch.World(n, device="cpu") for n in SIZES}
    yield opened
    for w in opened.values():
        w.close()


def _guard_mesh(n=4):
    """A mesh of ``n`` whose group was never started: the guards run
    before any collective."""
    return mesh_utils.Mesh("z", n, 0, "cpu")


# -- Collectives ---------------------------------------------------------------


def _split(x, n, axis):
    return np.split(x, n, axis=axis)


@pytest.mark.parametrize("n", SIZES)
def test_collectives_match_numpy_models(worlds, n):
    rng = np.random.default_rng(5)
    g = rng.integers(-50, 50, (4 * n, 3, 2 * n)).astype(np.float32)
    outs = worlds[n].run(rank_targets.collectives_probe, g,
                         in_specs=(P("z"),))
    xs = _split(g, n, 0)  # rank r's block
    for r, o in enumerate(outs):
        # all_to_all(split 0, concat 2): block r of every rank's axis 0,
        # rank i's at block i of axis 2.
        want = np.concatenate([_split(x, n, 0)[r] for x in xs], axis=2)
        np.testing.assert_array_equal(o["a2a_0_2"], want)
        np.testing.assert_array_equal(o["a2a_2_0"], xs[r])
        rep = [np.tile(x, (1, n, 1)) for x in xs]
        want = np.concatenate([_split(x, n, 1)[r] for x in rep], axis=0)
        np.testing.assert_array_equal(o["a2a_1_0"], want)
        scaled = [x * (i + 1) for i, x in enumerate(xs)]
        total = np.sum(scaled, axis=0)
        np.testing.assert_array_equal(o["rs_0"], _split(total, n, 0)[r])
        tiled = np.sum([np.tile(s, (1, 1, n)) for s in scaled], axis=0)
        np.testing.assert_array_equal(o["rs_2"], _split(tiled, n, 2)[r])
        np.testing.assert_array_equal(o["sum"], total)
        np.testing.assert_array_equal(o["min"], np.min(scaled, axis=0))
        np.testing.assert_array_equal(o["max"], np.max(scaled, axis=0))
        np.testing.assert_array_equal(o["gather_1"],
                                      np.concatenate(xs, axis=1))
        # ppermute s + 1 -> s, with and without the wrap.
        np.testing.assert_array_equal(o["next_wrap"], xs[(r + 1) % n])
        want = xs[r + 1] if r < n - 1 else np.zeros_like(xs[r])
        np.testing.assert_array_equal(o["next"], want)
        stats = o["stats"]
        assert stats["calls"]["all_to_all"] == 4
        assert stats["calls"]["ppermute"] == 2
        assert stats["bytes"]["all_reduce"] == 3 * xs[r].nbytes
        assert stats["staged_bytes"] == 0
        # A mesh without stats times nothing and gives the same values.
        np.testing.assert_array_equal(o["untimed"], total)


def test_host_staging_follows_transport_and_device():
    """gloo with a CUDA device stages each collective through host memory;
    gloo on the CPU and NCCL do not."""
    assert mesh_utils.Mesh("z", 2, 0, "cuda", "gloo").host_staged
    assert not mesh_utils.Mesh("z", 2, 0, "cpu", "gloo").host_staged
    assert not mesh_utils.Mesh("z", 2, 0, "cuda", "nccl").host_staged
    assert "staged through host memory" in mesh_utils.Mesh(
        "z", 2, 1, "cuda:0", "gloo").describe()


def test_failing_rank_fails_the_call_within_the_timeout():
    with launch.World(2, device="cpu") as world:
        t0 = time.monotonic()
        with pytest.raises(launch.RankError, match="rank 1 failed on purpose"):
            world.run(rank_targets.fail_on_rank, 1)
        assert time.monotonic() - t0 < launch.GRACE + 30
        assert not world.running
        # The next call starts a fresh world.
        out = world.run(rank_targets.fail_on_rank, 5, out_specs=P())
        np.testing.assert_array_equal(out, np.full(4, 2.0))


def _imports_jax_target(mesh):
    return mesh.rank


def test_launcher_refuses_jax_targets_and_defaults_to_the_card(worlds,
                                                               monkeypatch):
    """A target must be a module-level function whose module imports no
    JAX, and a world asks for the card unless told the CPU."""
    with pytest.raises(ValueError, match="module-level function"):
        worlds[2].run(lambda mesh: mesh.rank)
    with pytest.raises(ValueError, match="imports jax"):
        worlds[2].run(_imports_jax_target)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.World(2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch.run(2, rank_targets.fail_on_rank, 5)


def test_shard_and_gather_round_trip():
    x = np.arange(2 * 3 * 8).reshape(2, 3, 8)
    parts = [mesh_utils.shard(x, SLABS, 4, r) for r in range(4)]
    assert parts[1].shape == (2, 3, 2)
    np.testing.assert_array_equal(mesh_utils.gather(parts, SLABS), x)
    assert mesh_utils.shard(x, P(), 4, 2) is x
    with pytest.raises(ValueError, match="must divide axis 0"):
        mesh_utils.shard(x, P("z"), 4, 0)
    mesh = _guard_mesh()
    assert mesh_utils.grid_sharding(mesh).spec == SLABS
    assert mesh_utils.ray_sharding(mesh).spec == P("z")
    assert mesh_utils.replicated(mesh).spec == P()
    assert mesh.shape == {"z": 4} and not mesh.host_staged


# -- EDT ------------------------------------------------------------------------


@pytest.fixture(scope="module")
def edt_seed():
    rng = np.random.default_rng(17)
    seed = rng.random((16, 8, 24)) < 0.15
    seed[3, 3, 3] = True
    return seed


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("backend", ["auto", "plain", "xla"])
def test_sharded_squared_edt_bitwise(worlds, edt_seed, n, backend):
    ref = np.asarray(jax.jit(jedt.squared_edt)(jnp.asarray(edt_seed)))
    port = edt.squared_edt(torch.from_numpy(edt_seed)).numpy()
    got = worlds[n].run(rank_targets.squared_edt, edt_seed, in_specs=(SLABS,),
                        out_specs=SLABS, backend=backend)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, port)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_signed_distance_bitwise(worlds, edt_seed, n):
    ref = np.asarray(jax.jit(lambda m: jedt.signed_distance_from_filled_mask(
        m, 0.25))(jnp.asarray(edt_seed)))
    port = edt.signed_distance_from_filled_mask(torch.from_numpy(edt_seed),
                                                0.25).numpy()
    got = worlds[n].run(rank_targets.signed_distance, edt_seed, 0.25,
                        in_specs=(SLABS, None), out_specs=SLABS)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, port)


@pytest.mark.parametrize("n", SIZES)
def test_sharded_sdf_bitwise(worlds, n):
    rng = np.random.default_rng(23)
    occ = (rng.random((8, 8, 16)) < 0.2).astype(np.float32)
    occ[1, 2, 3] = 0.5  # unknown counts as filled
    jspec = JGridSpec.from_voxel_counts(0.25, occ.shape)
    ref = jax.jit(lambda o: jedt.extract_sdf_from_occupancy(
        o, jspec, None))(jnp.asarray(occ))
    spec = GridSpec.from_voxel_counts(0.25, occ.shape)
    port = edt.extract_sdf_from_occupancy(torch.from_numpy(occ), spec, None)
    d, mn, mx = worlds[n].run(targets.extract_sdf, occ, spec, np.eye(4),
                              in_specs=(SLABS, None, None),
                              out_specs=(SLABS, P(), P()))
    np.testing.assert_array_equal(d, np.asarray(ref.distances))
    np.testing.assert_array_equal(d, port.distances.numpy())
    # The locked extrema are the whole field's, on every rank.
    assert mn == float(port.minimum) and mx == float(port.maximum)


# -- Carving --------------------------------------------------------------------


def _carve_scene():
    """tests/test_sharded.py's reduce-scatter scene, with one more ray so
    that neither world size divides the ray count."""
    rng = np.random.default_rng(41)
    spec = JGridSpec.from_voxel_counts(0.25, (16, 16, 16))
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, -1.0)
    pts = rng.uniform(-1.0, 5.0, (1501, 3)).astype(np.float32)
    return spec, pose, pts, 8.0


@pytest.fixture(scope="module")
def carve_refs():
    """The JAX package's and the port's single-device walks of the carve
    scene (the compiled JAX walk agrees with its op-by-op walk on it)."""
    jspec, pose, pts, max_range = _carve_scene()
    cloud = jv.PointCloud.create(pts, pose, max_range=max_range)
    ref = jax.jit(lambda c: jv.raycast_pointcloud(jspec, jnp.eye(4), c))(
        cloud)
    spec = GridSpec(jspec.counts, jspec.resolution)
    port = voxelize.raycast_pointcloud(
        spec, torch.eye(4), interop.pointcloud_from_numpy(
            pts, pose, max_range, device="cpu"))
    return ref, port


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("reduce", ["all", "scatter"])
@pytest.mark.parametrize("run_axis", ["auto", "split", 0, 1, 2, None])
def test_sharded_carve_bitwise(worlds, carve_refs, n, reduce, run_axis):
    jspec, pose, pts, max_range = _carve_scene()
    spec = GridSpec(jspec.counts, jspec.resolution)
    spec_out = SLABS if reduce == "scatter" else P()
    free, filled = worlds[n].run(
        rank_targets.raycast, spec, np.eye(4, dtype=np.float32),
        (pts, pose, max_range), out_specs=(spec_out, spec_out),
        run_axis=run_axis, reduce=reduce)
    ref, port = carve_refs
    np.testing.assert_array_equal(free, np.asarray(ref.seen_free))
    np.testing.assert_array_equal(filled, np.asarray(ref.seen_filled))
    np.testing.assert_array_equal(free, port.seen_free.numpy())
    np.testing.assert_array_equal(filled, port.seen_filled.numpy())


def _pipeline_scene(nz):
    rng = np.random.default_rng(43)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (2.0, 2.0, -1.0)
    clouds = [(rng.uniform(-1.0, 5.0, (700, 3)).astype(np.float32), pose,
               8.0) for _ in range(2)]
    return (16, 16, nz), clouds


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("nz", [16, 15])
def test_sharded_voxelize_pipeline_bitwise(worlds, n, nz):
    """Slab-sharded (n | nz) and replicated (15) fusion against the JAX
    package's and the port's single-device VoxelizePointClouds."""
    counts, clouds = _pipeline_scene(nz)
    occ0 = np.full(counts, 0.5, np.float32)
    occ0[3, 4, 5] = 1.0  # a static filled cell stays
    opts = (0.5, 1, 1)
    jspec = JGridSpec.from_voxel_counts(0.25, counts)
    jenv = JOccupancyMap.create(jspec).replace(occupancy=jnp.asarray(occ0))
    ref = jax.jit(lambda cs: jv.voxelize_pointclouds(
        jenv, jv.FilterOptions(*opts), cs))(
            [jv.PointCloud.create(p, q, max_range=m) for p, q, m in clouds])
    spec = GridSpec.from_voxel_counts(0.25, counts)
    env = OccupancyMap.create(spec, device="cpu").replace(
        occupancy=torch.from_numpy(occ0))
    port = voxelize.voxelize_pointclouds(
        env, voxelize.FilterOptions(*opts),
        [interop.pointcloud_from_numpy(p, q, m, device="cpu")
         for p, q, m in clouds])
    out_spec = SLABS if nz % n == 0 else P()
    got = worlds[n].run(targets.voxelize_pointclouds, spec, np.eye(4),
                        occ0, opts, clouds, out_specs=out_spec)
    np.testing.assert_array_equal(got, np.asarray(ref.occupancy))
    np.testing.assert_array_equal(got, port.occupancy.numpy())


# -- Isosurface -----------------------------------------------------------------


def _iso_field():
    n, res = 32, 0.1
    ax = np.arange(n, dtype=np.float32) - (n - 1) / 2.0
    r = np.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                + ax[None, None, :] ** 2)
    shift = np.eye(4, dtype=np.float32)
    shift[:3, 3] = (0.5, -1.0, 2.0)
    return n, res, ((r - 8.0) * res).astype(np.float32), shift


@pytest.fixture(scope="module")
def iso_refs():
    n, res, d, shift = _iso_field()
    jspec = JGridSpec.from_voxel_counts(res, (n, n, n))
    jsdf = JSignedDistanceField.create(jspec, jnp.asarray(d),
                                       jnp.asarray(shift), locked=True)
    ref = jiso.extract_isosurface(jsdf, max_triangles=16384)
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    sdf = SignedDistanceField.create(spec, torch.from_numpy(d), shift,
                                     locked=True)
    return ref, isosurface.extract_isosurface(sdf, max_triangles=16384)


@pytest.mark.parametrize("n_ranks", SIZES)
def test_sharded_isosurface_matches_single_device(worlds, iso_refs, n_ranks):
    n, res, d, shift = _iso_field()
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    ref, port = iso_refs
    out = worlds[n_ranks].run(
        rank_targets.isosurface, d, spec, shift, in_specs=(P("z"), None, None),
        out_specs={"vertices": P("z"), "valid": P("z"), "count": P("z"),
                   "overflowed": P("z"), "counts": P()},
        max_triangles_per_shard=4096)
    counts = out["counts"]
    assert counts.shape == (n_ranks,)
    np.testing.assert_array_equal(out["count"], counts)
    assert (counts <= 4096).all() and not out["overflowed"].any()
    total = int(port.num_triangles)
    assert total == int(ref.num_triangles) == int(counts.sum())
    v_multi = out["vertices"][out["valid"]]
    assert v_multi.shape[0] == total
    # Same cubes, same operations, rank order: the port's single-device
    # triangles bit for bit, the JAX package's within the compiled sweep's
    # fused multiply-adds (test_torch_isosurface.py's tolerance).
    np.testing.assert_array_equal(v_multi, port.vertices[port.valid].numpy())
    v_ref = np.asarray(ref.vertices)[np.asarray(ref.valid)]
    np.testing.assert_allclose(v_multi, v_ref, rtol=0,
                               atol=2.0 ** -21 * n * res + 1e-6)


def test_sharded_isosurface_per_shard_overflow(worlds, iso_refs):
    """A shard that drops triangles is flagged even when the total fits
    the whole capacity; the gathered mesh refuses to weld."""
    n, res, d, shift = _iso_field()
    spec = GridSpec.from_voxel_counts(res, (n, n, n))
    _, port = iso_refs
    out = worlds[4].run(
        rank_targets.isosurface, d, spec, shift, in_specs=(P("z"), None, None),
        out_specs={"vertices": P("z"), "valid": P("z"), "count": P("z"),
                   "overflowed": P("z"), "counts": P(),
                   "gathered_overflowed": P(), "gathered_total": P(),
                   "gathered_capacity": P()},
        max_triangles_per_shard=8, gathered=True)
    assert (out["counts"] > 8).any()
    np.testing.assert_array_equal(out["overflowed"], out["counts"] > 8)
    assert int(out["gathered_total"]) == int(port.num_triangles)
    assert bool(out["gathered_overflowed"])
    assert int(out["gathered_capacity"]) == 4 * 8
    small = isosurface.IsoMesh(
        vertices=torch.from_numpy(out["vertices"]),
        valid=torch.from_numpy(out["valid"]),
        num_triangles=torch.tensor(int(out["counts"].sum())),
        shard_counts=torch.from_numpy(out["counts"]))
    with pytest.raises(ValueError, match="overflowed"):
        isosurface.weld_vertices(small)
    # Totals within the whole capacity, one shard over its own.
    skewed = small._replace(num_triangles=torch.tensor(20),
                            shard_counts=torch.tensor([20, 0, 0, 0]))
    assert int(skewed.num_triangles) < skewed.capacity
    assert bool(skewed.overflowed)


# -- Guards ---------------------------------------------------------------------


def test_edt_guards():
    mesh = _guard_mesh()
    with pytest.raises(ValueError, match="Unknown EDT backend"):
        sharded.sharded_squared_edt(torch.zeros(8, 4, 2, dtype=torch.bool),
                                    mesh, backend="nope")
    with pytest.raises(ValueError, match="must divide both"):
        sharded.sharded_signed_distance(
            torch.zeros(6, 4, 2, dtype=torch.bool), 0.1, mesh)
    with pytest.raises(ValueError, match="must divide both"):
        sharded._check_edt_sharding((8, 4, 6), 4, "pallas-bestfirst")
    with pytest.raises(ValueError, match="no axis"):
        sharded.sharded_squared_edt(torch.zeros(8, 4, 2, dtype=torch.bool),
                                    mesh, axis_name="x")


def _cpu_cloud(n_pts=10):
    return voxelize.PointCloud.create(torch.ones(n_pts, 3), device="cpu")


def test_carve_guards():
    mesh = _guard_mesh()
    spec = GridSpec.from_voxel_counts(0.25, (16, 16, 15))
    with pytest.raises(ValueError, match="Unknown run_axis"):
        sharded.sharded_raycast_pointcloud(spec, torch.eye(4), _cpu_cloud(),
                                           mesh, run_axis="diagonal")
    with pytest.raises(ValueError, match="Unknown reduce mode"):
        sharded.sharded_raycast_pointcloud(spec, torch.eye(4), _cpu_cloud(),
                                           mesh, run_axis=2, reduce="mean")
    with pytest.raises(ValueError, match="divide nz"):
        sharded.sharded_raycast_pointcloud(spec, torch.eye(4), _cpu_cloud(),
                                           mesh, run_axis=2,
                                           reduce="scatter")
    env = OccupancyMap.create(spec, device="cpu")
    with pytest.raises(ValueError, match="percent_seen_free"):
        sharded.sharded_voxelize_pointclouds(
            env, voxelize.FilterOptions(0.0, 1, 1), [], mesh)


def test_isosurface_guards():
    for counts, n, match in [((30, 8, 8), 4, "must divide nx"),
                             ((4, 8, 8), 4, ">= 2 planes"),
                             ((8, 8, 8), 2, "X slab has 4")]:
        spec = GridSpec.from_voxel_counts(0.1, counts)
        sdf = SignedDistanceField.create(spec, torch.ones(counts))
        with pytest.raises(ValueError, match=match):
            sharded.sharded_extract_isosurface(sdf, _guard_mesh(n))
