"""The JAX package's public callables that no other port test names, each
against its port twin on the same seeded inputs, on the CPU.

Every case is bitwise: index math, masks, selections, markers and
colours are exact, and the float results (transforms, interpolation,
closest points, EDT distances) come from the same operations rounded in
the same order in both packages. Two isosurface meshes extracted apart
agree within ``2^-21 n res`` (tests/test_torch_isosurface.py's
tolerance). ``jnp.cross`` is compiled even in an eager call, so it fuses
multiply-adds; on a triangle with a repeated vertex or collinear corners
that moves the JAX package's inside test, and the port follows the JAX
package run op by op there (``jax.disable_jit()``), as
tests/test_torch_mesh.py records for the rasterizer."""

import ctypes
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import voxelized_geometry_tools_tpu as jvgt
from voxelized_geometry_tools_tpu.core import dsh as jdsh
from voxelized_geometry_tools_tpu.core import grid as jgrid
from voxelized_geometry_tools_tpu.core import transforms as jt
from voxelized_geometry_tools_tpu.io import viz as jviz
from voxelized_geometry_tools_tpu.native import loader as jloader
from voxelized_geometry_tools_tpu.ops import backends as jb
from voxelized_geometry_tools_tpu.ops import edt as jedt
from voxelized_geometry_tools_tpu.ops import isosurface as jiso
from voxelized_geometry_tools_tpu.ops import map_ops as jmo
from voxelized_geometry_tools_tpu.ops import mesh as jmesh
from voxelized_geometry_tools_tpu.ops import sdf_query as jq
from voxelized_geometry_tools_tpu.ops import topology as jtopo
import voxelized_geometry_tools_tpu_torch as tvgt
from voxelized_geometry_tools_tpu_torch.core import dsh as tdsh
from voxelized_geometry_tools_tpu_torch.core import grid as tgrid
from voxelized_geometry_tools_tpu_torch.core import transforms as tt
from voxelized_geometry_tools_tpu_torch.core.maps import _bits
from voxelized_geometry_tools_tpu_torch.io import viz as tviz
from voxelized_geometry_tools_tpu_torch.native import loader as tloader
from voxelized_geometry_tools_tpu_torch.ops import backends as tb
from voxelized_geometry_tools_tpu_torch.ops import edt as tedt
from voxelized_geometry_tools_tpu_torch.ops import isosurface as tiso
from voxelized_geometry_tools_tpu_torch.ops import map_ops as tmo
from voxelized_geometry_tools_tpu_torch.ops import mesh as tmesh
from voxelized_geometry_tools_tpu_torch.ops import sdf_query as tq
from voxelized_geometry_tools_tpu_torch.ops import topology as ttopo

from test_torch_isosurface import _sdfs, _sphere_field, assert_meshes_match
from test_torch_map_ops import tagged_scene
from test_torch_serialization_io import _assert_markers_equal, _dsh_pair
from test_torch_transforms_exact import f1_scene, random_isometry

DTYPES = [torch.float32, torch.float64]
JAX_DTYPE = {torch.float32: jnp.float32, torch.float64: jnp.float64}
NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


def assert_same_bits(got, ref):
    """Equal dtype, shape and bit patterns (``-0.0`` and ``0.0`` differ;
    NaNs must sit in the same places with the same bits)."""
    got = _bits(got).numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    if ref.dtype == np.uint32:
        got = got.view(np.uint32)
    assert got.dtype == ref.dtype and got.shape == ref.shape
    if got.dtype.kind == "f":
        width = {2: np.uint16, 4: np.uint32, 8: np.uint64}[got.itemsize]
        got, ref = got.view(width), ref.view(width)
    np.testing.assert_array_equal(got, ref)


def _specs():
    """A uniform spec and one with per-axis voxel sizes, in each package."""
    return [(jvgt.GridSpec.from_voxel_counts(0.05, (7, 5, 9)),
             tvgt.GridSpec.from_voxel_counts(0.05, (7, 5, 9))),
            (jvgt.GridSpec.from_voxel_sizes((0.05, 0.1, 0.025), (6, 4, 8)),
             tvgt.GridSpec.from_voxel_sizes((0.05, 0.1, 0.025), (6, 4, 8)))]


def _indices(rng, counts, n=600):
    """int32 indices ``[n, 3]``, about a third of them out of bounds on
    some axis (negative or past the count)."""
    lo = -np.asarray(counts) // 2
    hi = np.asarray(counts) * 3 // 2
    return rng.integers(lo, hi, (n, 3)).astype(np.int32)


# -- core/grid.py -------------------------------------------------------------


@pytest.mark.parametrize("which", [0, 1])
def test_grid_spec_properties(which):
    """``num_x`` / ``num_y`` / ``num_z``, ``has_uniform_voxel_size``,
    ``enforce_uniform_voxel_size`` (and its ``ValueError``) and
    ``with_counts``, which keeps per-axis voxel sizes."""
    js, ts = _specs()[which]
    assert (ts.num_x, ts.num_y, ts.num_z) == (js.num_x, js.num_y, js.num_z)
    assert ts.has_uniform_voxel_size == js.has_uniform_voxel_size
    if js.has_uniform_voxel_size:
        assert ts.enforce_uniform_voxel_size() is ts
        assert js.enforce_uniform_voxel_size() is js
    else:
        with pytest.raises(ValueError) as jerr:
            js.enforce_uniform_voxel_size()
        with pytest.raises(ValueError) as terr:
            ts.enforce_uniform_voxel_size()
        assert str(terr.value) == str(jerr.value)
    jw, tw = js.with_counts((3.0, 11, 2)), ts.with_counts((3.0, 11, 2))
    assert isinstance(tw, tvgt.GridSpec)
    assert (tw.counts, tw.resolution, tw.voxel_sizes) == (
        jw.counts, jw.resolution, jw.voxel_sizes)
    assert tw.counts == (3, 11, 2)
    assert tw.voxel_sizes == ts.voxel_sizes


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_grid_index_math(which, dtype):
    """``grid_index_to_location_in_grid_frame`` in float32 and float64,
    ``check_grid_index_in_bounds`` on indices in and out of bounds."""
    js, ts = _specs()[which]
    idx = _indices(np.random.default_rng(10 + which), js.counts)
    with jax.enable_x64(dtype == torch.float64):
        ref = js.grid_index_to_location_in_grid_frame(
            jnp.asarray(idx), dtype=JAX_DTYPE[dtype])
        ref_in = js.check_grid_index_in_bounds(jnp.asarray(idx))
    assert_same_bits(ts.grid_index_to_location_in_grid_frame(
        torch.from_numpy(idx), dtype=dtype), ref)
    in_bounds = ts.check_grid_index_in_bounds(torch.from_numpy(idx))
    assert_same_bits(in_bounds, ref_in)
    assert 0 < int(in_bounds.sum()) < len(idx)


@pytest.mark.parametrize("oob_value", [float("inf"), -3.5])
def test_get_index_values(oob_value):
    rng = np.random.default_rng(20)
    data = rng.normal(size=(7, 5, 9)).astype(np.float32)
    idx = _indices(rng, data.shape)
    ref = jgrid.get_index_values(jnp.asarray(data), jnp.asarray(idx),
                                 oob_value)
    got = tgrid.get_index_values(torch.from_numpy(data),
                                 torch.from_numpy(idx), oob_value)
    assert_same_bits(got, ref)
    assert (got.numpy() == np.float32(oob_value)).any()


def _world_points(rng, spec, origin, n=2000):
    """Seeded world points over the grid and a margin of two cells around
    it, a tenth of them on cell faces (grid-frame multiples of the voxel
    size), as float32 ``[n, 4]`` (the fourth column is ignored)."""
    counts = np.asarray(spec.counts)
    sizes = np.asarray(spec.voxel_sizes)
    p_grid = rng.uniform(-2, counts + 2, (n, 3)) * sizes
    faces = rng.integers(-2, counts + 2, (n // 10, 3)) * sizes
    p_grid[: n // 10] = faces
    o = np.asarray(origin, np.float64)
    p_world = p_grid @ o[:3, :3].T + o[:3, 3]
    return np.concatenate([p_world, np.ones((n, 1))], -1).astype(np.float32)


def _origins():
    shifted = np.eye(4, dtype=np.float32)
    shifted[:3, 3] = (-0.1, 0.25, 0.05)
    _, rotated, _ = f1_scene(32, 1, 200)
    return {"shifted": shifted, "f1-rotated": rotated}


@pytest.mark.parametrize("origin_name", ["shifted", "f1-rotated"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_location_to_grid_index_and_bounds(origin_name, dtype):
    """The module functions against the JAX package's, bitwise, on F1's
    rotated origin too, and the port's map method against the JAX
    package's and against the module function; a numpy ``p_world`` goes
    onto the transform's device."""
    origin = _origins()[origin_name].astype(NP_DTYPE[dtype])
    js = jvgt.GridSpec.from_voxel_counts(0.02, (32, 32, 32))
    ts = tvgt.GridSpec.from_voxel_counts(0.02, (32, 32, 32))
    pts = _world_points(np.random.default_rng(30), ts, origin).astype(
        NP_DTYPE[dtype])
    with jax.enable_x64(dtype == torch.float64):
        jinv = jt.invert_isometry(jnp.asarray(origin))
        ref_idx = jgrid.location_to_grid_index(js, jinv, jnp.asarray(pts))
        ref_in = jgrid.check_location_in_bounds(js, jinv, jnp.asarray(pts))
        jmap = jvgt.OccupancyMap.create(js, jnp.asarray(origin))
        ref_method = jmap.location_to_grid_index(jnp.asarray(pts))
    tinv = tt.invert_isometry(torch.from_numpy(origin))
    assert_same_bits(tinv, jinv)
    got_idx = tgrid.location_to_grid_index(ts, tinv, torch.from_numpy(pts))
    assert_same_bits(got_idx, ref_idx)
    assert_same_bits(tgrid.location_to_grid_index(ts, tinv, pts), ref_idx)
    got_in = tgrid.check_location_in_bounds(ts, tinv, torch.from_numpy(pts))
    assert_same_bits(got_in, ref_in)
    assert 0 < int(got_in.sum()) < len(pts)
    tmap = tvgt.OccupancyMap.create(ts, torch.from_numpy(origin),
                                    device="cpu")
    got_method = tmap.location_to_grid_index(torch.from_numpy(pts))
    assert_same_bits(got_method, ref_method)
    # The map keeps a float32 transform: the method is the module function
    # on the map's own inverse.
    assert_same_bits(got_method, tgrid.location_to_grid_index(
        ts, tmap.inverse_origin_transform(), torch.from_numpy(pts)))


# -- core/transforms.py -------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_rotate_vector_and_apply_isometry(dtype):
    rng = np.random.default_rng(40)
    m = random_isometry(rng).astype(NP_DTYPE[dtype])
    pts = rng.uniform(-3, 3, (500, 3)).astype(NP_DTYPE[dtype])
    with jax.enable_x64(dtype == torch.float64):
        ref_rot = jt.rotate_vector(jnp.asarray(m), jnp.asarray(pts))
        ref_app = jt.apply_isometry(jnp.asarray(m), jnp.asarray(pts))
    tm, tp = torch.from_numpy(m), torch.from_numpy(pts)
    assert_same_bits(tt.rotate_vector(tm, tp), ref_rot)
    assert_same_bits(tt.apply_isometry(tm, tp), ref_app)


# -- core/dsh.py --------------------------------------------------------------


def test_dsh_sizes_and_chunks():
    jsz = jdsh.DSHGridSizes(0.25, (4, 2, 3))
    tsz = tdsh.DSHGridSizes(0.25, (4, 2, 3))
    assert tsz.chunk_sizes == jsz.chunk_sizes == (1.0, 0.5, 0.75)
    assert tsz.voxels_per_chunk == jsz.voxels_per_chunk == 24
    (jm, tm), pts = _dsh_pair(1, 200, 5.0)
    assert tm.num_chunks == jm.num_chunks > 1
    probes = np.concatenate([pts, np.random.default_rng(50).uniform(
        -8.0, 8.0, (100, 3))])
    for p in probes:
        assert tm.chunk_region_of(p) == jm.chunk_region_of(p)
    titems, jitems = list(tm.chunk_items()), list(jm.chunk_items())
    assert [r for r, _ in titems] == [r for r, _ in jitems]
    for (_, a), (_, b) in zip(titems, jitems):
        assert_same_bits(a, b)


# -- ops/edt.py, ops/map_ops.py -----------------------------------------------


@pytest.mark.parametrize("unknown_is_filled", [True, False])
def test_filled_mask_from_occupancy(unknown_is_filled):
    """Cells at exactly 0.5, one ulp either side, NaN and both infinities."""
    rng = np.random.default_rng(60)
    occ = rng.choice(np.array(
        [0.0, 1.0, 0.5, np.nextafter(np.float32(0.5), np.float32(0)),
         np.nextafter(np.float32(0.5), np.float32(1)), np.nan, np.inf,
         -np.inf, 0.25, 0.75], np.float32), (12, 10, 8))
    ref = jedt.filled_mask_from_occupancy(jnp.asarray(occ),
                                          unknown_is_filled)
    got = tedt.filled_mask_from_occupancy(torch.from_numpy(occ),
                                          unknown_is_filled)
    assert_same_bits(got, ref)


def test_merge_free_and_named_object_sdfs():
    """Signed zeros, infinities and NaN in both fields."""
    rng = np.random.default_rng(61)
    values = np.array([-2.0, -0.5, -0.0, 0.0, 0.5, 2.0, np.inf, -np.inf,
                       np.nan], np.float32)
    free = rng.choice(values, (10, 9, 8))
    named = rng.choice(values, (10, 9, 8))
    ref = jedt.merge_free_and_named_object_sdfs(jnp.asarray(free),
                                                jnp.asarray(named))
    got = tedt.merge_free_and_named_object_sdfs(torch.from_numpy(free),
                                                torch.from_numpy(named))
    assert_same_bits(got, ref)


def test_make_separate_object_sdfs():
    """One SDF an object of a three-object tagged map; distances bitwise
    (the EDT is exact)."""
    jmap, tmap = tagged_scene(4, n=16)
    ref = jmo.make_separate_object_sdfs(jmap, [3, 1, 2], oob_value=-1.0)
    got = tmo.make_separate_object_sdfs(tmap, [3, 1, 2], oob_value=-1.0)
    assert list(got) == list(ref) == [3, 1, 2]
    for oid in ref:
        assert_same_bits(got[oid].distances, ref[oid].distances)
        assert got[oid].oob_value == ref[oid].oob_value
        assert got[oid].locked == ref[oid].locked
        assert got[oid].frame == ref[oid].frame


# -- ops/topology.py ----------------------------------------------------------


@pytest.mark.parametrize("key_dtype", [np.int32, np.uint32])
def test_face_adjacency_from_key(key_dtype):
    rng = np.random.default_rng(70)
    key = rng.integers(0, 3, (11, 9, 7)).astype(key_dtype)
    if key_dtype == np.uint32:
        key[key == 2] = np.uint32(2 ** 31 + 5)
        tkey = torch.from_numpy(key.view(np.int32)).view(torch.uint32)
    else:
        tkey = torch.from_numpy(key)
    ref = jtopo.face_adjacency_from_key(jnp.asarray(key))
    got = ttopo.face_adjacency_from_key(tkey)
    for a, b in zip(got, ref):
        assert_same_bits(a, b)


# -- ops/mesh.py --------------------------------------------------------------


def _triangles(rng, n):
    """``n`` triangles: random ones, obtuse ones, ones with a repeated
    vertex and collinear ones, float32 ``[n, 3, 3]``."""
    tri = rng.uniform(-1, 1, (n, 3, 3))
    q = n // 4
    tri[q:2 * q, 2] = (tri[q:2 * q, 0] + tri[q:2 * q, 1]) / 2 + rng.normal(
        0, 0.01, (q, 3))  # obtuse at vertex 3
    tri[2 * q:3 * q, 2] = tri[2 * q:3 * q, 0]  # repeated vertex
    tri[3 * q:, 2] = 2 * tri[3 * q:, 1] - tri[3 * q:, 0]  # collinear
    return tri.astype(np.float32)


def test_closest_point_on_triangle():
    """Random and obtuse triangles against the JAX function as called;
    every triangle, degenerate ones too, against it run op by op."""
    rng = np.random.default_rng(80)
    tri = _triangles(rng, 400)
    q = rng.uniform(-1.5, 1.5, (400, 3)).astype(np.float32)
    normal = np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]).astype(
        np.float32)

    def ref_fn():
        return jmesh.closest_point_on_triangle(
            *(jnp.asarray(tri[:, k]) for k in range(3)), jnp.asarray(normal),
            jnp.asarray(q))

    got = tmesh.closest_point_on_triangle(
        *(torch.from_numpy(tri[:, k]) for k in range(3)),
        torch.from_numpy(normal), torch.from_numpy(q))
    assert_same_bits(got[:200], ref_fn()[:200])
    with jax.disable_jit():
        assert_same_bits(got, ref_fn())


def _sphere_mesh():
    """The isosurface of a 16^3 sphere at 0.05 m, in both packages."""
    d = _sphere_field(16, 0.05, 5.0, 0.0, 0)
    jsdf, tsdf = _sdfs(d, 0.05)
    return (jiso.extract_isosurface(jsdf, max_triangles=4096),
            tiso.extract_isosurface(tsdf, max_triangles=4096))


@pytest.mark.parametrize("enforce", [False, True])
def test_rasterize_mesh_into_channel(enforce):
    """The sphere's triangles (world frame) into a 20^3 channel bitwise
    against the compiled JAX rasterizer; with ``enforce_containment`` a
    triangle outside the grid raises in both packages."""
    jm, _ = _sphere_mesh()
    valid = np.asarray(jm.valid)
    verts = np.asarray(jm.vertices)[valid].reshape(-1, 3).astype(np.float64)
    tris = np.arange(len(verts)).reshape(-1, 3)
    origin = np.eye(4, dtype=np.float32)
    origin[:3, 3] = (-0.1, -0.1, -0.1)
    js = jvgt.GridSpec.from_voxel_counts(0.05, (20, 20, 20))
    ts = tvgt.GridSpec.from_voxel_counts(0.05, (20, 20, 20))
    occ = np.zeros((20, 20, 20), np.float32)
    occ[0, 0, :5] = 0.5
    ref = jmesh.rasterize_mesh_into_channel(
        js, origin, jnp.asarray(occ), verts, tris, enforce_containment=enforce)
    got = tmesh.rasterize_mesh_into_channel(
        ts, torch.from_numpy(origin), torch.from_numpy(occ), verts, tris,
        enforce_containment=enforce)
    assert_same_bits(got, ref)
    assert int((got.numpy() == 1.0).sum()) > 100
    if enforce:
        outside = np.concatenate([verts, [[2.0, 0.0, 0.0]]])
        bad = np.concatenate([tris, [[0, 1, len(verts)]]])
        with pytest.raises(RuntimeError, match="not contained") as jerr:
            jmesh.rasterize_mesh_into_channel(
                js, origin, jnp.asarray(occ), outside, bad, True)
        with pytest.raises(RuntimeError) as terr:
            tmesh.rasterize_mesh_into_channel(
                ts, torch.from_numpy(origin), torch.from_numpy(occ), outside,
                bad, True)
        assert str(terr.value) == str(jerr.value)


# -- ops/sdf_query.py ---------------------------------------------------------


@pytest.mark.parametrize("origin_name", ["shifted", "f1-rotated"])
def test_estimate_distance_interpolate(origin_name):
    """Points near cell faces (a thousandth of a cell off) and outside the
    grid, with their containing index clamped into the grid and as it is
    (NaN or infinity where the JAX function gives them)."""
    origin = _origins()[origin_name]
    d = _sphere_field(16, 0.05, 5.0, 0.3, 1)
    jsdf, tsdf = _sdfs(d, 0.05, origin)
    rng = np.random.default_rng(90)
    pts = _world_points(rng, tsdf.spec, origin, n=1500)[:, :3]
    jitter = rng.choice([-1e-3, 0.0, 1e-3], (len(pts), 3)) * 0.05
    pts = (pts + (jitter @ origin[:3, :3].T)).astype(np.float32)
    idx = np.array(jsdf.location_to_grid_index(jnp.asarray(pts)))
    assert_same_bits(tsdf.location_to_grid_index(torch.from_numpy(pts)), idx)
    clamped = np.clip(idx, 0, 15).astype(np.int32)
    for index in (clamped, idx):
        ref = jq.estimate_distance_interpolate(jsdf, jnp.asarray(pts),
                                               jnp.asarray(index))
        got = tq.estimate_distance_interpolate(
            tsdf, torch.from_numpy(pts), torch.from_numpy(index))
        assert_same_bits(got, ref)


# -- ops/backends.py, native/loader.py ----------------------------------------


def test_available_backend_accessors():
    opts = {"threads": 4, "chunk": 16384}
    jab = jb.AvailableBackend("dev0", opts, jb.BackendOption.NATIVE_CPU)
    tab = tb.AvailableBackend("dev0", opts, tb.BackendOption.NATIVE_CPU)
    assert tab.device_name() == jab.device_name() == "dev0"
    assert tab.device_options() == jab.device_options() == opts
    tab.device_options()["threads"] = 1
    jab.device_options()["threads"] = 1
    assert tab.device_options() == jab.device_options() == opts
    assert tab.backend_option().value == jab.backend_option().value


_NATIVE_FUNCTIONS = ("vgt_edt_sdf", "vgt_raycast", "vgt_filter",
                     "vgt_hardware_threads")


def test_get_library_loads_the_same_interface():
    """Both loaders give a loaded library with the same typed functions
    (each builds its library only if it is missing), or both give None."""
    jlib, tlib = jloader.get_library(), tloader.get_library()
    assert (jlib is None) == (tlib is None)
    if jlib is None:
        return
    assert isinstance(tlib, ctypes.CDLL)
    for name in _NATIVE_FUNCTIONS:
        jf, tf = getattr(jlib, name), getattr(tlib, name)
        assert tf.argtypes == jf.argtypes and tf.restype == jf.restype
    assert tlib.vgt_hardware_threads() == jlib.vgt_hardware_threads()


@pytest.mark.parametrize("failure", [
    FileNotFoundError(2, "No such file or directory: 'g++'"),
    subprocess.CalledProcessError(1, ["g++"])])
def test_get_library_without_a_build(failure, monkeypatch, tmp_path):
    """Where the library is not built and the compiler is missing or
    fails, both loaders give None (and ``available()`` is False)."""
    def fail(_path):
        raise failure

    for mod, path in ((jloader, str(tmp_path / "j.so")),
                      (tloader, tmp_path / "t.so")):
        monkeypatch.setattr(mod, "_LIB", None)
        monkeypatch.setattr(mod, "_FAILED", False)
        monkeypatch.setattr(mod, "_build_path", lambda p=path: p)
        monkeypatch.setattr(mod, "_compile", fail)
    assert jloader.get_library() is None
    assert tloader.get_library() is None
    assert not jloader.available() and not tloader.available()


# -- io/viz.py ----------------------------------------------------------------


@pytest.mark.parametrize("alpha", [1.0, 0.25])
def test_lookup_component_color(alpha):
    """Component 0 (transparent), every palette entry, the wrap and past
    it."""
    n = len(jviz._UNIQUE_COLORS)
    for component in [0, 1, 5, n - 1, n, n + 1, 2 * n + 3, 10 ** 6 + 7]:
        assert_same_bits(tviz.lookup_component_color(component, alpha),
                         jviz.lookup_component_color(component, alpha))


def test_interpolate_hot_to_cold():
    v = np.random.default_rng(100).uniform(-1.0, 3.0, (9, 7))
    v[0, :3] = (0.0, 2.0, 1.0)
    for low, high in ((0.0, 2.0), (1.0, 1.0), (0.5, 0.25)):
        assert_same_bits(tviz.interpolate_hot_to_cold(v, low, high),
                         jviz.interpolate_hot_to_cold(v, low, high))


def _rgba_by_value(occ):
    """A colour function: a hot-to-cold colour, transparent below 0.3."""
    rgba = jviz.interpolate_hot_to_cold(occ, 0.0, 1.0)
    rgba[..., 3] = np.where(np.asarray(occ) < 0.3, 0.0, 0.5)
    return rgba


@pytest.mark.parametrize("which", [0, 1])
def test_export_voxel_grid(which):
    js, ts = _specs()[which]
    occ = np.random.default_rng(110 + which).uniform(
        size=js.counts).astype(np.float32)
    origin = random_isometry(np.random.default_rng(111))
    ref = jviz.export_voxel_grid(js, jnp.asarray(origin), "grid",
                                 _rgba_by_value, jnp.asarray(occ), ns="v")
    got = tviz.export_voxel_grid(ts, torch.from_numpy(origin), "grid",
                                 _rgba_by_value, torch.from_numpy(occ),
                                 ns="v")
    _assert_markers_equal(got, ref)
    assert len(got.positions) > 0


def test_export_dsh_markers():
    (jm, tm), _ = _dsh_pair(2, 250, 4.0)
    _assert_markers_equal(tviz.export_dsh_grid(tm, _rgba_by_value),
                          jviz.export_dsh_grid(jm, _rgba_by_value))
    for kw in ({}, dict(collision_color=(0.0, 0.0, 1.0, 1.0),
                        free_color=(0.0, 1.0, 0.0, 0.5))):
        _assert_markers_equal(
            tviz.export_dsh_occupancy_for_display(tm, **kw),
            jviz.export_dsh_occupancy_for_display(jm, **kw))


@pytest.mark.parametrize("entries", [0, 40])
def test_export_voxel_grid_index_map(entries):
    rng = np.random.default_rng(120)
    index_map = {tuple(int(v) for v in rng.integers(-2, 9, 3)):
                 tuple(rng.choice([0.0, 0.5, 1.0], 4)) for _ in range(entries)}
    (js, ts) = _specs()[1]
    origin = random_isometry(rng)
    _assert_markers_equal(
        tviz.export_voxel_grid_index_map(ts, origin, "m", index_map),
        jviz.export_voxel_grid_index_map(js, origin, "m", index_map))


def _assert_triangle_markers_equal(a, b):
    assert a.frame == b.frame and a.ns == b.ns
    assert a.num_triangles == b.num_triangles
    for name in ("pose", "points", "color"):
        assert_same_bits(getattr(a, name), getattr(b, name))


def test_export_isosurface_for_display():
    """The same mesh through both exporters bitwise; each package's own
    extraction within the isosurface tolerance; an overflowed mesh raises
    in both."""
    jm, tm = _sphere_mesh()
    assert_meshes_match(jm, tm, 0.05, 16)
    as_port = tiso.IsoMesh(torch.from_numpy(np.array(jm.vertices)),
                           torch.from_numpy(np.array(jm.valid)),
                           torch.tensor(int(jm.num_triangles)))
    pose = random_isometry(np.random.default_rng(130))
    for kw in ({}, dict(color=(1.0, 0.0, 0.0, 0.5), ns="s", pose=pose)):
        ref = jviz.export_isosurface_for_display(jm, "world", **kw)
        _assert_triangle_markers_equal(
            tviz.export_isosurface_for_display(as_port, "world", **kw), ref)
        own = tviz.export_isosurface_for_display(tm, "world", **kw)
        assert own.num_triangles == ref.num_triangles > 100
        np.testing.assert_allclose(own.points, ref.points, rtol=0,
                                   atol=2.0 ** -21 * 16 * 0.05)
    small_j = jiso.extract_isosurface(_sdfs(_sphere_field(
        16, 0.05, 5.0, 0.0, 0), 0.05)[0], max_triangles=64)
    small_t = tiso.extract_isosurface(_sdfs(_sphere_field(
        16, 0.05, 5.0, 0.0, 0), 0.05)[1], max_triangles=64)
    with pytest.raises(ValueError, match="overflowed") as jerr:
        jviz.export_isosurface_for_display(small_j, "world")
    with pytest.raises(ValueError) as terr:
        tviz.export_isosurface_for_display(small_t, "world")
    assert str(terr.value) == str(jerr.value)
