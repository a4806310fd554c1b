"""The port's voxelizer backends and native loader against the JAX
package: the native C++ runtime (the same source, byte for byte) bitwise
equal to the JAX package's, the accelerator backend on the CPU equal to
the JAX package's op-by-op ``voxelize_pointclouds``, the two-camera oracle
through every backend, and the registry's options, errors and choices."""

import pathlib

import numpy as np
import jax
import pytest
import torch

from test_voxelize import (check_empty_voxelization, check_voxelization,
                           make_scene)
from voxelized_geometry_tools_tpu import native as jnative
from voxelized_geometry_tools_tpu.ops import backends as jb
from voxelized_geometry_tools_tpu.ops import voxelize as jv
from voxelized_geometry_tools_tpu_torch import GridSpec, OccupancyMap, interop
from voxelized_geometry_tools_tpu_torch import native
from voxelized_geometry_tools_tpu_torch.ops import backends as tb
from voxelized_geometry_tools_tpu_torch.ops import voxelize as tv

REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture
def needs_native():
    if not native.available() or not jnative.available():
        pytest.skip("no native toolchain")


@pytest.fixture(scope="module")
def scene():
    env, clouds = make_scene()
    tenv = interop.occupancy_map_from_numpy(
        GridSpec(env.spec.counts, env.spec.resolution),
        np.asarray(env.occupancy), np.asarray(env.origin_transform),
        env.frame, device="cpu")
    tclouds = [interop.pointcloud_from_numpy(
        np.asarray(c.points), np.asarray(c.origin_transform),
        np.asarray(c.max_range), device="cpu") for c in clouds]
    return env, clouds, tenv, tclouds


def test_native_source_is_the_jax_packages():
    port = REPO / "voxelized_geometry_tools_tpu_torch/native/vgt_native.cpp"
    ref = REPO / "voxelized_geometry_tools_tpu/native/vgt_native.cpp"
    assert port.read_bytes() == ref.read_bytes()


def test_native_loader_matches_jax(needs_native):
    """The port's loader against the JAX package's on the same arrays:
    the EDT, random rays (NaN origins and sentinels among them) and the
    filter, bitwise."""
    rng = np.random.default_rng(0)
    filled = rng.uniform(size=(9, 10, 11)) < 0.2
    np.testing.assert_array_equal(native.edt_sdf(filled, 0.1),
                                  jnative.edt_sdf(filled, 0.1))
    origins = rng.uniform(-1.0, 5.0, (300, 3)).astype(np.float32)
    origins[0] = np.nan
    pts = rng.uniform(-2.0, 7.0, (300, 3)).astype(np.float32)
    pts[1] = (4.5, 4.5, -3.0e38)
    for max_range in (np.inf, 3.0):
        got = native.raycast(origins, pts, max_range, (8, 9, 10), 0.5, 2)
        ref = jnative.raycast(origins, pts, max_range, (8, 9, 10), 0.5, 2)
        for g, r in zip(got, ref):
            np.testing.assert_array_equal(g, r)
    free = rng.integers(0, 4, (3, 8, 9, 10)).astype(np.int32)
    fill = rng.integers(0, 4, (3, 8, 9, 10)).astype(np.int32)
    occ = rng.choice(np.array([0.0, 0.5, 1.0], np.float32), (8, 9, 10))
    np.testing.assert_array_equal(
        native.filter_grids(free, fill, occ, 0.7, 2, 1),
        jnative.filter_grids(free, fill, occ, 0.7, 2, 1))
    assert native.hardware_threads() >= 1
    assert native.probe_available()


def test_native_backend_matches_jax(needs_native, scene):
    """The two-camera oracle through both packages' native backends:
    equal occupancy, and the oracle holds."""
    env, clouds, tenv, tclouds = scene
    options = jv.FilterOptions(1.0, 1, 1)
    ref = jb.NativeCpuPointCloudVoxelizer().voxelize_pointclouds(
        env, options, clouds)
    runtimes = []
    got = tb.NativeCpuPointCloudVoxelizer().voxelize_pointclouds(
        tenv, tv.FilterOptions(1.0, 1, 1), tclouds,
        runtime_log_fn=runtimes.append)
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    check_voxelization(got.occupancy.numpy())
    assert len(runtimes) == 1 and min(runtimes[0]) >= 0.0


@pytest.fixture(scope="module")
def eager_ref(scene):
    """The JAX package's voxelize_pointclouds on the oracle, op by op (see
    tests/test_torch_voxelize.py for why)."""
    env, clouds, _, _ = scene
    with jax.disable_jit():
        return jv.voxelize_pointclouds(env, jv.FilterOptions(1.0, 1, 1),
                                       clouds)


@pytest.mark.parametrize("carve_columns", [0, 1])
def test_accelerator_on_cpu_matches_jax(scene, eager_ref, carve_columns):
    """The accelerator backend on the CPU (the walk, or the column carve
    along pick_run_axis for these 16,641-point clouds) gives the JAX
    package's op-by-op occupancy and passes the oracle."""
    _, _, tenv, tclouds = scene
    ref = eager_ref
    logs = []
    vox = tb.AcceleratorPointCloudVoxelizer(
        {"CARVE_COLUMNS": carve_columns}, logs.append, device="cpu")
    got = vox.voxelize_pointclouds(tenv, tv.FilterOptions(1.0, 1, 1),
                                   tclouds)
    np.testing.assert_array_equal(got.occupancy.numpy(),
                                  np.asarray(ref.occupancy))
    check_voxelization(got.occupancy.numpy())
    assert any("CARVE_COLUMNS" in line for line in logs)


def test_every_backend_passes_the_oracle(scene):
    """The reference's one-oracle-many-backends test over the port's
    available backends (the accelerator on the CPU when there is no
    card), empty clouds included."""
    _, _, tenv, tclouds = scene
    options = tv.FilterOptions(1.0, 1, 1)
    backends = tb.get_available_backends()
    voxelizers = [tb.make_pointcloud_voxelizer(b, None) for b in backends]
    if not torch.cuda.is_available():
        voxelizers.append(tb.make_pointcloud_voxelizer(
            tb.BackendOption.ACCELERATOR, None, device="cpu"))
    assert voxelizers
    for vox in voxelizers:
        empty = vox.voxelize_pointclouds(tenv, options, [])
        check_empty_voxelization(empty.occupancy.numpy())
        got = vox.voxelize_pointclouds(tenv, options, tclouds)
        check_voxelization(got.occupancy.numpy())


def test_registry_without_a_card(monkeypatch):
    """No card: the accelerator is not listed, the best available backend
    is the native one (or, when that cannot be built, the accelerator on
    the CPU), and the accelerator needs device="cpu"."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    names = [b.backend_option() for b in tb.get_available_backends()]
    assert tb.BackendOption.ACCELERATOR not in names
    logs = []
    best = tb.make_best_available_pointcloud_voxelizer({}, logs.append)
    if native.available():
        assert isinstance(best, tb.NativeCpuPointCloudVoxelizer)
        assert tb.BackendOption.NATIVE_CPU in names
    else:
        assert isinstance(best, tb.AcceleratorPointCloudVoxelizer)
    assert any("Selected backend" in line for line in logs)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tb.AcceleratorPointCloudVoxelizer()
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tb.make_pointcloud_voxelizer(tb.BackendOption.ACCELERATOR)
    vox = tb.make_pointcloud_voxelizer(
        tb.AvailableBackend("", {}, tb.BackendOption.ACCELERATOR),
        device="cpu")
    assert vox.device == torch.device("cpu")


def test_best_available_falls_back_to_the_cpu_accelerator(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(native, "available", lambda: False)
    logs = []
    best = tb.make_best_available_pointcloud_voxelizer({}, logs.append)
    assert isinstance(best, tb.AcceleratorPointCloudVoxelizer)
    assert best.device == torch.device("cpu")
    assert any("unavailable" in line for line in logs)


def test_option_resolution_logging():
    logs = []
    assert tb.retrieve_option_or_default(
        {"CPU_NUM_THREADS": 4}, "CPU_NUM_THREADS", 0, logs.append) == 4
    assert tb.retrieve_option_or_default(
        {}, "CPU_NUM_THREADS", 7, logs.append) == 7
    assert logs == jb_logs()


def jb_logs():
    logs = []
    jb.retrieve_option_or_default({"CPU_NUM_THREADS": 4}, "CPU_NUM_THREADS",
                                  0, logs.append)
    jb.retrieve_option_or_default({}, "CPU_NUM_THREADS", 7, logs.append)
    return logs


def test_accelerator_options_logged_and_checked():
    logs = []
    tb.AcceleratorPointCloudVoxelizer(
        {"RAY_CHUNK": 512, "MAX_STEPS": 0, "CARVE_COLUMNS": 0}, logs.append,
        device="cpu")
    for key, value in (("RAY_CHUNK", 512), ("MAX_STEPS", 0),
                       ("CARVE_COLUMNS", 0)):
        assert f"Using option [{key}] with value [{value}]" in logs
    assert any("AcceleratorPointCloudVoxelizer on cpu" in line
               for line in logs)
    with pytest.raises(ValueError, match="RAY_CHUNK"):
        tb.AcceleratorPointCloudVoxelizer({"RAY_CHUNK": 0}, device="cpu")
    with pytest.raises(ValueError, match="MAX_STEPS"):
        tb.AcceleratorPointCloudVoxelizer({"MAX_STEPS": -5}, device="cpu")
    with pytest.raises(ValueError, match="Unknown backend option"):
        tb.make_pointcloud_voxelizer("bogus")


def test_non_uniform_spec_rejected(needs_native):
    spec = GridSpec.from_voxel_sizes((0.1, 0.2, 0.1), (4, 4, 4))
    env = OccupancyMap(origin_transform=torch.eye(4),
                       occupancy=torch.full((4, 4, 4), 0.5), spec=spec,
                       frame="t")
    cloud = tv.PointCloud.create(np.zeros((1, 3), np.float32), device="cpu")
    for vox in (tb.NativeCpuPointCloudVoxelizer(),
                tb.AcceleratorPointCloudVoxelizer(device="cpu")):
        with pytest.raises(ValueError, match="uniform"):
            vox.voxelize_pointclouds(env, tv.FilterOptions(), [cloud])


def test_accelerator_refuses_a_map_on_another_device(scene):
    _, _, tenv, tclouds = scene
    vox = tb.AcceleratorPointCloudVoxelizer(device="cpu")
    vox.device = torch.device("meta")
    with pytest.raises(ValueError, match="carves on meta"):
        vox.voxelize_pointclouds(tenv, tv.FilterOptions(), tclouds)
