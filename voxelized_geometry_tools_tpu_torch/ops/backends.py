"""Voxelizer backend registry and factory.

Port of ``voxelized_geometry_tools_tpu/ops/backends.py`` (the reference's
backend discovery and selection, pointcloud_voxelization.cpp:18-147):
enumerate the available backends, build a voxelizer for one, or take the
best available. ``ACCELERATOR`` is the CUDA card (the tiled carve kernel,
``kernels/csrc/carve.cu``), ``NATIVE_CPU`` the multithreaded C++ runtime
(:mod:`..native`). Every backend passes the same oracle tests.

String-keyed int32 option maps are kept (``RetrieveOptionOrDefault``,
device_voxelization_interface.hpp:44-70): ``CPU_NUM_THREADS`` (native) and
``RAY_CHUNK`` / ``MAX_STEPS`` / ``CARVE_COLUMNS`` (accelerator).
"""

from __future__ import annotations

import enum
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core import transforms
from ..core.device import default_device
from ..core.maps import OccupancyMap
from .voxelize import (FilterOptions, PointCloud, VoxelizerRuntime,
                       _carve_and_filter, pick_run_axis,
                       voxelize_pointclouds)

LoggingFunction = Optional[Callable[[str], None]]


class BackendOption(enum.Enum):
    """pointcloud_voxelization.hpp:18-21 equivalents."""
    BEST_AVAILABLE = "best_available"
    ACCELERATOR = "accelerator"   # the CUDA card
    NATIVE_CPU = "native_cpu"     # multithreaded C++ runtime


class AvailableBackend:
    """pointcloud_voxelization.hpp:24-52."""

    def __init__(self, device_name: str, device_options: Dict[str, int],
                 backend_option: BackendOption):
        self._device_name = device_name
        self._device_options = dict(device_options)
        self._backend_option = backend_option

    def device_name(self) -> str:
        return self._device_name

    def device_options(self) -> Dict[str, int]:
        return dict(self._device_options)

    def backend_option(self) -> BackendOption:
        return self._backend_option

    def __repr__(self):
        return (f"AvailableBackend({self._device_name!r}, "
                f"{self._backend_option})")


def retrieve_option_or_default(options: Dict[str, int], key: str,
                               default: int,
                               logging_fn: LoggingFunction = None) -> int:
    """``RetrieveOptionOrDefault`` (device_voxelization_interface.hpp:44-70)."""
    if key in options:
        value = int(options[key])
        if logging_fn:
            logging_fn(f"Using option [{key}] with value [{value}]")
        return value
    if logging_fn:
        logging_fn(f"Using default [{key}] with value [{default}]")
    return default


class AcceleratorPointCloudVoxelizer:
    """The device voxelizer. On the CUDA card (``device=None``) it carves
    every cloud with the tiled carve kernel, one launch per cloud, into its
    slice of one stacked pair of grids; ``CARVE_COLUMNS``
    is accepted, validated and logged, since the walk and the column carve
    give the same bits. With ``device="cpu"`` it carves with the PyTorch
    twins as the JAX package chooses them: the column carve along
    :func:`~.voxelize.pick_run_axis` for clouds of 4,096 points and more
    unless ``CARVE_COLUMNS=0``, else the walk. The tracking grids stay on
    the device between carve and filter; a ``runtime_log_fn`` gets the
    phase split as a ``VoxelizerRuntime`` (the device is then synchronized
    after each phase; without one, nothing waits for it). Without a card,
    ``device=None`` raises."""

    def __init__(self, options: Optional[Dict[str, int]] = None,
                 logging_fn: LoggingFunction = None, device=None):
        options = options or {}
        self._ray_chunk = retrieve_option_or_default(
            options, "RAY_CHUNK", 16384, logging_fn)
        if self._ray_chunk < 1:
            raise ValueError(f"RAY_CHUNK must be >= 1, got "
                             f"{self._ray_chunk}")
        self._max_steps = retrieve_option_or_default(
            options, "MAX_STEPS", 0, logging_fn) or None
        if self._max_steps is not None and self._max_steps < 1:
            # A negative budget would carve nothing while still marking
            # endpoints.
            raise ValueError(f"MAX_STEPS must be >= 1 (or 0/unset), got "
                             f"{self._max_steps}")
        self._use_columns = bool(retrieve_option_or_default(
            options, "CARVE_COLUMNS", 1, logging_fn))
        self.device = default_device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda",
                                           torch.cuda.current_device())
            name = torch.cuda.get_device_name(self.device)
            # Build (or load) the carve kernel now: a failed build raises
            # here, not at the first cloud.
            from ..kernels import carve
            carve._library()
        else:
            name = str(self.device)
        if logging_fn:
            logging_fn(f"AcceleratorPointCloudVoxelizer on {name}")

    def voxelize_pointclouds(self, static_environment: OccupancyMap,
                             filter_options: FilterOptions,
                             pointclouds: Sequence[PointCloud],
                             runtime_log_fn=None) -> OccupancyMap:
        filter_options.validate()
        if static_environment.occupancy.device != self.device:
            raise ValueError(
                f"the static environment lies on "
                f"{static_environment.occupancy.device}, this voxelizer "
                f"carves on {self.device}")
        if not pointclouds:
            return voxelize_pointclouds(static_environment, filter_options,
                                        [], runtime_log_fn,
                                        max_steps=self._max_steps)
        spec = static_environment.spec
        spec.enforce_uniform_voxel_size()
        origin = static_environment.origin_transform
        run_axes = None  # the card carves every cloud with the tiled kernel
        if self.device.type != "cuda":
            run_axes = tuple(
                pick_run_axis(cloud, origin)
                if self._use_columns and cloud.points.shape[0] >= 4096
                else None for cloud in pointclouds)
        occupancy = _carve_and_filter(
            spec, origin, pointclouds, filter_options,
            static_environment.occupancy, self._max_steps, self._ray_chunk,
            run_axes, runtime_log_fn)
        return static_environment.replace(occupancy=occupancy)


def _numpy(x, dtype) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, dtype)


class NativeCpuPointCloudVoxelizer:
    """Native C++ voxelizer (the reference's CPU backend,
    cpu_pointcloud_voxelization.cpp, in ``native/vgt_native.cpp``). It reads
    the clouds and the map on the host and returns the occupancy on the
    map's device."""

    def __init__(self, options: Optional[Dict[str, int]] = None,
                 logging_fn: LoggingFunction = None):
        options = options or {}
        from .. import native
        if not native.available():
            raise RuntimeError("native backend unavailable")
        self._native = native
        self._threads = retrieve_option_or_default(
            options, "CPU_NUM_THREADS", 0, logging_fn)
        if logging_fn:
            logging_fn(
                f"NativeCpuPointCloudVoxelizer with "
                f"{self._threads or native.hardware_threads()} threads")

    def voxelize_pointclouds(self, static_environment: OccupancyMap,
                             filter_options: FilterOptions,
                             pointclouds: Sequence[PointCloud],
                             runtime_log_fn=None) -> OccupancyMap:
        filter_options.validate()
        spec = static_environment.spec
        # The native kernel marches with one cubic cell size.
        spec.enforce_uniform_voxel_size()
        X_GW = _numpy(transforms.invert_isometry(
            static_environment.origin_transform), np.float64)

        t0 = time.monotonic()
        frees, filleds = [], []
        for cloud in pointclouds:
            X_GC = X_GW @ _numpy(cloud.origin_transform, np.float64)
            pts = _numpy(cloud.points, np.float64)
            pts_grid = pts @ X_GC[:3, :3].T + X_GC[:3, 3]
            origin = X_GC[:3, 3]
            free, filled = self._native.raycast(
                origin.astype(np.float32), pts_grid.astype(np.float32),
                float(cloud.max_range), spec.counts, spec.resolution,
                self._threads)
            frees.append(free)
            filleds.append(filled)
        t1 = time.monotonic()

        empty = np.zeros((0,) + spec.counts, np.int32)
        occupancy = self._native.filter_grids(
            np.stack(frees) if frees else empty,
            np.stack(filleds) if filleds else empty,
            _numpy(static_environment.occupancy, np.float32),
            filter_options.percent_seen_free,
            filter_options.outlier_points_threshold,
            filter_options.num_cameras_seen_free, self._threads)
        t2 = time.monotonic()

        if runtime_log_fn is not None:
            runtime_log_fn(VoxelizerRuntime(t1 - t0, t2 - t1))
        return static_environment.replace(occupancy=torch.from_numpy(
            occupancy).to(static_environment.occupancy.device))


def get_available_backends() -> List[AvailableBackend]:
    """``GetAvailableBackends`` (pointcloud_voxelization.cpp:18-53): the
    accelerator only when a CUDA card is present, the native backend when
    its library is built or g++ is present (a cheap probe: enumeration
    does not build it)."""
    backends: List[AvailableBackend] = []
    if torch.cuda.is_available():
        backends.append(AvailableBackend(
            f"accelerator (cuda: {torch.cuda.get_device_name(0)})", {},
            BackendOption.ACCELERATOR))
    from .. import native
    if native.probe_available():
        backends.append(AvailableBackend("native_cpu", {},
                                         BackendOption.NATIVE_CPU))
    return backends


def make_pointcloud_voxelizer(backend, logging_fn: LoggingFunction = None,
                              device=None):
    """``MakePointCloudVoxelizer`` (pointcloud_voxelization.cpp:55-90).
    ``device`` goes to the accelerator backend (None: the CUDA card)."""
    if isinstance(backend, AvailableBackend):
        option = backend.backend_option()
        options = backend.device_options()
    else:
        option = backend
        options = {}
    if option == BackendOption.BEST_AVAILABLE:
        return make_best_available_pointcloud_voxelizer(options, logging_fn)
    if option == BackendOption.ACCELERATOR:
        return AcceleratorPointCloudVoxelizer(options, logging_fn,
                                              device=device)
    if option == BackendOption.NATIVE_CPU:
        return NativeCpuPointCloudVoxelizer(options, logging_fn)
    raise ValueError(f"Unknown backend option {option}")


def make_best_available_pointcloud_voxelizer(
        options: Optional[Dict[str, int]] = None,
        logging_fn: LoggingFunction = None):
    """``MakeBestAvailablePointCloudVoxelizer``
    (pointcloud_voxelization.cpp:92-147). With a CUDA card present it builds
    the ``ACCELERATOR`` backend, and a failure there (the carve kernel's
    build included) raises: the one deviation from the JAX package, which
    falls through to the next backend, since that would hide the card.
    Without a card it takes ``NATIVE_CPU``, and when that cannot be built,
    the accelerator backend on the CPU (the PyTorch twins), as the JAX
    package does."""
    options = options or {}
    if torch.cuda.is_available():
        voxelizer = AcceleratorPointCloudVoxelizer(options, logging_fn)
        if logging_fn:
            logging_fn(f"Selected backend {BackendOption.ACCELERATOR}")
        return voxelizer
    try:
        voxelizer = NativeCpuPointCloudVoxelizer(options, logging_fn)
        selected = BackendOption.NATIVE_CPU
    except RuntimeError as e:
        if logging_fn:
            logging_fn(f"Backend {BackendOption.NATIVE_CPU} unavailable: {e}")
        voxelizer = AcceleratorPointCloudVoxelizer(options, logging_fn,
                                                   device="cpu")
        selected = BackendOption.ACCELERATOR
    if logging_fn:
        logging_fn(f"Selected backend {selected}")
    return voxelizer
