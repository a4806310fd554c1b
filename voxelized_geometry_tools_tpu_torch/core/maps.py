"""Voxel map containers: ``OccupancyMap`` and ``SignedDistanceField``.

Port of ``voxelized_geometry_tools_tpu/core/maps.py`` (the two classes on
the main path). Each map is a frozen dataclass holding tensors (an
``[nx, ny, nz]`` channel and a ``[4, 4]`` origin transform) plus static
Python fields; updates are functional (``replace``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import transforms
from .device import default_device
from .grid import GridSpec, get_index_values

Tensor = torch.Tensor

# Occupancy value conventions: 0.0 = free, 0.5 = unknown, 1.0 = filled.
FREE = 0.0
UNKNOWN = 0.5
FILLED = 1.0


def _default_transform(origin_transform, dtype=torch.float32,
                       device=None) -> Tensor:
    """Normalize an origin transform to a ``[4, 4]`` tensor of ``dtype``.

    The rigid-body inverse used for world<->grid transforms assumes
    ``R^-1 = R^T``, so anything that is not an isometry is rejected. The
    check reads the matrix on the host; a tensor that requires grad (a pose
    being optimized) is checked on its detached value."""
    if origin_transform is None:
        return torch.eye(4, dtype=dtype, device=device)
    if isinstance(origin_transform, torch.Tensor):
        t = origin_transform.to(dtype=dtype, device=device)
    else:
        t = torch.tensor(np.asarray(origin_transform), dtype=dtype,
                         device=device)
    if tuple(t.shape) != (4, 4):
        raise ValueError(
            f"origin_transform must be [4, 4], got {tuple(t.shape)}")
    m = t.detach().cpu().double().numpy()
    if (not np.allclose(m[:3, :3] @ m[:3, :3].T, np.eye(3), atol=1e-3)
            or not np.allclose(m[3], (0.0, 0.0, 0.0, 1.0), atol=1e-5)):
        raise ValueError(
            "origin_transform must be an isometry (orthonormal rotation + "
            "translation); the rigid-body inverse used for world<->grid "
            "transforms assumes R^-1 = R^T")
    return t


class _MapBase:
    """Shared geometry helpers."""

    spec: GridSpec
    origin_transform: Tensor

    @property
    def resolution(self) -> float:
        return self.spec.resolution

    def inverse_origin_transform(self) -> Tensor:
        """``invert_isometry(origin_transform)``. Every query asks for it,
        so it is kept on the map, keyed by the transform's storage and
        version (an inference tensor has no version: it is not written in
        place outside inference mode). A transform that requires grad gets
        it formed afresh under autograd."""
        m = self.origin_transform
        if m.requires_grad and torch.is_grad_enabled():
            return transforms.invert_isometry(m)
        key = (m.data_ptr(), None if m.is_inference() else m._version)
        cached = self.__dict__.get("_inverse")
        if cached is None or cached[0] != key:
            # A normal tensor even under inference mode, so that autograd
            # may save it later.
            with torch.inference_mode(False), torch.no_grad():
                cached = (key, transforms.invert_isometry(m))
            object.__setattr__(self, "_inverse", cached)
        return cached[1]

    def location_to_grid_index(self, p_world: Tensor) -> Tensor:
        p_grid = transforms.apply_isometry(
            self.inverse_origin_transform(), p_world[..., :3])
        return self.spec.location_in_grid_frame_to_grid_index(p_grid)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)


@dataclasses.dataclass(frozen=True)
class OccupancyMap(_MapBase):
    """Dense float occupancy grid."""

    origin_transform: Tensor
    occupancy: Tensor  # f32 [nx, ny, nz]
    spec: GridSpec
    frame: str = ""

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE,
               device=None) -> "OccupancyMap":
        """On ``device``; None means the CUDA card."""
        spec.enforce_uniform_voxel_size()
        device = default_device(device)
        return OccupancyMap(
            origin_transform=_default_transform(origin_transform,
                                                device=device),
            occupancy=torch.full(spec.counts, default_occupancy,
                                 dtype=torch.float32, device=device),
            spec=spec, frame=frame)


@dataclasses.dataclass(frozen=True)
class SignedDistanceField(_MapBase):
    """Dense signed-distance grid with a locked min/max cache.
    ``oob_value`` is returned for out-of-bounds queries."""

    origin_transform: Tensor
    distances: Tensor  # f32 [nx, ny, nz]
    minimum: Tensor    # 0-dim, valid when locked
    maximum: Tensor    # 0-dim, valid when locked
    spec: GridSpec
    frame: str = ""
    locked: bool = False
    oob_value: float = float("inf")

    @staticmethod
    def create(spec: GridSpec, distances, origin_transform=None,
               frame: str = "", oob_value: float = float("inf"),
               locked: bool = False, dtype=None,
               device=None) -> "SignedDistanceField":
        """``dtype`` selects the scalar type (float32 by default);
        ``device`` defaults to the device of ``distances`` when that is a
        tensor, else to the CUDA card."""
        spec.enforce_uniform_voxel_size()
        dtype = torch.float32 if dtype is None else dtype
        values = torch.as_tensor(
            distances, device=default_device(device, like=distances)).to(dtype)
        if tuple(values.shape) != tuple(spec.shape):
            raise ValueError(
                f"distances shape {tuple(values.shape)} != spec counts "
                f"{spec.shape}")
        zero = torch.zeros((), dtype=values.dtype, device=values.device)
        sdf = SignedDistanceField(
            origin_transform=_default_transform(
                origin_transform, values.dtype, values.device),
            distances=values, minimum=zero, maximum=zero,
            spec=spec, frame=frame, locked=False, oob_value=float(oob_value))
        return sdf.lock() if locked else sdf

    def lock(self) -> "SignedDistanceField":
        """Cache min/max and freeze."""
        return dataclasses.replace(
            self, minimum=torch.amin(self.distances),
            maximum=torch.amax(self.distances), locked=True)

    def unlock(self) -> "SignedDistanceField":
        return dataclasses.replace(self, locked=False)

    def replace(self, **kwargs):
        """Functional update. Replacing ``distances`` on a LOCKED field
        unlocks the result: the cached min/max no longer describes the new
        values. Re-``lock()`` explicitly if the cache is wanted."""
        if ("distances" in kwargs and self.locked
                and not {"minimum", "maximum", "locked"} & kwargs.keys()):
            kwargs["locked"] = False
        return dataclasses.replace(self, **kwargs)

    def get_minimum_maximum(self):
        if self.locked:
            return self.minimum, self.maximum
        return torch.amin(self.distances), torch.amax(self.distances)

    def get_index(self, index: Tensor) -> Tensor:
        """Distance at integer index [..., 3] with OOB semantics."""
        return get_index_values(self.distances, index, self.oob_value)
