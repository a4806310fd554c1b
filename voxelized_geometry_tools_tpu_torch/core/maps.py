"""Voxel map containers: the four occupancy cell layouts and the SDF.

Port of ``voxelized_geometry_tools_tpu/core/maps.py``: ``OccupancyMap``,
``OccupancyComponentMap``, ``TaggedObjectOccupancyMap``,
``TaggedObjectOccupancyComponentMap`` and ``SignedDistanceField``. Each map
is a frozen dataclass holding tensors (``[nx, ny, nz]`` channels and a
``[4, 4]`` origin transform) plus static Python fields; updates are
functional (``replace``, ``set_index``).

The uint32 channels (object ids, component and segment labels) are
``torch.uint32`` tensors, which PyTorch can create, view and compare but
not gather or scatter; cell access reads and writes them through an int32
view of the same bits.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import transforms
from .constants import constant
from .device import default_device
from .grid import (GridSpec, get_index_values, grid_index_to_location,
                   location_to_grid_index)

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

    @property
    def counts(self):
        return self.spec.counts

    @property
    def num_total_voxels(self) -> int:
        return self.spec.num_total

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
        return location_to_grid_index(
            self.spec, self.inverse_origin_transform(), p_world)

    def grid_index_to_location(self, index: Tensor) -> Tensor:
        return grid_index_to_location(self.spec, self.origin_transform,
                                      index)

    def replace(self, **kwargs):
        return dataclasses.replace(self, **kwargs)

    # -- cell access: batched, functional GetIndexImmutable / SetIndex /
    # GetLocationImmutable / SetLocation -----------------------------------

    def _channel_names(self):
        return [f.name for f in dataclasses.fields(self)
                if f.name != "origin_transform"
                and isinstance(getattr(self, f.name), torch.Tensor)
                and getattr(self, f.name).dim() == 3]

    def _index_tensor(self, index) -> Tensor:
        return torch.as_tensor(index, device=self.origin_transform.device)

    def _get_cells(self, index):
        """(dict of per-channel values, valid mask). Out-of-bounds lanes
        read the nearest edge cell (indices clamped per axis) with
        ``valid=False``."""
        idx = self._index_tensor(index)
        valid = self.spec.check_grid_index_in_bounds(idx)
        counts = constant(tuple(self.spec.counts), torch.int64, idx.device)
        safe = torch.minimum(torch.clamp(idx.long(), min=0), counts - 1)
        values = {}
        for name in self._channel_names():
            chan = getattr(self, name)
            bits = _bits(chan)[safe[..., 0], safe[..., 1], safe[..., 2]]
            values[name] = bits.view(chan.dtype)
        return values, valid

    def get_index(self, index):
        """Cell channels at integer indices ``[..., 3]`` -> (dict of
        per-channel values, valid mask). ``SignedDistanceField`` overrides
        this with its distance semantics; ``get_location`` keeps the
        ``(dict, valid)`` contract on every map type."""
        return self._get_cells(index)

    def get_location(self, p_world):
        """Cell channels at world locations ``[..., 3|4]`` -> (dict, valid),
        on every map type."""
        p = torch.as_tensor(p_world, device=self.origin_transform.device)
        return self._get_cells(self.location_to_grid_index(p[..., :3]))

    def set_index(self, index, **channel_values):
        """Functional ``SetIndex``: a new map with the given channel values
        written at integer indices ``[..., 3]``. Lanes out of bounds
        (negative ones too) are dropped, not clipped; where valid lanes
        share a cell the last one wins, as in the JAX package's scatter, on
        every device. Component and segment caches are invalidated. Raises
        on a locked :class:`SignedDistanceField` (unlock first)."""
        if getattr(self, "locked", False):
            raise ValueError(
                "Cannot mutate a locked SignedDistanceField; unlock() first")
        idx = self._index_tensor(index).long()
        lanes = idx.shape[:-1]
        names = self._channel_names()
        for name in channel_values:
            if name not in names:
                raise ValueError(f"Unknown channel {name!r}")
        flat = self.spec.flat_index(idx).reshape(-1)
        keep = self.spec.check_grid_index_in_bounds(idx).reshape(-1)
        # The last valid lane of each cell: stable sort by cell, then the
        # final entry of every run of equal cells.
        lane = torch.nonzero(keep).reshape(-1)
        order = torch.argsort(flat[lane], stable=True)
        lane = lane[order]
        cells = flat[lane]
        last = torch.ones_like(cells, dtype=torch.bool)
        last[:-1] = cells[1:] != cells[:-1]
        lane, cells = lane[last], cells[last]
        updates = {}
        for name, value in channel_values.items():
            chan = getattr(self, name)
            value = _bits(_as_channel_values(value, chan))
            out = _bits(chan).clone()
            out.view(-1)[cells] = torch.broadcast_to(value, lanes).reshape(
                -1)[lane]
            updates[name] = out.view(chan.dtype)
        for flag in ("components_valid", "spatial_segments_valid"):
            if hasattr(self, flag):
                updates[flag] = False
        return self.replace(**updates)

    def set_location(self, p_world, **channel_values):
        """Functional ``SetLocation``."""
        p = torch.as_tensor(p_world, device=self.origin_transform.device)
        return self.set_index(self.location_to_grid_index(p[..., :3]),
                              **channel_values)


def _bits(x: Tensor) -> Tensor:
    """``x`` itself, or for a uint32 tensor an int32 view of its bits
    (PyTorch cannot gather or scatter uint32)."""
    return x.view(torch.int32) if x.dtype == torch.uint32 else x


def _as_channel_values(value, chan: Tensor) -> Tensor:
    """``value`` in ``chan``'s dtype and device. Into a uint32 channel,
    host numbers convert as numpy converts them (a negative one raises
    ``OverflowError``), and values move as their int32 bits."""
    if chan.dtype != torch.uint32:
        return torch.as_tensor(value, dtype=chan.dtype, device=chan.device)
    if isinstance(value, torch.Tensor) and value.dtype == torch.uint32:
        return _bits(value).to(chan.device).view(torch.uint32)
    if isinstance(value, torch.Tensor):
        value = value.cpu().numpy()
    arr = np.array(value, dtype=np.uint32)
    return torch.from_numpy(arr.view(np.int32)).to(chan.device).view(
        torch.uint32)


def _full(spec: GridSpec, value, dtype, device) -> Tensor:
    """An ``[nx, ny, nz]`` channel of ``value``; a uint32 channel is filled
    through its int32 bits."""
    spec.enforce_uniform_voxel_size()
    if dtype == torch.uint32:
        bits = int(np.asarray(value, np.uint32).view(np.int32))
        return torch.full(spec.counts, bits, dtype=torch.int32,
                          device=device).view(torch.uint32)
    return torch.full(spec.counts, value, dtype=dtype, device=device)


def _u32_zero(device) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=device).view(
        torch.uint32)


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
        device = default_device(device)
        return OccupancyMap(
            origin_transform=_default_transform(origin_transform,
                                                device=device),
            occupancy=_full(spec, default_occupancy, torch.float32, device),
            spec=spec, frame=frame)


@dataclasses.dataclass(frozen=True)
class OccupancyComponentMap(_MapBase):
    """Occupancy + cached per-voxel connected-component labels. Update
    ``occupancy`` through :meth:`set_occupancy`, which clears
    ``components_valid``."""

    origin_transform: Tensor
    occupancy: Tensor             # f32 [nx, ny, nz]
    component: Tensor             # u32 [nx, ny, nz]
    number_of_components: Tensor  # u32 0-dim
    spec: GridSpec
    frame: str = ""
    components_valid: bool = False

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE,
               device=None) -> "OccupancyComponentMap":
        """On ``device``; None means the CUDA card."""
        device = default_device(device)
        return OccupancyComponentMap(
            origin_transform=_default_transform(origin_transform,
                                                device=device),
            occupancy=_full(spec, default_occupancy, torch.float32, device),
            component=_full(spec, 0, torch.uint32, device),
            number_of_components=_u32_zero(device),
            spec=spec, frame=frame, components_valid=False)

    def set_occupancy(self, occupancy: Tensor) -> "OccupancyComponentMap":
        return self.replace(occupancy=occupancy, components_valid=False)


@dataclasses.dataclass(frozen=True)
class TaggedObjectOccupancyMap(_MapBase):
    """Occupancy + semantic object id."""

    origin_transform: Tensor
    occupancy: Tensor  # f32 [nx, ny, nz]
    object_id: Tensor  # u32 [nx, ny, nz]
    spec: GridSpec
    frame: str = ""

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE, default_object_id: int = 0,
               device=None) -> "TaggedObjectOccupancyMap":
        """On ``device``; None means the CUDA card."""
        device = default_device(device)
        return TaggedObjectOccupancyMap(
            origin_transform=_default_transform(origin_transform,
                                                device=device),
            occupancy=_full(spec, default_occupancy, torch.float32, device),
            object_id=_full(spec, default_object_id, torch.uint32, device),
            spec=spec, frame=frame)


@dataclasses.dataclass(frozen=True)
class TaggedObjectOccupancyComponentMap(_MapBase):
    """Occupancy + object id + component + spatial segment."""

    origin_transform: Tensor
    occupancy: Tensor                   # f32 [nx, ny, nz]
    object_id: Tensor                   # u32 [nx, ny, nz]
    component: Tensor                   # u32 [nx, ny, nz]
    spatial_segment: Tensor             # u32 [nx, ny, nz]
    number_of_components: Tensor        # u32 0-dim
    number_of_spatial_segments: Tensor  # u32 0-dim
    spec: GridSpec
    frame: str = ""
    components_valid: bool = False
    spatial_segments_valid: bool = False

    @staticmethod
    def create(spec: GridSpec, origin_transform=None, frame: str = "",
               default_occupancy: float = FREE, default_object_id: int = 0,
               device=None) -> "TaggedObjectOccupancyComponentMap":
        """On ``device``; None means the CUDA card."""
        device = default_device(device)
        return TaggedObjectOccupancyComponentMap(
            origin_transform=_default_transform(origin_transform,
                                                device=device),
            occupancy=_full(spec, default_occupancy, torch.float32, device),
            object_id=_full(spec, default_object_id, torch.uint32, device),
            component=_full(spec, 0, torch.uint32, device),
            spatial_segment=_full(spec, 0, torch.uint32, device),
            number_of_components=_u32_zero(device),
            number_of_spatial_segments=_u32_zero(device),
            spec=spec, frame=frame,
            components_valid=False, spatial_segments_valid=False)

    def set_occupancy(self, occupancy: Tensor
                      ) -> "TaggedObjectOccupancyComponentMap":
        return self.replace(occupancy=occupancy, components_valid=False,
                            spatial_segments_valid=False)


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
