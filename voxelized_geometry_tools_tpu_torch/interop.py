"""Build the port's objects from the JAX package's state, given as numpy
arrays and plain Python fields (``np.asarray`` on each JAX leaf), so that
both packages compute on the same state. Arrays are copied (numpy views of
JAX arrays are read-only). Imports no JAX."""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from .core.device import default_device
from .core.grid import GridSpec
from .core.maps import (
    OccupancyComponentMap, OccupancyMap, SignedDistanceField,
    TaggedObjectOccupancyComponentMap, TaggedObjectOccupancyMap)
from .models.online_mapper import OnlineMapper
from .ops.render import PinholeCamera, SdfMip
from .ops.sdf_query import CornerPairTable, CornerTable
from .ops.voxelize import FilterOptions, PointCloud


def grid_spec_from_fields(counts: Sequence[int], resolution: float,
                          voxel_sizes: Optional[Sequence[float]] = None
                          ) -> GridSpec:
    """``GridSpec`` from a JAX ``GridSpec``'s ``counts``, ``resolution`` and
    ``voxel_sizes``."""
    return GridSpec(tuple(int(c) for c in counts), float(resolution),
                    voxel_sizes=None if voxel_sizes is None
                    else tuple(float(s) for s in voxel_sizes))


def sdf_from_numpy(spec: GridSpec, distances: np.ndarray,
                   origin_transform: np.ndarray, frame: str = "",
                   locked: bool = False, oob_value: float = float("inf"),
                   minimum=None, maximum=None,
                   device=None) -> SignedDistanceField:
    """A ``SignedDistanceField`` holding the given arrays as they are (same
    dtype). A locked field keeps the given ``minimum``/``maximum`` when
    both are passed, else recomputes them. ``device``: None means the CUDA
    card."""
    dist = torch.tensor(np.asarray(distances), device=default_device(device))
    sdf = SignedDistanceField.create(
        spec, dist, origin_transform=np.asarray(origin_transform),
        frame=frame, oob_value=oob_value, dtype=dist.dtype)
    if not locked:
        return sdf
    if minimum is None or maximum is None:
        return sdf.lock()
    return sdf.replace(
        minimum=torch.tensor(np.asarray(minimum), dtype=dist.dtype,
                             device=dist.device),
        maximum=torch.tensor(np.asarray(maximum), dtype=dist.dtype,
                             device=dist.device),
        locked=True)


def camera_from_numpy(pose: np.ndarray, fx, fy, cx, cy, width: int,
                      height: int, device=None) -> PinholeCamera:
    """A ``PinholeCamera`` from a JAX camera's leaves and static fields, on
    ``device`` (None: the CUDA card)."""
    return PinholeCamera.create(np.asarray(pose, np.float32), width, height,
                                fx=float(fx), fy=float(fy), cx=float(cx),
                                cy=float(cy), device=default_device(device))


def corner_table_from_numpy(rows: np.ndarray, device=None) -> CornerTable:
    """A ``CornerTable`` from a JAX ``CornerTable.rows``, on ``device``
    (None: the CUDA card)."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] != 8:
        raise ValueError(f"corner table rows must be [N, 8], got "
                         f"{rows.shape}")
    return CornerTable(rows=torch.tensor(rows, device=default_device(device)))


def corner_pair_table_from_numpy(rows: np.ndarray,
                                 device=None) -> CornerPairTable:
    """A ``CornerPairTable`` from a JAX ``CornerPairTable.rows`` (the same
    packed ``[ceil(N / 4), 8]`` layout), on ``device`` (None: the CUDA
    card)."""
    rows = np.asarray(rows)
    if rows.ndim != 2 or rows.shape[1] != 8:
        raise ValueError(f"corner pair table rows must be [ceil(N / 4), 8], "
                         f"got {rows.shape}")
    return CornerPairTable(
        rows=torch.tensor(rows, device=default_device(device)))


def pointcloud_from_numpy(points: np.ndarray, origin_transform: np.ndarray,
                          max_range=float("inf"), device=None) -> PointCloud:
    """A ``PointCloud`` from a JAX ``PointCloud``'s leaves (points, pose,
    max range), on ``device`` (None: the CUDA card)."""
    return PointCloud.create(np.asarray(points, np.float32),
                             np.asarray(origin_transform, np.float32),
                             max_range=float(np.asarray(max_range)),
                             device=default_device(device))


def occupancy_map_from_numpy(spec: GridSpec, occupancy: np.ndarray,
                             origin_transform: np.ndarray, frame: str = "",
                             device=None) -> OccupancyMap:
    """An ``OccupancyMap`` holding a copy of ``occupancy`` (float32) with
    the given pose, on ``device`` (None: the CUDA card)."""
    dev = default_device(device)
    occ = torch.tensor(np.asarray(occupancy, np.float32), device=dev)
    if tuple(occ.shape) != tuple(spec.counts):
        raise ValueError(f"occupancy shape {tuple(occ.shape)} != spec counts "
                         f"{spec.counts}")
    base = OccupancyMap.create(spec, np.asarray(origin_transform), frame,
                               device=dev)
    return base.replace(occupancy=occ)


def online_mapper_from_numpy(spec: GridSpec, origin_transform: np.ndarray,
                             frame: str, occupancy: np.ndarray,
                             frames_integrated: int,
                             filter_options: FilterOptions = FilterOptions(),
                             max_steps: Optional[int] = None,
                             carve_run_axis: Optional[int] = None,
                             device=None) -> OnlineMapper:
    """An ``OnlineMapper`` that continues a JAX mapper's state: its map's
    pose, frame and occupancy (``mapper.occupancy_map``) and its
    ``frames_integrated``, with the mapper's options, on ``device`` (None:
    the CUDA card). The SDF cache starts empty."""
    mapper = OnlineMapper(spec, np.asarray(origin_transform), frame,
                          filter_options=filter_options, max_steps=max_steps,
                          carve_run_axis=carve_run_axis, device=device)
    occ = occupancy_map_from_numpy(spec, occupancy, origin_transform, frame,
                                   device=mapper.occupancy_map.occupancy.device)
    mapper._set_occupancy(occ.occupancy, int(frames_integrated))
    return mapper


def sdf_mip_from_numpy(values: np.ndarray, coarse_counts: Sequence[int],
                       factor: int, block_size: float,
                       device=None) -> SdfMip:
    """An ``SdfMip`` from a JAX ``SdfMip``'s values and static fields, on
    ``device`` (None: the CUDA card)."""
    vals = torch.tensor(np.asarray(values, np.float32),
                        device=default_device(device)).reshape(-1)
    counts = tuple(int(c) for c in coarse_counts)
    if vals.numel() != int(np.prod(counts)):
        raise ValueError(f"mip values hold {vals.numel()} blocks, "
                         f"coarse_counts {counts}")
    return SdfMip(values=vals, coarse_counts=counts, factor=int(factor),
                  block_size=float(block_size))


def _u32(x, dev) -> torch.Tensor:
    """A uint32 channel or counter from numpy, through its int32 bits."""
    return torch.from_numpy(np.array(x, np.uint32).view(np.int32)).to(
        dev).view(torch.uint32)


def _map_from_numpy(cls, spec: GridSpec, origin_transform, frame: str,
                    device, channels: dict, counters: dict, flags: dict):
    """A map of class ``cls``: its ``create``'s defaults, then the given
    float32 occupancy, uint32 channels and counters, and cache flags."""
    dev = default_device(device)
    fields = {name: _u32(value, dev) for name, value in channels.items()
              if name != "occupancy"}
    fields["occupancy"] = torch.tensor(
        np.asarray(channels["occupancy"], np.float32), device=dev)
    for name, value in fields.items():
        if tuple(value.shape) != tuple(spec.counts):
            raise ValueError(f"{name} shape {tuple(value.shape)} != spec "
                             f"counts {spec.counts}")
    for name, value in counters.items():
        fields[name] = _u32(value, dev).reshape(())
    base = cls.create(spec, origin_transform, frame, device=dev)
    return base.replace(**fields, **flags)


def occupancy_component_map_from_numpy(
        spec: GridSpec, occupancy: np.ndarray, component: np.ndarray,
        number_of_components=0, origin_transform=None, frame: str = "",
        components_valid: bool = False,
        device=None) -> OccupancyComponentMap:
    """An ``OccupancyComponentMap`` from a JAX one's arrays (float32
    occupancy, uint32 labels and count) and flag, on ``device`` (None: the
    CUDA card)."""
    return _map_from_numpy(
        OccupancyComponentMap, spec, origin_transform, frame, device,
        {"occupancy": occupancy, "component": component},
        {"number_of_components": number_of_components},
        {"components_valid": bool(components_valid)})


def tagged_object_occupancy_map_from_numpy(
        spec: GridSpec, occupancy: np.ndarray, object_id: np.ndarray,
        origin_transform=None, frame: str = "",
        device=None) -> TaggedObjectOccupancyMap:
    """A ``TaggedObjectOccupancyMap`` from a JAX one's arrays (float32
    occupancy, uint32 object ids), on ``device`` (None: the CUDA card)."""
    return _map_from_numpy(
        TaggedObjectOccupancyMap, spec, origin_transform, frame, device,
        {"occupancy": occupancy, "object_id": object_id}, {}, {})


def tagged_object_occupancy_component_map_from_numpy(
        spec: GridSpec, occupancy: np.ndarray, object_id: np.ndarray,
        component: np.ndarray, spatial_segment: np.ndarray,
        number_of_components=0, number_of_spatial_segments=0,
        origin_transform=None, frame: str = "",
        components_valid: bool = False,
        spatial_segments_valid: bool = False,
        device=None) -> TaggedObjectOccupancyComponentMap:
    """A ``TaggedObjectOccupancyComponentMap`` from a JAX one's arrays,
    counts and flags, on ``device`` (None: the CUDA card)."""
    return _map_from_numpy(
        TaggedObjectOccupancyComponentMap, spec, origin_transform, frame,
        device,
        {"occupancy": occupancy, "object_id": object_id,
         "component": component, "spatial_segment": spatial_segment},
        {"number_of_components": number_of_components,
         "number_of_spatial_segments": number_of_spatial_segments},
        {"components_valid": bool(components_valid),
         "spatial_segments_valid": bool(spatial_segments_valid)})
