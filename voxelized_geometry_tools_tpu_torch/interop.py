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
from .core.maps import OccupancyMap, SignedDistanceField
from .models.online_mapper import OnlineMapper
from .ops.render import PinholeCamera
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
