"""Dense voxel-grid core: static geometry spec + index math on tensors.

Port of ``voxelized_geometry_tools_tpu/core/grid.py``. :class:`GridSpec` is
pure Python (voxel counts + sizes); its index math takes tensors and runs on
their device.

Conventions (shared with the JAX package):

* the grid-frame origin is the minimum corner of voxel ``(0, 0, 0)``;
* ``location -> index`` is ``floor(p_grid / voxel_sizes)`` per axis;
* ``index -> location`` is the cell center ``(index + 0.5) * voxel_sizes``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

from . import transforms
from .constants import constant

Tensor = torch.Tensor


@dataclasses.dataclass(frozen=True)
class GridSpec:
    """Static voxel-grid geometry (hashable)."""

    counts: Tuple[int, int, int]
    resolution: float
    # Per-axis voxel sizes; defaults to the uniform ``(resolution,) * 3``.
    # ``resolution`` always equals the X size.
    voxel_sizes: Optional[Tuple[float, float, float]] = None

    def __post_init__(self):
        if not (math.isfinite(self.resolution) and self.resolution > 0.0):
            raise ValueError("resolution must be a positive finite number")
        if any(int(c) <= 0 for c in self.counts):
            raise ValueError("voxel counts must be positive")
        object.__setattr__(
            self, "counts", tuple(int(c) for c in self.counts))
        object.__setattr__(self, "resolution", float(self.resolution))
        if self.voxel_sizes is None:
            sizes = (self.resolution,) * 3
        else:
            sizes = tuple(float(s) for s in self.voxel_sizes)
            if len(sizes) != 3:
                raise ValueError(
                    f"voxel_sizes must have 3 entries, got {len(sizes)}")
            if any(not (math.isfinite(v) and v > 0.0) for v in sizes):
                raise ValueError(
                    "voxel sizes must be positive finite numbers")
            if not math.isclose(sizes[0], self.resolution,
                                rel_tol=1e-6, abs_tol=0.0):
                raise ValueError(
                    "resolution must equal voxel_sizes[0] (VoxelXSize)")
            object.__setattr__(self, "resolution", sizes[0])
        object.__setattr__(self, "voxel_sizes", sizes)

    # -- constructors ------------------------------------------------------

    @staticmethod
    def from_voxel_counts(resolution: float, counts) -> "GridSpec":
        return GridSpec(tuple(int(c) for c in counts), float(resolution))

    @staticmethod
    def from_voxel_sizes(voxel_sizes, counts) -> "GridSpec":
        sizes = tuple(float(s) for s in voxel_sizes)
        return GridSpec(tuple(int(c) for c in counts), sizes[0],
                        voxel_sizes=sizes)

    @staticmethod
    def from_grid_sizes(resolution: float, sizes) -> "GridSpec":
        """Counts from physical axis sizes, rounded up."""
        resolution = float(resolution)
        counts = tuple(
            int(np.maximum(1, np.ceil(float(s) / resolution - 1e-9)))
            for s in sizes)
        return GridSpec(counts, resolution)

    # -- basic properties --------------------------------------------------

    @property
    def num_x(self) -> int:
        return self.counts[0]

    @property
    def num_y(self) -> int:
        return self.counts[1]

    @property
    def num_z(self) -> int:
        return self.counts[2]

    @property
    def num_total(self) -> int:
        return self.counts[0] * self.counts[1] * self.counts[2]

    @property
    def shape(self) -> Tuple[int, int, int]:
        return self.counts

    @property
    def grid_sizes(self) -> Tuple[float, float, float]:
        return tuple(c * s for c, s in zip(self.counts, self.voxel_sizes))

    @property
    def has_uniform_voxel_size(self) -> bool:
        return (self.voxel_sizes[0] == self.voxel_sizes[1]
                == self.voxel_sizes[2])

    def enforce_uniform_voxel_size(self) -> "GridSpec":
        if not self.has_uniform_voxel_size:
            raise ValueError(
                "this container requires a uniform voxel size; got "
                f"voxel_sizes={self.voxel_sizes}")
        return self

    # -- index math ----------------------------------------------------------

    def grid_index_to_location_in_grid_frame(self, index: Tensor,
                                             dtype=torch.float32) -> Tensor:
        """Cell-center location in grid frame for integer index [..., 3]."""
        sizes = constant(tuple(self.voxel_sizes), dtype, index.device)
        half = constant(0.5, dtype, index.device)
        return (index.to(dtype) + half) * sizes

    def location_in_grid_frame_to_grid_index(self, p_grid: Tensor) -> Tensor:
        """floor(p / voxel size) per axis, int32; may be out of bounds."""
        p = p_grid if p_grid.is_floating_point() else p_grid.float()
        sizes = constant(tuple(self.voxel_sizes), p.dtype, p.device)
        return torch.floor(p[..., :3] / sizes).to(torch.int32)

    def check_grid_index_in_bounds(self, index: Tensor) -> Tensor:
        counts = constant(tuple(self.counts), index.dtype, index.device)
        return torch.all((index >= 0) & (index < counts), dim=-1)

    def flat_index(self, index: Tensor) -> Tensor:
        """Row-major (x-major, z-fastest) flat index of [..., 3]."""
        ny, nz = self.counts[1], self.counts[2]
        return index[..., 0] * (ny * nz) + index[..., 1] * nz + index[..., 2]

    def unflatten_index(self, flat: Tensor) -> Tensor:
        """Inverse of :meth:`flat_index`: ``[..., 3]`` int32 indices."""
        ny, nz = self.counts[1], self.counts[2]
        x = torch.div(flat, ny * nz, rounding_mode="floor")
        rem = flat - x * (ny * nz)
        y = torch.div(rem, nz, rounding_mode="floor")
        return torch.stack([x, y, rem - y * nz], dim=-1).to(torch.int32)


def grid_index_to_location(spec: GridSpec, origin_transform: Tensor,
                           index: Tensor) -> Tensor:
    """Integer grid index ``[..., 3]`` -> world cell-center location."""
    p_grid = spec.grid_index_to_location_in_grid_frame(index)
    return transforms.apply_isometry(origin_transform, p_grid)


def get_index_values(data: Tensor, index: Tensor, oob_value) -> Tensor:
    """Gather ``data[index]``; any out-of-bounds lane returns ``oob_value``
    (indices are clamped into the grid first, then the lane is replaced)."""
    counts = constant(tuple(data.shape[:3]), index.dtype, index.device)
    in_bounds = torch.all((index >= 0) & (index < counts), dim=-1)
    safe = torch.minimum(torch.clamp(index, min=0), counts - 1).long()
    gathered = data[safe[..., 0], safe[..., 1], safe[..., 2]]
    oob = torch.tensor(oob_value, dtype=data.dtype, device=data.device)
    return torch.where(in_bounds, gathered, oob)
