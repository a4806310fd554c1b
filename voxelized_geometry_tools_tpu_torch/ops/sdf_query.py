"""Differentiable SDF distance queries and the corner-brick table.

Port of ``voxelized_geometry_tools_tpu/ops/sdf_query.py`` (the main-path
subset): trilinear distance estimation with corrected cell-center distances,
the corner-brick table that turns a sample's 8 corner gathers into one row
gather, and the z-pair table (2x the grid's memory) that turns them into
four. Every query is batched over ``[..., 3]`` points, branch-free
(``torch.where``), and differentiable in the points and in the distances
through autograd.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from ..core import transforms
from ..core.constants import constant
from ..core.maps import SignedDistanceField

Tensor = torch.Tensor

class DistanceQuery(NamedTuple):
    """Batched ``EstimateDistanceQuery``: values and a validity mask."""
    value: Tensor
    valid: Tensor


def _scalar(x: float, like: Tensor, dtype=None) -> Tensor:
    """0-dim tensor of ``x`` in ``dtype`` (default ``like``'s), rounded once
    from the Python double as the JAX package rounds its constants."""
    return constant(x, like.dtype if dtype is None else dtype, like.device)


def _axis_interp_indices(initial: Tensor, axis_size: int,
                         axis_offset: Tensor) -> Tuple[Tensor, Tensor]:
    """Vectorized ``GetAxisInterpolationIndices``."""
    i = initial
    n = axis_size
    up_a = torch.where(i + 1 >= n, i, i + 1)
    lo_a = torch.where(i + 1 >= n, torch.where(i - 1 < 0, i, i - 1), i)
    lo_b = torch.where(i - 1 < 0, i, i - 1)
    up_b = torch.where(i - 1 < 0, torch.where(i + 1 >= n, i, i + 1), i)
    pos = axis_offset >= 0.0
    return torch.where(pos, lo_a, lo_b), torch.where(pos, up_a, up_b)


def _pull_to_surface(d: Tensor, offset: Tensor) -> Tensor:
    """Corrected-center rule: pull a stored distance half a cell toward the
    surface (shared by the query path and the table build)."""
    return torch.where(d >= 0.0, d - offset, d + offset)


def _corrected_center_distance(sdf: SignedDistanceField,
                               idx: Tensor) -> Tensor:
    d = sdf.get_index(idx)
    return _pull_to_surface(d, _scalar(sdf.resolution * 0.5, d))


def estimate_distance_interpolate(sdf: SignedDistanceField, p_world: Tensor,
                                  index: Tensor) -> Tensor:
    """Trilinear estimate around a containing cell index (8 gathers).
    Differentiable in ``p_world`` and ``sdf.distances``."""
    dist = sdf.distances
    dt = dist.dtype
    res = _scalar(sdf.resolution, dist)
    p_grid = transforms.apply_isometry(
        sdf.inverse_origin_transform().to(dt), p_world[..., :3].to(dt))
    center = sdf.spec.grid_index_to_location_in_grid_frame(index, dtype=dt)
    offset = p_grid - center

    lx, ux = _axis_interp_indices(index[..., 0], sdf.spec.num_x,
                                  offset[..., 0])
    ly, uy = _axis_interp_indices(index[..., 1], sdf.spec.num_y,
                                  offset[..., 1])
    lz, uz = _axis_interp_indices(index[..., 2], sdf.spec.num_z,
                                  offset[..., 2])

    lower_corner = sdf.spec.grid_index_to_location_in_grid_frame(
        torch.stack([lx, ly, lz], dim=-1))
    # Not clamped: edge cells extrapolate like the reference.
    t = (p_grid - lower_corner) / res

    def corner(cx, cy, cz):
        return _corrected_center_distance(
            sdf, torch.stack([cx, cy, cz], dim=-1))

    v000 = corner(lx, ly, lz)
    v001 = corner(lx, ly, uz)
    v010 = corner(lx, uy, lz)
    v011 = corner(lx, uy, uz)
    v100 = corner(ux, ly, lz)
    v101 = corner(ux, ly, uz)
    v110 = corner(ux, uy, lz)
    v111 = corner(ux, uy, uz)

    tx, ty, tz = t[..., 0], t[..., 1], t[..., 2]
    c00 = v000 * (1 - tx) + v100 * tx
    c01 = v001 * (1 - tx) + v101 * tx
    c10 = v010 * (1 - tx) + v110 * tx
    c11 = v011 * (1 - tx) + v111 * tx
    c0 = c00 * (1 - ty) + c10 * ty
    c1 = c01 * (1 - ty) + c11 * ty
    return c0 * (1 - tz) + c1 * tz


def estimate_location_distance(sdf: SignedDistanceField,
                               p_world: Tensor) -> DistanceQuery:
    """``EstimateLocationDistance``, batched over ``[..., 3]``.
    Out-of-bounds or non-finite points return ``valid=False``, value NaN."""
    p = p_world[..., :3]
    index = sdf.location_to_grid_index(p)
    # Mask non-finite points BEFORE the arithmetic: torch.where passes the
    # unselected branch's NaN/inf gradients on.
    finite = torch.all(torch.isfinite(p), dim=-1)
    valid = finite & sdf.spec.check_grid_index_in_bounds(index)
    counts = constant(tuple(sdf.spec.counts), index.dtype, index.device)
    safe_index = torch.minimum(torch.clamp(index, min=0), counts - 1)
    safe_p = torch.where(finite[..., None], p, _scalar(0.0, p))
    value = estimate_distance_interpolate(sdf, safe_p, safe_index)
    return DistanceQuery(torch.where(valid, value, _scalar(float("nan"),
                                                           value)), valid)


def location_query_valid(sdf: SignedDistanceField, p_world: Tensor,
                         table_dtype=None) -> Tensor:
    """The ``valid`` field of a location query without the value gather;
    with ``table_dtype`` it replays :func:`estimate_location_distance_fast`'s
    predicate, else :func:`estimate_location_distance`'s."""
    if table_dtype is not None:
        p = p_world[..., :3].to(table_dtype)
        p_grid = transforms.apply_isometry(
            sdf.inverse_origin_transform().to(table_dtype), p)
        finite = torch.all(torch.isfinite(p), dim=-1)
        index = sdf.spec.location_in_grid_frame_to_grid_index(
            torch.where(finite[..., None], p_grid, _scalar(0.0, p_grid)))
        return finite & sdf.spec.check_grid_index_in_bounds(index)
    p = p_world[..., :3]
    index = sdf.location_to_grid_index(p)
    finite = torch.all(torch.isfinite(p), dim=-1)
    return finite & sdf.spec.check_grid_index_in_bounds(index)


# -- Corner-brick acceleration table ----------------------------------------
#
# A CornerTable stores, for every base cell ``b``, the 8 corrected corner
# distances of the cell pair ``(b, b+1)`` per axis as one contiguous row, so
# a trilinear sample is ONE row gather instead of eight. With
# ``s = p_grid / resolution - 0.5`` and ``b = clamp(floor(s), 0, n-2)`` per
# axis, the reference's per-octant lower/upper index selection reduces to
# corners ``(b, b+1)`` with ratio ``t = s - b``, so the fast query computes
# the same interpolation as the 8-gather path up to float reassociation.


class CornerTable(NamedTuple):
    """``[num_cells, 8]`` rows: row ``flat(b)`` holds corners ordered
    ``c = 4*dx + 2*dy + dz`` at cells ``clamp(b + (dx, dy, dz), 0, n-1)``."""
    rows: Tensor


# X planes per build step: bounds the build's transient to a few planes.
_TABLE_SLAB = 16


def build_corner_table(sdf: SignedDistanceField, dtype=None) -> CornerTable:
    """Build the corner-brick table from eight shifted slices of the
    edge-padded corrected grid, ``_TABLE_SLAB`` X planes at a time, into
    one preallocated ``[N, 8]`` tensor (8x the grid's memory; the slab loop
    keeps the transient to one slab). Differentiable in ``sdf.distances``.
    ``dtype`` defaults to the field's own."""
    d = sdf.distances
    dtype = d.dtype if dtype is None else dtype
    nx, ny, nz = d.shape
    half = _scalar(sdf.resolution * 0.5, d)
    rows = torch.empty((nx * ny * nz, 8), dtype=dtype, device=d.device)
    for x0 in range(0, nx, _TABLE_SLAB):
        x1 = min(x0 + _TABLE_SLAB, nx)
        # Planes x0 .. x1 (the +1 plane clamped onto the last), corrected
        # and edge-padded by one in y and z.
        xs = torch.arange(x0, x1 + 1, device=d.device).clamp_(max=nx - 1)
        pl = _pull_to_surface(d[xs], half)
        pl = torch.cat([pl, pl[:, -1:]], dim=1)
        pl = torch.cat([pl, pl[:, :, -1:]], dim=2)
        w = x1 - x0
        chans = [pl[dx:dx + w, dy:dy + ny, dz:dz + nz]
                 for dx in (0, 1) for dy in (0, 1) for dz in (0, 1)]
        rows[x0 * ny * nz:x1 * ny * nz] = torch.stack(
            chans, dim=-1).reshape(-1, 8).to(dtype)
    return CornerTable(rows=rows)


class CornerPairTable(NamedTuple):
    """Z-pair rows, packed four pairs to a row: ``[ceil(num_cells / 4), 8]``
    where flat cell ``i``'s pair, the corrected distances at cells ``b``
    and ``b + (0, 0, 1)`` (z clamped to the grid edge), is lanes
    ``(i % 4) * 2`` and ``+ 1`` of row ``i // 4``; the padding lanes are
    zero. The JAX package's layout (its packing avoids a lane-padded TPU
    layout), so rows move between the packages as they are; a query reads
    the rows as ``[*, 2]`` pairs and gathers four of them."""
    rows: Tensor


Table = Union[CornerTable, CornerPairTable]


def build_corner_pair_table(sdf: SignedDistanceField,
                            dtype=None) -> CornerPairTable:
    """Build the z-pair table from two shifted slices of the z-edge-padded
    corrected grid, ``_TABLE_SLAB`` X planes at a time, into one
    preallocated flat tensor (2x the grid's memory). Differentiable in
    ``sdf.distances``. ``dtype`` defaults to the field's own."""
    d = sdf.distances
    dtype = d.dtype if dtype is None else dtype
    nx, ny, nz = d.shape
    half = _scalar(sdf.resolution * 0.5, d)
    plane = ny * nz * 2
    padded = -(-(nx * ny * nz) // 4) * 4
    flat = torch.empty(padded * 2, dtype=dtype, device=d.device)
    flat[nx * plane:] = 0
    for x0 in range(0, nx, _TABLE_SLAB):
        x1 = min(x0 + _TABLE_SLAB, nx)
        pl = _pull_to_surface(d[x0:x1], half)
        pl = torch.cat([pl, pl[:, :, -1:]], dim=2)
        flat[x0 * plane:x1 * plane] = torch.stack(
            [pl[..., :nz], pl[..., 1:]], dim=-1).reshape(-1).to(dtype)
    return CornerPairTable(rows=flat.view(padded // 4, 8))


def estimate_location_distance_fast(
        sdf: SignedDistanceField,
        table: Table, p_world: Tensor) -> DistanceQuery:
    """:func:`estimate_location_distance` semantics with ONE row gather per
    sample from a :class:`CornerTable`, or four pair gathers from a
    :class:`CornerPairTable`. Both assemble the same 8-corner vector, so the
    two tables give the same bits. Differentiable in ``p_world`` and
    ``table.rows`` (hence in ``sdf.distances`` when the table was built from
    them under autograd)."""
    if not isinstance(table, (CornerTable, CornerPairTable)):
        raise TypeError(f"table must be a CornerTable or a CornerPairTable, "
                        f"got {type(table).__name__}")
    spec = sdf.spec
    rows = table.rows
    dt = rows.dtype
    p = p_world[..., :3].to(dt)
    p_grid = transforms.apply_isometry(
        sdf.inverse_origin_transform().to(dt), p)
    finite = torch.all(torch.isfinite(p), dim=-1)
    p_safe = torch.where(finite[..., None], p_grid, _scalar(0.0, p_grid))
    index = spec.location_in_grid_frame_to_grid_index(p_safe)
    valid = finite & spec.check_grid_index_in_bounds(index)

    s = p_safe / _scalar(spec.resolution, rows) - _scalar(0.5, rows)
    counts = constant(tuple(spec.counts), torch.int32, p.device)
    b = torch.minimum(torch.clamp(torch.floor(s).to(torch.int32), min=0),
                      torch.clamp(counts - 2, min=0))
    t = s - b.to(dt)

    nx, ny, nz = spec.counts
    bx, by, bz = b[..., 0].long(), b[..., 1].long(), b[..., 2].long()
    if isinstance(table, CornerPairTable):
        # Four z pairs at (bx | bx+1, by | by+1, bz), the x and y neighbours
        # clamped onto the edge cell as the brick build clamps them;
        # corners ordered c = 4*dx + 2*dy + dz, as in a CornerTable row.
        pairs = rows.reshape(-1, 2)
        bx1 = torch.clamp(bx + 1, max=nx - 1)
        by1 = torch.clamp(by + 1, max=ny - 1)

        def pair(x, y):
            flat = x * (ny * nz) + y * nz + bz
            return pairs.index_select(0, flat.reshape(-1)).reshape(
                *flat.shape, 2)

        corners = torch.cat([pair(bx, by), pair(bx, by1), pair(bx1, by),
                             pair(bx1, by1)], dim=-1)
    else:
        flat = bx * (ny * nz) + by * nz + bz
        corners = rows.index_select(0, flat.reshape(-1)).reshape(
            *flat.shape, 8)

    tx = t[..., 0:1]
    ty = t[..., 1:2]
    tz = t[..., 2:3]
    cx = corners[..., 0:4] * (1 - tx) + corners[..., 4:8] * tx
    cy = cx[..., 0:2] * (1 - ty) + cx[..., 2:4] * ty
    value = cy[..., 0] * (1 - tz[..., 0]) + cy[..., 1] * tz[..., 0]
    return DistanceQuery(torch.where(valid, value, _scalar(float("nan"),
                                                           value)), valid)
