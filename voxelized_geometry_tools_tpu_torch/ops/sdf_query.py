"""Differentiable SDF queries, gradients, projections, the local-extrema
map and the corner tables.

Port of ``voxelized_geometry_tools_tpu/ops/sdf_query.py``: trilinear
distance estimation with corrected cell-center distances, the corner-brick
table that turns a sample's 8 corner gathers into one row gather, and the
z-pair table (2x the grid's memory) that turns them into four; coarse and
fine gradients; the project-out-of-collision gradient walks (each
``lax.while_loop`` of the JAX package a Python loop with one ``any()``
host sync a step); and the local-extrema map as pointer jumping over the
one-step "next cell" field, with the JAX package's fixed round count.
Every query is batched over ``[..., 3]`` points, branch-free
(``torch.where``), and the distance queries are differentiable in the
points and in the distances through autograd.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple, Union

import torch

from ..core import transforms
from ..core.constants import constant
from ..core.maps import SignedDistanceField
from .edt import _sqrt

Tensor = torch.Tensor

# Cells per step of the local-extrema map's gradient and output passes:
# bounds their [m, 3] int64 index temporaries.
_EXTREMA_CHUNK = 1 << 22


class DistanceQuery(NamedTuple):
    """Batched ``EstimateDistanceQuery``: values and a validity mask."""
    value: Tensor
    valid: Tensor


class GradientQuery(NamedTuple):
    """Batched ``GradientQuery``: ``[..., 3]`` gradients and a mask."""
    gradient: Tensor
    valid: Tensor


class ProjectionResult(NamedTuple):
    """Batched ``ProjectedPosition``: ``[..., 3]`` positions and a mask."""
    position: Tensor
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


def estimate_index_distance(sdf: SignedDistanceField,
                            index: Tensor) -> DistanceQuery:
    """``EstimateIndexDistance``: the estimate at the world-frame cell
    centers of integer indices ``[..., 3]``."""
    return estimate_location_distance(sdf, sdf.grid_index_to_location(index))


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


def get_grid_aligned_index_coarse_gradient(
        sdf: SignedDistanceField, index: Tensor,
        enable_edge_gradients: bool = False) -> GradientQuery:
    """``GetGridAlignedIndexCoarseGradient``, batched over ``[..., 3]``:
    central differences over +/- 1 cell at interior cells; with
    ``enable_edge_gradients`` edge cells take the window clamped into the
    grid, else they are invalid. Invalid lanes read NaN."""
    idx = index
    counts = constant(tuple(sdf.spec.counts), idx.dtype, idx.device)
    in_bounds = torch.all((idx >= 0) & (idx < counts), dim=-1)
    interior = torch.all((idx > 0) & (idx < counts - 1), dim=-1)
    res = sdf.resolution
    dist = sdf.distances

    def value_at(offset):
        return sdf.get_index(idx + constant(offset, idx.dtype, idx.device))

    inv2r = _scalar(1.0 / (2.0 * res), dist)
    g_interior = torch.stack([
        (value_at((1, 0, 0)) - value_at((-1, 0, 0))) * inv2r,
        (value_at((0, 1, 0)) - value_at((0, -1, 0))) * inv2r,
        (value_at((0, 0, 1)) - value_at((0, 0, -1))) * inv2r,
    ], dim=-1)

    if enable_edge_gradients:
        low = torch.clamp(idx - 1, min=0)
        high = torch.minimum(idx + 1, counts - 1)
        incr = (high - low).to(dist.dtype) * _scalar(res, dist)
        zero = _scalar(0.0, dist)
        tiny = _scalar(1e-30, dist)

        def axis_grad(axis):
            lo_idx = idx.clone()
            lo_idx[..., axis] = low[..., axis]
            hi_idx = idx.clone()
            hi_idx[..., axis] = high[..., axis]
            delta = sdf.get_index(hi_idx) - sdf.get_index(lo_idx)
            return torch.where(incr[..., axis] > 0.0,
                               delta / torch.maximum(incr[..., axis], tiny),
                               zero)

        g_edge = torch.stack([axis_grad(0), axis_grad(1), axis_grad(2)],
                             dim=-1)
        gradient = torch.where(interior[..., None], g_interior, g_edge)
        valid = in_bounds
    else:
        gradient = g_interior
        valid = in_bounds & interior
    gradient = torch.where(valid[..., None], gradient,
                           _scalar(float("nan"), gradient))
    return GradientQuery(gradient, valid)


def get_index_coarse_gradient(sdf: SignedDistanceField, index: Tensor,
                              enable_edge_gradients: bool = False
                              ) -> GradientQuery:
    """``GetIndexCoarseGradient``: the grid-aligned gradient rotated into
    the world frame by the origin rotation."""
    aligned = get_grid_aligned_index_coarse_gradient(sdf, index,
                                                     enable_edge_gradients)
    world = transforms.rotate_vector(sdf.origin_transform, aligned.gradient)
    return GradientQuery(world, aligned.valid)


def get_location_coarse_gradient(sdf: SignedDistanceField, p_world: Tensor,
                                 enable_edge_gradients: bool = False
                                 ) -> GradientQuery:
    """``GetLocationCoarseGradient``: the coarse gradient of the cell that
    holds each world point ``[..., 3]``; non-finite or out-of-grid points
    are invalid."""
    p = p_world[..., :3]
    finite = torch.all(torch.isfinite(p), dim=-1)
    index = sdf.location_to_grid_index(
        torch.where(finite[..., None], p, _scalar(0.0, p)))
    in_bounds = finite & sdf.spec.check_grid_index_in_bounds(index)
    counts = constant(tuple(sdf.spec.counts), index.dtype, index.device)
    safe = torch.minimum(torch.clamp(index, min=0), counts - 1)
    g = get_index_coarse_gradient(sdf, safe, enable_edge_gradients)
    valid = in_bounds & g.valid
    return GradientQuery(torch.where(valid[..., None], g.gradient,
                                     _scalar(float("nan"), g.gradient)),
                         valid)


def get_location_fine_gradient(sdf: SignedDistanceField, p_world: Tensor,
                               nominal_window_size: float) -> GradientQuery:
    """``GetLocationFineGradient``: differences of trilinear estimates over
    a window of ``nominal_window_size`` per axis, one-sided where only one
    side is in the grid."""
    dt = sdf.distances.dtype
    p = p_world[..., :3].to(dt)
    w = _scalar(abs(float(nominal_window_size)), sdf.distances)
    two_w = 2.0 * w
    nan = _scalar(float("nan"), sdf.distances)
    in_bounds = sdf.spec.check_grid_index_in_bounds(
        sdf.location_to_grid_index(p))
    center = estimate_location_distance(sdf, p)

    def axis_fine(axis):
        minus = p.clone()
        minus[..., axis] = p[..., axis] + (-w)
        plus = p.clone()
        plus[..., axis] = p[..., axis] + w
        dm = estimate_location_distance(sdf, minus)
        dp = estimate_location_distance(sdf, plus)
        both = center.valid & dm.valid & dp.valid
        only_minus = center.valid & dm.valid & ~dp.valid
        only_plus = center.valid & dp.valid & ~dm.valid
        g_both = (dp.value - dm.value) / two_w
        g_minus = (center.value - dm.value) / w
        g_plus = (dp.value - center.value) / w
        g = torch.where(both, g_both,
                        torch.where(only_minus, g_minus,
                                    torch.where(only_plus, g_plus, nan)))
        return g, both | only_minus | only_plus

    gx, vx = axis_fine(0)
    gy, vy = axis_fine(1)
    gz, vz = axis_fine(2)
    valid = in_bounds & vx & vy & vz
    gradient = torch.where(valid[..., None], torch.stack([gx, gy, gz], dim=-1),
                           nan)
    return GradientQuery(gradient, valid)


def get_index_fine_gradient(sdf: SignedDistanceField, index: Tensor,
                            nominal_window_size: float) -> GradientQuery:
    """``GetIndexFineGradient``: the fine gradient at the world-frame cell
    centers of integer indices ``[..., 3]``."""
    return get_location_fine_gradient(
        sdf, sdf.grid_index_to_location(index), nominal_window_size)


def project_out_of_collision(sdf: SignedDistanceField, p_world: Tensor,
                             stepsize_multiplier: float = 0.1,
                             max_steps: int = 1000) -> ProjectionResult:
    """``ProjectLocationOutOfCollision``: walk each point up the coarse
    gradient until its distance is above zero."""
    return project_out_of_collision_to_minimum_distance(
        sdf, p_world, 0.0, stepsize_multiplier, max_steps)


def project_out_of_collision_to_minimum_distance(
        sdf: SignedDistanceField, p_world: Tensor, minimum_distance: float,
        stepsize_multiplier: float = 0.1,
        max_steps: int = 1000) -> ProjectionResult:
    """``ProjectLocationOutOfCollisionToMinimumDistance``, batched: each
    point at or below ``minimum_distance`` steps along the coarse gradient
    (edge gradients on) by at most ``stepsize_multiplier`` voxels until it
    is above it. At most ``max_steps`` steps, each a Python iteration with
    one host sync; walks that run out of steps or meet a flat or invalid
    gradient return ``valid=False``. Points that start outside the grid are
    returned unchanged with ``valid=True``."""
    dist = sdf.distances
    p = p_world[..., :3].to(dist.dtype)
    res = float(sdf.resolution)
    min_dist = _scalar(minimum_distance, dist)
    margin = _scalar(minimum_distance + res * stepsize_multiplier * 1e-3,
                     dist)
    max_step = _scalar(res * stepsize_multiplier, dist)
    grad_floor = _scalar(res * 0.25, dist)
    zero = _scalar(0.0, dist)
    tiny = _scalar(1e-30, dist)

    start_in_bounds = sdf.spec.check_grid_index_in_bounds(
        sdf.location_to_grid_index(p))
    d0 = estimate_location_distance(sdf, p).value
    d = torch.where(start_in_bounds, d0, _scalar(float("inf"), dist))
    active = start_in_bounds & (d0 <= min_dist)
    failed = torch.zeros_like(active)
    for _ in range(int(max_steps)):
        if not bool(active.any()):
            break
        g = get_location_coarse_gradient(sdf, p, enable_edge_gradients=True)
        gv = torch.where(g.valid[..., None], g.gradient, zero)
        x, y, z = gv[..., 0], gv[..., 1], gv[..., 2]
        gnorm = _sqrt(x * x + y * y + z * z, dist.dtype)
        productive = g.valid & (gnorm > grad_floor)
        step = torch.minimum(max_step, margin - d)
        direction = gv / torch.maximum(gnorm, tiny)[..., None]
        moving = active & productive
        p = torch.where(moving[..., None], p + direction * step[..., None], p)
        d = torch.where(moving, estimate_location_distance(sdf, p).value, d)
        failed = failed | (active & ~productive)
        active = moving & (d <= min_dist)
    return ProjectionResult(p, ~(failed | active))


# -- Local extrema (watershed) map -------------------------------------------


def _gradient_is_effectively_flat(gradient: Tensor,
                                  resolution: float) -> Tensor:
    """``GradientIsEffectiveFlat``: every |component| within
    ``0.06125 * resolution``."""
    thresh = _scalar(resolution * 0.06125, gradient)
    return torch.all(torch.abs(gradient) <= thresh, dim=-1)


def _next_from_gradient(sdf: SignedDistanceField, index: Tensor,
                        gradient: Tensor) -> Tensor:
    """``GetNextFromGradient``: a thresholded sign step toward increasing
    distance (flipped inside obstacles) over the 26-neighbourhood."""
    d = sdf.get_index(index)
    working = torch.where((d < 0.0)[..., None], -gradient, gradient)
    thresh = _scalar(sdf.resolution * 0.06125, working)
    step = torch.where(working > thresh, 1,
                       torch.where(working < -thresh, -1, 0)).to(index.dtype)
    return index + step


def compute_local_extrema_map(sdf: SignedDistanceField,
                              max_jump_rounds: int = 64) -> Tensor:
    """``ComputeLocalExtremaMap`` as the JAX package's parallel fixed point:
    ``[nx, ny, nz, 3]`` grid-frame centers (in the field's dtype) of the
    local extremum each cell's gradient walk reaches, ``+inf`` for walks
    that leave the grid. Flat cells are terminals; a cycle maps to its
    lowest flat index. The next-cell field is int32, as in the JAX package,
    and formed ``_EXTREMA_CHUNK`` cells at a time; the pointer jumping
    gathers with int32 indices (``index_select``), so no ``[n, 3]`` int64
    index tensor is ever whole."""
    spec = sdf.spec
    nx, ny, nz = spec.counts
    n = nx * ny * nz
    dev = sdf.distances.device
    i32 = torch.int32
    nxt = torch.empty(n + 1, dtype=i32, device=dev)
    nxt[n] = n  # the off-grid terminal, a self-loop
    for s in range(0, n, _EXTREMA_CHUNK):
        cells = torch.arange(s, min(s + _EXTREMA_CHUNK, n), dtype=i32,
                             device=dev)
        idx = spec.unflatten_index(cells)
        grad = get_index_coarse_gradient(sdf, idx,
                                         enable_edge_gradients=True)
        flat = _gradient_is_effectively_flat(grad.gradient, spec.resolution)
        step_idx = _next_from_gradient(sdf, idx, grad.gradient)
        in_bounds = spec.check_grid_index_in_bounds(step_idx)
        nxt[s:s + cells.numel()] = torch.where(
            flat, cells, torch.where(in_bounds,
                                     spec.flat_index(step_idx).to(i32),
                                     constant(n, i32, dev)))
        del idx, grad, step_idx

    # After round k, ptr[i] is 2^k steps along i's walk and rep[i] the
    # least index among those steps: ceil(log2 n) + 2 rounds collapse every
    # chain onto its terminal or into its cycle.
    rounds = max(1, min(max_jump_rounds, math.ceil(math.log2(max(n, 2))) + 2))
    ptr = nxt
    rep = torch.arange(n + 1, dtype=i32, device=dev)
    for _ in range(rounds):
        rep = torch.minimum(rep, rep.index_select(0, ptr))
        ptr = ptr.index_select(0, ptr)

    core = ptr[:n]
    core_safe = torch.clamp(core, max=n - 1)
    core_is_flat = (nxt.index_select(0, core_safe) == core_safe) & (core != n)
    core_is_oob = core == n
    target = torch.where(core_is_flat, core_safe,
                         rep.index_select(0, core_safe))
    del ptr, rep, core, core_safe, core_is_flat
    dt = sdf.distances.dtype
    out = torch.empty((n, 3), dtype=dt, device=dev)
    inf = _scalar(float("inf"), sdf.distances)
    for s in range(0, n, _EXTREMA_CHUNK):
        e = min(s + _EXTREMA_CHUNK, n)
        centers = spec.grid_index_to_location_in_grid_frame(
            spec.unflatten_index(target[s:e]), dtype=dt)
        out[s:e] = torch.where(core_is_oob[s:e, None], inf, centers)
    return out.reshape(nx, ny, nz, 3)
