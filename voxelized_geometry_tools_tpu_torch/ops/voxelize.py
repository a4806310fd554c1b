"""Pointcloud voxelization: multi-camera depth-cloud ray carving + fusion.

Port of ``voxelized_geometry_tools_tpu/ops/voxelize.py``, eagerly:

* a :class:`PointCloud` holds ``[N, 3]`` camera-frame points, an ``X_WC``
  origin transform and a max range;
* per-cloud :class:`TrackingGrid` s of ``{seen_free, seen_filled}`` int32
  counters are carved by the voxel walk (:func:`raycast_pointcloud`: on a
  CUDA tensor the hand-written kernel ``kernels/csrc/carve.cu``, one launch
  per cloud; on a CPU tensor its plain PyTorch version) or by the
  column-marching twin (:func:`raycast_pointcloud_columns`, plain PyTorch,
  one masked row per visited column);
* the ``CountsSeenAs`` fusion filter (:func:`combine_and_filter`) is a
  per-voxel map over the stacked camera grids (on a CUDA tensor the
  hand-written kernel ``kernels/csrc/fusion_filter.cu``, one launch; on a
  CPU tensor its plain PyTorch version).

Every mapping path carves by :func:`_carve_cloud` and fuses by
:func:`_carve_and_filter`.

Every carve gives the same bits: the setup (:func:`_prepare_rays` and
:func:`_ray_visits`; on a CUDA cloud its kernel ``kernels/csrc/
ray_setup.cu``, one launch per cloud, with the same bits) and the walk's
closed-form crossing times are the JAX package's expressions in its
operation order, each operation rounded on its own. (Compiled XLA CPU code
contracts ``a * b + c`` into one fused multiply-add, so the JAX package
matches the port bit for bit when it runs op by op, ``jax.disable_jit()``;
its compiled carve can pick another voxel where two crossing times lie
within a rounding of each other.) Where the JAX package runs a ``lax``
loop, the port runs a Python loop that reads, each iteration (the walk:
each 64-step segment), whether any ray is still alive.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..core import transforms
from ..core.constants import constant
from ..core.device import default_device
from ..core.grid import GridSpec
from ..core.maps import OccupancyMap
from ..kernels import carve
from ..kernels import fusion_filter
from ..kernels import ray_setup as setup_kernel
from ..kernels.carve import RaySetup, segment_steps
from ..kernels.edt_combine import correctly_rounded_sqrt
from ..kernels.fusion_filter import SeenAs, counts_seen_as  # noqa: F401
from ..utils.profiling import _span

Tensor = torch.Tensor

_INF = float("inf")


class FilterOptions(NamedTuple):
    """``PointCloudVoxelizationFilterOptions`` (hpp:20-92)."""
    percent_seen_free: float = 1.0
    outlier_points_threshold: int = 1
    num_cameras_seen_free: int = 1

    def validate(self) -> "FilterOptions":
        if not (0.0 < self.percent_seen_free <= 1.0):
            raise ValueError("0 < percent_seen_free <= 1 must be true")
        if self.outlier_points_threshold <= 0:
            raise ValueError("outlier_points_threshold <= 0")
        if self.num_cameras_seen_free <= 0:
            raise ValueError("num_cameras_seen_free <= 0")
        return self


@dataclasses.dataclass(frozen=True)
class PointCloud:
    """Camera-frame depth points + camera pose (``PointCloudWrapper``)."""
    points: Tensor            # f32 [N, 3] in camera frame; non-finite skipped
    origin_transform: Tensor  # f32 [4, 4] X_WC
    max_range: Tensor         # f32 0-dim

    @staticmethod
    def create(points, origin_transform=None,
               max_range: float = _INF, device=None) -> "PointCloud":
        """On ``device``; None means the device of ``points`` if it is a
        tensor, else the CUDA card. The range is filled in on the device
        (no host copy)."""
        device = default_device(device, like=points)
        with _span("ingest"):
            if isinstance(points, Tensor):
                pts = points.to(device=device, dtype=torch.float32)
            else:
                pts = torch.tensor(np.asarray(points, np.float32),
                                   device=device)
            pts = pts.reshape(-1, 3)
            if origin_transform is None:
                pose = torch.eye(4, dtype=torch.float32, device=device)
            else:
                pose = _as_f32(origin_transform, device)
            # Rounded to float32 here (torch.full refuses a value that
            # overflows it), as torch.tensor would round it.
            with np.errstate(over="ignore"):
                rounded = float(np.float32(max_range))
            return PointCloud(points=pts, origin_transform=pose,
                              max_range=torch.full((), rounded,
                                                   dtype=torch.float32,
                                                   device=device))


class TrackingGrid(NamedTuple):
    """Per-camera carve counters (cpu_pointcloud_voxelization.hpp:24-40)."""
    seen_free: Tensor    # i32 [nx, ny, nz]
    seen_filled: Tensor  # i32 [nx, ny, nz]


class VoxelizerRuntime(NamedTuple):
    """Phase wall times (pointcloud_voxelization_interface.hpp:206-229),
    measured only for a caller that passes a ``runtime_log_fn``: the port is
    eager, so the voxelizer then synchronizes the device after the carve and
    after the filter."""
    raycasting_time: float
    filtering_time: float


def _as_f32(x, device) -> Tensor:
    """A float32 tensor on ``device`` from a tensor or host data (copied)."""
    if isinstance(x, Tensor):
        return x.to(device=device, dtype=torch.float32)
    return torch.tensor(np.asarray(x, np.float32), device=device)


def _f32(x, device) -> Tensor:
    return constant(x, torch.float32, device)


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _grid_frame_transform(grid_origin_transform, cloud: PointCloud) -> Tensor:
    """``X_GC = inverse(X_WG) @ X_WC``, on the cloud's device (on a card
    without a host copy: the products are the transform product kernel's,
    ``core/transforms.matmul``)."""
    g = _as_f32(grid_origin_transform, cloud.points.device)
    return transforms.compose(transforms.invert_isometry(g),
                              cloud.origin_transform)


def _zero_grid(spec: GridSpec, device) -> TrackingGrid:
    zero = torch.zeros(spec.counts, dtype=torch.int32, device=device)
    return TrackingGrid(zero, zero.clone())


def stacked_grids(spec: GridSpec, n_clouds: int, device) -> TrackingGrid:
    """Uninitialized ``[C, nx, ny, nz]`` int32 counters for ``n_clouds``
    cameras, which the carve writes a camera's slice at a time."""
    return TrackingGrid(*(torch.empty((n_clouds,) + spec.counts,
                                      dtype=torch.int32, device=device)
                          for _ in range(2)))


def _ray_visits(spec: GridSpec, p_start: Tensor, start_index: Tensor,
                p_final: Tensor, final_index: Tensor, ray: Tensor,
                hit: Tensor, clipped: Tensor) -> RaySetup:
    """The walk's per-ray setup (cpu cpp:292-381): step signs, the time to
    leave the start voxel per axis and the time per voxel (0 where it is
    infinite, so ``t0 + k * dt`` keeps ``t0 = +inf`` on axes that never
    step), and the endpoint mark: filled unless range-clipped."""
    dev = p_start.device
    res = _f32(spec.resolution, dev)
    half = res * _f32(0.5, dev)
    inf = _f32(_INF, dev)
    step = torch.sign(final_index - start_index).to(torch.int32)
    start_center = spec.grid_index_to_location_in_grid_frame(start_index)
    bottom = start_center - half
    top = start_center + half
    t_pos = torch.abs((top - p_start) / ray)
    t_neg = torch.abs((p_start - bottom) / ray)
    t0 = torch.where(ray > 0.0, t_pos, torch.where(ray < 0.0, t_neg, inf))
    delta_t = torch.where(ray != 0.0, torch.abs(res / ray), inf)
    final_in = spec.check_grid_index_in_bounds(final_index)
    minus_one = constant(-1, torch.int32, dev)
    endpoint_flat = torch.where(
        hit & final_in, spec.flat_index(final_index).to(torch.int32),
        minus_one)
    dt_s = torch.where(torch.isfinite(delta_t), delta_t,
                       _f32(0.0, dev))
    return RaySetup(start=start_index.contiguous(),
                    final=final_index.contiguous(), step=step.contiguous(),
                    t0=t0.contiguous(), dt=dt_s.contiguous(),
                    hit=hit.contiguous(), end_flat=endpoint_flat.contiguous(),
                    end_filled=(~clipped).contiguous())


def _norm3_canonical(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis of ``[..., 3]`` with an
    order-canonical summation (ascending squares via a median-of-3
    select), so the result is bit-identical under any axis permutation;
    the sqrt is correctly rounded on every device."""
    sq = v * v
    a, b, c = sq[..., 0], sq[..., 1], sq[..., 2]
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = torch.maximum(torch.minimum(a, b),
                        torch.minimum(torch.maximum(a, b), c))
    return correctly_rounded_sqrt((lo + mid) + hi, torch.float32)


def _sum3(v: Tensor) -> Tensor:
    """Sum over the last axis of ``[..., 3]`` in index order."""
    return (v[..., 0] + v[..., 1]) + v[..., 2]


def _prepare_rays(spec: GridSpec, X_GC: Tensor, points: Tensor,
                  max_range: Tensor, slab_axis_order=(0, 1, 2)):
    """Per-ray setup: range clip + grid entry clip (cpp:216-290).

    ``slab_axis_order`` fixes the axis visit order of the entry slab test's
    prefix accumulation (its ``miss`` flag is order-sensitive for grazing
    rays); the column carve passes the inverse axis permutation so that the
    permuted-frame clip is bit-identical to the identity-frame one."""
    dev = points.device
    tiny = _f32(1e-30, dev)
    zero = _f32(0.0, dev)
    p_gco = X_GC[:3, 3]
    p_gp = transforms.apply_isometry(X_GC, points)
    finite = torch.all(torch.isfinite(points), dim=-1)

    ray = p_gp - p_gco
    ray_len = _norm3_canonical(ray)
    clipped = ray_len > max_range
    scale = torch.where(ray_len > 0,
                        max_range / torch.maximum(ray_len, tiny), zero)
    p_final = torch.where(clipped[:, None], p_gco + ray * scale[:, None],
                          p_gp)

    grid_sizes = _f32(tuple(spec.grid_sizes), dev)

    # Far-endpoint clamp (voxelize.py:263-286 of the JAX package): a huge
    # finite endpoint (a depth sensor's 1e9 / FLT_MAX sentinel with
    # max_range = inf) is moved onto the bounding sphere of grid + origin
    # plus two voxels, so the integer index math stays in range. ``ray``
    # itself is not clamped.
    corner = torch.maximum(torch.abs(p_gco), torch.abs(grid_sizes - p_gco))
    far_corner = correctly_rounded_sqrt(_sum3(corner * corner),
                                        torch.float32)
    l_safe = far_corner + _f32(2.0 * spec.resolution, dev)
    off = p_final - p_gco
    # Overflow-robust norm: normalize by the max-abs component first.
    m_abs = torch.amax(torch.abs(off), dim=-1)
    offn = off / torch.maximum(m_abs, tiny)[:, None]
    d_unit = correctly_rounded_sqrt(_sum3(offn * offn), torch.float32)
    too_far = m_abs * torch.minimum(d_unit, _f32(2.0, dev)) > l_safe
    clamped_final = (p_gco + offn
                     * (l_safe / torch.maximum(d_unit, tiny))[:, None])
    p_final = torch.where(too_far[:, None], clamped_final, p_final)
    origin_index = spec.location_in_grid_frame_to_grid_index(p_gco)
    origin_in = spec.check_grid_index_in_bounds(origin_index)

    # Slab test for rays starting outside the grid (cpp:234-290, Ericson
    # RTCD 5.3.3).
    direction = ray / torch.maximum(ray_len, tiny)[:, None]
    flat_thresh = _f32(1e-10, dev)
    one = _f32(1.0, dev)
    n = points.shape[0]
    tmin = torch.zeros(n, dtype=torch.float32, device=dev)
    tmax = tmin + max_range
    miss = torch.zeros(n, dtype=torch.bool, device=dev)
    for axis in slab_axis_order:
        d = direction[:, axis]
        nearly_flat = torch.abs(d) < flat_thresh
        in_slab = (p_gco[axis] >= 0.0) & (p_gco[axis] < grid_sizes[axis])
        ood = one / torch.where(nearly_flat, one, d)
        tlow = (zero - p_gco[axis]) * ood
        thigh = (grid_sizes[axis] - p_gco[axis]) * ood
        t1 = torch.minimum(tlow, thigh)
        t2 = torch.maximum(tlow, thigh)
        tmin_new = torch.where(nearly_flat, tmin, torch.maximum(tmin, t1))
        # The reference widens tmax (``if (t2 > tmax) tmax = t2``,
        # cpp:273-276), as written upstream; mirrored here.
        tmax_new = torch.where(nearly_flat, tmax, torch.maximum(tmax, t2))
        miss = miss | torch.where(nearly_flat, ~in_slab, tmin_new > tmax_new)
        tmin, tmax = tmin_new, tmax_new
    # The entry nudge scales with the voxel size (the reference's 1e-10
    # vanishes in float32).
    nudge = _f32(1e-3 * spec.resolution, dev)
    p_entry = p_gco + direction * (tmin + nudge)[:, None]
    p_start = torch.where(origin_in, p_gco[None, :], p_entry)
    hit = finite & (origin_in | ~miss)

    start_index = spec.location_in_grid_frame_to_grid_index(p_start)
    final_index = spec.location_in_grid_frame_to_grid_index(p_final)
    return p_start, start_index, p_final, final_index, ray, hit, clipped


def _balanced_chunk(n_rays: int, ray_chunk: int) -> int:
    """Chunk width that balances ``n_rays`` across the fewest chunks of at
    most ``ray_chunk`` rays, aligned to 256 (the JAX package's rule). The
    counts do not depend on the chunking."""
    n_rays = max(n_rays, 1)
    if n_rays <= ray_chunk:
        return n_rays
    n_chunks = -(-n_rays // ray_chunk)
    per = -(-n_rays // n_chunks)
    return min(-(-per // 256) * 256, ray_chunk)


_WALK_BACKENDS = ("auto", "plain", "cuda")


def _grids_out(spec: GridSpec, device,
               out: Optional[TrackingGrid]) -> TrackingGrid:
    """``out`` checked to be contiguous int32 grids of ``spec`` on
    ``device``, or fresh uninitialized ones for None."""
    if out is None:
        return TrackingGrid(*(torch.empty(spec.counts, dtype=torch.int32,
                                          device=device) for _ in range(2)))
    for g in out:
        if (g.shape != spec.counts or g.dtype != torch.int32
                or g.device != device or not g.is_contiguous()):
            raise ValueError(f"_out grids must be contiguous int32 "
                             f"{spec.counts} tensors on {device}")
    return out


def _step_budget(spec: GridSpec, max_steps: Optional[int]) -> int:
    """``max_steps`` (default ``nx + ny + nz + 2``) in whole segments."""
    if max_steps is None:
        max_steps = spec.num_x + spec.num_y + spec.num_z + 2
    return segment_steps(max_steps)


def raycast_pointcloud(spec: GridSpec, grid_origin_transform,
                       cloud: PointCloud,
                       max_steps: Optional[int] = None,
                       ray_chunk: int = 16384,
                       backend: str = "auto",
                       _out: Optional[TrackingGrid] = None) -> TrackingGrid:
    """Carve one cloud into a fresh tracking grid by the voxel walk
    (``DoRaycastPointCloud``, cpu cpp:167-206), on the cloud's device.

    ``max_steps`` (default ``nx + ny + nz + 2``) is the walk's step budget,
    rounded up to whole 64-step segments as in the JAX package.
    ``backend``: ``"cuda"`` launches the tiled carve kernel once over every
    ray (a CPU cloud raises), ``"plain"`` walks in PyTorch in ``ray_chunk``
    blocks, ``"auto"`` is the kernel for a CUDA cloud and the plain walk for
    a CPU one. All give the same bits. ``_out`` (internal): contiguous
    int32 grids to carve into, written in full and returned (the carve
    route passes each cloud's slice of one stacked pair)."""
    spec.enforce_uniform_voxel_size()
    if backend not in _WALK_BACKENDS:
        raise ValueError(f"Unknown carve backend {backend!r}")
    dev = cloud.points.device
    if backend == "cuda" and dev.type != "cuda":
        raise ValueError(f"backend='cuda' needs a cloud on a CUDA device, "
                         f"got one on {dev}")
    if backend != "plain":
        return _carve_cloud(spec, grid_origin_transform, cloud, max_steps,
                            ray_chunk, None, _out)
    out = _grids_out(spec, dev, _out)
    n_steps = _step_budget(spec, max_steps)
    n_rays = cloud.points.shape[0]
    free, filled = out.seen_free.view(-1), out.seen_filled.view(-1)
    with _span("fusion.ray_setup"):
        X_GC = _grid_frame_transform(grid_origin_transform, cloud)
    free.zero_()
    filled.zero_()
    # The plain walk goes in chunks so that its per-step temporaries stay
    # bounded.
    chunk = _balanced_chunk(n_rays, ray_chunk)
    for lo in range(0, n_rays, chunk):
        with _span("fusion.ray_setup"):
            setup = ray_setup_plain(spec, X_GC, cloud.points[lo:lo + chunk],
                                    cloud.max_range)
        with _span("fusion.carve"):
            carve.carve_plain(spec.counts, setup, n_steps, free, filled)
    return out


def _carve_cloud(spec: GridSpec, grid_origin_transform, cloud: PointCloud,
                 max_steps: Optional[int], ray_chunk: int,
                 run_axis: Union[None, int, str],
                 out: Optional[TrackingGrid] = None) -> TrackingGrid:
    """The carve route of every fusion path: one cloud into ``out`` (or
    fresh grids). A CUDA cloud takes the grid-frame transform (two product
    kernel launches), one setup kernel launch and one tiled carve kernel
    launch; a CPU cloud the column carve along ``run_axis``, or the plain
    walk where it is None. All give the same bits."""
    dev = cloud.points.device
    if dev.type != "cuda":
        if run_axis is None:
            return raycast_pointcloud(spec, grid_origin_transform, cloud,
                                      max_steps, ray_chunk=ray_chunk,
                                      backend="plain", _out=out)
        grid = raycast_pointcloud_columns(spec, grid_origin_transform, cloud,
                                          max_steps, ray_chunk=ray_chunk,
                                          run_axis=run_axis)
        if out is None:
            return grid
        for dst, src in zip(_grids_out(spec, dev, out), grid):
            dst.copy_(src)
        return out
    out = _grids_out(spec, dev, out)
    # The kernel takes every ray in one launch and writes both grids in
    # full.
    with _span("fusion.ray_setup"):
        setup = ray_setup(spec, grid_origin_transform, cloud)
    with _span("fusion.carve"):
        carve.carve_tiled(spec.counts, setup, _step_budget(spec, max_steps),
                          out.seen_free.view(-1), out.seen_filled.view(-1))
    return out


def ray_setup(spec: GridSpec, grid_origin_transform,
              cloud: PointCloud) -> RaySetup:
    """The carve kernel's per-ray inputs for every ray of ``cloud``, as
    :func:`raycast_pointcloud` makes them: on a CUDA cloud one launch of
    the setup kernel (``kernels/ray_setup.py``), on a CPU cloud
    :func:`ray_setup_plain`. Both give the same bits."""
    spec.enforce_uniform_voxel_size()
    X_GC = _grid_frame_transform(grid_origin_transform, cloud)
    if cloud.points.is_cuda:
        return setup_kernel.ray_setup(
            X_GC, cloud.points,
            cloud.max_range.to(cloud.points.device, torch.float32),
            spec.counts, spec.resolution, spec.grid_sizes)
    return ray_setup_plain(spec, X_GC, cloud.points, cloud.max_range)


def ray_setup_plain(spec: GridSpec, X_GC: Tensor, points: Tensor,
                    max_range: Tensor) -> RaySetup:
    """The setup in plain PyTorch, on any device: :func:`_prepare_rays`,
    then :func:`_ray_visits`. The setup kernel's plain version."""
    return _ray_visits(spec, *_prepare_rays(spec, X_GC, points, max_range))


# -- Column-marching carve ---------------------------------------------------


def _flag(mask: Tensor, when_true: bool, when_false: bool) -> Tensor:
    """``where(mask, when_true, when_false)`` for Python bools."""
    if when_true == when_false:
        return torch.full_like(mask, when_true)
    return mask if when_true else ~mask


class _Columns(NamedTuple):
    """Per-ray inputs of the column march (the permuted frame's axes)."""
    fx: Tensor
    fy: Tensor
    fz: Tensor
    sx: Tensor
    sy: Tensor
    sz: Tensor
    tx0: Tensor
    ty0: Tensor
    tz0: Tensor
    dtx_s: Tensor
    dty_s: Tensor
    dtz: Tensor
    dtz_s: Tensor


def _column_setup(spec: GridSpec, p_start: Tensor, start_idx: Tensor,
                  final_idx: Tensor, ray: Tensor, hit: Tensor):
    dev = p_start.device
    nx, ny, nz = spec.counts
    res = _f32(spec.resolution, dev)
    half = res * _f32(0.5, dev)
    inf = _f32(_INF, dev)
    zero = _f32(0.0, dev)
    step = torch.sign(final_idx - start_idx).to(torch.int32)
    start_center = spec.grid_index_to_location_in_grid_frame(start_idx)
    t_pos = torch.abs((start_center + half - p_start) / ray)
    t_neg = torch.abs((p_start - (start_center - half)) / ray)
    t0 = torch.where(ray > 0.0, t_pos, torch.where(ray < 0.0, t_neg, inf))
    delta = torch.where(ray != 0.0, torch.abs(res / ray), inf)

    def safe(d):
        return torch.where(torch.isfinite(d), d, zero)

    cx, cy, z0 = start_idx.unbind(-1)
    fx, fy, fz = final_idx.unbind(-1)
    sx, sy, sz = step.unbind(-1)
    tx0, ty0, tz0 = t0.unbind(-1)
    dtx, dty, dtz = delta.unbind(-1)
    cols = _Columns(fx, fy, fz, sx, sy, sz, tx0, ty0, tz0, safe(dtx),
                    safe(dty), dtz, safe(dtz))
    alive0 = hit & ~((cx == fx) & (cy == fy) & (z0 == fz))
    # The start voxel must be in bounds (callers clip the entry); guarded.
    alive0 = alive0 & (cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny) \
        & (z0 >= 0) & (z0 < nz)
    return cols, cx, cy, z0, alive0


def _column_step(spec: GridSpec, c: _Columns, cx, cy, z, kx, ky, kz,
                 run_beats_c1: bool, run_beats_c2: bool, c1_beats_c2: bool):
    """One column iteration's geometry, shared by both accumulators: the
    picked column axis, the z run in the current column (``n_eff`` steps to
    ``z_end``), whether the walk ends in it, and the next column."""
    nx, ny, nz = spec.counts
    dev = cx.device
    big = 2 * (nx + ny + nz)
    big_f = _f32(float(big), dev)
    zero = _f32(0.0, dev)
    tx = c.tx0 + kx.to(torch.float32) * c.dtx_s
    ty = c.ty0 + ky.to(torch.float32) * c.dty_s
    tz = c.tz0 + kz.to(torch.float32) * c.dtz_s
    # Column pick and run-vs-column ties: the reference's x >= y >= z
    # priority mapped through the axis permutation.
    pick_c1 = (tx <= ty) if c1_beats_c2 else (tx < ty)
    m = torch.where(pick_c1, tx, ty)
    run_tie_wins = _flag(pick_c1, run_beats_c1, run_beats_c2)
    at_final_col = (cx == c.fx) & (cy == c.fy)

    # z-steps demanded before the column changes: the first crossing index
    # j >= kz not consumed before the column step (its time < m, or == m
    # when the run axis outranks the picked column). The closed form lands
    # within one of the true j; the +/-1 sweeps pin it to the exact float
    # comparisons of the voxel walk.
    def consumed(jv):
        cj = c.tz0 + jv.to(torch.float32) * c.dtz_s
        return (cj < m) | (run_tie_wins & (cj == m))

    frac = (m - tz) / c.dtz
    frac = torch.where(torch.isfinite(frac), frac, big_f)
    ceil = torch.minimum(torch.maximum(
        torch.ceil(torch.maximum(frac, zero)), zero), big_f)
    j = kz + torch.where(tz < m, ceil, zero).to(torch.int32)
    for _ in range(2):
        j = torch.where((j > kz) & ~consumed(j - 1), j - 1, j)
    for _ in range(2):
        j = torch.where(consumed(j), j + 1, j)
    n_raw = torch.clamp(j - kz, 0, big)

    # z-steps until z == fz (none when the ray keeps its z layer), and to
    # the grid's z edge.
    zero_i = torch.zeros_like(z)
    n_to_fz = torch.where(c.sz != 0, torch.clamp((c.fz - z) * c.sz, min=0),
                          zero_i)
    n_edge = torch.where(c.sz > 0, (nz - 1) - z,
                         torch.where(c.sz < 0, z, zero_i + big))
    # Walk-terminating clamps in this column (voxelize.py:532-551 of the
    # JAX package); the grid-edge clamp outranks the final-z ones.
    end_fz = (n_raw > n_to_fz) & ~at_final_col & (n_to_fz <= n_edge)
    end_fz_final = (at_final_col & (n_raw >= n_to_fz)
                    & (n_to_fz - 1 <= n_edge))
    n_eff = torch.minimum(n_raw, n_edge)
    n_eff = torch.where(end_fz, n_to_fz, n_eff)
    n_eff = torch.where(end_fz_final, n_to_fz - 1, n_eff)
    end_oob_z = (~end_fz & ~end_fz_final) & (n_raw > n_edge)
    column_done = end_fz | end_fz_final | end_oob_z
    z_end = z + c.sz * n_eff

    # Column step, for lanes not terminated inside the column. Early break:
    # stepping an axis already at its final coordinate (cpp:405-434).
    pick_x = pick_c1
    break_b = torch.where(pick_x, cx == c.fx, cy == c.fy)
    ncx = torch.where(pick_x, cx + c.sx, cx)
    ncy = torch.where(pick_x, cy, cy + c.sy)
    oob_col = (ncx < 0) | (ncx >= nx) | (ncy < 0) | (ncy >= ny)
    step_ok = ~column_done & ~break_b & ~oob_col
    return (pick_x, n_eff, z_end, end_fz_final, n_to_fz, step_ok, ncx, ncy)


def _advance(alive_next, pick_x, ncx, ncy, z_end, n_eff, cx, cy, z, kx, ky,
             kz):
    ax, ay = alive_next & pick_x, alive_next & ~pick_x
    return (torch.where(ax, ncx, cx), torch.where(ay, ncy, cy),
            torch.where(alive_next, z_end, z), kx + ax.to(torch.int32),
            ky + ay.to(torch.int32),
            torch.where(alive_next, kz + n_eff, kz))


def _column_carve_chunk(spec: GridSpec, p_start: Tensor, start_idx: Tensor,
                        final_idx: Tensor, ray: Tensor, hit: Tensor,
                        free_rows: Tensor, m_max: int,
                        run_beats_c1: bool = False,
                        run_beats_c2: bool = False,
                        c1_beats_c2: bool = True,
                        voxel_budget: Optional[int] = None) -> None:
    """Column-marching walk: one iteration per visited (x, y) column, each
    adding the ray's contiguous z run there as one masked ``[nz]`` row into
    ``free_rows`` (``[nx * ny, nz]`` int32, in place). Same voxels as the
    voxel walk (the start voxel marked, the final one not, the same early
    breaks and grid exits). ``voxel_budget`` truncates each ray's run at the
    voxel where the walk's step budget would expire. Lanes that have died
    are dropped whenever fewer than half still walk."""
    nx, ny, nz = spec.counts
    dev = p_start.device
    c, cx, cy, z, alive = _column_setup(spec, p_start, start_idx, final_idx,
                                        ray, hit)
    kx = torch.zeros_like(cx)
    ky, kz = kx.clone(), kx.clone()
    used = kx.clone()
    zrange = torch.arange(nz, dtype=torch.int32, device=dev)[None, :]
    lanes = (c, cx, cy, z, kx, ky, kz, used, alive)
    for _ in range(m_max):
        n_alive = int(lanes[-1].sum())
        if n_alive == 0:
            break
        if n_alive * 2 <= lanes[-1].numel():
            live = lanes[-1].nonzero().squeeze(1)
            lanes = (_Columns(*(v[live] for v in lanes[0])),
                     *(v[live] for v in lanes[1:]))
        c, cx, cy, z, kx, ky, kz, used, alive = lanes
        (pick_x, n_eff, z_end, end_fz_final, n_to_fz, step_ok, ncx,
         ncy) = _column_step(spec, c, cx, cy, z, kx, ky, kz, run_beats_c1,
                             run_beats_c2, c1_beats_c2)
        # A final column whose only voxel is the final voxel marks nothing.
        emit = alive & ~(end_fz_final & (n_to_fz == 0))
        alive_next = alive & step_ok
        if voxel_budget is not None:
            # Each walk step marks one voxel; this run would mark n_eff + 1.
            r_full = torch.where(emit, n_eff + 1, torch.zeros_like(n_eff))
            allowed = torch.clamp(voxel_budget - used, min=0)
            trunc = r_full > allowed
            r_eff = torch.minimum(r_full, allowed)
            emit = emit & (r_eff > 0)
            z_end_mark = z + c.sz * torch.clamp(r_eff - 1, min=0)
            alive_next = alive_next & ~trunc
            used = used + r_eff
        else:
            z_end_mark = z_end
        rows = (cx * ny + cy)[emit]
        if rows.numel():
            zmin = torch.minimum(z, z_end_mark)[emit]
            zmax = torch.maximum(z, z_end_mark)[emit]
            mask = (zrange >= zmin[:, None]) & (zrange <= zmax[:, None])
            free_rows.index_add_(0, rows.long(), mask.to(torch.int32))
        cx, cy, z, kx, ky, kz = _advance(alive_next, pick_x, ncx, ncy, z_end,
                                         n_eff, cx, cy, z, kx, ky, kz)
        lanes = (c, cx, cy, z, kx, ky, kz, used, alive_next)


def _scatter_flat(grid_flat: Tensor, idx: Tensor, val: Tensor,
                  on: Tensor) -> None:
    """``grid_flat[idx] += val`` for the lanes in ``on`` (the rest are
    dropped, as the JAX package's ``mode="drop"`` sentinel rows are)."""
    if bool(on.any()):
        grid_flat.index_add_(0, idx[on].long(), val[on].to(grid_flat.dtype))


def _column_carve_chunk_diff(spec: GridSpec, p_start: Tensor,
                             start_idx: Tensor, final_idx: Tensor,
                             ray: Tensor, hit: Tensor, bucket_grid: Tensor,
                             m_max: int, run_beats_c1: bool = False,
                             run_beats_c2: bool = False,
                             c1_beats_c2: bool = True) -> None:
    """Diff twin of :func:`_column_carve_chunk`: one scalar element per
    visited column into ``bucket_grid`` (int32 ``[10, nx * ny, nz + 2]``:
    D, B0, four B+ and four B- buckets by xy step direction and z-march
    sign, in place), folded into counts by :func:`_combine_diff_buckets`.
    Each column's run is encoded by its entry element; entry and exit
    elements close each ray's first and last run (the JAX package's
    voxelize.py:617-803)."""
    nx, ny, nz = spec.counts
    sec = nx * ny * (nz + 2)
    c, cx, cy, z, alive = _column_setup(spec, p_start, start_idx, final_idx,
                                        ray, hit)
    sz = c.sz
    grid_flat = bucket_grid.view(-1)
    ones = torch.ones_like(cx)
    zero_i = torch.zeros_like(cx)

    def el_index(bucket, col_flat, zslot):
        return bucket * sec + col_flat * (nz + 2) + zslot

    # Entry element: opens the first run (sz > 0: +1 at its low z; sz < 0:
    # -1 above its high z; sz == 0: the self-contained B0 pair).
    entry_bucket = torch.where(sz == 0, ones, zero_i)
    entry_slot = torch.where(sz < 0, z + 1, z)
    entry_val = torch.where(sz < 0, -ones, ones)
    _scatter_flat(grid_flat, el_index(entry_bucket, cx * ny + cy, entry_slot),
                  entry_val, alive)

    kx = torch.zeros_like(cx)
    ky, kz = kx.clone(), kx.clone()
    exit_col, exit_z = zero_i.clone(), zero_i.clone()
    exit_on = torch.zeros_like(alive)
    for _ in range(m_max):
        if not bool(alive.any()):
            break
        (pick_x, n_eff, z_end, _, _, step_ok, ncx,
         ncy) = _column_step(spec, c, cx, cy, z, kx, ky, kz, run_beats_c1,
                             run_beats_c2, c1_beats_c2)
        alive_next = alive & step_ok
        dying = alive & ~step_ok
        # Element of the stepped-into column, by xy step direction (0..3 =
        # x+, x-, y+, y-) and z sign; sz < 0 elements live at slot z + 1.
        dcode = torch.where(pick_x, torch.where(c.sx > 0, 0, 1),
                            torch.where(c.sy > 0, 2, 3)).to(torch.int32)
        col_bucket = torch.where(sz == 0, ones,
                                 torch.where(sz > 0, 2 + dcode, 6 + dcode))
        el_slot = torch.where(sz < 0, z_end + 1, z_end)
        # An sz == 0 lane stepping into its final column dies unmarked next
        # iteration: its self-contained B0 element is suppressed.
        el_on = alive_next & ~((sz == 0) & (ncx == c.fx) & (ncy == c.fy))
        _scatter_flat(grid_flat, el_index(col_bucket, ncx * ny + ncy,
                                          el_slot), ones, el_on)
        # Exit element of dying lanes (sz != 0) closes the last run.
        exit_col = torch.where(dying, cx * ny + cy, exit_col)
        exit_z = torch.where(dying, z_end, exit_z)
        exit_on = exit_on | (dying & (sz != 0))
        cx, cy, z, kx, ky, kz = _advance(alive_next, pick_x, ncx, ncy, z_end,
                                         n_eff, cx, cy, z, kx, ky, kz)
        alive = alive_next
    # Lanes cut off by m_max close their last run where they stand.
    exit_col = torch.where(alive, cx * ny + cy, exit_col)
    exit_z = torch.where(alive, z, exit_z)
    exit_on = exit_on | (alive & (sz != 0))
    exit_slot = torch.where(sz < 0, exit_z, exit_z + 1)
    exit_val = torch.where(sz < 0, ones, -ones)
    _scatter_flat(grid_flat, el_index(zero_i, exit_col, exit_slot), exit_val,
                  exit_on)


def _combine_diff_buckets(spec: GridSpec, bucket_grid: Tensor) -> Tensor:
    """Fold the 10 diff buckets into per-voxel seen-free counts: nine dense
    shifted adds + one z cumsum, exact integer arithmetic."""
    nx, ny, nz = spec.counts
    g = bucket_grid.reshape(10, nx, ny, nz + 2)
    b0 = g[1]
    diff = g[0] + b0
    # B0: -1 one z above each element.
    diff[:, :, 1:] -= b0[:, :, :-1]

    def shift_xy(arr, dx, dy):
        """arr sampled at (x + dx, y + dy), zero outside."""
        out = torch.zeros_like(arr)
        sx = slice(max(dx, 0), nx + min(dx, 0))
        tx_ = slice(max(-dx, 0), nx + min(-dx, 0))
        sy = slice(max(dy, 0), ny + min(dy, 0))
        ty_ = slice(max(-dy, 0), ny + min(-dy, 0))
        out[tx_, ty_] = arr[sx, sy]
        return out

    for k, (dx, dy) in enumerate([(1, 0), (-1, 0), (0, 1), (0, -1)]):
        bp = g[2 + k]   # sz > 0: +1 at the element; -1 at (col - d, z + 1)
        diff += bp
        diff[:, :, 1:] -= shift_xy(bp, dx, dy)[:, :, :-1]
        bm = g[6 + k]   # sz < 0 (stored at slot z + 1)
        diff[:, :, :-1] += shift_xy(bm, dx, dy)[:, :, 1:]
        diff -= bm
    return torch.cumsum(diff, dim=2, dtype=torch.int32)[:, :, :nz]


# run_axis -> axis permutation that makes it the last (run) axis.
_AXIS_PERMS = {0: (1, 2, 0), 1: (2, 0, 1), 2: (0, 1, 2)}


def raycast_pointcloud_columns(spec: GridSpec, grid_origin_transform,
                               cloud: PointCloud,
                               max_steps: Optional[int] = None,
                               ray_chunk: int = 16384,
                               run_axis: Union[int, str] = 2,
                               accumulate: str = "rows") -> TrackingGrid:
    """Column-marching twin of :func:`raycast_pointcloud`, plain PyTorch on
    the cloud's device: the same tracking grid, bit for bit. ``run_axis``
    picks the grid axis of the contiguous runs (the camera bundle's
    dominant axis); ``"split"`` carves each ray along its own dominant axis
    (:func:`_raycast_columns_split`). ``accumulate``: ``"rows"`` (one
    masked ``[nz]`` row per column) or ``"diff"`` (one scalar element per
    column + bucket-shift combine; its accumulator is ``[10, nx * ny, nz +
    2]`` int32, 5 GiB at 512^3). ``max_steps`` is the walk's per-ray voxel
    budget (rounded up to whole 64-step segments); only ``"rows"`` takes
    it."""
    spec.enforce_uniform_voxel_size()
    if max_steps is not None and accumulate != "rows":
        raise ValueError(
            "max_steps is only supported with accumulate='rows' (the diff "
            "variant's endpoint algebra cannot truncate runs mid-column)")
    if isinstance(run_axis, str):
        if run_axis != "split":
            raise ValueError(f"Unknown run_axis {run_axis!r}")
        return _raycast_columns_split(spec, grid_origin_transform, cloud,
                                      max_steps, ray_chunk, accumulate)
    perm = _AXIS_PERMS[int(run_axis)]
    # Reference priority x >= y >= z mapped into the permuted frame: which
    # axis wins each pairwise tie is decided by the original axis id.
    c1_old, c2_old, run_old = perm
    tie_flags = dict(run_beats_c1=run_old < c1_old,
                     run_beats_c2=run_old < c2_old,
                     c1_beats_c2=c1_old < c2_old)
    if perm == (0, 1, 2):
        return _raycast_columns_impl(spec, grid_origin_transform, cloud,
                                     max_steps, ray_chunk, tie_flags,
                                     accumulate=accumulate)
    # Carve in a permuted grid frame where run_axis is last (the grid
    # transform's columns permuted: exact), then permute the counts back.
    pspec = GridSpec(tuple(spec.counts[a] for a in perm), spec.resolution)
    g = _as_f32(grid_origin_transform, cloud.points.device)
    porigin = g[:, list(perm) + [3]]
    inv = tuple(int(a) for a in np.argsort(perm))
    grid = _raycast_columns_impl(pspec, porigin, cloud, max_steps, ray_chunk,
                                 tie_flags, slab_axis_order=inv,
                                 accumulate=accumulate)
    return TrackingGrid(
        seen_free=grid.seen_free.permute(inv).contiguous(),
        seen_filled=grid.seen_filled.permute(inv).contiguous())


def _raycast_columns_split(spec: GridSpec, grid_origin_transform,
                           cloud: PointCloud, max_steps: Optional[int],
                           ray_chunk: int, accumulate: str) -> TrackingGrid:
    """Direction-independent column carve: each ray runs along its own
    dominant grid axis (``run_axis="split"``). Rays are grouped by ``argmax
    |dir|`` in the grid frame and each group is carved with its run axis;
    the integer sums equal the voxel walk. (The JAX package hands each call
    the whole cloud with the other groups' points set to +inf, which mark
    nothing; the port hands each call its group's points.)"""
    X_GC = _grid_frame_transform(grid_origin_transform, cloud)
    p_grid = transforms.apply_isometry(X_GC, cloud.points)
    d = p_grid - X_GC[:3, 3]
    finite = torch.all(torch.isfinite(cloud.points), dim=-1)
    axis_id = torch.argmax(torch.abs(torch.where(
        finite[:, None], d, _f32(0.0, d.device))), dim=-1)
    total = None
    for a in range(3):
        sel = finite & (axis_id == a)
        grid = raycast_pointcloud_columns(
            spec, grid_origin_transform,
            dataclasses.replace(cloud, points=cloud.points[sel]),
            max_steps=max_steps, ray_chunk=ray_chunk, run_axis=a,
            accumulate=accumulate)
        total = grid if total is None else TrackingGrid(
            seen_free=total.seen_free + grid.seen_free,
            seen_filled=total.seen_filled + grid.seen_filled)
    return total


def _raycast_columns_impl(spec: GridSpec, grid_origin_transform,
                          cloud: PointCloud, max_steps: Optional[int],
                          ray_chunk: int, tie_flags: dict,
                          slab_axis_order=(0, 1, 2),
                          accumulate: str = "rows") -> TrackingGrid:
    nx, ny, nz = spec.counts
    dev = cloud.points.device
    X_GC = _grid_frame_transform(grid_origin_transform, cloud)
    n_rays = cloud.points.shape[0]
    if n_rays == 0:
        return _zero_grid(spec, dev)
    if accumulate not in ("rows", "diff"):
        raise ValueError(f"Unknown accumulate mode {accumulate!r}")

    # m_max bounds column iterations (the xy footprint's diagonal); a user
    # max_steps is the walk's per-ray voxel budget, rounded up to whole
    # 64-step segments as the walk rounds it.
    m_max = nx + ny + 2
    voxel_budget = None if max_steps is None else segment_steps(max_steps)
    chunk = _balanced_chunk(n_rays, ray_chunk)

    # Sort rays by projected xy path length, so that each chunk's column
    # loop (which runs to the chunk's longest ray) matches its rays. The
    # counts do not depend on the order.
    points = cloud.points
    if n_rays > chunk:
        p_world = transforms.apply_isometry(X_GC, points)
        start_i = spec.location_in_grid_frame_to_grid_index(X_GC[:3, 3])
        final_i = spec.location_in_grid_frame_to_grid_index(p_world)
        m_est = (torch.abs(final_i[:, 0] - start_i[0])
                 + torch.abs(final_i[:, 1] - start_i[1]))
        m_est = torch.where(torch.all(torch.isfinite(points), dim=-1), m_est,
                            torch.zeros_like(m_est))
        points = points[torch.argsort(m_est, stable=True)]

    use_diff = accumulate == "diff"
    if use_diff:
        free_acc = torch.zeros((10, nx * ny, nz + 2), dtype=torch.int32,
                               device=dev)
    else:
        free_acc = torch.zeros((nx * ny, nz), dtype=torch.int32, device=dev)
    free_pt = torch.zeros(spec.num_total, dtype=torch.int32, device=dev)
    filled = torch.zeros_like(free_pt)
    minus_one = constant(-1, torch.int32, dev)
    for lo in range(0, n_rays, chunk):
        (p_start, start_idx, _, final_idx, ray, hit,
         clipped) = _prepare_rays(spec, X_GC, points[lo:lo + chunk],
                                  cloud.max_range,
                                  slab_axis_order=slab_axis_order)
        if use_diff:
            _column_carve_chunk_diff(spec, p_start, start_idx, final_idx,
                                     ray, hit, free_acc, m_max, **tie_flags)
        else:
            _column_carve_chunk(spec, p_start, start_idx, final_idx, ray,
                                hit, free_acc, m_max,
                                voxel_budget=voxel_budget, **tie_flags)
        final_in = spec.check_grid_index_in_bounds(final_idx)
        endpoint_flat = torch.where(
            hit & final_in, spec.flat_index(final_idx).to(torch.int32),
            minus_one)
        marked = endpoint_flat >= 0
        carve._add_ones(free_pt, endpoint_flat[marked & clipped])
        carve._add_ones(filled, endpoint_flat[marked & ~clipped])
    if use_diff:
        free_counts = _combine_diff_buckets(spec, free_acc).reshape(-1)
    else:
        free_counts = free_acc.reshape(-1)
    free_counts = free_counts + free_pt
    return TrackingGrid(seen_free=free_counts.reshape(spec.counts),
                        seen_filled=filled.reshape(spec.counts))


# -- Run-axis policies (host numpy, as in the JAX package) -------------------


def _policy_sample(pts: Tensor, k: int = 2048) -> np.ndarray:
    """A ``k``-point subsample taken on the device before it is copied to
    the host, by golden-ratio stepping (coprime with N, so that it resonates
    with no scanline width). Speed policy only."""
    n_pts = pts.shape[0]
    if n_pts > k:
        step = max(1, int(round(n_pts * 0.6180339887498949)))
        while np.gcd(step, n_pts) != 1:
            step += 1
        idx = (np.arange(k, dtype=np.int64) * step) % n_pts
        pts = pts[torch.as_tensor(idx, device=pts.device)]
    return pts.detach().cpu().numpy()


def _policy_dirs(cloud: PointCloud, grid_origin_transform):
    pts = _policy_sample(cloud.points)
    finite = np.all(np.isfinite(pts), axis=-1)
    if not finite.any():
        return None
    X_GC = cloud.origin_transform.detach().cpu().numpy().astype(np.float64)
    if grid_origin_transform is not None:
        g = grid_origin_transform
        if isinstance(g, Tensor):
            g = g.detach().cpu().numpy()
        X_GC = np.linalg.inv(np.asarray(g, np.float64)) @ X_GC
    return pts[finite] @ X_GC[:3, :3].T


def dominant_ray_axis(cloud: PointCloud,
                      grid_origin_transform=None) -> int:
    """Best ``run_axis`` for :func:`raycast_pointcloud_columns`: the grid
    axis most aligned with the cloud's mean ray direction."""
    dirs = _policy_dirs(cloud, grid_origin_transform)
    if dirs is None:
        return 2
    return int(np.argmax(np.abs(dirs.mean(axis=0))))


def pick_run_axis(cloud: PointCloud, grid_origin_transform=None,
                  split_threshold: float = 0.75) -> Union[int, str]:
    """``run_axis`` policy: the dominant grid axis when at least
    ``split_threshold`` of the (sampled) rays share it, else ``"split"``.
    A speed policy only: every choice gives the walk's bits."""
    dirs = _policy_dirs(cloud, grid_origin_transform)
    if dirs is None:
        return 2
    per_ray = np.argmax(np.abs(dirs), axis=-1)
    counts = np.bincount(per_ray, minlength=3)
    top = int(counts.argmax())
    if counts[top] >= split_threshold * counts.sum():
        return top
    return "split"


def raycast_single_point(spec: GridSpec, grid_origin_transform,
                         p_world_origin, p_world_point,
                         max_range: float = _INF,
                         max_steps: Optional[int] = None,
                         device=None) -> TrackingGrid:
    """``CpuPointCloudVoxelizer::RaycastSinglePoint`` (cpu cpp:81-109): carve
    one origin->point ray given in the grid frame (pass an identity grid
    transform for that), on ``device`` (None: the CUDA card)."""
    device = default_device(device, like=p_world_origin)
    origin = torch.as_tensor(p_world_origin, dtype=torch.float32,
                             device=device)[:3]
    point = torch.as_tensor(p_world_point, dtype=torch.float32,
                            device=device)[:3]
    cloud = PointCloud.create(
        (point - origin).reshape(1, 3),
        origin_transform=transforms.isometry_from_translation(origin),
        max_range=max_range)
    return raycast_pointcloud(spec, grid_origin_transform, cloud, max_steps)


# -- Fusion filter -----------------------------------------------------------


def combine_and_filter(options: FilterOptions, seen_free: Tensor,
                       seen_filled: Tensor, occupancy: Tensor) -> Tensor:
    """Fuse stacked per-camera counters ``[C, nx, ny, nz]`` into occupancy
    (``DoCombineAndFilterGrids``, cpu cpp:438-497). Filled static cells are
    left untouched; others become filled if any camera saw a hit, free if
    enough cameras saw through, else unknown. On CUDA tensors one launch of
    the fusion filter kernel, on CPU tensors its plain PyTorch version
    (``kernels/fusion_filter.py``: int32 counters and a float32 occupancy
    on one device)."""
    with _span("fusion.filter"):
        return fusion_filter.combine_and_filter_fused(
            options, seen_free, seen_filled, occupancy)


def _carve_and_filter(
        spec: GridSpec, grid_origin_transform,
        pointclouds: Sequence[PointCloud], filter_options: FilterOptions,
        occupancy: Tensor, max_steps: Optional[int] = None,
        ray_chunk: int = 16384,
        run_axes: Optional[Sequence[Union[None, int, str]]] = None,
        runtime_log_fn: Optional[Callable[[VoxelizerRuntime], None]] = None
) -> Tensor:
    """The fusion step of every mapping path, under one ``vgt.fusion``
    span: each cloud carved by :func:`_carve_cloud` (along ``run_axes[i]``
    on the CPU; None: the walk) into its slice of :func:`stacked_grids`,
    then :func:`combine_and_filter` over ``occupancy``. A
    ``runtime_log_fn`` gets the phases' wall times as a
    ``VoxelizerRuntime``, the device synchronized after each; without one,
    nothing waits for the device."""
    dev = occupancy.device
    if run_axes is None:
        run_axes = (None,) * len(pointclouds)
    timed = runtime_log_fn is not None
    with _span("fusion"):
        t0 = time.monotonic()
        seen_free, seen_filled = stacked_grids(spec, len(pointclouds), dev)
        for i, (cloud, axis) in enumerate(zip(pointclouds, run_axes)):
            _carve_cloud(spec, grid_origin_transform, cloud, max_steps,
                         ray_chunk, axis,
                         TrackingGrid(seen_free[i], seen_filled[i]))
        if timed:
            _sync(dev)
        t1 = time.monotonic()
        fused = combine_and_filter(filter_options, seen_free, seen_filled,
                                   occupancy)
        if timed:
            _sync(dev)
            runtime_log_fn(VoxelizerRuntime(t1 - t0, time.monotonic() - t1))
    return fused


def voxelize_pointclouds(
        static_environment: OccupancyMap,
        filter_options: FilterOptions,
        pointclouds: Sequence[PointCloud],
        runtime_log_fn: Optional[Callable[[VoxelizerRuntime], None]] = None,
        max_steps: Optional[int] = None) -> OccupancyMap:
    """End-to-end ``VoxelizePointClouds`` (pointcloud_voxelization_interface.
    hpp:246-292): every cloud carved (the tiled carve kernel for clouds on
    a CUDA device), then fused, by :func:`_carve_and_filter`, which times
    the phases for a ``runtime_log_fn``."""
    filter_options.validate()
    dev = static_environment.occupancy.device
    for cloud in pointclouds:
        if cloud.points.device != dev:
            raise ValueError(f"a cloud lies on {cloud.points.device}, "
                             f"the static environment on {dev}")
    occupancy = _carve_and_filter(
        static_environment.spec, static_environment.origin_transform,
        pointclouds, filter_options, static_environment.occupancy, max_steps,
        runtime_log_fn=runtime_log_fn)
    return static_environment.replace(occupancy=occupancy)
