"""Differentiable SDF sphere tracing (depth rendering).

Port of ``voxelized_geometry_tools_tpu/ops/render.py``: a pinhole camera,
world-frame rays, slab clipping to the grid box, and the march schedules
over the trilinear SDF samples of :mod:`.sdf_query`:

* the fixed-step march (``early_exit=False``): ``num_steps`` iterations of
  a Python loop; converged rays keep ``dt = 0``, so extra iterations change
  neither value nor gradient. Differentiable in ``sdf.distances`` and
  ``camera.pose`` through autograd over plain tensor ops, also when it
  starts at the cone prepass's certified depths (those are detached).
* the early-exit schedule (``early_exit=True``): a full-width head, then
  the still-alive rays sorted by estimated remaining steps and marched in
  ``tail_chunks`` chunks; with ``render_depth(coarse_factor=...)`` a cone
  prepass certifies per-block start depths and escape certificates, the
  tail sorts whole cone blocks, and the final sample gathers only where its
  value is not already known. Inference only, as in the JAX package.

Each ``lax.while_loop`` of the JAX package is a Python loop here whose
``any(alive)`` test is a host sync every iteration. On a CUDA card the
eager march is bound by the host's kernel launches, so the sync costs less
than the full-width iterations a sparser test would run past the last live
ray. Sorts are stable, so chunk membership (and with it the iteration
counters) follows the JAX package's order.

Either table type (:class:`..ops.sdf_query.CornerTable` or
``CornerPairTable``) serves every schedule, and ``remat=True``
rematerializes each fixed-march step in the backward pass
(``torch.utils.checkpoint``). The early-exit march also takes the
:class:`SdfMip` empty-space skip and over-relaxation (``relax > 1``);
:func:`render_depth_batch` marches several views of one camera rig in one
block-sorted tail. Rays that miss return ``hit=False`` with depth
``max_depth``. :func:`render_occupancy_image` and
:func:`depth_to_pointcloud` turn a render into a soft silhouette and back
into a sensor cloud.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core import transforms
from ..core.constants import constant
from ..core.device import default_device
from ..core.maps import SignedDistanceField
from . import sdf_query
from .edt import _sqrt
from .voxelize import PointCloud

Tensor = torch.Tensor

# Sort key of dead rays: after every live one.
_DEAD_KEY = 3e30
_BIG = 1e30


@dataclasses.dataclass(frozen=True)
class PinholeCamera:
    """Pinhole camera: intrinsics + world-from-camera pose. The optical
    convention is +z forward, +x right, +y down (standard depth camera)."""
    pose: Tensor  # [4, 4] X_WC
    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    width: int
    height: int

    @staticmethod
    def create(pose, width: int, height: int,
               focal: Optional[float] = None, fx=None, fy=None,
               cx=None, cy=None, device=None) -> "PinholeCamera":
        if focal is not None:
            fx = fy = focal
        if fx is None or fy is None:
            raise ValueError(
                "PinholeCamera.create needs focal= (sets both) or fx= and "
                "fy= explicitly")
        if cx is None:
            cx = (width - 1) / 2.0
        if cy is None:
            cy = (height - 1) / 2.0
        # None: a tensor pose keeps its device, a host pose goes to the card.
        device = default_device(device, like=pose)
        if isinstance(pose, torch.Tensor):
            pose = pose.to(dtype=torch.float32, device=device)
        else:
            pose = torch.tensor(np.asarray(pose), dtype=torch.float32,
                                device=device)

        def scalar(v):
            return torch.as_tensor(v, dtype=torch.float32,
                                   device=pose.device)

        return PinholeCamera(pose=pose, fx=scalar(fx), fy=scalar(fy),
                             cx=scalar(cx), cy=scalar(cy),
                             width=int(width), height=int(height))

    @staticmethod
    def stack(cameras) -> "PinholeCamera":
        """One camera of a rig of views with the same image size: each
        tensor gains a leading view axis (``pose [B, 4, 4]``, ``fx [B]``),
        the form :func:`render_depth_batch` takes."""
        cameras = list(cameras)
        if len({(c.width, c.height) for c in cameras}) != 1:
            raise ValueError("stacked cameras must share one image size")
        return PinholeCamera(
            *(torch.stack([getattr(c, k) for c in cameras])
              for k in ("pose", "fx", "fy", "cx", "cy")),
            width=cameras[0].width, height=cameras[0].height)

    def view(self, i: int) -> "PinholeCamera":
        """View ``i`` of a stacked camera."""
        return PinholeCamera(self.pose[i], self.fx[i], self.fy[i],
                             self.cx[i], self.cy[i], self.width, self.height)


class RenderResult(NamedTuple):
    depth: Tensor     # [H, W] ray depth (t along the unit ray direction)
    hit: Tensor       # [H, W] bool, surface hit within max_depth
    points: Tensor    # [H, W, 3] final world-space sample positions
    distance: Tensor  # [H, W] final SDF sample value


class SdfMip(NamedTuple):
    """Coarse lower-bound grid for empty-space skipping: ``values[b]``
    lower-bounds the corrected distance anywhere in coarse block ``b``
    (min-pool minus ``(sqrt(3)/2 + 1/2)`` voxels; the field is
    1-Lipschitz), so one gather from it is a safe step."""
    values: Tensor       # f32 [ncx * ncy * ncz] flattened coarse blocks
    coarse_counts: Tuple[int, int, int]
    factor: int
    block_size: float    # factor * resolution (meters)


def build_sdf_mip(sdf: SignedDistanceField, factor: int = 8) -> SdfMip:
    """Min-pool the float32 distances into ``factor^3`` blocks (the grid
    padded with ``+inf`` to a multiple) and subtract the half-cell
    diagonal plus the half voxel of the corrected-center rule."""
    nx, ny, nz = sdf.spec.counts
    f = int(factor)
    d = sdf.distances.to(torch.float32)
    pad = ((-nz) % f, (-ny) % f, (-nx) % f)
    if any(pad):
        d = torch.nn.functional.pad(d, (0, pad[0], 0, pad[1], 0, pad[2]),
                                    value=float("inf"))
    cx, cy, cz = d.shape[0] // f, d.shape[1] // f, d.shape[2] // f
    pooled = torch.amin(d.reshape(cx, f, cy, f, cz, f), dim=(1, 3, 5))
    margin = _f32((0.5 * float(np.sqrt(3.0)) + 0.5) * sdf.spec.resolution,
                  d.device)
    return SdfMip(values=(pooled - margin).reshape(-1),
                  coarse_counts=(cx, cy, cz), factor=f,
                  block_size=f * sdf.spec.resolution)


def _f32(x, device) -> Tensor:
    return constant(x, torch.float32, device)


def _counter(iters) -> Tensor:
    """An iteration count (or a list of them) as an int32 CPU tensor, the
    form of the JAX package's counters."""
    return torch.tensor(iters, dtype=torch.int32)


def _norm3(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis of ``[..., 3]``, elementwise."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    return torch.sqrt(x * x + y * y + z * z)


def _unit_dirs(camera: PinholeCamera, u: Tensor, v: Tensor) -> Tensor:
    """World directions of the pixels at columns ``u`` and rows ``v``,
    normalized as the JAX package normalizes them op by op: the squares
    summed in axis order, a correctly rounded sqrt, a divide."""
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    d = torch.stack([(uu - camera.cx) / camera.fx,
                     (vv - camera.cy) / camera.fy,
                     torch.ones_like(uu)], dim=-1)
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    d = d / _sqrt(x * x + y * y + z * z, d.dtype)[..., None]
    return transforms.rotate_vector(camera.pose, d)


def camera_rays(camera: PinholeCamera) -> Tuple[Tensor, Tensor]:
    """World-frame ray origins ``[H,W,3]`` and unit directions ``[H,W,3]``."""
    dev = camera.pose.device
    dirs_world = _unit_dirs(
        camera, torch.arange(camera.width, dtype=torch.float32, device=dev),
        torch.arange(camera.height, dtype=torch.float32, device=dev))
    origins = camera.pose[:3, 3].expand(dirs_world.shape)
    return origins, dirs_world


def _clip_to_grid(sdf: SignedDistanceField, origins: Tensor,
                  dirs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Slab-clip rays to the grid box in grid frame:
    ``(t_enter, t_exit, hits_grid)``."""
    inv = sdf.inverse_origin_transform()
    o_grid = transforms.apply_isometry(inv, origins)
    d_grid = transforms.rotate_vector(inv, dirs)
    sizes = constant(tuple(sdf.spec.grid_sizes), torch.float32,
                     origins.device)
    tiny = _f32(1e-12, origins.device)
    safe_d = torch.where(d_grid.abs() < tiny,
                         torch.where(d_grid < 0, -tiny, tiny), d_grid)
    t_low = (0.0 - o_grid) / safe_d
    t_high = (sizes - o_grid) / safe_d
    t1 = torch.minimum(t_low, t_high)
    t2 = torch.maximum(t_low, t_high)
    t_enter = torch.amax(t1, dim=-1)
    t_exit = torch.amin(t2, dim=-1)
    zero = torch.zeros((), dtype=torch.float32, device=origins.device)
    hits = t_exit > torch.maximum(t_enter, zero)
    return torch.maximum(t_enter, zero), t_exit, hits


def _pad_rows(x: Tensor, pad: int, fill) -> Tensor:
    """``x`` with ``pad`` rows of ``fill`` appended on axis 0."""
    if not pad:
        return x
    return torch.cat([x, x.new_full((pad,) + tuple(x.shape[1:]), fill)])


def _unsort(xs: Tensor, order: Tensor, unit: int, n: int) -> Tensor:
    """Inverse of ``x.reshape(-1, unit)[order].reshape(-1)``, cut to ``n``
    rows: whole ``unit``-row blocks go back to their original places."""
    rows = xs.reshape((order.numel(), unit) + tuple(xs.shape[1:]))
    out = torch.empty_like(rows)
    out[order] = rows
    return out.reshape((-1,) + tuple(xs.shape[1:]))[:n]


def sphere_trace(sdf: SignedDistanceField, origins: Tensor, dirs: Tensor,
                 num_steps: int = 64,
                 surface_threshold: Optional[float] = None,
                 max_depth: float = 100.0,
                 step_scale: float = 1.0,
                 corner_table: Optional[sdf_query.Table] = None,
                 early_exit: bool = False,
                 mip=None,
                 coarse_steps: int = 64,
                 head_steps: int = 8,
                 tail_chunks: int = 8,
                 t_init: Optional[Tensor] = None,
                 t_init_valid_from: Optional[Tensor] = None,
                 sort_key: Optional[Tensor] = None,
                 certified_miss: Optional[Tensor] = None,
                 sort_block: int = 1,
                 relax: float = 1.0,
                 remat: bool = False,
                 with_stats: bool = False):
    """Sphere-trace rays (``[..., 3]`` world-frame origins and directions)
    through an SDF grid.

    The march advances each ray by its sampled distance until the sample
    falls below ``surface_threshold`` (default a quarter voxel), the ray
    leaves the grid, or ``num_steps`` is spent. The options are the JAX
    package's (see its ``sphere_trace``):

    * ``corner_table``: each sample is one row gather (a ``CornerTable``)
      or four (a ``CornerPairTable``).
    * ``early_exit``: stop once no ray is alive. After ``head_steps``
      full-width steps, the live rays are sorted (stable) by estimated
      remaining steps (the decay of their last two samples, or ``-sort_key``
      with no head) and the rest of the budget runs in ``tail_chunks``
      chunks, each stopping on its own. ``sort_block`` sorts and moves
      whole runs of that many consecutive rays (1 when it does not divide
      the ray count) and then takes the sparse final sample: converged rays
      reuse their last march sample, rays outside the grid read
      ``(inf, False)`` from the validity test alone, and only the rest are
      sampled, needy blocks first, in the chunks that hold one.
    * ``t_init`` / ``t_init_valid_from``: certified start depths, used for
      rays that enter the grid at or after ``t_init_valid_from``.
    * ``certified_miss`` (early exit with ``t_init``): rays proven to meet
      no surface on ``[t_init_valid_from, t_init]``; those whose in-grid
      span lies inside it are not marched (they keep the final sample).
    * ``with_stats``: also return the JAX package's work counters (see
      :func:`gather_rows_from_stats`): iteration counts as int32 CPU
      tensors, static widths as ints.

    * ``mip`` (an :class:`SdfMip`): before the march, every ray in the
      grid jumps ahead by its block's lower bound, less the convergence
      band, while that jump exceeds one block, for at most
      ``coarse_steps`` jumps (one host sync each).
    * ``relax > 1`` (early exit only): over-relaxed sphere tracing. Rays
      whose sample decays at less than half the last advance step
      ``relax`` times their sample; a relaxed step whose next sample
      shows that the two step spheres do not overlap is reverted to the
      classic step (an out-of-grid sample tests as 0 for that). Each
      march phase (head, every tail chunk) starts with no step taken.
    * ``remat`` (fixed march): each step is rematerialized in the backward
      pass instead of keeping its gather indices and weights
      (``torch.utils.checkpoint``, non-reentrant); values and gradients
      are the same bits. The early-exit schedule ignores it, as the JAX
      package's does."""
    if surface_threshold is None:
        surface_threshold = 0.25 * sdf.resolution
    relax = float(relax)
    if relax < 1.0:
        raise ValueError(f"relax={relax} must be >= 1.0 "
                         "(use step_scale for under-relaxation)")
    if relax > 1.0 and not early_exit:
        raise ValueError("relax > 1 requires early_exit=True (the revert "
                         "logic lives in the early-exit march; the "
                         "differentiable fixed march stays classic)")

    dev = origins.device
    thresh = _f32(surface_threshold, dev)
    eps = _f32(1e-3 * sdf.resolution, dev)
    max_d = _f32(max_depth, dev)

    if corner_table is not None:
        def sample(pos):
            return sdf_query.estimate_location_distance_fast(
                sdf, corner_table, pos)

        def sample_valid(pos):
            return sdf_query.location_query_valid(sdf, pos,
                                                  corner_table.rows.dtype)
        value_dtype = corner_table.rows.dtype
    else:
        def sample(pos):
            return sdf_query.estimate_location_distance(sdf, pos)

        def sample_valid(pos):
            return sdf_query.location_query_valid(sdf, pos)
        value_dtype = sdf.distances.dtype

    t_enter, t_exit, hits_grid = _clip_to_grid(sdf, origins, dirs)
    t0 = torch.where(hits_grid, t_enter + eps, max_d)
    t_stop = torch.minimum(t_exit, max_d)
    batch_shape = tuple(t0.shape)
    n_rays = int(np.prod(batch_shape)) if batch_shape else 1
    valid_from = None if t_init_valid_from is None else torch.as_tensor(
        t_init_valid_from, dtype=torch.float32, device=dev)
    killed = None
    if t_init is not None:
        t_init = torch.as_tensor(t_init, dtype=torch.float32, device=dev)
        if certified_miss is not None and early_exit:
            killed = torch.as_tensor(certified_miss, device=dev).bool() \
                & (t_stop <= t_init)
            if valid_from is not None:
                killed = killed & (t_enter >= valid_from)
        ti = torch.minimum(t_init, t_stop)
        if valid_from is not None:
            ti = torch.where(t_enter >= valid_from, ti, t0)
        t0 = torch.maximum(t0, ti)

    if mip is not None:
        t0 = _mip_skip(sdf, mip, origins, dirs, t0, t_stop, hits_grid,
                       thresh, coarse_steps)

    def advance_ray(t, alive, o, d_ray, stop):
        q = sample(o + d_ray * t[..., None])
        d = torch.where(q.valid, q.value, thresh)  # nudge forward if outside
        converged = q.valid & (d <= thresh)
        advance = torch.maximum(d * step_scale, eps)
        new_t = torch.where(alive & ~converged, t + advance, t)
        return new_t, alive & ~converged & (new_t < stop), d, converged

    relax_f = _f32(relax, dev)
    half = _f32(0.5, dev)
    zero = _f32(0.0, dev)

    def advance_relaxed(t, alive, o, d_ray, stop, d_cur, last_adv,
                        was_relaxed):
        """One over-relaxed step: ``(new_t, new_alive, d, converged,
        overshoot, new_adv, new_relaxed)``."""
        q = sample(o + d_ray * t[..., None])
        # An out-of-grid sample proves nothing about the skipped segment:
        # it tests as 0 (revert), not as the nudge value.
        d_test = torch.where(q.valid, q.value, zero)
        overshoot = alive & was_relaxed & (last_adv > d_cur + d_test)
        d = torch.where(q.valid, q.value, thresh)
        converged = q.valid & (d <= thresh) & ~overshoot
        classic = torch.maximum(d * step_scale, eps)
        classic_prev = torch.maximum(d_cur * step_scale, eps)
        # Only tangential rays (sample decaying at less than half the
        # march rate) take relaxed steps.
        tangential = (d_cur - d) < half * last_adv
        adv = torch.where(tangential,
                          torch.maximum(d * step_scale * relax_f, eps),
                          classic)
        new_t = torch.where(
            overshoot, t - last_adv + classic_prev,
            torch.where(alive & ~converged, t + adv, t))
        new_adv = torch.where(overshoot, classic_prev, adv)
        # Exit on the classic step's guarantee: a relaxed step past
        # ``stop`` proved nothing, and its out-of-grid sample reverts it.
        escaped = ~overshoot & (t + classic >= stop)
        new_alive = alive & ~converged & ~escaped
        return (new_t, new_alive, d, converged, overshoot, new_adv,
                tangential & ~overshoot)

    def march_while(t, alive, o, d_ray, stop, budget, d_cur=None,
                    conv=None):
        """Up to ``budget`` iterations while any ray is alive. Also carries
        each ray's last two samples (``d_prev``, ``d_cur``) and whether it
        converged, and counts the iterations that had a live ray. With
        ``relax > 1`` each call starts with no step taken."""
        d_prev = torch.full_like(t, _BIG)
        if d_cur is None:
            d_cur = d_prev
        if conv is None:
            conv = torch.zeros_like(alive)
        if relax > 1.0:
            last_adv = torch.zeros_like(t)
            was_relaxed = torch.zeros_like(alive)
        iters = 0
        for _ in range(budget):
            if not bool(alive.any()):
                break
            iters += 1
            if relax > 1.0:
                (new_t, new_alive, d, converged, overshoot, last_adv,
                 was_relaxed) = advance_relaxed(t, alive, o, d_ray, stop,
                                                d_cur, last_adv, was_relaxed)
                kept = alive & ~overshoot
            else:
                new_t, new_alive, d, converged = advance_ray(
                    t, alive, o, d_ray, stop)
                kept = alive
            d_prev = torch.where(kept, d_cur, d_prev)
            d_cur = torch.where(kept, d, d_cur)
            conv = conv | (alive & converged)
            t, alive = new_t, new_alive
        return t, alive, d_prev, d_cur, conv, iters

    alive0 = hits_grid if mip is None else hits_grid & (t0 < t_stop)
    if killed is not None:
        alive0 = alive0 & ~killed
    stats = {}
    sparse = None  # (carried last samples, converged, sort block, chunks)
    if early_exit:
        head = min(int(head_steps), num_steps) if tail_chunks > 1 \
            else num_steps
        if head > 0:
            t_final, alive, d_prev, d_cur, conv, head_iters = march_while(
                t0, alive0, origins, dirs, t_stop, head)
        else:
            # No full-width fine steps: the caller's sort_key orders the
            # tail.
            t_final, alive = t0, alive0
            d_prev = d_cur = None
            conv = torch.zeros_like(alive0)
            head_iters = 0
        stats["fine_head_iters"] = _counter(head_iters)
        remaining = num_steps - head
        if remaining > 0 and tail_chunks > 1:
            t_final, sparse = _sorted_tail(
                march_while, batch_shape, t_final, alive, d_prev, d_cur,
                conv, origins, dirs, t_stop, sort_key, eps, remaining,
                int(tail_chunks), sort_block, stats)
    else:
        def step(t, alive):
            return advance_ray(t, alive, origins, dirs, t_stop)[:2]

        t_final, alive = t0, alive0
        for _ in range(num_steps):
            if remat:
                t_final, alive = checkpoint(step, t_final, alive,
                                            use_reentrant=False)
            else:
                t_final, alive = step(t_final, alive)
        stats["fine_head_iters"] = _counter(num_steps)
    stats["fine_head_width"] = n_rays

    points = origins + dirs * t_final[..., None]
    inf = constant(float("inf"), value_dtype, dev)
    if sparse is not None:
        d_carried, conv, bs, k = sparse
        valid = sample_valid(points)
        final_d = _sparse_final_sample(
            sample, points, valid, d_carried, conv, bs, k, inf,
            stats).reshape(batch_shape)
    else:
        q = sample(points)
        valid = q.valid
        final_d = torch.where(valid, q.value, inf)
        stats["final_sample_rows"] = n_rays
    hit = hits_grid & valid & (final_d <= thresh * 2.0)
    # Newton-style refinement: pull the depth to the zero crossing along the
    # ray with the final sample; keeps depth differentiable in the voxel
    # values even where the march converged early.
    refined_t = t_final + torch.where(hit, final_d,
                                      torch.zeros_like(final_d))
    depth = torch.where(hit, refined_t, max_d)
    result = RenderResult(depth=depth, hit=hit, points=points,
                          distance=final_d)
    return (result, stats) if with_stats else result


def _mip_skip(sdf: SignedDistanceField, mip: SdfMip, origins: Tensor,
              dirs: Tensor, t0: Tensor, t_stop: Tensor, hits_grid: Tensor,
              thresh: Tensor, coarse_steps: int) -> Tensor:
    """Empty-space skip over ``mip``: each ray in the grid advances by its
    coarse block's lower bound less the convergence band (``thresh`` plus
    half a cell diagonal, which the bound does not cover) while that
    advance exceeds one block, up to ``coarse_steps`` rounds."""
    inv = sdf.inverse_origin_transform()
    ncx, ncy, ncz = mip.coarse_counts
    dev = origins.device
    block = _f32(mip.block_size, dev)
    band = thresh + _f32(0.5 * float(np.sqrt(3.0)) * sdf.resolution, dev)
    hi = constant((ncx - 1, ncy - 1, ncz - 1), torch.int32, dev)
    t, skipping = t0, hits_grid
    for _ in range(int(coarse_steps)):
        if not bool(skipping.any()):
            break
        p_grid = transforms.apply_isometry(inv, origins + dirs * t[..., None])
        ci = torch.minimum(torch.clamp(
            torch.floor(p_grid / block).to(torch.int32), min=0), hi)
        flat = ci[..., 0] * (ncy * ncz) + ci[..., 1] * ncz + ci[..., 2]
        bound = mip.values.index_select(0, flat.reshape(-1)).reshape(
            flat.shape)
        advance = bound - band
        can_skip = advance > block
        new_t = torch.where(skipping & can_skip, t + advance, t)
        skipping = skipping & can_skip & (new_t < t_stop)
        t = new_t
    return t


def _sorted_tail(march_while, batch_shape, t_final, alive, d_prev, d_cur,
                 conv, origins, dirs, t_stop, sort_key, eps, remaining, k,
                 sort_block, stats):
    """The early-exit tail: still-alive rays sorted (stable) by estimated
    remaining steps, in whole ``sort_block`` units, and marched for
    ``remaining`` steps in ``k`` chunks, each stopping on its own.

    Returns ``(t_final, sparse)``: the final depths in ``batch_shape``, and
    for block sorts (``sparse`` not None) the merged last sample, the
    converged mask, the block size and ``k``, which the sparse final sample
    needs."""
    n = int(np.prod(batch_shape)) if batch_shape else 1
    bs = int(sort_block) if sort_block and n % sort_block == 0 else 1
    # Pad in whole sort blocks so block units stay intact.
    nb = n // bs
    pad_b = (-nb) % k
    pad = pad_b * bs
    chunk = (n + pad) // k

    def flat_pad(x, fill):
        return _pad_rows(x.reshape((n,) + tuple(x.shape[len(batch_shape):])),
                         pad, fill)

    alive_f = flat_pad(alive, False)
    if d_cur is not None:
        decay = flat_pad(d_prev - d_cur, 0.0)
        steps_est = flat_pad(d_cur, 0.0) / torch.maximum(decay, eps)
    elif sort_key is not None:
        # Caller-supplied slowness (larger = slower), negated for the
        # ascending sort.
        steps_est = -flat_pad(torch.as_tensor(
            sort_key, dtype=torch.float32, device=t_final.device), 0.0)
    else:
        steps_est = flat_pad(t_final * 0.0, 0.0)
    key = torch.where(alive_f, steps_est,
                      _f32(_DEAD_KEY, t_final.device))
    # One key per sort block (its most urgent live ray); whole blocks move.
    order = torch.argsort(key.reshape(-1, bs).amin(dim=1), stable=True)

    def permute(x):
        rows = x.reshape((nb + pad_b, bs) + tuple(x.shape[1:]))
        return rows[order].reshape(x.shape)

    t_s = permute(flat_pad(t_final, 0.0))
    alive_s = permute(alive_f)
    o_s = permute(flat_pad(origins.expand(batch_shape + (3,)), 0.0))
    d_s = permute(flat_pad(dirs.expand(batch_shape + (3,)), 0.0))
    stop_s = permute(flat_pad(t_stop, 0.0))
    # Thread the head's last sample and converged mask into the tail, so
    # the merged carries cover both phases.
    if d_cur is not None:
        dc_s = permute(flat_pad(d_cur, _BIG))
        cv_s = permute(flat_pad(conv, False))
    else:
        dc_s = torch.full_like(t_s, _BIG)
        cv_s = torch.zeros_like(alive_s)

    t_out, d_out, cv_out, iters = [], [], [], []
    for c in range(k):
        s = slice(c * chunk, (c + 1) * chunk)
        t_c, _, _, d_last, conv_c, i_c = march_while(
            t_s[s], alive_s[s], o_s[s], d_s[s], stop_s[s], remaining,
            d_cur=dc_s[s], conv=cv_s[s])
        t_out.append(t_c)
        d_out.append(d_last)
        cv_out.append(conv_c)
        iters.append(i_c)
    stats["fine_tail_iters"] = _counter(iters)  # [k]
    stats["fine_tail_chunk_width"] = chunk
    # Rows the compaction moves per array: whole sort blocks when bs > 1.
    stats["fine_sort_blocks"] = (nb + pad_b) if bs > 1 else (n + pad)
    # Permutes in (t, alive, o, d, stop; + last sample and converged mask
    # after a head) and scatters back (t; + last sample and converged mask
    # for the sparse final sample).
    sparse_final = bs > 1
    stats["fine_sort_arrays"] = (5 + (2 if d_cur is not None else 0)
                                 + (3 if sparse_final else 1))
    t_final = _unsort(torch.cat(t_out), order, bs, n).reshape(batch_shape)
    if not sparse_final:
        return t_final, None
    d_carried = _unsort(torch.cat(d_out), order, bs, n)
    conv = _unsort(torch.cat(cv_out), order, bs, n).reshape(batch_shape)
    return t_final, (d_carried, conv, bs, k)


def _sparse_final_sample(sample, points, valid, d_carried, conv, bs, k, inf,
                         stats):
    """Final values ``[n]`` of a block-sorted schedule without a dense
    gather: converged rays stopped at their last sample, so it is their
    value; rays outside the grid read ``inf``; the rest (certificate-
    retired and budget-capped rays) are sampled. Blocks holding such a ray
    are sorted first (stable) and the ``k`` chunks that hold one, a prefix,
    are sampled in one call: one host read for all chunk flags."""
    n = conv.numel()
    conv_f = conv.reshape(-1)
    valid_f = valid.reshape(-1)
    needs = valid_f & ~conv_f
    nb = n // bs
    k2 = min(k, nb)
    pad = (-nb) % k2
    block_needs = _pad_rows(needs.reshape(nb, bs).any(dim=1), pad, False)
    order = torch.argsort((~block_needs).to(torch.uint8), stable=True)
    bpc = (nb + pad) // k2
    chunk_go = block_needs[order].reshape(k2, bpc).any(dim=1)
    go = int(chunk_go.sum())  # the needy chunks are a prefix
    vals = torch.full(((nb + pad) * bs,), float("inf"), dtype=inf.dtype,
                      device=inf.device)
    if go:
        pts = _pad_rows(points.reshape(nb, bs, 3), pad, 0.0)[
            order[:go * bpc]]
        q = sample(pts.reshape(-1, 3))
        vals[:go * bpc * bs] = torch.where(q.valid, q.value, inf)
    gathered = _unsort(vals, order, bs, n)
    stats["final_sample_rows"] = go * bpc * bs
    stats["final_sort_blocks"] = nb + pad
    stats["final_sort_arrays"] = 2  # points permute + value scatter
    return torch.where(conv_f, d_carried.to(inf.dtype),
                       torch.where(valid_f, gathered, inf))


def _cone_prepass(sdf: SignedDistanceField, camera: PinholeCamera,
                  factor: int, num_steps: int,
                  surface_threshold: float, max_depth: float,
                  corner_table: Optional[sdf_query.Table],
                  max_cone_steps: Optional[int] = None,
                  cone_tail_chunks: int = 1,
                  cone_refine: Optional[int] = None,
                  stats: Optional[dict] = None
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Cone-traced coarse pass, one cone per ``factor x factor`` pixel
    block (the JAX package's ``_cone_prepass``; its docstring has the
    proofs). A cone advances while its sample exceeds its radius plus a
    safety margin, so its depth certifies that no fine ray of the block
    meets the surface before it. Returns four ``[H, W]`` images: the
    certified depth ``t_init``, the depth the cone started at
    (``t_valid_from``; the certificate covers rays entering the grid from
    there on), a slowness estimate (steps used, plus the budget if the cone
    never stopped) and the escape certificate (the cone left the grid still
    safe: the block's rays meet no surface in the grid).

    ``max_cone_steps`` caps the cone budget. ``cone_tail_chunks > 1`` runs
    the cones 8 full-width steps, then sorted (stable) by estimated
    remaining steps in that many chunks; results are bitwise those of one
    chunk. ``cone_refine`` (a block size dividing ``factor``) runs a second
    stage of sub-cones that continue from their parent's depth; the images
    are then at that block size."""
    f = int(factor)
    dev = camera.pose.device
    wc, hc = camera.width // f, camera.height // f

    def block_dirs(du, dv, bf):
        # World direction of the fine pixel at offset (du, dv) within each
        # bf x bf block (camera_rays' math on the coarse lattice).
        u = torch.arange(camera.width // bf, dtype=torch.float32,
                         device=dev) * bf + du
        v = torch.arange(camera.height // bf, dtype=torch.float32,
                         device=dev) * bf + dv
        return _unit_dirs(camera, u, v)

    def block_geometry(bf):
        """(center dirs, tan of the exact per-block angular radius): the
        extreme directions of a pinhole block are at its 4 corners."""
        center = block_dirs((bf - 1) / 2.0, (bf - 1) / 2.0, bf)
        sin_t = torch.zeros(center.shape[:-1], dtype=torch.float32,
                            device=dev)
        for du in (-0.5, bf - 0.5):
            for dv in (-0.5, bf - 0.5):
                c = block_dirs(du, dv, bf)
                sin_t = torch.maximum(
                    sin_t, _norm3(torch.linalg.cross(c, center, dim=-1)))
        tan_t = sin_t / torch.sqrt(torch.clamp(1.0 - sin_t * sin_t,
                                               min=1e-6))
        return center, tan_t

    center, tan_t = block_geometry(f)
    origins = camera.pose[:3, 3].expand(center.shape)

    if corner_table is not None:
        def raw_sample(pos):
            return sdf_query.estimate_location_distance_fast(
                sdf, corner_table, pos)
    else:
        def raw_sample(pos):
            return sdf_query.estimate_location_distance(sdf, pos)

    # Cone samples are clamped into the grid box and the value is offset-
    # corrected (no geometry outside the grid, 1-Lipschitz field), so the
    # march may start before the entry face and run past the exit face.
    inv = sdf.inverse_origin_transform()
    fwd = sdf.origin_transform
    sizes_g = constant(tuple(sdf.spec.grid_sizes), torch.float32, dev)
    clamp_pad = _f32(0.25 * sdf.resolution, dev)

    def sample(pos):
        p_g = transforms.apply_isometry(inv, pos)
        p_c = torch.clamp(p_g, min=clamp_pad, max=sizes_g - clamp_pad)
        off = _norm3(p_g - p_c)
        q = raw_sample(transforms.apply_isometry(fwd, p_c))
        return q.value - off, q.valid

    # The cone starts at the center ray's entry depth and stops at
    # min(exit, max_depth), as fine rays do.
    t_enter_c, t_exit_c, hits_c = _clip_to_grid(sdf, origins, center)
    t_exit_c = torch.minimum(t_exit_c, _f32(max_depth, dev))
    t_start = torch.clamp(t_enter_c, min=0.0)
    # Safety margin: the interpolated corrected query is within delta of the
    # metric distance, so the cone must keep query > tan*t + 2*delta +
    # thresh, plus a band that makes the endpoint guarantee strict against
    # f32 rounding (the JAX package's round-4 fix).
    delta = (0.5 + float(np.sqrt(3.0)) / 2.0) * sdf.resolution
    band = 0.05 * sdf.resolution
    margin = _f32(surface_threshold + 2.0 * delta + band, dev)
    eps = _f32(1e-3 * sdf.resolution, dev)

    budget = num_steps if max_cone_steps is None \
        else min(int(max_cone_steps), num_steps)

    def cone_march(t, alive, used, escaped, d_prev, d_cur, o, c, tt, tx,
                   steps):
        """March cones while safe; each cone's sequence is independent of
        which cones share the loop, so any chunking gives the same bits."""
        iters = 0
        for _ in range(steps):
            if not bool(alive.any()):
                break
            iters += 1
            value, valid = sample(o + c * t[..., None])
            r = tt * t + margin
            safe = valid & (value > r)
            step = torch.maximum((value - r) / (1.0 + tt), eps)
            t_new = torch.where(alive & safe, t + step, t)
            # Escape: the cone crossed the exit depth while still safe.
            escaped = escaped | (alive & safe & (t_new >= tx))
            used = torch.where(alive, used + 1.0, used)
            d_prev = torch.where(alive, d_cur, d_prev)
            d_cur = torch.where(alive, value, d_cur)
            alive = alive & safe & (t_new < tx)
            t = t_new
        return iters, t, alive, used, escaped, d_prev, d_cur

    k_cone = int(cone_tail_chunks)

    def run_stage(o, c, tt, tx, t0, alive0, used0, escaped0,
                  head_steps=None, sort_key0=None):
        """Head + (with ``k_cone > 1``) sorted chunked tail over flat
        ``[m]`` cones. ``head_steps=0`` sorts by the caller's ``sort_key0``
        (larger = slower) without a full-width head."""
        d0 = torch.full_like(t0, _BIG)
        head = budget if k_cone <= 1 else min(8, budget)
        if head_steps is not None and k_cone > 1:
            head = min(int(head_steps), budget)
        if head > 0:
            hd_iters, t_c, alive_e, used, escaped, d_prev, d_cur = \
                cone_march(t0, alive0, used0, escaped0, d0, d0, o, c, tt,
                           tx, head)
        else:
            hd_iters = 0
            t_c, alive_e, used, escaped = t0, alive0, used0, escaped0
            d_prev = d_cur = d0
        st = {"head_iters": _counter(hd_iters), "head_width": t_c.shape[0]}
        if stats is not None:
            stats.setdefault("cone_stages", []).append(st)
        if k_cone <= 1 or budget <= head:
            return t_c, alive_e, used, escaped
        n = t_c.shape[0]
        pad = (-n) % k_cone
        chunk = (n + pad) // k_cone
        # 10 permute gathers in + 4 unsort scatters out, scalar rows.
        st["sort_rows"] = n + pad
        st["sort_arrays"] = 14

        alive_f = _pad_rows(alive_e, pad, False)
        if head > 0:
            decay = _pad_rows(d_prev - d_cur, pad, 0.0)
            est = _pad_rows(d_cur, pad, 0.0) / torch.maximum(decay, eps)
        elif sort_key0 is not None:
            est = -_pad_rows(sort_key0.float(), pad, 0.0)
        else:
            est = _pad_rows(t_c * 0.0, pad, 0.0)
        key = torch.where(alive_f, est, _f32(_DEAD_KEY, dev))
        order = torch.argsort(key, stable=True)
        (t_s, al_s, us_s, es_s, dp_s, dc_s, o_s, c_s, tt_s, tx_s) = [
            _pad_rows(a, pad, fill)[order] for a, fill in (
                (t_c, 0.0), (alive_e, False), (used, 0.0),
                (escaped, False), (d_prev, _BIG), (d_cur, _BIG), (o, 0.0),
                (c, 0.0), (tt, 0.0), (tx, 0.0))]
        outs, iters = [], []
        for i in range(k_cone):
            s = slice(i * chunk, (i + 1) * chunk)
            i_o, t_o, al_o, us_o, es_o, _, _ = cone_march(
                t_s[s], al_s[s], us_s[s], es_s[s], dp_s[s], dc_s[s], o_s[s],
                c_s[s], tt_s[s], tx_s[s], budget - head)
            outs.append((t_o, al_o, us_o, es_o))
            iters.append(i_o)
        st["tail_iters"] = _counter(iters)  # [k_cone]
        st["tail_chunk_width"] = chunk
        return tuple(_unsort(torch.cat(xs), order, 1, n)
                     for xs in zip(*outs))

    def flat(x):
        return x.reshape((hc * wc,) + tuple(x.shape[2:]))

    zeros_f = torch.zeros(hc * wc, dtype=torch.float32, device=dev)
    t_cone, alive_end, used, escaped = run_stage(
        flat(origins), flat(center), flat(tan_t), flat(t_exit_c),
        flat(t_start), flat(hits_c & (t_start < t_exit_c)), zeros_f,
        zeros_f < -1.0)
    hits_b = flat(hits_c)
    valid_from = torch.where(hits_b, flat(t_start), _f32(float("inf"), dev))
    out_f = f

    if cone_refine and int(cone_refine) >= f:
        raise ValueError(
            f"cone_refine={int(cone_refine)} must be smaller than "
            f"coarse_factor={f} (it is the FINER second-stage block size)")
    if cone_refine:
        # Sub-cones of every parent block continue from the parent's
        # certified depth with a narrower radius; children of escaped
        # parents start dead, children of missed blocks stay uncertified.
        rf = int(cone_refine)
        if f % rf:
            raise ValueError(
                f"cone_refine={rf} must divide coarse_factor={f}")
        scale = f // rf
        wc2, hc2 = camera.width // rf, camera.height // rf
        center2, tan2 = block_geometry(rf)
        origins2 = camera.pose[:3, 3].expand(center2.shape)
        _, t_ex2, hits2 = _clip_to_grid(sdf, origins2, center2)
        t_ex2 = torch.minimum(t_ex2, _f32(max_depth, dev))

        def up(x):
            img = x.reshape(hc, wc)
            return img.repeat_interleave(scale, 0).repeat_interleave(
                scale, 1).reshape(hc2 * wc2)

        def flat2(x):
            return x.reshape((hc2 * wc2,) + tuple(x.shape[2:]))

        t_p = up(t_cone)
        esc_p = up(escaped)
        hits_p = up(hits_b)
        t0_2 = torch.clamp(t_p, min=0.0)
        alive2 = flat2(hits2) & hits_p & ~esc_p & (t0_2 < flat2(t_ex2))
        # No child head: children sort by their parent's slowness.
        parent_slow = up(used + torch.where(alive_end, _f32(budget, dev),
                                            _f32(0.0, dev)))
        t_cone, alive_end, used, escaped = run_stage(
            flat2(origins2), flat2(center2), flat2(tan2), flat2(t_ex2),
            t0_2, alive2, up(used), esc_p,
            head_steps=0, sort_key0=parent_slow)
        hits_b = hits_p
        valid_from = up(valid_from)
        out_f = rf

    t_cone = torch.where(hits_b, t_cone, _f32(0.0, dev))
    # Blocks whose center ray misses the grid stay uncertified.
    escaped = escaped & hits_b
    # Cones that never stopped sort after everything else.
    slowness = used + torch.where(alive_end, _f32(budget, dev),
                                  _f32(0.0, dev))
    hb, wb = camera.height // out_f, camera.width // out_f

    def up_img(x):
        return x.reshape(hb, wb).repeat_interleave(
            out_f, 0).repeat_interleave(out_f, 1)

    return (up_img(t_cone), up_img(valid_from), up_img(slowness),
            up_img(escaped))


def _total(x) -> float:
    """Sum of a counter: a tensor (any device), a numpy array or a
    number."""
    if isinstance(x, torch.Tensor):
        return float(x.sum())
    return float(np.sum(x))


def gather_rows_from_stats(stats: dict,
                           gathers_per_sample: float = 1.0) -> float:
    """Gather and scatter rows a frame issued, from the ``with_stats=True``
    counters of :func:`render_depth` (the port's own, or the JAX package's
    converted to numpy): every march iteration samples once per lane of
    its phase width (``gathers_per_sample`` rows per sample: 1 with a
    corner table, 8 without), and every compaction moves one row per sort
    unit per array. Reading the counters syncs with the device."""
    rows = 0.0
    for st in stats.get("cone_stages", []):
        rows += _total(st["head_iters"]) * st["head_width"] \
            * gathers_per_sample
        if "tail_iters" in st:
            rows += _total(st["tail_iters"]) * st["tail_chunk_width"] \
                * gathers_per_sample
        if "sort_rows" in st:
            rows += st["sort_rows"] * st["sort_arrays"]
    rows += (_total(stats.get("fine_head_iters", 0))
             * stats.get("fine_head_width", 0) * gathers_per_sample)
    if "fine_tail_iters" in stats:
        rows += (_total(stats["fine_tail_iters"])
                 * stats["fine_tail_chunk_width"] * gathers_per_sample)
        rows += stats["fine_sort_blocks"] * stats["fine_sort_arrays"]
    rows += _total(stats.get("final_sample_rows", 0)) * gathers_per_sample
    if "final_sort_blocks" in stats:  # sparse final sample's block permutes
        rows += stats["final_sort_blocks"] * stats["final_sort_arrays"]
    return rows


def block_relayout(height: int, width: int, factor: int,
                   batch: Optional[int] = None):
    """``(to_blocks, from_blocks)`` for the block-tail schedule: lay a
    ``[..., height, width, *rest]`` image out so that each ``factor x
    factor`` cone block is one contiguous run of rays (the ``sort_block``
    unit of :func:`sphere_trace`), and back; ``batch`` adds a leading view
    axis."""
    f = int(factor)
    hb, wb = height // f, width // f
    if batch is None:
        def to_blocks(x):
            rest = tuple(x.shape[2:])
            return x.reshape(hb, f, wb, f, *rest).transpose(1, 2) \
                .reshape(hb * wb * f * f, *rest)

        def from_blocks(x):
            rest = tuple(x.shape[1:])
            return x.reshape(hb, wb, f, f, *rest).transpose(1, 2) \
                .reshape(height, width, *rest)
    else:
        b = int(batch)

        def to_blocks(x):
            rest = tuple(x.shape[3:])
            return x.reshape(b, hb, f, wb, f, *rest).transpose(2, 3) \
                .reshape(b * hb * wb * f * f, *rest)

        def from_blocks(x):
            rest = tuple(x.shape[1:])
            return x.reshape(b, hb, wb, f, f, *rest).transpose(2, 3) \
                .reshape(b, height, width, *rest)
    return to_blocks, from_blocks


def render_depth(sdf: SignedDistanceField, camera: PinholeCamera,
                 num_steps: int = 64, max_depth: float = 100.0,
                 surface_threshold: Optional[float] = None,
                 corner_table: Optional[sdf_query.Table] = None,
                 early_exit: bool = False,
                 mip=None,
                 coarse_factor: int = 0,
                 cone_steps: Optional[int] = None,
                 cone_tail_chunks: int = 1,
                 cone_refine: Optional[int] = None,
                 with_stats: bool = False,
                 **trace_kwargs):
    """Render an ``[H, W]`` depth image (differentiable in
    ``sdf.distances`` and ``camera.pose`` on the fixed-step march). See
    :func:`sphere_trace` for the march options.

    ``coarse_factor > 0`` (dividing both image sizes) runs
    :func:`_cone_prepass` and starts every fine ray at its block's
    certified depth: hits are a superset of the plain march's, up to
    tangent grazers, and common depths agree within the convergence
    threshold. ``cone_steps``, ``cone_tail_chunks`` and ``cone_refine`` go
    to the prepass. With ``head_steps=0`` the tail sorts by the cone's
    slowness, and with ``early_exit`` and ``tail_chunks > 1`` the rays are
    laid out block-major (:func:`block_relayout`) so the tail sorts whole
    cone blocks and retires escape-certified rays unmarched.
    ``with_stats=True`` returns ``(result, stats)``; see
    :func:`gather_rows_from_stats`."""
    origins, dirs = camera_rays(camera)
    t_init = t_valid_from = sort_key = cert_miss = None
    stats = {} if with_stats else None
    if coarse_factor:
        if camera.width % coarse_factor or camera.height % coarse_factor:
            raise ValueError(
                f"coarse_factor={coarse_factor} must divide the image "
                f"dimensions {camera.width}x{camera.height}")
        thresh = (0.25 * sdf.resolution if surface_threshold is None
                  else float(surface_threshold))
        # The certified start is control data: within the certified-empty
        # interval the march result does not depend on it, so no gradient
        # flows through the prepass.
        t_init, t_valid_from, cone_slow, cert_miss = (
            x.detach() for x in _cone_prepass(
                sdf, camera, coarse_factor, num_steps, thresh, max_depth,
                corner_table, max_cone_steps=cone_steps,
                cone_tail_chunks=cone_tail_chunks, cone_refine=cone_refine,
                stats=stats))
        if trace_kwargs.get("head_steps", 8) == 0:
            # No full-width fine steps: the tail sorts by cone slowness.
            sort_key = cone_slow
    if (early_exit and sort_key is not None
            and trace_kwargs.get("tail_chunks", 8) > 1):
        # Block-tail schedule: each cone's f x f pixels contiguous, so the
        # tail sorts and moves whole blocks; outputs are laid back out.
        f = int(coarse_factor)
        to_blocks, from_blocks = block_relayout(camera.height,
                                                camera.width, f)
        result = sphere_trace(
            sdf, to_blocks(origins), to_blocks(dirs), num_steps=num_steps,
            max_depth=max_depth, surface_threshold=surface_threshold,
            corner_table=corner_table, early_exit=True, mip=mip,
            t_init=to_blocks(t_init),
            t_init_valid_from=to_blocks(t_valid_from),
            sort_key=to_blocks(sort_key),
            certified_miss=to_blocks(cert_miss),
            sort_block=f * f, with_stats=with_stats, **trace_kwargs)
        if with_stats:
            result, trace_stats = result
            stats.update(trace_stats)
        result = RenderResult(*(from_blocks(v) for v in result))
        return (result, stats) if with_stats else result
    result = sphere_trace(sdf, origins, dirs, num_steps=num_steps,
                          max_depth=max_depth,
                          surface_threshold=surface_threshold,
                          corner_table=corner_table, early_exit=early_exit,
                          mip=mip, t_init=t_init,
                          t_init_valid_from=t_valid_from, sort_key=sort_key,
                          certified_miss=cert_miss,
                          with_stats=with_stats, **trace_kwargs)
    if with_stats:
        result, trace_stats = result
        stats.update(trace_stats)
        return result, stats
    return result


def render_depth_batch(sdf: SignedDistanceField, cameras: PinholeCamera,
                       num_steps: int = 64, max_depth: float = 100.0,
                       surface_threshold: Optional[float] = None,
                       corner_table: Optional[sdf_query.Table] = None,
                       coarse_factor: int = 8,
                       cone_steps: Optional[int] = 32,
                       cone_tail_chunks: int = 8,
                       tail_chunks: int = 64,
                       **trace_kwargs) -> RenderResult:
    """Render ``B`` views in one march: ``cameras`` is a stacked camera
    (:meth:`PinholeCamera.stack`: ``pose [B, 4, 4]``, ``fx [B]``, ...), and
    the result holds ``[B, H, W]`` images. The cone prepass runs view by
    view, then every fine ray of every view marches in one block-sorted
    tail (``head_steps=0``), so each ray's samples, and with them each
    view's depths and hits, are bitwise those of :func:`render_depth` on
    the same schedule. Inference only (``early_exit``); ``coarse_factor``
    must divide both image sizes."""
    if not (coarse_factor and cameras.width % coarse_factor == 0
            and cameras.height % coarse_factor == 0):
        raise ValueError("render_depth_batch requires coarse_factor "
                         "dividing the image dimensions")
    f = int(coarse_factor)
    h, w = cameras.height, cameras.width
    thresh = (0.25 * sdf.resolution if surface_threshold is None
              else float(surface_threshold))
    views = [cameras.view(i) for i in range(cameras.pose.shape[0])]
    rays = [camera_rays(v) for v in views]
    origins = torch.stack([o for o, _ in rays])  # [B, H, W, 3]
    dirs = torch.stack([d for _, d in rays])
    cones = [_cone_prepass(sdf, v, f, num_steps, thresh, max_depth,
                           corner_table, max_cone_steps=cone_steps,
                           cone_tail_chunks=cone_tail_chunks)
             for v in views]
    t_init, t_valid_from, sort_key, cert_miss = (
        torch.stack(images).detach() for images in zip(*cones))
    to_blocks, from_blocks = block_relayout(h, w, f, batch=len(views))
    result = sphere_trace(
        sdf, to_blocks(origins), to_blocks(dirs), num_steps=num_steps,
        max_depth=max_depth, surface_threshold=surface_threshold,
        corner_table=corner_table, early_exit=True,
        head_steps=0, tail_chunks=tail_chunks,
        t_init=to_blocks(t_init), t_init_valid_from=to_blocks(t_valid_from),
        sort_key=to_blocks(sort_key), certified_miss=to_blocks(cert_miss),
        sort_block=f * f, **trace_kwargs)
    return RenderResult(*(from_blocks(v) for v in result))


def render_occupancy_image(sdf: SignedDistanceField, camera: PinholeCamera,
                           num_steps: int = 64, max_depth: float = 100.0,
                           softness: float = 1.0,
                           **render_kwargs) -> Tensor:
    """Soft silhouette: the sigmoid of the final SDF sample, a smooth hit
    mask whose gradients reach voxels even for near-miss rays.
    ``render_kwargs`` go to :func:`render_depth`."""
    result = render_depth(sdf, camera, num_steps=num_steps,
                          max_depth=max_depth, **render_kwargs)
    scale = _f32(softness * sdf.resolution, result.distance.device)
    d = torch.where(torch.isfinite(result.distance), result.distance,
                    10.0 * scale)
    return torch.sigmoid(-d / scale)


def depth_to_pointcloud(result: RenderResult, camera: PinholeCamera,
                        max_range: Optional[float] = None):
    """Back-project a rendered depth image into a camera-frame
    :class:`..ops.voxelize.PointCloud` (NaN where the ray missed), posed at
    the camera: render -> sensor model -> carving."""
    origins, dirs = camera_rays(camera)
    pts_world = origins + dirs * result.depth[..., None]
    inv = transforms.invert_isometry(camera.pose)
    pts_cam = transforms.apply_isometry(inv, pts_world)
    pts = torch.where(result.hit[..., None], pts_cam,
                      _f32(float("nan"), pts_cam.device))
    return PointCloud.create(
        pts.reshape(-1, 3), camera.pose,
        max_range=float("inf") if max_range is None else max_range)
