"""Differentiable SDF sphere tracing (depth rendering).

Port of ``voxelized_geometry_tools_tpu/ops/render.py`` (the main-path
subset): a pinhole camera, world-frame rays, slab clipping to the grid box,
and two march schedules over the trilinear SDF samples of
:mod:`.sdf_query`:

* the fixed-step march (``early_exit=False``): ``num_steps`` iterations of
  a Python loop; converged rays keep ``dt = 0``, so extra iterations change
  neither value nor gradient. Differentiable in ``sdf.distances`` and
  ``camera.pose`` through autograd over plain tensor ops.
* the early-exit march (``early_exit=True, tail_chunks=1``): the same
  iteration, stopped as soon as no ray is alive. In eager PyTorch the
  ``any(alive)`` test is one host sync per iteration.

Rays that miss return ``hit=False`` with depth ``max_depth``. The cone
prepass, block-sorted tail, sparse final sample, mip skip and the other
schedule options of the JAX package are not ported yet and raise.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core import transforms
from ..core.maps import SignedDistanceField
from . import sdf_query

Tensor = torch.Tensor

_SCHEDULE_TODO = "ROADMAP.md queue 1 item 5b"


def _todo(option: str, item: str = _SCHEDULE_TODO):
    return NotImplementedError(f"{option} is not ported yet ({item})")


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


class RenderResult(NamedTuple):
    depth: Tensor     # [H, W] ray depth (t along the unit ray direction)
    hit: Tensor       # [H, W] bool, surface hit within max_depth
    points: Tensor    # [H, W, 3] final world-space sample positions
    distance: Tensor  # [H, W] final SDF sample value


def camera_rays(camera: PinholeCamera) -> Tuple[Tensor, Tensor]:
    """World-frame ray origins ``[H,W,3]`` and unit directions ``[H,W,3]``."""
    dev = camera.pose.device
    u = torch.arange(camera.width, dtype=torch.float32, device=dev)
    v = torch.arange(camera.height, dtype=torch.float32, device=dev)
    vv, uu = torch.meshgrid(v, u, indexing="ij")
    dirs_cam = torch.stack([
        (uu - camera.cx) / camera.fx,
        (vv - camera.cy) / camera.fy,
        torch.ones_like(uu),
    ], dim=-1)
    dirs_cam = dirs_cam / torch.linalg.vector_norm(dirs_cam, dim=-1,
                                                   keepdim=True)
    dirs_world = transforms.rotate_vector(camera.pose, dirs_cam)
    origins = camera.pose[:3, 3].expand(dirs_world.shape)
    return origins, dirs_world


def _clip_to_grid(sdf: SignedDistanceField, origins: Tensor,
                  dirs: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Slab-clip rays to the grid box in grid frame:
    ``(t_enter, t_exit, hits_grid)``."""
    inv = sdf.inverse_origin_transform()
    o_grid = transforms.apply_isometry(inv, origins)
    d_grid = transforms.rotate_vector(inv, dirs)
    sizes = torch.tensor(sdf.spec.grid_sizes, dtype=torch.float32,
                         device=origins.device)
    tiny = torch.tensor(1e-12, dtype=torch.float32, device=origins.device)
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


def sphere_trace(sdf: SignedDistanceField, origins: Tensor, dirs: Tensor,
                 num_steps: int = 64,
                 surface_threshold: Optional[float] = None,
                 max_depth: float = 100.0,
                 step_scale: float = 1.0,
                 corner_table: Optional[sdf_query.CornerTable] = None,
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
                 with_stats: bool = False) -> RenderResult:
    """Sphere-trace rays (``[..., 3]`` world-frame origins and directions)
    through an SDF grid.

    The march advances each ray by its sampled distance until the sample
    falls below ``surface_threshold`` (default a quarter voxel), the ray
    leaves the grid, or ``num_steps`` is spent. ``corner_table`` makes each
    sample one row gather. ``early_exit=True`` stops once every ray has
    converged or left; it is ported for ``tail_chunks <= 1`` (the whole
    budget in one march). ``head_steps``, ``sort_block`` and
    ``coarse_steps`` only matter for schedules that are not ported.

    Not ported yet, and raising: ``mip``, ``t_init``/``t_init_valid_from``,
    ``certified_miss``, ``sort_key``, ``relax > 1``, ``remat``,
    ``with_stats`` and ``early_exit`` with ``tail_chunks > 1``."""
    if surface_threshold is None:
        surface_threshold = 0.25 * sdf.resolution
    relax = float(relax)
    if relax < 1.0:
        raise ValueError(f"relax={relax} must be >= 1.0 "
                         "(use step_scale for under-relaxation)")
    if mip is not None:
        raise _todo("mip", "ROADMAP.md queue 1 item 5d, SdfMip")
    for name, value in (("t_init", t_init),
                        ("t_init_valid_from", t_init_valid_from),
                        ("sort_key", sort_key),
                        ("certified_miss", certified_miss)):
        if value is not None:
            raise _todo(name)
    if relax > 1.0:
        raise _todo("relax > 1", "ROADMAP.md queue 1 item 5h")
    if remat:
        raise _todo("remat", "ROADMAP.md queue 1 item 5h")
    if with_stats:
        raise _todo("with_stats")
    if early_exit and tail_chunks > 1:
        raise _todo(f"early_exit with tail_chunks={tail_chunks} > 1 (pass "
                    "tail_chunks=1)")

    dev = origins.device
    thresh = torch.tensor(surface_threshold, dtype=torch.float32, device=dev)
    eps = torch.tensor(1e-3 * sdf.resolution, dtype=torch.float32,
                       device=dev)
    max_d = torch.tensor(max_depth, dtype=torch.float32, device=dev)

    if corner_table is not None:
        def sample(pos):
            return sdf_query.estimate_location_distance_fast(
                sdf, corner_table, pos)
    else:
        def sample(pos):
            return sdf_query.estimate_location_distance(sdf, pos)

    t_enter, t_exit, hits_grid = _clip_to_grid(sdf, origins, dirs)
    t = torch.where(hits_grid, t_enter + eps, max_d)
    t_stop = torch.minimum(t_exit, max_d)
    alive = hits_grid

    def advance(t, alive):
        pos = origins + dirs * t[..., None]
        q = sample(pos)
        d = torch.where(q.valid, q.value, thresh)  # nudge forward if outside
        converged = q.valid & (d <= thresh)
        step = torch.maximum(d * step_scale, eps)
        new_t = torch.where(alive & ~converged, t + step, t)
        return new_t, alive & ~converged & (new_t < t_stop)

    for _ in range(num_steps):
        # early_exit: one host sync per iteration (no CUDA graph yet).
        if early_exit and not bool(alive.any()):
            break
        t, alive = advance(t, alive)

    points = origins + dirs * t[..., None]
    q = sample(points)
    inf = torch.tensor(float("inf"), dtype=q.value.dtype, device=dev)
    final_d = torch.where(q.valid, q.value, inf)
    hit = hits_grid & q.valid & (final_d <= thresh * 2.0)
    # Newton-style refinement: pull the depth to the zero crossing along the
    # ray with the final sample; keeps depth differentiable in the voxel
    # values even where the march converged early.
    refined_t = t + torch.where(hit, final_d, torch.zeros_like(final_d))
    depth = torch.where(hit, refined_t, max_d)
    return RenderResult(depth=depth, hit=hit, points=points,
                        distance=final_d)


def render_depth(sdf: SignedDistanceField, camera: PinholeCamera,
                 num_steps: int = 64, max_depth: float = 100.0,
                 surface_threshold: Optional[float] = None,
                 corner_table: Optional[sdf_query.CornerTable] = None,
                 early_exit: bool = False,
                 mip=None,
                 coarse_factor: int = 0,
                 cone_steps: Optional[int] = None,
                 cone_tail_chunks: int = 1,
                 cone_refine: Optional[int] = None,
                 with_stats: bool = False,
                 **trace_kwargs) -> RenderResult:
    """Render an ``[H, W]`` depth image (differentiable in
    ``sdf.distances`` and ``camera.pose`` on the fixed-step march). See
    :func:`sphere_trace` for the options. ``coarse_factor > 0`` (the cone
    prepass, with ``cone_steps``/``cone_tail_chunks``/``cone_refine``) is
    not ported yet and raises."""
    if coarse_factor:
        raise _todo(f"coarse_factor={coarse_factor} (the cone prepass)")
    origins, dirs = camera_rays(camera)
    return sphere_trace(sdf, origins, dirs, num_steps=num_steps,
                        max_depth=max_depth,
                        surface_threshold=surface_threshold,
                        corner_table=corner_table, early_exit=early_exit,
                        mip=mip, with_stats=with_stats, **trace_kwargs)
