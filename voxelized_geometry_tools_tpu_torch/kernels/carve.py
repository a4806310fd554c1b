"""Pointcloud carve, the voxel walk of every ray of a cloud counted into
int32 tracking grids: the CUDA kernel ``csrc/carve.cu`` and its plain
PyTorch version.

Both take the per-ray setup as a :class:`RaySetup` (made by
``ops/voxelize.py::_ray_visits`` from ``_prepare_rays``), walk each ray for
at most ``n_steps`` steps and add into flat ``seen_free`` / ``seen_filled``
grids: one per visited voxel into ``seen_free``, and the endpoint into
``seen_filled`` (or ``seen_free`` where the ray was range-clipped). The
kernel replaces no TPU kernel: the JAX package carves with XLA scatters
inside while-loops (``voxelized_geometry_tools_tpu/ops/voxelize.py::
raycast_pointcloud``). One thread per ray, one launch per cloud;
``launches`` counts them. Integer adds commute, so the kernel equals the
plain walk bit for bit.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build

Tensor = torch.Tensor

__all__ = ["RaySetup", "carve_kernel", "carve_plain", "count_visits",
           "segment_steps"]

# Kernel launches.
launches = 0

# The JAX package's walk runs in segments of this many steps and tests for
# live rays between them (``_DDA_SEGMENT``), so a step budget is rounded up
# to a whole number of segments.
SEGMENT = 64


class RaySetup(NamedTuple):
    """Per-ray walk inputs, all on one device."""
    start: Tensor      # int32 [N, 3] start voxel
    final: Tensor      # int32 [N, 3] final voxel (may lie outside the grid)
    step: Tensor       # int32 [N, 3] sign(final - start)
    t0: Tensor         # float32 [N, 3] time to leave the start voxel
    dt: Tensor         # float32 [N, 3] time per voxel, 0 where infinite
    hit: Tensor        # bool [N] the ray is walked
    end_flat: Tensor   # int32 [N] endpoint's flat index, -1 for none
    end_filled: Tensor  # bool [N] endpoint is marked filled, else free


def segment_steps(max_steps: int) -> int:
    """The walk's step budget: ``max_steps`` rounded up to whole segments."""
    return max(-(-int(max_steps) // SEGMENT), 0) * SEGMENT


def _add_ones(grid: Tensor, flat: Tensor) -> None:
    if flat.numel():
        grid.index_add_(0, flat.long(), torch.ones_like(flat))


def _mark_endpoints(setup: RaySetup, seen_free: Tensor,
                    seen_filled: Tensor) -> None:
    marked = setup.end_flat >= 0
    _add_ones(seen_free, setup.end_flat[marked & ~setup.end_filled])
    _add_ones(seen_filled, setup.end_flat[marked & setup.end_filled])


def _walk_steps(counts: Tuple[int, int, int], setup: RaySetup,
                n_steps: int, on_visit) -> None:
    """The voxel walk of ``_ray_visits`` in the JAX package, eagerly: per
    step, ``on_visit`` gets the flat indices of the voxels visited. Rays
    that have died are dropped at each segment boundary, where the JAX
    package tests whether any ray still walks."""
    nx, ny, nz = counts
    keep = setup.hit.nonzero().squeeze(1)
    cx, cy, cz = setup.start[keep].unbind(-1)
    fx, fy, fz = setup.final[keep].unbind(-1)
    sx, sy, sz = setup.step[keep].unbind(-1)
    tx0, ty0, tz0 = setup.t0[keep].unbind(-1)
    dtx, dty, dtz = setup.dt[keep].unbind(-1)
    kx = torch.zeros_like(cx)
    ky, kz = kx.clone(), kx.clone()
    active = torch.ones_like(cx, dtype=torch.bool)
    for s in range(n_steps):
        if s % SEGMENT == 0:
            live = active.nonzero().squeeze(1)
            if live.numel() == 0:
                break
            if live.numel() < active.numel():
                cx, cy, cz, fx, fy, fz, sx, sy, sz, tx0, ty0, tz0, dtx, dty, \
                    dtz, kx, ky, kz, active = (
                        v[live] for v in (cx, cy, cz, fx, fy, fz, sx, sy, sz,
                                          tx0, ty0, tz0, dtx, dty, dtz, kx,
                                          ky, kz, active))
        tx = tx0 + kx.to(torch.float32) * dtx
        ty = ty0 + ky.to(torch.float32) * dty
        tz = tz0 + kz.to(torch.float32) * dtz
        running = active & ((cx != fx) | (cy != fy) | (cz != fz))
        in_b = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
                & (cz >= 0) & (cz < nz))
        alive = running & in_b
        on_visit((cx * (ny * nz) + cy * nz + cz)[alive])
        # Axis choice with the reference's tie-breaking (x, then y, then z).
        pick_x = (tx <= ty) & (tx <= tz)
        pick_y = ~pick_x & (ty <= tx) & (ty <= tz)
        pick_z = ~pick_x & ~pick_y
        at_final = torch.where(pick_x, cx == fx,
                               torch.where(pick_y, cy == fy, cz == fz))
        alive = alive & ~at_final
        adv_x, adv_y, adv_z = alive & pick_x, alive & pick_y, alive & pick_z
        cx = torch.where(adv_x, cx + sx, cx)
        cy = torch.where(adv_y, cy + sy, cy)
        cz = torch.where(adv_z, cz + sz, cz)
        kx = kx + adv_x.to(torch.int32)
        ky = ky + adv_y.to(torch.int32)
        kz = kz + adv_z.to(torch.int32)
        active = alive


def carve_plain(counts: Tuple[int, int, int], setup: RaySetup,
                n_steps: int, seen_free: Tensor, seen_filled: Tensor) -> None:
    """The walk in plain PyTorch, on any device: adds each ray's visits and
    endpoint into the flat int32 grids ``seen_free`` and ``seen_filled``
    (``[nx * ny * nz]``), in place."""
    _walk_steps(counts, setup, n_steps,
                lambda flat: _add_ones(seen_free, flat))
    _mark_endpoints(setup, seen_free, seen_filled)


def count_visits(counts: Tuple[int, int, int], setup: RaySetup,
                 n_steps: int) -> int:
    """How many voxel visits the walk makes (the kernel's atomics, besides
    one per marked endpoint), by the plain walk."""
    total = [0]

    def on_visit(flat):
        total[0] += flat.numel()

    _walk_steps(counts, setup, n_steps, on_visit)
    return total[0]


@functools.cache
def _library():
    lib = build.load_library("carve")
    lib.carve_walk_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 4
        + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_void_p])
    lib.carve_walk_launch.restype = ctypes.c_int
    return lib


def _check(setup: RaySetup, seen_free: Tensor, seen_filled: Tensor,
           n_total: int) -> None:
    n = setup.hit.shape[0]
    want = {"start": (torch.int32, (n, 3)), "final": (torch.int32, (n, 3)),
            "step": (torch.int32, (n, 3)), "t0": (torch.float32, (n, 3)),
            "dt": (torch.float32, (n, 3)), "hit": (torch.bool, (n,)),
            "end_flat": (torch.int32, (n,)),
            "end_filled": (torch.bool, (n,))}
    for name, (dtype, shape) in want.items():
        t = getattr(setup, name)
        if t.device.type != "cuda":
            raise ValueError(f"carve kernel: {name} lies on {t.device}, "
                             "not on a CUDA device")
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"carve kernel: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape}")
    for name, g in (("seen_free", seen_free), ("seen_filled", seen_filled)):
        if (g.device != setup.hit.device or g.dtype != torch.int32
                or tuple(g.shape) != (n_total,) or not g.is_contiguous()):
            raise ValueError(f"carve kernel: {name} must be a contiguous "
                             f"int32 [{n_total}] tensor on {setup.hit.device}")


def carve_kernel(counts: Tuple[int, int, int], setup: RaySetup,
                 n_steps: int, seen_free: Tensor, seen_filled: Tensor) -> None:
    """One launch of the kernel (built at first use) on the current stream,
    without synchronizing: as :func:`carve_plain`, for CUDA tensors only."""
    global launches
    nx, ny, nz = counts
    _check(setup, seen_free, seen_filled, nx * ny * nz)
    if nx * ny * nz >= 2 ** 31:
        raise ValueError(f"grid {counts} has 2^31 voxels or more")
    dev = setup.hit.device
    err = _library().carve_walk_launch(
        setup.start.data_ptr(), setup.final.data_ptr(),
        setup.step.data_ptr(), setup.t0.data_ptr(), setup.dt.data_ptr(),
        setup.hit.data_ptr(), setup.end_flat.data_ptr(),
        setup.end_filled.data_ptr(), setup.hit.shape[0], nx, ny, nz,
        int(n_steps), seen_free.data_ptr(), seen_filled.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"carve kernel launch failed (cudaError_t {err})")
    launches += 1

