"""The carve's per-ray setup on the card: the CUDA kernel of
``csrc/ray_setup.cu``.

For every point of a cloud, the range clip, the far-endpoint clamp, the
grid-entry clip and the walk's inputs, as one :class:`.carve.RaySetup`:
the eight arrays that :func:`.carve.carve_tiled` reads. Its plain version
is the PyTorch setup of ``ops/voxelize.py`` (``_prepare_rays``, then
``_ray_visits``), which the CPU takes and the tests hold the kernel
against; the kernel gives its bits on the card for every field. It
replaces no TPU kernel: the JAX package forms the setup with XLA
elementwise operations.

:func:`ray_setup` launches it once, on the current stream, without a host
copy or a wait; ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Tuple

import torch

from . import build
from .carve import RaySetup

Tensor = torch.Tensor

__all__ = ["RAY_BYTES", "ray_setup"]

# Kernel launches.
launches = 0

# Bytes a ray moves at least: its point read (3 float32) and its RaySetup
# written (start, final, step: 3 int32 each; t0, dt: 3 float32 each; hit;
# end_flat int32; end_filled).
POINT_BYTES = 3 * 4
SETUP_BYTES = 3 * 12 + 2 * 12 + 1 + 4 + 1
RAY_BYTES = POINT_BYTES + SETUP_BYTES


@functools.cache
def _library():
    lib = build.load_library("ray_setup")
    lib.ray_setup_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [ctypes.c_int] * 3
        + [ctypes.c_float] * 8 + [ctypes.c_void_p] * 8
        + [ctypes.c_int, ctypes.c_void_p])
    lib.ray_setup_launch.restype = ctypes.c_int
    return lib


def _empty_setup(n: int, device) -> RaySetup:
    """Uninitialized setup arrays for ``n`` rays on ``device``."""
    def empty(dtype, *shape):
        return torch.empty((n,) + shape, dtype=dtype, device=device)
    return RaySetup(start=empty(torch.int32, 3), final=empty(torch.int32, 3),
                    step=empty(torch.int32, 3), t0=empty(torch.float32, 3),
                    dt=empty(torch.float32, 3), hit=empty(torch.bool),
                    end_flat=empty(torch.int32),
                    end_filled=empty(torch.bool))


def ray_setup(X_GC: Tensor, points: Tensor, max_range: Tensor,
              counts: Tuple[int, int, int], resolution: float,
              grid_sizes: Tuple[float, float, float]) -> RaySetup:
    """The setup of every ray of ``points`` (float32 ``[N, 3]`` in the
    camera frame) from the camera at ``X_GC`` (float32 ``[4, 4]``, the
    grid-frame transform) with range ``max_range`` (float32, 0-dim), into
    the grid of ``counts`` voxels of edge ``resolution`` (``grid_sizes``:
    counts times the voxel size), all on one CUDA device: one launch of the
    kernel (built at first use), without synchronizing. Raises on anything
    else."""
    global launches
    dev = points.device
    for name, t in (("X_GC", X_GC), ("points", points),
                    ("max_range", max_range)):
        if t.device != dev or not t.is_cuda or t.dtype != torch.float32:
            raise ValueError(f"ray setup kernel: {name} must be float32 on "
                             f"the points' CUDA device, got {t.dtype} on "
                             f"{t.device}")
    if points.dim() != 2 or points.shape[1] != 3 or X_GC.shape != (4, 4) \
            or max_range.numel() != 1:
        raise ValueError(f"ray setup kernel: points {tuple(points.shape)}, "
                         f"X_GC {tuple(X_GC.shape)}, max_range "
                         f"{tuple(max_range.shape)}")
    if math.prod(counts) >= 2 ** 31:
        raise ValueError(f"grid {tuple(counts)} has 2^31 voxels or more")
    n = points.shape[0]
    out = _empty_setup(n, dev)
    if n == 0:
        return out
    res = float(resolution)
    X_GC, points = X_GC.contiguous(), points.contiguous()
    err = _library().ray_setup_launch(
        X_GC.data_ptr(), points.data_ptr(), max_range.data_ptr(), n,
        *counts, *grid_sizes, res, 2.0 * res, 1e-3 * res, 1e-30, 1e-10,
        out.start.data_ptr(),
        out.final.data_ptr(), out.step.data_ptr(), out.t0.data_ptr(),
        out.dt.data_ptr(), out.hit.data_ptr(), out.end_flat.data_ptr(),
        out.end_filled.data_ptr(), dev.index or 0,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ray setup kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return out
