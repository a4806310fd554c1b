"""The fusion filter: the CUDA kernel of ``csrc/fusion_filter.cu`` and its
plain PyTorch version.

Both take C cameras' stacked int32 counters ``seen_free`` and
``seen_filled`` (``[C, *occupancy.shape]``) and the static float32
occupancy, and return the fused float32 occupancy
(``DoCombineAndFilterGrids``): each camera votes by the ``CountsSeenAs``
rule; a static cell above 0.5 is kept, any other becomes 1.0 if some
camera saw it filled, 0.0 if at least ``num_cameras_seen_free`` cameras saw
it free, else 0.5. The kernel replaces no TPU kernel: the JAX package fuses
with XLA elementwise operations, which the plain version repeats
(:func:`counts_seen_as`, which ``ops/voxelize.py`` re-exports, and its
votes). The kernel reads each input once and writes the result once, and
gives the plain version's bits for any counters and any occupancy, NaN
included (the source says how).

:func:`combine_and_filter_fused` launches the kernel for a CUDA tensor and
takes the plain version only for a CPU tensor; ``launches`` counts the
launches.
"""

from __future__ import annotations

import ctypes
import enum
import functools
import operator

import torch

from ..core.constants import constant
from . import build

Tensor = torch.Tensor

__all__ = ["combine_and_filter_fused", "combine_and_filter_plain"]

# Kernel launches.
launches = 0


@functools.cache
def _library():
    lib = build.load_library("fusion_filter")
    lib.fusion_filter_launch.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_longlong] * 2
        + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.fusion_filter_launch.restype = ctypes.c_int
    return lib


class SeenAs(enum.IntEnum):
    """pointcloud_voxelization_interface.hpp:18."""
    UNKNOWN = 0
    FILLED = 1
    FREE = 2


def _f32(x, device) -> Tensor:
    return constant(x, torch.float32, device)


def counts_seen_as(options, seen_free: Tensor,
                   seen_filled: Tensor) -> Tensor:
    """Vectorized ``CountsSeenAs`` voting rule (hpp:55-86); int8 SeenAs
    codes."""
    dev = seen_free.device
    i8 = torch.int8
    filtered_filled = torch.where(
        seen_filled >= options.outlier_points_threshold, seen_filled,
        torch.zeros_like(seen_filled))
    both = (seen_free > 0) & (filtered_filled > 0)
    pct = seen_free.to(torch.float32) / torch.maximum(
        (seen_free + filtered_filled).to(torch.float32), _f32(1.0, dev))
    free = constant(int(SeenAs.FREE), i8, dev)
    filled = constant(int(SeenAs.FILLED), i8, dev)
    unknown = constant(int(SeenAs.UNKNOWN), i8, dev)
    both_result = torch.where(
        pct >= _f32(float(options.percent_seen_free), dev), free, filled)
    return torch.where(
        both, both_result,
        torch.where(seen_free > 0, free,
                    torch.where(filtered_filled > 0, filled, unknown)))


def combine_and_filter_plain(options, seen_free: Tensor, seen_filled: Tensor,
                             occupancy: Tensor) -> Tensor:
    """The plain version, on any device: :func:`counts_seen_as`'s int8
    codes, each camera's votes summed, then the fuse, as whole-grid PyTorch
    operations."""
    dev = occupancy.device
    seen = counts_seen_as(options, seen_free, seen_filled)
    cameras_filled = (seen == SeenAs.FILLED).to(torch.int32).sum(
        dim=0, dtype=torch.int32)
    cameras_free = (seen == SeenAs.FREE).to(torch.int32).sum(
        dim=0, dtype=torch.int32)
    fused = torch.where(
        cameras_filled > 0, _f32(1.0, dev),
        torch.where(cameras_free >= options.num_cameras_seen_free,
                    _f32(0.0, dev), _f32(0.5, dev)))
    return torch.where(occupancy <= 0.5, fused, occupancy)


def _int32(x) -> int:
    """The int32 an int32 tensor is compared with for the integer ``x``:
    its low 32 bits, signed."""
    return ctypes.c_int32(operator.index(x)).value


def kernel_options(options) -> tuple:
    """The kernel's three option arguments: ``percent_seen_free`` rounded
    to float32, the other two as the int32 the plain version compares
    with."""
    return (ctypes.c_float(float(options.percent_seen_free)).value,
            _int32(options.outlier_points_threshold),
            _int32(options.num_cameras_seen_free))


def _check(seen_free: Tensor, seen_filled: Tensor, occupancy: Tensor) -> None:
    for name, t, dtype in (("seen_free", seen_free, torch.int32),
                           ("seen_filled", seen_filled, torch.int32),
                           ("occupancy", occupancy, torch.float32)):
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    want = "[C, " + ", ".join(str(s) for s in occupancy.shape) + "]"
    for name, t in (("seen_free", seen_free), ("seen_filled", seen_filled)):
        if t.dim() != occupancy.dim() + 1 or t.shape[1:] != occupancy.shape:
            raise ValueError(f"{name} must be {want} for an occupancy of "
                             f"shape {tuple(occupancy.shape)}, got "
                             f"{tuple(t.shape)}")
    if seen_free.shape[0] != seen_filled.shape[0]:
        raise ValueError(f"seen_free holds {seen_free.shape[0]} cameras, "
                         f"seen_filled {seen_filled.shape[0]}")
    devices = (seen_free.device, seen_filled.device, occupancy.device)
    if len(set(devices)) != 1:
        raise ValueError(f"seen_free, seen_filled and occupancy lie on "
                         f"{', '.join(map(str, devices))}: one device only")


def combine_and_filter_fused(options, seen_free: Tensor, seen_filled: Tensor,
                             occupancy: Tensor) -> Tensor:
    """The fused occupancy (as the module says), in a new tensor. On CUDA
    tensors one launch of the kernel (built at first use) on the current
    stream, without synchronizing, host copy or scalar upload; on CPU
    tensors the plain version. Raises on counters that are not int32 or
    not ``[C, *occupancy.shape]``, an occupancy that is not float32, and
    tensors on different devices."""
    global launches
    _check(seen_free, seen_filled, occupancy)
    if not occupancy.is_cuda:
        return combine_and_filter_plain(options, seen_free, seen_filled,
                                        occupancy)
    free, filled, occ = (t if t.is_contiguous() else t.contiguous()
                         for t in (seen_free, seen_filled, occupancy))
    out = torch.empty_like(occ)
    if out.numel() == 0:
        return out
    err = _library().fusion_filter_launch(
        free.data_ptr(), filled.data_ptr(), occ.data_ptr(), out.data_ptr(),
        free.shape[0], occ.numel(), *kernel_options(options),
        occ.device.index or 0,
        torch.cuda.current_stream(occ.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fusion_filter launch failed: cudaError_t {err}")
    launches += 1
    return out
