"""The EDT's axis-0 seed pass: the CUDA kernel of ``csrc/edt_seed.cu`` and
its plain PyTorch version.

Both take a bool mask ``[nx, ny, nz]`` (any strides) and return the
C-contiguous float32 ``[fields * nx, ny, nz]``: for each (y, z) line, the
squared distance in voxels along x to the nearest True voxel (rows ``[0,
nx)``, the filled field) and, with ``fields=2``, to the nearest False voxel
(rows ``[nx, 2 nx)``, the free field); ``+inf`` on a line with no voxel of
the sought kind. That is the stacked field the two-field EDT's envelope
passes read. The kernel replaces no TPU kernel: the JAX package takes this
pass with XLA ``cummax`` scans, which the plain version repeats
(``ops/edt.py::_binary_squared_dist_last``). Both round each distance to
float32 and square it with one rounding, and take the least square, so
they agree bit for bit at every ``nx`` (the source says why).

:func:`seed_fields` launches the kernel for a CUDA tensor and takes the
plain version only for a CPU tensor; ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

Tensor = torch.Tensor

__all__ = ["MAX_NX", "packed_max_nx", "seed_fields", "seed_fields_plain"]

# Kernel launches.
launches = 0

# The longest x axis: both versions index it in int32.
MAX_NX = 2 ** 31 - 1


@functools.cache
def _library():
    lib = build.load_library("edt_seed")
    lib.edt_seed_launch.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 6
        + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    lib.edt_seed_launch.restype = ctypes.c_int
    lib.edt_seed_packed_max_nx.argtypes = [ctypes.c_int]
    lib.edt_seed_packed_max_nx.restype = ctypes.c_longlong
    return lib


def packed_max_nx(device) -> int:
    """The longest x axis whose lines' bits the kernel holds in shared
    memory on CUDA ``device`` (14,528 on an H100); longer lines find their
    runs in the mask itself, with the same values."""
    index = torch.device(device).index
    return int(_library().edt_seed_packed_max_nx(
        torch.cuda.current_device() if index is None else index))


def seed_fields_plain(mask: Tensor, fields: int = 1) -> Tensor:
    """The plain version, on any device and any ``nx``: the prefix scans of
    ``_binary_squared_dist_last`` along axis 0, of ``mask`` and, with
    ``fields=2``, of ``~mask``, stacked."""
    from ..ops.edt import _binary_squared_dist_last

    return torch.cat([
        _binary_squared_dist_last(m.movedim(0, -1)).movedim(-1, 0)
        for m in (mask, ~mask)[:fields]])


def _check(mask: Tensor, fields: int) -> None:
    if mask.dtype != torch.bool:
        raise TypeError(f"mask must be bool, got {mask.dtype}")
    if mask.dim() != 3:
        raise ValueError(f"mask must be 3-D, got shape {tuple(mask.shape)}")
    if fields not in (1, 2):
        raise ValueError(f"fields must be 1 or 2, got {fields}")
    if mask.shape[0] > MAX_NX:
        raise ValueError(f"axis 0 of {mask.shape[0]} voxels exceeds "
                         f"{MAX_NX}, the most an int32 index reaches")


def seed_fields(mask: Tensor, fields: int = 1) -> Tensor:
    """The seed pass of ``mask`` (``fields`` 1 or 2, as the module says).
    On a CUDA tensor one launch of the kernel (built at first use) on the
    current stream, without synchronizing, host copy or scalar upload; on
    a CPU tensor the plain version. Raises on a mask that is not bool or
    not 3-D, and on ``nx > MAX_NX``."""
    global launches
    _check(mask, fields)
    if not mask.is_cuda:
        return seed_fields_plain(mask, fields)
    nx, ny, nz = mask.shape
    out = torch.empty((fields * nx, ny, nz), dtype=torch.float32,
                      device=mask.device)
    if out.numel() == 0:
        return out
    err = _library().edt_seed_launch(
        mask.data_ptr(), out.data_ptr(), nx, ny, nz, *mask.stride(), fields,
        mask.device.index or 0,
        torch.cuda.current_stream(mask.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edt_seed launch failed: cudaError_t {err}")
    launches += 1
    return out
