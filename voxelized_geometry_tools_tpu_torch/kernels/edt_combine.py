"""The EDT's signed combine: the CUDA kernel of ``csrc/edt_combine.cu`` and
its plain PyTorch version.

Both take two float32 fields of squared distances in voxels, ``a`` (to the
filled set) and ``b`` (to the free set), and write the signed distance
``sqrt(a) * res - sqrt(b) * res`` into a float32 or float64 ``out``, each
root correctly rounded in ``out``'s type and ``res`` the rounding of
``resolution`` to it. The one-field forms write ``sqrt(a) * res`` (``b``
None) or ``out - sqrt(b) * res`` (``a`` None), so that a float64 result
can be formed one field at a time. The kernel replaces no TPU kernel: the
JAX package combines with XLA elementwise operations, which the plain
version repeats with :func:`correctly_rounded_sqrt`. The kernel reads each
input once and writes the result once, and gives the plain version's bits
for any float32 input.

:func:`signed_combine` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors; ``launches`` counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from . import build

Tensor = torch.Tensor

__all__ = ["correctly_rounded_sqrt", "signed_combine",
           "signed_combine_plain"]

# Kernel launches.
launches = 0

# The kernel's forms (``csrc/edt_combine.cu``): both fields, the first
# alone, the second alone subtracted from ``out``.
_BOTH, _FIRST, _SUBTRACT_SECOND = 0, 1, 2
_OUT_DTYPES = (torch.float32, torch.float64)


@functools.cache
def _library():
    lib = build.load_library("edt_combine")
    lib.edt_combine_launch.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_double]
        + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.edt_combine_launch.restype = ctypes.c_int
    return lib


def correctly_rounded_sqrt(x: Tensor, dtype) -> Tensor:
    """Correctly rounded ``sqrt`` in ``dtype`` (float32 or float64), so the
    result matches the JAX package bit for bit on every device. It is taken
    in float64 and rounded: a correctly rounded float64 sqrt rounded to
    float32 is the correctly rounded float32 sqrt (53 >= 2 * 24 + 2).
    PyTorch's CPU sqrt is not correctly rounded in either type (measured
    on the integers below 3 * 512^2: 5456 differ by one ulp in float32,
    6070 in float64), so a CPU tensor takes numpy's, which is; on CUDA the
    float64 sqrt is IEEE."""
    x64 = x.to(torch.float64)
    if x64.device.type == "cpu":
        return torch.from_numpy(np.asarray(np.sqrt(x64.numpy()))).to(dtype)
    return torch.sqrt(x64).to(dtype)


def signed_combine_plain(a: Optional[Tensor], b: Optional[Tensor],
                         resolution: float, out: Tensor) -> Tensor:
    """The plain version, on any device: whole-grid PyTorch operations,
    written into ``out``, which is returned."""
    res = torch.tensor(resolution, dtype=out.dtype, device=out.device)
    if a is None:
        return out.sub_(correctly_rounded_sqrt(b, out.dtype) * res)
    value = correctly_rounded_sqrt(a, out.dtype) * res
    if b is not None:
        value = value - correctly_rounded_sqrt(b, out.dtype) * res
    return out.copy_(value)


def _check(a: Optional[Tensor], b: Optional[Tensor], out: Tensor) -> None:
    fields = {name: t for name, t in (("a", a), ("b", b)) if t is not None}
    if not fields:
        raise ValueError("signed_combine needs a, b or both")
    for name, t in fields.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be torch.float32, got {t.dtype}")
        if t.shape != out.shape:
            raise ValueError(f"{name} has shape {tuple(t.shape)}, out "
                             f"{tuple(out.shape)}")
    devices = [t.device for t in fields.values()] + [out.device]
    if len(set(devices)) != 1:
        raise ValueError(f"a, b and out lie on "
                         f"{', '.join(map(str, devices))}: one device only")


def signed_combine(a: Optional[Tensor], b: Optional[Tensor],
                   resolution: float, out: Tensor) -> Tensor:
    """``out = sqrt(a) * res - sqrt(b) * res`` (or a one-field form, as the
    module says), in place in ``out``, which is returned. ``out`` may be
    ``a`` or ``b`` itself. On CUDA tensors one launch of the kernel (built
    at first use) on the current stream, without synchronizing, host copy
    or scalar upload, for a contiguous float32 or float64 ``out``; on CPU
    tensors the plain version. Raises on fields that are not float32 or
    not ``out``'s shape, tensors on different devices, and, on CUDA, an
    ``out`` of another type or not contiguous."""
    global launches
    _check(a, b, out)
    if not out.is_cuda:
        return signed_combine_plain(a, b, resolution, out)
    if out.dtype not in _OUT_DTYPES:
        raise TypeError(f"out must be torch.float32 or torch.float64 on "
                        f"CUDA, got {out.dtype}")
    if not out.is_contiguous():
        raise ValueError("out must be contiguous")
    a, b = (t if t is None or t.is_contiguous() else t.contiguous()
            for t in (a, b))
    form = _FIRST if b is None else _SUBTRACT_SECOND if a is None else _BOTH
    if out.numel() == 0:
        return out
    err = _library().edt_combine_launch(
        None if a is None else a.data_ptr(),
        None if b is None else b.data_ptr(), out.data_ptr(), out.numel(),
        float(resolution), int(out.dtype == torch.float64), form,
        out.device.index or 0,
        torch.cuda.current_stream(out.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"edt_combine launch failed: cudaError_t {err}")
    launches += 1
    return out
