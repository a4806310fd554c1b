"""The transform product on the card: the CUDA kernel of
``csrc/transform_product.cu``.

``a @ b`` of small CUDA matrices with the bits of XLA's CPU dot, as
``core/transforms._product`` forms them on the host for CPU tensors: in
float32 each element is the fused multiply-add chain of
``core/transforms._fma_chain`` (the ``k = 0`` product rounded on its own,
then ``fma`` in ``k`` order); in float64 with ``K <= 3`` the chain of
``_fma_chain_f64``. One launch on the current stream, no host copy and no
wait; ``launches`` counts them. The kernel replaces no TPU kernel (the JAX
package's products are XLA dots).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

Tensor = torch.Tensor

__all__ = ["fma_chain_product"]

# Kernel launches.
launches = 0

_DTYPES = (torch.float32, torch.float64)


@functools.cache
def _library():
    lib = build.load_library("transform_product")
    lib.transform_product_launch.argtypes = (
        [ctypes.c_void_p] + [ctypes.c_longlong] * 2 + [ctypes.c_void_p]
        + [ctypes.c_longlong] * 2 + [ctypes.c_void_p] + [ctypes.c_int] * 5
        + [ctypes.c_void_p])
    lib.transform_product_launch.restype = ctypes.c_int
    return lib


def fma_chain_product(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of ``[m, K] @ [K, n]`` CUDA tensors of one dtype (float32,
    or float64 with ``K <= 3``), any strides, as a new contiguous
    ``[m, n]`` tensor: one launch of the kernel (built at first use),
    without synchronizing. Raises on anything else."""
    global launches
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"transform product of shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}")
    if a.dtype != b.dtype or a.dtype not in _DTYPES:
        raise TypeError(f"transform product of {a.dtype} and {b.dtype}: "
                        "float32 or float64, both alike")
    if not (a.is_cuda and a.device == b.device):
        raise ValueError(f"transform product of tensors on {a.device} and "
                         f"{b.device}: one CUDA device")
    m, k = a.shape
    n = b.shape[1]
    if a.dtype == torch.float64 and k > 3:
        raise ValueError("a float64 product with K > 3 is not an FMA chain")
    if min(m, k, n) < 1 or m * n >= 2 ** 31:
        raise ValueError(f"transform product of shapes {tuple(a.shape)} and "
                         f"{tuple(b.shape)}: empty or too large")
    out = torch.empty((m, n), dtype=a.dtype, device=a.device)
    err = _library().transform_product_launch(
        a.data_ptr(), a.stride(0), a.stride(1), b.data_ptr(), b.stride(0),
        b.stride(1), out.data_ptr(), m, k, n, int(a.dtype == torch.float64),
        a.device.index or 0, torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"transform product launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return out
