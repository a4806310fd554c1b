"""Rigid-body (isometry) transform utilities on ``[4, 4]`` tensors.

Port of ``voxelized_geometry_tools_tpu/core/transforms.py`` (the subset the
main path uses). An isometry is a plain row-major ``[4, 4]`` tensor; every
helper keeps the dtype and device of its input.

The JAX package forms its transform products (``compose``, the inverse's
``-R^T t``) as XLA dots. In float32, XLA's CPU dot computes each element
as a fused multiply-add chain in ``k`` order, ``fma(a3, b3, fma(a2, b2,
fma(a1, b1, a0 b0)))``, jitted or op by op. In float64 (checked against
exact ``fractions.Fraction`` chains on random products) it is that chain
where ``K <= 3`` (the inverse's ``-R^T t``, 3x3 products), but a 4x4
product such as ``compose`` rounds each product and sums them in ``k``
order; a float64 ``K = 4`` product with an odd column count (a 4x4 matrix
times a vector) is neither, and is not formed by the port. :func:`matmul`
reproduces each of these bit for bit, whatever the device (see
:func:`_fma_chain` and :func:`_fma_chain_f64`), so grid-frame transforms,
and every carve and query built on them, get the JAX package's bits.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from .constants import constant
from .device import default_device

Tensor = torch.Tensor


def identity_isometry(dtype=torch.float32, device=None) -> Tensor:
    """On ``device``; None means the CUDA card."""
    return torch.eye(4, dtype=dtype, device=default_device(device))


def isometry_from_translation(translation, dtype=torch.float32,
                              device=None) -> Tensor:
    """Isometry that is a pure translation, on ``device`` (None: the
    translation's device if it is a tensor, else the CUDA card)."""
    device = default_device(device, like=translation)
    m = torch.eye(4, dtype=dtype, device=device)
    m[:3, 3] = torch.as_tensor(translation, dtype=dtype, device=device)
    return m


def _fma_chain(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` of float32 ``[m, K] @ [K, n]`` arrays as XLA's FMA chain:
    ``k = 0`` rounded on its own, then each ``fma(a_k, b_k, acc)``
    correctly rounded, from float64 operations that are exact IEEE: the
    float64 product of two floats is exact; the float64 sum ``s = p + c``
    is made round-to-odd (TwoSum's error ``e`` says where the exact sum
    lies; an even ``s`` with ``e != 0`` moves one ulp toward it), and
    round-to-odd to 53 bits then round-to-nearest to 24 bits is the
    correctly rounded 24-bit sum."""
    a64, b64 = a.astype(np.float64), b.astype(np.float64)
    out = a[:, :1] * b[:1, :]
    with np.errstate(all="ignore"):
        for k in range(1, a.shape[1]):
            p = a64[:, k:k + 1] * b64[k:k + 1, :]
            c = out.astype(np.float64)
            s = p + c
            bb = s - p
            e = (p - (s - bb)) + (c - bb)
            bump = (e != 0) & np.isfinite(e) & ((s.view(np.int64) & 1) == 0)
            s = np.where(bump, np.nextafter(s, np.copysign(np.inf, e)), s)
            out = s.astype(np.float32)
    return out


def _fma_chain_f64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """``a @ b`` of float64 ``[m, K] @ [K, n]`` arrays as an FMA chain in
    ``k`` order: each step is formed exactly as a ``Fraction`` and rounded
    once (``int / int`` is correctly rounded in Python). Elements with a
    non-finite operand take the rounded chain, which gives the same
    infinities and NaNs."""
    with np.errstate(all="ignore"):
        out = a[:, :1] * b[:1, :]
    for i in range(a.shape[0]):
        for j in range(b.shape[1]):
            col = b[:, j]
            if not (np.isfinite(a[i]).all() and np.isfinite(col).all()):
                acc = out[i, j]
                with np.errstate(all="ignore"):
                    for k in range(1, a.shape[1]):
                        acc = acc + a[i, k] * col[k]
                out[i, j] = acc
                continue
            acc = float(out[i, j])
            for k in range(1, a.shape[1]):
                acc = float(Fraction(float(a[i, k])) * Fraction(float(col[k]))
                            + Fraction(acc))
            out[i, j] = acc
    return out


def _product(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for ``[m, K] @ [K, n]``, formed on the host (a 4x4 chain
    is some 140 elementwise operations, each a kernel launch on a card,
    about 3 ms of host time; the copy to the host waits for the card once):
    in float32 the FMA chain of :func:`_fma_chain`; in float64 with
    ``K <= 3`` the FMA chain of :func:`_fma_chain_f64`. Otherwise the
    products are rounded, then summed in ``k`` order."""
    if a.dtype == b.dtype == torch.float32:
        out = _fma_chain(a.detach().cpu().numpy(), b.detach().cpu().numpy())
        return torch.from_numpy(out).to(a.device)
    if a.dtype == b.dtype == torch.float64 and a.shape[1] <= 3:
        out = _fma_chain_f64(a.detach().cpu().numpy(),
                             b.detach().cpu().numpy())
        return torch.from_numpy(out).to(a.device)
    out = a[:, :1] * b[:1, :]
    for k in range(1, a.shape[1]):
        out = out + a[:, k:k + 1] * b[k:k + 1, :]
    return out


class _Matmul(torch.autograd.Function):
    """The forward is :func:`_product`; the backward is the matmul's
    gradient."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _product(a, b)

    @staticmethod
    def backward(ctx, grad):
        a, b = ctx.saved_tensors
        grad_a = grad @ b.T if ctx.needs_input_grad[0] else None
        grad_b = a.T @ grad if ctx.needs_input_grad[1] else None
        return grad_a, grad_b


def matmul(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` of two matrices (or a matrix and a vector) with the JAX
    package's bits on the CPU, exact on every device: in float32, and in
    float64 up to ``K = 3``, each element is the fused multiply-add chain
    of XLA's dot; a float64 4x4 product sums rounded products in ``k``
    order, as XLA's does. Differentiable."""
    if b.dim() == 1:
        return _Matmul.apply(a, b[:, None])[:, 0]
    return _Matmul.apply(a, b)


def invert_isometry(m: Tensor) -> Tensor:
    """Exact inverse of an isometry: ``[R^T, -R^T t]``, with ``-R^T t``
    formed as the JAX package forms it, ``(-R^T) @ t`` (differentiable)."""
    rt = m[:3, :3].T
    t = matmul(-rt, m[:3, 3])
    bottom = constant(((0.0, 0.0, 0.0, 1.0),), m.dtype, m.device)
    return torch.cat([torch.cat([rt, t[:, None]], dim=1), bottom], dim=0)


def compose(a: Tensor, b: Tensor) -> Tensor:
    """The product ``a @ b`` of two ``[4, 4]`` transforms (:func:`matmul`)."""
    return matmul(a, b)


def rotate_vector(m: Tensor, vectors: Tensor) -> Tensor:
    """Apply only the rotation part to vector(s) of shape ``[..., 3]``.

    Written elementwise, in the same operation order as the JAX package, so
    that the two agree bit for bit on the CPU (a matmul would sum in another
    order). Mixed dtypes are promoted first, as JAX promotes them."""
    dt = torch.promote_types(m.dtype, vectors.dtype)
    m, vectors = m.to(dt), vectors.to(dt)
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    return torch.stack([
        x * m[0, 0] + y * m[0, 1] + z * m[0, 2],
        x * m[1, 0] + y * m[1, 1] + z * m[1, 2],
        x * m[2, 0] + y * m[2, 1] + z * m[2, 2],
    ], dim=-1)


def apply_isometry(m: Tensor, points: Tensor) -> Tensor:
    """Apply an isometry to point(s) of shape ``[..., 3]``."""
    return rotate_vector(m, points) + m[:3, 3]
