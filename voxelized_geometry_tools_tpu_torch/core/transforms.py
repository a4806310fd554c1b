"""Rigid-body (isometry) transform utilities on ``[4, 4]`` tensors.

Port of ``voxelized_geometry_tools_tpu/core/transforms.py``. An isometry is
a plain row-major ``[4, 4]`` tensor; every helper keeps the dtype and device
of its input. The pose helpers that work on the host
(:func:`rotation_matrix_to_quaternion`, :func:`isometry_to_pose`,
:func:`np_isometry_from_translation`) take and return numpy arrays, as in
the JAX package.

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
:func:`_fma_chain` and :func:`_fma_chain_f64`; on a CUDA card the chains
are one launch of the transform product kernel,
``kernels/transform_product.py``), so grid-frame transforms, and every
carve and query built on them, get the JAX package's bits.
"""

from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from ..kernels import transform_product
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


def isometry_from_rotation_translation(rotation, translation,
                                       dtype=torch.float32,
                                       device=None) -> Tensor:
    """Isometry from a ``[3, 3]`` rotation and a translation, on ``device``
    (None: the rotation's device if it is a tensor, else the CUDA card)."""
    device = default_device(device, like=rotation)
    m = torch.eye(4, dtype=dtype, device=device)
    m[:3, :3] = torch.as_tensor(rotation, dtype=dtype, device=device)
    m[:3, 3] = torch.as_tensor(translation, dtype=dtype, device=device)
    return m


def fma32(a: Tensor, b: Tensor, c: Tensor) -> Tensor:
    """The correctly rounded float32 ``fma(a, b, c)`` of float32 tensors,
    from exact float64 operations on their device, as :func:`_fma_chain`
    forms each step: the float64 product is exact, the float64 sum is made
    round-to-odd from TwoSum's error, then rounded once to float32."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    e = (p - (s - bb)) + (c64 - bb)
    even = (s.contiguous().view(torch.int64) & 1) == 0
    bump = (e != 0) & torch.isfinite(e) & even
    toward = torch.copysign(torch.full_like(s, float("inf")), e)
    return torch.where(bump, torch.nextafter(s, toward), s).float()


def norm_fma(v: Tensor) -> Tensor:
    """Euclidean norm over the last axis as XLA's compiled reduction forms
    it in float32, ``sqrt(fma(v2, v2, fma(v1, v1, v0 * v0)))`` (correctly
    rounded sqrt); other dtypes square and sum in axis order."""
    from ..ops.edt import _sqrt
    if v.dtype != torch.float32:
        acc = v[..., 0] * v[..., 0]
        for k in range(1, v.shape[-1]):
            acc = acc + v[..., k] * v[..., k]
        return _sqrt(acc, v.dtype)
    acc = v[..., 0] * v[..., 0]
    for k in range(1, v.shape[-1]):
        acc = fma32(v[..., k], v[..., k], acc)
    return _sqrt(acc, torch.float32)


def quaternion_to_rotation_matrix(quaternion) -> Tensor:
    """Rotation matrix from quaternion ``(w, x, y, z)`` (Eigen order), on
    the quaternion's device (host data: the CUDA card). The quaternion is
    normalized first."""
    q = torch.as_tensor(quaternion, device=default_device(like=quaternion))
    if not q.is_floating_point():
        q = q.float()
    q = q / norm_fma(q)
    w, x, y, z = q[0], q[1], q[2], q[3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)]),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)]),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)]),
    ])


def isometry_from_quaternion_translation(quaternion, translation,
                                         dtype=torch.float32,
                                         device=None) -> Tensor:
    """Isometry from a quaternion ``(w, x, y, z)`` and a translation, on
    ``device`` (None: the quaternion's device if it is a tensor, else the
    CUDA card)."""
    device = default_device(device, like=quaternion)
    rot = quaternion_to_rotation_matrix(
        torch.as_tensor(quaternion, dtype=dtype, device=device))
    return isometry_from_rotation_translation(rot, translation, dtype=dtype,
                                              device=device)


def _host64(m) -> np.ndarray:
    if isinstance(m, Tensor):
        return m.detach().cpu().double().numpy()
    return np.asarray(m, np.float64)


def rotation_matrix_to_quaternion(rotation) -> np.ndarray:
    """Quaternion ``(w, x, y, z)`` from a rotation matrix, on the host
    (Shepperd's branch selection). Inverse of
    :func:`quaternion_to_rotation_matrix`; gives the translation +
    quaternion pose of ``geometry_msgs::Pose``."""
    m = _host64(rotation)[:3, :3]
    # A reflection (det < 0), scaled or NaN matrix would give a wrong (or
    # NaN) quaternion.
    if not np.isfinite(m).all() or not np.allclose(
            m @ m.T, np.eye(3), atol=1e-5) or np.linalg.det(m) < 0.0:
        raise ValueError("not a proper rotation matrix")
    t = np.trace(m)
    if t > 0:
        r = np.sqrt(1.0 + t)
        w = 0.5 * r
        s = 0.5 / r
        q = np.array([w, (m[2, 1] - m[1, 2]) * s, (m[0, 2] - m[2, 0]) * s,
                      (m[1, 0] - m[0, 1]) * s])
    else:
        i = int(np.argmax(np.diag(m)))
        j, k = (i + 1) % 3, (i + 2) % 3
        r = np.sqrt(1.0 + m[i, i] - m[j, j] - m[k, k])
        s = 0.5 / r
        q = np.zeros(4)
        q[0] = (m[k, j] - m[j, k]) * s
        q[1 + i] = 0.5 * r
        q[1 + j] = (m[j, i] + m[i, j]) * s
        q[1 + k] = (m[k, i] + m[i, k]) * s
    return q / np.linalg.norm(q)


def isometry_to_pose(m) -> tuple:
    """Split a ``[4, 4]`` isometry into ``(translation[3], quaternion_wxyz
    [4])`` numpy arrays, the payload of ``geometry_msgs::Pose``."""
    m = _host64(m)
    return m[:3, 3].copy(), rotation_matrix_to_quaternion(m)


def isometry_from_axis_angle(axis, angle, dtype=torch.float32,
                             device=None) -> Tensor:
    """Rotation-only isometry from an axis-angle (Rodrigues), on ``device``
    (None: the axis's device if it is a tensor, else the CUDA card)."""
    device = default_device(device, like=axis)
    axis = torch.as_tensor(axis, dtype=dtype, device=device)
    axis = axis / norm_fma(axis)
    a = torch.as_tensor(angle, dtype=dtype, device=device)
    kx, ky, kz = axis[0], axis[1], axis[2]
    zero = torch.zeros((), dtype=dtype, device=device)
    k = torch.stack([
        torch.stack([zero, -kz, ky]),
        torch.stack([kz, zero, -kx]),
        torch.stack([-ky, kx, zero]),
    ])
    rot = (torch.eye(3, dtype=dtype, device=device) + torch.sin(a) * k
           + (1.0 - torch.cos(a)) * matmul(k, k))
    return isometry_from_rotation_translation(
        rot, torch.zeros(3, dtype=dtype, device=device), dtype=dtype,
        device=device)


def np_isometry_from_translation(translation, dtype=np.float32) -> np.ndarray:
    m = np.eye(4, dtype=dtype)
    m[:3, 3] = np.asarray(translation, dtype=dtype)
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
    """``a @ b`` for ``[m, K] @ [K, n]``: in float32 the FMA chain of
    :func:`_fma_chain`; in float64 with ``K <= 3`` the FMA chain of
    :func:`_fma_chain_f64`. Otherwise the products are rounded, then
    summed in ``k`` order. A chain of two tensors on one CUDA device is
    one launch of the transform product kernel, with no host copy; other
    chains are formed on the host (on a card as elementwise operations a
    4x4 chain would be some 140 launches)."""
    chain = (a.dtype == b.dtype == torch.float32
             or (a.dtype == b.dtype == torch.float64 and a.shape[1] <= 3))
    if chain and a.is_cuda and a.device == b.device:
        return transform_product.fma_chain_product(a.detach(), b.detach())
    if chain:
        return _chain_on_host(a, b)
    out = a[:, :1] * b[:1, :]
    for k in range(1, a.shape[1]):
        out = out + a[:, k:k + 1] * b[k:k + 1, :]
    return out


def _chain_on_host(a: Tensor, b: Tensor) -> Tensor:
    """The FMA chain of :func:`_product` formed in numpy on the host, on
    ``a``'s device (the transform product kernel's plain version)."""
    chain = _fma_chain if a.dtype == torch.float32 else _fma_chain_f64
    out = chain(a.detach().cpu().numpy(), b.detach().cpu().numpy())
    return torch.from_numpy(out).to(a.device)


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
