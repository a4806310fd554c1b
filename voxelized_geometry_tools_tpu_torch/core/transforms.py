"""Rigid-body (isometry) transform utilities on ``[4, 4]`` tensors.

Port of ``voxelized_geometry_tools_tpu/core/transforms.py`` (the subset the
main path uses). An isometry is a plain row-major ``[4, 4]`` tensor; every
helper keeps the dtype and device of its input.
"""

from __future__ import annotations

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


def invert_isometry(m: Tensor) -> Tensor:
    """Exact inverse of an isometry: ``[R^T, -R^T t]`` (differentiable)."""
    rt = m[:3, :3].T
    t = -rotate_vector(rt, m[:3, 3])
    bottom = constant(((0.0, 0.0, 0.0, 1.0),), m.dtype, m.device)
    return torch.cat([torch.cat([rt, t[:, None]], dim=1), bottom], dim=0)


def compose(a: Tensor, b: Tensor) -> Tensor:
    """The product ``a @ b`` of two ``[4, 4]`` transforms, written as sums
    of products in ``k`` order (no matmul, whose order of sums is the
    library's)."""
    out = a[:, :1] * b[:1, :]
    for k in range(1, 4):
        out = out + a[:, k:k + 1] * b[k:k + 1, :]
    return out


def rotate_vector(m: Tensor, vectors: Tensor) -> Tensor:
    """Apply only the rotation part to vector(s) of shape ``[..., 3]``.

    Written elementwise, in the same operation order as the JAX package, so
    that the two agree bit for bit on the CPU (a matmul would sum in another
    order)."""
    x, y, z = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    return torch.stack([
        x * m[0, 0] + y * m[0, 1] + z * m[0, 2],
        x * m[1, 0] + y * m[1, 1] + z * m[1, 2],
        x * m[2, 0] + y * m[2, 1] + z * m[2, 2],
    ], dim=-1)


def apply_isometry(m: Tensor, points: Tensor) -> Tensor:
    """Apply an isometry to point(s) of shape ``[..., 3]``."""
    return rotate_vector(m, points) + m[:3, 3]
