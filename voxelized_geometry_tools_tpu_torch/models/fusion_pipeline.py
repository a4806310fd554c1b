"""End-to-end pipeline: pointclouds -> occupancy -> SDF -> sphere-traced
render, with gradient-based refinement.

Port of ``voxelized_geometry_tools_tpu/models/fusion_pipeline.py``:
:func:`reconstruct` composes the port's carve and fusion filter
(:mod:`..ops.voxelize`, the carve kernel on the card), its exact two-field
EDT (:mod:`..ops.edt`) and its depth render (:mod:`..ops.render`). The
carve and the EDT are data stages (piecewise constant in their inputs);
gradients flow from pixels to the SDF voxel values and the camera pose,
which the fits (:func:`fit_camera_pose`, :func:`fit_voxels`) optimize with
``torch.optim.Adam`` at optax's defaults in place of ``optax.adam``.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Sequence, Tuple

import torch

from ..core import transforms
from ..core.constants import constant
from ..core.maps import OccupancyMap, SignedDistanceField
from ..ops import edt, render, sdf_query, voxelize

Tensor = torch.Tensor


class PipelineOutput(NamedTuple):
    occupancy_map: OccupancyMap
    sdf: SignedDistanceField
    render_result: render.RenderResult


def reconstruct(static_environment: OccupancyMap,
                clouds: Sequence[voxelize.PointCloud],
                camera: render.PinholeCamera,
                filter_options: voxelize.FilterOptions = voxelize.FilterOptions(),
                unknown_is_filled: bool = True,
                num_render_steps: int = 64,
                max_depth: float = 100.0,
                voxelizer=None,
                runtime_log_fn=None) -> PipelineOutput:
    """Full forward pipeline: carve -> fuse -> EDT -> render, on the
    device of ``static_environment``. ``voxelizer`` (one of
    :mod:`..ops.backends`) carves and fuses in place of
    :func:`..ops.voxelize.voxelize_pointclouds`; ``runtime_log_fn`` gets
    its ``VoxelizerRuntime``."""
    if voxelizer is None:
        carved = voxelize.voxelize_pointclouds(
            static_environment, filter_options, list(clouds),
            runtime_log_fn=runtime_log_fn)
    else:
        carved = voxelizer.voxelize_pointclouds(
            static_environment, filter_options, list(clouds),
            runtime_log_fn=runtime_log_fn)
    sdf = edt.extract_sdf_from_occupancy(
        carved.occupancy, carved.spec, carved.origin_transform,
        frame=carved.frame, unknown_is_filled=unknown_is_filled)
    result = render.render_depth(sdf, camera, num_steps=num_render_steps,
                                 max_depth=max_depth)
    return PipelineOutput(carved, sdf, result)


# -- Pose parameterization (se3 tangent) -------------------------------------


def se3_exp(tangent: Tensor) -> Tensor:
    """Differentiable pose chart: the SO(3) exponential of ``(rx, ry, rz)``
    with the translation ``(tx, ty, tz)`` copied raw (an SO(3) x R^3 chart,
    not the full SE(3) exponential; see the JAX package's ``se3_exp``).

    ``R = I + A K + B K^2`` with ``A = sin(t)/t``, ``B = (1-cos(t))/t^2``
    and the double-``where`` Taylor switch near zero, so the Jacobian at the
    identity is finite; ``K @ K`` is :func:`..core.transforms.matmul`, the
    JAX package's bits."""
    rot_vec = tangent[:3]
    trans = tangent[3:]
    dt, dev = tangent.dtype, tangent.device
    theta_sq = torch.sum(rot_vec * rot_vec)
    small = theta_sq < 1e-8
    safe_theta_sq = torch.where(small, constant(1.0, dt, dev), theta_sq)
    safe_theta = torch.sqrt(safe_theta_sq)
    # sin and cos in float64, rounded once: nearer XLA's float32 sin and cos
    # than PyTorch's float32 kernels are.
    wide = safe_theta.double()
    a = torch.where(small, 1.0 - theta_sq / 6.0,
                    torch.sin(wide).to(dt) / safe_theta)
    b = torch.where(small, 0.5 - theta_sq / 24.0,
                    (1.0 - torch.cos(wide).to(dt)) / safe_theta_sq)
    kx, ky, kz = rot_vec[0], rot_vec[1], rot_vec[2]
    zero = torch.zeros((), dtype=dt, device=dev)
    k = torch.stack([
        torch.stack([zero, -kz, ky]),
        torch.stack([kz, zero, -kx]),
        torch.stack([-ky, kx, zero]),
    ])
    rot = (torch.eye(3, dtype=dt, device=dev) + a * k
           + b * transforms.matmul(k, k))
    bottom = constant(((0.0, 0.0, 0.0, 1.0),), dt, dev)
    return torch.cat([torch.cat([rot, trans[:, None]], dim=1), bottom],
                     dim=0)


def perturb_pose(base_pose: Tensor, tangent: Tensor) -> Tensor:
    """Left-compose a tangent perturbation onto a base pose."""
    return transforms.compose(se3_exp(tangent), base_pose)


# -- Differentiable fitting ---------------------------------------------------


def _valid_targets(result: render.RenderResult, target_depth: Tensor,
                   max_depth: float) -> Tensor:
    # target > 0: depth cameras encode missing returns as 0; such pixels
    # must not become hard targets at depth zero.
    return (result.hit & torch.isfinite(target_depth)
            & (target_depth > 0.0) & (target_depth < max_depth))


def _target(target_depth, device) -> Tensor:
    return torch.as_tensor(target_depth, dtype=torch.float32, device=device)


def depth_loss(sdf: SignedDistanceField, camera: render.PinholeCamera,
               target_depth, num_steps: int = 64,
               max_depth: float = 100.0,
               huber_delta: float = 0.1, **render_kwargs) -> Tensor:
    """Masked Huber loss between rendered and target depth: rays that miss
    in either image, and targets that are not finite, not positive or not
    below ``max_depth``, are excluded. The Huber term is optax's, term for
    term: ``q = min(|e|, delta)``, ``0.5 q^2 + delta (|e| - q)``. Extra
    kwargs reach :func:`..ops.render.render_depth` (``remat=True``, a
    prebuilt ``corner_table``)."""
    result = render.render_depth(sdf, camera, num_steps=num_steps,
                                 max_depth=max_depth, **render_kwargs)
    target = _target(target_depth, result.depth.device)
    valid = _valid_targets(result, target, max_depth)
    err = torch.where(valid, result.depth - target,
                      torch.zeros_like(result.depth))
    abs_err = torch.abs(err)
    quadratic = torch.clamp(abs_err, max=huber_delta)
    loss = 0.5 * (quadratic * quadratic) + huber_delta * (abs_err - quadratic)
    return torch.sum(loss) / torch.clamp(torch.sum(valid), min=1)


@dataclasses.dataclass
class PoseFitResult:
    pose: Tensor
    tangent: Tensor
    losses: Tensor
    # Fraction of rays hitting in BOTH rendered and target images at the
    # final pose; ~0 means the fit never engaged (see fit_camera_pose).
    valid_fraction: float = float("nan")


def _adam(params, learning_rate: float) -> torch.optim.Adam:
    """``optax.adam(learning_rate)``'s defaults."""
    return torch.optim.Adam(params, lr=learning_rate, betas=(0.9, 0.999),
                            eps=1e-8, foreach=False)


def fit_camera_pose(sdf: SignedDistanceField,
                    base_camera: render.PinholeCamera,
                    target_depth, num_iters: int = 100,
                    learning_rate: float = 1e-2, num_steps: int = 48,
                    max_depth: float = 100.0,
                    **render_kwargs) -> PoseFitResult:
    """Gradient-descent camera pose fit against a target depth image: pixel
    gradients flow through sphere tracing into the se3 tangent, which Adam
    moves from zero. Extra kwargs reach :func:`..ops.render.render_depth`
    (``remat=True`` bounds backward-pass memory for full-frame fits).
    ``valid_fraction`` is the final pose's share of rays valid in both
    images: with none, the loss and its gradient are exactly zero and the
    fit silently no-ops."""
    base_pose = base_camera.pose
    target = _target(target_depth, base_pose.device)
    tangent = torch.zeros(6, dtype=torch.float32, device=base_pose.device,
                          requires_grad=True)
    optimizer = _adam([tangent], learning_rate)
    losses = []
    for _ in range(num_iters):
        optimizer.zero_grad(set_to_none=True)
        cam = dataclasses.replace(base_camera,
                                  pose=perturb_pose(base_pose, tangent))
        loss = depth_loss(sdf, cam, target, num_steps=num_steps,
                          max_depth=max_depth, **render_kwargs)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    with torch.no_grad():
        tangent = tangent.detach()
        pose = perturb_pose(base_pose, tangent)
        res = render.render_depth(sdf, dataclasses.replace(base_camera,
                                                           pose=pose),
                                  num_steps=num_steps, max_depth=max_depth,
                                  **render_kwargs)
        valid = _valid_targets(res, target, max_depth)
    return PoseFitResult(
        pose=pose, tangent=tangent,
        losses=torch.stack(losses),
        valid_fraction=float(valid.float().mean()))


def fit_voxels(sdf: SignedDistanceField,
               cameras: Sequence[render.PinholeCamera],
               target_depths, num_iters: int = 50,
               learning_rate: float = 0.05, num_steps: int = 48,
               max_depth: float = 100.0,
               smoothness_weight: float = 0.1,
               **render_kwargs) -> Tuple[SignedDistanceField, Tensor]:
    """Optimize the SDF voxel grid against target depth images (multi-view
    voxel refinement: pixel-to-voxel gradients with a TV smoothness prior).
    Returns the refined (re-locked) SDF and the loss history. Extra kwargs
    reach :func:`..ops.render.render_depth`. A ``corner_table`` kwarg is a
    request for the table path: a table of the same type (``CornerTable``
    or ``CornerPairTable``) is rebuilt from the current distances in each
    loss evaluation, since a prebuilt table bakes the original values and
    would give the data term no voxel gradient.

    Gradient updates do not keep the 1-Lipschitz property: render the
    refined field without certified acceleration, or re-extract an exact
    SDF from its sign, before relying on certified skips."""
    if not cameras:
        raise ValueError("fit_voxels needs at least one camera")
    if len(cameras) != len(target_depths):
        raise ValueError(
            f"{len(cameras)} cameras but {len(target_depths)} target "
            "depth images")
    render_kwargs = dict(render_kwargs)
    table_proto = render_kwargs.pop("corner_table", None)
    dev = sdf.distances.device
    targets = [_target(t, dev) for t in target_depths]

    def loss_fn(distances):
        cur = sdf.replace(distances=distances)
        kw = dict(render_kwargs)
        if table_proto is not None:
            build = (sdf_query.build_corner_pair_table
                     if isinstance(table_proto, sdf_query.CornerPairTable)
                     else sdf_query.build_corner_table)
            kw["corner_table"] = build(cur)
        loss = 0.0
        for cam, target in zip(cameras, targets):
            loss = loss + depth_loss(cur, cam, target, num_steps=num_steps,
                                     max_depth=max_depth, **kw)
        tv = (torch.mean(torch.abs(torch.diff(distances, dim=0)))
              + torch.mean(torch.abs(torch.diff(distances, dim=1)))
              + torch.mean(torch.abs(torch.diff(distances, dim=2))))
        return loss / len(cameras) + smoothness_weight * tv

    distances = sdf.distances.detach().clone().requires_grad_(True)
    optimizer = _adam([distances], learning_rate)
    losses = []
    for _ in range(num_iters):
        optimizer.zero_grad(set_to_none=True)
        loss = loss_fn(distances)
        loss.backward()
        optimizer.step()
        losses.append(loss.detach())
    refined = sdf.replace(distances=distances.detach()).lock()
    return refined, torch.stack(losses)
