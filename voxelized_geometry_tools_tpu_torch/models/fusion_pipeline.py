"""End-to-end pipeline: pointclouds -> occupancy -> SDF -> sphere-traced
render.

Port of ``voxelized_geometry_tools_tpu/models/fusion_pipeline.py``:
:func:`reconstruct` composes the port's carve and fusion filter
(:mod:`..ops.voxelize`, the carve kernel on the card), its exact two-field
EDT (:mod:`..ops.edt`) and its depth render (:mod:`..ops.render`). The
carve and the EDT are data stages (piecewise constant in their inputs);
gradients flow from pixels to the SDF voxel values and the camera pose.

The pose and voxel fits (``se3_exp``, ``perturb_pose``, ``depth_loss``,
``PoseFitResult``, ``fit_camera_pose``, ``fit_voxels``) are not ported yet
(ROADMAP queue 1, item 9): they need ``CornerPairTable`` (item 5c) and
``torch.optim`` in place of optax, and raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

from ..core.maps import OccupancyMap, SignedDistanceField
from ..ops import edt, render, voxelize


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


def _todo(name: str):
    return NotImplementedError(
        f"{name} is not ported yet (ROADMAP queue 1, item 9: it needs "
        "CornerPairTable, item 5c, and torch.optim in place of optax)")


def se3_exp(tangent):
    raise _todo("se3_exp")


def perturb_pose(base_pose, tangent):
    raise _todo("perturb_pose")


def depth_loss(sdf, camera, target_depth, num_steps: int = 64,
               max_depth: float = 100.0, huber_delta: float = 0.1,
               **render_kwargs):
    raise _todo("depth_loss")


class PoseFitResult:
    def __init__(self, *args, **kwargs):
        raise _todo("PoseFitResult")


def fit_camera_pose(sdf, base_camera, target_depth, num_iters: int = 100,
                    learning_rate: float = 1e-2, num_steps: int = 48,
                    max_depth: float = 100.0, **render_kwargs):
    raise _todo("fit_camera_pose")


def fit_voxels(sdf, cameras, target_depths, num_iters: int = 50,
               learning_rate: float = 0.05, num_steps: int = 48,
               max_depth: float = 100.0, smoothness_weight: float = 0.1,
               **render_kwargs):
    raise _todo("fit_voxels")
