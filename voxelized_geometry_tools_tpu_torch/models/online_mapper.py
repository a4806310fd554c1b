"""Incremental online mapping: stream depth frames into a live map + SDF.

Port of ``voxelized_geometry_tools_tpu/models/online_mapper.py``. Each
sensor frame is carved into the current occupancy map (the running map is
the static environment of ``CountsSeenAs`` fusion, so filled cells latch),
and consumers query the refreshed SDF:

* the occupancy lives on the mapper's device between frames;
* ``integrate_frames`` folds a recorded sequence frame by frame, the loop
  that the JAX package's ``lax.scan`` compiles (same uniform-shape rule);
* the SDF is recomputed lazily and cached until the next integration;
* ``localize`` fits a camera pose against the live SDF through the
  differentiable renderer.

The carve route depends on the device. On the CPU the mapper carves as the
JAX package does: the column carve on the run axis (picked from the first
frame's dominant ray direction unless given), or the voxel walk for
``carve_run_axis=-1``. On the CUDA card it always carves with
:func:`..ops.voxelize.raycast_pointcloud`, whose ``"auto"`` backend there is
the tiled carve kernel: the port's column carve is plain PyTorch, many
times slower on the card, and both carves give the same bits. A kernel that
fails to build or launch raises; nothing falls back.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from ..core.grid import GridSpec
from ..core.maps import OccupancyMap, SignedDistanceField
from ..ops import edt, render, voxelize

Tensor = torch.Tensor


class OnlineMapper:
    """Streaming occupancy mapper with a lazily refreshed SDF."""

    def __init__(self, spec: GridSpec, origin_transform=None,
                 frame: str = "world",
                 filter_options: voxelize.FilterOptions =
                 voxelize.FilterOptions(),
                 max_steps: Optional[int] = None,
                 carve_run_axis: Optional[int] = None,
                 device=None):
        """``carve_run_axis``: grid axis of the CPU's column carve; by
        default the first integrated cloud's dominant ray axis (a mapper's
        camera orientation is stable across frames); ``-1`` forces the
        voxel walk. ``device``: where the map lives (None: the CUDA
        card); clouds must lie there too."""
        filter_options.validate()
        self._map = OccupancyMap.create(spec, origin_transform, frame,
                                        device=device)
        self._options = filter_options
        self._max_steps = max_steps
        self._run_axis = carve_run_axis
        self._sdf_cache = {}
        self._frames_integrated = 0

    # -- state ------------------------------------------------------------

    @property
    def occupancy_map(self) -> OccupancyMap:
        return self._map

    @property
    def frames_integrated(self) -> int:
        return self._frames_integrated

    # -- integration --------------------------------------------------------

    def _resolve_run_axis(self, cloud: voxelize.PointCloud):
        if self._run_axis is None:
            self._run_axis = voxelize.dominant_ray_axis(
                cloud, self._map.origin_transform)

    def _integrate_one(self, occupancy: Tensor,
                       cloud: voxelize.PointCloud) -> Tensor:
        spec, origin = self._map.spec, self._map.origin_transform
        if cloud.points.device != occupancy.device:
            raise ValueError(f"a cloud lies on {cloud.points.device}, the "
                             f"map on {occupancy.device}")
        if occupancy.device.type == "cuda" or self._run_axis < 0:
            grid = voxelize.raycast_pointcloud(spec, origin, cloud,
                                               self._max_steps)
        else:
            grid = voxelize.raycast_pointcloud_columns(
                spec, origin, cloud, self._max_steps,
                run_axis=self._run_axis)
        return voxelize.combine_and_filter(
            self._options, grid.seen_free[None], grid.seen_filled[None],
            occupancy)

    def _set_occupancy(self, occupancy: Tensor, frames: int) -> OccupancyMap:
        self._map = self._map.replace(occupancy=occupancy)
        self._sdf_cache.clear()
        self._frames_integrated += frames
        return self._map

    def integrate(self, cloud: voxelize.PointCloud) -> OccupancyMap:
        """Carve one depth frame into the running map (filled cells latch,
        per the ``CountsSeenAs`` fuse over the current occupancy)."""
        self._resolve_run_axis(cloud)
        return self._set_occupancy(
            self._integrate_one(self._map.occupancy, cloud), 1)

    def integrate_frames(self, clouds: Sequence[voxelize.PointCloud]
                         ) -> OccupancyMap:
        """Fold a recorded sequence, the fused occupancy carried from frame
        to frame; the same bits as integrating the frames one at a time.
        All clouds must share a point count (depth cameras do), as the JAX
        package's stacked fold needs."""
        if not clouds:
            return self._map
        shapes = {tuple(c.points.shape) for c in clouds}
        if len(shapes) != 1:
            raise ValueError(
                f"integrate_frames needs uniform cloud shapes, got {shapes}")
        self._resolve_run_axis(clouds[0])
        occ = self._map.occupancy
        for cloud in clouds:
            occ = self._integrate_one(occ, cloud)
        return self._set_occupancy(occ, len(clouds))

    # -- derived products ----------------------------------------------------

    def sdf(self, unknown_is_filled: bool = True,
            add_virtual_border: bool = False) -> SignedDistanceField:
        """Current SDF; cached until the next integration."""
        key = (unknown_is_filled, add_virtual_border)
        cached = self._sdf_cache.get(key)
        if cached is None:
            cached = edt.extract_sdf_from_occupancy(
                self._map.occupancy, self._map.spec,
                self._map.origin_transform, frame=self._map.frame,
                unknown_is_filled=unknown_is_filled,
                add_virtual_border=add_virtual_border)
            self._sdf_cache[key] = cached
        return cached

    def render_depth(self, camera: render.PinholeCamera,
                     **kwargs) -> render.RenderResult:
        """Render the live map's SDF from a camera."""
        return render.render_depth(self.sdf(), camera, **kwargs)

    def extract_mesh(self, level: float = 0.0,
                     max_triangles: int = 1 << 18, frame: str = "world"):
        raise NotImplementedError(
            "OnlineMapper.extract_mesh is not ported yet (ROADMAP.md queue 1 "
            "item 10: ops/isosurface.py)")

    def localize(self, camera_guess: render.PinholeCamera, target_depth,
                 num_iters: int = 50, learning_rate: float = 0.01,
                 **render_kwargs):
        """Refine a camera pose against an observed depth image by
        render-and-compare on the live SDF
        (:func:`.fusion_pipeline.fit_camera_pose`)."""
        from .fusion_pipeline import fit_camera_pose
        return fit_camera_pose(self.sdf(), camera_guess, target_depth,
                               num_iters=num_iters,
                               learning_rate=learning_rate, **render_kwargs)
