"""The ``voxelizer`` loop kind: the best available voxelizer over a
running occupancy, then the EDT.

Loaded by path by ``registry.loop("voxelizer")``; ``LOOP`` is the class
the harness builds for a traffic mix whose ``"loop"`` is ``"voxelizer"``.
"""

from __future__ import annotations

from torch import Tensor

from portbench.loops import MappingLoop


class VoxelizerLoop(MappingLoop):
    """The best available voxelizer's ``voxelize_pointclouds`` over the
    running occupancy, then ``extract_sdf_from_occupancy``, each frame."""

    def _build(self) -> None:
        from voxelized_geometry_tools_tpu_torch.core.maps import OccupancyMap
        from voxelized_geometry_tools_tpu_torch.ops import backends
        if self.device.type == "cuda":
            self.voxelizer = \
                backends.make_best_available_pointcloud_voxelizer()
        else:
            self.voxelizer = backends.AcceleratorPointCloudVoxelizer(
                device=self.device)
        self.env = OccupancyMap.create(self.spec, device=self.device)

    def occupancy(self) -> Tensor:
        return self.env.occupancy

    def _frame(self, frame, spans, traced):
        from voxelized_geometry_tools_tpu_torch.ops import edt
        clouds = self._clouds(frame)

        def log(runtime):
            spans.add("carve", runtime.raycasting_time)
            spans.add("filter", runtime.filtering_time)

        with spans.span("fuse", traced):
            self.env = self.voxelizer.voxelize_pointclouds(
                self.env, self.options, clouds, runtime_log_fn=log)
        with spans.span("sdf", traced):
            sdf = edt.extract_sdf_from_occupancy(
                self.env.occupancy, self.spec, self.env.origin_transform,
                unknown_is_filled=self.traffic["unknown_is_filled"])
        return sdf.distances

    def _release(self) -> None:
        self.env = self.voxelizer = None


LOOP = VoxelizerLoop
