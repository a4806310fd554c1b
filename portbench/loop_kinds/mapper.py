"""The ``mapper`` loop kind: one mapping node through ``OnlineMapper``.

Loaded by path by ``registry.loop("mapper")``; ``LOOP`` is the class the
harness builds for a traffic mix whose ``"loop"`` is ``"mapper"``.
"""

from __future__ import annotations

from torch import Tensor

from portbench.loops import MappingLoop


class MapperLoop(MappingLoop):
    """``OnlineMapper.integrate`` then ``OnlineMapper.sdf()`` each frame."""

    def _build(self) -> None:
        from voxelized_geometry_tools_tpu_torch.models.online_mapper import \
            OnlineMapper
        self.mapper = OnlineMapper(self.spec, filter_options=self.options,
                                   device=self.device)

    def occupancy(self) -> Tensor:
        return self.mapper.occupancy_map.occupancy

    def _frame(self, frame, spans, traced):
        (cloud,) = self._clouds(frame)
        with spans.span("fuse", traced):
            self.mapper.integrate(cloud)
        with spans.span("sdf", traced):
            sdf = self.mapper.sdf(
                unknown_is_filled=self.traffic["unknown_is_filled"])
        return sdf.distances

    def _release(self) -> None:
        self.mapper = None


LOOP = MapperLoop
