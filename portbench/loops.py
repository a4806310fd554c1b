"""The loop contract, and the code that the mapping loop kinds share.

A traffic mix names the kind of loop it drives (``"loop"``); the harness
loads that kind from ``portbench/loop_kinds/<kind>.py`` by path
(``registry.loop``), as it loads a metric's reader, and builds the file's
``LOOP`` class. ``Loop`` below is the contract every such class keeps.

A loop builds its inputs from the seed in ``setup``, runs one request per
``step`` (a sensor frame, from the host tensors a camera node hands to the
synchronized result), keeps the program's outputs of a few requests drawn
from the seed, and after the window compares them with the plain
reference in ``check``. The harness times the steps; a loop only says
what it compared.

Mapping loops check three frames: the set-up's first, which starts from
a fresh map; one of the window's first ``check_within`` frames; and the
first frame to start once a share of the window drawn from the seed
(``late_share``) has passed, which meets the state of a long run. For each
they copy to the host the program's occupancy before the frame (the
running state it starts from), its occupancy after it and its SDF. The
copies are made between frames, outside every frame's latency, so the
card holds nothing for the check and the window's peak memory is the
deployment's own: the program's state and temporaries, and the newest
SDF, which a mapping node holds for its planners until the next one
replaces it.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from . import scenes
from .reference import carve as ref_carve
from .reference import edt as ref_edt
from .reference import fusion as ref_fusion
from .tracing import Spans

Tensor = torch.Tensor


def _host(t: Tensor) -> Tensor:
    return t.detach().to("cpu", copy=True)


def _pinned_like(t: Tensor) -> Tensor:
    return torch.empty(t.shape, dtype=t.dtype,
                       pin_memory=t.device.type == "cuda")


@dataclasses.dataclass
class Sample:
    frame: int                # index into the run's frames
    before: Optional[Tensor]  # program occupancy the frame started from
    after: Tensor             # program occupancy after the frame
    sdf: Tensor               # program SDF after the frame
    # All on the host; ``before`` is None for the fresh map.


class Loop:
    """What the harness calls on a loop kind's ``LOOP``, in this order:

    * ``LOOP(config, traffic, seed, device)``: the cell's configuration and
      traffic mix as dicts, the run's seed, the device; nothing runs yet.
    * ``setup()``: the inputs, from the seed, and the program's state.
    * ``warm_up(spans)``: every shape the window uses, through the
      window's own call. Set-up ends when it returns.
    * For each window request ``i`` (0-based): ``before_step(i, elapsed_s,
      seconds)``, outside its latency (``elapsed_s`` since the window
      opened, of ``seconds``); ``step(i, spans, traced)``, its latency,
      which the harness ends with a synchronize; ``after_step(i)``,
      outside its latency. ``spans`` is the run's ``tracing.Spans``;
      ``traced`` says whether the run is traced.
    * ``end_window()``: once the window's peak memory is read; drops the
      program's state.
    * ``check(control=None)``: the compared numbers, ``{name: number}``,
      of the program's outputs against the plain reference; with
      ``control`` (a lower ``torch.dtype``), of the reference computed in
      it, standing where the program's outputs stood. The harness keeps
      the names that ``limits/<cell>.json`` gives a limit, so a kind's
      own numbers need only their limits.
    """

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)

    def setup(self) -> None:
        raise NotImplementedError

    def warm_up(self, spans: Spans) -> None:
        raise NotImplementedError

    def before_step(self, i: int, elapsed_s: float, seconds: float) -> None:
        pass

    def step(self, i: int, spans: Spans, traced: bool) -> None:
        raise NotImplementedError

    def after_step(self, i: int) -> None:
        pass

    def end_window(self) -> None:
        pass

    def check(self, control: Optional[torch.dtype] = None
              ) -> Dict[str, float]:
        raise NotImplementedError


class MappingLoop(Loop):
    """Frames of depth clouds into a running occupancy, then the SDF."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        super().__init__(config, traffic, seed, device)
        self.samples: List[Sample] = []
        self.latest: Optional[Tensor] = None  # the newest SDF's values
        self._before: Optional[Tensor] = None
        self._slot: Optional[List[Tensor]] = None
        self._slots: List[List[Tensor]] = []  # page-locked, one a frame
        self._step_s = self._elapsed_s = 0.0  # the last frame; its start

    # -- inputs -------------------------------------------------------------

    def setup(self) -> None:
        from voxelized_geometry_tools_tpu_torch.core.grid import GridSpec
        from voxelized_geometry_tools_tpu_torch.ops import voxelize

        grid, cam = self.config["grid"], self.config["camera"]
        self.spec = GridSpec(tuple(grid["counts"]), float(grid["resolution"]))
        self.max_range = float(cam["max_range"])
        self.options = voxelize.FilterOptions(**self.config["fusion"])
        scene = scenes.make_scene(self.config, self.device)
        poses = scenes.camera_poses(self.config, self.seed)
        clouds = scenes.depth_clouds(self.config, scene, poses, self.seed,
                                     self.device)
        pin = self.device.type == "cuda"
        self.points = torch.empty(clouds.shape, dtype=torch.float32,
                                  pin_memory=pin)
        self.points.copy_(clouds)
        del clouds
        self.poses = torch.tensor(poses, dtype=torch.float32)
        if pin:
            self.poses = self.poses.pin_memory()
        self.n_frames = self.poses.shape[0]
        rng = np.random.default_rng(scenes.seed_bits(self.seed) ^ 0xC4EC)
        self.check_at = int(rng.integers(int(self.traffic["check_within"])))
        lo, hi = self.traffic["late_share"]
        self.late_share = float(rng.uniform(lo, hi))
        self._late_taken = False
        self._build()

    def _clouds(self, frame: int):
        from voxelized_geometry_tools_tpu_torch.ops import voxelize
        i = frame % self.n_frames
        return [voxelize.PointCloud.create(
            self.points[i, c], self.poses[i, c], max_range=self.max_range,
            device=self.device) for c in range(self.poses.shape[1])]

    # -- the program --------------------------------------------------------

    def _build(self) -> None:
        raise NotImplementedError

    def occupancy(self) -> Tensor:
        raise NotImplementedError

    def _frame(self, frame: int, spans: Spans, traced: bool) -> Tensor:
        """Fuse one frame and refresh the SDF; returns the SDF's values."""
        raise NotImplementedError

    def warm_up(self, spans: Spans) -> None:
        """The set-up's frames, through the window's call. The first starts
        from the fresh map and is checked. Set-up also allocates the
        page-locked host buffers that the window's two checked frames are
        copied into, so that those copies are short and alike from run to
        run."""
        n = int(self.traffic["warm_frames"])
        for f in range(n):
            t0 = time.perf_counter()
            self.latest = self._frame(f, spans, traced=False)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            self._step_s = time.perf_counter() - t0
            if f == 0:
                self.samples.append(Sample(0, None, _host(self.occupancy()),
                                           _host(self.latest)))
                self._slots = [[_pinned_like(self.occupancy()),
                                _pinned_like(self.occupancy()),
                                _pinned_like(self.latest)]
                               for _ in range(2)]
        self.first_window_frame = n

    def before_step(self, i: int, elapsed_s: float, seconds: float) -> None:
        """Between frames, outside the latency of any: whether window
        request ``i`` is checked, and if so the occupancy it starts
        from. The late frame is also taken where the last frame's time
        says this one may close the window, so that a window of a few
        frames still checks one of them."""
        if i:
            self._step_s = elapsed_s - self._elapsed_s
        self._elapsed_s = elapsed_s
        late = not self._late_taken and (
            elapsed_s >= self.late_share * seconds
            or elapsed_s + self._step_s >= seconds)
        if late:
            self._late_taken = True
        if (i == self.check_at or late) and self._slots:
            self._slot = self._slots.pop()
            self._before = self._slot[0].copy_(self.occupancy())

    def step(self, i: int, spans: Spans, traced: bool) -> None:
        """Window request ``i`` (0-based): one frame, handed over as host
        tensors, to its refreshed SDF."""
        self.latest = self._frame(self.first_window_frame + i, spans, traced)

    def after_step(self, i: int) -> None:
        """Between frames: the checked frame's outputs to the host."""
        if self._before is not None:
            _, after, sdf = self._slot
            self.samples.append(Sample(
                self.first_window_frame + i, self._before,
                after.copy_(self.occupancy()), sdf.copy_(self.latest)))
            self._before = self._slot = None

    def end_window(self) -> None:
        self.latest = None
        self._release()

    def _release(self) -> None:
        """Drop the program's state."""
        raise NotImplementedError

    # -- the check ----------------------------------------------------------

    def reference_occupancy(self, sample: Sample, dtype) -> Tensor:
        i = sample.frame % self.n_frames
        grid = self.config["grid"]
        counts, res = tuple(grid["counts"]), float(grid["resolution"])
        frees, filleds = [], []
        for c in range(self.poses.shape[1]):
            free, filled = ref_carve.carve(
                counts, res, self.poses[i, c].to(self.device),
                self.points[i, c].to(self.device), self.max_range, dtype)
            frees.append(free)
            filleds.append(filled)
        before = (sample.before.to(self.device)
                  if sample.before is not None else
                  torch.zeros(counts, dtype=torch.float32,
                              device=self.device))
        return ref_fusion.fuse(self.config["fusion"], frees, filleds, before)

    def reference_sdf(self, after: Tensor, dtype) -> Tensor:
        filled = ref_edt.filled_from_occupancy(
            after, self.traffic["unknown_is_filled"])
        return ref_edt.signed_distance(
            filled, float(self.config["grid"]["resolution"]), dtype)

    def check(self, control: Optional[torch.dtype] = None
              ) -> Dict[str, float]:
        """The compared numbers, the worst over the checked frames: voxels
        whose occupancy differs from the reference's carve and filter, and
        voxels whose SDF value differs from the reference's EDT of the
        program's occupancy. With ``control``, the reference computed in
        that lower precision stands where the program's outputs stood."""
        worst = {"occupancy_mismatch_voxels": 0, "sdf_mismatch_voxels": 0}
        for s in self.samples:
            after = s.after.to(self.device)
            ref_occ = self.reference_occupancy(s, torch.float32)
            got_occ = (after if control is None
                       else self.reference_occupancy(s, control))
            occ = int((ref_occ != got_occ).sum())
            del ref_occ, got_occ
            ref_sdf = self.reference_sdf(after, torch.float32)
            got_sdf = (s.sdf.to(self.device) if control is None
                       else self.reference_sdf(after, control))
            sdf = int((ref_sdf != got_sdf).sum())
            del ref_sdf, got_sdf, after
            worst["occupancy_mismatch_voxels"] = max(
                worst["occupancy_mismatch_voxels"], occ)
            worst["sdf_mismatch_voxels"] = max(worst["sdf_mismatch_voxels"],
                                               sdf)
        return worst
