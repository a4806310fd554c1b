"""Profiling / tracing utilities.

Port of ``voxelized_geometry_tools_tpu/utils/profiling.py``:

* :func:`force_materialize` waits for the card (``torch.cuda.synchronize``)
  when any of the given values holds a CUDA tensor;
* :class:`PhaseTimer` accumulates named phases, timed with CUDA events on
  the card (the device time between the phase's start and end on the
  current stream) and with the host's monotonic clock on the CPU;
* :func:`trace` records a ``torch.profiler`` trace (TensorBoard format).

The mapping path marks its layers with ``vgt.*`` annotations
(:func:`_span`: ``vgt.ingest``, ``vgt.fusion`` with its ``ray_setup``,
``carve`` and ``filter``, ``vgt.edt`` with its ``mask``, ``seed_pass``,
``envelope``, ``combine`` and ``lock``, and in the slab-streamed EDT a
``slab_writeback`` inside the seed and envelope passes around each slab's
copy into its field). They are recorded only while a profiler runs,
through :func:`trace` or any ``torch.profiler`` session, and land in its
trace beside the kernels, on the same clock: a dotted name gives the parent
layer, nesting on the host thread the caller.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import torch

_NO_SPAN = contextlib.nullcontext()


def _span(name: str):
    """``torch.profiler.record_function("vgt." + name)`` while a profiler
    records, else a no-op context. The check costs a fraction of a
    microsecond; a ``record_function`` entered with no profiler running
    costs about ten. A span adds no synchronization, no host copy and no
    state: the profiler keeps it and writes it out with its trace."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("vgt." + name)
    return _NO_SPAN


def _leaves(value):
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _leaves(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _leaves(v)
    elif hasattr(value, "__dataclass_fields__"):
        for name in value.__dataclass_fields__:
            yield from _leaves(getattr(value, name))


def force_materialize(*values) -> None:
    """Block until every tensor in ``values`` (nested in tuples, lists,
    dicts and dataclasses) is computed: one ``torch.cuda.synchronize`` for
    each CUDA device they lie on; CPU tensors are computed already."""
    devices = {t.device for v in values for t in _leaves(v)
               if t.device.type == "cuda"}
    for device in devices:
        torch.cuda.synchronize(device)


class PhaseTimer:
    """Accumulating named-phase timer.

    The context manager yields a list; append the block's OUTPUTS to it so
    they are materialized before the clock stops.

    >>> timer = PhaseTimer(device="cpu")
    >>> with timer.phase("raycast") as outs:
    ...     grids = carve(...)
    ...     outs.append(grids)
    >>> timer.times()["raycast"]

    ``device``: ``"cuda"`` times phases with CUDA events on the current
    stream, ``"cpu"`` with the host clock; None means the card when there
    is one. A phase whose body raises records no time."""

    def __init__(self, device=None):
        if device is None:
            device = "cuda" if torch.cuda.is_available() else "cpu"
        self.device = torch.device(device)
        self._times: Dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, *materialize):
        outs = list(materialize)
        if self.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            yield outs
            end.record()
            end.synchronize()
            force_materialize(*outs)
            seconds = start.elapsed_time(end) / 1e3
        else:
            t0 = time.monotonic()
            yield outs
            force_materialize(*outs)
            seconds = time.monotonic() - t0
        self._times[name] = self._times.get(name, 0.0) + seconds

    def times(self) -> Dict[str, float]:
        return dict(self._times)

    def total(self) -> float:
        return sum(self._times.values())

    def report(self) -> str:
        lines = [f"{name}: {t:.4f}s" for name, t in self._times.items()]
        lines.append(f"total: {self.total():.4f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """``torch.profiler`` trace written to ``log_dir`` (TensorBoard
    format), with the card's activity when there is one. No-op when
    ``log_dir`` is None, so call sites can leave tracing wired in."""
    if log_dir is None:
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
