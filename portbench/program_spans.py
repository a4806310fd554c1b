"""The program's own spans in the profiler's trace: device time, idle time
and host waits by the layer of the port that caused them.

The port marks its layers with ``vgt.*`` annotations
(``voxelized_geometry_tools_tpu_torch/utils/profiling.py``), recorded only
while a profiler runs, on the trace's own clock; a dotted name gives the
parent layer. :func:`summarize` keeps every field of
:func:`tracing.summarize` and adds, each keyed by the innermost program
span the host was in (``""``: none):

* ``span_busy_s`` and ``span_ops``: device time and count of the kernels,
  copies and memsets launched there, matched to their launch by the
  ``correlation`` of the runtime call (of the driver call where a kernel
  has no runtime call), clipped to the window as ``busy_s`` is;
* ``span_idle_s``: each idle interval of the window, split over the time
  the host spent in each span meanwhile;
* ``span_waits``: the host's blocking calls there (the synchronizes and
  ``cudaMemcpy``).

The idle gaps' names also carry the program span around the gap's
middle: ``fuse/vgt.fusion.ray_setup: _Matmul``.

``tracing.py`` stays as the accepted benchmark has it: :func:`install`
routes ``DeviceTrace``'s summary through :func:`summarize`, and every
reader of a program-span metric calls it when it is loaded, which the
harness does before the window opens. A program without the spans (an
older commit) leaves the fields empty, and those readers report nothing.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from . import tracing

PROGRAM_PREFIX = "vgt."
_WAITS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                    "cudaEventSynchronize", "cudaMemcpy"))
_base_summarize = tracing.summarize


@dataclasses.dataclass
class SpanSummary(tracing.TraceSummary):
    span_busy_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    span_ops: Dict[str, int] = dataclasses.field(default_factory=dict)
    span_idle_s: Dict[str, float] = dataclasses.field(default_factory=dict)
    span_waits: Dict[str, int] = dataclasses.field(default_factory=dict)

    def has_program_spans(self) -> bool:
        return any(k for d in (self.span_busy_s, self.span_idle_s,
                               self.span_waits) for k in d)


def subtree(values: Dict[str, float], name: str) -> float:
    """The sum of ``values`` over span ``name`` and the spans named under
    it (``name.*``)."""
    return sum(v for k, v in values.items()
               if k == name or k.startswith(name + "."))


def of(run) -> Optional[SpanSummary]:
    """The run's summary where it holds program spans, else None."""
    s = run.trace
    if (not isinstance(s, SpanSummary) or not s.has_program_spans()
            or not run.traced_steps):
        return None
    return s


def install() -> None:
    """Route the benchmark's device-trace summary through
    :func:`summarize`."""
    tracing.summarize = summarize


class _Timeline:
    """The innermost program span the host is in, as a step function of
    time: ``labels[i]`` from ``times[i]`` to ``times[i + 1]``, ``""``
    before the first breakpoint and after the last."""

    def __init__(self, spans: List[Tuple[float, float, str]]):
        self.times: List[float] = []
        self.labels: List[str] = []
        stack: List[Tuple[float, float, str]] = []

        def close_until(t):
            while stack and stack[-1][1] <= t:
                end = stack.pop()[1]
                self.times.append(end)
                self.labels.append(stack[-1][2] if stack else "")

        for a, b, name in sorted(spans, key=lambda s: (s[0], -s[1])):
            close_until(a)
            if stack:
                b = min(b, stack[-1][1])  # spans of one thread nest
            stack.append((a, b, name))
            self.times.append(a)
            self.labels.append(name)
        close_until(math.inf)

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.times, t) - 1
        return self.labels[i] if i >= 0 else ""

    def split(self, a: float, b: float, into: Dict[str, float]) -> None:
        """Add each label's share of ``[a, b]`` to ``into``."""
        i = bisect.bisect_right(self.times, a) - 1
        t = a
        while t < b:
            end = min(b, self.times[i + 1] if i + 1 < len(self.times)
                      else math.inf)
            label = self.labels[i] if i >= 0 else ""
            into[label] = into.get(label, 0.0) + end - t
            t, i = end, i + 1


def summarize(events: List[dict], top_gaps: int = 10) -> SpanSummary:
    """:func:`tracing.summarize`'s summary with the program's spans."""
    base = _base_summarize(events, top_gaps)
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name") == tracing.WINDOW_SPAN and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
    w0, w1 = min(w[0] for w in windows), max(w[1] for w in windows)
    launches: Dict[str, Dict[int, float]] = {"cuda_runtime": {},
                                             "cuda_driver": {}}
    device, program, bench, ops, waits = [], [], [], [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat, name = e.get("cat"), e["name"]
        if cat in tracing._DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b > a:
                device.append((a, b, e.get("args", {}).get("correlation")))
        elif cat == "user_annotation" and name.startswith(PROGRAM_PREFIX):
            program.append((a, b, name))
        elif cat == "user_annotation" and name.startswith(
                tracing.SPAN_PREFIX):
            bench.append((a, b, name[len(tracing.SPAN_PREFIX):]))
        if cat in launches and "correlation" in e.get("args", {}):
            launches[cat][e["args"]["correlation"]] = a
        if cat in ("cpu_op", "cuda_runtime"):
            ops.append((a, b, name))
        if cat == "cuda_runtime" and name in _WAITS and w0 <= a <= w1:
            waits.append(a)
    timeline = _Timeline(program)

    busy: Dict[str, float] = collections.defaultdict(float)
    count: Dict[str, int] = collections.defaultdict(int)
    for a, b, corr in device:
        t = launches["cuda_runtime"].get(corr,
                                         launches["cuda_driver"].get(corr))
        label = "" if t is None else timeline.at(t)
        busy[label] += (b - a) * 1e-6
        count[label] += 1
    idle_us: Dict[str, float] = {}
    merged = tracing._union([(a, b) for a, b, _ in device])
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    gaps = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
    for a, b in gaps:
        timeline.split(a, b, idle_us)
    n_waits: Dict[str, int] = collections.defaultdict(int)
    for t in waits:
        n_waits[timeline.at(t)] += 1

    ops.sort()
    op_starts = [o[0] for o in ops]
    gaps.sort(key=lambda g: g[0] - g[1])
    idle_gaps = []
    for a, b in gaps[:top_gaps]:
        name = tracing._gap_name(a, b, bench, ops, op_starts)
        span = timeline.at((a + b) / 2)
        if span:
            head, sep, tail = name.partition(": ")
            name = f"{head}/{span}{sep}{tail}"
        idle_gaps.append((name, (b - a) * 1e-6))
    return SpanSummary(
        window_s=base.window_s, busy_s=base.busy_s, kernel_s=base.kernel_s,
        kernel_count=base.kernel_count, idle_gaps=idle_gaps,
        span_busy_s=dict(busy), span_ops=dict(count),
        span_idle_s={k: v * 1e-6 for k, v in idle_us.items()},
        span_waits=dict(n_waits))
