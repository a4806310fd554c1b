"""The benchmark's own spans and its reading of the profiler's trace.

Spans are host-clock intervals the benchmark records around its calls into
the program (synchronized in a traced run), kept in memory by name. The
device trace is ``torch.profiler``'s (CUPTI) timeline of the traced steps:
it is written to a file under ``TMPDIR``, read back, summarized and
deleted. The summary keeps, inside the traced window, the device time of
each kernel by name, the union of device-busy intervals, and the longest
idle gaps, each named by the benchmark span and the host operation that
overlapped it most.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

WINDOW_SPAN = "portbench.window"
SPAN_PREFIX = "portbench."
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Spans:
    """Durations in seconds by span name."""

    def __init__(self):
        self.durations: Dict[str, List[float]] = collections.defaultdict(list)

    @contextlib.contextmanager
    def span(self, name: str, sync: bool):
        """Time a block on the host clock; with ``sync`` the device is
        synchronized at both ends, so the span holds the block's work."""
        if sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.profiler.record_function(SPAN_PREFIX + name):
            yield
        if sync:
            torch.cuda.synchronize()
        self.durations[name].append(time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        self.durations[name].append(seconds)


@dataclasses.dataclass
class TraceSummary:
    window_s: float
    busy_s: float
    kernel_s: Dict[str, float]
    kernel_count: Dict[str, int]
    idle_gaps: List[Tuple[str, float]]

    def device_ops(self, top: int = 10) -> List[Tuple[str, float]]:
        """The ``top`` device operations by total time, under short
        names."""
        totals: Dict[str, float] = collections.defaultdict(float)
        for name, s in self.kernel_s.items():
            totals[short_name(name)] += s
        return sorted(totals.items(), key=lambda kv: -kv[1])[:top]

    def kernels_matching(self, *needles: str) -> Tuple[float, int]:
        """Device seconds and launches of the kernels whose name holds
        any of ``needles``."""
        secs, count = 0.0, 0
        for name, s in self.kernel_s.items():
            if any(n in name for n in needles):
                secs += s
                count += self.kernel_count[name]
        return secs, count


def short_name(name: str, width: int = 96) -> str:
    """A kernel's name without ``void`` and its parameter list, and
    without its template arguments when still longer than ``width``."""
    if name.startswith("void "):
        name = name[5:]
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, 0, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    if len(name) > width and "<" in name:
        # Keep the first function named in the template arguments (the
        # operation of an elementwise kernel).
        inner = [f for f in re.findall(r"::(\w+)(?:<[^<>]*>)?\(", name)
                 if not f.startswith("gpu_kernel")]
        name = name[:name.index("<")] + (f"[{inner[0]}]" if inner else "")
    return name.strip()


def _union(intervals: List[Tuple[float, float]]):
    merged: List[List[float]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def _gap_name(a: float, b: float, spans, ops, op_starts) -> str:
    """The innermost benchmark span around the gap's middle, and the host
    operation that overlaps the gap most."""
    mid = (a + b) / 2
    inner = [s for s in spans if s[0] <= mid <= s[1]]
    span = min(inner, key=lambda s: s[1] - s[0])[2] if inner else "host"
    best, best_overlap = None, 0.0
    # The operations that start last before the gap ends.
    last = bisect.bisect_right(op_starts, b)
    for s, e, name in ops[max(0, last - 4096):last]:
        overlap = min(b, e) - max(a, s)
        if overlap > best_overlap:
            best, best_overlap = name, overlap
    return span if best is None else f"{span}: {best}"


def summarize(events: List[dict], top_gaps: int = 10) -> TraceSummary:
    """Summary of a chrome trace's events inside the benchmark's window
    span (times in microseconds in the trace, seconds in the summary)."""
    windows = [(e["ts"], e["ts"] + e["dur"]) for e in events
               if e.get("name") == WINDOW_SPAN and e.get("ph") == "X"
               and e.get("cat") in ("user_annotation", "cpu_op")]
    if not windows:
        raise RuntimeError("the trace holds no benchmark window span")
    w0, w1 = min(w[0] for w in windows), max(w[1] for w in windows)
    kernel_s: Dict[str, float] = collections.defaultdict(float)
    kernel_count: Dict[str, int] = collections.defaultdict(int)
    busy = []
    spans, ops = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        cat = e.get("cat")
        if cat in _DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            busy.append((a, b))
            kernel_s[e["name"]] += (b - a) * 1e-6
            kernel_count[e["name"]] += 1
        elif cat == "user_annotation" and e["name"].startswith(SPAN_PREFIX):
            spans.append((a, b, e["name"][len(SPAN_PREFIX):]))
        elif cat in ("cpu_op", "cuda_runtime"):
            ops.append((a, b, e["name"]))
    ops.sort()
    op_starts = [o[0] for o in ops]
    merged = _union(busy)
    busy_us = sum(b - a for a, b in merged)
    gaps = []
    edges = [w0] + [x for iv in merged for x in iv] + [w1]
    for a, b in zip(edges[0::2], edges[1::2]):
        if b > a:
            gaps.append((a, b))
    gaps.sort(key=lambda g: g[0] - g[1])
    idle = [(_gap_name(a, b, spans, ops, op_starts), (b - a) * 1e-6)
            for a, b in gaps[:top_gaps]]
    return TraceSummary(window_s=(w1 - w0) * 1e-6, busy_s=busy_us * 1e-6,
                        kernel_s=dict(kernel_s),
                        kernel_count=dict(kernel_count), idle_gaps=idle)


class DeviceTrace:
    """``torch.profiler`` over the traced steps; ``summary`` after
    ``stop``."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
        self._window = None
        self.summary: Optional[TraceSummary] = None

    def start(self) -> None:
        torch.cuda.synchronize()
        self._prof.__enter__()
        self._window = torch.profiler.record_function(WINDOW_SPAN)
        self._window.__enter__()

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._window.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(prefix="portbench-trace-",
                                    suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f)["traceEvents"]
        finally:
            os.unlink(path)
        self.summary = summarize(events)
