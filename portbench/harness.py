"""One run of one cell: set-up, warm-up, the measured window, the check.

``run_cell`` builds the cell's loop, of the kind its traffic mix names
(``registry.loop``), from its configuration and traffic mix, warms it up
(set-up ends there), then drives it as one closed-loop client for
``seconds``: each request starts when the last one has returned, and its
latency runs from handing over its inputs to its synchronized result.
With ``trace`` the steps are also split by synchronized spans and the
first ``trace_steps`` of them run under the profiler; the run then reports
the cell's per-layer metrics instead of its end-to-end ones. After the
window it reads the peak memory, frees the program's state and compares
the outputs that the loop copied to the host with the plain reference.
Those copies are made between requests (``before_step``, ``after_step``),
outside every latency but inside the window.
"""

from __future__ import annotations

import dataclasses
import importlib
import sys
import time
from typing import Dict, List, Optional

import torch

from . import registry
from .tracing import DeviceTrace, Spans, TraceSummary


@dataclasses.dataclass
class RunRecord:
    """What a metric's reader reads."""
    cell: str
    config: dict
    traffic: dict
    latencies: List[float]      # seconds per window request
    elapsed_s: float            # window start to the last request's end
    setup_s: float
    spans: Spans
    trace: Optional[TraceSummary]
    counters: Dict[str, float]  # program counters over the traced steps
    traced_steps: int


def _counter_value(path: str) -> float:
    module, attr = path.split(":")
    return float(getattr(importlib.import_module(module), attr))


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: str, seed: int, seconds: float, trace: bool,
             t_process: float, device="cuda", config: Optional[dict] = None,
             traffic: Optional[dict] = None,
             control: Optional[torch.dtype] = None) -> dict:
    """The result line's object, ``checks`` last. ``config`` and
    ``traffic`` replace the cell's own (the CPU tests' small sizes); on
    the CPU no metric is reported. ``control`` (a lower precision; for
    setting limits) adds the compared numbers of the reference computed
    in it, standing in the program's place, under ``control``."""
    bench = registry.load_benchmark()
    w = registry.workload(bench, cell)
    config = config or registry.config(bench, w["config"])
    traffic = traffic or registry.traffic(w["traffic"])
    device = torch.device(device)
    metrics = registry.metrics_of(bench, cell, trace)
    readers = {m["name"]: registry.reader(m["name"]) for m in metrics}
    counter_paths = {k: v for r in readers.values()
                     for k, v in getattr(r, "COUNTERS", {}).items()}

    loop = registry.loop(traffic["loop"])(config, traffic, seed, device)
    loop.setup()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    loop.warm_up(Spans())
    _sync(device)
    setup_s = time.perf_counter() - t_process

    spans, latencies = Spans(), []
    trace_steps = int(traffic["trace_steps"]) if trace else 0
    profiler = DeviceTrace() if trace and device.type == "cuda" else None
    counters: Dict[str, float] = {}
    if profiler is not None:
        # The profiler's own start (CUPTI's set-up) stays out of the window.
        counters = {k: sum(_counter_value(p) for p in v)
                    for k, v in counter_paths.items()}
        profiler.start()
    t_start = time.perf_counter()
    t_end = t_start
    i = 0
    while True:
        loop.before_step(i, time.perf_counter() - t_start, seconds)
        t0 = time.perf_counter()
        loop.step(i, spans, traced=trace)
        _sync(device)
        t_end = time.perf_counter()
        latencies.append(t_end - t0)
        loop.after_step(i)
        i += 1
        if profiler is not None and i == trace_steps:
            profiler.stop()
            counters = {k: sum(_counter_value(p) for p in v) - counters[k]
                        for k, v in counter_paths.items()}
        if t_end - t_start >= seconds:
            break
    if profiler is not None and i < trace_steps:
        profiler.stop()
        counters = {k: sum(_counter_value(p) for p in v) - counters[k]
                    for k, v in counter_paths.items()}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    loop.end_window()

    record = RunRecord(
        cell=cell, config=config, traffic=traffic, latencies=latencies,
        elapsed_s=t_end - t_start,
        setup_s=setup_s, spans=spans,
        trace=profiler.summary if profiler else None, counters=counters,
        traced_steps=min(i, trace_steps))
    values = {}
    if device.type == "cuda":
        for m in metrics:
            v = readers[m["name"]].read(record)
            if v is not None:
                values[m["name"]] = {"value": v, "unit": m["unit"]}

    t_check = time.perf_counter()
    limits = registry.limits(cell)
    numbers = {k: v for k, v in loop.check().items() if k in limits}
    ms = sorted(1e3 * x for x in latencies)
    print(f"portbench: {cell} seed {seed}: set-up {setup_s:.3f} s, window "
          f"{t_end - t_start:.3f} s ({i} requests: {ms[0]:.2f} / "
          f"{ms[len(ms) // 2]:.2f} / {ms[-1]:.2f} ms least / median / "
          f"most), check {time.perf_counter() - t_check:.3f} s",
          file=sys.stderr)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    failed = sum(v > limits[k] for k, v in numbers.items())
    result = {
        "correct": failed == 0,
        "attempted": i,
        "failed": failed,
        "metrics": values,
        "device": {
            "platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": 1,
            "memory_peak_bytes": peak,
        },
    }
    if profiler is not None:
        s = profiler.summary
        result["device"]["busy_s"] = s.busy_s
        result["device"]["window_s"] = s.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in
                                              s.device_ops()],
                               "idle_gaps": [list(x) for x in s.idle_gaps]}
    if control is not None:
        result["control"] = {k: v for k, v in loop.check(control).items()
                             if k in limits}
    result["checks"] = checks
    return result
