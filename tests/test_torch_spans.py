"""The port's ``vgt.*`` profiler spans (``utils/profiling._span``) and the
benchmark's reading of them (``portbench/program_spans.py`` and its six
readers), on the CPU.

* With no profiler running, no ``record_function`` is entered.
* Under ``torch.profiler``, the mapping path's entry points give exactly
  the layer spans, nested by their dotted names, with no synchronize.
* A call to a voxelizer without a ``runtime_log_fn`` waits for nothing.
* ``program_spans.summarize`` on a hand-written chrome trace: kernels go to
  the span that launched them, idle gaps are split over the spans the host
  was in, waits are counted, gap names carry the span, and the benchmark's
  own summary fields are those of ``tracing.summarize``.
* Each reader: None untraced or without program spans, the fixture's
  number traced.
"""

import json
import types

import pytest
import torch

from portbench import program_spans, registry, tracing
from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.core.maps import OccupancyMap
from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
    OnlineMapper)
from voxelized_geometry_tools_tpu_torch.ops import backends, edt, voxelize
from voxelized_geometry_tools_tpu_torch.utils import profiling

FUSION = {"vgt.fusion", "vgt.fusion.ray_setup", "vgt.fusion.carve",
          "vgt.fusion.filter"}
EDT = {"vgt.edt", "vgt.edt.mask", "vgt.edt.seed_pass", "vgt.edt.envelope",
       "vgt.edt.combine", "vgt.edt.lock"}


def _spec():
    return GridSpec.from_grid_sizes(0.25, (8, 8, 8))  # 32^3


def _clouds(n):
    g = torch.Generator().manual_seed(19)
    pts = torch.rand(200, 3, generator=g) * 4.0 + 2.0
    poses = []
    for c in range(n):
        pose = torch.eye(4)
        pose[:3, 3] = torch.tensor([1.0, 1.0, 1.0 + c])
        poses.append(pose)
    return [voxelize.PointCloud.create(pts, p, max_range=6.0, device="cpu")
            for p in poses]


def _mapper_frame():
    mapper = OnlineMapper(_spec(), device="cpu", carve_run_axis=-1)
    mapper.integrate(_clouds(1)[0])
    return mapper.sdf()


VOXELIZERS = {
    "voxelize_pointclouds": lambda: voxelize.voxelize_pointclouds,
    "accelerator": lambda: backends.AcceleratorPointCloudVoxelizer(
        device="cpu").voxelize_pointclouds,
}


def _voxelize(entry, **kwargs):
    env = OccupancyMap.create(_spec(), device="cpu")
    return VOXELIZERS[entry]()(env, voxelize.FilterOptions(), _clouds(2),
                               **kwargs)


def _voxelize_frame(entry):
    env = _voxelize(entry)
    return edt.extract_sdf_from_occupancy(env.occupancy, env.spec,
                                          env.origin_transform)


FRAMES = {"mapper": _mapper_frame,
          **{e: (lambda e=e: _voxelize_frame(e)) for e in VOXELIZERS}}


def _raise(*args, **kwargs):
    raise AssertionError("called")


@pytest.mark.parametrize("entry", sorted(FRAMES))
def test_no_record_function_without_profiler(monkeypatch, entry):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    assert not torch.autograd._profiler_enabled()
    FRAMES[entry]()


def _traced(frame, tmp_path):
    """The ``vgt.*`` host spans of one call under ``torch.profiler``, as
    (start, end, name) from its chrome trace."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tracing.WINDOW_SPAN):
            frame()
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"]) for e in events
                   if e.get("cat") == "user_annotation"
                   and e["name"].startswith("vgt."))
    return spans, events


def _parent(span, spans):
    """The innermost other program span around ``span``."""
    a, b, _ = span
    around = [s for s in spans if s is not span and s[0] <= a and b <= s[1]]
    return min(around, key=lambda s: s[1] - s[0])[2] if around else None


@pytest.mark.parametrize("entry", sorted(FRAMES))
def test_spans_name_and_nest_the_layers(monkeypatch, tmp_path, entry):
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    spans, _ = _traced(FRAMES[entry], tmp_path)
    names = [s[2] for s in spans]
    assert set(names) == {"vgt.ingest"} | FUSION | EDT
    clouds = 1 if entry == "mapper" else 2
    assert names.count("vgt.ingest") == clouds
    assert names.count("vgt.fusion") == 1
    assert names.count("vgt.fusion.carve") == clouds
    assert names.count("vgt.fusion.filter") == 1
    assert names.count("vgt.edt") == 1
    assert names.count("vgt.edt.envelope") == 2
    for span in spans:
        name, parent = span[2], _parent(span, spans)
        if name in ("vgt.ingest", "vgt.fusion", "vgt.edt"):
            assert parent is None, (name, parent)
        else:
            assert parent == name.rsplit(".", 1)[0], (name, parent)


def test_span_makes_no_sync_or_host_copy(monkeypatch, tmp_path):
    for attr in ("cpu", "item", "tolist", "numpy"):
        monkeypatch.setattr(torch.Tensor, attr, _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)

    def frame():
        with profiling._span("probe"):
            with profiling._span("probe.inner"):
                pass

    spans, _ = _traced(frame, tmp_path)
    assert [s[2] for s in spans] == ["vgt.probe", "vgt.probe.inner"]
    assert profiling._span("probe") is profiling._NO_SPAN


@pytest.mark.parametrize("entry", sorted(VOXELIZERS))
def test_voxelizer_waits_only_for_a_log_fn(monkeypatch, entry):
    # On the CPU the voxelizers' ``_sync`` never reaches the card: count
    # its calls as well as the card's synchronize.
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("cuda"))
    for module in (voxelize, backends):
        monkeypatch.setattr(module, "_sync", lambda d: calls.append("sync"))
    _voxelize(entry)
    assert calls == []

    logged = []
    _voxelize(entry, runtime_log_fn=logged.append)
    assert calls == ["sync", "sync"]
    assert len(logged) == 1 and min(logged[0]) >= 0.0


def test_summarize_reads_a_profiler_trace(tmp_path):
    """A CPU trace of the mapper: no device work, so the whole window is
    idle, split over the program's spans and the time outside them."""
    _, events = _traced(_mapper_frame, tmp_path)
    s = program_spans.summarize(events)
    assert s.busy_s == 0.0 and s.span_busy_s == {}
    assert set(s.span_idle_s) <= {""} | {"vgt.ingest"} | FUSION | EDT
    assert {"vgt.fusion.carve", "vgt.edt.envelope"} <= set(s.span_idle_s)
    assert sum(s.span_idle_s.values()) == pytest.approx(s.window_s)
    assert s.has_program_spans()


# -- a hand-written trace -----------------------------------------------------
#
# Window 0-1000 us; the benchmark's spans fuse 0-600 and sdf 600-1000; the
# program's vgt.fusion 10-500 (ray_setup 20-200, carve 200-300, filter
# 440-500) and vgt.edt 600-990 (envelope 650-900).


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": 1}
    if args:
        e["args"] = args
    return e


def _fixture(program=True):
    spans = [("portbench.window", 0, 1000), ("portbench.fuse", 0, 600),
             ("portbench.sdf", 600, 400)]
    if program:
        spans += [("vgt.fusion", 10, 490), ("vgt.fusion.ray_setup", 20, 180),
                  ("vgt.fusion.carve", 200, 100),
                  ("vgt.fusion.filter", 440, 60), ("vgt.edt", 600, 390),
                  ("vgt.edt.envelope", 650, 250)]
    events = [_x("user_annotation", n, ts, dur) for n, ts, dur in spans]
    events += [
        _x("gpu_user_annotation", "vgt.fusion", 0, 1000),  # device side
        _x("cpu_op", "_Matmul", 100, 115),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=1),
        _x("kernel", "void at::native::where_kernel(int)", 40, 60,
           correlation=1),
        _x("cuda_driver", "cuLaunchKernel", 210, 5, correlation=2),
        _x("kernel", "carve_tile_kernel", 220, 100, correlation=2),
        _x("cuda_runtime", "cudaMemcpyAsync", 400, 5, correlation=3),
        _x("gpu_memcpy", "Memcpy HtoD", 405, 35, correlation=3),
        _x("cuda_runtime", "cudaLaunchKernel", 445, 5, correlation=4),
        _x("kernel", "filter_kernel", 450, 20, correlation=4),
        _x("cuda_runtime", "cudaMemsetAsync", 550, 5, correlation=5),
        _x("gpu_memset", "Memset", 560, 10, correlation=5),
        _x("cuda_runtime", "cudaLaunchKernel", 700, 5, correlation=6),
        _x("kernel", "edt_bestfirst_staged_kernel", 700, 150, correlation=6),
        _x("kernel", "orphan_kernel", 950, 10, correlation=99),
        _x("cuda_runtime", "cudaLaunchKernel", 980, 5, correlation=7),
        _x("kernel", "combine_kernel", 990, 20, correlation=7),
        _x("cuda_runtime", "cudaLaunchKernel", 1005, 5, correlation=8),
        _x("kernel", "late_kernel", 1020, 10, correlation=8),
        _x("cuda_runtime", "cudaStreamSynchronize", 150, 5),
        _x("cuda_runtime", "cudaMemcpy", 420, 3),
        _x("cuda_runtime", "cudaDeviceSynchronize", 580, 10),
    ]
    return events


def _us(d):
    return {k: pytest.approx(v * 1e-6) for k, v in d.items()}


def test_program_spans_summary():
    events = _fixture()
    s = program_spans.summarize(events)
    assert s.span_busy_s == _us({
        "vgt.fusion.ray_setup": 60, "vgt.fusion.carve": 100,  # driver only
        "vgt.fusion": 35, "vgt.fusion.filter": 20, "vgt.edt.envelope": 150,
        "vgt.edt": 10,  # clipped to the window
        "": 20})        # launched outside the spans; launch not in trace
    assert s.span_ops == {"vgt.fusion.ray_setup": 1, "vgt.fusion.carve": 1,
                          "vgt.fusion": 1, "vgt.fusion.filter": 1,
                          "vgt.edt.envelope": 1, "vgt.edt": 1, "": 2}
    assert s.span_idle_s == _us({
        "": 100, "vgt.fusion": 95, "vgt.fusion.ray_setup": 120,
        "vgt.fusion.carve": 20, "vgt.fusion.filter": 40, "vgt.edt": 130,
        "vgt.edt.envelope": 100})
    assert s.span_waits == {"vgt.fusion.ray_setup": 1, "vgt.fusion": 1,
                            "": 1}
    assert [g[0] for g in s.idle_gaps] == [
        "sdf/vgt.edt: cudaDeviceSynchronize",
        "fuse/vgt.fusion.ray_setup: _Matmul",
        "sdf/vgt.edt",
        "fuse: cudaMemsetAsync",
        "fuse/vgt.fusion: cudaMemcpyAsync",
        "fuse/vgt.fusion.ray_setup: cudaLaunchKernel",
        "sdf/vgt.edt: cudaLaunchKernel",
        "fuse/vgt.fusion.filter: cudaLaunchKernel"]
    assert sum(s.span_busy_s.values()) == pytest.approx(s.busy_s)
    assert (sum(s.span_idle_s.values())
            == pytest.approx(s.window_s - s.busy_s))


def test_program_spans_keep_the_benchmark_fields():
    # tracing.py's own summarize (a loaded span reader reroutes the name).
    events = _fixture()
    base = program_spans._base_summarize(events)
    s = program_spans.summarize(events)
    assert type(base) is tracing.TraceSummary
    assert (s.window_s, s.busy_s) == (base.window_s, base.busy_s)
    assert (s.window_s, s.busy_s) == (pytest.approx(1e-3),
                                      pytest.approx(395e-6))
    assert s.kernel_s == base.kernel_s and s.kernel_count == base.kernel_count
    assert s.kernel_s["edt_bestfirst_staged_kernel"] == pytest.approx(150e-6)
    assert "late_kernel" not in s.kernel_s
    assert s.device_ops() == base.device_ops()
    assert [g[1] for g in s.idle_gaps] == [g[1] for g in base.idle_gaps]
    for (name, _), (base_name, _) in zip(s.idle_gaps, base.idle_gaps):
        head, _, tail = name.partition(": ")
        base_head, _, base_tail = base_name.partition(": ")
        assert (head.split("/")[0], tail) == (base_head, base_tail)


READERS = {"ray_setup_ms": 0.03, "filter_busy_ms": 0.01,
           "edt_glue_ms": 0.005, "idle_ms.fusion": 0.1375,
           "idle_ms.edt": 0.115, "host_waits": 1.0}


@pytest.mark.parametrize("metric", sorted(READERS))
def test_span_readers(monkeypatch, metric):
    # Loading a reader installs the span summary; undo that after the test.
    monkeypatch.setattr(tracing, "summarize", tracing.summarize)
    reader = registry.reader(metric)
    assert tracing.summarize is program_spans.summarize

    def run(trace):
        return types.SimpleNamespace(trace=trace, traced_steps=2)

    assert reader.read(run(None)) is None
    assert reader.read(run(tracing.summarize(_fixture(program=False)))) is None
    value = reader.read(run(tracing.summarize(_fixture())))
    assert value == pytest.approx(READERS[metric])
    bench = registry.load_benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == metric]
    assert entry["source"] == "program_span"
    assert entry["moves"] == "frames_per_s"
