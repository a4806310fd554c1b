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
* The slab-streamed EDT gives the dense path's ``seed_pass``,
  ``envelope`` and ``combine`` spans and a ``slab_writeback`` span a slab,
  as many as ``streamed_slabs`` counts and ``_slabs`` schedules; the dense
  path's sequence of spans is unchanged.
* ``edt_bestfirst.elements_launched`` counts the elements of every
  variant's launches; the streamed EDT's three readers read a
  hand-written trace and the counter.
"""

import dataclasses
import functools
import json
import types

import pytest
import torch

from portbench import program_spans, registry, roofline, tracing
from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.core.maps import OccupancyMap
from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
    OnlineMapper)
from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst
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
    # On the CPU the fusion step's ``_sync`` (both voxelizers') never
    # reaches the card: count its calls as well as the card's synchronize.
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda *a: calls.append("cuda"))
    monkeypatch.setattr(voxelize, "_sync", lambda d: calls.append("sync"))
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


# -- the slab-streamed EDT ----------------------------------------------------

SLAB = 8


def _edt_mask(shape):
    g = torch.Generator().manual_seed(sum(shape))
    return torch.rand(shape, generator=g) < 0.1


def _streamed_extract(mask, monkeypatch):
    """``extract_signed_distance_field`` on the streamed path, at slab
    ``SLAB`` so that small grids take several slabs."""
    monkeypatch.setattr(
        edt, "signed_distance_from_filled_mask_streamed",
        functools.partial(edt.signed_distance_from_filled_mask_streamed,
                          slab=SLAB))
    spec = GridSpec.from_voxel_counts(0.1, mask.shape)
    return edt.extract_signed_distance_field(mask, spec, None,
                                             streaming=True)


def _pass_slabs(shape, axis):
    """Slabs ``_slabs`` schedules for one field's pass along ``axis``."""
    return len(edt._slabs(shape[edt._streamed_slab_axis(shape, axis)],
                          SLAB))


def _in_order(spans):
    """Span names in the order they open, an outer span before the spans
    it holds."""
    return [s[2] for s in sorted(spans, key=lambda s: (s[0], -s[1]))]


def test_streamed_edt_records_no_function_without_profiler(monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    _streamed_extract(_edt_mask((13, 17, 19)), monkeypatch)


@pytest.mark.parametrize("shape", [(13, 17, 19), (6, 4, 40), (20, 9, 1)])
def test_streamed_edt_spans_and_slabs(monkeypatch, tmp_path, shape):
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    mask = _edt_mask(shape)
    before = edt.streamed_slabs
    spans, _ = _traced(lambda: _streamed_extract(mask, monkeypatch),
                       tmp_path)
    names = [s[2] for s in spans]
    passes = [a for a in range(3) if a == 0 or shape[a] > 1]
    slabs = 2 * sum(_pass_slabs(shape, a) for a in passes)  # two fields
    assert set(names) == EDT | {"vgt.edt.slab_writeback"}
    assert names.count("vgt.edt") == 1
    assert names.count("vgt.edt.seed_pass") == 2
    assert names.count("vgt.edt.envelope") == 2 * (len(passes) - 1)
    # One float32 combine over both fields, after the second field.
    assert names.count("vgt.edt.combine") == 1
    assert names.count("vgt.edt.slab_writeback") == slabs
    assert edt.streamed_slabs - before == slabs
    parents = [_parent(span, spans) for span in spans
               if span[2] == "vgt.edt.slab_writeback"]
    assert parents.count("vgt.edt.seed_pass") == 2 * _pass_slabs(shape, 0)
    assert set(parents) <= {"vgt.edt.seed_pass", "vgt.edt.envelope"}
    for span in spans:
        name, parent = span[2], _parent(span, spans)
        if name == "vgt.edt":
            assert parent is None
        elif name != "vgt.edt.slab_writeback":
            assert parent == "vgt.edt", (name, parent)


DENSE_EDT_SPANS = ["vgt.edt", "vgt.edt.mask", "vgt.edt.seed_pass",
                   "vgt.edt.envelope", "vgt.edt.envelope", "vgt.edt.combine",
                   "vgt.edt.lock"]


def test_dense_edt_span_sequence_is_unchanged(tmp_path):
    mask = _edt_mask((13, 17, 19))
    spec = GridSpec.from_voxel_counts(0.1, mask.shape)
    before = edt.streamed_slabs
    spans, _ = _traced(lambda: edt.extract_signed_distance_field(
        mask, spec, None, streaming=False), tmp_path)
    assert _in_order(spans) == DENSE_EDT_SPANS
    assert edt.streamed_slabs == before


class _FakeLibrary:
    """Stands in for the built best-first library: every launch succeeds
    and launches nothing."""

    def edt_bestfirst_staged_launch(self, *args):
        return 0

    def edt_bestfirst_cluster_launch(self, *args):
        return 0

    def edt_bestfirst_launch(self, *args):
        return 0


VARIANTS = {
    "staged": (edt_bestfirst.parabolic_envelope_last_staged,
               "launches_staged", (2, 24, 40)),
    "cluster": (functools.partial(
        edt_bestfirst.parabolic_envelope_last_cluster, cluster=2),
        "launches_cluster", (3, 2048)),
    "global": (edt_bestfirst.parabolic_envelope_last_global, "launches",
               (5, 7, 33)),
    "inkernel": (functools.partial(
        edt_bestfirst.parabolic_envelope_last_global, hoist_cmin=False),
        "launches_inkernel", (4, 9, 17)),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_elements_launched_counts_every_variant(monkeypatch, variant):
    """On the CPU with the library faked: each launch adds the elements of
    its ``f``, once, whatever its layout."""
    monkeypatch.setattr(edt_bestfirst, "_library", _FakeLibrary)
    monkeypatch.setattr(edt_bestfirst, "_check_input", lambda f: None)
    monkeypatch.setattr(edt_bestfirst, "_stream_args", lambda f: (0, None))
    monkeypatch.setattr(edt_bestfirst, "_resident_clusters",
                        lambda *args: 1)
    fn, counter, shape = VARIANTS[variant]
    for f in (torch.zeros(shape), torch.zeros(shape[::-1]).transpose(0, -1)):
        elements = edt_bestfirst.elements_launched
        launches = getattr(edt_bestfirst, counter)
        fn(f)
        assert getattr(edt_bestfirst, counter) == launches + 1
        assert edt_bestfirst.elements_launched == elements + f.numel()


# Window 0-1000 us; the benchmark's sdf span 0-1000; the program's vgt.edt
# 0-990: seed_pass 10-200 (a slab_writeback 100-150), envelope 200-600 (a
# slab_writeback 400-450), combine 600-900.


def _streamed_fixture():
    spans = [("portbench.window", 0, 1000), ("portbench.sdf", 0, 1000),
             ("vgt.edt", 0, 990), ("vgt.edt.seed_pass", 10, 190),
             ("vgt.edt.slab_writeback", 100, 50),
             ("vgt.edt.envelope", 200, 400),
             ("vgt.edt.slab_writeback", 400, 50),
             ("vgt.edt.combine", 600, 300)]
    events = [_x("user_annotation", n, ts, dur) for n, ts, dur in spans]
    launches = [(20, "edt_seed_kernel", 30, 60),
                (110, "direct_copy_kernel", 110, 30),
                (210, "edt_bestfirst_staged_kernel", 220, 160),
                (410, "direct_copy_kernel", 410, 30),
                (610, "sqrt_kernel", 620, 200),
                (830, "sub_kernel", 830, 50)]
    for corr, (at, name, ts, dur) in enumerate(launches, 1):
        events += [_x("cuda_runtime", "cudaLaunchKernel", at, 5,
                      correlation=corr),
                   _x("kernel", name, ts, dur, correlation=corr)]
    return events


STREAMED_READERS = {"slab_writeback_ms": 0.03, "combine_ms": 0.125}


@pytest.mark.parametrize("metric", sorted(STREAMED_READERS))
def test_streamed_span_readers(monkeypatch, metric):
    monkeypatch.setattr(tracing, "summarize", tracing.summarize)
    reader = registry.reader(metric)
    assert tracing.summarize is program_spans.summarize

    def run(trace):
        return types.SimpleNamespace(trace=trace, traced_steps=2)

    assert reader.read(run(None)) is None
    assert reader.read(run(tracing.summarize(_fixture(program=False)))) is None
    # The dense fixture has neither span: an older program's streamed EDT.
    assert reader.read(run(tracing.summarize(_fixture()))) is None
    value = reader.read(run(tracing.summarize(_streamed_fixture())))
    assert value == pytest.approx(STREAMED_READERS[metric])
    bench = registry.load_benchmark()
    (entry,) = [m for m in bench["per_layer"] if m["name"] == metric]
    assert (entry["source"], entry["layer"]) == ("program_span", "EDT")
    assert entry["workloads"] == ["kinfu_room_1024x512.map"]


def test_edt_stream_roofline_reads_the_elements(monkeypatch):
    from portbench import harness
    reader = registry.reader("edt_stream_roofline")
    (path,) = reader.COUNTERS["edt_elements"]
    before = harness._counter_value(path)
    monkeypatch.setattr(edt_bestfirst, "elements_launched", before + 7)
    assert harness._counter_value(path) == before + 7

    trace = tracing.TraceSummary(
        window_s=1.0, busy_s=0.5,
        kernel_s={"edt_bestfirst_staged_kernel": 0.003,
                  "edt_bestfirst_cluster_kernel": 0.001,
                  "edt_seed_kernel": 0.002},
        kernel_count={"edt_bestfirst_staged_kernel": 3,
                      "edt_bestfirst_cluster_kernel": 1,
                      "edt_seed_kernel": 2}, idle_gaps=[])

    def run(trace, **counters):
        return types.SimpleNamespace(trace=trace, counters=counters)

    elements = 2 ** 28
    bound_s = 8 * elements / roofline.H100_HBM_BYTES_PER_S
    assert reader.read(run(trace, edt_elements=elements)) == pytest.approx(
        100 * bound_s / 0.004)
    assert reader.read(run(None, edt_elements=elements)) is None
    assert reader.read(run(trace)) is None
    assert reader.read(run(trace, edt_elements=0)) is None
    no_kernels = dataclasses.replace(trace, kernel_s={}, kernel_count={})
    assert reader.read(run(no_kernels, edt_elements=elements)) is None


def test_edt_stream_roofline_names_no_counter_an_older_program_lacks(
        monkeypatch):
    monkeypatch.delattr(edt_bestfirst, "elements_launched")
    assert registry.reader("edt_stream_roofline").COUNTERS == {}
