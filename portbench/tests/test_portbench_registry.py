"""BENCHMARK.json keeps to its contract, every piece it names is found by
name, and a piece added only as files is found too."""

import json
import re
import textwrap

import pytest
import torch

from portbench import registry
from portbench.loops import Loop
from portbench.tests.conftest import small, small_config

BENCH = registry.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_keys_and_shapes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["portbench"]
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in {"host_clock", "device_trace"}
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in SOURCES
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    for n in names:
        assert NAME.match(n), n
    for k in ("workloads", "end_to_end", "per_layer", "configs"):
        assert len({x["name"] for x in BENCH[k]}) == len(BENCH[k])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_every_cell_reports_setup_another_metric_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for w in BENCH["workloads"]:
        got = [m["name"] for m in registry.metrics_of(BENCH, w["name"],
                                                      False)]
        assert "setup_s" in got and len(got) >= 2
        layers = registry.metrics_of(BENCH, w["name"], True)
        assert layers
        for m in layers:
            assert m["moves"] in got and m["moves"] in e2e


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_named_pieces_are_found(w):
    cfg = registry.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    assert issubclass(registry.loop(registry.traffic(w["traffic"])["loop"]),
                      Loop)
    assert registry.limits(w["name"])
    for traced in (False, True):
        for m in registry.metrics_of(BENCH, w["name"], traced):
            assert callable(registry.reader(m["name"]).read)


def test_configs_reduce_nothing():
    for c in BENCH["configs"]:
        assert c["reduced"] == registry.config(BENCH, c["name"])["reduced"]


# A kind of loop of its own, as a later cell adds one: it keeps a running
# sum of seeded rows on its device and compares it with a float64 one.
TOY_KIND = """
    import torch

    from portbench.loops import Loop


    class ToyLoop(Loop):
        def setup(self):
            g = torch.Generator(device=self.device).manual_seed(self.seed)
            self.rows = torch.rand(self.traffic["rows"], 4, generator=g,
                                   device=self.device)
            self.total = torch.zeros(4, device=self.device)
            self.calls = []

        def warm_up(self, spans):
            self.calls.append("warm_up")

        def before_step(self, i, elapsed_s, seconds):
            self.calls.append("before_step")

        def step(self, i, spans, traced):
            with spans.span("sum", traced):
                self.total += self.rows[i % len(self.rows)]
            self.steps = i + 1

        def after_step(self, i):
            self.calls.append("after_step")

        def end_window(self):
            self.calls.append("end_window")

        def check(self, control=None):
            want = self.rows[:self.steps].double().sum(0)
            got = self.total if control is None else want.to(control)
            return {"sum_gap": float((got.double() - want).abs().max())}


    LOOP = ToyLoop
"""


def test_a_piece_added_as_files_is_found(tmp_path):
    from portbench.tracing import Spans
    for d in ("traffic", "metrics", "limits", "loop_kinds"):
        (tmp_path / d).mkdir()
    (tmp_path / "traffic" / "burst.json").write_text(
        json.dumps({"loop": "toy", "warm_frames": 2, "rows": 3}))
    (tmp_path / "loop_kinds" / "toy.py").write_text(
        textwrap.dedent(TOY_KIND))
    (tmp_path / "metrics" / "new_metric.map.py").write_text(
        textwrap.dedent("""
            def read(run):
                return 42.0
        """))
    (tmp_path / "limits" / "x.burst.json").write_text('{"a": 1}')
    assert registry.traffic("burst", root=tmp_path)["warm_frames"] == 2
    assert registry.reader("new_metric.map", root=tmp_path).read(None) == 42
    assert registry.limits("x.burst", root=tmp_path) == {"a": 1}
    bench = dict(BENCH, per_layer=BENCH["per_layer"] + [
        {"name": "new_metric.map", "unit": "ms", "better": "lower",
         "source": "host_clock", "layer": "fusion",
         "moves": "frames_per_s"}])
    cell = BENCH["workloads"][0]["name"]
    assert "new_metric.map" in [m["name"] for m in
                                registry.metrics_of(bench, cell, True)]

    traffic = registry.traffic("burst", root=tmp_path)
    kind = registry.loop(traffic["loop"], root=tmp_path)
    assert issubclass(kind, Loop)
    loop = kind({"name": "toy"}, traffic, 2 ** 31 + 5, "cpu")
    spans = Spans()
    loop.setup()
    loop.warm_up(spans)
    loop.before_step(0, 0.0, 1.0)
    loop.step(0, spans, traced=False)
    loop.after_step(0)
    loop.end_window()
    assert loop.calls == ["warm_up", "before_step", "after_step",
                          "end_window"]
    assert len(spans.durations["sum"]) == 1
    assert loop.check() == {"sum_gap": 0.0}
    assert loop.check(torch.bfloat16)["sum_gap"] > 0


def test_an_unknown_loop_kind_names_the_path(tmp_path):
    with pytest.raises(FileNotFoundError,
                       match=str(tmp_path / "loop_kinds" / "nothing.py")):
        registry.loop("nothing", root=tmp_path)


def test_a_rehearsal_block_sets_the_cpu_sizes():
    """A configuration's ``rehearsal`` object lies over the shared CPU
    sizes, nested objects key by key; one without it keeps them."""
    base = registry.config(BENCH, "tum_kinect_512")
    assert "rehearsal" not in base
    assert small(base) == small_config("tum_kinect_512")
    cfg = dict(base, queries={"count": 100000, "kind": "interpolate"},
               rehearsal={"grid": {"counts": [16, 16, 8]},
                          "queries": {"count": 50}, "path": {"poses": 4}})
    got = small(cfg)
    assert got["grid"] == {"counts": [16, 16, 8], "resolution": 0.16}
    assert got["queries"] == {"count": 50, "kind": "interpolate"}
    assert got["path"] == dict(base["path"], poses=4)
    assert got["camera"] == small(base)["camera"]
    assert cfg["queries"]["count"] == 100000


READERS = sorted((registry.HERE / "metrics").glob("*.py"))
# Every program counter that some reader names, so that each reader finds
# its own counter in the record.
COUNTERS = sorted({k for p in READERS
                   for k in getattr(registry.reader(p.stem), "COUNTERS", {})})
# Every kernel the port's CUDA sources define, so that a roofline reader
# finds its kernel's device time in the trace.
PORT_KERNELS = sorted({k for p in (
    registry.REPO / "voxelized_geometry_tools_tpu_torch" / "kernels"
    / "csrc").glob("*.cu") for k in re.findall(
        r"__global__\s.*?\b(\w+_kernel)\s*\(", p.read_text(), re.S)})


def test_the_record_holds_every_counter_and_kernel():
    assert {"carve_launches", "edt_launches", "edt_elements"} <= set(
        COUNTERS)
    assert {"carve_tile_kernel", "edt_bestfirst_staged_kernel"} < set(
        PORT_KERNELS)


@pytest.mark.parametrize("path", READERS, ids=lambda p: p.stem)
def test_every_reader_reads_a_record(path):
    """Each reader gives a number, or None where its record holds nothing
    to read; a roofline reader, a share in (0, 100] of a trace that holds
    every kernel of the port and a record that holds every counter."""
    from portbench.harness import RunRecord
    from portbench.tracing import Spans, TraceSummary
    spans = Spans()
    for name in ("fuse", "filter", "sdf"):
        spans.add(name, 0.01)
    cfg = registry.config(BENCH, "tum_kinect_512")
    kernel_s = dict.fromkeys(PORT_KERNELS, 0.002)
    kernel_s["edt_bestfirst_staged_kernel"] = 0.004
    kernel_count = dict.fromkeys(PORT_KERNELS, 1)
    kernel_count.update(carve_tile_kernel=2, edt_bestfirst_staged_kernel=4)
    trace = TraceSummary(window_s=1.0, busy_s=0.25, kernel_s=kernel_s,
                         kernel_count=kernel_count, idle_gaps=[])
    counters = dict.fromkeys(COUNTERS, 1)
    counters.update(carve_launches=2, edt_launches=4)
    for t in (None, trace):
        run = RunRecord(cell="x", config=cfg, traffic={},
                        latencies=[0.05] * 20, elapsed_s=1.0, setup_s=9.0,
                        spans=spans, trace=t, counters=counters,
                        traced_steps=2)
        v = registry.reader(path.stem).read(run)
        assert v is None or (isinstance(v, float) and v >= 0)
        if t is not None and "roofline" in path.stem:
            assert 0 < v <= 100
