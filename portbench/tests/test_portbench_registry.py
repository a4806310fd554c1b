"""BENCHMARK.json keeps to its contract, every piece it names is found by
name, and a piece added only as files is found too."""

import json
import re
import textwrap

import pytest

from portbench import registry

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
    assert registry.traffic(w["traffic"])["loop"]
    assert registry.limits(w["name"])
    for traced in (False, True):
        for m in registry.metrics_of(BENCH, w["name"], traced):
            assert callable(registry.reader(m["name"]).read)


def test_configs_reduce_nothing():
    for c in BENCH["configs"]:
        assert c["reduced"] == registry.config(BENCH, c["name"])["reduced"]


def test_a_piece_added_as_files_is_found(tmp_path):
    (tmp_path / "traffic").mkdir()
    (tmp_path / "metrics").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "traffic" / "burst.json").write_text(
        json.dumps({"loop": "mapper", "warm_frames": 2}))
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


@pytest.mark.parametrize("path", sorted((registry.HERE / "metrics").glob(
    "*.py")), ids=lambda p: p.stem)
def test_every_reader_reads_a_record(path):
    """Each reader gives a number, or None where its record holds nothing
    to read."""
    from portbench.harness import RunRecord
    from portbench.tracing import Spans, TraceSummary
    spans = Spans()
    for name in ("fuse", "filter", "sdf"):
        spans.add(name, 0.01)
    cfg = registry.config(BENCH, "tum_kinect_512")
    trace = TraceSummary(window_s=1.0, busy_s=0.25,
                         kernel_s={"carve_tile_kernel": 0.002,
                                   "edt_bestfirst_staged_kernel": 0.004},
                         kernel_count={"carve_tile_kernel": 2,
                                       "edt_bestfirst_staged_kernel": 4},
                         idle_gaps=[])
    for t in (None, trace):
        run = RunRecord(cell="x", config=cfg, traffic={},
                        latencies=[0.05] * 20, elapsed_s=1.0, setup_s=9.0,
                        spans=spans, trace=t,
                        counters={"carve_launches": 2, "edt_launches": 4},
                        traced_steps=2)
        v = registry.reader(path.stem).read(run)
        assert v is None or (isinstance(v, float) and v >= 0)
        if t is not None and "roofline" in path.stem:
            assert 0 < v <= 100
