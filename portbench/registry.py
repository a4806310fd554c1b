"""Finds each piece of a cell by the name ``BENCHMARK.json`` gives it.

* a configuration: the ``file`` of its ``configs`` entry;
* a traffic mix: ``portbench/traffic/<traffic>.json``;
* a metric's reader: ``portbench/metrics/<metric>.py`` (loaded by path, so
  a name may hold dots), with a ``read(run)`` that returns a number or
  None;
* a cell's limits for ``correct``: ``portbench/limits/<cell>.json``;
* the kind of loop a traffic mix drives (its ``"loop"``):
  ``portbench/loop_kinds/<kind>.py`` (loaded by path), whose ``LOOP`` is a
  class that keeps the contract of ``loops.Loop``.

A later change adds a configuration, a mix, a metric, a cell or a kind of
loop by adding such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HERE = Path(__file__).resolve().parent
REPO = HERE.parent


def load_benchmark(path: Path = REPO / "BENCHMARK.json") -> dict:
    with open(path) as f:
        return json.load(f)


def _entry(entries: List[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json names no {what} {name!r}")


def workload(bench: dict, name: str) -> dict:
    return _entry(bench["workloads"], name, "workload")


def config(bench: dict, name: str, repo: Path = REPO) -> dict:
    entry = _entry(bench["configs"], name, "config")
    with open(repo / entry["file"]) as f:
        return json.load(f)


def traffic(name: str, root: Path = HERE) -> dict:
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def limits(cell: str, root: Path = HERE) -> Dict[str, float]:
    with open(root / "limits" / f"{cell}.json") as f:
        return json.load(f)


def _load(path: Path, module_name: str, what: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no {what} at {path}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader(metric: str, root: Path = HERE) -> ModuleType:
    return _load(root / "metrics" / f"{metric}.py",
                 f"portbench_metric_{metric.replace('.', '_')}",
                 f"reader for metric {metric!r}")


def loop(kind: str, root: Path = HERE) -> type:
    """The ``LOOP`` class of ``loop_kinds/<kind>.py``."""
    return _load(root / "loop_kinds" / f"{kind}.py",
                 f"portbench_loop_{kind.replace('.', '_')}",
                 f"loop kind {kind!r}").LOOP


def metrics_of(bench: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced. An end-to-end metric without a
    ``workloads`` list is every cell's; a per-layer one without it is every
    cell's that reports the end-to-end metric it moves."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in moved)]
