"""A small CPU rehearsal of each cell's loop through the port, and the
faults and the control that the check must catch."""

import time

import pytest
import torch

from portbench import harness, registry
from portbench.tests.conftest import small_config

BENCH = registry.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


def _run(cell, seed=2 ** 31 + 99, **kw):
    w = registry.workload(BENCH, cell)
    return harness.run_cell(cell, seed, 0.2, False, time.perf_counter(),
                            device="cpu", config=small_config(w["config"]),
                            **kw)


@pytest.mark.parametrize("cell", CELLS)
def test_rehearsal_is_correct_and_reports_no_device_metric(cell):
    r = _run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["metrics"] == {}
    assert r["device"]["platform"] == "cpu"
    assert list(r)[-1] == "checks"
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_bfloat16_is_not_correct(cell):
    r = _run(cell, control=torch.bfloat16)
    limits = registry.limits(cell)
    assert any(v > limits[k] for k, v in r["control"].items())


def _fault_unchanged(monkeypatch):
    from voxelized_geometry_tools_tpu_torch.models import online_mapper
    from voxelized_geometry_tools_tpu_torch.ops import backends
    monkeypatch.setattr(online_mapper.OnlineMapper, "integrate",
                        lambda self, cloud: self.occupancy_map)
    monkeypatch.setattr(
        backends.AcceleratorPointCloudVoxelizer, "voxelize_pointclouds",
        lambda self, env, options, clouds, runtime_log_fn=None: env)


def _fault_half_batch(monkeypatch):
    from voxelized_geometry_tools_tpu_torch.models import online_mapper
    from voxelized_geometry_tools_tpu_torch.ops import backends, voxelize
    one = online_mapper.OnlineMapper._integrate_one
    many = backends.AcceleratorPointCloudVoxelizer.voxelize_pointclouds

    def half(cloud):
        n = cloud.points.shape[0] // 2
        return voxelize.PointCloud(cloud.points[:n], cloud.origin_transform,
                                   cloud.max_range)

    monkeypatch.setattr(online_mapper.OnlineMapper, "_integrate_one",
                        lambda self, occ, cloud: one(self, occ, half(cloud)))
    monkeypatch.setattr(
        backends.AcceleratorPointCloudVoxelizer, "voxelize_pointclouds",
        lambda self, env, opts, clouds, runtime_log_fn=None: many(
            self, env, opts, clouds[:max(1, len(clouds) // 2)]
            if len(clouds) > 1 else [half(clouds[0])], runtime_log_fn))


def _fault_altered_answer(monkeypatch):
    from voxelized_geometry_tools_tpu_torch.ops import edt
    real = edt.signed_distance_from_filled_mask

    def altered(*a, **k):
        out = real(*a, **k)
        out[3, 4, 5] += 0.01
        return out

    monkeypatch.setattr(edt, "signed_distance_from_filled_mask", altered)


FAULTS = {"state_unchanged": _fault_unchanged,
          "half_batch": _fault_half_batch,
          "altered_answer": _fault_altered_answer}


def _faults():
    for cell in CELLS:
        for name, fault in FAULTS.items():
            yield pytest.param(cell, fault, id=f"{cell}-{name}")


@pytest.mark.parametrize("cell,fault", _faults())
def test_fault_makes_the_run_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    r = _run(cell)
    assert not r["correct"]
    assert r["failed"] >= 1


def test_cuda_run_of_a_small_cell(cuda_device):
    cell = CELLS[0]
    w = registry.workload(BENCH, cell)
    r = harness.run_cell(cell, 17, 1.0, True, time.perf_counter(),
                         device=cuda_device,
                         config=small_config(w["config"]))
    assert r["correct"]
    assert r["device"]["platform"] == "gpu"
    assert 0 < r["device"]["busy_s"] <= r["device"]["window_s"]
