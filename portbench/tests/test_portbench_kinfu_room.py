"""The 6 mm room (``kinfu_room_1024x512``): its configuration against the
one it shares a room, camera and path with, the metrics its cell reports,
and its loop rehearsed on the CPU on the slab-streamed EDT that the full
grid takes by the port's own size rule."""

import copy
import math
import time

import pytest
import torch

from portbench import harness, registry
from voxelized_geometry_tools_tpu_torch.ops import edt

BENCH = registry.load_benchmark()
CELL = "kinfu_room_1024x512.map"
CONFIG = registry.config(BENCH, "kinfu_room_1024x512")
BASE = registry.config(BENCH, "tum_kinect_512")

E2E = ["frame_ms_p95", "frames_per_s", "setup_s"]
LAYERS = ["fuse_ms", "sdf_ms", "carve_roofline", "idle_share.map",
          "ray_setup_ms", "filter_busy_ms", "edt_glue_ms", "idle_ms.fusion",
          "idle_ms.edt", "host_waits", "edt_stream_roofline",
          "slab_writeback_ms", "combine_ms"]
# The accepted cells' metrics, which adding this cell leaves as they were.
DENSE_LAYERS = ["fuse_ms", "sdf_ms", "carve_roofline", "edt_roofline",
                "idle_share.map", "ray_setup_ms", "filter_busy_ms",
                "edt_glue_ms", "idle_ms.fusion", "idle_ms.edt", "host_waits"]
ACCEPTED = {"tum_kinect_512.map": DENSE_LAYERS,
            "pair_kinect_512.fuse": DENSE_LAYERS[:1] + ["filter_ms"]
            + DENSE_LAYERS[1:]}


def _names(cell, traced):
    return [m["name"] for m in registry.metrics_of(BENCH, cell, traced)]


def test_cell_reports_exactly_its_metrics():
    assert _names(CELL, False) == E2E
    assert sorted(_names(CELL, True)) == sorted(LAYERS)


@pytest.mark.parametrize("cell", sorted(ACCEPTED))
def test_accepted_cells_report_what_they_did(cell):
    assert _names(cell, False) == E2E
    assert _names(cell, True) == ACCEPTED[cell]


def test_cell_takes_one_chip_and_the_map_mix():
    w = registry.workload(BENCH, CELL)
    assert (w["config"], w["traffic"], w["chips"]) == (
        "kinfu_room_1024x512", "map", 1)


def test_configuration_is_the_room_at_six_millimetres():
    grid = CONFIG["grid"]
    assert grid == {"counts": [1024, 1024, 512], "resolution": 0.006}
    assert math.prod(grid["counts"]) == 2 ** 29
    # Nothing else of the deployment changes but where the room lies.
    for key in ("dtype", "camera", "noise", "fusion", "path"):
        assert CONFIG[key] == BASE[key], key
    room, base = CONFIG["room"], BASE["room"]
    assert {k: v for k, v in room.items() if k not in ("lo", "hi")} == {
        k: v for k, v in base.items() if k not in ("lo", "hi")}
    extent = [c * grid["resolution"] for c in grid["counts"]]
    for a in range(3):
        assert room["hi"][a] - room["lo"][a] == pytest.approx(
            base["hi"][a] - base["lo"][a])
        assert room["lo"][a] + room["hi"][a] == pytest.approx(extent[a])
    assert CONFIG["reduced"] == []


def test_full_grid_takes_the_streamed_edt():
    """By the port's own size rule; a frame's EDT then walks 48 slabs (8
    a pass, three passes, two fields), 32 of them best-first launches and
    16 seed launches."""
    counts = CONFIG["grid"]["counts"]
    assert math.prod(counts) >= edt._STREAMING_AUTO_VOXELS
    per_pass = [len(edt._slabs(counts[edt._streamed_slab_axis(counts, a)],
                               128)) for a in range(3)]
    assert per_pass == [8, 8, 8]
    assert 2 * sum(per_pass) == 48


def _small_streamed_config():
    """The configuration at a size the CPU holds, over the same 6.144 x
    6.144 x 3.072 m box: 64 x 64 x 32 voxels of 0.096 m, 64 x 48 images
    with the intrinsics scaled alike, 8 poses of the path."""
    c = copy.deepcopy(CONFIG)
    c["grid"] = {"counts": [64, 64, 32], "resolution": 0.096}
    c["camera"].update(width=64, height=48, fx=52.5, fy=52.5, cx=31.5,
                       cy=23.5)
    c["path"]["poses"] = 8
    return c


def _run(monkeypatch, **kw):
    monkeypatch.setattr(edt, "_STREAMING_AUTO_VOXELS", 64 * 64 * 32)
    return harness.run_cell(CELL, 2 ** 31 + 21, 0.2, False,
                            time.perf_counter(), device="cpu",
                            config=_small_streamed_config(), **kw)


def test_streamed_rehearsal_is_correct(monkeypatch):
    slabs = edt.streamed_slabs
    r = _run(monkeypatch)
    assert edt.streamed_slabs > slabs
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 1
    assert r["checks"]["sdf_mismatch_voxels"]["value"] == 0
    assert r["metrics"] == {}


def test_streamed_control_in_bfloat16_is_not_correct(monkeypatch):
    r = _run(monkeypatch, control=torch.bfloat16)
    limits = registry.limits(CELL)
    assert any(v > limits[k] for k, v in r["control"].items())


def test_streamed_altered_answer_is_not_correct(monkeypatch):
    real = edt.signed_distance_from_filled_mask_streamed

    def altered(*a, **k):
        out = real(*a, **k)
        out[3, 4, 5] += 0.01
        return out

    monkeypatch.setattr(edt, "signed_distance_from_filled_mask_streamed",
                        altered)
    r = _run(monkeypatch)
    assert not r["correct"]
    assert r["checks"]["sdf_mismatch_voxels"]["value"] >= 1
