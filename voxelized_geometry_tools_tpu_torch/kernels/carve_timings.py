"""The carve's scenes, and the carve kernels' times on one CUDA card as one
JSON line.

    python -m voxelized_geometry_tools_tpu_torch.kernels.carve_timings LABEL

prints ``CARVE_TIMINGS {...}``: on the 512^3 pipeline's first camera
(307,200 rays looking +z), on ``bench.py``'s config2 cloud and on the
oblique cloud at 128^3, the time of

* ``zero``: zeroing both int32 grids (``Tensor.zero_``), as a caller of the
  walk kernel must before it;
* ``walk``: the walk kernel (``carve.carve_kernel``) alone, on grids that
  are already zeroed (its atomics add into them);
* ``walk_count``: the same walk with each visit's atomic replaced by a
  count in a register (one store a ray), a variant built here from the
  text of ``csrc/carve.cu`` and nowhere else: the walk's own cost;
* ``walk_fresh``: zeroing and the walk, the carve into fresh grids;
* where the tree has it, ``tiled``: the tiled kernel (``carve.carve_tiled``,
  every pass, fresh grids it writes in full), its first 1, 2, 3 and 4
  passes queued behind a spin of the card (``probes.queued_ms``), its list
  entries, its variants (``TILED_VARIANTS``) in turns, and each tile-pass
  work item's cycles;

with the visits, the card's name and power limit; with ``--sweep``, the
tiled kernel on every pipeline camera, config2 and the oblique cloud for
each tile shape and tile-pass setting of ``SWEEP_TILES`` x
``SWEEP_SETTINGS``, each result checked bitwise against the walk kernel's.
Pass prefixes, variants and settings are builds of ``csrc/carve.cu``'s
text with a few edits (:func:`build_variant`). It calls only entry
points that every version of the port since the carve kernel has (the
tiled kernel only where it exists), so two commits compare in one call on
one card: unpack the other commit's tree (``git archive REV | tar x -C
_scratch/parent``) and run, in turns from each tree's root, ``python3 -c
"$(cat <this file>)" LABEL``. ``chip_smoke.py`` takes its carve scenes from
here.
"""

import contextlib
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from voxelized_geometry_tools_tpu_torch import GridSpec
from voxelized_geometry_tools_tpu_torch.kernels import build, carve
from voxelized_geometry_tools_tpu_torch.kernels.probes import (cuda_ms,
                                                              queued_ms)
from voxelized_geometry_tools_tpu_torch.ops import voxelize

IMG_W, IMG_H = 640, 480
# bench.py:221-236's carve (config2): one 640x480 cloud into 128^3 at 0.02 m.
CARVE_N, CARVE_RES = 128, 0.02
# The pipeline (ROADMAP items 8 and 9): 512^3 at 0.01 m, four 640x480
# depth cameras (benchmarks/sharded_rates.py:66-78's cloud, and the same
# points looking along +x, +y and -z through the grid centre).
PIPE_N, PIPE_RES = 512, 0.01


def config2_points():
    """bench.py:221-236's camera-frame points: a 640x480 depth image of a
    rippled surface 2.0-2.4 m away."""
    cu, cv = np.meshgrid(np.linspace(-0.5, 0.5, 640),
                         np.linspace(-0.4, 0.4, 480), indexing="ij")
    cdep = 2.2 + 0.2 * np.sin(6 * cu) * np.cos(6 * cv)
    return np.stack([cu * cdep, cv * cdep, cdep],
                    -1).reshape(-1, 3).astype(np.float32)


def config2_cloud(device):
    """bench.py:221-236's carve cloud: the camera at (1.28, 1.28, -1.0)
    looking +z into 128^3 at 0.02 m."""
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = (1.28, 1.28, -1.0)
    return voxelize.PointCloud.create(config2_points(), pose, device=device)


def look_along(direction, position):
    """A camera rotation (+z forward) looking along ``direction``, at
    ``position`` (benchmarks/carve_oblique.py:48-67's frame)."""
    fwd = np.asarray(direction, np.float64)
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, 0.0, 1.0])
    if abs(fwd @ up) > 0.9:
        up = np.array([0.0, 1.0, 0.0])
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 0], pose[:3, 1], pose[:3, 2] = right, np.cross(fwd, right), fwd
    pose[:3, 3] = position
    return pose


def oblique_cloud(device):
    """benchmarks/carve_oblique.py:48-67's make_cloud((1, 1, 1)): the
    config2 camera turned to 45 degrees to every grid axis, 1.8 m from the
    128^3 grid's centre."""
    fwd = np.ones(3) / np.sqrt(3.0)
    pose = look_along(fwd, np.full(3, 1.28) - 1.8 * fwd)
    return voxelize.PointCloud.create(config2_points(), pose, device=device)


def pipeline_clouds(device):
    """The pipeline's four 640x480 cameras: benchmarks/sharded_rates.py:
    66-78's cloud (rng 0, looking +z from 0.2 of the grid below it), and
    the same points with the pose turned to look along +x, +y and -z
    through the grid centre from the same distance outside it."""
    n, res = PIPE_N, PIPE_RES
    rng = np.random.default_rng(0)
    w, h = IMG_W, IMG_H
    uv = np.stack(np.meshgrid(
        (np.arange(w) - w / 2) / 600.0, (np.arange(h) - h / 2) / 600.0,
        indexing="xy"), -1)
    depth = (0.55 * n * res) * (1.0 + 0.1 * rng.standard_normal((h, w)))
    pts = np.concatenate([uv * depth[..., None], depth[..., None]],
                         -1).reshape(-1, 3).astype(np.float32)
    center = np.full(3, n * res / 2)
    away = n * res / 2 + 0.2 * n * res
    poses = []
    for axis, sign in ((2, 1.0), (0, 1.0), (1, 1.0), (2, -1.0)):
        fwd = np.zeros(3)
        fwd[axis] = sign
        if (axis, sign) == (2, 1.0):
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = center - away * fwd
        else:
            pose = look_along(fwd, center - away * fwd)
        poses.append(pose)
    return [voxelize.PointCloud.create(pts, p, max_range=2.0 * n * res,
                                       device=device) for p in poses]


def scenes(device):
    """(name, spec, cloud) of each carve this script times."""
    big = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    small = GridSpec.from_voxel_counts(CARVE_RES, (CARVE_N,) * 3)
    return [("pipeline camera 0", big, pipeline_clouds(device)[0]),
            ("config2", small, config2_cloud(device)),
            ("oblique (1, 1, 1)", small, oblique_cloud(device))]


# The register-count variant of the walk kernel: each visit's atomic
# becomes a count, stored once a ray (into seen_filled[r], so the walk is
# not optimized away).
_COUNT_EDITS = (
    ("int kx = 0, ky = 0, kz = 0;", "int kx = 0, ky = 0, kz = 0, count = 0;"),
    ("atomicAdd(seen_free + (cx * nyz + cy * nz + cz), 1);", "++count;"),
    ("      ++kz;\n    }\n  }\n}", "      ++kz;\n    }\n  }\n"
     "  seen_filled[r] = count;\n}"),
)
# Variants of the tiled kernel's tile pass, for its split (their grids are
# wrong except lb3's): "no_atomics" counts a segment's visits in a register
# and adds them once; "no_walk" adds one a segment and walks nothing;
# "no_store" stores no tile.
TILED_VARIANTS = {
    "no_atomics": (
        ("  const int dx = sx * x_stride, dy = sy * y_stride;\n",
         "  const int dx = sx * x_stride, dy = sy * y_stride;\n"
         "  int visits = 0;\n"),
        ("    atomicAdd(s_free + local, 1);\n    if (tx <= ty && tx <= tz) {",
         "    ++visits;\n    if (tx <= ty && tx <= tz) {"),
        ("      if (cz < lo[2] || cz >= hi[2]) break;\n    }\n  }\n}",
         "      if (cz < lo[2] || cz >= hi[2]) break;\n    }\n  }\n"
         "  atomicAdd(s_free, visits);\n}"),
    ),
    "no_walk": (
        ("          walk_segment(en.x, en.y, start, fin, step, t0, dt, g, lo, "
         "hi,\n                       n_steps, s_free);",
         "          atomicAdd(s_free + en.y, 1);"),
    ),
    "no_store": (
        ("                                           int* dst) {\n"
         "  const int per_row",
         "                                           int* dst) {\n  return;\n"
         "  const int per_row"),
    ),
    # Each work item's cycles written over its entry in the item list:
    # (zeroing and walk, the rest).
    "clocked": (
        ("    const int2 item = items[q];\n",
         "    const int2 item = items[q];\n    const long long clk0 = clock64();\n"),
        ("    __syncthreads();\n    if (item.y == 0) {\n",
         "    __syncthreads();\n    const long long clk1 = clock64();\n"
         "    if (item.y == 0) {\n"),
        ("    __syncthreads();  // shared memory and `next` are reused\n",
         "    if (threadIdx.x == 0) const_cast<int2*>(items)[q] = make_int2(\n"
         "        static_cast<int>(clk1 - clk0),\n"
         "        static_cast<int>(clock64() - clk1));\n"
         "    __syncthreads();  // shared memory and `next` are reused\n"),
        ("      __syncthreads();  // `next` is read by every thread before it "
         "changes\n",
         "      if (threadIdx.x == 0) const_cast<int2*>(items)[q] = make_int2(\n"
         "          -1, static_cast<int>(clock64() - clk0));\n"
         "      __syncthreads();  // `next` is read by every thread before it "
         "changes\n"),
    ),
    # The tile pass with at most 40 registers a thread (3 blocks of 512 an
    # SM).
    "lb3": (
        ("__launch_bounds__(TILE_THREADS, 1024 / TILE_THREADS)",
         "__launch_bounds__(TILE_THREADS, 3)"),
    ),
}
# The launch cut after its first 1, 2 and 3 passes (count; scan; fill).
PREFIX_VARIANTS = {
    stages: (("  // Pass %d: " % (stages + 1),
              "  return 0;\n  // Pass %d: " % (stages + 1)),)
    for stages in (1, 2, 3)}


def setting_edits(threads, chunk):
    """Edits that set the tile pass's block size and chunk."""
    return (("constexpr int TILE_THREADS = 512;",
             f"constexpr int TILE_THREADS = {threads};"),
            ("constexpr int CHUNK = 4096;", f"constexpr int CHUNK = {chunk};"))


def build_variant(name, edits):
    """Builds and loads a variant of ``csrc/carve.cu`` made by ``edits``
    (each must match once), with the argument types of the real one."""
    text = (build.SRC_DIR / "carve.cu").read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"carve.cu no longer holds {old!r} once")
        text = text.replace(old, new)
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = build.BUILD_DIR / f"carve_{name}_{os.getpid()}.cu"
    src.write_text(text)
    out = src.with_suffix(".so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, "-o", str(out),
                    str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    real = carve._library()
    for fn in ("carve_walk_launch", "carve_tiled_launch",
               "carve_tile_smem_bytes", "carve_tile_chunk"):
        if hasattr(real, fn):
            getattr(lib, fn).argtypes = getattr(real, fn).argtypes
            getattr(lib, fn).restype = getattr(real, fn).restype
    return lib


@contextlib.contextmanager
def using_library(lib):
    """carve's wrappers launch from ``lib`` (a variant) meanwhile."""
    real = carve._library
    carve._library = lambda: lib
    try:
        yield
    finally:
        carve._library = real


def item_pairs(name, spec, setup, n_steps):
    """Runs the instrumented variant ``name`` once; its pair per work item
    and the per-tile entry counts."""
    free = torch.empty(spec.num_total, dtype=torch.int32, device="cuda")
    filled = torch.empty_like(free)
    with using_library(build_variant(name, TILED_VARIANTS[name])):
        bufs = carve._launch_tiled(spec.counts, setup, n_steps, free, filled,
                                   carve.TILE)
        torch.cuda.synchronize()
    scratch = bufs["scratch"]
    n_tiles = (scratch.numel() - 3) // 4
    n_items = int(scratch[4 * n_tiles + 2])
    counts = scratch[:n_tiles]
    items = bufs["items"][:n_items].long()
    return items, counts


def item_stats(spec, setup, n_steps) -> dict:
    """The tile pass's work items: their cycles (zeroing and walk; the
    rest: stores, flags, endpoints) by the "clocked" variant, summed over
    items with entries and over empty ones."""
    items, counts = item_pairs("clocked", spec, setup, n_steps)
    # The variant overwrote each item with its cycles, an empty tile's as
    # (-1, cycles).
    busy = items[:, 0] >= 0
    walk, rest = items[busy, 0], items[busy, 1]
    out = {"items": items.shape[0], "busy_items": int(busy.sum()),
           "busy_tiles": int((counts > 0).sum()),
           "walk_cycles_sum": int(walk.sum()),
           "rest_cycles_sum": int(rest.sum()),
           "empty_cycles_sum": int(items[~busy, 1].sum()),
           "walk_cycles_max": int(walk.max()),
           "walk_cycles_top5": walk.sort(descending=True).values[:5]
           .tolist()}
    return out


def variant_times(spec, setup, n_steps, reps=10) -> dict:
    """The tiled kernel against its variants on the same inputs, in turns,
    queued."""
    free = torch.empty(spec.num_total, dtype=torch.int32, device="cuda")
    filled = torch.empty_like(free)
    libs = {"tiled": carve._library()}
    libs.update({name: build_variant(name, edits)
                 for name, edits in TILED_VARIANTS.items()
                 if name != "clocked"})
    out = {}
    for name in list(libs) + list(reversed(libs)):
        with using_library(libs[name]):
            out.setdefault(f"turns_{name}_queued_ms", []).append(
                queued_ms(lambda: carve._launch_tiled(
                    spec.counts, setup, n_steps, free, filled, carve.TILE),
                    reps))
    return out


def carve_times(spec, cloud, count_lib, reps=20) -> dict:
    eye = torch.eye(4, device="cuda")
    setup = voxelize.ray_setup(spec, eye, cloud)
    n_steps = carve.segment_steps(sum(spec.counts) + 2)
    free = torch.zeros(spec.num_total, dtype=torch.int32, device="cuda")
    filled = torch.zeros_like(free)
    out = {"rays": setup.hit.shape[0],
           "visits": carve.count_visits(spec.counts, setup, n_steps)}

    def zero():
        free.zero_()
        filled.zero_()

    def walk():
        carve.carve_kernel(spec.counts, setup, n_steps, free, filled)

    def walk_count():
        with using_library(count_lib):
            walk()

    def fresh():
        zero()
        walk()

    fns = {"zero": zero, "walk": walk, "walk_count": walk_count,
           "walk_fresh": fresh}
    tiled = getattr(carve, "carve_tiled", None)
    if tiled is not None:
        fns["tiled"] = lambda: tiled(spec.counts, setup, n_steps, free,
                                     filled)
    # In turns: each function twice, the second round in reverse order.
    order = list(fns) + list(reversed(fns))
    for name in order:
        out.setdefault(name + "_ms", []).append(cuda_ms(fns[name], reps))
    if tiled is not None:
        out["tiled_queued_ms"] = queued_ms(fns["tiled"], reps)
        out.update(tiled_passes(spec, setup, n_steps, free, filled, reps))
        out.update(variant_times(spec, setup, n_steps))
        out["items"] = item_stats(spec, setup, n_steps)
    return out


def tiled_passes(spec, setup, n_steps, free, filled, reps) -> dict:
    """The tiled kernel's passes: the time of its first 1, 2, 3 and 4
    passes (count; scan; fill; tile), queued behind a spin of the card so
    that the wrapper's host time does not pace them, and its list
    entries."""
    libs = [build_variant(f"first_{stages}", edits)
            for stages, edits in PREFIX_VARIANTS.items()]
    libs.append(carve._library())
    out = {"tiled_first_stages_queued_ms": []}
    for lib in libs:
        with using_library(lib):
            out["tiled_first_stages_queued_ms"].append(queued_ms(
                lambda: carve._launch_tiled(spec.counts, setup, n_steps,
                                            free, filled, carve.TILE), reps))
    scratch = carve._launch_tiled(spec.counts, setup, n_steps, free, filled,
                                  carve.TILE)["scratch"]
    n_tiles = (scratch.numel() - 3) // 4
    out["tiled_entries"] = int(scratch[2 * n_tiles])
    out["tiled_busy_tiles"] = int((scratch[:n_tiles] > 0).sum())
    out["tiles"] = n_tiles
    return out


# Tile shapes (x, y, z) and tile-pass settings (block size, chunk) swept
# on every camera.
SWEEP_TILES = ((16, 16, 64), (16, 32, 32), (32, 16, 32), (8, 16, 128),
               (16, 16, 32), (8, 16, 64))
SWEEP_SETTINGS = ((512, 2048), (512, 4096), (512, 16384), (1024, 4096),
                  (256, 2048))


def sweep(reps=10) -> dict:
    """The tiled kernel on every pipeline camera, config2 and the oblique
    cloud for each tile shape and tile-pass setting, each result checked
    bitwise against the walk kernel's."""
    out = {}
    big = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    small = GridSpec.from_voxel_counts(CARVE_RES, (CARVE_N,) * 3)
    cases = [(f"camera {i}", big, c)
             for i, c in enumerate(pipeline_clouds("cuda"))]
    cases += [("config2", small, config2_cloud("cuda")),
              ("oblique", small, oblique_cloud("cuda"))]
    libs = {(t, c): build_variant(f"t{t}_c{c}", setting_edits(t, c))
            for t, c in SWEEP_SETTINGS}
    eye = torch.eye(4, device="cuda")
    for name, spec, cloud in cases:
        setup = voxelize.ray_setup(spec, eye, cloud)
        n_steps = carve.segment_steps(sum(spec.counts) + 2)
        want = [torch.zeros(spec.num_total, dtype=torch.int32,
                            device="cuda") for _ in range(2)]
        carve.carve_kernel(spec.counts, setup, n_steps, *want)
        got = [torch.empty_like(want[0]) for _ in range(2)]
        row = {}
        for tile in SWEEP_TILES:
            for (threads, chunk), lib in libs.items():
                got[0].fill_(-7)
                got[1].fill_(-7)
                with using_library(lib):
                    carve._launch_tiled(spec.counts, setup, n_steps, *got,
                                        tile)
                    if not (torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1])):
                        raise AssertionError(
                            f"{name} {tile} t{threads} c{chunk}: the tiled "
                            "kernel differs from the walk")
                    row[f"{tile} t{threads} c{chunk}"] = cuda_ms(
                        lambda: carve._launch_tiled(
                            spec.counts, setup, n_steps, *got, tile), reps)
            scratch = carve._launch_tiled(spec.counts, setup, n_steps, *got,
                                          tile)["scratch"]
            n_tiles = (scratch.numel() - 3) // 4
            row[f"{tile} entries"] = int(scratch[2 * n_tiles])
        out[name] = row
        del setup, want, got
    return out


def main(label: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("carve_timings: no CUDA device")
    out = {"label": label}
    count_lib = build_variant("count", _COUNT_EDITS)
    with torch.no_grad():
        for name, spec, cloud in scenes("cuda"):
            out[name] = carve_times(spec, cloud, count_lib)
        if "--sweep" in sys.argv:
            out["sweep"] = sweep()

    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("CARVE_TIMINGS " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
