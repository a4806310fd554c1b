"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (one nvcc per source, in
parallel), checks each bit for bit against its plain PyTorch version (the
EDT's seed kernel on masks of every kind and layout, with its launch count,
its span's host waits and its 512^3 time against its byte bound; the
fusion filter kernel at each benchmark cell's shape and on a ragged grid
given unaligned and non-contiguous, with the same counts and its times
against its byte bound; the EDT's signed combine kernel on the cells'
fields in both types, each form and in place, with its launch count, its
place right after the z pass and its times against its byte bound), then
drives the main path at full size (512^3 two-field EDT -> corner table ->
640x480 sphere-traced renders, the scene and camera of bench.py) and the
differentiable ``entry()``, checking every result. Then it drives every
other EDT backend through the same 512^3 EDT (the full sweep's staged
variant with its times against the sweep's own floor, the windowed walk's
staged variant with its walk count), the best-first kernel's clustered
variant and the full sweep's and the windowed walk's global variants
through an EDT whose axes are too long for the staged ones, the best-first
kernel's global variant through an axis beyond a cluster's reach,
the large-grid path (a 1024^3 signed EDT that takes the slab-streamed
pipeline on its own, and a render from it without a corner table), the
primitive-rate probes' entry point (``kernels.probes.main``, the
counterpart of benchmarks/inkernel_microbench.py, with the card's launch
floor) with each probe held against its plain version, and bench.py's
shipped early-exit schedule (cone prepass, block-sorted tail, sparse final
sample) on the sphere and clutter scenes. Last, the pointcloud carve:
bench.py's config2 cloud and an oblique one into 128^3 through the tiled
carve kernel, bitwise against the plain walk (on the card and on the CPU),
the tiled plain model and the plain column carve, the kernel timed with
the native CPU runtime's rate beside it; and the pipeline (carve -> fuse
-> EDT -> render, ``reconstruct``) at 512^3 with four 640x480 cameras
through the best-available voxelizer, each camera's tiled carve held
against the plain carves, and the kernel timed on the first camera. Then
the carve under rotated grid origins (fault F1's 64^3 input and the first
pipeline camera into 512^3: X_GC on the card bitwise equal to the CPU's,
the tiled kernel to the plain walk), the online mapper at 512^3 (integrate
and integrate_frames bitwise equal to each other and to the plain walk
followed by the fusion filter, its SDF through the staged EDT kernel, a
render and a localize) and the fits on bench.py's sphere (the pose fit
with and without remat, the voxel fit with a brick-table and a pair-table
request, pair-table queries bitwise against brick-table queries). Last,
the SDF's other consumers on bench.py's 512^3 sphere (``phase_queries``):
the mip skip and relaxed renders against the plain early-exit render, a
batch of four views each bitwise its own render, their clouds re-carved
into a fresh mapper, 10^6-point queries, gradients and projections against
the CPU, the extrema map and the float64 SDF. Then the grid helpers and the
callables tests/test_torch_api_coverage.py holds against the JAX package
(``phase_api``): 10^6 points under a rotated origin through
``location_to_grid_index``, ``check_location_in_bounds`` and
``estimate_distance_interpolate``, and 512^3 face adjacency, filled
masks, the free-and-named merge and an isosurface's rasterization, each
bitwise against the CPU. Then the geometry and host-side
modules at 512^3 (``phase_geometry``): the sphere's SDF through
``map_ops``, its isosurface (welded, written as OBJ, its statistics, and
rasterized back into a fresh map) and the analytic sphere field's; the
component maps of the sphere, a torus and a hollow cube with their
surfaces and holes and voids; bench.py's clutter tagged by component
with per-object SDFs and meshes and spatial segments; the same scenes at
128^3 on the card and the CPU, bitwise; the pipeline's clouds into a
fresh mapper and its mesh; serialization, the DSH map with 10^6 packed
lookups, and the viz exporters. Then the sharded path
(``phase_sharded``): four gloo ranks on the card at 512^3 (the pipeline's
carve and fusion into Z slabs, both SDFs, the pixel-row and grid-sharded
renders, the X-slab isosurface) held against the single-device port, a
one-rank NCCL world, ``dryrun_multichip(4)``; and the nine examples at
their defaults (``phase_examples``). Prints
human-readable lines, then a JSON line describing each kernel, then
``{"ok": true, "device": ...}`` as the last line. Any failure raises, and
the script exits non-zero; without a CUDA card it exits non-zero before
doing anything.
"""

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

import numpy as np
import torch

from voxelized_geometry_tools_tpu_torch.kernels import probes
from voxelized_geometry_tools_tpu_torch.kernels.carve_timings import (
    CARVE_N, CARVE_RES, PIPE_N, PIPE_RES, config2_cloud, look_along,
    oblique_cloud, pipeline_clouds)
from voxelized_geometry_tools_tpu_torch.kernels.edt_timings import (
    large_sphere_mask, sphere_mask, stacked_passes)
from voxelized_geometry_tools_tpu_torch.kernels.probes import cuda_ms

GRID_N = 512
RESOLUTION = 0.01
IMG_W, IMG_H = 640, 480
NUM_STEPS = 64
LARGE_N = 1024
CSRC = "voxelized_geometry_tools_tpu_torch/kernels/csrc/"
PALLAS = "voxelized_geometry_tools_tpu/kernels/edt_pallas.py:"
# Each kernel of the port: (source, the TPU kernel it replaces). The
# best-first source holds four: the staged variant (either hoist_cmin,
# every axis whose 32-line block fits shared memory: the main path's), the
# clustered variant (either hoist_cmin, longer axes up to a cluster's
# reach: the redesign of the in-kernel-minima kernel for them) and the
# global variant with hoisted and with in-kernel chunk minima. The
# full-sweep and the windowed sources hold two each: the staged variant
# and, for longer axes, the global one.
KERNELS = {
    "edt_bestfirst_staged": (CSRC + "edt_bestfirst.cu", PALLAS + "301"),
    "edt_bestfirst_cluster": (CSRC + "edt_bestfirst.cu", PALLAS + "241"),
    "edt_bestfirst": (CSRC + "edt_bestfirst.cu", PALLAS + "301"),
    "edt_bestfirst_inkernel": (CSRC + "edt_bestfirst.cu", PALLAS + "241"),
    "edt_envelope_staged": (CSRC + "edt_envelope.cu", PALLAS + "111"),
    "edt_envelope_global": (CSRC + "edt_envelope.cu", PALLAS + "111"),
    "edt_windowed_staged": (CSRC + "edt_windowed.cu", PALLAS + "161"),
    "edt_windowed_global": (CSRC + "edt_windowed.cu", PALLAS + "161"),
}
# The 512^3 signed EDT through each kernel backend: (backend, hoist_cmin,
# the kernel that must run it).
SWEEP = (("cuda-bestfirst", True, "edt_bestfirst_staged"),
         ("cuda-bestfirst", False, "edt_bestfirst_staged"),
         ("cuda-envelope", True, "edt_envelope_staged"),
         ("cuda-windowed", True, "edt_windowed_staged"))
# An axis too long for the staged blocks: the clustered and global
# variants' EDT grid is [GLOBAL_X, GLOBAL_N, GLOBAL_N].
GLOBAL_N, GLOBAL_X = 2048, 4
# An axis beyond an 8-CTA cluster's reach: the best-first kernel's global
# variant takes the z pass of an EDT of this grid.
LONG_SHAPE = (4, 16, 12_800)
# Cluster sizes the clustered variant is also forced to in the
# kernel-vs-plain cases (besides its plan's).
FORCED_CLUSTERS = (4, 8)
# Envelope-kernel cases: axis lengths, the last only for the global variants.
ENVELOPE_NS = (37, 300, 512, 513, 1024, GLOBAL_N)
# H100 SXM peaks (NVIDIA's data sheet, 700 W): HBM bytes/s, float32
# add/multiply/FMA instructions/s (67 TFLOP/s counting an FMA as two
# operations), and float32 min/max instructions/s, which issue at half that
# rate (64 against 128 per SM per clock, CUDA C++ guide's throughput table).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 33.5e12
F32_MINMAX_PER_S = F32_OPS_PER_S / 2
MICROBENCH = "benchmarks/inkernel_microbench.py:"
# The probe kernels: (the TPU kernel each replaces, the key of its time in
# the JSON of kernels.probes.main, and the rows that time is per).
PROBES = {
    "vmem_gather": (MICROBENCH + "68", "vmem_gather_ns_per_row",
                    probes.GATHER_ITERS),
    "vmem_scatter": (MICROBENCH + "95", "vmem_scatter_ns_per_row_4096",
                     probes.SCATTER_ITERS),
    "hbm_dma": (MICROBENCH + "121", "hbm_dma_ns_per_row_depth8",
                probes.DMA_ITERS),
    "vmem_batch_march": (MICROBENCH + "170",
                         "march_step_ns_per_ray_batch256",
                         probes.MARCH_STEPS * 256),
}
LIBRARIES = ("edt_bestfirst", "edt_envelope", "edt_windowed", "probes",
             "carve", "edt_seed", "fusion_filter", "edt_combine", "ray_setup",
             "transform_product")
# The carve kernel replaces no TPU kernel: the JAX package carves with XLA
# scatters in while-loops (raycast_pointcloud and its column twin).
CARVE_REPLACES = "voxelized_geometry_tools_tpu/ops/voxelize.py:357"
# Nor do the setup kernel and the transform product kernel: the JAX
# package sets rays up with XLA elementwise operations (_prepare_rays,
# _ray_visits) and forms transform products as XLA dots (compose).
SETUP_REPLACES = "voxelized_geometry_tools_tpu/ops/voxelize.py:242"
PRODUCT_REPLACES = "voxelized_geometry_tools_tpu/core/transforms.py:128"
# Nor does the EDT's seed kernel: the JAX package takes the axis-0 binary
# pass with XLA cummax scans (_binary_squared_dist_last).
SEED_REPLACES = "voxelized_geometry_tools_tpu/ops/edt.py:50"
# Nor does the fusion filter's: the JAX package fuses with XLA elementwise
# operations (counts_seen_as and combine_and_filter).
FILTER_REPLACES = "voxelized_geometry_tools_tpu/ops/voxelize.py:1156"
# The fusion filter kernel's checks and times: (cameras, grid) of each
# benchmark cell (the map's and the pair's 512^3, the 6 mm room's
# 1024 x 1024 x 512), then a ragged grid whose inputs are also given
# unaligned (by 4 bytes) and non-contiguous.
FILTER_SHAPES = ((1, (512, 512, 512)), (2, (512, 512, 512)),
                 (1, (1024, 1024, 512)))
FILTER_RAGGED = (257, 129, 67)
# Nor does the EDT's signed combine kernel: the JAX package combines with
# XLA elementwise operations (sqrt, products and a difference).
COMBINE_REPLACES = "voxelized_geometry_tools_tpu/ops/edt.py:229"
# The combine kernel's checks and times at each cell's field: the map's and
# the pair's dense 512^3 EDT (bench.py's sphere, its stacked [1024, 512,
# 512] field), and the 6 mm room's streamed 1024 x 1024 x 512 EDT (a
# centered sphere), whose two fields are combined in one pass.
COMBINE_DENSE_N = 512
COMBINE_ROOM_SHAPE = (1024, 1024, 512)
# Float32 operations a voxel of the combine: two square roots, two
# products, a difference.
COMBINE_OPS = 5
# Runtime calls that hold the host until the card has caught up (the ones
# portbench/program_spans.py counts as host waits).
BLOCKING_CALLS = frozenset(("cudaStreamSynchronize", "cudaDeviceSynchronize",
                            "cudaEventSynchronize", "cudaMemcpy"))
# The carve scenes (kernels/carve_timings.py): bench.py:221-236's config2
# (one 640x480 cloud into CARVE_N^3), an oblique cloud, and the pipeline's
# four 640x480 cameras into PIPE_N^3 (ROADMAP items 8 and 9).
# int32 adds per second on the H100 SXM: 64 a clock per SM (the CUDA C++
# guide's throughput table), 132 SMs at the 1,980 MHz boost clock. A
# device-memory atomic costs at least one add; it is priced at this rate.
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# The carve kernel's per-ray inputs (kernels/carve.py::RaySetup): start,
# final, step, t0, dt (3 x 4 bytes each), hit and end_filled (1 byte
# each), end_flat (4 bytes).
CARVE_RAY_BYTES = 5 * 12 + 2 + 4
# bench.py's shipped render schedule (bench.py:124-128).
SCHEDULE = dict(early_exit=True, coarse_factor=8, head_steps=0,
                tail_chunks=32, cone_steps=32, cone_tail_chunks=8)
SCHEDULE_FRAMES = 3
# Device memory the streamed 1024^3 signed EDT may allocate (its peak less
# what was allocated before the call, so the small tensors that earlier
# phases leave do not count): what the call allocated before the staged
# kernel, kernels/edt_timings.py's streamed_growth_bytes on the commit before
# it, on an H100 (set by the signed combine; with the 1 GiB mask held, a
# peak of 13.75 GiB).
STREAMED_GROWTH_BYTES = 13_690_213_376
# Render contract (as tests/test_torch_render.py): depth within 1e-4 m on
# common hits; hit flips only on tangent grazers, at most 0.5% of pixels.
DEPTH_ATOL = 1e-4
MAX_HIT_FLIPS = 0.005
GRAZER_BAND = 0.08
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4
# The device-memory gather on a non-integer table against a float64 sum of
# the same rows, relative to the rows' absolute sum: its float32 order of
# adds reads about 1e-8 there on an H100, while one row of the 20,000
# dropped or doubled moves it by about 5e-5.
DMA_REL_TOL = 1e-6
# Calls of a probe wrapper whose host time is averaged.
HOST_REPS = 50


def log(*args):
    print(*args, flush=True)


def max_abs_err(got, ref):
    """Largest |got - ref|, counting equal entries (inf included) as 0."""
    diff = torch.where(got == ref, torch.zeros_like(got), (got - ref).abs())
    return float(diff.max()) if diff.numel() else 0.0


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() "
                         "is False); this script runs only on a CUDA card")
    name = torch.cuda.get_device_name(0)
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    log(f"nvidia-smi name,power.limit: {card_name_and_limit()}")
    return name


def card_name_and_limit():
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def kernel_modules():
    from voxelized_geometry_tools_tpu_torch.kernels import (
        edt_bestfirst, edt_envelope, edt_windowed)
    return edt_bestfirst, edt_envelope, edt_windowed


def kernel_fns():
    """Each kernel's wrapper, by the names of ``KERNELS`` (the best-first
    variants forced: the staged one raises where its block does not fit)."""
    eb, ee, ew = kernel_modules()
    return {
        "edt_bestfirst_staged": eb.parabolic_envelope_last_staged,
        "edt_bestfirst_cluster": eb.parabolic_envelope_last_cluster,
        "edt_bestfirst": eb.parabolic_envelope_last_global,
        "edt_bestfirst_inkernel": functools.partial(
            eb.parabolic_envelope_last_global, hoist_cmin=False),
        "edt_envelope_staged": ee.parabolic_envelope_last_staged,
        "edt_envelope_global": ee.parabolic_envelope_last_global,
        "edt_windowed_staged": ew.parabolic_envelope_last_staged,
        "edt_windowed_global": ew.parabolic_envelope_last_global,
    }


def staged_planned(kname, f):
    """Whether the staged variant ``kname`` plans ``f`` (its block fits);
    True for every other kernel (the forced clustered variant takes the
    smallest cluster that fits where its plan has none)."""
    eb, ee, ew = kernel_modules()
    if kname == "edt_bestfirst_staged":
        return eb.plan_lines(f)[0].staged
    if kname == "edt_envelope_staged":
        return ee.plan(f)[1] > 0
    if kname == "edt_windowed_staged":
        return ew.plan(f)[1] > 0
    return True


def reset_launches():
    from voxelized_geometry_tools_tpu_torch.kernels import (
        carve, edt_combine, edt_seed, fusion_filter, ray_setup)
    eb, ee, ew = kernel_modules()
    ray_setup.launches = 0
    edt_seed.launches = 0
    fusion_filter.launches = 0
    edt_combine.launches = 0
    eb.launches_staged = eb.launches_cluster = 0
    eb.launches = eb.launches_inkernel = 0
    ee.launches_staged = ee.launches = 0
    ew.launches_staged = ew.launches = 0
    carve.launches_tiled = 0


def read_launches():
    """Every kernel's launches but the transform product's (any transform
    on the card launches it; the carve phases count it themselves)."""
    from voxelized_geometry_tools_tpu_torch.kernels import (
        carve, edt_combine, edt_seed, fusion_filter, ray_setup)
    eb, ee, ew = kernel_modules()
    return {"ray_setup": ray_setup.launches,
            "edt_seed": edt_seed.launches,
            "fusion_filter": fusion_filter.launches,
            "edt_combine": edt_combine.launches,
            "carve_tiled": carve.launches_tiled,
            "edt_bestfirst_staged": eb.launches_staged,
            "edt_bestfirst_cluster": eb.launches_cluster,
            "edt_bestfirst": eb.launches,
            "edt_bestfirst_inkernel": eb.launches_inkernel,
            "edt_envelope_staged": ee.launches_staged,
            "edt_envelope_global": ee.launches,
            "edt_windowed_staged": ew.launches_staged,
            "edt_windowed_global": ew.launches}


@contextlib.contextmanager
def counting_calls(module, names, calls):
    """Counts the calls of each ``module.<name>`` in ``calls[name]`` while
    the context is open (callers look the function up at each call)."""
    saved = {name: getattr(module, name) for name in names}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for name, fn in saved.items():
        calls[name] = 0
        setattr(module, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(module, name, fn)


def phase_build():
    from voxelized_geometry_tools_tpu_torch.kernels import build
    eb, ee, ew = kernel_modules()
    from voxelized_geometry_tools_tpu_torch import native
    from voxelized_geometry_tools_tpu_torch.kernels import (
        carve, edt_combine, edt_seed, fusion_filter, ray_setup,
        transform_product)
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(LIBRARIES) + 1) as pool:
        # The native CPU runtime (g++) builds beside the CUDA sources.
        native_built = pool.submit(native.get_library)
        paths = list(pool.map(build.build, LIBRARIES))
        if native_built.result() is None:
            raise RuntimeError("the native CPU runtime did not build")
    for mod in (eb, ee, ew):
        mod._launcher()
    probes._library()
    carve._library()
    edt_seed._library()
    fusion_filter._library()
    edt_combine._library()
    ray_setup._library()
    transform_product._library()
    log(f"build: {', '.join(LIBRARIES)} and the native CPU runtime in "
        f"{time.monotonic() - t0:.2f} s (in parallel)")
    for name, path in zip(LIBRARIES, paths):
        ptxas = path.with_suffix(".log")
        if not ptxas.exists():
            continue
        for line in ptxas.read_text().splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "entry function" in line):
                log(f"  ptxas {name}: {line.strip()}")


def _field_cases(rng, lo, p_inf_line):
    """Random fields in [lo, 400) with +inf holes (and, with p_inf_line,
    whole +inf lines) for every n of ENVELOPE_NS, in both pass layouts:
    positions contiguous (the z pass's; ragged line counts) and lines
    contiguous (moved views, the y pass's), plus a base that is not 16-byte
    aligned and sparse seeds in the moved layout."""
    def field(shape):
        f = rng.uniform(lo, 400.0, shape).astype(np.float32)
        f[rng.uniform(size=shape) < 0.5] = np.inf
        if p_inf_line and len(shape) > 1:
            f[..., rng.uniform(size=shape[-2]) < p_inf_line, :] = np.inf
        return torch.from_numpy(f).cuda()

    cases = []
    for n in ENVELOPE_NS:
        for shape in [(n,), (77, n), (3, 45, n), (2, 1000, n)]:
            cases.append((f"z-layout{shape}", field(shape)))
        for shape in [(3, n, 45), (2, n, 1000)]:
            cases.append((f"y-layout{shape}", field(shape).movedim(1, -1)))
        cases.append((f"offset(5,33,{n})", field((5, 33, n + 1))[..., 1:]))
        sparse = np.where(rng.random((5, n, 70)) < 0.01, 0.0, np.inf)
        x = torch.from_numpy(sparse.astype(np.float32)).cuda()
        cases.append((f"sparse-seeds-y-layout(5,70,{n})", x.movedim(1, -1)))
    return cases


def envelope_cases():
    """Random fields (+inf, negative values) and the degenerate fills, in
    both layouts (``_field_cases``)."""
    cases = _field_cases(np.random.default_rng(0), -60.0, 0.0)
    for fill in (np.inf, 0.0, 1e6, -3.0):
        x = torch.full((6, 40, 129), fill, device="cuda")
        cases += [(f"fill={fill}", x), (f"fill={fill}-y-layout",
                                        x.movedim(1, -1))]
    return cases


def nonneg_envelope_cases():
    """The cases the windowed kernel is exact on (f >= 0): random fields
    with +inf holes and whole +inf lines, and the non-negative fills."""
    cases = _field_cases(np.random.default_rng(1), 0.0, 0.2)
    for fill in (np.inf, 0.0, 1e6):
        cases.append((f"fill={fill}",
                      torch.full((6, 40, 129), fill, device="cuda")))
    return cases


def phase_kernel_vs_plain():
    """Every kernel bitwise against the plain version: the staged variants
    on every case whose block fits (the global variants on all, the
    clustered variant on all with its plan's or the smallest cluster and
    with FORCED_CLUSTERS, the windowed kernels on f >= 0 only). Returns the
    largest error per kernel."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    signed, nonneg = envelope_cases(), nonneg_envelope_cases()
    refs = [k.parabolic_envelope_last_plain(f) for _, f in signed + nonneg]
    worst = {}
    for kname, fn in kernel_fns().items():
        cases = list(zip(signed + nonneg, refs))
        if kname.startswith("edt_windowed"):
            cases = cases[len(signed):]
        cases = [c for c in cases if staged_planned(kname, c[0][1])]
        calls = [(fn, "")]
        if kname == "edt_bestfirst_cluster":
            calls += [(functools.partial(fn, cluster=c), f", cluster {c}")
                      for c in FORCED_CLUSTERS]
        worst[kname] = 0.0
        layouts = set()
        for (name, f), ref in cases:
            for call, how in calls:
                got = call(f)
                torch.cuda.synchronize()
                err = max_abs_err(got, ref)
                worst[kname] = max(worst[kname], err)
                if not torch.equal(got, ref):
                    raise AssertionError(f"{kname} != plain on {name}{how}: "
                                         f"max abs err {err}")
            layouts.add(k.plan_lines(f)[0].lines_contiguous)
        if layouts != {False, True}:
            raise AssertionError(f"the {kname} cases miss a layout")
        log(f"kernel vs plain: {kname}: {len(cases) * len(calls)} cases "
            f"bitwise equal (n up to "
            f"{max(f.shape[-1] for (_, f), _ in cases)})")
    return worst


def seed_cases():
    """``(name, mask)`` cases of the seed kernel: bench.py's 512^3 sphere,
    random masks at three fills (x axes of 1, 2, 33, 1024, 4096, whose bits
    need more than 48 KiB of shared memory a block, the longest whose bits
    fit a block's shared memory and one more, which takes the global
    variant), lines of one seed at either end at those two lengths (squares
    past 2^24, rounded), lines with no filled and lines with no free voxel,
    an all-filled and an all-free grid, a permuted and a narrowed view, a
    slab of the streamed 1024^3 pipeline and the sharded EDT's local [1024,
    128, 512] shape."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_seed

    rng = np.random.default_rng(20)

    def rand(shape, fill):
        return torch.from_numpy(rng.random(shape) < fill).cuda()

    packed = edt_seed.packed_max_nx("cuda")
    cases = [("sphere 512^3", sphere_mask(GRID_N, "cuda"))]
    for fill in (0.1, 0.5, 0.9):
        for shape in ((1, 40, 33), (2, 17, 65), (33, 20, 70),
                      (1024, 8, 40), (4096, 3, 50), (packed, 3, 50),
                      (packed + 1, 3, 50)):
            cases.append((f"random fill {fill} {shape}", rand(shape, fill)))
    for nx in (packed, packed + 1):
        ends = torch.zeros((nx, 4, 40), dtype=torch.bool, device="cuda")
        ends[0, 0], ends[-1, 1], ends[nx // 3, 2] = True, True, True
        ends[:, 3] = True
        ends[nx // 2, 3] = False
        cases.append((f"one seed a line, nx {nx}", ends))
    lines = rand((64, 30, 50), 0.5)
    lines[:, ::3] = False
    lines[:, 1::3] = True
    cases.append(("lines with no filled / no free voxel", lines))
    cases.append(("all filled", torch.ones((40, 20, 36), dtype=torch.bool,
                                           device="cuda")))
    cases.append(("all free", torch.zeros((40, 20, 36), dtype=torch.bool,
                                          device="cuda")))
    base = rand((90, 64, 48), 0.3)
    cases.append(("permuted (movedim)", base.movedim(2, 0)))
    cases.append(("narrow slab", base.narrow(1, 16, 20)))
    large = large_sphere_mask(LARGE_N, "cuda")
    cases.append(("1024^3 streamed slab view", large.narrow(1, 128, 128)))
    cases.append(("sharded local [1024, 128, 512]",
                  large.narrow(1, 448, 128).narrow(2, 512, 512)))
    cases.append(("random [1024, 128, 512]", rand((1024, 128, 512), 0.5)))
    return cases


def blocking_calls_in(events, span_name):
    """The runtime calls in ``events`` (a profiler's) that block the host,
    made while the host was inside a span named ``span_name``, and the
    names of every runtime call there; raises unless the span occurs once
    on the host (the profiler also marks it on the card's timeline)."""
    from torch.autograd import DeviceType

    spans = [e for e in events
             if e.name == span_name and e.device_type == DeviceType.CPU]
    if len(spans) != 1:
        raise AssertionError(f"{len(spans)} {span_name} spans, expected 1")
    a, b = spans[0].time_range.start, spans[0].time_range.end
    inside = [e.name for e in events if e.name.startswith("cuda")
              and a <= e.time_range.start <= b]
    return [n for n in inside if n in BLOCKING_CALLS], inside


def phase_edt_seed():
    """The seed kernel bitwise against its plain version (both fields, one
    field, the stacked order) on every ``seed_cases`` mask; one dense EDT
    at 512^3 launches it once and blocks the host nowhere in its span; its
    512^3 two-field time beside its byte bound and the plain version's."""
    from torch.profiler import ProfilerActivity, profile

    from voxelized_geometry_tools_tpu_torch.kernels import edt_seed
    from voxelized_geometry_tools_tpu_torch.ops import edt

    t_phase = time.monotonic()
    n_cases = 0
    for name, mask in seed_cases():
        one = edt_seed.seed_fields(mask, 1)
        two = edt_seed.seed_fields(mask, 2)
        ref = edt_seed.seed_fields_plain(mask, 2)
        torch.cuda.synchronize()
        nx = mask.shape[0]
        for got, want, what in ((two, ref, "two fields"),
                                (one, ref[:nx], "one field"),
                                (two[nx:], ref[nx:], "free field")):
            if not (got.is_contiguous() and torch.equal(got, want)):
                raise AssertionError(
                    f"edt_seed != plain on {name} ({what}): max abs err "
                    f"{max_abs_err(got, want)}, contiguous "
                    f"{got.is_contiguous()}")
        n_cases += 1
        del one, two, ref
    log(f"edt_seed vs plain: {n_cases} masks, one and two fields, bitwise "
        "equal")

    mask = sphere_mask(GRID_N, "cuda")
    edt.signed_distance_from_filled_mask(mask, RESOLUTION)
    torch.cuda.synchronize()
    before = edt_seed.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edt.signed_distance_from_filled_mask(mask, RESOLUTION)
        torch.cuda.synchronize()
    launched = edt_seed.launches - before
    events = prof.events()
    blocking, calls = blocking_calls_in(events, "vgt.edt.seed_pass")
    kernel_us = [e.time_range.elapsed_us() for e in events
                 if "edt_seed_kernel" in e.name]
    log(f"edt_seed in one {GRID_N}^3 dense EDT: {launched} launch, runtime "
        f"calls in vgt.edt.seed_pass {calls}, traced kernel "
        f"{[round(us / 1e3, 4) for us in kernel_us]} ms")
    if launched != 1:
        raise AssertionError(f"one dense EDT launched the seed kernel "
                             f"{launched} times, expected 1")
    if blocking:
        raise AssertionError(f"vgt.edt.seed_pass blocked the host: {blocking}")
    if len(kernel_us) != 1:
        raise AssertionError(f"the trace holds {len(kernel_us)} seed kernels, "
                             "expected 1")

    ms = cuda_ms(lambda: edt_seed.seed_fields(mask, 2), 20)
    plain_ms = cuda_ms(lambda: edt_seed.seed_fields_plain(mask, 2), 3)
    bound_ms, bound_by = bound_of(mask.numel() * (1 + 2 * 4), 0)
    log(f"edt_seed {GRID_N}^3 two fields: {ms:.4f} ms, bound {bound_ms:.4f} "
        f"ms ({bound_by}), bound / time {bound_ms / ms:.3f}; plain "
        f"{plain_ms:.3f} ms; phase {time.monotonic() - t_phase:.1f} s")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def filter_inputs(cameras, shape, seed):
    """Counters ``[cameras, *shape]`` and an occupancy on the card that
    give every vote and every kind of static cell: counts in [-2, 8), half
    of them 0 (a carved grid's most common count), one in a thousand
    beyond 2^24 or near 2^31 - 1 (sums that round and wrap); occupancy 0,
    0.25, 0.5, the float after 0.5, 1.0 or NaN."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    size = (cameras,) + tuple(shape)
    big = torch.tensor([2 ** 24 + 1, 2 ** 24 + 3, 2 ** 30 + 7, 2 ** 31 - 1],
                       dtype=torch.int32, device="cuda")

    def counters():
        c = torch.randint(-2, 8, size, generator=g, device="cuda",
                          dtype=torch.int32)
        c.masked_fill_(torch.rand(size, generator=g, device="cuda") < 0.5, 0)
        pick = torch.rand(size, generator=g, device="cuda") < 1e-3
        c[pick] = big[torch.randint(0, 4, (int(pick.sum()),), generator=g,
                                    device="cuda")]
        return c

    values = torch.tensor([0.0, 0.25, 0.5, float(np.nextafter(
        np.float32(0.5), np.float32(1.0))), 1.0, float("nan")],
        dtype=torch.float32, device="cuda")
    occ = values[torch.randint(0, len(values), tuple(shape), generator=g,
                               device="cuda")]
    return counters(), counters(), occ


def phase_fusion_filter():
    """The fusion filter kernel bitwise against its plain version at each
    cell's shape (three filter options each) and on a ragged grid given
    aligned, unaligned and non-contiguous; ``combine_and_filter`` launches
    it once in its span and blocks the host nowhere there; its time at
    each shape beside its byte bound ((8 C + 8) bytes a voxel) and the
    plain version's. Returns the map shape's row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from voxelized_geometry_tools_tpu_torch.kernels import fusion_filter
    from voxelized_geometry_tools_tpu_torch.ops import voxelize

    t_phase = time.monotonic()
    options = (voxelize.FilterOptions(), voxelize.FilterOptions(0.7, 3, 2),
               voxelize.FilterOptions(1 / 3, 1, 3))

    def check(what, o, args, ref_args):
        before = fusion_filter.launches
        got = fusion_filter.combine_and_filter_fused(o, *args)
        want = fusion_filter.combine_and_filter_plain(o, *ref_args)
        torch.cuda.synchronize()
        if fusion_filter.launches != before + 1:
            raise AssertionError(f"fusion_filter on {what}: "
                                 f"{fusion_filter.launches - before} launches")
        if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
            diff = int((got.view(torch.int32) != want.view(torch.int32))
                       .sum())
            raise AssertionError(f"fusion_filter != plain on {what}, {o}: "
                                 f"{diff} voxels differ")

    cameras, shape = 2, FILTER_RAGGED
    free, filled, occ = filter_inputs(cameras, shape, 22)

    def unaligned(t):
        return torch.cat([t.flatten()[:1], t.flatten()])[1:].view(t.shape)

    views = {"ragged": (free, filled, occ),
             "ragged unaligned": tuple(map(unaligned, (free, filled, occ))),
             "ragged, non-contiguous occupancy": (
                 free, filled,
                 occ.transpose(0, 2).contiguous().transpose(0, 2))}
    for c in (1, cameras):
        for name, args in views.items():
            for o in options:
                check(f"{name} {shape}, {c} camera(s)", o,
                      (args[0][:c], args[1][:c], args[2]),
                      (free[:c], filled[:c], occ))
    del free, filled, occ, views
    log(f"fusion_filter vs plain: {FILTER_RAGGED} with 1 and 2 cameras, "
        f"aligned, unaligned and non-contiguous, {len(options)} options "
        "each, bitwise equal")

    rows = []
    for cameras, shape in FILTER_SHAPES:
        free, filled, occ = filter_inputs(cameras, shape, 21 + cameras)
        name = f"{cameras} camera(s) x {'x'.join(map(str, shape))}"
        for o in options:
            check(name, o, (free, filled, occ), (free, filled, occ))
        o = voxelize.FilterOptions()
        voxelize.combine_and_filter(o, free, filled, occ)
        torch.cuda.synchronize()
        before = fusion_filter.launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            voxelize.combine_and_filter(o, free, filled, occ)
            torch.cuda.synchronize()
        launched = fusion_filter.launches - before
        events = prof.events()
        blocking, calls = blocking_calls_in(events, "vgt.fusion.filter")
        device_ops = [e for e in events if e.device_type == DeviceType.CUDA
                      and not e.name.startswith("vgt.")]
        traced = [e.time_range.elapsed_us() / 1e3 for e in device_ops
                  if "fusion_filter_kernel" in e.name]
        if launched != 1 or len(traced) != 1 or len(device_ops) != 1:
            raise AssertionError(
                f"combine_and_filter on {name}: {launched} launches, device "
                f"operations {[e.name for e in device_ops]}")
        if blocking:
            raise AssertionError(f"vgt.fusion.filter blocked the host: "
                                 f"{blocking}")
        ms = cuda_ms(lambda: fusion_filter.combine_and_filter_fused(
            o, free, filled, occ), 20)
        plain_ms = cuda_ms(lambda: fusion_filter.combine_and_filter_plain(
            o, free, filled, occ), 3)
        bound_ms, bound_by = bound_of(occ.numel() * (8 * cameras + 8), 0)
        log(f"fusion_filter {name}: {ms:.4f} ms (traced {traced[0]:.4f}), "
            f"bound {bound_ms:.4f} ms ({bound_by}), bound / time "
            f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms; one launch and "
            f"runtime calls {calls} in vgt.fusion.filter")
        rows.append({"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by})
        del free, filled, occ
    log(f"phase_fusion_filter: {time.monotonic() - t_phase:.1f} s")
    return rows[0]


def phase_edt_combine():
    """The signed combine kernel bitwise against its plain version on real
    EDT fields at each cell's shape: the 512^3 sphere's stacked field
    (both types, each form) and the two fields of a 1024 x 1024 x 512
    sphere (float32, out of place and in place over the first field, as the
    streamed EDT takes it); one dense EDT launches it once, as the last
    device operation after the z pass's envelope kernel (no copy before
    it), and blocks the host nowhere in ``vgt.edt.combine``; its times
    beside its byte bounds and the plain version's. Returns the 512^3
    float32 row."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from voxelized_geometry_tools_tpu_torch.kernels import edt_combine
    from voxelized_geometry_tools_tpu_torch.ops import edt

    t_phase = time.monotonic()
    n = COMBINE_DENSE_N
    mask = sphere_mask(n, "cuda")
    d = stacked_passes(mask)[3].contiguous()
    fields = {f"{n}^3 dense": (d[:n], d[n:])}
    room = torch.zeros(COMBINE_ROOM_SHAPE, dtype=torch.bool, device="cuda")
    c = [s // 2 for s in COMBINE_ROOM_SHAPE]
    big = large_sphere_mask(COMBINE_ROOM_SHAPE[2], "cuda")
    h = COMBINE_ROOM_SHAPE[2] // 2
    room[c[0] - h:c[0] + h, c[1] - h:c[1] + h] = big
    del big
    fields["x".join(map(str, COMBINE_ROOM_SHAPE)) + " streamed"] = (
        edt.squared_edt_streamed(room), edt.squared_edt_streamed(~room))
    del room

    def launch(a, b, out):
        before = edt_combine.launches
        got = edt_combine.signed_combine(a, b, RESOLUTION, out)
        if edt_combine.launches != before + 1:
            raise AssertionError(f"edt_combine: "
                                 f"{edt_combine.launches - before} launches")
        return got

    rows = []
    for name, (a, b) in fields.items():
        dtypes = ((torch.float32, torch.float64) if name.endswith("dense")
                  else (torch.float32,))
        for dtype in dtypes:
            want = edt_combine.signed_combine_plain(
                a, b, RESOLUTION, torch.empty(a.shape, dtype=dtype,
                                              device="cuda"))
            got = launch(a, b, torch.empty(a.shape, dtype=dtype,
                                           device="cuda"))
            first = launch(a, None, torch.empty(a.shape, dtype=dtype,
                                                device="cuda"))
            checks = {"both fields": got,
                      "one field at a time": launch(None, b, first)}
            if dtype == torch.float32:
                in_place = a.clone()
                checks["in place over a"] = launch(in_place, b, in_place)
            torch.cuda.synchronize()
            for form, result in checks.items():
                if not _bitwise(result, want):
                    diff = int((result != want).sum())
                    raise AssertionError(f"edt_combine != plain on {name} "
                                         f"{dtype}, {form}: {diff} differ")
            forms = ", ".join(checks)
            del first, checks
            out = torch.empty(a.shape, dtype=dtype, device="cuda")
            ms = cuda_ms(lambda: edt_combine.signed_combine(
                a, b, RESOLUTION, out), 20)
            plain_ms = cuda_ms(lambda: edt_combine.signed_combine_plain(
                a, b, RESOLUTION, out), 3)
            bound_ms, bound_by = bound_of(
                a.numel() * (8 + out.element_size()), COMBINE_OPS * a.numel())
            log(f"edt_combine {name} {dtype}: {ms:.4f} ms, bound "
                f"{bound_ms:.4f} ms ({bound_by}), bound / time "
                f"{bound_ms / ms:.3f}; plain {plain_ms:.3f} ms; {forms} "
                f"bitwise equal to plain; "
                f"{int(want.isnan().sum())} NaN, "
                f"{int(want.isinf().sum())} infinite")
            rows.append({"ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
            del want, got, out
    del fields

    edt.signed_distance_from_filled_mask(mask, RESOLUTION)
    torch.cuda.synchronize()
    before = edt_combine.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        edt.signed_distance_from_filled_mask(mask, RESOLUTION)
        torch.cuda.synchronize()
    launched = edt_combine.launches - before
    events = prof.events()
    blocking, calls = blocking_calls_in(events, "vgt.edt.combine")
    device_ops = sorted((e for e in events if e.device_type == DeviceType.CUDA
                         and not e.name.startswith("vgt.")),
                        key=lambda e: e.time_range.start)
    names = [e.name for e in device_ops]
    traced = [e.time_range.elapsed_us() / 1e3 for e in device_ops
              if "edt_combine_kernel" in e.name]
    log(f"edt_combine in one {n}^3 dense EDT: {launched} launch, device "
        f"operations in order {names}, runtime calls in vgt.edt.combine "
        f"{calls}, traced kernel {traced} ms")
    if (launched != 1 or len(traced) != 1
            or "edt_combine_kernel" not in names[-1]
            or "edt_bestfirst" not in names[-2]):
        raise AssertionError(f"one dense EDT: {launched} combine launches, "
                             f"device operations {names}")
    if blocking:
        raise AssertionError(f"vgt.edt.combine blocked the host: {blocking}")
    log(f"phase_edt_combine: {time.monotonic() - t_phase:.1f} s")
    return rows[0]


def phase_main_path():
    """The main path at full size, with every launch count reset first."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query

    spec = GridSpec.from_voxel_counts(RESOLUTION, (GRID_N,) * 3)
    mask = sphere_mask(GRID_N, "cuda")
    sizes = np.asarray(spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    camera = render.PinholeCamera.create(pose, IMG_W, IMG_H, focal=520.0,
                                         device="cuda")
    torch.cuda.synchronize()

    eb, _, _ = kernel_modules()
    calls = {}
    reset_launches()
    # The global variant's minima pass and its transposing line view.
    with counting_calls(eb, ("_chunk_minima", "launch_on_lines"), calls), \
            torch.no_grad():
        sdf = edt.extract_signed_distance_field(mask, spec, None,
                                                frame="bench")
        table = sdf_query.build_corner_table(sdf)
        fixed = render.render_depth(sdf, camera, num_steps=NUM_STEPS,
                                    corner_table=table)
        early = render.render_depth(sdf, camera, num_steps=NUM_STEPS,
                                    corner_table=table, early_exit=True,
                                    tail_chunks=1)
    torch.cuda.synchronize()
    counts = read_launches()
    launches = counts["edt_bestfirst_staged"]
    log(f"main path: launches {counts}; calls {calls}")
    if counts["edt_seed"] != 1:
        raise AssertionError(f"the {GRID_N}^3 EDT launched the seed kernel "
                             f"{counts['edt_seed']} times, expected 1")
    if launches != 2:
        raise AssertionError(f"the {GRID_N}^3 EDT launched the staged kernel "
                             f"{launches} times, expected 2 (y and z passes)")
    if counts["edt_combine"] != 1:
        raise AssertionError(f"the {GRID_N}^3 EDT launched the combine kernel "
                             f"{counts['edt_combine']} times, expected 1")
    if sum(counts.values()) != launches + counts["edt_seed"] + 1:
        raise AssertionError(f"the main path launched another kernel: {counts}")
    if any(calls.values()):
        raise AssertionError(f"the main path ran the global variant's minima "
                             f"or transposing view: {calls}")
    return (spec, mask, sdf, table, camera, fixed, early, launches,
            counts["edt_seed"], counts["edt_combine"])


def phase_edt_checks(mask, sdf):
    """Kernel EDT bitwise against the plain EDT at 512^3, scipy at 128^3,
    and per-pass times."""
    import scipy.ndimage
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    from voxelized_geometry_tools_tpu_torch.ops import edt

    plain = edt.signed_distance_from_filled_mask(mask, RESOLUTION,
                                                 backend="plain")
    err = max_abs_err(sdf.distances, plain)
    if not torch.equal(sdf.distances, plain):
        raise AssertionError(f"{GRID_N}^3 EDT: kernel != plain, max abs err {err}")
    del plain
    log(f"edt {GRID_N}^3: kernel == plain (bitwise), "
        f"min {float(sdf.minimum):.6f} max {float(sdf.maximum):.6f}")

    small = sphere_mask(128, "cuda")
    small[10:30, 90:100, 5:60] = True
    for seed in (small, ~small):
        got = edt.squared_edt(seed).cpu().numpy()
        ref = scipy.ndimage.distance_transform_edt(~seed.cpu().numpy()) ** 2
        if not np.array_equal(got, np.rint(ref).astype(np.float32)):
            raise AssertionError("128^3 squared EDT != scipy")
    log("edt 128^3: squared EDT == scipy.ndimage.distance_transform_edt^2")

    # Per-pass times on the main path's stacked [1024, 512, 512] field.
    fy, dz, ry, rz = stacked_passes(mask)
    for name, x, r in (("y", fy, ry), ("z", dz, rz)):
        plan, _ = k.plan_lines(x)
        if not plan.staged or plan.copy or r.stride() != x.stride():
            raise AssertionError(f"{name} pass: {plan}, output strides "
                                 f"{r.stride()} for input {x.stride()}")
        log(f"edt {name} pass: {plan}; output strides {r.stride()} == "
            "input's (read and written in place)")
    t = {}
    for name, x in (("y", fy), ("z", dz)):
        t[f"wrapper_{name}"] = cuda_ms(lambda: k.parabolic_envelope_last(x),
                                       5)
        t[f"kernel_{name}"] = cuda_ms(staged_kernel_only(x), 5)
        t[f"plain_{name}"] = cuda_ms(
            lambda: k.parabolic_envelope_last_plain(x), 1)
        # The global variant (the kernel before the staged one) on the same
        # field: alone, with its wrapper, and its minima pass and transposed
        # copy.
        ft = x.transpose(-1, -2)
        t[f"transpose_{name}"] = (cuda_ms(lambda: ft.contiguous(), 5)
                                  if not ft.is_contiguous() else 0.0)
        ft = ft.contiguous()
        t[f"minima_{name}"] = cuda_ms(lambda: k._chunk_minima(ft), 5)
        t[f"global_kernel_{name}"] = cuda_ms(global_kernel_only(ft), 5)
        t[f"global_wrapper_{name}"] = cuda_ms(
            lambda: k.parabolic_envelope_last_global(x), 5)
    t["edt_total"] = cuda_ms(lambda: edt.signed_distance_from_filled_mask(
        mask, RESOLUTION), 3)
    for key, ms in t.items():
        log(f"edt time {key}: {ms:.3f} ms")
    log("edt time staged minima_y, minima_z, transpose_z: not run (the "
        "staged kernel forms its minima in shared memory and reads both "
        "layouts in place)")
    log(f"edt {GRID_N}^3 two-field: {GRID_N ** 3 / (t['edt_total'] / 1e3):.4e} "
        "voxels/s")
    bounds = {}
    for name, x, r in (("y", fy, ry), ("z", dz, rz)):
        bounds[name] = envelope_bound(x)
        share = bounds[name]["bound_ms"] / t[f"kernel_{name}"]
        log(f"edt {name} pass bound: {bounds[name]}; staged kernel "
            f"{t[f'kernel_{name}']:.4f} ms, bound / time {share:.3f}")
        for tile_q in (k.TILE_Q, 16):
            log(f"edt {name} pass visit count, {tile_q}-position tiles: "
                f"{visit_arithmetic(x, r, tile_q)}")
    del fy, dz, ry, rz
    return t, err, bounds


def staged_kernel_only(x):
    """A call of the staged kernel alone on ``x`` (planned and its output
    allocated once)."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    plan, x3 = k.plan_lines(x)
    out3 = k.staged_output(plan, x3)
    return lambda: k.launch_staged(plan, x3, out3)


def global_kernel_only(ft, hoist_cmin=True):
    """A call of the global variant's kernel alone on ``ft`` ([B, n, L],
    lines contiguous), its chunk minima and output made once."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    b, n, lines = ft.shape
    cmin = k._chunk_minima(ft) if hoist_cmin else None
    out = torch.empty_like(ft)
    args = (ft.data_ptr(), None if cmin is None else cmin.data_ptr(),
            out.data_ptr(), b, n, lines, *ft.stride(), *k._stream_args(ft))

    def run():
        if k._launcher()(*args) != 0:
            raise AssertionError("global best-first launch failed")
    return run


def envelope_bound(x):
    """The least time of one envelope pass over ``x`` on the H100, whatever
    the kernel: the larger of its bytes (``x`` read once, the result written
    once) at the HBM rate and its operations at the float32 rate, counted as
    one add per output, since no exact kernel forms fewer than one candidate
    per output (how many more it forms is its algorithm's, not the
    function's)."""
    bytes_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = x.numel() / F32_OPS_PER_S * 1e3
    return {"bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def sweep_floor_ms(x):
    """A full sweep's own floor on ``x`` on the H100: each output takes all
    n candidates of its line, each one min at the min/max rate (and one add,
    whose issue slot the same rate already counts: two of 128 lanes a clock
    an SM against the min's 64)."""
    return x.numel() * x.shape[-1] / F32_MINMAX_PER_S * 1e3


def visit_arithmetic(x, r, tile_q):
    """What a pass ordered and stopped by tile-level bounds computes on
    ``x`` (result ``r``), in tiles of ``tile_q`` positions (``visit_count``):
    its candidates per output, and their time on the H100 at one add (float32
    rate) and one min (min/max rate) each. Not a floor: the staged kernel's
    test of 8-position groups computes fewer candidates."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    vc = k.visit_count(x, r, tile_q=tile_q)
    ms = vc["candidates"] * (1 / F32_OPS_PER_S + 1 / F32_MINMAX_PER_S) * 1e3
    return {"candidates_per_output": vc["candidates"] / vc["outputs"],
            "chunks_per_tile": vc["chunks"] / vc["tiles"],
            "arithmetic_ms": ms}


def bound_of(n_bytes, n_ops):
    """``(ms, what binds)``: the larger of ``n_bytes`` at the HBM rate and
    ``n_ops`` float32 operations at the float32 rate."""
    b = n_bytes / HBM_BYTES_PER_S * 1e3
    o = n_ops / F32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def summed_bound(parts):
    """One bound for several passes: the larger of their summed byte times
    and their summed operation times."""
    b = sum(p["bytes_ms"] for p in parts)
    o = sum(p["ops_ms"] for p in parts)
    return max(b, o), "bytes" if b >= o else "operations"


@contextlib.contextmanager
def bestfirst_hoist(hoist_cmin):
    """Routes ``backend="cuda-bestfirst"`` to the best-first wrapper with
    ``hoist_cmin`` (the EDT looks the wrapper up at each call)."""
    eb, _, _ = kernel_modules()
    wrapper = eb.parabolic_envelope_last
    eb.parabolic_envelope_last = functools.partial(wrapper,
                                                   hoist_cmin=hoist_cmin)
    try:
        yield
    finally:
        eb.parabolic_envelope_last = wrapper


def edt_through(mask, backend, hoist_cmin, kname, ref, what, expect=None):
    """The signed EDT of ``mask`` through ``backend``: it must launch
    ``kname`` exactly twice (y and z passes) and nothing else, or exactly
    the launches of ``expect`` (kernel name -> count), and give ``ref``'s
    bits. Returns ``kname``'s launches and the largest error."""
    from voxelized_geometry_tools_tpu_torch.ops import edt

    # Every dense EDT launches the seed and the combine kernel once.
    expect = {**(expect or {kname: 2}), "edt_seed": 1, "edt_combine": 1}
    torch.cuda.synchronize()
    reset_launches()
    with bestfirst_hoist(hoist_cmin):
        got = edt.signed_distance_from_filled_mask(mask, RESOLUTION,
                                                   backend=backend)
    torch.cuda.synchronize()
    counts = read_launches()
    if {name: n for name, n in counts.items() if n} != expect:
        raise AssertionError(f"{what} via {backend} (hoist_cmin="
                             f"{hoist_cmin}): launches {counts}, expected "
                             f"{expect}")
    err = max_abs_err(got, ref)
    if not torch.equal(got, ref):
        raise AssertionError(f"{what} via {kname} != reference, max abs "
                             f"err {err}")
    log(f"{what} via backend {backend!r} (hoist_cmin={hoist_cmin}): "
        f"bitwise equal, launches {expect}")
    return counts[kname], err


def time_passes(fns, fy, dz):
    """Each wrapper's y- and z-pass times on one field."""
    times = {}
    for kname, fn in fns.items():
        reps = 2 if kname.startswith("edt_envelope") else 5
        times[kname] = (cuda_ms(lambda: fn(fy), reps),
                        cuda_ms(lambda: fn(dz), reps))
    return times


def phase_backend_sweep(mask, sdf, t_plain):
    """The 512^3 signed EDT through every kernel backend (the best-first one
    with both hoist_cmin, each the staged variant): each must give the main
    path's bits (held against plain in phase_edt_checks) through its own
    kernel, two launches each; then every wrapper's y- and z-pass times on
    the main path's stacked field, the global best-first variants forced.
    The plain passes and the bounds are phase_edt_checks' (same function,
    same field)."""
    launches, errs = {}, {}
    for backend, hoist, kname in SWEEP:
        n_launch, err = edt_through(mask, backend, hoist, kname,
                                    sdf.distances, f"edt {GRID_N}^3")
        launches[kname] = n_launch
        errs[kname] = max(errs.get(kname, 0.0), err)

    fy, dz, ry, rz = stacked_passes(mask)
    times = time_passes(kernel_fns(), fy, dz)
    for kname, (ty, tz) in times.items():
        log(f"edt time {kname}: y {ty:.3f} ms, z {tz:.3f} ms (plain y "
            f"{t_plain['plain_y']:.3f} ms, z {t_plain['plain_z']:.3f} ms)")
    _, _, ew = kernel_modules()
    for name, x, r, i in (("y", fy, ry, 0), ("z", dz, rz, 1)):
        wc = ew.walk_count(x, r)
        log(f"edt windowed {name} pass: staged "
            f"{times['edt_windowed_staged'][i]:.3f} ms, global "
            f"{times['edt_windowed_global'][i]:.3f} ms; byte bound "
            f"{envelope_bound(x)['bytes_ms']:.4f} ms; walk count (a lower "
            f"bound) {wc}: {wc['chunks'] / wc['tiles']:.4f} chunks a tile, "
            f"{wc['dead'] / max(wc['chunks'], 1):.4f} of them +inf on every "
            f"line, {wc['whole_axis'] / wc['tiles']:.4f} of tiles walk the "
            f"whole axis")
    for kname in ("edt_envelope_staged", "edt_envelope_global"):
        for name, x, ms in (("y", fy, times[kname][0]),
                            ("z", dz, times[kname][1])):
            floor = sweep_floor_ms(x)
            log(f"edt {kname} {name} pass: {ms:.3f} ms; full-sweep floor "
                f"{floor:.3f} ms ({x.numel() * x.shape[-1]} candidates at "
                f"{F32_MINMAX_PER_S:.3e} min/s), floor / time "
                f"{floor / ms:.3f}; byte bound "
                f"{envelope_bound(x)['bytes_ms']:.4f} ms")
    del fy, dz, ry, rz
    return launches, errs, times


def phase_global_variant():
    """Axes too long for the staged blocks: the signed EDT of a [4, 2048,
    2048] grid takes the best-first kernel's clustered variant for both
    hoist_cmin, the full sweep's and the windowed walk's global variants
    through cuda-envelope and cuda-windowed, and must equal the plain
    backend bit for bit; the z axis of a LONG_SHAPE grid, beyond a
    cluster's reach, takes the best-first kernel's global variant for each
    hoist_cmin. Then the per-pass times on the 2048 grid's stacked field
    (the global best-first variants forced), the plain passes', the
    cluster's plan and the bounds."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    from voxelized_geometry_tools_tpu_torch.ops import edt

    n = GLOBAL_N
    ax = torch.arange(n, device="cuda", dtype=torch.float32)
    mask = (((ax[:, None] - 0.4 * n) ** 2 + (ax[None, :] - 0.6 * n) ** 2
             <= (0.2 * n) ** 2)[None].expand(GLOBAL_X, n, n).clone())
    mask[:, 50:90, 1500:1900] = True
    plain = edt.signed_distance_from_filled_mask(mask, RESOLUTION,
                                                 backend="plain")
    launches, errs = {}, {}
    for backend, hoist, kname in (
            ("cuda-bestfirst", True, "edt_bestfirst_cluster"),
            ("cuda-bestfirst", False, "edt_bestfirst_cluster"),
            ("cuda-envelope", True, "edt_envelope_global"),
            ("cuda-windowed", True, "edt_windowed_global")):
        launches[kname], err = edt_through(
            mask, backend, hoist, kname, plain,
            f"edt [{GLOBAL_X}, {n}, {n}]")
        errs[kname] = max(errs.get(kname, 0.0), err)
    del plain

    long_mask = torch.zeros(LONG_SHAPE, dtype=torch.bool, device="cuda")
    long_mask[1:3, 4:9, 3000:3100] = True
    long_mask[:, 10, 11000:11004] = True
    long_plain = edt.signed_distance_from_filled_mask(long_mask, RESOLUTION,
                                                      backend="plain")
    for hoist, kname in ((True, "edt_bestfirst"),
                         (False, "edt_bestfirst_inkernel")):
        launches[kname], errs[kname] = edt_through(
            long_mask, "cuda-bestfirst", hoist, kname, long_plain,
            f"edt {list(LONG_SHAPE)}", {"edt_bestfirst_staged": 1, kname: 1})
    del long_mask, long_plain

    fy, dz, ry, rz = stacked_passes(mask)
    for x in (fy, dz):
        if any(staged_planned(name, x) for name in
               ("edt_bestfirst_staged", "edt_envelope_staged",
                "edt_windowed_staged")):
            raise AssertionError(f"an axis of {n} planned a staged variant")
        plan = k.plan_lines(x)[0]
        if plan.cluster != 2 or plan.copy:
            raise AssertionError(f"an axis of {n}: {plan}, expected a "
                                 "cluster of 2 read in place")
        smem = k.cluster_smem_bytes(n, plan.lines_contiguous, plan.cluster,
                                    plan.cluster_warps)
        held = k._resident_clusters(n, plan.lines_contiguous, plan.cluster,
                                    plan.cluster_warps, 0)
        log(f"edt [{GLOBAL_X}, {n}, {n}] cluster plan: {plan}; {smem} bytes "
            f"of shared memory a CTA; {held} such clusters resident at once")
    fns = kernel_fns()
    names = list(launches) + ["edt_bestfirst", "edt_bestfirst_inkernel"]
    times = time_passes({name: fns[name] for name in dict.fromkeys(names)},
                        fy, dz)
    for hoist in (True, False):
        times[f"wrapper_hoist_{hoist}"] = time_passes(
            {"w": functools.partial(k.parabolic_envelope_last,
                                    hoist_cmin=hoist)}, fy, dz)["w"]
    plain_ms = (cuda_ms(lambda: k.parabolic_envelope_last_plain(fy), 1),
                cuda_ms(lambda: k.parabolic_envelope_last_plain(dz), 1))
    bounds = [envelope_bound(fy), envelope_bound(dz)]
    for kname, (ty, tz) in times.items():
        log(f"edt [{GLOBAL_X}, {n}, {n}] time {kname}: y {ty:.4f} ms, z "
            f"{tz:.4f} ms (plain y {plain_ms[0]:.3f} ms, z "
            f"{plain_ms[1]:.3f} ms); bound / time y "
            f"{bounds[0]['bound_ms'] / ty:.3f}, z "
            f"{bounds[1]['bound_ms'] / tz:.3f}")
    log(f"edt [{GLOBAL_X}, {n}, {n}] bounds {bounds}")
    for name, x, r in (("y", fy, ry), ("z", dz, rz)):
        vc = k.visit_count(x, r, cluster=2)
        log(f"edt [{GLOBAL_X}, {n}, {n}] {name} pass visit count: {vc}; "
            f"{vc['chunks'] / vc['tiles']:.4f} chunks a tile, remote share "
            f"{vc['remote'] / max(vc['chunks'], 1):.4f}")
    del fy, dz, ry, rz
    return launches, errs, times, plain_ms, bounds


def phase_sqrt_rounding():
    """On every integer below 3 * 1024^2 (every squared distance of a 1024^3
    EDT): the CUDA float64 sqrt, which the plain version of the EDT's
    signed combine takes (``ops/edt._sqrt``), must equal numpy's correctly
    rounded one; whether the float32 CUDA sqrt is
    correctly rounded too is reported, not relied on."""
    x = torch.arange(3 * LARGE_N ** 2, device="cuda", dtype=torch.float32)
    s64 = torch.sqrt(x.double())
    exact = np.sqrt(np.arange(x.numel(), dtype=np.float64))
    if not np.array_equal(s64.cpu().numpy(), exact):
        raise AssertionError("the CUDA float64 sqrt is not correctly rounded")
    differ = int((torch.sqrt(x) != s64.float()).sum())
    log(f"sqrt on integers < 3*{LARGE_N}^2: cuda float64 == numpy (correctly "
        f"rounded); cuda float32 differs from it on {differ} of {x.numel()}")


def streamed_launches(shape, slab=128):
    """Envelope launches of one streamed two-field EDT, from the schedule:
    one per slab, for each envelope pass, for each field."""
    from voxelized_geometry_tools_tpu_torch.ops import edt

    per_field = 0
    for axis in (1, 2):
        if shape[axis] > 1:
            n_s = shape[edt._streamed_slab_axis(shape, axis)]
            size, pad = edt._slab_schedule(n_s, slab)
            per_field += (n_s + pad) // size
    return 2 * per_field


def slab_passes(mask, slab=128):
    """The staged kernel alone on the first [slab, n, n] slab of the
    streamed pipeline's y and z passes (in place: the y pass reads a moved
    view of the slab), with each pass's bound and visit count."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    from voxelized_geometry_tools_tpu_torch.ops import edt

    d = edt._streamed_binary_axis0(mask, slab).narrow(0, 0, slab)
    fy = d.movedim(1, -1)
    ry = k.parabolic_envelope_last(fy)
    dz = ry.movedim(-1, 1)
    rz = k.parabolic_envelope_last(dz)
    for name, x, r in (("y", fy, ry), ("z", dz, rz)):
        ms = cuda_ms(staged_kernel_only(x), 5)
        b = envelope_bound(x)
        log(f"large slab {tuple(d.shape)} {name} pass: staged kernel "
            f"{ms:.4f} ms; plan {k.plan_lines(x)[0]}; bound {b}; bound / "
            f"time {b['bound_ms'] / ms:.3f}; visit count "
            f"{visit_arithmetic(x, r, k.TILE_Q)}")


def phase_large_grid():
    """1024^3: extract_signed_distance_field picks the streamed pipeline on
    its own (streaming=None); its SDF must equal the dense best-first EDT
    bit for bit, with the schedule's launch count and bounded peak memory.
    Then one 640x480, 64-step fixed-step frame without a corner table (the
    8-gather sample path)."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.ops import edt, render

    n = LARGE_N
    spec = GridSpec.from_voxel_counts(RESOLUTION, (n,) * 3)
    mask = large_sphere_mask(n, "cuda")
    expected = streamed_launches(mask.shape)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    reset_launches()
    t0 = time.monotonic()
    with torch.no_grad():
        sdf = edt.extract_signed_distance_field(mask, spec, None,
                                                frame="large")
    torch.cuda.synchronize()
    t_extract = time.monotonic() - t0
    peak_bytes = torch.cuda.max_memory_allocated()
    growth = peak_bytes - before
    counts = read_launches()
    launches = counts["edt_bestfirst_staged"]
    log(f"large {n}^3: extract_signed_distance_field {t_extract * 1e3:.1f} ms"
        f" (first call, min/max included); launches {counts}, schedule "
        f"expects {expected} of edt_bestfirst_staged")
    # One seed launch per axis-0 slab, for each field; one combine.
    seed_expected = 2 * len(edt._slabs(n, 128))
    if (launches != expected or counts["edt_seed"] != seed_expected
            or counts["edt_combine"] != 1
            or sum(counts.values()) != expected + seed_expected + 1):
        raise AssertionError(f"streamed {n}^3 EDT launched {counts}, the "
                             f"schedule expects {expected} of "
                             f"edt_bestfirst_staged, {seed_expected} of "
                             "edt_seed and 1 of edt_combine")
    log(f"large {n}^3: peak device memory of the streamed call "
        f"{peak_bytes / 2 ** 30:.6f} GiB, {peak_bytes} bytes, of which the "
        f"call allocated {growth} ({before} held before it)")
    if growth > STREAMED_GROWTH_BYTES:
        raise AssertionError(f"streamed {n}^3 EDT allocated {growth} bytes "
                             f"above what it was given, more than "
                             f"{STREAMED_GROWTH_BYTES}")
    values = sdf.distances
    center = float(values[n // 2, n // 2, n // 2])
    corner = float(values[0, 0, 0])
    if not center < 0.0 < corner:
        raise AssertionError(f"sign: center {center}, corner {corner}")
    log(f"large {n}^3: center {center:.6f} < 0 < corner {corner:.6f}")

    t_edt = cuda_ms(lambda: edt.signed_distance_from_filled_mask_streamed(
        mask, RESOLUTION), 2)
    log(f"large {n}^3 streamed two-field EDT: {t_edt:.3f} ms = "
        f"{n ** 3 / (t_edt / 1e3):.4e} voxels/s")
    slab_passes(mask)

    torch.cuda.reset_peak_memory_stats()
    dense = edt.signed_distance_from_filled_mask(mask, RESOLUTION)
    torch.cuda.synchronize()
    dense_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    err = max_abs_err(values, dense)
    if not torch.equal(values, dense):
        raise AssertionError(f"streamed {n}^3 SDF != dense, max abs err {err}")
    del dense
    log(f"large {n}^3: streamed == dense best-first EDT (bitwise); dense "
        f"peak device memory {dense_peak:.3f} GiB")

    sizes = np.asarray(spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    camera = render.PinholeCamera.create(pose, IMG_W, IMG_H, focal=600.0,
                                         device="cuda")
    with torch.no_grad():
        frame = render.render_depth(sdf, camera, num_steps=NUM_STEPS)
        t_render = cuda_ms(lambda: render.render_depth(
            sdf, camera, num_steps=NUM_STEPS), 2)
    hit_frac = float(frame.hit.float().mean())
    if not 0.0 < hit_frac < 1.0:
        raise AssertionError(f"large render: hit fraction {hit_frac}")
    if not bool(torch.isfinite(frame.depth[frame.hit]).all()):
        raise AssertionError("large render: non-finite depth on hits")
    pole = (1.2 - 0.25) * n * RESOLUTION
    center_depth = float(frame.depth[IMG_H // 2, IMG_W // 2])
    if abs(center_depth - pole) > 2 * RESOLUTION:
        raise AssertionError(f"large render: central depth {center_depth} m, "
                             f"expected ~{pole}")
    log(f"large {n}^3 render (no table, fixed {NUM_STEPS} steps): hit "
        f"fraction {hit_frac:.6f}, central depth {center_depth:.6f} m (pole "
        f"~{pole:.3f} m), {t_render:.3f} ms = "
        f"{IMG_W * IMG_H / (t_render / 1e3):.4e} rays/s")
    return err


def check_render_contract(ref, got, resolution):
    ref_hit, got_hit = ref.hit, got.hit
    flips = ref_hit != got_hit
    share = float(flips.float().mean())
    if share > MAX_HIT_FLIPS:
        raise AssertionError(f"hit masks differ on {share:.4%} of pixels")
    hitter = torch.where(ref_hit, ref.distance, got.distance)
    graze = (hitter - 0.25 * resolution).abs() <= GRAZER_BAND * resolution
    if bool((flips & ~graze).any()):
        raise AssertionError("hit flip outside the tangent-grazer band")
    m = ref_hit & got_hit
    err = float((got.depth[m] - ref.depth[m]).abs().max())
    if err > DEPTH_ATOL:
        raise AssertionError(f"depth differs by {err} m on common hits")
    return share, err


def phase_render(sdf, table, camera, fixed, early):
    from voxelized_geometry_tools_tpu_torch.ops import render, sdf_query

    for name, res in (("fixed", fixed), ("early_exit", early)):
        hit_frac = float(res.hit.float().mean())
        if not 0.0 < hit_frac < 1.0:
            raise AssertionError(f"{name}: hit fraction {hit_frac}")
        if tuple(res.depth.shape) != (IMG_H, IMG_W):
            raise AssertionError(f"{name}: depth shape {res.depth.shape}")
        if not bool(torch.isfinite(res.depth[res.hit]).all()):
            raise AssertionError(f"{name}: non-finite depth on hits")
        log(f"render {name}: hit fraction {hit_frac:.6f}")
    flips, err = check_render_contract(fixed, early, sdf.resolution)
    log(f"render early_exit vs fixed: hit flips {flips:.6f}, max depth "
        f"diff {err:.3e} m")
    # Independent check: the central ray meets the sphere's near pole at
    # depth (1.2 - 0.25) * grid size (4.864 m at 512^3), within two voxels.
    pole = (1.2 - 0.25) * GRID_N * RESOLUTION
    center = float(fixed.depth[IMG_H // 2, IMG_W // 2])
    if abs(center - pole) > 2 * RESOLUTION:
        raise AssertionError(f"central depth {center} m, expected ~{pole}")
    log(f"render central depth {center:.6f} m (sphere pole at ~{pole:.3f} m)")

    t = {}
    with torch.no_grad():
        t["table_build"] = cuda_ms(
            lambda: sdf_query.build_corner_table(sdf), 2)
        for name, kw in (("fixed", {}),
                         ("early_exit", dict(early_exit=True,
                                             tail_chunks=1))):
            t[f"render_{name}"] = cuda_ms(lambda: render.render_depth(
                sdf, camera, num_steps=NUM_STEPS, corner_table=table, **kw),
                5)
    for key, ms in t.items():
        extra = ""
        if key.startswith("render"):
            extra = f", {IMG_W * IMG_H / (ms / 1e3):.4e} rays/s"
        log(f"time {key}: {ms:.3f} ms{extra}")
    return t


def phase_gradients():
    """The port's entry() on the card, forward and backward, against the
    same entry() on the CPU (which the CPU tests hold against JAX)."""
    from voxelized_geometry_tools_tpu_torch import entry

    results = {}
    for device in ("cuda", "cpu"):
        fn, (dist, pose) = entry.entry(device=device)
        d = dist.clone().requires_grad_(True)
        p = pose.clone().requires_grad_(True)
        depth = fn(d, p)
        torch.mean(depth).backward()
        results[device] = (depth.detach().cpu(), d.grad.cpu(), p.grad.cpu())
    depth, g_d, g_p = results["cuda"]
    for name, g in (("distances", g_d), ("pose", g_p)):
        if not bool(torch.isfinite(g).all()) or float(g.abs().sum()) == 0.0:
            raise AssertionError(f"gradient w.r.t. {name} is non-finite or 0")
    c_depth, c_g_d, c_g_p = results["cpu"]
    hit = c_depth < 100.0
    if not torch.equal(depth < 100.0, hit):
        raise AssertionError("entry(): hit mask differs between cuda and cpu")
    np.testing.assert_allclose(depth[hit].numpy(), c_depth[hit].numpy(),
                               rtol=0, atol=DEPTH_ATOL)
    np.testing.assert_allclose(g_d.numpy(), c_g_d.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(g_p.numpy(), c_g_p.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    log(f"entry(): forward {tuple(depth.shape)} hit {float(hit.float().mean()):.4f}; "
        f"|grad distances|_1 {float(g_d.abs().sum()):.6e}, "
        f"|grad pose|_1 {float(g_p.abs().sum()):.6e}; cuda == cpu within "
        "contract")


# The march probe's kernel-vs-plain shapes: (batch, n_steps, replicas
# beyond one), besides the timed ones: ragged steps, one ray, and a batch
# whose steps' values outgrow shared memory (chunks).
MARCH_CASES = ((64, probes.MARCH_STEPS, True), (256, probes.MARCH_STEPS, True),
               (256, 63, True), (1, 1, True), (1000, 200, False))


def probe_cases(full):
    """(name, kernel call, plain call) for each probe: the TPU seeds and
    others, row counts that are not powers of two, the gather over the
    plan's CTAs and over 1, 7 and 132 CTAs a replica, the scatter's 8192 x 8
    and 2048 x 128 accumulators over a cluster with 1 and 1,001 iterations
    (fewer than the cluster's threads, and ragged against them) besides
    the timed counts, dma depths 1/2/8/16 and n_iters == depth (zeros) on
    the 2^20-row and a 1,000,003-row table, the march's MARCH_CASES on
    4096 x 8, 3001 x 8 and 1000 x 12 tables by its plan and forced to
    either route, one replica and ``full``; integer tables, so every sum is
    exact and kernel and plain must agree bit for bit."""
    pr = probes
    dev = torch.device("cuda")
    cases = []
    for n_rows, width, seed in ((pr.TABLE_ROWS, pr.WIDTH, pr.GATHER_SEED),
                                (3001, pr.WIDTH, 7), (1000, 37, 424242)):
        table = pr.integer_table(n_rows, width, dev, seed=n_rows)
        for reps, iters, ctas in ((1, pr.GATHER_ITERS, None),
                                  (full, 20_000, None),
                                  (1, pr.GATHER_ITERS, 1), (1, 20_000, 7),
                                  (1, 1001, full)):
            args = (iters, reps, seed)
            cases.append((f"vmem_gather({n_rows}x{width}, seed {seed}, "
                          f"{iters} iterations, {reps} replicas, ctas "
                          f"{ctas})",
                          functools.partial(pr.vmem_gather_split, table,
                                            iters, ctas, reps, seed),
                          functools.partial(pr.vmem_gather_plain, table,
                                            *args)))
    for n_rows, width, seed in ((2048, pr.WIDTH, pr.SCATTER_SEED),
                                (4096, pr.WIDTH, 99), (8192, pr.WIDTH, 3),
                                (1000, 37, 5), (2048, 128, 11)):
        mask = pr.integer_table(1, width, dev, seed=width)
        for reps, iters in ((1, pr.SCATTER_ITERS), (full, 20_000), (1, 1),
                            (full, 1), (1, 1001), (full, 1001)):
            args = (iters, n_rows, reps, seed)
            cases.append((f"vmem_scatter({n_rows}x{width}, seed {seed}, "
                          f"{iters} iterations, {reps} replicas)",
                          functools.partial(pr.vmem_scatter, mask, *args),
                          functools.partial(pr.vmem_scatter_plain, mask,
                                            *args)))
    big = pr.integer_table(pr.DMA_ROWS, pr.DMA_WIDTH, dev, seed=2)
    for rows in (pr.DMA_ROWS, 1_000_003):
        table = big[:rows]
        for depth in (1,) + pr.DMA_DEPTHS:
            for reps in (1, full):
                for iters in (pr.DMA_ITERS, depth):
                    args = (iters, depth, reps, pr.DMA_SEED + depth)
                    cases.append((f"hbm_dma({rows}x{pr.DMA_WIDTH}, depth "
                                  f"{depth}, {iters} iterations, {reps} "
                                  "replicas)",
                                  functools.partial(pr.hbm_dma, table, *args),
                                  functools.partial(pr.hbm_dma_plain, table,
                                                    *args)))
    for n_rows, width in ((pr.TABLE_ROWS, pr.WIDTH), (3001, pr.WIDTH),
                          (1000, 12)):
        table = pr.integer_table(n_rows, width, dev, seed=n_rows + 1)
        for batch, n_steps, many in MARCH_CASES:
            t0 = pr.integer_table(1, batch, dev, seed=batch) * 0.25
            for reps in (1, full) if many else (1,):
                # Computed at the first of its routes' cases, then kept.
                plain = functools.cache(functools.partial(
                    pr.vmem_batch_march_plain, table, t0, n_steps, reps))
                for route in (None,) + pr.MARCH_ROUTES:
                    cases.append((
                        f"vmem_batch_march({n_rows}x{width}, batch {batch}, "
                        f"{n_steps} steps, {reps} replicas, route "
                        f"{route or 'planned'})",
                        functools.partial(pr.vmem_batch_march_split, table,
                                          t0, n_steps, route, None, reps),
                        plain))
    return cases


def march_in_order(table, t0, n_steps, replicas, seed=probes.MARCH_SEED):
    """The march probe in the kernel's order of adds, step by step on the
    card: each ray's row summed w = 0, 1, ... in float32 (one rounding an
    operation, as the kernel, built without contraction), floored, and added
    into its depth in step order."""
    batch = t0.shape[-1]
    idx = probes._replica_indices(seed, replicas, n_steps * batch,
                                  table.shape[0], table.device)
    floor = torch.tensor(probes.MARCH_MIN_STEP, device=table.device)
    t = t0.reshape(1, batch).expand(replicas, batch)
    for k in range(n_steps):
        rows = table[idx[:, k * batch:(k + 1) * batch]]
        d = torch.zeros(replicas, batch, device=table.device)
        for w in range(table.shape[1]):
            d = d + rows[..., w] * 0.125
        t = t + torch.maximum(d, floor)
    return t


def probe_nonintegers(full):
    """Non-integer inputs: the scatter equals its plain version bit for bit
    (tolerance 0: every add into a cell adds the same mask value, so no
    order of the remote reductions changes a partial sum), and so it does
    on zeros of both signs, infinities, a subnormal, values that overflow
    and NaN, against the plain version on the CPU (sequential adds; the
    remote reductions keep subnormals, the card's index_add_ flushes
    them); two launches of each gather (device memory, shared memory) give
    the same bits (their reduction order is fixed by their plans) and agree
    with a float64 sum of the same rows within DMA_REL_TOL of their absolute
    sum; two launches of the march by either route give the same bits, the
    bits of the march in its order of adds (march_in_order; tolerance 0)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    mask = torch.rand(1, probes.WIDTH, generator=gen, device="cuda") - 0.5
    special = torch.tensor([[0.0, -0.0, float("inf"), -float("inf"), 1e-45,
                             3e38, 0.1, float("nan")]])
    cases = ((mask, probes.SCATTER_ITERS, 4096, 1, mask),
             (mask, probes.SCATTER_ITERS, 8192, full, mask),
             (special.cuda(), 50_000, 100, 1, special))
    for m, n_iters, n_rows, reps, m_ref in cases:
        got = probes.vmem_scatter(m, n_iters, n_rows, reps).to(m_ref.device)
        ref = probes.vmem_scatter_plain(m_ref, n_iters, n_rows, reps)
        same = ((got.view(torch.int32) == ref.view(torch.int32))
                | (torch.isnan(got) & torch.isnan(ref)))
        if not bool(same.all()):
            raise AssertionError(
                f"vmem_scatter on a non-integer mask != plain ({n_rows} rows, "
                f"{reps} replicas) at {int((~same).sum())} entries: max abs "
                f"err {max_abs_err(got, ref)}")
    big = torch.randn(probes.DMA_ROWS, probes.DMA_WIDTH, generator=gen,
                      device="cuda")
    small = torch.randn(probes.TABLE_ROWS, probes.WIDTH, generator=gen,
                        device="cuda")
    gathers = {
        "hbm_dma": (big, probes.DMA_SEED, probes.DMA_ITERS - 8,
                    lambda reps: probes.hbm_dma(big, probes.DMA_ITERS, 8,
                                                reps)),
        "vmem_gather": (small, probes.GATHER_SEED, probes.GATHER_ITERS,
                        lambda reps: probes.vmem_gather(
                            small, probes.GATHER_ITERS, reps)),
    }
    worst = {}
    for name, (table, seed, summed, fn) in gathers.items():
        worst[name] = 0.0
        for reps in (1, full):
            first, second = fn(reps), fn(reps)
            if not torch.equal(first, second):
                raise AssertionError(f"{name} on a non-integer table: two "
                                     f"launches differ ({reps} replicas)")
            idx = probes._replica_indices(seed, reps, summed,
                                          table.shape[0], "cuda")
            rows = table[idx].double()
            err = ((first.double() - rows.sum(dim=1)).abs()
                   / rows.abs().sum(dim=1))
            worst[name] = max(worst[name], float(err.max()))
            del rows
        if worst[name] > DMA_REL_TOL:
            raise AssertionError(f"{name} on a non-integer table: "
                                 f"{worst[name]} of the absolute sum from a "
                                 f"float64 sum, above {DMA_REL_TOL}")
    t0 = torch.randn(1, 256, generator=gen, device="cuda")
    for reps in (1, full):
        ref = march_in_order(small, t0, probes.MARCH_STEPS, reps)
        for route in probes.MARCH_ROUTES:
            first, second = (probes.vmem_batch_march_split(
                small, t0, probes.MARCH_STEPS, route, None, reps)
                for _ in range(2))
            if not (torch.equal(first, second) and torch.equal(first, ref)):
                raise AssertionError(
                    f"vmem_batch_march on a float table, route {route}, "
                    f"{reps} replicas: two launches equal "
                    f"{torch.equal(first, second)}, max abs err from the "
                    f"in-order march {max_abs_err(first, ref)}")
    log(f"probes non-integer: scatter == plain (bitwise, tolerance 0, on "
        f"special values too); hbm_dma and vmem_gather launches identical, "
        f"within {worst} of the absolute sum from a float64 sum (limit "
        f"{DMA_REL_TOL}); vmem_batch_march launches identical by either "
        f"route, == the in-order march (bitwise, tolerance 0)")


def march_routes(full):
    """The march probe at the card's shape: the plan's route and split at
    each batch for one replica and ``full``, each route's time there
    (queued, its own default CTAs), and the fixed cost of a launch with no
    steps (launch, set-up and, staged, the table's stage)."""
    dev = torch.device("cuda")
    table = probes.integer_table(probes.TABLE_ROWS, probes.WIDTH, dev)
    table_bytes = table.numel() * 4
    limit = probes.max_shared_bytes(dev)
    for batch in probes.MARCH_BATCHES:
        t0 = torch.zeros(1, batch, device=dev)
        for reps in (1, full):
            plan = probes.march_plan(batch, probes.MARCH_STEPS, reps, full,
                                     table_bytes=table_bytes,
                                     block_limit=limit)
            ms = {route: probes.queued_ms(
                lambda: probes.vmem_batch_march_split(
                    table, t0, probes.MARCH_STEPS, route, None, reps))
                for route in probes.MARCH_ROUTES}
            log(f"vmem_batch_march batch {batch}, {reps} replicas: plan "
                f"route {plan.route}, {plan.ctas} CTAs a replica of "
                f"{plan.threads} threads ({plan.rays} rays x {plan.group} "
                f"step lanes, chunk {plan.chunk} steps); queued ms by route "
                f"{json.dumps(ms)}")
        fixed = {route: probes.queued_ms(
            lambda: probes.vmem_batch_march_split(table, t0, 0, route, None))
            for route in (None,) + probes.MARCH_ROUTES}
        log(f"vmem_batch_march batch {batch}, one replica, no steps (fixed "
            f"cost, ms queued; None: the plan's): {fixed}")


def host_us(fn, reps):
    """Mean microseconds of host time per call of ``fn`` (after one warm-up
    call), the card not waited for."""
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t
    torch.cuda.synchronize()
    return host / reps * 1e6


def phase_probes():
    """The probes' entry point (kernels.probes.main: every probe at the
    card's shapes, one replica and one per SM) with the launch counts set
    to 0 before it and read after; then each probe bitwise against its
    plain version, and the plain versions' times at the card's shapes."""
    torch.cuda.synchronize()
    for name in probes.launches:
        probes.launches[name] = 0
    rates = probes.main()
    torch.cuda.synchronize()
    full = rates["replicas_full"]
    launches = dict(probes.launches)
    log(f"probes main(): launches {launches}")
    if min(launches.values()) == 0:
        raise AssertionError(f"a probe kernel was not launched: {launches}")

    worst = {name: 0.0 for name in PROBES}
    counted = 0
    for name, kernel, plain in probe_cases(full):
        got, ref = kernel(), plain()
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        key = name.split("(")[0]
        worst[key] = max(worst[key], err)
        if not torch.equal(got, ref):
            raise AssertionError(f"{name}: kernel != plain, max abs err "
                                 f"{err}")
        counted += 1
    log(f"probes kernel vs plain: {counted} cases bitwise equal "
        f"(replicas 1 and {full})")
    probe_nonintegers(full)
    floor_ms = rates["launch_floor_ms"]
    log(f"launch floor: the empty kernel takes {floor_ms:.6f} ms per launch "
        "(timed as the probes are, queued behind a spin)")
    log(f"fixed cost of a launch besides its rows (ms, one replica): "
        f"{json.dumps(rates['fixed_ms'])}")
    log(f"vmem_gather at one replica by CTAs a replica (ms, queued; the "
        f"plan takes {probes.gather_plan(probes.GATHER_ITERS, probes.WIDTH, 1, full).ctas}): "
        f"{json.dumps(rates['vmem_gather_cta_sweep_ms'])}")
    march_routes(full)

    dev = torch.device("cuda")
    table = probes.integer_table(probes.TABLE_ROWS, probes.WIDTH, dev)
    mask = probes.integer_table(1, probes.WIDTH, dev, seed=1)
    big = probes.integer_table(probes.DMA_ROWS, probes.DMA_WIDTH, dev, seed=2)
    t0 = torch.zeros(1, 256, device=dev)
    dma_seeds = probes.fresh_seeds(probes.DMA_SEED, 4, 1, probes.DMA_ITERS)
    plain_ms = {
        "vmem_gather": cuda_ms(lambda: probes.vmem_gather_plain(
            table, probes.GATHER_ITERS), 3),
        "vmem_scatter": cuda_ms(lambda: probes.vmem_scatter_plain(
            mask, probes.SCATTER_ITERS, 4096), 3),
        "hbm_dma": cuda_ms(lambda: probes.hbm_dma_plain(
            big, probes.DMA_ITERS, 8, 1, next(dma_seeds)), 3),
        "vmem_batch_march": cuda_ms(lambda: probes.vmem_batch_march_plain(
            table, t0, probes.MARCH_STEPS), 3),
    }
    # One PyTorch call per probe that moves the same rows, its indices made
    # before timing (a fresh sequence per call for the device-memory
    # probe's, as the probe reads); the march probe has none.
    def rows_of(seed, iters, n_rows):
        return torch.from_numpy(probes.lcg_indices(seed, iters,
                                                   n_rows)).to(dev)

    gidx = rows_of(probes.GATHER_SEED, probes.GATHER_ITERS, probes.TABLE_ROWS)
    sidx = rows_of(probes.SCATTER_SEED, probes.SCATTER_ITERS, 4096)
    src = mask.expand(probes.SCATTER_ITERS, probes.WIDTH).contiguous()
    acc = torch.zeros(4096, probes.WIDTH, device=dev)
    didx = [rows_of(seed, probes.DMA_ITERS, probes.DMA_ROWS) for seed in
            probes.fresh_seeds(probes.DMA_SEED, 24, 1, probes.DMA_ITERS)]
    dma_rows = iter(didx)
    library_calls = {
        "vmem_gather": lambda: torch.index_select(table, 0, gidx),
        "vmem_scatter": lambda: acc.index_add_(0, sidx, src),
        "hbm_dma": lambda: torch.index_select(big, 0, next(dma_rows)),
    }
    # Timed as the probes are (queued_ms) and, as earlier runs timed them,
    # paced by the host (cuda_ms).
    library_ms = {name: probes.queued_ms(fn, 10)
                  for name, fn in library_calls.items()}
    library_ms["vmem_batch_march"] = None
    for name, fn in library_calls.items():
        log(f"library call of {name}: {library_ms[name]:.6f} ms queued, "
            f"{cuda_ms(fn, 10):.6f} ms paced by the host")
    # Bytes (each input read once, each output written once; the rows the
    # device-memory probe reads, not its whole table) and float32 operations
    # of one replica at the timed shape.
    w, dw = probes.WIDTH, probes.DMA_WIDTH
    work = {
        "vmem_gather": (4 * (probes.TABLE_ROWS * w + w),
                        probes.GATHER_ITERS * w),
        "vmem_scatter": (4 * (w + 4096 * w), probes.SCATTER_ITERS * w),
        "hbm_dma": (4 * (probes.DMA_ITERS * dw + dw),
                    (probes.DMA_ITERS - 8) * dw),
        "vmem_batch_march": (4 * (probes.TABLE_ROWS * w + 2 * 256),
                             probes.MARCH_STEPS * 256 * (2 * w + 2)),
    }
    bounds = {name: bound_of(b, o) for name, (b, o) in work.items()}
    # Each probe at one replica as main() times it (queued), paced by the
    # host (cuda_ms, as earlier versions timed it), and its wrapper's host
    # time per call.
    seeds = probes.fresh_seeds(probes.DMA_SEED + 7, 2 * HOST_REPS, 1,
                               probes.DMA_ITERS)
    kernel_calls = {
        "vmem_gather": lambda: probes.vmem_gather(table, probes.GATHER_ITERS),
        "vmem_scatter": lambda: probes.vmem_scatter(
            mask, probes.SCATTER_ITERS, 4096),
        "hbm_dma": lambda: probes.hbm_dma(big, probes.DMA_ITERS, 8, 1,
                                          next(seeds)),
        "vmem_batch_march": lambda: probes.vmem_batch_march(
            table, t0, probes.MARCH_STEPS),
    }
    kernel_ms = {}
    for name, (_, key, rows) in PROBES.items():
        kernel_ms[name] = rates[key] * rows / 1e6
        fn = kernel_calls[name]
        log(f"probe {name} at one replica: {kernel_ms[name]:.6f} ms queued, "
            f"{cuda_ms(fn, 10):.6f} ms paced by the host, "
            f"{host_us(fn, HOST_REPS):.2f} us of host time a call")
        lib = library_ms[name]
        log(f"probe {name}: {rates[key]:.4f} ns/row with 1 replica "
            f"({kernel_ms[name]:.4f} ms), {rates['full_card'][key]:.4f} "
            f"ns/row over {full} replicas; plain version "
            f"{plain_ms[name]:.4f} ms (index generation included); library "
            f"call {'none' if lib is None else f'{lib:.4f} ms'}; bound "
            f"{bounds[name][0]:.6f} ms ({bounds[name][1]})")
    return launches, worst, kernel_ms, plain_ms, library_ms, bounds


def check_cone_equiv(base, cone, resolution):
    """tests/test_fast_render.py's contract for a cone-started render against
    the plain march of the same budget: every hit of the plain march is a
    hit here, and common depths agree within twice the threshold. Excepted
    are tangent grazers, whose sub-threshold sliver two sample sequences may
    enter at different points or not at all: for a lost hit, the plain
    march's final query within the grazer band of the threshold (as in the
    test); for the depth, either render's, since a shallow approach may stop
    either sequence just under the threshold. The depth test also skips
    the plain march's budget-capped hits (final query above the threshold:
    within the hit test's twice the threshold, but converged nowhere).
    Returns the grazer hits lost, the largest depth difference held to the
    contract, and the count of common hits past it (grazers or budget-
    capped) with their largest depth difference."""
    thresh = 0.25 * resolution
    band = GRAZER_BAND * resolution
    graze = (base.distance - thresh).abs() <= band
    divergent = base.hit & ~cone.hit
    if bool((divergent & ~graze).any()):
        lost = int((divergent & ~graze).sum())
        raise AssertionError(f"the schedule lost {lost} non-grazer hits of "
                             "the plain march")
    graze = graze | ((cone.distance - thresh).abs() <= band)
    both = base.hit & cone.hit
    diff = (cone.depth - base.depth).abs()
    past = both & (diff > 2.0 * thresh + 1e-6)
    held = both & ~graze & (base.distance <= thresh)
    if bool((past & held).any()):
        bad = past & held
        raise AssertionError(f"depth differs by {float(diff[bad].max())} m "
                             f"on {int(bad.sum())} common hits")
    err = float(diff[held].max())
    past_err = float(diff[past].max()) if bool(past.any()) else 0.0
    return int(divergent.sum()), err, int(past.sum()), past_err


def clutter_mask(n, device):
    """bench.py's clutter scene (rng 42: a floor slab and 14 spheres), built
    on the card in float64 as bench.py builds it in numpy."""
    rng = np.random.default_rng(42)
    ax = torch.arange(n, device=device, dtype=torch.float64)
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    mask[:, :, :24] = True
    for _ in range(14):
        cc = rng.uniform(0.15, 0.85, 3) * n
        cr = rng.uniform(20.0, 60.0)
        mask |= (((ax[:, None, None] - cc[0]) ** 2
                  + (ax[None, :, None] - cc[1]) ** 2)
                 + (ax[None, None, :] - cc[2]) ** 2) <= cr * cr
    return mask


def certified_share(sdf, table, camera):
    """Share of the frame's rays that the escape certificates retire
    unmarched (sphere_trace's ``killed`` mask under the schedule)."""
    from voxelized_geometry_tools_tpu_torch.ops import render

    thresh = 0.25 * sdf.resolution
    t_init, valid_from, _, escaped = render._cone_prepass(
        sdf, camera, SCHEDULE["coarse_factor"], NUM_STEPS, thresh, 100.0,
        table, max_cone_steps=SCHEDULE["cone_steps"],
        cone_tail_chunks=SCHEDULE["cone_tail_chunks"])
    t_enter, t_exit, _ = render._clip_to_grid(sdf, *render.camera_rays(camera))
    killed = (escaped & (torch.clamp(t_exit, max=100.0) <= t_init)
              & (t_enter >= valid_from))
    return float(killed.float().mean())


def profile_frame(fn):
    """Device operations (kernels and copies) one call of ``fn`` runs, and
    their summed device time in ms, from the profiler's trace."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = sum(1 for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA)
    if n == 0:
        raise AssertionError("the profiler saw no CUDA kernel")
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
    return n, busy


def phase_render_schedule(spec, sdf, table, camera, fixed):
    """bench.py's shipped schedule on the 512^3 sphere and clutter scenes:
    held against the fixed 64-step march of the same frame under the cone
    contract, with its counters, certificate share, time and launches."""
    from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query

    cmask = clutter_mask(GRID_N, "cuda")
    with torch.no_grad():
        csdf = edt.extract_signed_distance_field(cmask, spec, None,
                                                 frame="clutter")
        ctable = sdf_query.build_corner_table(csdf)
        cfixed = render.render_depth(csdf, camera, num_steps=NUM_STEPS,
                                     corner_table=ctable)
    del cmask
    for scene, s, t, base in (("sphere", sdf, table, fixed),
                              ("clutter", csdf, ctable, cfixed)):
        def frame(s=s, t=t):
            return render.render_depth(s, camera, num_steps=NUM_STEPS,
                                       corner_table=t, **SCHEDULE)

        with torch.no_grad():
            res, stats = render.render_depth(
                s, camera, num_steps=NUM_STEPS, corner_table=t,
                with_stats=True, **SCHEDULE)
            plain = frame()
            if not (torch.equal(plain.depth, res.depth)
                    and torch.equal(plain.hit, res.hit)):
                raise AssertionError(f"{scene}: with_stats changed the frame")
            hit_frac = float(res.hit.float().mean())
            # bench.py's camera sees the clutter scene's floor slab face-on
            # across the whole frame: every ray hits.
            if not 0.0 < hit_frac <= (1.0 if scene == "clutter" else 0.5):
                raise AssertionError(f"{scene}: hit fraction {hit_frac}")
            if not bool(torch.isfinite(res.depth[res.hit]).all()):
                raise AssertionError(f"{scene}: non-finite depth on hits")
            lost, derr, n_skip, skip_err = check_cone_equiv(base, res,
                                                            s.resolution)
            rows = render.gather_rows_from_stats(stats)
            cone_head = int(stats["cone_stages"][0]["head_iters"])
            if cone_head <= 0:
                raise AssertionError(f"{scene}: the cone head did not march")
            share = certified_share(s, t, camera)
            ms = cuda_ms(frame, SCHEDULE_FRAMES)
            n_launch, busy = profile_frame(frame)
        if scene == "sphere":
            pole = (1.2 - 0.25) * GRID_N * RESOLUTION
            center = float(res.depth[IMG_H // 2, IMG_W // 2])
            if abs(center - pole) > 2 * RESOLUTION:
                raise AssertionError(f"schedule central depth {center} m, "
                                     f"expected ~{pole}")
            log(f"schedule sphere: central depth {center:.6f} m (pole "
                f"~{pole:.3f} m)")
        fine = stats["fine_tail_iters"].tolist()
        base_frac = float(base.hit.float().mean())
        log(f"schedule {scene}: {ms:.3f} ms/frame = "
            f"{IMG_W * IMG_H / (ms / 1e3):.4e} rays/s; hit fraction "
            f"{hit_frac:.6f} (fixed march {base_frac:.6f},"
            f" {lost} grazer hits lost, max depth diff {derr:.3e} m; "
            f"{n_skip} grazer or budget-capped common hits past it, max "
            f"{skip_err:.3e} m); gather "
            f"rows/frame {rows:.0f}; certificate-retired share {share:.6f}; "
            f"cone head iterations {cone_head}; fine tail iterations {fine};"
            f" final sample rows {int(stats['final_sample_rows'])}; "
            f"{n_launch} device operations/frame, {busy:.3f} ms of device "
            f"time (idle share {1.0 - busy / ms:.3f})")


# -- Carving and the pipeline -------------------------------------------------


def grids_equal(a, b):
    return (torch.equal(a.seen_free.cpu(), b.seen_free.cpu())
            and torch.equal(a.seen_filled.cpu(), b.seen_filled.cpu()))


def setup_fields_differing(a, b):
    """The fields of two RaySetups whose bits differ (floats compared as
    int32, NaN included)."""
    def bits(t):
        t = t.cpu()
        return t.view(torch.int32) if t.dtype == torch.float32 else t
    return [f for f in a._fields
            if not torch.equal(bits(getattr(a, f)), bits(getattr(b, f)))]


def check_kernel_setup(name, spec, origin, cloud):
    """The card's setup (the setup kernel, after the product kernel's X_GC)
    against the plain setup on the card from the same X_GC, every field
    bitwise; the setup kernel launched once and the product kernel twice
    (the grid's inverse and the composition)."""
    from voxelized_geometry_tools_tpu_torch.kernels import (
        ray_setup, transform_product)
    from voxelized_geometry_tools_tpu_torch.ops import voxelize
    launched = (ray_setup.launches, transform_product.launches)
    got = voxelize.ray_setup(spec, origin, cloud)
    products = transform_product.launches - launched[1]
    if ray_setup.launches != launched[0] + 1 or products != 2:
        raise AssertionError(f"{name}: the setup launched the setup kernel "
                             f"{ray_setup.launches - launched[0]} times and "
                             f"the product kernel {products} times")
    plain = voxelize.ray_setup_plain(
        spec, voxelize._grid_frame_transform(origin, cloud), cloud.points,
        cloud.max_range)
    differ = setup_fields_differing(got, plain)
    if differ:
        raise AssertionError(f"{name}: the setup kernel differs from the "
                             f"plain setup on the card in {differ}")
    return got


def carve_fn(spec, setup, n_steps, run, zero=True):
    """One carve of ``setup`` into fresh grids by ``run``: the plain walk
    adds into grids zeroed first (``zero``); the tiled kernel and its plain
    model write every voxel, so nothing is zeroed. ``fn.grids`` holds the
    result, shaped as the grid."""
    free = torch.empty(spec.counts, dtype=torch.int32, device="cuda")
    filled = torch.empty_like(free)

    def fn():
        if zero:
            free.zero_()
            filled.zero_()
        run(spec.counts, setup, n_steps, free.view(-1), filled.view(-1))
    fn.grids = SimpleNamespace(seen_free=free, seen_filled=filled)
    return fn


def carve_bound(spec, setup, visits):
    """The carve's least time on the H100: its bytes (each ray's inputs
    read once, both int32 grids written once) at the HBM rate against its
    visits, each an int32 device-memory atomic, at the int32 add rate."""
    n_bytes = setup.hit.shape[0] * CARVE_RAY_BYTES + 2 * 4 * spec.num_total
    b = n_bytes / HBM_BYTES_PER_S * 1e3
    o = visits / INT32_OPS_PER_S * 1e3
    return (b, "bytes") if b >= o else (o, "operations")


def phase_carve():
    """bench.py's config2 carve and the oblique camera at 128^3: the tiled
    kernel (``raycast_pointcloud``'s carve on the card) bitwise against the
    plain walk (on the card and, from the same points, on the CPU), the
    tiled plain model, the plain column carve (run axis 2, pick_run_axis's
    choice, the diff accumulator), and the card's ray setup against the
    CPU's; the kernel's time, and the native CPU runtime's and the plain
    carves' rates."""
    from voxelized_geometry_tools_tpu_torch import GridSpec, native
    from voxelized_geometry_tools_tpu_torch.kernels import carve
    from voxelized_geometry_tools_tpu_torch.ops import voxelize

    spec = GridSpec.from_voxel_counts(CARVE_RES, (CARVE_N,) * 3)
    eye = torch.eye(4, device="cuda")
    n_steps = carve.segment_steps(3 * CARVE_N + 2)
    for name, make in (("config2", config2_cloud),
                       ("oblique (1, 1, 1)", oblique_cloud)):
        cloud = make("cuda")
        n_rays = cloud.points.shape[0]
        before = carve.launches_tiled
        got = voxelize.raycast_pointcloud(spec, eye, cloud)
        torch.cuda.synchronize()
        if carve.launches_tiled != before + 1:
            raise AssertionError(f"{name}: raycast_pointcloud did not launch "
                                 "the tiled kernel once")
        axis = voxelize.pick_run_axis(cloud, eye)
        t0 = time.monotonic()
        refs = {"plain walk": voxelize.raycast_pointcloud(
            spec, eye, cloud, backend="plain")}
        torch.cuda.synchronize()
        walk_ms = (time.monotonic() - t0) * 1e3
        for a in sorted({2, axis}, key=str):
            refs[f"column carve run_axis={a!r}"] = \
                voxelize.raycast_pointcloud_columns(spec, eye, cloud,
                                                    run_axis=a)
        refs["column carve diff"] = voxelize.raycast_pointcloud_columns(
            spec, eye, cloud, run_axis=axis, accumulate="diff")
        host = voxelize.PointCloud.create(cloud.points.cpu(),
                                          cloud.origin_transform.cpu(),
                                          float(cloud.max_range))
        t0 = time.monotonic()
        refs["CPU plain walk"] = voxelize.raycast_pointcloud(
            spec, eye.cpu(), host)
        cpu_walk_s = time.monotonic() - t0
        dev_setup = check_kernel_setup(name, spec, eye, cloud)
        model = carve_fn(spec, dev_setup, n_steps, carve.carve_tiled_plain,
                         zero=False)
        model()
        refs["tiled plain model"] = model.grids
        for what, ref in refs.items():
            if not grids_equal(got, ref):
                raise AssertionError(f"{name}: the tiled carve kernel "
                                     f"differs from the {what}")
        cpu_setup = voxelize.ray_setup(spec, eye.cpu(), host)
        hit = cpu_setup.hit
        for field in dev_setup._fields:
            # Rays that are not walked may hold any index (a float to int
            # conversion of NaN differs between devices).
            if not torch.equal(getattr(dev_setup, field).cpu()[hit],
                               getattr(cpu_setup, field)[hit]) \
                    or not torch.equal(dev_setup.hit.cpu(), hit):
                raise AssertionError(f"{name}: the card's ray setup differs "
                                     f"from the CPU's in {field}")
        visits = carve.count_visits(spec.counts, dev_setup, n_steps)
        tiled = carve_fn(spec, dev_setup, n_steps, carve.carve_tiled,
                         zero=False)
        times = {"carve_tiled": [cuda_ms(tiled, 20) for _ in range(2)]}
        wrapper_ms = cuda_ms(
            lambda: voxelize.raycast_pointcloud(spec, eye, cloud), 10)
        t0 = time.monotonic()
        voxelize.raycast_pointcloud_columns(spec, eye, cloud, run_axis=axis)
        torch.cuda.synchronize()
        cols_ms = (time.monotonic() - t0) * 1e3
        native_ms = None
        if name == "config2":
            # The camera's rotation is the identity: grid-frame points are
            # the camera's plus its position.
            origin = np.array([1.28, 1.28, -1.0], np.float32)
            pts = cloud.points.cpu().numpy() + origin
            native.raycast(origin, pts, np.inf, spec.counts, CARVE_RES)
            t0 = time.monotonic()
            reps = 3
            for _ in range(reps):
                nf, nd = native.raycast(origin, pts, np.inf, spec.counts,
                                        CARVE_RES)
            native_ms = (time.monotonic() - t0) / reps * 1e3
        bound_ms, bound_by = carve_bound(spec, dev_setup, visits)
        tiled_ms = float(np.mean(times["carve_tiled"]))
        log(f"carve {name}: {n_rays} rays into {CARVE_N}^3, tiled kernel "
            f"bitwise equal to {', '.join(refs)}, the setup kernel's setup "
            f"equal to the plain setup on the card and to the CPU's; "
            f"{visits} visits ({visits / n_rays:.1f} a ray); tiled kernel "
            f"{times['carve_tiled']} ms = "
            f"{n_rays / (tiled_ms / 1e3):.4e} rays/s "
            f"({visits / (tiled_ms / 1e3):.4e} visits/s, bound "
            f"{bound_ms:.4f} ms by {bound_by}, reached "
            f"{bound_ms / tiled_ms:.3f}); raycast_pointcloud "
            f"(setup + kernel) {wrapper_ms:.4f} ms = "
            f"{n_rays / (wrapper_ms / 1e3):.4e} rays/s; plain walk one call "
            f"{walk_ms:.1f} ms; plain column carve "
            f"run_axis={axis!r} one call {cols_ms:.1f} ms; CPU plain walk "
            f"{cpu_walk_s:.2f} s"
            + ("" if native_ms is None else
               f"; native CPU runtime ({native.hardware_threads()} threads) "
               f"{native_ms:.2f} ms = {n_rays / (native_ms / 1e3):.4e} "
               "rays/s"))


def filled_invariant(spec, cloud):
    """Rays whose endpoint the kernel must mark filled: finite, not
    range-clipped, endpoint in the grid (grid frame = world frame here),
    computed apart from the carve's setup."""
    from voxelized_geometry_tools_tpu_torch.core import transforms
    pts = cloud.points
    p = transforms.apply_isometry(cloud.origin_transform, pts)
    ray = p - cloud.origin_transform[:3, 3]
    length = torch.sqrt((ray.double() ** 2).sum(-1))
    idx = torch.floor(p / spec.resolution).long()
    inside = ((idx >= 0) & (idx < PIPE_N)).all(-1)
    finite = torch.isfinite(pts).all(-1)
    return int((finite & inside & (length <= float(cloud.max_range))).sum())


def phase_pipeline(camera):
    """ROADMAP items 8 and 9 at full size: four 640x480 clouds carved into
    512^3 (0.5 static occupancy) by the best-available voxelizer (the
    tiled carve kernel, each cloud into its slice of one stacked pair),
    fused, EDT, and a 64-step render from bench.py's camera, through
    ``reconstruct``; each camera's tiled-kernel grids bitwise against the
    plain walk on the card and on the CPU and the plain column carve, the
    fused occupancy against combine_and_filter of the plain grids, the
    filled-count invariant, the phase times and peak device memory; the
    tiled kernel's time on camera 0."""
    from voxelized_geometry_tools_tpu_torch import GridSpec, OccupancyMap
    from voxelized_geometry_tools_tpu_torch.kernels import (
        carve, fusion_filter, transform_product)
    from voxelized_geometry_tools_tpu_torch.models import fusion_pipeline
    from voxelized_geometry_tools_tpu_torch.ops import (backends, edt, render,
                                                        voxelize)

    spec = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    env = OccupancyMap.create(spec, default_occupancy=0.5, device="cuda")
    clouds = pipeline_clouds("cuda")
    logs = []
    vox = backends.make_best_available_pointcloud_voxelizer({}, logs.append)
    if not isinstance(vox, backends.AcceleratorPointCloudVoxelizer) \
            or vox.device.type != "cuda":
        raise AssertionError(f"best available voxelizer: {vox} ({logs})")
    log(f"pipeline voxelizer: {'; '.join(logs)}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    runtimes = []
    reset_launches()
    products = transform_product.launches
    t0 = time.monotonic()
    with torch.no_grad():
        out = fusion_pipeline.reconstruct(env, clouds, camera, voxelizer=vox,
                                          runtime_log_fn=runtimes.append)
    torch.cuda.synchronize()
    step_s = time.monotonic() - t0
    counts = read_launches()
    products = transform_product.launches - products
    peak = torch.cuda.max_memory_allocated()
    if (counts["ray_setup"], counts["carve_tiled"]) != (len(clouds),) * 2:
        raise AssertionError(f"the pipeline's carve launches: {counts}, "
                             f"expected the ray setup and the tiled kernel "
                             f"once for each of {len(clouds)} cameras")
    if counts["edt_bestfirst_staged"] != 2:
        raise AssertionError(f"the pipeline's EDT launches: {counts}")
    if counts["fusion_filter"] != 1:
        raise AssertionError(f"the pipeline's filter launches: {counts}, "
                             "expected the fusion filter kernel once")
    if counts["edt_combine"] != 1:
        raise AssertionError(f"the pipeline's combine launches: {counts}")
    occ = out.occupancy_map.occupancy
    values = set(torch.unique(occ).tolist())
    if not values <= {0.0, 0.5, 1.0} or len(values) != 3:
        raise AssertionError(f"fused occupancy values {values}")
    res = out.render_result
    hit_frac = float(res.hit.float().mean())
    if not hit_frac > 0.0 or not bool(
            torch.isfinite(res.depth[res.hit]).all()):
        raise AssertionError(f"pipeline render: hit fraction {hit_frac}")
    if not bool(torch.isfinite(out.sdf.distances).all()):
        raise AssertionError("pipeline SDF is not finite")
    # Phase times apart (each synchronized): the EDT and the render again.
    with torch.no_grad():
        t0 = time.monotonic()
        sdf = edt.extract_sdf_from_occupancy(occ, spec, env.origin_transform)
        torch.cuda.synchronize()
        edt_s = time.monotonic() - t0
        t0 = time.monotonic()
        again = render.render_depth(sdf, camera, num_steps=NUM_STEPS)
        torch.cuda.synchronize()
        render_s = time.monotonic() - t0
    if not torch.equal(sdf.distances, out.sdf.distances) or not torch.equal(
            again.depth, res.depth):
        raise AssertionError("the pipeline's EDT or render is not repeatable")
    del sdf, again
    log(f"pipeline {PIPE_N}^3, {len(clouds)} cameras ("
        f"{sum(c.points.shape[0] for c in clouds)} rays): step "
        f"{step_s * 1e3:.1f} ms (carve {runtimes[0].raycasting_time * 1e3:.1f}"
        f" ms, filter {runtimes[0].filtering_time * 1e3:.1f} ms; EDT alone "
        f"{edt_s * 1e3:.1f} ms, render alone {render_s * 1e3:.1f} ms); peak "
        f"device memory {peak / 2 ** 30:.3f} GiB; launches {counts}; "
        f"occupancy free/unknown/filled "
        f"{[int((occ == v).sum()) for v in (0.0, 0.5, 1.0)]}; render hit "
        f"fraction {hit_frac:.6f}")

    # Each camera's tiled-kernel grids, fresh and its slice of a stacked
    # pair carved by the voxelizers' carve route (written over garbage),
    # against the plain walk (card and CPU) and the plain column carve.
    eye = env.origin_transform
    n_steps = carve.segment_steps(3 * PIPE_N + 2)
    # Garbage freed where the caching allocator will likely place the pair.
    garbage = torch.full((2, len(clouds)) + spec.counts, -7,
                         dtype=torch.int32, device="cuda")
    del garbage
    stacked = voxelize.stacked_grids(spec, len(clouds), "cuda")
    for i, cloud in enumerate(clouds):
        voxelize._carve_cloud(spec, eye, cloud, None, 16384, None,
                              voxelize.TrackingGrid(stacked[0][i],
                                                    stacked[1][i]))
    plain_free, plain_filled = [], []
    first = None
    for i, cloud in enumerate(clouds):
        got = voxelize.raycast_pointcloud(spec, eye, cloud, backend="cuda")
        setup = voxelize.ray_setup(spec, eye, cloud)
        plain = carve_fn(spec, setup, n_steps, carve.carve_plain)
        plain()
        host = voxelize.PointCloud.create(cloud.points.cpu(),
                                          cloud.origin_transform.cpu(),
                                          float(cloud.max_range))
        t0 = time.monotonic()
        cpu_walk = voxelize.raycast_pointcloud(spec, eye.cpu(), host)
        cpu_walk_s = time.monotonic() - t0
        axis = voxelize.pick_run_axis(cloud, eye)
        t0 = time.monotonic()
        ref = voxelize.raycast_pointcloud_columns(
            spec, eye, cloud, run_axis=axis, ray_chunk=cloud.points.shape[0])
        torch.cuda.synchronize()
        cols_s = time.monotonic() - t0
        sliced = SimpleNamespace(seen_free=stacked[0][i],
                                 seen_filled=stacked[1][i])
        for what, other in (("plain walk", plain.grids),
                            ("CPU plain walk", cpu_walk),
                            ("plain column carve", ref)):
            for which, grids in (("tiled carve kernel", got),
                                 ("carve route's stacked slice",
                                  sliced)):
                if not grids_equal(grids, other):
                    raise AssertionError(f"camera {i}: the {which} differs "
                                         f"from the {what}")
        filled = int(got.seen_filled.sum())
        want = filled_invariant(spec, cloud)
        if filled != want:
            raise AssertionError(f"camera {i}: {filled} filled marks, "
                                 f"expected {want}")
        scratch = carve._launch_tiled(spec.counts, setup, n_steps,
                                      got.seen_free.view(-1),
                                      got.seen_filled.view(-1),
                                      carve.TILE)["scratch"]
        n_tiles = (scratch.numel() - 3) // 4
        entries = int(scratch[2 * n_tiles])
        busy = int((scratch[:n_tiles] > 0).sum())
        log(f"pipeline camera {i}: tiled kernel and the carve route's "
            f"stacked slice bitwise equal to the plain walk (card; CPU one "
            f"call {cpu_walk_s:.1f} s) "
            f"and the plain column carve (run_axis={axis!r}, one call "
            f"{cols_s * 1e3:.1f} ms); filled marks {filled} = finite "
            f"unclipped in-grid rays; free marks {int(got.seen_free.sum())};"
            f" tile lists {entries} entries "
            f"({entries / cloud.points.shape[0]:.2f} a ray) in {busy} of "
            f"{n_tiles} tiles of {carve.tile_shape(spec.counts)}")
        plain_free.append(ref.seen_free)
        plain_filled.append(ref.seen_filled)
        if first is None:
            first = setup
        del got, sliced, ref, plain, cpu_walk, setup
    del stacked
    fused = fusion_filter.combine_and_filter_plain(
        voxelize.FilterOptions(), torch.stack(plain_free),
        torch.stack(plain_filled), env.occupancy)
    if not torch.equal(fused, occ):
        raise AssertionError("the pipeline's fused occupancy differs from "
                             "the plain filter of the plain grids")
    del plain_free, plain_filled, fused

    # The tiled kernel at the main path's shape (camera 0), a carve into
    # fresh 512^3 grids, against its plain version on the same setup; the
    # bound.
    visits = carve.count_visits(spec.counts, first, n_steps)
    tiled = carve_fn(spec, first, n_steps, carve.carve_tiled, zero=False)
    times = {"carve_tiled": [cuda_ms(tiled, 10) for _ in range(2)]}
    plain_ms = {"carve_tiled": cuda_ms(carve_fn(
        spec, first, n_steps, carve.carve_tiled_plain, zero=False), 1)}
    bound_ms, bound_by = carve_bound(spec, first, visits)
    n_rays = first.hit.shape[0]
    rows = {}
    for kname, ms_turns in times.items():
        ms = float(np.mean(ms_turns))
        log(f"{kname}, pipeline camera 0: {ms_turns} ms (twice) = "
            f"{n_rays / (ms / 1e3):.4e} rays/s, {visits} visits "
            f"({visits / (ms / 1e3):.4e} visits/s); plain version "
            f"{plain_ms[kname]:.1f} ms; bound {bound_ms:.4f} ms by "
            f"{bound_by}, reached {bound_ms / ms:.3f}")
        rows[kname] = {"launches": counts[kname], "ms": ms,
                       "plain_ms": plain_ms[kname], "bound_ms": bound_ms,
                       "bound_by": bound_by}
    rows.update(setup_rows(spec, eye, clouds[0], counts["ray_setup"],
                           products))
    return rows


def setup_rows(spec, origin, cloud, setup_launches, product_launches):
    """The setup kernel and the transform product kernel at the main
    path's shapes (a 640x480 camera's setup, the grid-frame 4x4 product),
    queued, each against its plain version: the plain setup on the card
    and the product formed on the host from the card's operands (two
    copies down, one up, as before the kernel). Bounds: the bytes, each
    input read once and each output written once."""
    from voxelized_geometry_tools_tpu_torch.core import transforms
    from voxelized_geometry_tools_tpu_torch.kernels import (
        ray_setup, transform_product)
    from voxelized_geometry_tools_tpu_torch.ops import voxelize

    check_kernel_setup("pipeline camera 0", spec, origin, cloud)
    inverse = transforms.invert_isometry(origin)
    X_GC = transforms.compose(inverse, cloud.origin_transform)
    n = cloud.points.shape[0]

    def kernel():
        ray_setup.ray_setup(X_GC, cloud.points, cloud.max_range,
                            spec.counts, spec.resolution, spec.grid_sizes)

    def plain():
        voxelize.ray_setup_plain(spec, X_GC, cloud.points, cloud.max_range)

    def product():
        transforms.compose(inverse, cloud.origin_transform)

    def host_product():
        transforms._chain_on_host(inverse, cloud.origin_transform)

    rows = {}
    for kname, run, run_plain, n_bytes, launches, source, replaces in (
            ("ray_setup", kernel, plain, ray_setup.RAY_BYTES * n,
             setup_launches, "ray_setup.cu", SETUP_REPLACES),
            ("transform_product", product, host_product, 3 * 16 * 4,
             product_launches, "transform_product.cu", PRODUCT_REPLACES)):
        ms_turns = [probes.queued_ms(run) for _ in range(2)]
        plain_ms = cuda_ms(run_plain, 10)
        ms = float(np.mean(ms_turns))
        bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"{kname}, pipeline camera 0 ({n} rays): {ms_turns} ms queued "
            f"(twice); plain version {plain_ms:.4f} ms a call; bound "
            f"{bound_ms:.6f} ms by bytes ({n_bytes} B), reached "
            f"{bound_ms / ms:.4f}; launches in the pipeline step "
            f"{launches}")
        rows[kname] = {"launches": launches, "ms": ms, "plain_ms": plain_ms,
                       "bound_ms": bound_ms, "bound_by": "bytes",
                       "source": source, "replaces": replaces}
    return rows


# Fault F1's input (ROADMAP.md section 3; tests/test_torch_transforms_exact.py
# draws the same scene with fewer points), and the 512^3 grid turned about
# its centre by these angles (radians about x, then y, then z).
F1_N, F1_RES, F1_POINTS, F1_SEED = 64, 0.02, 200_000, 200
ROTATED_ANGLES = (0.3, -0.2, 0.25)
# The pipeline cameras' intrinsics (carve_timings.pipeline_clouds: pixel
# (u, v) is the ray (u - w/2, v - h/2, 600)).
CLOUD_FOCAL = 600.0
LOCALIZE_ITERS = 5
FIT_STEPS = 48
POSE_FIT_ITERS = 5
# The pose fits' Adam step (rad and m a step): 0.2 voxel at 0.01 m, where
# the package's default of 0.01 (made for 0.1 m voxels) overshoots.
POSE_LR = 2e-3
POSE_FIT_TANGENT = (0.01, -0.01, 0.005, 0.02, -0.01, 0.01)
# remat=True against remat=False on the card: each fit step's loss, rtol.
REMAT_RTOL = 1e-4
VOXEL_FIT_ITERS = 3
# The voxel fit's noise and Adam step, in voxels.
VOXEL_NOISE, VOXEL_LR = 0.3, 0.05
PAIR_QUERY_POINTS = 1_000_000


def quat_rotation(q):
    """Rotation matrix of the unit quaternion ``q / |q|`` (w, x, y, z)."""
    w, x, y, z = np.asarray(q, np.float64) / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])


def f1_scene(device):
    """F1's 64^3 grid at 0.02 m under an origin rotated about all three
    axes and one rotated camera inside it with 200,000 rays, drawn from
    ``default_rng(200)``: (spec, X_WG as numpy, cloud)."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.ops import voxelize
    rng = np.random.default_rng(F1_SEED)
    origin = np.eye(4, dtype=np.float32)
    origin[:3, :3] = quat_rotation(rng.normal(size=4))
    origin[:3, 3] = rng.uniform(-0.5, 0.5, 3)
    cam_grid = np.full(3, F1_N) * F1_RES * rng.uniform(0.3, 0.7, 3)
    cam_rot = quat_rotation(rng.normal(size=4))
    pts = rng.uniform(-2, 2, (F1_POINTS, 3)).astype(np.float32)
    o = origin.astype(np.float64)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, :3] = o[:3, :3] @ cam_rot
    pose[:3, 3] = o[:3, :3] @ cam_grid + o[:3, 3]
    spec = GridSpec.from_voxel_counts(F1_RES, (F1_N,) * 3)
    return spec, origin, voxelize.PointCloud.create(pts, pose, max_range=5.0,
                                                    device=device)


def rotated_pipeline_origin():
    """X_WG of the pipeline's 512^3 grid turned about its centre by
    ``ROTATED_ANGLES``, so the pipeline's cameras still look into it."""
    (cx, sx), (cy, sy), (cz, sz) = ((np.cos(a), np.sin(a))
                                    for a in ROTATED_ANGLES)
    rx = np.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    rot = rz @ ry @ rx
    centre = np.full(3, PIPE_N * PIPE_RES / 2)
    m = np.eye(4, dtype=np.float32)
    m[:3, :3] = rot
    m[:3, 3] = centre - rot @ centre
    return m


def termwise_grid_frame(origin, pose):
    """``inverse(X_WG) @ X_WC`` with each product rounded before the sums
    (k in order), as the port formed it before its transforms took XLA's
    fused multiply-add chain."""
    def product(a, b):
        out = a[:, :1] * b[:1, :]
        for k in range(1, a.shape[1]):
            out = out + a[:, k:k + 1] * b[k:k + 1, :]
        return out

    m = torch.from_numpy(origin)
    rt = m[:3, :3].T
    inv = torch.eye(4)
    inv[:3, :3] = rt
    inv[:3, 3:] = product(-rt, m[:3, 3:])
    return product(inv, pose)


def phase_rotated_carve():
    """Fault F1 on the card: under grid origins rotated about all three
    axes (F1's 64^3 input, and the pipeline's first camera into 512^3), the
    carve's X_GC on the card is the CPU's bit for bit, and the tiled carve
    kernel's grids equal the plain walk on the card (and, at 64^3, the
    plain walk on the CPU)."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.kernels import carve
    from voxelized_geometry_tools_tpu_torch.ops import voxelize

    t_phase = time.monotonic()
    big = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    cases = [("F1 64^3", *f1_scene("cuda"), True),
             (f"pipeline camera 0, {PIPE_N}^3", big, rotated_pipeline_origin(),
              pipeline_clouds("cuda")[0], False)]
    for name, spec, origin, cloud, on_cpu in cases:
        origin_card = torch.from_numpy(origin).cuda()
        host = voxelize.PointCloud.create(
            cloud.points.cpu(), cloud.origin_transform.cpu(),
            float(cloud.max_range), device="cpu")
        x_card = voxelize._grid_frame_transform(origin_card, cloud).cpu()
        x_cpu = voxelize._grid_frame_transform(torch.from_numpy(origin), host)
        if not torch.equal(x_card.view(torch.int32), x_cpu.view(torch.int32)):
            raise AssertionError(f"{name}: X_GC on the card differs from the "
                                 f"CPU's:\n{x_card}\n{x_cpu}")
        # The products rounded term by term (the port before the fix).
        flips = int((termwise_grid_frame(origin, host.origin_transform)
                     != x_cpu).sum())
        check_kernel_setup(name, spec, origin_card, cloud)
        before = carve.launches_tiled
        t0 = time.monotonic()
        got = voxelize.raycast_pointcloud(spec, origin_card, cloud)
        torch.cuda.synchronize()
        kernel_ms = (time.monotonic() - t0) * 1e3
        if carve.launches_tiled != before + 1:
            raise AssertionError(f"{name}: raycast_pointcloud launched the "
                                 f"tiled kernel {carve.launches_tiled - before}"
                                 " times, expected once")
        plain = voxelize.raycast_pointcloud(spec, origin_card, cloud,
                                            backend="plain")
        refs = [("plain walk on the card", plain)]
        if on_cpu:
            refs.append(("plain walk on the CPU", voxelize.raycast_pointcloud(
                spec, torch.from_numpy(origin), host)))
        for what, ref in refs:
            if not grids_equal(got, ref):
                raise AssertionError(f"{name}: the tiled carve kernel differs "
                                     f"from the {what}")
        log(f"rotated carve, {name}: X_GC on the card (the product kernel) "
            f"equal to the CPU's (a term-by-term product differs in {flips} "
            f"of 16 elements); the setup kernel's setup equal to the plain "
            f"setup on the card; "
            f"tiled kernel ({kernel_ms:.2f} ms a call, setup included) "
            f"bitwise equal to the {' and the '.join(w for w, _ in refs)}; "
            f"free marks {int(got.seen_free.sum())}, filled marks "
            f"{int(got.seen_filled.sum())}")
        del got, plain, refs
    log(f"phase_rotated_carve: {time.monotonic() - t_phase:.1f} s")


def _timed(fn):
    """(fn(), ms) with the card synchronized after."""
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def phase_mapper():
    """ROADMAP item 9's OnlineMapper at 512^3, 0.01 m: the pipeline's four
    clouds integrated one at a time (each a tiled-kernel carve), the same
    four folded by integrate_frames into a fresh mapper (equal occupancy),
    both against the plain walk on the card followed by combine_and_filter,
    bitwise; then the cached SDF (the staged best-first EDT kernel), a
    640x480 64-step render from the last cloud's camera and a 5-iteration
    localize against it. Prints each phase's time and the peak memory."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.kernels import fusion_filter
    from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
        OnlineMapper)
    from voxelized_geometry_tools_tpu_torch.models import fusion_pipeline
    from voxelized_geometry_tools_tpu_torch.ops import render, voxelize

    t_phase = time.monotonic()
    spec = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    clouds = pipeline_clouds("cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    mapper = OnlineMapper(spec, frame="world", device="cuda")
    frame_ms = [_timed(lambda c=c: mapper.integrate(c))[1] for c in clouds]
    counts = read_launches()
    filter_launches = counts["fusion_filter"]
    if (counts["ray_setup"], counts["carve_tiled"],
            filter_launches) != (len(clouds),) * 3 or sum(
            counts.values()) != 3 * len(clouds):
        raise AssertionError(f"the mapper's integrate launches: {counts}, "
                             f"expected the ray setup, the tiled carve and "
                             f"the fusion filter kernels once for each of "
                             f"{len(clouds)} frames")
    fold = OnlineMapper(spec, frame="world", device="cuda")
    _, fold_ms = _timed(lambda: fold.integrate_frames(clouds))
    occ = mapper.occupancy_map.occupancy
    if not torch.equal(fold.occupancy_map.occupancy, occ):
        raise AssertionError("integrate_frames' occupancy differs from "
                             "integrate's, frame by frame")
    if (mapper.frames_integrated, fold.frames_integrated) != (4, 4):
        raise AssertionError("frames_integrated")
    del fold
    ref = torch.zeros(spec.counts, dtype=torch.float32, device="cuda")
    eye = mapper.occupancy_map.origin_transform
    for cloud in clouds:
        g = voxelize.raycast_pointcloud(spec, eye, cloud, backend="plain")
        ref = fusion_filter.combine_and_filter_plain(
            voxelize.FilterOptions(), g.seen_free[None], g.seen_filled[None],
            ref)
        del g
    if not torch.equal(ref, occ):
        raise AssertionError("the mapper's occupancy differs from the plain "
                             "walk followed by the plain filter")
    del ref
    values = [int((occ == v).sum()) for v in (0.0, 0.5, 1.0)]
    if not all(values):
        raise AssertionError(f"mapper occupancy free/unknown/filled {values}")

    reset_launches()
    with torch.no_grad():
        sdf, sdf_ms = _timed(mapper.sdf)
    counts = read_launches()
    if (counts["edt_bestfirst_staged"], counts["edt_seed"],
            counts["edt_combine"]) != (2, 1, 1) or sum(counts.values()) != 4:
        raise AssertionError(f"the mapper's SDF launches: {counts}, expected "
                             "the staged best-first EDT kernel twice, the "
                             "seed and the combine kernel once")
    if mapper.sdf() is not sdf or not bool(
            torch.isfinite(sdf.distances).all()):
        raise AssertionError("the mapper's SDF is not cached or not finite")

    camera = render.PinholeCamera.create(
        clouds[-1].origin_transform, IMG_W, IMG_H, focal=CLOUD_FOCAL,
        cx=IMG_W / 2, cy=IMG_H / 2, device="cuda")
    with torch.no_grad():
        res, render_ms = _timed(lambda: mapper.render_depth(
            camera, num_steps=NUM_STEPS))
    hit = float(res.hit.float().mean())
    if not hit > 0.5 or not bool(torch.isfinite(res.depth).all()):
        raise AssertionError(f"mapper render: hit fraction {hit}")
    guess = dataclasses.replace(camera, pose=fusion_pipeline.perturb_pose(
        camera.pose, torch.tensor((0.0, 0.0, 0.0, 0.0, 0.0, 0.02),
                                  device="cuda")))
    fit, localize_ms = _timed(lambda: mapper.localize(
        guess, res.depth, num_iters=LOCALIZE_ITERS, learning_rate=POSE_LR))
    losses = fit.losses.cpu().numpy()
    if not np.isfinite(losses).all() or not fit.valid_fraction > 0.5:
        raise AssertionError(f"localize: losses {losses}, valid fraction "
                             f"{fit.valid_fraction}")
    peak = torch.cuda.max_memory_allocated()
    log(f"mapper {PIPE_N}^3, {len(clouds)} frames of {IMG_W}x{IMG_H}: "
        f"integrate {[round(t, 2) for t in frame_ms]} ms a frame, "
        f"integrate_frames {fold_ms:.2f} ms for {len(clouds)} (equal "
        f"occupancy, equal to the plain walk + the plain filter); sdf "
        f"{sdf_ms:.2f} ms; render {render_ms:.2f} ms (hit fraction "
        f"{hit:.6f}); localize {LOCALIZE_ITERS} iterations {localize_ms:.2f} "
        f"ms, losses {losses.tolist()}, valid fraction "
        f"{fit.valid_fraction:.6f}; occupancy free/unknown/filled {values}; "
        f"peak device memory {peak / 2 ** 30:.3f} GiB")
    log(f"phase_mapper: {time.monotonic() - t_phase:.1f} s")
    return filter_launches


def phase_fits():
    """ROADMAP item 9's fits on bench.py's 512^3 sphere at 640x480, 48
    steps: fit_camera_pose for 5 iterations without and with remat (both
    peak memories and loss histories, which agree within rtol 1e-4),
    fit_voxels with two cameras for 3 iterations once with a CornerTable
    request and once with a CornerPairTable request (each loss falls), and
    pair-table queries against brick-table queries on 10^6 random points,
    bitwise."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.models import fusion_pipeline
    from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query

    t_phase = time.monotonic()
    spec = GridSpec.from_voxel_counts(RESOLUTION, (GRID_N,) * 3)
    mask = sphere_mask(GRID_N, "cuda")
    reset_launches()
    with torch.no_grad():
        sdf = edt.extract_signed_distance_field(mask, spec, None,
                                                frame="bench")
    torch.cuda.synchronize()
    counts = read_launches()
    if (counts["edt_bestfirst_staged"], counts["edt_combine"]) != (2, 1) \
            or sum(counts.values()) != 4:
        raise AssertionError(f"the fits' SDF launches: {counts}")
    del mask
    sizes = np.asarray(spec.grid_sizes)
    front = np.eye(4, dtype=np.float32)
    front[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    side = look_along((1.0, 0.0, 0.0),
                      sizes / 2.0 - np.array([1.2 * sizes[0], 0.0, 0.0]))
    cams = [render.PinholeCamera.create(p, IMG_W, IMG_H, focal=520.0,
                                        device="cuda") for p in (front, side)]
    with torch.no_grad():
        frames = [render.render_depth(sdf, c, num_steps=FIT_STEPS)
                  for c in cams]
    targets = [f.depth for f in frames]
    target_hits = float(frames[0].hit.float().mean())
    del frames
    base = dataclasses.replace(cams[0], pose=fusion_pipeline.perturb_pose(
        cams[0].pose, torch.tensor(POSE_FIT_TANGENT, device="cuda")))
    pose_fits = {}
    for remat in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fit, ms = _timed(lambda: fusion_pipeline.fit_camera_pose(
            sdf, base, targets[0], num_iters=POSE_FIT_ITERS,
            learning_rate=POSE_LR, num_steps=FIT_STEPS, remat=remat))
        losses = fit.losses.cpu().numpy()
        peak = torch.cuda.max_memory_allocated()
        pose_fits[remat] = losses
        log(f"fit_camera_pose {GRID_N}^3 sphere, {IMG_W}x{IMG_H}, "
            f"{FIT_STEPS} steps, remat={remat}: {ms / POSE_FIT_ITERS:.1f} ms "
            f"a step ({POSE_FIT_ITERS} steps, final render included), peak "
            f"device memory {peak / 2 ** 30:.3f} GiB, losses "
            f"{losses.tolist()}, valid fraction {fit.valid_fraction:.6f} "
            f"(the target's hits {target_hits:.6f})")
        if not np.isfinite(losses).all() or not (
                fit.valid_fraction > 0.5 * target_hits):
            raise AssertionError(f"fit_camera_pose: losses {losses}, valid "
                                 f"fraction {fit.valid_fraction}, the "
                                 f"target's hits {target_hits}")
    if not np.allclose(pose_fits[True], pose_fits[False], rtol=REMAT_RTOL,
                       atol=0.0):
        raise AssertionError("remat changed the pose fit's losses beyond "
                             f"rtol {REMAT_RTOL}: {pose_fits}")

    gen = torch.Generator(device="cuda").manual_seed(0)
    noisy = sdf.replace(distances=sdf.distances + VOXEL_NOISE * RESOLUTION
                        * torch.randn(spec.counts, generator=gen,
                                      device="cuda"))
    for build in (sdf_query.build_corner_table,
                  sdf_query.build_corner_pair_table):
        with torch.no_grad():
            proto = build(noisy)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (refined, losses), ms = _timed(lambda: fusion_pipeline.fit_voxels(
            noisy, cams, targets, num_iters=VOXEL_FIT_ITERS,
            learning_rate=VOXEL_LR * RESOLUTION, num_steps=FIT_STEPS,
            corner_table=proto))
        losses = losses.cpu().numpy()
        peak = torch.cuda.max_memory_allocated()
        kind = type(proto).__name__
        log(f"fit_voxels {GRID_N}^3, 2 cameras, {kind} request: "
            f"{ms / VOXEL_FIT_ITERS:.1f} ms a step, peak device memory "
            f"{peak / 2 ** 30:.3f} GiB, losses {losses.tolist()}")
        if not np.isfinite(losses).all() or not losses[-1] < losses[0]:
            raise AssertionError(f"fit_voxels ({kind}) losses {losses}")
        if not refined.locked:
            raise AssertionError("fit_voxels returned an unlocked field")
        del proto, refined
    del noisy

    with torch.no_grad():
        brick = sdf_query.build_corner_table(sdf)
        pair = sdf_query.build_corner_pair_table(sdf)
        lo = torch.tensor(-0.1 * sizes, dtype=torch.float32, device="cuda")
        span = torch.tensor(1.2 * sizes, dtype=torch.float32, device="cuda")
        pts = lo + span * torch.rand((PAIR_QUERY_POINTS, 3), generator=gen,
                                     device="cuda")
        qb = sdf_query.estimate_location_distance_fast(sdf, brick, pts)
        qp = sdf_query.estimate_location_distance_fast(sdf, pair, pts)
        if not torch.equal(qb.valid, qp.valid) or not torch.equal(
                qb.value.view(torch.int32), qp.value.view(torch.int32)):
            raise AssertionError("pair-table queries differ from brick-table "
                                 "queries")
        brick_ms = cuda_ms(lambda: sdf_query.estimate_location_distance_fast(
            sdf, brick, pts), 5)
        pair_ms = cuda_ms(lambda: sdf_query.estimate_location_distance_fast(
            sdf, pair, pts), 5)
    log(f"pair table {GRID_N}^3: {PAIR_QUERY_POINTS} random queries "
        f"({int(qb.valid.sum())} valid) bitwise equal to the brick table's; "
        f"query {pair_ms:.3f} ms (brick {brick_ms:.3f} ms); table "
        f"{pair.rows.numel() * 4 / 2 ** 30:.3f} GiB (brick "
        f"{brick.rows.numel() * 4 / 2 ** 30:.3f} GiB)")
    del brick, pair, pts, qb, qp, sdf
    log(f"phase_fits: {time.monotonic() - t_phase:.1f} s")


# -- The SDF's other consumers (mip, relax, batch, queries, extrema, f64) ----

# Query points of the queries step, and of its CPU comparison.
QUERY_POINTS = 1_000_000
CPU_QUERY_POINTS = 10_000
# Projections start in the shell up to this many voxels inside the sphere.
SHELL_VOXELS = 4.0
# tests/test_torch_sdf_gradients.py's tolerance for projected points.
PROJECTION_ATOL = 2e-5
# The extrema map's card-against-CPU grid, and the walk bound of its check.
EXTREMA_CPU_N = 128
CYCLE_WALK = 64
# The float64 SDF's combine is held against the CPU's on this crop.
F64_CROP = 64
# The mip factors of the mip step.
MIP_FACTORS = (8, 4)
# Relax factors (early exit), and the one on the shipped schedule.
RELAX_FACTORS = (1.3, 1.9)
RELAX_SCHEDULE = 1.6
# render_depth_batch's schedule (the JAX package's defaults, with the
# corner table and coarse_factor 8) and each view's own render_depth on it.
BATCH = dict(coarse_factor=8, cone_steps=32, cone_tail_chunks=8,
             tail_chunks=64)
BATCH_SINGLE = dict(early_exit=True, head_steps=0, **BATCH)


def _step(steps, name, fn, phase="queries"):
    """``fn()`` with its wall time and peak device memory logged and kept
    in ``steps``."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    ms = (time.monotonic() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    steps.append((name, ms, peak))
    log(f"{phase} step {name}: {ms:.1f} ms, peak device memory "
        f"{peak / 2 ** 30:.3f} GiB")
    return out


def batch_views(spec):
    """bench.py's camera and the same camera turned to look along +x, -x
    and -z through the grid centre, 1.2 grid sizes out (bench.py's camera
    itself looks along +z)."""
    from voxelized_geometry_tools_tpu_torch.ops import render

    sizes = np.asarray(spec.grid_sizes)
    center = sizes / 2.0
    poses = []
    for fwd in ((0.0, 0.0, 1.0), (1.0, 0.0, 0.0), (-1.0, 0.0, 0.0),
                (0.0, 0.0, -1.0)):
        fwd = np.asarray(fwd)
        if fwd[2] == 1.0:
            pose = np.eye(4, dtype=np.float32)
            pose[:3, 3] = center - 1.2 * sizes[2] * fwd
        else:
            pose = look_along(fwd, center - 1.2 * sizes[0] * fwd)
        poses.append(pose)
    return [render.PinholeCamera.create(p, IMG_W, IMG_H, focal=520.0,
                                        device="cuda") for p in poses]


def check_grazer_contract(base, got, resolution, flip_band, depth_tol,
                          what):
    """A skip or relaxed render against the plain early-exit render of the
    same frame, tests/test_fast_render.py's contracts (mip: hits equal,
    depths within 2 voxels; relax: flips within ``om * 0.2`` voxels of the
    threshold, depths within 2 thresholds): hit flips only where the
    hitting render's final query lies within ``flip_band`` of the
    threshold; common depths within ``depth_tol``. Excepted from the depth
    test, as in check_cone_equiv, are tangent grazers (either render's
    final query within GRAZER_BAND of the threshold), at most
    MAX_HIT_FLIPS of the pixels: another sample sequence may stop in
    another point of their sub-threshold sliver or miss it. The JAX
    package's mip and relaxed renders of this sphere do the same, on the
    same pixels as the port at 64^3 and 128^3
    (tests/test_torch_render_mip.py). Returns (hits lost, hits gained,
    largest common depth difference held, grazers past it, their largest
    difference)."""
    thresh = 0.25 * resolution
    flips = base.hit != got.hit
    hitter = torch.where(base.hit, base.distance, got.distance)
    bad = flips & ~((hitter - thresh).abs() <= flip_band)
    if bool(bad.any()):
        raise AssertionError(f"{what}: {int(bad.sum())} hit flips outside "
                             "the grazer band")
    m = base.hit & got.hit
    band = GRAZER_BAND * resolution
    graze = ((base.distance - thresh).abs() <= band) \
        | ((got.distance - thresh).abs() <= band)
    diff = (base.depth - got.depth).abs()
    past = m & (diff > depth_tol + 1e-6)
    if bool((past & ~graze).any()):
        raise AssertionError(f"{what}: depth differs by "
                             f"{float(diff[past & ~graze].max())} m")
    if float((past | flips).float().mean()) > MAX_HIT_FLIPS:
        raise AssertionError(f"{what}: {int(flips.sum())} flips and "
                             f"{int(past.sum())} grazers past the depth test")
    err = float(diff[m & ~past].max())
    past_err = float(diff[past].max()) if bool(past.any()) else 0.0
    return (int((base.hit & ~got.hit).sum()), int((got.hit & ~base.hit).sum()),
            err, int(past.sum()), past_err)


def _bitwise(a, b):
    """Equal bits, NaNs included (as int32 views of float32 tensors)."""
    a, b = a.contiguous(), b.contiguous()
    if a.dtype == torch.float64:
        return torch.equal(a.view(torch.int64), b.view(torch.int64))
    if a.dtype == torch.float32:
        return torch.equal(a.view(torch.int32), b.view(torch.int32))
    return torch.equal(a, b)


def queries_mip(steps, sdf, table, camera):
    from voxelized_geometry_tools_tpu_torch.ops import render

    half = 0.5 * sdf.resolution
    d = sdf.distances
    corrected = torch.where(d >= 0.0, d - half, d + half)
    with torch.no_grad():
        base, base_stats = render.render_depth(
            sdf, camera, num_steps=NUM_STEPS, corner_table=table,
            early_exit=True, with_stats=True)
    for f in MIP_FACTORS:
        mip = _step(steps, f"build_sdf_mip factor {f}",
                    lambda: render.build_sdf_mip(sdf, f))
        n = GRID_N // f
        vals = mip.values.reshape(n, 1, n, 1, n, 1)
        ok = bool((vals <= corrected.reshape(n, f, n, f, n, f)).all())
        if mip.coarse_counts != (n,) * 3 or not ok:
            raise AssertionError(f"mip factor {f}: an entry exceeds a "
                                 "corrected distance of its block")
        with torch.no_grad():
            res, stats = _step(
                steps, f"render mip factor {f}",
                lambda: render.render_depth(
                    sdf, camera, num_steps=NUM_STEPS, corner_table=table,
                    early_exit=True, mip=mip, with_stats=True))
        lost, gained, err, n_past, past_err = check_grazer_contract(
            base, res, sdf.resolution, GRAZER_BAND * sdf.resolution,
            2 * sdf.resolution, f"mip factor {f}")
        log(f"mip factor {f} ({n}^3 blocks): every entry <= every corrected "
            f"distance of its block; render against the plain early-exit "
            f"render: {lost} tangent-grazer hits lost, {gained} gained, max "
            f"common depth diff {err:.3e} m ({n_past} grazers past 2 voxels,"
            f" max {past_err:.3e} m); gather rows "
            f"{render.gather_rows_from_stats(stats):.0f} (plain "
            f"{render.gather_rows_from_stats(base_stats):.0f})")
    del corrected


def queries_relax(steps, sdf, table, camera):
    from voxelized_geometry_tools_tpu_torch.ops import render

    early = dict(num_steps=NUM_STEPS, corner_table=table, early_exit=True)
    sched = dict(num_steps=NUM_STEPS, corner_table=table, **SCHEDULE)
    cases = [(om, early) for om in RELAX_FACTORS] + [(RELAX_SCHEDULE, sched)]
    bases = {}
    for om, kw in cases:
        key = id(kw)
        with torch.no_grad():
            if key not in bases:
                bases[key] = _step(
                    steps, f"render relax=1 ({'schedule' if kw is sched else 'early exit'})",
                    lambda: render.render_depth(sdf, camera, with_stats=True,
                                                **kw))
            base, base_stats = bases[key]
            res, stats = _step(
                steps, f"render relax={om}",
                lambda: render.render_depth(sdf, camera, relax=om,
                                            with_stats=True, **kw))
        lost, gained, err, n_past, past_err = check_grazer_contract(
            base, res, sdf.resolution, om * 0.2 * sdf.resolution,
            0.5 * sdf.resolution, f"relax={om}")

        def iters(st):
            return (int(st["fine_head_iters"]),
                    int(_total_iters(st.get("fine_tail_iters"))))

        log(f"relax={om} ({'shipped schedule' if kw is sched else 'early exit'}"
            f"): {lost} grazer hits lost, {gained} gained, max common depth "
            f"diff {err:.3e} m ({n_past} grazers past 2 thresholds, max "
            f"{past_err:.3e} m); "
            f"gather rows {render.gather_rows_from_stats(stats):.0f} "
            f"(relax=1: {render.gather_rows_from_stats(base_stats):.0f}); "
            f"head / tail iterations {iters(stats)} (relax=1: "
            f"{iters(base_stats)})")


def _total_iters(x):
    return 0 if x is None else int(torch.as_tensor(x).sum())


def queries_batch(steps, sdf, table, spec):
    from voxelized_geometry_tools_tpu_torch.ops import render

    cams = batch_views(spec)
    rig = render.PinholeCamera.stack(cams)
    with torch.no_grad():
        batch = _step(steps, f"render_depth_batch of {len(cams)} views",
                      lambda: render.render_depth_batch(
                          sdf, rig, num_steps=NUM_STEPS, corner_table=table,
                          **BATCH))
        single_ms = []
        for i, cam in enumerate(cams):
            t0 = time.monotonic()
            single = render.render_depth(sdf, cam, num_steps=NUM_STEPS,
                                         corner_table=table, **BATCH_SINGLE)
            torch.cuda.synchronize()
            single_ms.append((time.monotonic() - t0) * 1e3)
            if not (_bitwise(batch.depth[i], single.depth)
                    and torch.equal(batch.hit[i], single.hit)):
                raise AssertionError(f"batch view {i} differs from its own "
                                     "render_depth")
    hits = [round(float(h.float().mean()), 6) for h in batch.hit]
    if not all(0.0 < h < 1.0 for h in hits):
        raise AssertionError(f"batch hit fractions {hits}")
    log(f"render_depth_batch {len(cams)} x {IMG_W}x{IMG_H}: each view's "
        f"depth and hit bitwise equal to its own render_depth; hit fractions "
        f"{hits}; per-view renders {[round(t, 1) for t in single_ms]} ms "
        f"({sum(single_ms):.1f} ms together)")
    return cams, batch


def queries_clouds(steps, sdf, table, spec, cams, batch):
    from voxelized_geometry_tools_tpu_torch.core import transforms
    from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
        OnlineMapper)
    from voxelized_geometry_tools_tpu_torch.ops import (
        render, sdf_query, voxelize)

    thresh = 0.25 * sdf.resolution
    clouds = []
    worst, graze_pts, n_pts = -float("inf"), 0, 0
    for i, cam in enumerate(cams):
        view = render.RenderResult(*(x[i] for x in batch))
        cloud = render.depth_to_pointcloud(view, cam)
        hit = view.hit.reshape(-1)
        world = transforms.apply_isometry(cam.pose, cloud.points[hit])
        q = sdf_query.estimate_location_distance(sdf, world)
        # The Newton refine moves a hit along its ray by its final sample:
        # at a tangent grazer (final sample within GRAZER_BAND of the
        # threshold) that leaves the point up to the hit test's 2
        # thresholds from the surface; every other hit point is within one.
        final = view.distance.reshape(-1)[hit]
        graze = (final - thresh).abs() <= GRAZER_BAND * sdf.resolution
        over = q.value > thresh
        if not bool(q.valid.all()) or bool((over & ~graze).any()) or not bool(
                (q.value.abs() <= 2 * thresh).all()):
            raise AssertionError(f"view {i}: a hit point's distance exceeds "
                                 f"{thresh} m (or a grazer's {2 * thresh} m)")
        if not bool(torch.isnan(cloud.points[~hit]).all()):
            raise AssertionError(f"view {i}: a missed ray's point is finite")
        worst = max(worst, float(q.value.abs().max()))
        graze_pts += int(over.sum())
        n_pts += int(hit.sum())
        clouds.append(cloud)
    log(f"depth_to_pointcloud: {n_pts} hit points, each within {thresh} m of "
        f"the surface but {graze_pts} tangent grazers within {2 * thresh} m "
        f"(largest |distance| {worst:.3e} m)")
    reset_launches()
    mapper = OnlineMapper(spec, frame="world", device="cuda")
    _step(steps, f"integrate_frames of {len(clouds)} rendered clouds",
          lambda: mapper.integrate_frames(clouds))
    counts = read_launches()
    if (counts["ray_setup"], counts["carve_tiled"],
            counts["fusion_filter"]) != (len(clouds),) * 3 \
            or sum(counts.values()) != 3 * len(clouds):
        raise AssertionError(f"integrate_frames launches {counts}")
    eye = mapper.occupancy_map.origin_transform
    tiled = voxelize.raycast_pointcloud(spec, eye, clouds[0])
    plain = voxelize.raycast_pointcloud(spec, eye, clouds[0],
                                        backend="plain")
    if not grids_equal(tiled, plain):
        raise AssertionError("the tiled carve of the first rendered cloud "
                             "differs from the plain walk")
    del tiled, plain
    reset_launches()
    with torch.no_grad():
        resdf = _step(steps, "re-carved mapper sdf()", mapper.sdf)
    counts = read_launches()
    if (counts["edt_bestfirst_staged"], counts["edt_combine"]) != (2, 1) \
            or sum(counts.values()) != 4:
        raise AssertionError(f"the re-carved SDF's launches {counts}")
    occ = mapper.occupancy_map.occupancy
    filled = occ > 0.5
    near = float((sdf.distances[filled].abs() <= 2 * sdf.resolution)
                 .float().mean())
    if not int(filled.sum()) or not near > 0.5:
        raise AssertionError(f"re-carved filled voxels: {int(filled.sum())},"
                             f" share near the surface {near}")
    log(f"re-carve: {int(filled.sum())} filled voxels, share within 2 voxels "
        f"of the sphere's surface {near:.6f}; carve_tiled of the first "
        f"cloud bitwise equal to the plain walk; sdf() finite "
        f"{bool(torch.isfinite(resdf.distances).all())}")
    del mapper, resdf, occ, filled
    with torch.no_grad():
        img = _step(steps, "render_occupancy_image (one view)",
                    lambda: render.render_occupancy_image(
                        sdf, cams[0], num_steps=NUM_STEPS,
                        corner_table=table))
    if not (0.0 < float(img.mean()) < 1.0) or not bool(
            torch.isfinite(img).all()):
        raise AssertionError("render_occupancy_image")
    log(f"render_occupancy_image: mean {float(img.mean()):.6f}")


def shell_points(count, gen):
    """Points in the shell up to SHELL_VOXELS voxels inside the sphere."""
    c = GRID_N / 2.0 * RESOLUTION
    r_out = GRID_N / 4.0 * RESOLUTION
    dirs = torch.randn((count, 3), generator=gen, device="cuda")
    dirs = dirs / dirs.norm(dim=-1, keepdim=True)
    r = r_out - SHELL_VOXELS * RESOLUTION * torch.rand(
        (count,), generator=gen, device="cuda")
    return c + dirs * r[:, None]


def queries_points(steps, sdf):
    from voxelized_geometry_tools_tpu_torch.ops import sdf_query

    gen = torch.Generator(device="cuda").manual_seed(1)
    sizes = torch.tensor(sdf.spec.grid_sizes, device="cuda")
    pts = (-0.05 + 1.1 * torch.rand((QUERY_POINTS, 3), generator=gen,
                                    device="cuda")) * sizes
    idx = torch.randint(-2, GRID_N + 2, (QUERY_POINTS, 3), generator=gen,
                        device="cuda", dtype=torch.int32)
    inside = shell_points(QUERY_POINTS, gen)
    calls = {
        "estimate_index_distance":
            lambda s, p, i, q: sdf_query.estimate_index_distance(s, i),
        "coarse gradient":
            lambda s, p, i, q: sdf_query.get_location_coarse_gradient(s, p),
        "coarse gradient, edges":
            lambda s, p, i, q: sdf_query.get_location_coarse_gradient(
                s, p, enable_edge_gradients=True),
        "fine gradient, 1 voxel":
            lambda s, p, i, q: sdf_query.get_location_fine_gradient(
                s, p, RESOLUTION),
        "project_out_of_collision":
            lambda s, p, i, q: sdf_query.project_out_of_collision(s, q),
    }
    with torch.no_grad():
        out = {name: _step(steps, f"{name}, {QUERY_POINTS} points",
                           lambda fn=fn: fn(sdf, pts, idx, inside))
               for name, fn in calls.items()}
    proj = out["project_out_of_collision"]
    d = sdf_query.estimate_location_distance(sdf, proj.position[proj.valid])
    if not bool((d.value > 0.0).all()) or not float(
            proj.valid.float().mean()) > 0.99:
        raise AssertionError("a valid projected point is not out of "
                             "collision, or under 99 % are valid")
    cpu = sdf.replace(distances=sdf.distances.cpu(),
                      origin_transform=sdf.origin_transform.cpu(),
                      minimum=sdf.minimum.cpu(), maximum=sdf.maximum.cpu())
    m = CPU_QUERY_POINTS
    report = []
    for name, fn in calls.items():
        ref = fn(cpu, pts[:m].cpu(), idx[:m].cpu(), inside[:m].cpu())
        got = tuple(x[:m].cpu() for x in out[name])
        if not torch.equal(got[1], ref[1]):
            raise AssertionError(f"{name}: valid differs from the CPU's")
        both = ref[1]
        diff = (got[0][both] - ref[0][both]).abs()
        err = float(diff.max()) if diff.numel() else 0.0
        if name == "project_out_of_collision":
            if err > PROJECTION_ATOL:
                raise AssertionError(f"{name}: {err} m from the CPU's")
        elif not (_bitwise(got[0][both], ref[0][both])
                  and bool(torch.isnan(got[0][~both]).all())):
            raise AssertionError(f"{name}: not bitwise equal to the CPU's")
        report.append(f"{name} {err:.3e}")
    log(f"queries, {QUERY_POINTS} points: valid projections "
        f"{float(proj.valid.float().mean()):.6f}, every valid projected point "
        f"at distance > 0; largest difference from the CPU on {m} points: "
        f"{'; '.join(report)} (bitwise but the projection, held to "
        f"{PROJECTION_ATOL})")


def extrema_targets_ok(sdf, extrema):
    """Every finite target is the centre of an effectively flat cell or of a
    cell whose walk returns to it within CYCLE_WALK steps (a cycle)."""
    from voxelized_geometry_tools_tpu_torch.ops import sdf_query

    spec = sdf.spec
    e = extrema.reshape(-1, 3)
    finite = torch.isfinite(e).all(dim=-1)
    cells = torch.unique(spec.flat_index(
        spec.location_in_grid_frame_to_grid_index(e[finite]).long()))
    idx = spec.unflatten_index(cells)
    grad = sdf_query.get_index_coarse_gradient(sdf, idx, True)
    flat = sdf_query._gradient_is_effectively_flat(grad.gradient,
                                                   spec.resolution)
    cur, back = idx, torch.zeros_like(flat)
    for _ in range(CYCLE_WALK):
        g = sdf_query.get_index_coarse_gradient(sdf, cur, True)
        nxt = sdf_query._next_from_gradient(sdf, cur, g.gradient)
        cur = torch.where(spec.check_grid_index_in_bounds(nxt)[..., None],
                          nxt, cur)
        back |= (cur == idx).all(dim=-1)
    if not bool((flat | back).all()):
        raise AssertionError("an extremum is neither flat nor on a cycle")
    return int(cells.numel()), int(flat.sum()), int((back & ~flat).sum()), \
        int((~finite).sum())


def queries_extrema(steps, sdf):
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.ops import edt, sdf_query

    spec = GridSpec.from_voxel_counts(RESOLUTION * GRID_N / EXTREMA_CPU_N,
                                      (EXTREMA_CPU_N,) * 3)
    small = edt.extract_signed_distance_field(
        sphere_mask(EXTREMA_CPU_N, "cuda"), spec, None)
    got = _step(steps, f"compute_local_extrema_map {EXTREMA_CPU_N}^3",
                lambda: sdf_query.compute_local_extrema_map(small))
    cpu = small.replace(distances=small.distances.cpu(),
                        origin_transform=small.origin_transform.cpu())
    t0 = time.monotonic()
    ref = sdf_query.compute_local_extrema_map(cpu)
    cpu_ms = (time.monotonic() - t0) * 1e3
    if not _bitwise(got.cpu(), ref):
        raise AssertionError(f"the {EXTREMA_CPU_N}^3 extrema map differs "
                             "from the CPU's")
    del small, got, ref
    n = GRID_N ** 3
    rounds = int(np.ceil(np.log2(n))) + 2
    extrema = _step(steps, f"compute_local_extrema_map {GRID_N}^3 "
                           f"({rounds} jump rounds)",
                    lambda: sdf_query.compute_local_extrema_map(sdf))
    if tuple(extrema.shape) != (GRID_N,) * 3 + (3,):
        raise AssertionError(f"extrema shape {tuple(extrema.shape)}")
    targets, flat, cycles, escapes = extrema_targets_ok(sdf, extrema)
    log(f"extrema map: {EXTREMA_CPU_N}^3 bitwise equal to the CPU's (CPU "
        f"{cpu_ms:.1f} ms); {GRID_N}^3: {escapes} cells leave the grid, "
        f"{targets} distinct finite targets ({flat} flat cells, {cycles} "
        f"cycle members), each checked")


def queries_f64(steps, mask, sdf):
    from voxelized_geometry_tools_tpu_torch.ops import edt, sdf_query

    res = sdf.resolution
    with torch.no_grad():
        sdf64 = _step(steps, f"float64 EDT {GRID_N}^3",
                      lambda: edt.extract_signed_distance_field(
                          mask, sdf.spec, None, dtype=torch.float64))
    d64 = sdf64.distances
    if d64.dtype != torch.float64:
        raise AssertionError(f"float64 SDF holds {d64.dtype}")
    # Each field is its rounded sqrt times its own rounded resolution:
    # divided by that, it squares to within 0.05 of its integer here (the
    # largest is about 315^2).
    sq64 = torch.round((d64 / res) ** 2)
    sq32 = torch.round((sdf.distances.double() / float(np.float32(res))) ** 2)
    if not torch.equal(sq64, sq32):
        raise AssertionError("float64 and float32 SDFs' squared integer "
                             "distances differ")
    c = GRID_N // 2 - F64_CROP // 2
    crop = (slice(c, c + F64_CROP),) * 3
    d2 = sq64[crop].cpu()
    neg = d64[crop].cpu() < 0
    zero = torch.zeros_like(d2)
    res64 = torch.tensor(res, dtype=torch.float64)
    ref = (edt._sqrt(torch.where(neg, zero, d2), torch.float64) * res64
           - edt._sqrt(torch.where(neg, d2, zero), torch.float64) * res64)
    if not _bitwise(d64[crop].cpu().contiguous(), ref):
        raise AssertionError("the float64 combine differs from the CPU's")
    del sq64, sq32
    gen = torch.Generator(device="cuda").manual_seed(2)
    sizes = torch.tensor(sdf.spec.grid_sizes, device="cuda")
    pts = (-0.05 + 1.1 * torch.rand((QUERY_POINTS, 3), generator=gen,
                                    device="cuda")) * sizes
    idx = torch.randint(0, GRID_N, (QUERY_POINTS, 3), generator=gen,
                        device="cuda", dtype=torch.int32)
    eps32 = float(np.finfo(np.float32).eps)
    dmax = float(sdf.distances.abs().max())
    with torch.no_grad():
        q64 = _step(steps, f"float64 queries, {QUERY_POINTS} points",
                    lambda: sdf_query.estimate_location_distance(sdf64, pts))
        g64 = _step(steps, f"float64 coarse gradients, {QUERY_POINTS} points",
                    lambda: sdf_query.get_location_coarse_gradient(
                        sdf64, pts, True))
        q32 = sdf_query.estimate_location_distance(sdf, pts)
        # A point within float32 rounding of a cell face may take the
        # neighbouring cell in one type: gradients are held cell by cell.
        gi64 = sdf_query.get_index_coarse_gradient(sdf64, idx, True)
        gi32 = sdf_query.get_index_coarse_gradient(sdf, idx, True)
        moved = (sdf64.location_to_grid_index(pts)
                 != sdf.location_to_grid_index(pts)).any(dim=-1)
    if q64.value.dtype != torch.float64 or g64.gradient.dtype != torch.float64 \
            or gi64.gradient.dtype != torch.float64:
        raise AssertionError("float64 queries or gradients lost float64")
    if not torch.equal(q64.valid, q32.valid) or not torch.equal(
            gi64.valid, gi32.valid):
        raise AssertionError("float64 validity differs from float32's")
    qerr = float((q64.value - q32.value.double())[q64.valid].abs().max())
    gerr = float((gi64.gradient - gi32.gradient.double())[gi64.valid]
                 .abs().max())
    qtol, gtol = 8 * eps32 * dmax, 8 * eps32 * dmax / res
    if qerr > qtol or gerr > gtol:
        raise AssertionError(f"float64 against float32: queries {qerr} "
                             f"(limit {qtol}), gradients {gerr} (limit {gtol})")
    log(f"float64 {GRID_N}^3: squared integer distances equal the float32 "
        f"SDF's; combine bitwise equal to the CPU's on a {F64_CROP}^3 crop; "
        f"{QUERY_POINTS} queries / gradients float64, within {qerr:.3e} / "
        f"{gerr:.3e} of float32 (limits {qtol:.3e} / {gtol:.3e}; gradients "
        f"at the same cells; {int(moved.sum())} of the points fall in "
        f"another cell in float64)")


def phase_queries():
    """The SDF's other consumers at full width on bench.py's 512^3 sphere
    (its SDF from the staged EDT kernel, the 4 GiB corner table, bench.py's
    640x480 camera, 64 steps): the mip at factors 8 and 4 (the lower-bound
    property on the whole grid; mip renders hit as the plain early-exit
    render, depths within 2 voxels); relaxed renders at 1.3, 1.9 and 1.6 on
    the shipped schedule (tests/test_fast_render.py's relax contract, with
    their counters beside relax=1's); render_depth_batch of four views,
    each bitwise equal to its own render_depth; the views back to clouds
    (hit points within the threshold), integrated into a fresh 512^3
    OnlineMapper (tiled carve bitwise against the plain walk, its SDF
    through the EDT kernel), render_occupancy_image; 10^6-point index
    queries, coarse and fine gradients and projections out of the 4-voxel
    shell (10^4 against the CPU: bitwise, the projection within
    PROJECTION_ATOL); the extrema map at 128^3 (bitwise against the CPU)
    and 512^3 (every finite target checked); the float64 SDF. Logs each
    step's wall time and peak device memory."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query

    t_phase = time.monotonic()
    steps = []
    spec = GridSpec.from_voxel_counts(RESOLUTION, (GRID_N,) * 3)
    mask = sphere_mask(GRID_N, "cuda")
    reset_launches()
    with torch.no_grad():
        sdf = _step(steps, f"EDT {GRID_N}^3", lambda: (
            edt.extract_signed_distance_field(mask, spec, None,
                                              frame="bench")))
    counts = read_launches()
    if (counts["edt_bestfirst_staged"], counts["edt_combine"]) != (2, 1) \
            or sum(counts.values()) != 4:
        raise AssertionError(f"the queries' SDF launches: {counts}")
    with torch.no_grad():
        table = _step(steps, "corner table",
                      lambda: sdf_query.build_corner_table(sdf))
    camera = batch_views(spec)[0]
    queries_mip(steps, sdf, table, camera)
    queries_relax(steps, sdf, table, camera)
    cams, batch = queries_batch(steps, sdf, table, spec)
    queries_clouds(steps, sdf, table, spec, cams, batch)
    del table, batch
    queries_points(steps, sdf)
    queries_extrema(steps, sdf)
    queries_f64(steps, mask, sdf)
    total = time.monotonic() - t_phase
    log(f"phase_queries: {total:.1f} s; steps (ms, peak GiB): "
        + "; ".join(f"{n} {ms:.1f} {p / 2 ** 30:.3f}" for n, ms, p in steps))

# phase_api: the seeded points (a tenth of them on cell faces) over the
# grid and a margin of API_MARGIN voxels, and the shell width of its label
# field and of its unknown band (voxels).
API_POINTS = 1_000_000
API_SEED = 16
API_MARGIN = 8
API_SHELL_VOXELS = 8


def api_points(spec, origin):
    """``API_POINTS`` float32 world points drawn in the grid frame of
    ``spec`` under ``origin`` (numpy ``[4, 4]``) from ``API_SEED``."""
    rng = np.random.default_rng(API_SEED)
    counts = np.asarray(spec.counts)
    p_grid = rng.uniform(-API_MARGIN, counts + API_MARGIN, (API_POINTS, 3))
    faces = API_POINTS // 10
    p_grid[:faces] = rng.integers(-API_MARGIN, counts + API_MARGIN,
                                  (faces, 3))
    o = origin.astype(np.float64)
    p_world = (p_grid * spec.resolution) @ o[:3, :3].T + o[:3, 3]
    return torch.from_numpy(p_world.astype(np.float32))


def sphere_distances(n, resolution, device):
    """bench.py's sphere (radius n/4 voxels about n/2) as an analytic
    float32 distance field, negative inside."""
    ax = (torch.arange(n, device=device, dtype=torch.float32) - n / 2.0) ** 2
    r2 = ax[:, None, None] + ax[None, :, None] + ax[None, None, :]
    return (torch.sqrt(r2) - n / 4.0) * resolution


def phase_api():
    """The grid helpers (``GridSpec.with_counts``; the module functions
    ``location_to_grid_index`` and ``check_location_in_bounds``) and the
    callables that tests/test_torch_api_coverage.py holds against the JAX
    package, on bench.py's 512^3 spec under phase_rotated_carve's rotated
    origin: 10^6 seeded points through both module functions and
    ``estimate_distance_interpolate`` over bench.py's sphere as an analytic
    distance field; ``face_adjacency_from_key`` on a 512^3 int32 field of
    distance shells; ``filled_mask_from_occupancy`` (either
    ``unknown_is_filled``) and ``merge_free_and_named_object_sdfs`` at
    512^3; the sphere's isosurface rasterized with
    ``rasterize_mesh_into_channel`` into a 512^3 channel. Each result is
    held bitwise against the same call on CPU copies of its inputs (the
    CPU tests hold each bitwise against the JAX package), the module
    functions also against the map method on the card. Launches no
    hand-written kernel. Logs each step's time and the phase's peak
    device memory beside the card's name and power limit."""
    from voxelized_geometry_tools_tpu_torch import (
        GridSpec, SignedDistanceField, __version__)
    from voxelized_geometry_tools_tpu_torch.core import grid, transforms
    from voxelized_geometry_tools_tpu_torch.ops import (
        edt, isosurface, mesh, sdf_query, topology)

    card = card_name_and_limit()
    log(f"voxelized_geometry_tools_tpu_torch.__version__: {__version__}")
    t_phase = time.monotonic()
    reset_launches()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    steps = []

    def step(name, fn):
        out, ms = _timed(fn)
        steps.append((name, ms))
        return out

    def check(name, got, ref):
        """``got`` (on the card) bitwise against ``ref``."""
        if got.dtype != ref.dtype or got.shape != ref.shape:
            raise AssertionError(f"phase_api: {name}: {got.dtype} "
                                 f"{tuple(got.shape)} against {ref.dtype} "
                                 f"{tuple(ref.shape)}")
        _same_bits(got, ref.cpu(), f"phase_api: {name}")

    spec = GridSpec.from_voxel_counts(RESOLUTION, (GRID_N,) * 3)
    part = spec.with_counts((GRID_N // 2, GRID_N, GRID_N // 4))
    if (part.counts != (GRID_N // 2, GRID_N, GRID_N // 4)
            or part.voxel_sizes != spec.voxel_sizes
            or part.resolution != spec.resolution):
        raise AssertionError(f"with_counts: {part}")
    origin_np = rotated_pipeline_origin()
    origin_cpu = torch.from_numpy(origin_np)
    origin = origin_cpu.cuda()
    inv, inv_cpu = (transforms.invert_isometry(origin),
                    transforms.invert_isometry(origin_cpu))
    check("invert_isometry", inv, inv_cpu)
    pts_cpu = api_points(spec, origin_np)
    pts = pts_cpu.cuda()

    idx = step("location_to_grid_index",
               lambda: grid.location_to_grid_index(spec, inv, pts))
    inside = step("check_location_in_bounds",
                  lambda: grid.check_location_in_bounds(spec, inv, pts))
    check("location_to_grid_index", idx,
          grid.location_to_grid_index(spec, inv_cpu, pts_cpu))
    check("check_location_in_bounds", inside,
          grid.check_location_in_bounds(spec, inv_cpu, pts_cpu))
    from_numpy = grid.location_to_grid_index(spec, inv, pts_cpu.numpy())
    if from_numpy.device.type != "cuda":
        raise AssertionError("location_to_grid_index put numpy points on "
                             f"{from_numpy.device}, not the card")
    check("location_to_grid_index of numpy points", from_numpy, idx)
    in_share = float(inside.float().mean())
    if not 0.5 < in_share < 1.0:
        raise AssertionError(f"in-bounds share {in_share}")

    dist = step(f"sphere distance field {GRID_N}^3",
                lambda: sphere_distances(GRID_N, RESOLUTION, "cuda"))
    sdf = SignedDistanceField.create(spec, dist, origin, frame="api")
    sdf_cpu = SignedDistanceField.create(spec, dist.cpu(), origin_cpu,
                                         frame="api")
    check("the map's inverse origin transform",
          sdf.inverse_origin_transform(), inv)
    check("the map method location_to_grid_index",
          sdf.location_to_grid_index(pts), idx)
    safe = torch.clamp(idx, 0, GRID_N - 1)
    est = step("estimate_distance_interpolate",
               lambda: sdf_query.estimate_distance_interpolate(
                   sdf, pts, safe))
    check("estimate_distance_interpolate", est,
          sdf_query.estimate_distance_interpolate(sdf_cpu, pts_cpu,
                                                  safe.cpu()))
    if not bool(torch.isfinite(est).all()):
        raise AssertionError("estimate_distance_interpolate: non-finite "
                             "values on clamped indices")

    key = torch.floor(dist / (API_SHELL_VOXELS * RESOLUTION)).to(torch.int32)
    adj = step("face_adjacency_from_key",
               lambda: topology.face_adjacency_from_key(key))
    for axis, got, ref in zip("xyz", adj, topology.face_adjacency_from_key(
            key.cpu())):
        check(f"face_adjacency_from_key, {axis}", got, ref)
    del key, adj

    band = API_SHELL_VOXELS * RESOLUTION
    occ = torch.where(dist < 0.0, 1.0, torch.where(dist < band, 0.5, 0.0))
    occ_cpu = occ.cpu()
    for unknown in (True, False):
        filled = step(f"filled_mask_from_occupancy unknown_is_filled="
                      f"{unknown}", lambda: edt.filled_mask_from_occupancy(
                          occ, unknown))
        check(f"filled_mask_from_occupancy({unknown})", filled,
              edt.filled_mask_from_occupancy(occ_cpu, unknown))
        del filled
    del occ, occ_cpu

    named = -torch.flip(dist, (0,))
    merged = step("merge_free_and_named_object_sdfs",
                  lambda: edt.merge_free_and_named_object_sdfs(dist, named))
    check("merge_free_and_named_object_sdfs", merged,
          edt.merge_free_and_named_object_sdfs(sdf_cpu.distances,
                                               named.cpu()))
    del named, merged

    iso = step("extract_isosurface", lambda: isosurface.extract_isosurface(
        sdf, max_triangles=GEOMETRY_CAP))
    if bool(iso.overflowed):
        raise AssertionError(f"isosurface overflowed: {int(iso.num_triangles)}")
    verts = iso.vertices[iso.valid].reshape(-1, 3)
    tris = torch.arange(verts.shape[0], device="cuda").reshape(-1, 3)
    del iso
    channel = step(f"rasterize_mesh_into_channel, {tris.shape[0]} "
                   "triangles", lambda: mesh.rasterize_mesh_into_channel(
                       spec, origin, torch.zeros(spec.counts, device="cuda"),
                       verts, tris))
    check("rasterize_mesh_into_channel", channel,
          mesh.rasterize_mesh_into_channel(
              spec, origin_cpu, torch.zeros(spec.counts), verts.cpu(),
              tris.cpu()))
    n_filled = int((channel == 1.0).sum())
    if n_filled == 0:
        raise AssertionError("the rasterized isosurface filled no cell")
    del channel, verts, tris, sdf, dist

    counts = read_launches()
    if any(counts.values()):
        raise AssertionError(f"phase_api launched kernels: {counts}")
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    log(f"phase_api ({card}): {time.monotonic() - t_phase:.1f} s; "
        f"{in_share:.4f} of {API_POINTS} points in bounds, {n_filled} cells "
        "rasterized; every result bitwise equal to the CPU's; steps (ms): "
        + "; ".join(f"{n} {ms:.2f}" for n, ms in steps)
        + f"; peak device memory {peak / 2 ** 30:.3f} GiB "
        f"({held / 2 ** 30:.3f} GiB held before the phase)")


# phase_geometry: the isosurface cap at 512^3 (a 128-voxel sphere gives
# 1,846,704 triangles, the clutter's slab 2,088,968), the torus and the
# hollow cube (in voxels), the spatial-segment threshold (voxels), the
# card-against-CPU size, the DSH chunk and lookups, the viz size.
GEOMETRY_CAP = 1 << 22
# The mapper's mesh: its SDF counts unknown cells as filled, so the ragged
# walls of the four carved cones are surface too (about 2.9 * 10^7
# triangles; 1.2 GB of vertices at this cap).
MAPPER_CAP = 1 << 25
TORUS_RADII = (160, 48)
SHELL_VOXELS = 8
SEGMENT_VOXELS = 3.0
GEOMETRY_CPU_N = 128
DSH_CHUNK = 64
DSH_LOOKUPS = 1_000_000
VIZ_N = 256
MAPPER_VERTEX_VOXELS = 2


def _gstep(steps, name, fn):
    return _step(steps, name, fn, phase="geometry")


def _counted(steps, name, fn, expect):
    """``_gstep`` with the kernels' launches counted; raises unless they
    are ``expect`` (``{kernel: count}``, every other kernel 0). Returns the
    result and the counts."""
    reset_launches()
    out = _gstep(steps, name, fn)
    counts = read_launches()
    want = {k: expect.get(k, 0) for k in counts}
    if counts != want:
        raise AssertionError(f"{name}: launches {counts}, expected {want}")
    return out, counts


def _add_launches(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def torus_mask(n, device, major, minor):
    """A torus about the z axis through the grid centre (radii in voxels)."""
    ax = torch.arange(n, device=device, dtype=torch.float32) - n / 2.0
    rxy = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2)
    return (rxy - major) ** 2 + ax[None, None, :] ** 2 <= minor * minor


def hollow_cube_mask(n, device, shell):
    """A cube over the middle half of the grid with walls ``shell`` voxels
    thick and an empty inside."""
    mask = torch.zeros((n, n, n), dtype=torch.bool, device=device)
    lo, hi = n // 4, 3 * n // 4
    mask[lo:hi, lo:hi, lo:hi] = True
    mask[lo + shell:hi - shell, lo + shell:hi - shell,
         lo + shell:hi - shell] = False
    return mask


def _to_cpu(m):
    """A map or SDF with every tensor field moved to the CPU."""
    return m.replace(**{f.name: getattr(m, f.name).cpu()
                        for f in dataclasses.fields(m)
                        if isinstance(getattr(m, f.name), torch.Tensor)})


def _component_map(spec, mask, device):
    from voxelized_geometry_tools_tpu_torch import OccupancyComponentMap
    return OccupancyComponentMap.create(spec, device=device).set_occupancy(
        mask.float())


def _tagged_map(spec, mask, device):
    """The mask's filled components tagged each with its own object id (its
    component label), as a TaggedObjectOccupancyComponentMap; with the
    untagged labels."""
    from voxelized_geometry_tools_tpu_torch import (
        TaggedObjectOccupancyComponentMap)
    from voxelized_geometry_tools_tpu_torch.ops import topology

    occ = mask.float()
    comp, _ = topology.connected_components_by_occupancy(occ)
    bits = comp.view(torch.int32)
    oid = torch.where(mask, bits, torch.zeros_like(bits)).view(torch.uint32)
    omap = TaggedObjectOccupancyComponentMap.create(
        spec, device=device).replace(occupancy=occ, object_id=oid)
    return omap, comp


def _sphere_radii(iso, center, radius):
    v = iso.vertices[iso.valid].reshape(-1, 3).double()
    return (torch.linalg.vector_norm(v - center, dim=-1) - radius).abs()


def _euler(faces):
    """(V - E + F over the used vertices, every edge in exactly 2 faces)."""
    e = np.concatenate([faces[:, (0, 1)], faces[:, (1, 2)],
                        faces[:, (2, 0)]])
    e.sort(axis=1)
    _, cnt = np.unique(e, axis=0, return_counts=True)
    n_vert = len(np.unique(faces))
    return n_vert - len(cnt) + len(faces), bool((cnt == 2).all())


def geometry_sphere(steps, spec, launches):
    """The 512^3 sphere: SDF (2 staged launches), isosurface, radii, weld,
    OBJ, statistics, and the welded mesh rasterized back; the analytic
    sphere field for tests/test_isosurface.py's radius and statistics
    bounds."""
    import tempfile
    from voxelized_geometry_tools_tpu_torch.ops import (
        isosurface, map_ops, mesh)

    n, res = spec.counts[0], spec.resolution
    omap = _component_map(spec, sphere_mask(n, "cuda"), "cuda")
    with torch.no_grad():
        sdf, counts = _counted(
            steps, f"extract_signed_distance_field {n}^3",
            lambda: map_ops.extract_signed_distance_field(omap),
            {"edt_bestfirst_staged": 2, "edt_seed": 1, "edt_combine": 1})
    _add_launches(launches, counts)
    iso = _gstep(steps, f"extract_isosurface {n}^3 (cap {GEOMETRY_CAP})",
                 lambda: isosurface.extract_isosurface(
                     sdf, max_triangles=GEOMETRY_CAP, frame="grid"))
    n_tri = int(iso.num_triangles)
    if bool(iso.overflowed) or n_tri < 1000 or int(iso.valid.sum()) != n_tri:
        raise AssertionError(f"sphere isosurface: {n_tri} triangles, cap "
                             f"{GEOMETRY_CAP}")
    iso_ops, iso_busy = profile_frame(lambda: isosurface.extract_isosurface(
        sdf, max_triangles=GEOMETRY_CAP, frame="grid"))
    iso_idle = 1.0 - iso_busy / steps[-1][1]
    # The mask's sphere: radius n/4 about index n/2, cell centres at
    # (index + 0.5) * res. The EDT field of the voxelized mask puts its
    # level set on the mask's staircase, within a voxel of the sphere.
    center, radius = (n / 2.0 + 0.5) * res, n / 4.0 * res
    resid = _sphere_radii(iso, center, radius) / res
    edt_max, edt_mean = float(resid.max()), float(resid.mean())
    if edt_max > 1.0 or edt_mean > 0.25:
        raise AssertionError(f"EDT sphere vertex radii: max {edt_max}, mean "
                             f"{edt_mean} voxels off")
    verts, faces = _gstep(steps, f"weld_vertices ({n_tri} triangles)",
                          lambda: isosurface.weld_vertices(iso))
    chi, manifold = _euler(faces)
    if chi != 2 or not manifold:
        raise AssertionError(f"welded sphere: Euler characteristic {chi}, "
                             f"manifold {manifold}")
    with tempfile.TemporaryDirectory() as tmp:
        n_faces = _gstep(steps, "save_obj", lambda: isosurface.save_obj(
            f"{tmp}/sphere.obj", iso))
    if n_faces != len(faces):
        raise AssertionError(f"save_obj wrote {n_faces} faces of "
                             f"{len(faces)}")
    area, volume = _gstep(steps, "mesh_statistics",
                          lambda: isosurface.mesh_statistics(iso))
    sphere_area = 4.0 * np.pi * radius ** 2
    sphere_volume = 4.0 / 3.0 * np.pi * radius ** 3
    edt_area_err = area / sphere_area - 1.0
    edt_volume_err = volume / sphere_volume - 1.0
    if abs(edt_volume_err) > 0.05:
        raise AssertionError(f"EDT sphere volume off by {edt_volume_err}")
    fresh = _component_map(spec, torch.zeros((n,) * 3, dtype=torch.bool,
                                             device="cuda"), "cuda")
    occ = _gstep(steps, f"rasterize_mesh ({len(faces)} faces) into {n}^3",
                 lambda: mesh.rasterize_mesh(fresh, verts, faces).occupancy)
    filled = occ > 0.5
    n_filled = int(filled.sum())
    far = float(sdf.distances[filled].abs().max()) / res
    # Within one voxel of the surface: every filled cell has a cell of the
    # other class in its 26-neighbourhood (|SDF| <= sqrt(3) voxels). The
    # share of the cells face-adjacent to the other class (|SDF| = 1 voxel)
    # that are filled is logged: a triangle reaches only the cells of its
    # own AABB index range, as in the reference.
    adjacent = sdf.distances.abs() == sdf.distances.abs().amin()
    covered = float((filled & adjacent).sum()) / float(adjacent.sum())
    if far > np.sqrt(3.0) + 1e-6 or not n_filled:
        raise AssertionError(f"rasterized sphere: {n_filled} cells, |SDF| "
                             f"up to {far} voxels")
    del sdf, iso, occ, filled, fresh, verts, faces

    # The analytic sphere field of tests/test_isosurface.py at full size.
    ax = torch.arange(n, dtype=torch.float32, device="cuda") - (n - 1) / 2.0
    r = torch.sqrt(ax[:, None, None] ** 2 + ax[None, :, None] ** 2
                   + ax[None, None, :] ** 2)
    from voxelized_geometry_tools_tpu_torch import SignedDistanceField
    exact = SignedDistanceField.create(spec, (r - n / 4.0) * res,
                                       locked=True)
    del r
    iso = _gstep(steps, f"extract_isosurface {n}^3, analytic sphere",
                 lambda: isosurface.extract_isosurface(
                     exact, max_triangles=GEOMETRY_CAP, frame="grid"))
    if bool(iso.overflowed):
        raise AssertionError("analytic sphere isosurface overflowed")
    resid = _sphere_radii(iso, (n - 1) / 2.0 * res + 0.5 * res, radius) / res
    exact_max, exact_mean = float(resid.max()), float(resid.mean())
    area_x, volume_x = isosurface.mesh_statistics(iso)
    errs = (area_x / sphere_area - 1.0, volume_x / sphere_volume - 1.0)
    if exact_max >= 0.35 or exact_mean >= 0.1 or max(map(abs, errs)) > 0.05:
        raise AssertionError(f"analytic sphere: radii max {exact_max} mean "
                             f"{exact_mean} voxels, area/volume off {errs}")
    log(f"geometry sphere {n}^3 (radius {n // 4} voxels): {n_tri} triangles "
        f"({iso_ops} device operations, {iso_busy:.2f} ms of device time, "
        f"idle share {iso_idle:.3f} of the unprofiled call); EDT field: "
        f"vertex radii off by max {edt_max:.4f} / mean "
        f"{edt_mean:.4f} voxels, welded V-E+F = 2 and manifold, area "
        f"{edt_area_err:+.4f} and volume {edt_volume_err:+.4f} of the "
        f"sphere's (the mask's staircase), {n_filled} rasterized cells all "
        f"within |SDF| <= {far:.4f} voxels, covering {covered:.4f} of the "
        f"cells face-adjacent to the other class; analytic field: "
        f"{int(iso.num_triangles)} triangles, radii max {exact_max:.4f} / "
        f"mean {exact_mean:.4f} voxels, area {errs[0]:+.5f}, volume "
        f"{errs[1]:+.5f}")
    del iso, exact
    return omap


def _shape_topology(steps, name, omap, comp_at, expect):
    """Components, surfaces and topology of one component map; the filled
    component's (holes, voids) must be ``expect``."""
    from voxelized_geometry_tools_tpu_torch.ops import map_ops, topology

    omap = _gstep(steps, f"{name}: update_connected_components",
                  lambda: map_ops.update_connected_components(omap))
    rounds = topology.last_rounds["label_components"]
    cc_ops, cc_busy = profile_frame(
        lambda: topology.connected_components_by_occupancy(omap.occupancy))
    cc_idle = 1.0 - cc_busy / steps[-1][1]
    surf = _gstep(steps, f"{name}: is_surface_index",
                  lambda: map_ops.is_surface_index(omap))
    surfaces = _gstep(steps, f"{name}: extract_component_surfaces",
                      lambda: map_ops.extract_component_surfaces(
                          omap, topology.FILLED_COMPONENTS))
    types = topology.FILLED_COMPONENTS | topology.EMPTY_COMPONENTS
    _, result = _gstep(steps, f"{name}: compute_component_topology",
                       lambda: map_ops.compute_component_topology(omap,
                                                                  types))
    filled = int(omap.component.view(torch.int32)[comp_at])
    if result.get(filled) != expect or filled not in surfaces:
        raise AssertionError(f"{name}: component {filled} topology "
                             f"{result.get(filled)}, expected {expect}")
    log(f"geometry {name}: {int(omap.number_of_components.view(torch.int32))}"
        f" components ({rounds} propagation rounds, {cc_ops} device "
        f"operations, {cc_busy:.2f} ms of device time, idle share "
        f"{cc_idle:.3f}), {int(surf.sum())} "
        f"surface cells, {len(surfaces[filled])} surface cells of the filled "
        f"component, topology {dict(result)} (lifted CC "
        f"{topology.last_rounds['lifted']} rounds)")
    return omap


def geometry_components(steps, spec, sphere):
    """The sphere's, a torus's and a hollow cube's component maps; returns
    the sphere's."""
    n = spec.counts[0]
    mid = (n // 2,) * 3
    sphere = _shape_topology(steps, "sphere", sphere, mid, (0, 0))
    if int(sphere.number_of_components.view(torch.int32)) != 2:
        raise AssertionError("the sphere map has not 2 components")
    major, minor = TORUS_RADII
    _shape_topology(steps, "torus", _component_map(
        spec, torus_mask(n, "cuda", major, minor), "cuda"),
        (n // 2 + major, n // 2, n // 2), (1, 0))
    _shape_topology(steps, "hollow cube", _component_map(
        spec, hollow_cube_mask(n, "cuda", SHELL_VOXELS), "cuda"),
        (n // 4, n // 4, n // 4), (0, 1))
    return sphere


def geometry_clutter(steps, spec, launches):
    """bench.py's clutter at 512^3, each filled component its own object:
    tagged components, per-object SDFs (2 launches each), per-object
    meshes, spatial segments."""
    from voxelized_geometry_tools_tpu_torch.ops import isosurface, map_ops

    n, res = spec.counts[0], spec.resolution
    mask = clutter_mask(n, "cuda")
    omap, comp = _tagged_map(spec, mask, "cuda")
    ids = map_ops.object_ids_present(omap)
    k = len(ids)
    omap = _gstep(steps, "update_tagged_connected_components",
                  lambda: map_ops.update_tagged_connected_components(omap))
    if not torch.equal(omap.component.view(torch.int32),
                       comp.view(torch.int32)):
        raise AssertionError("tagged components differ from the untagged "
                             "ones on a map tagged by component")
    del comp
    with torch.no_grad():
        sdfs, counts = _counted(
            steps, f"make_all_object_sdfs ({k} objects)",
            lambda: map_ops.make_all_object_sdfs(omap),
            {"edt_bestfirst_staged": 2 * k, "edt_seed": k,
             "edt_combine": k})
    _add_launches(launches, counts)
    oid = omap.object_id.view(torch.int32)
    for i, sdf in sdfs.items():
        if not torch.equal(sdf.distances < 0, oid == i):
            raise AssertionError(f"object {i}'s SDF is not negative exactly "
                                 "on its cells")
    del sdfs
    with torch.no_grad():
        meshes, counts = _counted(
            steps, f"extract_object_meshes ({k} objects)",
            lambda: isosurface.extract_object_meshes(
                omap, max_triangles=GEOMETRY_CAP, frame="grid"),
            {"edt_bestfirst_staged": 2 * k, "edt_seed": k,
             "edt_combine": k})
    _add_launches(launches, counts)
    n_tris = {}
    for i, m in meshes.items():
        idx = torch.nonzero(oid == i)
        lo = (idx.amin(dim=0).double() - 1.0) * res
        hi = (idx.amax(dim=0).double() + 2.0) * res
        v = m.vertices[m.valid].reshape(-1, 3).double()
        if bool(m.overflowed) or not bool(((v >= lo) & (v <= hi)).all()):
            raise AssertionError(f"object {i}'s mesh overflowed or leaves its "
                                 "box")
        n_tris[i] = int(m.num_triangles)
    del meshes
    thresh = SEGMENT_VOXELS * res
    with torch.no_grad():
        seg, counts = _counted(
            steps, f"update_spatial_segments ({SEGMENT_VOXELS} voxels)",
            lambda: map_ops.update_spatial_segments(omap, thresh),
            {"edt_bestfirst_staged": 4, "edt_seed": 2, "edt_combine": 2})
    _add_launches(launches, counts)
    labels = seg.spatial_segment.view(torch.int32)
    num = int(seg.number_of_spatial_segments.view(torch.int32))
    # Each segment lies within one object: the (segment, object) pairs
    # name each nonzero segment once.
    pairs = torch.unique(labels.long() * (1 << 32) + oid.long())
    named = pairs[pairs >= (1 << 32)] >> 32
    if not num or int(labels.max()) != num or named.numel() != num:
        raise AssertionError(f"spatial segments: {num} segments, "
                             f"{named.numel()} (segment, object) pairs")
    log(f"geometry clutter {n}^3: {k} objects, triangles {n_tris}; "
        f"{num} spatial segments at {SEGMENT_VOXELS} voxels, each within one "
        f"object")


def _cpu_pair(fn, *args):
    """``fn`` on the card's arguments and on their CPU copies."""
    return fn(*args), fn(*(_to_cpu(a) if hasattr(a, "replace") else
                           a.cpu() if isinstance(a, torch.Tensor) else a
                           for a in args))


def _same_bits(a, b, what):
    if isinstance(a, dict):
        if sorted(a) != sorted(b):
            raise AssertionError(f"{what}: keys differ card/CPU")
        for key in a:
            _same_bits(a[key], b[key], f"{what}[{key}]")
        return
    if isinstance(a, torch.Tensor):
        a = a.cpu()
        if a.dtype == torch.uint32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        if not _bitwise(a.contiguous(), b.contiguous()):
            raise AssertionError(f"{what}: card and CPU differ")
    elif isinstance(a, np.ndarray):
        if not np.array_equal(a, b):
            raise AssertionError(f"{what}: card and CPU differ")
    elif a != b:
        raise AssertionError(f"{what}: card {a}, CPU {b}")


def geometry_against_cpu(steps):
    """The same scenes at GEOMETRY_CPU_N^3 on the card and the CPU: labels,
    surface masks, topology, spatial segments, isosurface and rasterized
    occupancy, bitwise."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.ops import (
        isosurface, map_ops, mesh, topology)

    n = GEOMETRY_CPU_N
    res = RESOLUTION * GRID_N / n
    spec = GridSpec.from_voxel_counts(res, (n,) * 3)
    scale = n / GRID_N
    types = topology.FILLED_COMPONENTS | topology.EMPTY_COMPONENTS
    t0 = time.monotonic()
    shapes = {
        "sphere": sphere_mask(n, "cuda"),
        "torus": torus_mask(n, "cuda", TORUS_RADII[0] * scale,
                            TORUS_RADII[1] * scale),
        "hollow cube": hollow_cube_mask(n, "cuda",
                                        max(2, int(SHELL_VOXELS * scale))),
    }
    for name, mask in shapes.items():
        card, cpu = _cpu_pair(map_ops.update_connected_components,
                              _component_map(spec, mask, "cuda"))
        _same_bits(card.component, cpu.component, f"{name} components")
        _same_bits(*_cpu_pair(map_ops.is_surface_index, card),
                   f"{name} surface mask")
        _same_bits(*_cpu_pair(lambda m: map_ops.extract_component_surfaces(
            m, types), card), f"{name} component surfaces")
        _same_bits(*_cpu_pair(lambda m: map_ops.compute_component_topology(
            m, types)[1], card), f"{name} holes and voids")
    omap, _ = _tagged_map(spec, clutter_mask(n, "cuda"), "cuda")
    seg, seg_cpu = _cpu_pair(lambda m: map_ops.update_spatial_segments(
        m, SEGMENT_VOXELS * res), omap)
    _same_bits(seg.spatial_segment, seg_cpu.spatial_segment,
               "spatial segments")
    sdf = map_ops.extract_signed_distance_field(
        _component_map(spec, shapes["sphere"], "cuda"))
    iso, iso_cpu = _cpu_pair(lambda s: isosurface.extract_isosurface(
        s, max_triangles=GEOMETRY_CAP // 16, frame="grid"), sdf)
    _same_bits(int(iso.num_triangles), int(iso_cpu.num_triangles),
               "isosurface count")
    _same_bits(iso.valid, iso_cpu.valid, "isosurface valid")
    vdiff = float((iso.vertices.cpu() - iso_cpu.vertices).abs().max())
    if vdiff > 2.0 ** -21 * n * res:
        raise AssertionError(f"isosurface vertices differ by {vdiff}")
    verts, faces = isosurface.weld_vertices(iso)
    fresh = _component_map(spec, torch.zeros_like(shapes["sphere"]), "cuda")
    occ, occ_cpu = _cpu_pair(lambda m: mesh.rasterize_mesh(
        m, verts, faces).occupancy, fresh)
    _same_bits(occ, occ_cpu, "rasterized occupancy")
    ms = (time.monotonic() - t0) * 1e3
    steps.append((f"card against CPU at {n}^3", ms, 0))
    n_seg = int(seg_cpu.number_of_spatial_segments.view(torch.int32))
    log(f"geometry card against CPU at {n}^3 ({ms:.1f} ms): components, "
        f"surface masks, component surfaces, holes and voids of the sphere, "
        f"torus and hollow cube, the clutter's {n_seg} spatial segments, "
        f"the sphere's {int(iso_cpu.num_triangles)} triangles (vertices "
        f"differ by {vdiff}) and {int((occ_cpu > 0.5).sum())} rasterized "
        f"cells: all bitwise equal")


def geometry_mapper(steps, launches):
    """The pipeline's four clouds into a fresh 512^3 OnlineMapper, then its
    mesh."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.models.online_mapper import (
        OnlineMapper)

    spec = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    clouds = pipeline_clouds("cuda")
    mapper = OnlineMapper(spec, frame="world", device="cuda")
    _, counts = _counted(steps, f"OnlineMapper.integrate_frames "
                                f"({len(clouds)} clouds)",
                         lambda: mapper.integrate_frames(clouds),
                         {"ray_setup": len(clouds),
                          "carve_tiled": len(clouds),
                          "fusion_filter": len(clouds)})
    _add_launches(launches, counts)
    with torch.no_grad():
        iso, counts = _counted(steps, "OnlineMapper.extract_mesh",
                               lambda: mapper.extract_mesh(
                                   max_triangles=MAPPER_CAP),
                               {"edt_bestfirst_staged": 2, "edt_seed": 1,
                                "edt_combine": 1})
    _add_launches(launches, counts)
    n_tri = int(iso.num_triangles)
    if bool(iso.overflowed) or n_tri == 0:
        raise AssertionError(f"mapper mesh: {n_tri} triangles, cap "
                             f"{MAPPER_CAP}")
    # The SDF counts filled and unknown cells as filled: each vertex lies
    # within MAPPER_VERTEX_VOXELS of such a cell.
    solid = (mapper.occupancy_map.occupancy >= 0.5).float()[None, None]
    k = 2 * MAPPER_VERTEX_VOXELS + 1
    near = torch.nn.functional.max_pool3d(solid, k, stride=1,
                                          padding=MAPPER_VERTEX_VOXELS)[0, 0]
    del solid
    v = iso.vertices[iso.valid].reshape(-1, 3)
    idx = torch.clamp(torch.floor(v / PIPE_RES).long(), 0, PIPE_N - 1)
    ok = near[idx[:, 0], idx[:, 1], idx[:, 2]] > 0
    if not bool(ok.all()):
        raise AssertionError(f"{int((~ok).sum())} mapper mesh vertices lie "
                             f"farther than {MAPPER_VERTEX_VOXELS} voxels "
                             "from a filled or unknown cell")
    log(f"geometry mapper {PIPE_N}^3: {len(clouds)} clouds, mesh of {n_tri} "
        f"triangles, every vertex within {MAPPER_VERTEX_VOXELS} voxels of a "
        f"filled or unknown cell")


def geometry_host(steps, sphere):
    """Serialization (512^3 uncompressed, 128^3 compressed), the DSH map
    of the clutter in 64^3 chunks with 10^6 packed lookups, the viz
    exporters at 256^3."""
    from voxelized_geometry_tools_tpu_torch import GridSpec, interop
    from voxelized_geometry_tools_tpu_torch.core import dsh, serialization
    from voxelized_geometry_tools_tpu_torch.io import viz
    from voxelized_geometry_tools_tpu_torch.ops import map_ops

    n = GRID_N
    blob = _gstep(steps, f"to_file_bytes {n}^3 component map",
                  lambda: serialization.to_file_bytes(sphere, compress=False))
    if blob != serialization.to_file_bytes(_to_cpu(sphere), compress=False):
        raise AssertionError("serialized bytes differ from the CPU map's")
    back = _gstep(steps, f"from_file_bytes {n}^3 component map",
                  lambda: serialization.from_file_bytes(blob, device="cuda"))
    _same_bits(back.component, sphere.component.cpu(), "reloaded components")
    _same_bits(back.occupancy, sphere.occupancy.cpu(), "reloaded occupancy")
    size = len(blob)
    del blob, back
    small_n = GEOMETRY_CPU_N
    small = map_ops.update_connected_components(_component_map(
        GridSpec.from_voxel_counts(RESOLUTION * n / small_n, (small_n,) * 3),
        sphere_mask(small_n, "cuda"), "cuda"))
    zblob = _gstep(steps, f"to_file_bytes {small_n}^3 compressed",
                   lambda: serialization.to_file_bytes(small))
    if zblob != serialization.to_file_bytes(_to_cpu(small)):
        raise AssertionError("compressed bytes differ from the CPU map's")
    _same_bits(serialization.from_file_bytes(zblob, device="cuda").component,
               small.component.cpu(), "reloaded compressed components")

    occ = clutter_mask(n, "cuda").float()
    c = DSH_CHUNK
    host = occ.cpu().numpy()
    chunks = []
    for i in range(0, n, c):
        for j in range(0, n, c):
            for k in range(0, n, c):
                block = host[i:i + c, j:j + c, k:k + c]
                if block.min() == block.max():
                    chunks.append(((i // c, j // c, k // c),
                                   dsh.FillStatus.CHUNK_FILLED,
                                   float(block[0, 0, 0]), None))
                else:
                    chunks.append(((i // c, j // c, k // c),
                                   dsh.FillStatus.CELL_FILLED, 0.0, block))
    dmap = interop.dsh_map_from_numpy(RESOLUTION, (c, c, c), chunks, 0.5,
                                      "clutter")
    packed = _gstep(steps, f"DSH pack ({len(chunks)} chunks of {c}^3)",
                    lambda: dmap.pack(device="cuda"))
    gen = torch.Generator(device="cuda").manual_seed(3)
    extent = n * RESOLUTION
    pts = (-0.1 + 1.2 * torch.rand((DSH_LOOKUPS, 3), generator=gen,
                                   device="cuda")) * extent
    values, status = _gstep(steps, f"packed_get_location, {DSH_LOOKUPS} "
                                   "points",
                            lambda: dsh.packed_get_location(packed, pts))
    cpu_values, cpu_status = dsh.packed_get_location(
        dmap.pack(device="cpu"), pts.cpu())
    _same_bits(values, cpu_values, "DSH lookups")
    _same_bits(status, cpu_status, "DSH lookup status")
    cell = torch.floor(pts / RESOLUTION).long()
    inside = ((cell >= 0) & (cell < n)).all(dim=-1)
    ci = cell[inside]
    if not torch.equal(values[inside], occ[ci[:, 0], ci[:, 1], ci[:, 2]]) \
            or not bool((status[inside] != 0).all()) \
            or bool((status[~inside] != 0).any()):
        raise AssertionError("DSH lookups disagree with the dense clutter")
    del occ, host, chunks, dmap, packed, pts, values, status

    vn = VIZ_N
    vspec = GridSpec.from_voxel_counts(RESOLUTION * n / vn, (vn,) * 3)
    vmap = map_ops.update_connected_components(_component_map(
        vspec, clutter_mask(vn, "cuda"), "cuda"))
    marker = _gstep(steps, f"export_occupancy_for_display {vn}^3",
                    lambda: viz.export_occupancy_for_display(vmap))
    if marker.num_cells != vn ** 3:
        raise AssertionError(f"occupancy marker has {marker.num_cells} cells")
    del marker
    cc = _gstep(steps, f"export_connected_components_for_display {vn}^3",
                lambda: viz.export_connected_components_for_display(vmap))
    surf = _gstep(steps, f"export_classified_surfaces_for_display {vn}^3",
                  lambda: viz.export_classified_surfaces_for_display(vmap))
    vsdf = map_ops.extract_signed_distance_field(vmap)
    sdf_marker = _gstep(steps, f"export_sdf_for_display {vn}^3",
                        lambda: viz.export_sdf_for_display(vsdf))
    if cc.num_cells != vn ** 3 or not 0 < surf.num_cells < vn ** 3 \
            or sdf_marker.num_cells != vn ** 3:
        raise AssertionError(f"viz markers: {cc.num_cells}, "
                             f"{surf.num_cells}, {sdf_marker.num_cells}")
    log(f"geometry host: {n}^3 component map {size} bytes, bytes equal to "
        f"the CPU map's, reloaded bitwise; {small_n}^3 compressed "
        f"{len(zblob)} bytes; DSH {DSH_LOOKUPS} lookups bitwise against the "
        f"CPU and the dense map; viz at {vn}^3: {surf.num_cells} surface "
        f"cells")


def phase_geometry():
    """The geometry and host-side modules at 512^3, 0.01 m: the sphere's
    SDF (map_ops, 2 staged launches), isosurface, weld, OBJ, statistics and
    the mesh rasterized back (and the analytic sphere field); component
    maps of the sphere, a torus and a hollow cube with surfaces and
    topology; bench.py's clutter tagged by component with per-object SDFs
    and meshes and spatial segments; the same scenes at 128^3 on the card
    and the CPU, bitwise; the pipeline's clouds into a fresh OnlineMapper
    (4 tiled-carve launches) and its mesh; serialization, the DSH map and
    the viz exporters. Logs each step's wall time and peak device memory
    and returns the kernels' launches."""
    from voxelized_geometry_tools_tpu_torch import GridSpec

    t_phase = time.monotonic()
    steps = []
    launches = {}
    spec = GridSpec.from_voxel_counts(RESOLUTION, (GRID_N,) * 3)
    sphere = geometry_components(steps, spec,
                                 geometry_sphere(steps, spec, launches))
    geometry_clutter(steps, spec, launches)
    geometry_against_cpu(steps)
    geometry_mapper(steps, launches)
    geometry_host(steps, sphere)
    total = time.monotonic() - t_phase
    log(f"phase_geometry: {total:.1f} s; launches {launches}; steps (ms, "
        f"peak GiB): " + "; ".join(f"{n} {ms:.1f} {p / 2 ** 30:.3f}"
                                   for n, ms, p in steps))
    return launches



# -- The sharded path and the examples ----------------------------------------

SHARDED_RANKS = 4
# Slab triangles a rank may hold (each rank's 128 x-planes of the 512^3
# sphere hold at most about half of its 1,846,704).
SHARDED_ISO_CAP = 1 << 21
SPHERE_TRIANGLES = 1_846_704
# The grid-sharded renders' exchange schedule: the depths do not depend on
# it; 64 owner steps a phase and 4 chunks keep the eager phase loop short.
GRID_RENDER = dict(steps_per_exchange=64, ray_chunks=4)
GRID_CONE = dict(coarse_factor=8, cone_steps=32, cone_tail_chunks=8,
                 **GRID_RENDER)
# The JAX tests' tolerances (tests/test_sharded.py): the schedule and the
# table renders 1e-5, the fixed march 1e-6, the grid-sharded march 1e-4.
SHARDED_SCHEDULE_ATOL = 1e-5
SHARDED_FIXED_ATOL = 1e-6
GRID_ATOL = 1e-4


def _camera_dict(camera):
    return {"pose": camera.pose.cpu().numpy(), "width": camera.width,
            "height": camera.height, "fx": float(camera.fx),
            "fy": float(camera.fy), "cx": float(camera.cx),
            "cy": float(camera.cy)}


def _host_result(res):
    return SimpleNamespace(**{k: getattr(res, k).cpu() for k in
                              ("depth", "hit", "distance")})


def check_sharded_render(single, depth, atol, resolution, what):
    """A render put together from the ranks against the single-device one
    of the same schedule: hits equal and depths within ``atol``, except
    tangent grazers (the single render's final query within the grazer
    band of the threshold) and budget-capped hits (final query above the
    threshold), as phase_render_schedule excepts them. Returns the largest
    depth difference held and the count of excepted pixels."""
    depth = torch.from_numpy(depth)
    thresh = 0.25 * resolution
    excepted = ((single.distance - thresh).abs() <= GRAZER_BAND * resolution
                ) | (single.hit & (single.distance > thresh))
    hit = depth < 99.0
    flips = (hit != single.hit) & ~excepted
    if bool(flips.any()):
        raise AssertionError(f"{what}: {int(flips.sum())} hit flips outside "
                             "the grazer band")
    both = hit & single.hit & ~excepted
    err = float((depth[both] - single.depth[both]).abs().max())
    if err > atol:
        raise AssertionError(f"{what}: depth differs by {err} m (> {atol})")
    return err, int((excepted & ((hit != single.hit) | (
        (depth - single.depth).abs() > atol))).sum())


def _same_array(a, b, what):
    if a.shape != b.shape or not np.array_equal(a, b):
        bad = (a != b).sum() if a.shape == b.shape else "shape"
        raise AssertionError(f"{what}: sharded and single-device differ "
                             f"({bad})")


def _log_world(label, out, size):
    """Each step's wall time, and per rank its launches, collective bytes
    and ms, and peak device memory."""
    for name in out["steps"][0]:
        ms = max(st[name]["ms"] for st in out["steps"])
        card = max(st[name]["card_used_bytes"] for st in out["steps"])
        log(f"{label} step {name}: {ms:.1f} ms (slowest rank); card memory "
            f"in use {card / 2 ** 30:.2f} GiB")
        for r, st in enumerate(out["steps"]):
            c = st[name]["collectives"]
            per = ", ".join(
                f"{k} {c['calls'][k]}x {c['bytes'][k] / 2 ** 20:.1f} MiB "
                f"{c['ms'][k]:.1f} ms" for k in sorted(c["calls"]))
            log(f"  rank {r}/{size}: launches {st[name]['launches']}; "
                f"collectives: {per or 'none'}; staged "
                f"{c['staged_bytes'] / 2 ** 20:.1f} MiB")
    for r in range(size):
        log(f"{label} rank {r}: peak device memory "
            f"{out['peak_bytes'][r] / 2 ** 30:.3f} GiB, launches "
            f"{out['launches'][r]}")


def phase_sharded(camera):
    """The sharded path (parallel/) four ranks wide at 512^3 on the one
    card (gloo, each collective staged through host memory), held against
    the single-device port: the pipeline's four cameras carved and fused
    into Z slabs (occupancy bitwise), the slabs' SDF and bench.py's sphere
    SDF from Z slabs (bitwise), the pixel-row renders of the sphere on the
    shipped schedule and the fixed march, the slab table along x and the
    grid-sharded renders without and with the cone prepass, and the X-slab
    isosurface (bitwise, 1,846,704 triangles); then a one-rank NCCL world
    (device tensors, no staging) through the carve and the SDFs, and
    dryrun_multichip(4). No time here is a scaling number: the ranks share
    one card and their collectives go through host memory."""
    import gc
    from voxelized_geometry_tools_tpu_torch import GridSpec, OccupancyMap, entry
    from voxelized_geometry_tools_tpu_torch.models import fusion_pipeline
    from voxelized_geometry_tools_tpu_torch.ops import (edt, isosurface,
                                                        render, sdf_query)
    from voxelized_geometry_tools_tpu_torch.parallel import launch, targets
    from voxelized_geometry_tools_tpu_torch.parallel.mesh_utils import P

    t_phase = time.monotonic()
    slabs = P(None, None, "z")
    # Single-device references, on the card, then moved to the host.
    spec = GridSpec.from_voxel_counts(PIPE_RES, (PIPE_N,) * 3)
    env = OccupancyMap.create(spec, default_occupancy=0.5, device="cuda")
    clouds = pipeline_clouds("cuda")
    with torch.no_grad():
        out = fusion_pipeline.reconstruct(env, clouds, camera)
        ref_occ = out.occupancy_map.occupancy.cpu().numpy()
        ref_pipe_sdf = out.sdf.distances.cpu().numpy()
        del out
        mask = sphere_mask(GRID_N, "cuda")
        sdf = edt.extract_signed_distance_field(mask, spec, None,
                                                frame="bench")
        table = sdf_query.build_corner_table(sdf)
        ref_shipped = _host_result(render.render_depth(
            sdf, camera, num_steps=NUM_STEPS, corner_table=table,
            **SCHEDULE))
        ref_fixed = _host_result(render.render_depth(
            sdf, camera, num_steps=NUM_STEPS, corner_table=table))
        del table
        iso = isosurface.extract_isosurface(sdf, max_triangles=GEOMETRY_CAP,
                                            frame="grid")
        ref_tri = iso.vertices[iso.valid].cpu().numpy()
        del iso
        ref_sphere_sdf = sdf.distances.cpu().numpy()
        host_mask = mask.cpu().numpy()
        del sdf, mask
    cloud_args = [(c.points.cpu().numpy(), c.origin_transform.cpu().numpy(),
                   float(c.max_range)) for c in clouds]
    del env, clouds
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    if ref_tri.shape[0] != SPHERE_TRIANGLES:
        raise AssertionError(f"single-device sphere isosurface: "
                             f"{ref_tri.shape[0]} triangles")
    log(f"sharded references (single device): {time.monotonic() - t_phase:.1f}"
        f" s; {ref_tri.shape[0]} sphere triangles")

    out_specs = {"occupancy": slabs, "pipe_sdf": slabs, "sphere_sdf": slabs,
                 "render_schedule": P("z"), "render_fixed": P("z"),
                 "grid_fixed": P(), "grid_cone": P(), "grid_phases": P(),
                 "iso_vertices": P("z"), "iso_valid": P("z"),
                 "iso_counts": P(), "steps": None, "launches": None,
                 "peak_bytes": None, "mesh": None}
    args = (spec, cloud_args, host_mask, _camera_dict(camera), NUM_STEPS,
            SCHEDULE, GRID_CONE, SHARDED_ISO_CAP)
    in_specs = (None, None, slabs, None, None, None, None, None)
    t0 = time.monotonic()
    with launch.World(SHARDED_RANKS, "gloo", "cuda") as world:
        t_start = time.monotonic() - t0
        log(f"sharded world: {SHARDED_RANKS} ranks started in {t_start:.1f} "
            f"s; {world.descriptions[0]}")
        t0 = time.monotonic()
        got = world.run(targets.pipeline, *args, in_specs=in_specs,
                        out_specs=out_specs)
        t_run = time.monotonic() - t0
        timings = world.last_timings
        t0 = time.monotonic()
    log(f"sharded world: run {t_run:.1f} s, stopped in "
        f"{time.monotonic() - t0:.1f} s; per rank (inputs, target, "
        f"outputs, reply s): " + "; ".join(
            f"{t['inputs_s']:.2f} {t['target_s']:.2f} {t['outputs_s']:.2f} "
            f"{t['reply_s']:.2f}" for t in timings))
    _log_world("sharded", got, SHARDED_RANKS)
    total = {k: sum(r[k] for r in got["launches"])
             for k in got["launches"][0]}
    for r in range(SHARDED_RANKS):
        launches = got["launches"][r]
        # 4 clouds (a setup and a carve each), one filter of their grids;
        # 2 envelope passes and one combine for each of the 2 SDFs.
        if launches != {"edt_bestfirst_staged": 4,
                        "ray_setup": len(cloud_args),
                        "carve_tiled": len(cloud_args), "fusion_filter": 1,
                        "edt_combine": 2}:
            raise AssertionError(f"rank {r} launches {launches}")

    _same_array(got["occupancy"], ref_occ, "fused occupancy")
    _same_array(got["pipe_sdf"], ref_pipe_sdf, "pipeline SDF")
    _same_array(got["sphere_sdf"], ref_sphere_sdf, "sphere SDF")
    res = RESOLUTION
    err_s, exc_s = check_sharded_render(ref_shipped, got["render_schedule"],
                                        SHARDED_SCHEDULE_ATOL, res,
                                        "pixel-row shipped schedule")
    err_f, exc_f = check_sharded_render(ref_fixed, got["render_fixed"],
                                        SHARDED_FIXED_ATOL, res,
                                        "pixel-row fixed march")
    err_g, exc_g = check_sharded_render(ref_fixed, got["grid_fixed"],
                                        GRID_ATOL, res,
                                        "grid-sharded slab-table march")
    # The cone prepass starts each ray where the single-device schedule
    # does (the same certificates), and the march from there is the same:
    # the shipped render's depths. Then the cone contract against the
    # fixed march, with the shipped render's final samples for the
    # grazer test of the cone side.
    err_gc, exc_gc = check_sharded_render(ref_shipped, got["grid_cone"],
                                          GRID_ATOL, res,
                                          "grid-sharded cone render")
    cone = torch.from_numpy(got["grid_cone"])
    lost, err_c, n_past, _ = check_cone_equiv(ref_fixed, SimpleNamespace(
        depth=cone, hit=cone < 99.0, distance=ref_shipped.distance), res)
    counts = got["iso_counts"]
    tri = got["iso_vertices"][got["iso_valid"]]
    if int(counts.sum()) != SPHERE_TRIANGLES:
        raise AssertionError(f"sharded isosurface counts {counts}")
    _same_array(tri, ref_tri, "isosurface triangles")
    log(f"sharded {SHARDED_RANKS} ranks at {GRID_N}^3 ({t_run:.1f} s): "
        f"occupancy, pipeline SDF and sphere SDF bitwise; pixel-row renders "
        f"shipped max diff {err_s:.3e} m ({exc_s} grazer or budget-capped "
        f"pixels excepted), fixed {err_f:.3e} m ({exc_f}); grid-sharded "
        f"slab-table march {err_g:.3e} m ({exc_g}), "
        f"{int(got['grid_phases'][0])} phases; with the cone prepass "
        f"{int(got['grid_phases'][1])} phases, against the shipped render "
        f"{err_gc:.3e} m ({exc_gc}), against the fixed march {lost} grazer "
        f"hits lost, max depth diff {err_c:.3e} m ({n_past} grazer or "
        f"budget-capped hits past it); isosurface {counts.tolist()} "
        f"triangles, bitwise in rank order")
    del got

    # One rank over NCCL: device tensors, no staging.
    t0 = time.monotonic()
    with launch.World(1, "nccl", "cuda") as world:
        log(f"sharded NCCL world: {world.descriptions[0]}")
        one = world.run(targets.pipeline, *args, in_specs=in_specs,
                        out_specs={k: out_specs[k] for k in (
                            "occupancy", "pipe_sdf", "sphere_sdf", "steps",
                            "launches", "peak_bytes")}, carve_only=True)
    _log_world("nccl", one, 1)
    for k, v in one["launches"][0].items():
        total[k] += v
    _same_array(one["occupancy"], ref_occ, "NCCL fused occupancy")
    _same_array(one["pipe_sdf"], ref_pipe_sdf, "NCCL pipeline SDF")
    _same_array(one["sphere_sdf"], ref_sphere_sdf, "NCCL sphere SDF")
    staged = sum(st[n]["collectives"]["staged_bytes"]
                 for st in one["steps"] for n in st)
    if staged:
        raise AssertionError(f"the NCCL world staged {staged} bytes")
    log(f"sharded NCCL 1 rank ({time.monotonic() - t0:.1f} s): occupancy "
        f"and both SDFs bitwise, nothing staged")
    del one

    t0 = time.monotonic()
    dry = entry.dryrun_multichip(SHARDED_RANKS, backend="gloo")
    log(f"dryrun_multichip({SHARDED_RANKS}) on the card, gloo: loss "
        f"{float(dry['loss']):.6f}, {time.monotonic() - t0:.1f} s")
    log(f"phase_sharded: {time.monotonic() - t_phase:.1f} s; launches of "
        f"its worlds' pipeline steps, every rank: {total}")
    return total


EXAMPLES = (
    ("voxel_raycasting", []), ("differentiable_fitting", []),
    ("tutorial", []), ("estimate_distance", []),
    ("pointcloud_voxelization", []), ("online_mapping", []),
    ("isosurface_export", None), ("spatial_segments", []),
    ("sharded_pipeline", ["--backend", "gloo", "--world-size",
                          str(SHARDED_RANKS)]))


def phase_examples():
    """Every ported example on the card at its default arguments
    (sharded_pipeline with four gloo ranks), with its output and time."""
    import importlib
    import tempfile

    t_phase = time.monotonic()
    for name, argv in EXAMPLES:
        module = importlib.import_module(
            f"voxelized_geometry_tools_tpu_torch.examples.{name}")
        log(f"-- example {name}")
        t0 = time.monotonic()
        with tempfile.TemporaryDirectory() as tmp:
            lines = module.main(
                [f"{tmp}/isosurface.obj"] if argv is None else argv)
        log(f"-- example {name}: {time.monotonic() - t0:.2f} s")
        text = "\n".join(lines)
        if name == "pointcloud_voxelization" and text.count("PASSED") != 2:
            raise AssertionError("pointcloud_voxelization: a backend failed")
        if name == "sharded_pipeline" and (
                "single-device EDT: True" not in text
                or "pixel-sharded render: True" not in text):
            raise AssertionError("sharded_pipeline: a comparison failed")
        if name == "online_mapping" and (
                lines[-1] != "OK" or "integration: True" not in text):
            raise AssertionError("online_mapping failed")
    log(f"phase_examples: {time.monotonic() - t_phase:.1f} s")


def main():
    name = phase_device()
    phase_build()
    err_cases = phase_kernel_vs_plain()
    seed_row = phase_edt_seed()
    filter_row = phase_fusion_filter()
    combine_row = phase_edt_combine()
    torch.cuda.reset_peak_memory_stats()
    (spec, mask, sdf, table, camera, fixed, early, launches, seed_launches,
     combine_launches) = phase_main_path()
    log(f"peak device memory, main path: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    t_edt, err_edt, pass_bounds = phase_edt_checks(mask, sdf)
    sweep_launches, sweep_errs, sweep_times = \
        phase_backend_sweep(mask, sdf, t_edt)
    phase_render(sdf, table, camera, fixed, early)
    phase_render_schedule(spec, sdf, table, camera, fixed)
    del table, fixed, early
    phase_gradients()
    del sdf, mask
    glob_launches, glob_errs, glob_times, glob_plain, glob_bounds = \
        phase_global_variant()
    phase_sqrt_rounding()
    err_large = phase_large_grid()
    (probe_launches, probe_errs, probe_ms, probe_plain_ms, probe_library_ms,
     probe_bounds) = phase_probes()
    phase_carve()
    carve_rows = phase_pipeline(camera)
    t_slice = time.monotonic()
    phase_rotated_carve()
    filter_launches = phase_mapper()
    phase_fits()
    log(f"rotated carve, mapper and fits phases: "
        f"{time.monotonic() - t_slice:.1f} s")
    phase_queries()
    phase_api()
    log(f"phase_geometry launches (counted steps): {phase_geometry()}")
    # The sharded worlds' launches (every rank's), added to the rows of
    # the two kernels their path runs.
    sharded_launches = phase_sharded(camera)
    phase_examples()
    plain_512 = t_edt["plain_y"] + t_edt["plain_z"]
    kernels = []
    for kname, (source, replaces) in KERNELS.items():
        # Each envelope kernel's y + z passes, wrapper included, against the
        # plain version and the bound of the same passes. The staged
        # best-first variant: the main path's launches and its 512^3 field.
        # The clustered and global variants: the [4, 2048, 2048] field; the
        # launches of the [4, 2048, 2048] EDT (hoist_cmin=True), or of the
        # LONG_SHAPE EDT for the global best-first variants. The full
        # sweep's and the windowed walk's staged variants: the 512^3 backend
        # sweep's launches and the main path's field. The staged best-first
        # variant and carve_tiled also count the sharded worlds' launches.
        errs = [err_cases[kname]]
        parts = [pass_bounds["y"], pass_bounds["z"]]
        if kname == "edt_bestfirst_staged":
            n_launch = launches + sharded_launches[kname]
            errs = errs + [sweep_errs[kname], err_edt, err_large]
            ms = t_edt["wrapper_y"] + t_edt["wrapper_z"]
            plain_ms = plain_512
        elif kname in glob_launches:
            n_launch, errs = glob_launches[kname], errs + [glob_errs[kname]]
            ms, plain_ms, parts = sum(glob_times[kname]), sum(glob_plain), \
                glob_bounds
        else:
            n_launch, errs = sweep_launches[kname], errs + [sweep_errs[kname]]
            ms, plain_ms = sum(sweep_times[kname]), plain_512
        bound_ms, bound_by = summed_bound(parts)
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces, "launches": n_launch,
            "max_abs_err": max(errs), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            # No single PyTorch call computes the min-plus transform.
            "library_ms": None,
        })
    for kname, (replaces, _, _) in PROBES.items():
        # Launches: the probes' entry point's run. Times: one replica at
        # the card's shape of that key, against the plain version and the
        # library call that moves the same rows.
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + "probes.cu",
            "replaces": replaces, "launches": probe_launches[kname],
            "max_abs_err": probe_errs[kname], "ms": probe_ms[kname],
            "plain_ms": probe_plain_ms[kname],
            "bound_ms": probe_bounds[kname][0],
            "bound_by": probe_bounds[kname][1],
            "library_ms": probe_library_ms[kname],
        })
    # The carve kernel: the pipeline's launches; its time, its plain
    # version's and the bound on the pipeline's first camera at 512^3. Every
    # comparison of it is bitwise (a difference raises). No single PyTorch
    # call computes the walk.
    # The setup and transform product kernels: the pipeline's launches and
    # the sharded worlds' (the setup's), their times at the main path's
    # shapes and their plain versions'; every comparison of them is bitwise.
    for kname, row in carve_rows.items():
        kernels.append({
            "name": kname, "route": "cuda",
            "source": CSRC + row.pop("source", "carve.cu"),
            "replaces": row.pop("replaces", CARVE_REPLACES),
            "launches": row["launches"] + sharded_launches.get(kname, 0),
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
        })
    # The seed kernel: the main path's launches (one dense EDT, one), its
    # 512^3 two-field time and the plain version's. Every comparison of it
    # is bitwise and a difference raises, so its error is 0.
    kernels.append({
        "name": "edt_seed", "route": "cuda", "source": CSRC + "edt_seed.cu",
        "replaces": SEED_REPLACES, "launches": seed_launches,
        "max_abs_err": 0.0, **seed_row, "library_ms": None,
    })
    # The fusion filter kernel: the mapper's integrate launches (one a
    # frame) and the sharded worlds' (one a rank), its time at the map
    # cell's shape (one camera, 512^3) and the plain version's. Every
    # comparison of it is bitwise and a difference raises.
    kernels.append({
        "name": "fusion_filter", "route": "cuda",
        "source": CSRC + "fusion_filter.cu", "replaces": FILTER_REPLACES,
        "launches": filter_launches + sharded_launches["fusion_filter"],
        "max_abs_err": 0.0, **filter_row, "library_ms": None,
    })
    # The combine kernel: the main path's launches (one dense EDT, one) and
    # the sharded worlds' (one an SDF), its time on the 512^3 sphere's
    # stacked field in float32 and the plain version's. Every comparison
    # of it is bitwise and a difference raises.
    kernels.append({
        "name": "edt_combine", "route": "cuda",
        "source": CSRC + "edt_combine.cu", "replaces": COMBINE_REPLACES,
        "launches": combine_launches + sharded_launches["edt_combine"],
        "max_abs_err": 0.0, **combine_row, "library_ms": None,
    })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
