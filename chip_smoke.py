"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the checkout (one nvcc per source, in
parallel), checks each bit for bit against its plain PyTorch version, then
drives the main path at full size (512^3 two-field EDT -> corner table ->
640x480 sphere-traced renders, the scene and camera of bench.py) and the
differentiable ``entry()``, checking every result. Then it drives every
other EDT backend through the same 512^3 EDT, the large-grid path (a
1024^3 signed EDT that takes the slab-streamed pipeline on its own, and a
render from it without a corner table), the primitive-rate probes' entry
point (``kernels.probes.main``, the counterpart of
benchmarks/inkernel_microbench.py) with each probe held against its plain
version, and bench.py's shipped early-exit schedule (cone prepass, block-
sorted tail, sparse final sample) on the sphere and clutter scenes. Prints
human-readable lines, then a JSON line describing each kernel, then
``{"ok": true, "device": ...}`` as the last line. Any failure raises, and
the script exits non-zero; without a CUDA card it exits non-zero before
doing anything.
"""

import contextlib
import functools
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from voxelized_geometry_tools_tpu_torch.kernels import probes
from voxelized_geometry_tools_tpu_torch.kernels.probes import cuda_ms

GRID_N = 512
RESOLUTION = 0.01
IMG_W, IMG_H = 640, 480
NUM_STEPS = 64
LARGE_N = 1024
CSRC = "voxelized_geometry_tools_tpu_torch/kernels/csrc/"
PALLAS = "voxelized_geometry_tools_tpu/kernels/edt_pallas.py:"
# Each kernel of the port: (source, the TPU kernel it replaces, the backend
# that runs it through the EDT).
KERNELS = {
    "edt_bestfirst": (CSRC + "edt_bestfirst.cu", PALLAS + "301",
                      "cuda-bestfirst"),
    "edt_bestfirst_inkernel": (CSRC + "edt_bestfirst.cu", PALLAS + "241",
                               "cuda-bestfirst"),
    "edt_envelope": (CSRC + "edt_envelope.cu", PALLAS + "111",
                     "cuda-envelope"),
    "edt_windowed": (CSRC + "edt_windowed.cu", PALLAS + "161",
                     "cuda-windowed"),
}
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
LIBRARIES = ("edt_bestfirst", "edt_envelope", "edt_windowed", "probes")
# bench.py's shipped render schedule (bench.py:124-128).
SCHEDULE = dict(early_exit=True, coarse_factor=8, head_steps=0,
                tail_chunks=32, cone_steps=32, cone_tail_chunks=8)
SCHEDULE_FRAMES = 3
# Peak device memory allowed for the streamed 1024^3 signed EDT.
STREAMED_PEAK_GIB = 20.0
# Render contract (as tests/test_torch_render.py): depth within 1e-4 m on
# common hits; hit flips only on tangent grazers, at most 0.5% of pixels.
DEPTH_ATOL = 1e-4
MAX_HIT_FLIPS = 0.005
GRAZER_BAND = 0.08
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(f"device: {name} (torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} card(s))")
    log(f"nvidia-smi name,power.limit: {smi.stdout.strip()}")
    return name


def kernel_modules():
    from voxelized_geometry_tools_tpu_torch.kernels import (
        edt_bestfirst, edt_envelope, edt_windowed)
    return edt_bestfirst, edt_envelope, edt_windowed


def kernel_fns():
    """Each kernel's wrapper, by the names of ``KERNELS``."""
    eb, ee, ew = kernel_modules()
    return {
        "edt_bestfirst": eb.parabolic_envelope_last,
        "edt_bestfirst_inkernel": functools.partial(
            eb.parabolic_envelope_last, hoist_cmin=False),
        "edt_envelope": ee.parabolic_envelope_last,
        "edt_windowed": ew.parabolic_envelope_last,
    }


def reset_launches():
    eb, ee, ew = kernel_modules()
    eb.launches = eb.launches_inkernel = ee.launches = ew.launches = 0


def read_launches():
    eb, ee, ew = kernel_modules()
    return {"edt_bestfirst": eb.launches,
            "edt_bestfirst_inkernel": eb.launches_inkernel,
            "edt_envelope": ee.launches, "edt_windowed": ew.launches}


def phase_build():
    from voxelized_geometry_tools_tpu_torch.kernels import build
    eb, ee, ew = kernel_modules()
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(LIBRARIES)) as pool:
        paths = list(pool.map(build.build, LIBRARIES))
    for mod in (eb, ee, ew):
        mod._launcher()
    probes._library()
    log(f"build: {', '.join(LIBRARIES)} in {time.monotonic() - t0:.2f} s "
        "(in parallel)")
    for name, path in zip(LIBRARIES, paths):
        ptxas = path.with_suffix(".log")
        if not ptxas.exists():
            continue
        for line in ptxas.read_text().splitlines():
            if ("registers" in line or "spill" in line or "smem" in line
                    or "entry function" in line):
                log(f"  ptxas {name}: {line.strip()}")


def envelope_cases():
    """Random fields (+inf, negative values), degenerate fields, n in {37,
    300, 512, 513}, ragged line counts and strided layouts."""
    rng = np.random.default_rng(0)
    cases = []
    for n in (37, 300, 512, 513):
        for shape in [(n,), (77, n), (3, 45, n), (2, 1000, n)]:
            f = rng.uniform(-60.0, 400.0, shape).astype(np.float32)
            f[rng.uniform(size=shape) < 0.5] = np.inf
            cases.append((f"random{shape}", torch.from_numpy(f).cuda()))
        # The y pass's layout: the transformed axis is not the last in
        # memory (a moved view, read in place by the kernel).
        sparse = np.where(rng.random((5, n, 70)) < 0.01, 0.0, np.inf)
        x = torch.from_numpy(sparse.astype(np.float32)).cuda()
        cases.append((f"sparse-seeds-moved(5,70,{n})", x.movedim(1, -1)))
    for fill in (np.inf, 0.0, 1e6, -3.0):
        cases.append((f"fill={fill}",
                      torch.full((6, 40, 129), fill, device="cuda")))
    return cases


def nonneg_envelope_cases():
    """The cases the windowed kernel is exact on (f >= 0): random fields
    with +inf holes and whole +inf lines, sparse seeds in the moved layout,
    and the non-negative fills."""
    rng = np.random.default_rng(1)
    cases = []
    for n in (37, 300, 512, 513):
        for shape in [(n,), (77, n), (3, 45, n), (2, 1000, n)]:
            f = rng.uniform(0.0, 400.0, shape).astype(np.float32)
            f[rng.uniform(size=shape) < 0.5] = np.inf
            if len(shape) > 1:
                f[..., rng.uniform(size=shape[-2]) < 0.2, :] = np.inf
            cases.append((f"nonneg{shape}", torch.from_numpy(f).cuda()))
        sparse = np.where(rng.random((5, n, 70)) < 0.01, 0.0, np.inf)
        x = torch.from_numpy(sparse.astype(np.float32)).cuda()
        cases.append((f"sparse-seeds-moved(5,70,{n})", x.movedim(1, -1)))
    for fill in (np.inf, 0.0, 1e6):
        cases.append((f"fill={fill}",
                      torch.full((6, 40, 129), fill, device="cuda")))
    return cases


def phase_kernel_vs_plain():
    """Every kernel bitwise against the plain version; the windowed kernel
    on f >= 0 only. Returns the largest error per kernel."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
    signed, nonneg = envelope_cases(), nonneg_envelope_cases()
    refs = [k.parabolic_envelope_last_plain(f) for _, f in signed + nonneg]
    worst = {}
    for kname, fn in kernel_fns().items():
        cases = list(zip(signed + nonneg, refs))
        if kname == "edt_windowed":
            cases = cases[len(signed):]
        worst[kname] = 0.0
        for (name, f), ref in cases:
            got = fn(f)
            torch.cuda.synchronize()
            err = max_abs_err(got, ref)
            worst[kname] = max(worst[kname], err)
            if not torch.equal(got, ref):
                raise AssertionError(f"{kname} != plain on {name}: max abs "
                                     f"err {err}")
        log(f"kernel vs plain: {kname}: {len(cases)} cases bitwise equal")
    return worst


def sphere_mask(n, device):
    ax = torch.arange(n, device=device, dtype=torch.float32)
    c, r = n / 2.0, n / 4.0
    return ((ax[:, None, None] - c) ** 2 + (ax[None, :, None] - c) ** 2
            + (ax[None, None, :] - c) ** 2) <= r * r


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

    reset_launches()
    with torch.no_grad():
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
    launches = counts["edt_bestfirst"]
    log(f"main path: launches {counts}")
    if launches != 2:
        raise AssertionError(f"the {GRID_N}^3 EDT launched the kernel {launches} "
                             "times, expected 2 (y and z passes)")
    if sum(counts.values()) != launches:
        raise AssertionError(f"the main path launched another kernel: {counts}")
    return spec, mask, sdf, table, camera, fixed, early, launches


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
    d = torch.cat([
        edt._binary_squared_dist_last(m.movedim(0, -1)).movedim(-1, 0)
        for m in (mask, ~mask)])
    fy = d.movedim(1, -1)
    dz = k.parabolic_envelope_last(fy).movedim(-1, 1)
    t = {}
    t["kernel_y"] = cuda_ms(lambda: k.parabolic_envelope_last(fy), 5)
    t["kernel_z"] = cuda_ms(lambda: k.parabolic_envelope_last(dz), 5)
    t["plain_y"] = cuda_ms(lambda: k.parabolic_envelope_last_plain(fy), 1)
    t["plain_z"] = cuda_ms(lambda: k.parabolic_envelope_last_plain(dz), 1)
    ft_z = dz.transpose(1, 2).contiguous()
    t["minima_y"] = cuda_ms(lambda: k._chunk_minima(fy.transpose(1, 2)), 5)
    t["transpose_z"] = cuda_ms(lambda: dz.transpose(1, 2).contiguous(), 5)
    t["minima_z"] = cuda_ms(lambda: k._chunk_minima(ft_z), 5)
    t["edt_total"] = cuda_ms(lambda: edt.signed_distance_from_filled_mask(
        mask, RESOLUTION), 3)
    del d, fy, dz, ft_z
    for key, ms in t.items():
        log(f"edt time {key}: {ms:.3f} ms")
    log(f"edt {GRID_N}^3 two-field: {GRID_N ** 3 / (t['edt_total'] / 1e3):.4e} "
        "voxels/s")
    return t, err


@contextlib.contextmanager
def bestfirst_inkernel_minima():
    """Routes ``backend="cuda-bestfirst"`` to the best-first kernel with
    ``hoist_cmin=False`` (the EDT looks the wrapper up at each call)."""
    eb, _, _ = kernel_modules()
    hoisted = eb.parabolic_envelope_last
    eb.parabolic_envelope_last = functools.partial(hoisted, hoist_cmin=False)
    try:
        yield
    finally:
        eb.parabolic_envelope_last = hoisted


def phase_backend_sweep(mask, sdf, t_plain):
    """The 512^3 signed EDT through every kernel backend: each must give the
    main path's bits (held against plain in phase_edt_checks) through its
    own kernel, two launches each; then each kernel's y- and z-pass times
    on the main path's stacked field. The plain passes were timed in
    phase_edt_checks (same function), so they are not run again."""
    from voxelized_geometry_tools_tpu_torch.ops import edt

    fns = kernel_fns()
    launches, errs, times = {}, {}, {}
    for kname, (_, _, backend) in KERNELS.items():
        route = (bestfirst_inkernel_minima() if kname == "edt_bestfirst_inkernel"
                 else contextlib.nullcontext())
        torch.cuda.synchronize()
        reset_launches()
        with route:
            got = edt.signed_distance_from_filled_mask(mask, RESOLUTION,
                                                       backend=backend)
        torch.cuda.synchronize()
        counts = read_launches()
        launches[kname] = counts[kname]
        if counts[kname] != 2 or sum(counts.values()) != 2:
            raise AssertionError(f"backend {backend} ({kname}): launches "
                                 f"{counts}, expected 2 of {kname}")
        errs[kname] = max_abs_err(got, sdf.distances)
        if not torch.equal(got, sdf.distances):
            raise AssertionError(f"{GRID_N}^3 EDT via {kname} != main path, "
                                 f"max abs err {errs[kname]}")
        del got
        log(f"edt {GRID_N}^3 via {kname} (backend {backend!r}): == main path "
            "(bitwise), 2 launches")

    d = torch.cat([
        edt._binary_squared_dist_last(m.movedim(0, -1)).movedim(-1, 0)
        for m in (mask, ~mask)])
    fy = d.movedim(1, -1)
    dz = fns["edt_bestfirst"](fy).movedim(-1, 1)
    for kname, fn in fns.items():
        reps = 2 if kname == "edt_envelope" else 5
        ty = cuda_ms(lambda: fn(fy), reps)
        tz = cuda_ms(lambda: fn(dz), reps)
        times[kname] = (ty, tz)
        log(f"edt time {kname}: y {ty:.3f} ms, z {tz:.3f} ms (plain y "
            f"{t_plain['plain_y']:.3f} ms, z {t_plain['plain_z']:.3f} ms)")
    del d, fy, dz
    return launches, errs, times


def phase_sqrt_rounding():
    """On every integer below 3 * 1024^2 (every squared distance of a 1024^3
    EDT): the CUDA float64 sqrt, which the EDT's signed combine takes, must
    equal numpy's correctly rounded one; whether the float32 CUDA sqrt is
    correctly rounded too is reported, not relied on."""
    x = torch.arange(3 * LARGE_N ** 2, device="cuda", dtype=torch.float32)
    s64 = torch.sqrt(x.double())
    exact = np.sqrt(np.arange(x.numel(), dtype=np.float64))
    if not np.array_equal(s64.cpu().numpy(), exact):
        raise AssertionError("the CUDA float64 sqrt is not correctly rounded")
    differ = int((torch.sqrt(x) != s64.float()).sum())
    log(f"sqrt on integers < 3*{LARGE_N}^2: cuda float64 == numpy (correctly "
        f"rounded); cuda float32 differs from it on {differ} of {x.numel()}")


def large_sphere_mask(n, device):
    """benchmarks/large_grid.py's scene: a centered sphere of radius n/4,
    built on the card."""
    ax = (torch.arange(n, device=device, dtype=torch.float32)
          - (n - 1) / 2.0) ** 2
    return (ax[:, None, None] + ax[None, :, None]
            + ax[None, None, :]) <= (n / 4.0) ** 2


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
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    counts = read_launches()
    launches = counts["edt_bestfirst"]
    log(f"large {n}^3: extract_signed_distance_field {t_extract * 1e3:.1f} ms"
        f" (first call, min/max included); launches {counts}, schedule "
        f"expects {expected} of edt_bestfirst")
    if launches != expected or sum(counts.values()) != expected:
        raise AssertionError(f"streamed {n}^3 EDT launched {counts}, the "
                             f"schedule expects {expected}")
    log(f"large {n}^3: peak device memory of the streamed call {peak:.3f} "
        f"GiB ({before / 2 ** 30:.3f} GiB held before it)")
    if peak > STREAMED_PEAK_GIB:
        raise AssertionError(f"streamed {n}^3 EDT peaked at {peak:.3f} GiB")
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


def probe_cases(full):
    """(name, kernel call, plain call) for each probe: the TPU seeds and
    others, a row count that is not a power of two, dma depths 2/8/16,
    march batches 64/256, one replica and ``full``; integer tables, so
    every sum is exact and kernel and plain must agree bit for bit."""
    pr = probes
    dev = torch.device("cuda")
    cases = []
    for n_rows, width, seed in ((pr.TABLE_ROWS, pr.WIDTH, pr.GATHER_SEED),
                                (3001, pr.WIDTH, 7), (1000, 37, 424242)):
        table = pr.integer_table(n_rows, width, dev, seed=n_rows)
        for reps, iters in ((1, pr.GATHER_ITERS), (full, 20_000)):
            args = (iters, reps, seed)
            cases.append((f"vmem_gather({n_rows}x{width}, seed {seed}, "
                          f"{reps} replicas)",
                          functools.partial(pr.vmem_gather, table, *args),
                          functools.partial(pr.vmem_gather_plain, table,
                                            *args)))
    for n_rows, width, seed in ((2048, pr.WIDTH, pr.SCATTER_SEED),
                                (4096, pr.WIDTH, 99), (1000, 37, 5)):
        mask = pr.integer_table(1, width, dev, seed=width)
        for reps, iters in ((1, pr.SCATTER_ITERS), (full, 20_000)):
            args = (iters, n_rows, reps, seed)
            cases.append((f"vmem_scatter({n_rows}x{width}, seed {seed}, "
                          f"{reps} replicas)",
                          functools.partial(pr.vmem_scatter, mask, *args),
                          functools.partial(pr.vmem_scatter_plain, mask,
                                            *args)))
    big = pr.integer_table(pr.DMA_ROWS, pr.DMA_WIDTH, dev, seed=2)
    for rows in (pr.DMA_ROWS, 1_000_003):
        table = big[:rows]
        for depth in pr.DMA_DEPTHS:
            for reps in (1, full):
                args = (pr.DMA_ITERS, depth, reps, pr.DMA_SEED + depth)
                cases.append((f"hbm_dma({rows}x{pr.DMA_WIDTH}, depth "
                              f"{depth}, {reps} replicas)",
                              functools.partial(pr.hbm_dma, table, *args),
                              functools.partial(pr.hbm_dma_plain, table,
                                                *args)))
    for n_rows in (pr.TABLE_ROWS, 3001):
        table = pr.integer_table(n_rows, pr.WIDTH, dev, seed=n_rows + 1)
        for batch in pr.MARCH_BATCHES:
            t0 = pr.integer_table(1, batch, dev, seed=batch) * 0.25
            for reps in (1, full):
                args = (table, t0, pr.MARCH_STEPS, reps)
                cases.append((f"vmem_batch_march({n_rows}x{pr.WIDTH}, "
                              f"batch {batch}, {reps} replicas)",
                              functools.partial(pr.vmem_batch_march, *args),
                              functools.partial(pr.vmem_batch_march_plain,
                                                *args)))
    return cases


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
    kernel_ms = {}
    for name, (_, key, rows) in PROBES.items():
        kernel_ms[name] = rates[key] * rows / 1e6
        log(f"probe {name}: {rates[key]:.4f} ns/row with 1 replica "
            f"({kernel_ms[name]:.4f} ms), {rates['full_card'][key]:.4f} "
            f"ns/row over {full} replicas; plain version "
            f"{plain_ms[name]:.4f} ms (index generation included)")
    return launches, worst, kernel_ms, plain_ms


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


def main():
    name = phase_device()
    phase_build()
    err_cases = phase_kernel_vs_plain()
    torch.cuda.reset_peak_memory_stats()
    spec, mask, sdf, table, camera, fixed, early, launches = \
        phase_main_path()
    log(f"peak device memory, main path: "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB")
    t_edt, err_edt = phase_edt_checks(mask, sdf)
    sweep_launches, sweep_errs, sweep_times = phase_backend_sweep(
        mask, sdf, t_edt)
    phase_render(sdf, table, camera, fixed, early)
    phase_render_schedule(spec, sdf, table, camera, fixed)
    del table, fixed, early
    phase_gradients()
    del sdf, mask
    phase_sqrt_rounding()
    err_large = phase_large_grid()
    probe_launches, probe_errs, probe_ms, probe_plain_ms = phase_probes()
    kernels = []
    for kname, (source, replaces, _) in KERNELS.items():
        # Launches: the main path's run for the best-first kernel, the
        # 512^3 backend sweep's run for the others. Times (backend sweep):
        # one 512^3 two-field EDT's y + z envelope passes, wrapper included
        # (chunk minima, z-pass transpose), against the plain version of
        # the same two passes.
        first = kname == "edt_bestfirst"
        errs = [err_cases[kname], sweep_errs[kname]]
        errs += [err_edt, err_large] if first else []
        ty, tz = sweep_times[kname]
        kernels.append({
            "name": kname, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": launches if first else sweep_launches[kname],
            "max_abs_err": max(errs),
            "ms": ty + tz,
            "plain_ms": t_edt["plain_y"] + t_edt["plain_z"],
        })
    for kname, (replaces, _, _) in PROBES.items():
        # Launches: the probes' entry point's run. Times: one replica at
        # the card's shape of that key, against the plain version.
        kernels.append({
            "name": kname, "route": "cuda", "source": CSRC + "probes.cu",
            "replaces": replaces, "launches": probe_launches[kname],
            "max_abs_err": probe_errs[kname], "ms": probe_ms[kname],
            "plain_ms": probe_plain_ms[kname],
        })
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
