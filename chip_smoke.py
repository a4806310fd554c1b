"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Builds the port's CUDA kernel from the checkout, checks it bit for bit
against its plain PyTorch version, then drives the main path at full size
(512^3 two-field EDT -> corner table -> 640x480 sphere-traced renders, the
scene and camera of bench.py) and the differentiable ``entry()``, checking
every result. Prints human-readable lines, then a JSON line describing each
kernel, then ``{"ok": true, "device": ...}`` as the last line. Any failure
raises, and the script exits non-zero; without a CUDA card it exits
non-zero before doing anything.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

GRID_N = 512
RESOLUTION = 0.01
IMG_W, IMG_H = 640, 480
NUM_STEPS = 64
KERNEL_SOURCE = "voxelized_geometry_tools_tpu_torch/kernels/csrc/edt_bestfirst.cu"
KERNEL_REPLACES = "voxelized_geometry_tools_tpu/kernels/edt_pallas.py:301"
# Render contract (as tests/test_torch_render.py): depth within 1e-4 m on
# common hits; hit flips only on tangent grazers, at most 0.5% of pixels.
DEPTH_ATOL = 1e-4
MAX_HIT_FLIPS = 0.005
GRAZER_BAND = 0.08
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-4


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, reps):
    """Mean milliseconds per call of ``fn`` on the current stream (CUDA
    events around ``reps`` calls, after one warm-up call)."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    del out
    return start.elapsed_time(stop) / reps


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


def phase_build():
    from voxelized_geometry_tools_tpu_torch.kernels import build, edt_bestfirst
    t0 = time.monotonic()
    edt_bestfirst._launcher()
    log(f"build: edt_bestfirst in {time.monotonic() - t0:.2f} s")
    ptxas = build.library_path("edt_bestfirst").with_suffix(".log")
    if ptxas.exists():
        for line in ptxas.read_text().splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  ptxas: {line.strip()}")


def phase_kernel_vs_plain():
    """Bitwise on random fields (+inf, negative values), degenerate fields,
    n in {37, 300, 512, 513}, ragged line counts and strided layouts."""
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst as k
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
    worst = 0.0
    for name, f in cases:
        got = k.parabolic_envelope_last(f)
        ref = k.parabolic_envelope_last_plain(f)
        torch.cuda.synchronize()
        err = max_abs_err(got, ref)
        worst = max(worst, err)
        if not torch.equal(got, ref):
            raise AssertionError(f"kernel != plain on {name}: max abs err "
                                 f"{err}")
    log(f"kernel vs plain: {len(cases)} cases bitwise equal")
    return worst


def sphere_mask(n, device):
    ax = torch.arange(n, device=device, dtype=torch.float32)
    c, r = n / 2.0, n / 4.0
    return ((ax[:, None, None] - c) ** 2 + (ax[None, :, None] - c) ** 2
            + (ax[None, None, :] - c) ** 2) <= r * r


def phase_main_path():
    """The main path at full size, with every launch count reset first."""
    from voxelized_geometry_tools_tpu_torch import GridSpec
    from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst
    from voxelized_geometry_tools_tpu_torch.ops import edt, render, sdf_query

    spec = GridSpec.from_voxel_counts(RESOLUTION, (GRID_N,) * 3)
    mask = sphere_mask(GRID_N, "cuda")
    sizes = np.asarray(spec.grid_sizes)
    pose = np.eye(4, dtype=np.float32)
    pose[:3, 3] = sizes / 2.0 - np.array([0.0, 0.0, 1.2 * sizes[2]])
    camera = render.PinholeCamera.create(pose, IMG_W, IMG_H, focal=520.0,
                                         device="cuda")
    torch.cuda.synchronize()

    edt_bestfirst.launches = 0
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
    launches = edt_bestfirst.launches
    log(f"main path: edt_bestfirst launches = {launches}")
    if launches != 2:
        raise AssertionError(f"the {GRID_N}^3 EDT launched the kernel {launches} "
                             "times, expected 2 (y and z passes)")
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
    phase_render(sdf, table, camera, fixed, early)
    del table, fixed, early
    phase_gradients()
    print(json.dumps({"kernels": [{
        "name": "edt_bestfirst",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": KERNEL_REPLACES,
        "launches": launches,
        "max_abs_err": max(err_cases, err_edt),
        # One 512^3 two-field EDT's two envelope passes (y + z), wrapper
        # included (chunk minima, z-pass transpose), against the plain
        # version of the same two passes.
        "ms": t_edt["kernel_y"] + t_edt["kernel_z"],
        "plain_ms": t_edt["plain_y"] + t_edt["plain_z"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
    sys.exit(0)
