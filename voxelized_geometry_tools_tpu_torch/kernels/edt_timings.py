"""The EDT path's scenes and fields, and its times on one CUDA card as one
JSON line.

    python -m voxelized_geometry_tools_tpu_torch.kernels.edt_timings LABEL

prints ``EDT_TIMINGS {...}``: the best-first wrapper's y- and z-pass times
on the main path's 512^3 two-field field (``bench.py``'s sphere), the
512^3 two-field signed EDT, and the streamed 1024^3 signed EDT's time, its
peak device memory and the part of that peak the call itself allocated
(the peak less what was held before it), with the card's name and power
limit. It calls only entry points that every version of the port has, so
two commits compare in one call on one card: unpack the other commit's tree
(``git archive REV | tar x -C _scratch/parent``) and run, in turns from
each tree's root, ``python3 -c "$(cat <this file>)" LABEL``.
``chip_smoke.py`` takes its scenes and fields from here.
"""

import json
import subprocess
import sys

import torch

from voxelized_geometry_tools_tpu_torch.kernels import edt_bestfirst
from voxelized_geometry_tools_tpu_torch.kernels.probes import cuda_ms
from voxelized_geometry_tools_tpu_torch.ops import edt


def sphere_mask(n, device):
    """``bench.py``'s scene: a sphere of radius n/4 voxels centered at n/2."""
    ax = torch.arange(n, device=device, dtype=torch.float32)
    c, r = n / 2.0, n / 4.0
    return ((ax[:, None, None] - c) ** 2 + (ax[None, :, None] - c) ** 2
            + (ax[None, None, :] - c) ** 2) <= r * r


def large_sphere_mask(n, device):
    """``benchmarks/large_grid.py``'s scene: a centered sphere of radius n/4
    voxels."""
    ax = (torch.arange(n, device=device, dtype=torch.float32)
          - (n - 1) / 2.0) ** 2
    return (ax[:, None, None] + ax[None, :, None]
            + ax[None, None, :]) <= (n / 4.0) ** 2


def stacked_passes(mask):
    """The two-field [2 nx, ny, nz] field of ``mask`` after the binary x
    pass, as the y pass reads it (a moved view) and as the z pass reads it,
    with each pass's result: ``(fy, dz, ry, rz)``."""
    d = torch.cat([
        edt._binary_squared_dist_last(m.movedim(0, -1)).movedim(-1, 0)
        for m in (mask, ~mask)])
    fy = d.movedim(1, -1)
    ry = edt_bestfirst.parabolic_envelope_last(fy)
    dz = ry.movedim(-1, 1)
    return fy, dz, ry, edt_bestfirst.parabolic_envelope_last(dz)


def main(label: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("edt_timings: no CUDA device")
    out = {"label": label}
    mask = sphere_mask(512, "cuda")
    fy, dz = stacked_passes(mask)[:2]
    out["y_ms"] = cuda_ms(lambda: edt_bestfirst.parabolic_envelope_last(fy),
                          10)
    out["z_ms"] = cuda_ms(lambda: edt_bestfirst.parabolic_envelope_last(dz),
                          10)
    out["edt512_ms"] = cuda_ms(
        lambda: edt.signed_distance_from_filled_mask(mask, 0.01), 5)
    del fy, dz, mask
    big = large_sphere_mask(1024, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    res = edt.signed_distance_from_filled_mask_streamed(big, 0.01)
    torch.cuda.synchronize()
    out["streamed_peak_bytes"] = torch.cuda.max_memory_allocated()
    out["streamed_growth_bytes"] = out["streamed_peak_bytes"] - before
    del res
    out["streamed1024_ms"] = cuda_ms(
        lambda: edt.signed_distance_from_filled_mask_streamed(big, 0.01), 3)
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("EDT_TIMINGS " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
