"""Times of the envelope kernels and the shared-memory gather and
batched-march probes on one CUDA card, as one JSON line.

    python -m voxelized_geometry_tools_tpu_torch.kernels.kernel_timings LABEL

prints ``KERNEL_TIMINGS {...}``: the full-sweep, windowed and best-first
backends' wrappers (``parabolic_envelope_last`` of ``edt_envelope``,
``edt_windowed`` and ``edt_bestfirst``, whichever variant the tree plans)
on the y and z passes of the main path's 512^3 two-field field; the
best-first wrapper with either ``hoist_cmin`` and its forced global variant
(hoisted minima) on the y and z passes of ``chip_smoke.py``'s [4, 2048,
2048] grid (a disk and a box), and, where the tree has a clustered variant,
that variant forced to each cluster size; and the gather probe
(``probes.vmem_gather``, 4096 x 8 table, 100,000 rows) at one replica and
one per SM, timed queued (``probes.queued_ms``), beside
``torch.index_select`` of one replica's rows; the march probe
(``probes.vmem_batch_march``, 4096 x 8 table, 64 steps) at batches 64 and
256, one replica and one per SM, and with no steps (its fixed cost), timed
queued, and, where the tree has the route split, each route forced there,
both routes at replica counts in between, each route's CTA sweep at one
replica, and the staged route's fixed cost at one replica per SM by each
way of staging (no steps: a batch of 1,024 rays fills its CTA, which stages
by register loads, one of 1,000 does not, which stages by bulk copies);
with the card's name and power limit and the SM clocks
``nvidia-smi`` read every 20 ms while the full-sweep passes ran. It calls
only entry points that every version of the port since the probes' queued
timing has (the clustered variant and the march's routes only where they
exist), so two commits compare in one call on one card: unpack
the other commit's tree (``git archive REV | tar x -C _scratch/parent``)
and run, in turns from each tree's root, ``python3 -c "$(cat <this
file>)" LABEL``.
"""
import functools
import json
import subprocess
import sys

import torch

from voxelized_geometry_tools_tpu_torch.kernels import (edt_bestfirst,
                                                       edt_envelope,
                                                       edt_windowed, probes)
from voxelized_geometry_tools_tpu_torch.kernels.edt_timings import (
    sphere_mask, stacked_passes)
from voxelized_geometry_tools_tpu_torch.kernels.probes import cuda_ms


def long_axis_times() -> dict:
    """The best-first kernel's passes on the [4, 2048, 2048] grid of
    ``chip_smoke.py``'s ``phase_global_variant``."""
    n = 2048
    ax = torch.arange(n, device="cuda", dtype=torch.float32)
    mask = (((ax[:, None] - 0.4 * n) ** 2 + (ax[None, :] - 0.6 * n) ** 2
             <= (0.2 * n) ** 2)[None].expand(4, n, n).clone())
    mask[:, 50:90, 1500:1900] = True
    fy, dz = stacked_passes(mask)[:2]
    eb = edt_bestfirst
    fns = {f"hoist_{h}": functools.partial(eb.parabolic_envelope_last,
                                           hoist_cmin=h)
           for h in (True, False)}
    fns["global"] = eb.parabolic_envelope_last_global
    if hasattr(eb, "parabolic_envelope_last_cluster"):
        for c in eb.CLUSTER_SIZES:
            fns[f"cluster_{c}"] = functools.partial(
                eb.parabolic_envelope_last_cluster, cluster=c)
    out = {}
    for key, fn in fns.items():
        for name, x in (("y", fy), ("z", dz)):
            out[f"bestfirst2048_{key}_{name}_ms"] = cuda_ms(lambda: fn(x), 20)
    return out


def march_times(full: int) -> dict:
    """The march probe's queued times (see the module docstring)."""
    dev = torch.device("cuda")
    table = probes.integer_table(probes.TABLE_ROWS, probes.WIDTH, dev)
    split = getattr(probes, "vmem_batch_march_split", None)
    out = {}
    for batch in probes.MARCH_BATCHES:
        t0 = torch.zeros(1, batch, device=dev)
        key = f"march_b{batch}"
        for reps in (1, full):
            out[f"{key}_{reps}_replicas_ms"] = probes.queued_ms(
                lambda: probes.vmem_batch_march(table, t0, probes.MARCH_STEPS,
                                                reps))
        out[f"{key}_no_steps_ms"] = probes.queued_ms(
            lambda: probes.vmem_batch_march(table, t0, 0))
        if split is None:
            continue
        for route in probes.MARCH_ROUTES:
            for reps in (1, 8, 33, 66, full):
                out[f"{key}_{route}_{reps}_replicas_ms"] = probes.queued_ms(
                    lambda: split(table, t0, probes.MARCH_STEPS, route, None,
                                  reps))
            out[f"{key}_{route}_no_steps_ms"] = probes.queued_ms(
                lambda: split(table, t0, 0, route, None))
            out[f"{key}_{route}_cta_sweep_ms"] = {
                ctas: probes.queued_ms(lambda: split(
                    table, t0, probes.MARCH_STEPS, route, ctas))
                for ctas in (4, 8, 16, 32, 64, 128) if ctas <= batch}
    if split is not None:
        for how, batch in (("loads", 1024), ("bulk", 1000)):
            t0 = torch.zeros(1, batch, device=dev)
            out[f"march_staged_{full}_replicas_no_steps_{how}_ms"] = \
                probes.queued_ms(lambda: split(table, t0, 0, "staged", None,
                                               full))
    return out


def main(label: str) -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("kernel_timings: no CUDA device")
    out = {"label": label}
    fy, dz = stacked_passes(sphere_mask(512, "cuda"))[:2]
    clocks = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm",
         "--format=csv,noheader,nounits", "-lms", "20"],
        stdout=subprocess.PIPE, text=True)
    try:
        for name, x in (("y", fy), ("z", dz)):
            out[f"envelope_{name}_ms"] = cuda_ms(
                lambda: edt_envelope.parabolic_envelope_last(x), 10)
    finally:
        clocks.terminate()
    out["envelope_sm_mhz"] = [int(v) for v in clocks.communicate()[0].split()]
    for name, x in (("y", fy), ("z", dz)):
        out[f"windowed_{name}_ms"] = cuda_ms(
            lambda: edt_windowed.parabolic_envelope_last(x), 10)
        out[f"bestfirst_{name}_ms"] = cuda_ms(
            lambda: edt_bestfirst.parabolic_envelope_last(x), 10)
    del fy, dz
    out.update(long_axis_times())
    dev = torch.device("cuda")
    full = torch.cuda.get_device_properties(dev).multi_processor_count
    table = probes.integer_table(probes.TABLE_ROWS, probes.WIDTH, dev)
    for reps in (1, full):
        out[f"gather_{reps}_replicas_ms"] = probes.queued_ms(
            lambda: probes.vmem_gather(table, probes.GATHER_ITERS, reps))
    rows = torch.from_numpy(probes.lcg_indices(
        probes.GATHER_SEED, probes.GATHER_ITERS, probes.TABLE_ROWS)).to(dev)
    out["index_select_ms"] = probes.queued_ms(
        lambda: torch.index_select(table, 0, rows))
    out.update(march_times(full))
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("KERNEL_TIMINGS " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
