"""Times of the full-sweep envelope kernel and the shared-memory gather
probe on one CUDA card, as one JSON line.

    python -m voxelized_geometry_tools_tpu_torch.kernels.kernel_timings LABEL

prints ``KERNEL_TIMINGS {...}``: the full-sweep backend's wrapper
(``edt_envelope.parabolic_envelope_last``, whichever variant the tree plans)
on the y and z passes of the main path's 512^3 two-field field, and the
gather probe (``probes.vmem_gather``, 4096 x 8 table, 100,000 rows) at one
replica and one per SM, timed queued (``probes.queued_ms``), beside
``torch.index_select`` of one replica's rows, with the card's name and
power limit and the SM clocks ``nvidia-smi`` read every 20 ms while the
envelope passes ran. It calls only entry points that every version of the
port since the probes' queued timing has, so two commits compare in one
call on one card: unpack the other commit's tree (``git archive REV | tar
x -C _scratch/parent``) and run, in turns from each tree's root, ``python3
-c "$(cat <this file>)" LABEL``.
"""

import json
import subprocess
import sys

import torch

from voxelized_geometry_tools_tpu_torch.kernels import edt_envelope, probes
from voxelized_geometry_tools_tpu_torch.kernels.edt_timings import (
    sphere_mask, stacked_passes)
from voxelized_geometry_tools_tpu_torch.kernels.probes import cuda_ms


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
    del fy, dz
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
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print("KERNEL_TIMINGS " + json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "tree")
