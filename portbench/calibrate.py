"""Readings for a cell's limits: the program's compared numbers and the
control's, seed by seed, in one process.

    python3 -m portbench.calibrate --workload <cell> --seconds <s> \
        --seeds <n> [<n> ...] [--control bfloat16]

The control is the plain reference computed in the precision below the
configuration's (float32 -> bfloat16), standing where the program's
outputs stood. One JSON line per seed: ``program`` and ``control``.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

import torch  # noqa: E402

from . import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", default="bfloat16")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.calibrate: no CUDA card", file=sys.stderr)
        return 3
    control = getattr(torch, args.control)
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = harness.run_cell(args.workload, seed, args.seconds, False,
                             t0, control=control)
        print(json.dumps({
            "seed": seed, "frames": r["attempted"],
            "program": {k: v["value"] for k, v in r["checks"].items()},
            "control": r["control"],
            "frame_ms_p95": r["metrics"].get("frame_ms_p95", {}).get("value"),
            "setup_s": r["metrics"].get("setup_s", {}).get("value"),
            "peak": r["device"]["memory_peak_bytes"],
            "seconds": time.perf_counter() - t0}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
