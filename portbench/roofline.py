"""Published peaks of the card and the bytes each measured kernel needs.

A roofline share is the least time the card could take for a call (the
bytes it must move at the published HBM rate) over the device time the
call took, in percent. The bytes count each input read once and each
output written once, whatever the kernel reads again.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM data sheet, at the full 700 W power limit.
H100_HBM_BYTES_PER_S = 3.35e12
H100_FP32_FLOPS = 67e12

# The carve kernel's per-ray inputs: start, final and step voxels (3 x 3
# int32), crossing time and time per voxel (2 x 3 float32), the hit flag
# (bool), the endpoint's flat index (int32) and its filled flag (bool).
CARVE_RAY_BYTES = 3 * 12 + 2 * 12 + 1 + 4 + 1


def carve_bytes(n_rays: int, counts) -> int:
    """One carve of ``n_rays`` into fresh ``seen_free`` / ``seen_filled``
    int32 grids of ``counts``: the rays read once, both grids written
    once."""
    return CARVE_RAY_BYTES * int(n_rays) + 2 * 4 * math.prod(counts)


def edt_pass_bytes(counts, fields: int = 2) -> int:
    """One envelope pass of the EDT over ``fields`` float32 fields of
    ``counts``: each read once and written once."""
    return 2 * fields * 4 * math.prod(counts)


def bound_seconds(n_bytes: int) -> float:
    return n_bytes / H100_HBM_BYTES_PER_S


def share_percent(bound_s: float, device_s: float):
    """``100 * bound / time``, or None when nothing was timed."""
    if device_s <= 0.0:
        return None
    return 100.0 * bound_s / device_s
