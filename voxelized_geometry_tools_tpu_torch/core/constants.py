"""Constant tensors, made once per (value, dtype, device) and then reused.

On a CUDA device, ``torch.tensor`` of host data is a pageable copy that
waits for the device to drain, so a query that builds its constants afresh
stalls the launch queue several times per call. Every constant of the hot
paths comes from :func:`constant` instead. The tensors are shared: never
write to one.
"""

from __future__ import annotations

import torch

_CACHE = {}


def constant(value, dtype, device) -> torch.Tensor:
    """``torch.tensor(value, dtype=dtype, device=device)``, cached; ``value``
    is a number or a (nested) tuple of numbers."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    # repr keys the value exactly (a NaN equals no other NaN).
    key = (repr(value), dtype, device)
    t = _CACHE.get(key)
    if t is None:
        # A normal tensor even when first asked for under inference mode,
        # so that autograd may save it later.
        with torch.inference_mode(False):
            t = _CACHE[key] = torch.tensor(value, dtype=dtype, device=device)
    return t
