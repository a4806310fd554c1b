"""The port's default device: the CUDA card.

Every entry point that makes tensors from host data (numpy arrays, Python
numbers) or from nothing takes ``device``; ``None`` means the card, and a
tensor given as data keeps its own device. Without a card, the default
raises instead of falling back to the CPU: code that means the CPU says
``device="cpu"``.
"""

from __future__ import annotations

import torch


def default_device(device=None, like=None) -> torch.device:
    """``device`` as a ``torch.device``; when it is None, the device of
    ``like`` if that is a tensor, else the CUDA card. Raises
    ``RuntimeError`` when that card is wanted and there is none."""
    if device is not None:
        return torch.device(device)
    if isinstance(like, torch.Tensor):
        return like.device
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: voxelized_geometry_tools_tpu_torch runs on the "
            'card unless told otherwise; pass device="cpu" to run on the CPU')
    return torch.device("cuda")
