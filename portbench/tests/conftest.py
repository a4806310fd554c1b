"""Small sizes shared by the benchmark's CPU tests."""

import copy

import pytest

from portbench import registry


def small_config(name: str) -> dict:
    """A configuration of the benchmark at a size the CPU holds: a 32^3
    grid over the same 5.12 m room (0.16 m voxels), 64 x 48 images with
    the intrinsics scaled alike, 8 poses of the path."""
    bench = registry.load_benchmark()
    c = copy.deepcopy(registry.config(bench, name))
    c["grid"] = {"counts": [32, 32, 32], "resolution": 0.16}
    c["camera"].update(width=64, height=48, fx=52.5, fy=52.5, cx=31.5,
                       cy=23.5)
    c["path"]["poses"] = 8
    return c


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
