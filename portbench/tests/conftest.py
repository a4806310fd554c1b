"""Small sizes shared by the benchmark's CPU tests."""

import copy

import pytest

from portbench import registry


def merged(base: dict, over: dict) -> dict:
    """``over`` laid over ``base``; nested objects merge key by key."""
    out = dict(base)
    for k, v in over.items():
        both = isinstance(v, dict) and isinstance(out.get(k), dict)
        out[k] = merged(out[k], v) if both else v
    return out


def small(config: dict) -> dict:
    """``config`` at a size the CPU holds: a 32^3 grid over the same
    5.12 m room (0.16 m voxels), 64 x 48 images with the intrinsics scaled
    alike, 8 poses of the path; then the configuration's own
    ``rehearsal`` object, if it has one, merged over that, so that a
    configuration with keys of its own (a planner's query counts, say)
    sets their CPU sizes in its file."""
    c = copy.deepcopy(config)
    c["grid"] = {"counts": [32, 32, 32], "resolution": 0.16}
    c["camera"].update(width=64, height=48, fx=52.5, fy=52.5, cx=31.5,
                       cy=23.5)
    c["path"]["poses"] = 8
    return merged(c, c.get("rehearsal", {}))


def small_config(name: str) -> dict:
    """The benchmark's configuration ``name`` at its CPU size
    (``small``)."""
    return small(registry.config(registry.load_benchmark(), name))


@pytest.fixture
def cuda_device():
    """The card, or a skip where there is none."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
