"""Exact 1-D squared-distance transform along the last axis, full sweep: the
CUDA kernel ``csrc/edt_envelope.cu`` (the counterpart of the JAX package's
``parabolic_envelope_last_pallas``, backend ``"pallas"``) and its plain
PyTorch version.

Both compute ``d[..., q] = min_k (q - k)^2 + f[..., k]`` for a float32 ``f``
(``+inf`` and negative values allowed, NaN not) and agree bit for bit. The
plain version is :func:`.edt_bestfirst.parabolic_envelope_last_plain`,
re-exported here: all the envelope kernels compute the same function.
``launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .edt_bestfirst import (LINES_ARGTYPES, launch_on_lines,
                            parabolic_envelope_last_plain)

Tensor = torch.Tensor

__all__ = ["parabolic_envelope_last", "parabolic_envelope_last_plain",
           "squared_edt_envelope"]

launches = 0


@functools.cache
def _launcher():
    fn = build.load_library("edt_envelope").edt_envelope_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + LINES_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def parabolic_envelope_last(f: Tensor) -> Tensor:
    """Exact squared-distance transform along the last axis of ``f``, every
    candidate visited. On a CUDA tensor this launches the kernel (building
    it at first use) on the current stream, without synchronizing, or
    raises; on a CPU tensor it runs :func:`parabolic_envelope_last_plain`."""
    if f.device.type == "cpu":
        return parabolic_envelope_last_plain(f)

    def launch(ft, out, args):
        global launches
        err = _launcher()(ft.data_ptr(), out.data_ptr(), *args)
        if err == 0:
            launches += 1
        return err

    return launch_on_lines(f, "edt_envelope", launch)


def squared_edt_envelope(seed: Tensor) -> Tensor:
    """3-D squared EDT with the full-sweep envelope on axes 1 and 2 (the
    counterpart of the JAX package's ``squared_edt_pallas``): axis 0 takes
    the binary prefix-scan pass of :mod:`..ops.edt`, which needs no
    kernel."""
    from ..ops.edt import _binary_squared_dist_last

    seed = seed.bool()
    d = _binary_squared_dist_last(seed.movedim(0, -1)).movedim(-1, 0)
    if seed.shape[1] > 1:
        d = parabolic_envelope_last(d.movedim(1, -1)).movedim(-1, 1)
    if seed.shape[2] > 1:
        d = parabolic_envelope_last(d)
    return d
