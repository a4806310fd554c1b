"""Exact 1-D squared-distance transform along the last axis for ``f >= 0``,
outward walk: the CUDA kernel ``csrc/edt_windowed.cu`` (the counterpart of
the JAX package's ``parabolic_envelope_last_pallas_windowed``, backend
``"pallas-windowed"``) and its plain PyTorch version.

The kernel computes ``d[..., q] = min_k (q - k)^2 + f[..., k]`` exactly for
a float32 ``f >= 0`` (``+inf`` allowed, NaN not): its stop bound is
geometric only, so a negative value outside a tile's window can be missed,
as in the JAX package's kernel. The kernel does not check the sign. Every
EDT field is a squared distance, so it is never negative there. The plain
version, :func:`.edt_bestfirst.parabolic_envelope_last_plain` re-exported
here, is exact for any sign, so it equals the kernel only on ``f >= 0``.
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

__all__ = ["parabolic_envelope_last", "parabolic_envelope_last_plain"]

launches = 0


@functools.cache
def _launcher():
    fn = build.load_library("edt_windowed").edt_windowed_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + LINES_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def parabolic_envelope_last(f: Tensor) -> Tensor:
    """Exact squared-distance transform along the last axis of ``f >= 0``.
    On a CUDA tensor this launches the kernel (building it at first use) on
    the current stream, without synchronizing, or raises; on a CPU tensor it
    runs :func:`parabolic_envelope_last_plain`."""
    if f.device.type == "cpu":
        return parabolic_envelope_last_plain(f)

    def launch(ft, out, args):
        global launches
        err = _launcher()(ft.data_ptr(), out.data_ptr(), *args)
        if err == 0:
            launches += 1
        return err

    return launch_on_lines(f, "edt_windowed", launch)
