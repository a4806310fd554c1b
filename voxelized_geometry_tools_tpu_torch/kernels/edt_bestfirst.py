"""Exact 1-D squared-distance transform along the last axis: the CUDA
best-first kernel (``csrc/edt_bestfirst.cu``) and its plain PyTorch version.

Both compute ``d[..., q] = min_k (q - k)^2 + f[..., k]`` for a float32
``f`` of shape ``[..., n]`` (``+inf`` and negative values allowed, NaN not)
and agree bit for bit. :func:`parabolic_envelope_last` launches the kernel
for a CUDA tensor and takes the plain version only for a CPU tensor.
``launches`` counts kernel launches with hoisted chunk minima,
``launches_inkernel`` those with ``hoist_cmin=False``. The plain version and
the launch plumbing here are shared with :mod:`.edt_envelope` and
:mod:`.edt_windowed`.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import build

Tensor = torch.Tensor

# k rows per chunk and lines per warp; must match csrc/edt_common.cuh.
CHUNK = 16
WARP_LINES = 32
# Axis length limit of every envelope kernel; it bounds the best-first
# kernel's shared-memory bound table (4 warps x ceil(n / 16) floats).
MAX_N = 16384
# Cap on the plain version's [lines, n, block] candidate tensor (1 GiB f32).
PLAIN_CANDIDATES = 1 << 28

# Kernel launches with hoisted chunk minima, and with in-kernel minima.
launches = 0
launches_inkernel = 0


def parabolic_envelope_last_plain(f: Tensor, block: int = 512) -> Tensor:
    """Blocked min-plus, chunked over lines and over ``k`` so that the
    candidate tensor stays under ``PLAIN_CANDIDATES`` elements. Port of
    ``voxelized_geometry_tools_tpu/ops/edt.py::_parabolic_envelope_last``:
    each candidate is ``fl(fl((q - k)^2) + f)`` as there."""
    shape = f.shape
    n = shape[-1]
    f2 = f.reshape(-1, n)
    block = max(1, min(int(block), n))
    q = torch.arange(n, dtype=f.dtype, device=f.device)
    out = torch.empty_like(f2, memory_format=torch.contiguous_format)
    lines_per = max(1, PLAIN_CANDIDATES // (n * block))
    # Squared offsets (q - k)^2 per k block: exact small integers.
    dsq = []
    for k0 in range(0, n, block):
        k = torch.arange(k0, min(k0 + block, n), dtype=f.dtype,
                         device=f.device)
        delta = q[:, None] - k[None, :]
        dsq.append((k0, delta * delta))
    for s in range(0, f2.shape[0], lines_per):
        fl = f2[s:s + lines_per]
        d = None
        for k0, sq in dsq:
            fk = fl[:, None, k0:k0 + sq.shape[1]]
            cand = torch.amin(sq + fk, dim=-1)
            d = cand if d is None else torch.minimum(d, cand)
        out[s:s + lines_per] = d
    return out.reshape(shape)


def _chunk_minima(ft: Tensor) -> Tensor:
    """``min f`` over each (32-line block, 16-row chunk): ``[B, n_lb, n_ch]``.
    Ragged edges pad with ``+inf``, so each minimum is over real entries
    only. The counterpart of the XLA reduction that feeds the TPU kernel."""
    b, n, lines = ft.shape
    n_ch = -(-n // CHUNK)
    n_lb = -(-lines // WARP_LINES)
    pad_n, pad_l = n_ch * CHUNK - n, n_lb * WARP_LINES - lines
    x = ft
    if pad_n or pad_l:
        x = torch.nn.functional.pad(x, (0, pad_l, 0, pad_n),
                                    value=float("inf"))
    cm = torch.amin(x.reshape(b, n_ch, CHUNK, n_lb, WARP_LINES), dim=(2, 4))
    return cm.transpose(1, 2).contiguous()


# ctypes types of the arguments every envelope kernel's C entry point takes
# after its pointers: B, n, L, the three strides of f, device, stream.
LINES_ARGTYPES = [ctypes.c_longlong] * 6 + [ctypes.c_int, ctypes.c_void_p]


@functools.cache
def _launcher():
    lib = build.load_library("edt_bestfirst")
    lib.edt_bestfirst_chunk_rows.argtypes = []
    lib.edt_bestfirst_chunk_rows.restype = ctypes.c_int
    if lib.edt_bestfirst_chunk_rows() != CHUNK:
        raise RuntimeError("edt_bestfirst.cu and edt_bestfirst.py disagree "
                           "on the chunk size")
    fn = lib.edt_bestfirst_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + LINES_ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def launch_on_lines(f: Tensor, name: str, launch) -> Tensor:
    """The wrapper plumbing the envelope kernels share. Checks that ``f`` is
    a float32 CUDA tensor whose last axis is in ``[1, MAX_N]``, views it as
    ``[B, n, L]`` with the lines on the contiguous axis (a transposed copy
    only where they are not), allocates the contiguous output and calls
    ``launch(ft, out, args)`` once, where ``args`` are the trailing
    arguments of ``LINES_ARGTYPES``. ``launch`` starts the kernel on the
    current stream and returns its ``cudaError_t``; a non-zero one raises.
    Returns the result in ``f``'s shape; its strides follow the kernel's
    layout. An empty ``f`` launches nothing."""
    if f.device.type != "cuda":
        raise ValueError(f"unsupported device {f.device}")
    if f.dtype != torch.float32:
        raise TypeError(f"f must be float32, got {f.dtype}")
    if f.dim() == 0:
        raise ValueError("f must have at least one axis")
    n = f.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"axis length {n} outside [1, {MAX_N}]")
    if f.numel() == 0:
        return torch.empty_like(f)
    # [B, lines, n] -> [B, n, lines]: lines become the contiguous axis.
    f3 = f.reshape(-1, f.shape[-2] if f.dim() > 1 else 1, n)
    ft = f3.transpose(1, 2)
    if ft.stride(2) != 1 and ft.shape[2] > 1:
        ft = ft.contiguous()
    b, _, lines = ft.shape
    out = torch.empty((b, n, lines), dtype=torch.float32, device=f.device)
    err = launch(ft, out, (b, n, lines, *ft.stride(), f.device.index or 0,
                           torch.cuda.current_stream(f.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed (cudaError_t {err})")
    return out.transpose(1, 2).reshape(f.shape)


def parabolic_envelope_last(f: Tensor, hoist_cmin: bool = True) -> Tensor:
    """Exact squared-distance transform along the last axis of ``f``.

    On a CUDA tensor this launches the kernel (building it at first use) on
    the current stream, without synchronizing, or raises; it never falls
    back. ``hoist_cmin`` (as in the JAX package's
    ``parabolic_envelope_last_pallas_bestfirst``) takes the chunk minima
    from :func:`_chunk_minima`, computed once per call; without it the
    kernel reduces them itself. Both give the same bits. On a CPU tensor it
    runs :func:`parabolic_envelope_last_plain`."""
    if f.device.type == "cpu":
        return parabolic_envelope_last_plain(f)

    def launch(ft, out, args):
        global launches, launches_inkernel
        cmin = _chunk_minima(ft) if hoist_cmin else None
        err = _launcher()(ft.data_ptr(),
                          None if cmin is None else cmin.data_ptr(),
                          out.data_ptr(), *args)
        if err == 0 and hoist_cmin:
            launches += 1
        elif err == 0:
            launches_inkernel += 1
        return err

    return launch_on_lines(f, "edt_bestfirst", launch)
