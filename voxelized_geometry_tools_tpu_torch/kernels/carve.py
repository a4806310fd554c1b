"""Pointcloud carve, the voxel walk of every ray of a cloud counted into
int32 tracking grids: the CUDA kernel of ``csrc/carve.cu`` and its plain
PyTorch versions.

All take the per-ray setup as a :class:`RaySetup` (made by
``ops/voxelize.py::_ray_visits`` from ``_prepare_rays``) and walk each ray
for at most ``n_steps`` steps: one count per visited voxel into
``seen_free``, and the endpoint into ``seen_filled`` (or ``seen_free``
where the ray was range-clipped). The kernel replaces no TPU kernel: the
JAX package carves with XLA scatters inside while-loops
(``voxelized_geometry_tools_tpu/ops/voxelize.py::raycast_pointcloud``).

* :func:`carve_tiled` (the carve of every fusion path on the card): rays
  binned into grid tiles, each tile counted in shared memory and both
  grids written in full, zeros included; its four passes are one launch,
  counted in ``launches_tiled``. Its plain version
  :func:`carve_tiled_plain` cuts the walks into per-tile segments the same
  way and re-walks each from its saved state.
* :func:`carve_plain` is the walk itself, one step of every ray at a
  time, adding into grids the caller zeroed.

Integer adds commute, so every version gives the plain walk's bits.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import build

Tensor = torch.Tensor

__all__ = ["RaySetup", "TILE", "carve_plain", "carve_tiled",
           "carve_tiled_plain", "count_entries", "count_visits",
           "segment_steps", "tile_shape"]

# Launches of the tiled kernel (one a carve, its four passes together).
launches_tiled = 0

# The tiled kernel's tile extents (x, y, z), cut to the grid where it is
# smaller: 16,384 voxels, a tile of seen_free in 64 KiB of shared memory,
# rows of 64 int32 along z (whole 128-byte lines of the z-fastest layout);
# picked from kernels/carve_timings.py's sweep on the pipeline's cameras.
TILE = (16, 16, 64)

# The JAX package's walk runs in segments of this many steps and tests for
# live rays between them (``_DDA_SEGMENT``), so a step budget is rounded up
# to a whole number of segments.
SEGMENT = 64


class RaySetup(NamedTuple):
    """Per-ray walk inputs, all on one device."""
    start: Tensor      # int32 [N, 3] start voxel
    final: Tensor      # int32 [N, 3] final voxel (may lie outside the grid)
    step: Tensor       # int32 [N, 3] sign(final - start)
    t0: Tensor         # float32 [N, 3] time to leave the start voxel
    dt: Tensor         # float32 [N, 3] time per voxel, 0 where infinite
    hit: Tensor        # bool [N] the ray is walked
    end_flat: Tensor   # int32 [N] endpoint's flat index, -1 for none
    end_filled: Tensor  # bool [N] endpoint is marked filled, else free


def segment_steps(max_steps: int) -> int:
    """The walk's step budget: ``max_steps`` rounded up to whole segments."""
    return max(-(-int(max_steps) // SEGMENT), 0) * SEGMENT


def _add_ones(grid: Tensor, flat: Tensor) -> None:
    if flat.numel():
        grid.index_add_(0, flat.long(),
                        torch.ones_like(flat, dtype=grid.dtype))


def _mark_endpoints(setup: RaySetup, seen_free: Tensor,
                    seen_filled: Tensor) -> None:
    marked = setup.end_flat >= 0
    _add_ones(seen_free, setup.end_flat[marked & ~setup.end_filled])
    _add_ones(seen_filled, setup.end_flat[marked & setup.end_filled])


def _walk_steps(counts: Tuple[int, int, int], setup: RaySetup,
                n_steps: int, on_visit) -> None:
    """The voxel walk of ``_ray_visits`` in the JAX package, eagerly: per
    step, ``on_visit`` gets the flat indices of the voxels visited. Rays
    that have died are dropped at each segment boundary, where the JAX
    package tests whether any ray still walks."""
    nx, ny, nz = counts
    keep = setup.hit.nonzero().squeeze(1)
    cx, cy, cz = setup.start[keep].unbind(-1)
    fx, fy, fz = setup.final[keep].unbind(-1)
    sx, sy, sz = setup.step[keep].unbind(-1)
    tx0, ty0, tz0 = setup.t0[keep].unbind(-1)
    dtx, dty, dtz = setup.dt[keep].unbind(-1)
    kx = torch.zeros_like(cx)
    ky, kz = kx.clone(), kx.clone()
    active = torch.ones_like(cx, dtype=torch.bool)
    for s in range(n_steps):
        if s % SEGMENT == 0:
            live = active.nonzero().squeeze(1)
            if live.numel() == 0:
                break
            if live.numel() < active.numel():
                cx, cy, cz, fx, fy, fz, sx, sy, sz, tx0, ty0, tz0, dtx, dty, \
                    dtz, kx, ky, kz, active = (
                        v[live] for v in (cx, cy, cz, fx, fy, fz, sx, sy, sz,
                                          tx0, ty0, tz0, dtx, dty, dtz, kx,
                                          ky, kz, active))
        tx = tx0 + kx.to(torch.float32) * dtx
        ty = ty0 + ky.to(torch.float32) * dty
        tz = tz0 + kz.to(torch.float32) * dtz
        running = active & ((cx != fx) | (cy != fy) | (cz != fz))
        in_b = ((cx >= 0) & (cx < nx) & (cy >= 0) & (cy < ny)
                & (cz >= 0) & (cz < nz))
        alive = running & in_b
        on_visit((cx * (ny * nz) + cy * nz + cz)[alive])
        # Axis choice with the reference's tie-breaking (x, then y, then z).
        pick_x = (tx <= ty) & (tx <= tz)
        pick_y = ~pick_x & (ty <= tx) & (ty <= tz)
        pick_z = ~pick_x & ~pick_y
        at_final = torch.where(pick_x, cx == fx,
                               torch.where(pick_y, cy == fy, cz == fz))
        alive = alive & ~at_final
        adv_x, adv_y, adv_z = alive & pick_x, alive & pick_y, alive & pick_z
        cx = torch.where(adv_x, cx + sx, cx)
        cy = torch.where(adv_y, cy + sy, cy)
        cz = torch.where(adv_z, cz + sz, cz)
        kx = kx + adv_x.to(torch.int32)
        ky = ky + adv_y.to(torch.int32)
        kz = kz + adv_z.to(torch.int32)
        active = alive


def carve_plain(counts: Tuple[int, int, int], setup: RaySetup,
                n_steps: int, seen_free: Tensor, seen_filled: Tensor) -> None:
    """The walk in plain PyTorch, on any device: adds each ray's visits and
    endpoint into the flat int32 grids ``seen_free`` and ``seen_filled``
    (``[nx * ny * nz]``), in place."""
    _walk_steps(counts, setup, n_steps,
                lambda flat: _add_ones(seen_free, flat))
    _mark_endpoints(setup, seen_free, seen_filled)


def count_visits(counts: Tuple[int, int, int], setup: RaySetup,
                 n_steps: int) -> int:
    """How many voxel visits the walk makes, by the plain walk."""
    total = [0]

    def on_visit(flat):
        total[0] += flat.numel()

    _walk_steps(counts, setup, n_steps, on_visit)
    return total[0]


def tile_shape(counts: Tuple[int, int, int],
               tile: Tuple[int, int, int] = TILE) -> Tuple[int, int, int]:
    """The tile extents the tiled carve uses on a grid of ``counts``:
    ``tile`` cut to the grid."""
    if len(tile) != 3 or min(tile) < 1:
        raise ValueError(f"tile extents must be 3 positive ints, got {tile}")
    return tuple(min(int(e), int(n)) for e, n in zip(tile, counts))


def _tile_counts(counts, tile):
    return tuple(-(-n // e) for n, e in zip(counts, tile))


def entry_capacity(counts: Tuple[int, int, int], tile: Tuple[int, int, int],
                   n_rays: int, n_steps: int) -> int:
    """The tiled carve's bound on its tile lists' entries: a walk is
    monotone in every axis, so it enters at most ``1 + sum(tiles along an
    axis - 1)`` tiles, and no more than ``n_steps``; one entry more a ray
    for its endpoint."""
    per_ray = min(sum(_tile_counts(counts, tile)) - 2, max(int(n_steps), 0))
    return int(n_rays) * (per_ray + 1)


def _bin_segments(counts, tile, setup: RaySetup, n_steps: int):
    """The tiled carve's bin pass, on all rays at once: for each tile a
    walk enters, the ray and the voxel where it enters (each ray's segments
    in walk order). Per segment, each axis's first advance that ends the
    walk in the tile (leaving it, or its axis at its final coordinate) is
    found, the least of the three in the walk's order (time, then x, y, z)
    ends the segment, and the other axes' advances before it are counted by
    a binary search on their nondecreasing crossing times."""
    dev = setup.hit.device
    n = torch.tensor(counts, device=dev)
    e = torch.tensor(tile, device=dev)
    ray = setup.hit.nonzero().squeeze(1)
    c = setup.start[ray].long()
    f = setup.final[ray].long()
    sgn = setup.step[ray].long()
    ts, dd = setup.t0[ray], setup.dt[ray]
    k = torch.zeros_like(c)
    s = torch.zeros_like(ray)
    axes = torch.arange(3, device=dev)
    seg_ray, seg_c = [], []
    while ray.numel():
        live = ((s < n_steps) & ((c >= 0) & (c < n)).all(1)
                & ~(c == f).all(1))
        ray, c, f, sgn, ts, dd, k, s = (v[live] for v in (
            ray, c, f, sgn, ts, dd, k, s))
        if not ray.numel():
            break
        seg_ray.append(ray)
        seg_c.append(c)
        lo = torch.div(c, e, rounding_mode="floor") * e
        hi = torch.minimum(lo + e, n)
        to_final = (f - c).abs()
        in_tile = torch.where(sgn > 0, hi - 1 - c, c - lo)
        leaves = (sgn != 0) & (to_final > in_tile)
        m = torch.where(sgn == 0, torch.zeros_like(c),
                        torch.minimum(to_final, in_tile))
        te = ts + (k + m).to(torch.float32) * dd
        tx, ty, tz = te.unbind(1)
        ea = torch.where((tx <= ty) & (tx <= tz), 0,
                         torch.where((ty <= tx) & (ty <= tz), 1, 2))
        t_end = te.gather(1, ea[:, None]).squeeze(1)
        n_adv = m.clone()
        for b in range(3):
            lo_j, hi_j = torch.zeros_like(s), m[:, b].clone()
            while bool((lo_j < hi_j).any()):
                act = lo_j < hi_j
                mid = torch.div(lo_j + hi_j, 2, rounding_mode="floor")
                tb = ts[:, b] + (k[:, b] + mid).to(torch.float32) * dd[:, b]
                first = (tb < t_end) | ((tb == t_end) & (b < ea))
                lo_j = torch.where(act & first, mid + 1, lo_j)
                hi_j = torch.where(act & ~first, mid, hi_j)
            n_adv[:, b] = torch.where(ea == b, m[:, b], lo_j)
        s_end = s + n_adv.sum(1)
        go = (s_end < n_steps) & leaves.gather(1, ea[:, None]).squeeze(1)
        adv = n_adv + (axes[None, :] == ea[:, None]).long()
        c, k, s = c + adv * sgn, k + adv, s_end + 1
        ray, c, f, sgn, ts, dd, k, s = (v[go] for v in (
            ray, c, f, sgn, ts, dd, k, s))
    if not seg_ray:
        return ray, c
    return torch.cat(seg_ray), torch.cat(seg_c)


def count_entries(counts: Tuple[int, int, int], setup: RaySetup,
                  n_steps: int, tile: Tuple[int, int, int] = TILE
                  ) -> Tuple[int, int]:
    """The tiled carve's list entries, by its plain bin pass: (segments,
    endpoints)."""
    tile = tile_shape(counts, tile)
    seg_ray, _ = _bin_segments(counts, tile, setup, n_steps)
    return seg_ray.numel(), int((setup.end_flat >= 0).sum())


def carve_tiled_plain(counts: Tuple[int, int, int], setup: RaySetup,
                      n_steps: int, seen_free: Tensor, seen_filled: Tensor,
                      tile: Tuple[int, int, int] = TILE) -> None:
    """The tiled carve in plain PyTorch, on any device: its bin pass cuts
    each walk into per-tile segments (:func:`_bin_segments`), its tile pass
    re-walks each segment step by step from its saved state (crossing
    counters ``k = |c - start|``) until it leaves the tile or stops,
    counting into per-tile buffers with the endpoints, and every voxel of
    the flat int32 grids ``seen_free`` and ``seen_filled`` is written once
    from them. Equal to :func:`carve_plain` on zeroed grids."""
    tile = tile_shape(counts, tile)
    dev = setup.hit.device
    n = torch.tensor(counts, device=dev)
    e = torch.tensor(tile, device=dev)
    ntx, nty, ntz = _tile_counts(counts, tile)
    vol = tile[0] * tile[1] * tile[2]
    n_tiles = ntx * nty * ntz
    stride = torch.tensor((tile[1] * tile[2], tile[2], 1), device=dev)
    buf_free = torch.zeros(n_tiles * vol, dtype=torch.int32, device=dev)
    buf_filled = torch.zeros_like(buf_free)

    def place(c):
        """Each voxel's tile and its offset in the tile."""
        t = torch.div(c, e, rounding_mode="floor")
        tile_id = (t[:, 0] * nty + t[:, 1]) * ntz + t[:, 2]
        return tile_id, ((c - t * e) * stride).sum(1), t * e

    ray, c = _bin_segments(counts, tile, setup, n_steps)
    tile_id, local, lo = place(c)
    slot = tile_id * vol + local
    hi = torch.minimum(lo + e, n)
    f = setup.final[ray].long()
    sgn = setup.step[ray].long()
    ts, dd = setup.t0[ray], setup.dt[ray]
    k = (c - setup.start[ray].long()).abs()
    s = k.sum(1)
    t = ts + k.to(torch.float32) * dd
    while slot.numel():
        live = (s < n_steps) & ~(c == f).all(1)
        slot, c, f, sgn, ts, dd, k, s, t, lo, hi = (v[live] for v in (
            slot, c, f, sgn, ts, dd, k, s, t, lo, hi))
        _add_ones(buf_free, slot)
        tx, ty, tz = t.unbind(1)
        a = torch.where((tx <= ty) & (tx <= tz), 0,
                        torch.where((ty <= tx) & (ty <= tz), 1, 2))[:, None]
        go = (c.gather(1, a) != f.gather(1, a)).squeeze(1)
        pick = torch.arange(3, device=dev)[None, :] == a
        c = c + pick * sgn
        k = k + pick
        t = torch.where(pick, ts + k.to(torch.float32) * dd, t)
        slot = slot + (sgn * stride * pick).sum(1)
        s = s + 1
        ca = c.gather(1, a)
        go &= ((ca >= lo.gather(1, a)) & (ca < hi.gather(1, a))).squeeze(1)
        slot, c, f, sgn, ts, dd, k, s, t, lo, hi = (v[go] for v in (
            slot, c, f, sgn, ts, dd, k, s, t, lo, hi))
    marked = setup.end_flat >= 0
    end = setup.end_flat[marked].long()
    nyz = counts[1] * counts[2]
    end_c = torch.stack([end // nyz, end // counts[2] % counts[1],
                         end % counts[2]], 1)
    end_tile, end_local, _ = place(end_c)
    end_slot = end_tile * vol + end_local
    filled = setup.end_filled[marked]
    _add_ones(buf_free, end_slot[~filled])
    _add_ones(buf_filled, end_slot[filled])
    # Write out: the tiles laid side by side, cut to the grid; every voxel
    # once.
    for buf, grid in ((buf_free, seen_free), (buf_filled, seen_filled)):
        whole = buf.reshape(ntx, nty, ntz, *tile).permute(
            0, 3, 1, 4, 2, 5).reshape(ntx * tile[0], nty * tile[1],
                                      ntz * tile[2])
        grid.view(counts).copy_(
            whole[:counts[0], :counts[1], :counts[2]])


@functools.cache
def _library():
    lib = build.load_library("carve")
    lib.carve_tiled_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 7
        + [ctypes.c_void_p] * 2 + [ctypes.c_longlong]
        + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.carve_tiled_launch.restype = ctypes.c_int
    lib.carve_tile_chunk.argtypes = []
    lib.carve_tile_chunk.restype = ctypes.c_int
    lib.carve_tile_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.carve_tile_smem_bytes.restype = ctypes.c_longlong
    return lib


# Dynamic shared memory a block may opt into on the H100 (227 KiB).
MAX_SHARED_BYTES = 232_448


def _check(setup: RaySetup, seen_free: Tensor, seen_filled: Tensor,
           n_total: int) -> None:
    n = setup.hit.shape[0]
    want = {"start": (torch.int32, (n, 3)), "final": (torch.int32, (n, 3)),
            "step": (torch.int32, (n, 3)), "t0": (torch.float32, (n, 3)),
            "dt": (torch.float32, (n, 3)), "hit": (torch.bool, (n,)),
            "end_flat": (torch.int32, (n,)),
            "end_filled": (torch.bool, (n,))}
    for name, (dtype, shape) in want.items():
        t = getattr(setup, name)
        if t.device.type != "cuda":
            raise ValueError(f"carve kernel: {name} lies on {t.device}, "
                             "not on a CUDA device")
        if t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(f"carve kernel: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape}")
    for name, g in (("seen_free", seen_free), ("seen_filled", seen_filled)):
        if (g.device != setup.hit.device or g.dtype != torch.int32
                or tuple(g.shape) != (n_total,) or not g.is_contiguous()):
            raise ValueError(f"carve kernel: {name} must be a contiguous "
                             f"int32 [{n_total}] tensor on {setup.hit.device}")


def tile_smem_bytes(tile: Tuple[int, int, int]) -> int:
    """Shared memory the tile pass takes for ``tile``: a tile of
    ``seen_free``, int32."""
    return 4 * tile[0] * tile[1] * tile[2]


def _launch_tiled(counts, setup: RaySetup, n_steps: int, seen_free: Tensor,
                  seen_filled: Tensor, tile) -> dict:
    """The tiled kernel's four passes, uncounted. Returns its buffers:
    ``scratch`` (per-tile counts, then the lists' offsets, the last one the
    number of entries), ``entries`` and ``items`` (the tile pass's work
    items)."""
    nx, ny, nz = counts
    tile = tile_shape(counts, tile)
    smem = tile_smem_bytes(tile)
    if smem > MAX_SHARED_BYTES:
        raise ValueError(f"tile {tile} needs {smem} bytes of shared memory, "
                         f"above the {MAX_SHARED_BYTES} a block may take")
    _check(setup, seen_free, seen_filled, nx * ny * nz)
    if nx * ny * nz >= 2 ** 31:
        raise ValueError(f"grid {counts} has 2^31 voxels or more")
    lib = _library()
    if lib.carve_tile_smem_bytes(*tile) != smem:
        raise RuntimeError("carve.cu's tile shared memory differs from "
                           "tile_smem_bytes")
    n_rays = setup.hit.shape[0]
    capacity = entry_capacity(counts, tile, n_rays, n_steps)
    if capacity >= 2 ** 31:
        raise ValueError(f"{n_rays} rays in tiles {tile} of grid {counts} "
                         f"may need {capacity} list entries, 2^31 or more: "
                         "carve fewer rays at a time")
    dev = setup.hit.device
    n_tiles = 1
    for x in _tile_counts(counts, tile):
        n_tiles *= x
    scratch = torch.empty(4 * n_tiles + 3, dtype=torch.int32, device=dev)
    entries = torch.empty(max(capacity, 1), 2, dtype=torch.int32, device=dev)
    items = torch.empty(n_tiles - (-capacity // lib.carve_tile_chunk()), 2,
                        dtype=torch.int32, device=dev)
    err = lib.carve_tiled_launch(
        setup.start.data_ptr(), setup.final.data_ptr(),
        setup.step.data_ptr(), setup.t0.data_ptr(), setup.dt.data_ptr(),
        setup.hit.data_ptr(), setup.end_flat.data_ptr(),
        setup.end_filled.data_ptr(), n_rays, nx, ny, nz, *tile,
        int(n_steps), scratch.data_ptr(), entries.data_ptr(), capacity,
        items.data_ptr(), seen_free.data_ptr(), seen_filled.data_ptr(),
        dev.index or 0, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"tiled carve kernel launch failed "
                           f"(cudaError_t {err})")
    return {"scratch": scratch, "entries": entries, "items": items}


def carve_tiled(counts: Tuple[int, int, int], setup: RaySetup, n_steps: int,
                seen_free: Tensor, seen_filled: Tensor,
                tile: Tuple[int, int, int] = TILE) -> None:
    """One launch of the tiled kernel (its four passes, built at first use)
    on the current stream, without synchronizing: writes every voxel of the
    flat int32 grids ``seen_free`` and ``seen_filled`` (nothing need be
    zeroed first), as :func:`carve_tiled_plain`, for CUDA tensors only."""
    global launches_tiled
    _launch_tiled(counts, setup, n_steps, seen_free, seen_filled, tile)
    launches_tiled += 1
