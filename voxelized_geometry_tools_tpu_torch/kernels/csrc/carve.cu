// Pointcloud carve: the voxel walk of every ray of one cloud, counted into
// int32 tracking grids (Hopper, sm_90a): carve_tiled, rays binned into grid
// tiles, each tile counted in shared memory and written once, zeros
// included.
//
// Replaces no TPU kernel. The JAX package carves with XLA scatters inside
// while-loops (voxelized_geometry_tools_tpu/ops/voxelize.py::
// raycast_pointcloud and its column twin), shaped around the TPU's scatter
// engine; run eagerly in PyTorch each loop step costs tens of launches. The
// reference library's CUDA backend carves with one thread per ray and
// atomicAdd into device memory.
//
// What it computes, per ray r, bit for bit as the plain walk
// kernels/carve.py::carve_plain does:
// * the endpoint mark: end_flat[r] >= 0 adds one to seen_filled there if
//   end_filled[r], else to seen_free (a range-clipped endpoint is free);
// * for a ray with hit[r], the walk from start to final: each step visits
//   the current voxel (one count into seen_free) while it is in the grid
//   and not the final voxel, then advances the axis whose closed-form
//   crossing time t = t0 + float(k) * dt is least (ties x >= y >= z), and
//   stops where that axis already holds its final coordinate, or after
//   n_steps steps (the caller's budget, a whole number of 64-step segments).
// The per-ray setup (start and final voxels, step signs, t0, the safe
// deltas dt, the endpoint) is computed by the wrapper in PyTorch, with the
// same functions as the plain walk, so the kernel repeats no float setup.
// Each t is one rounded multiply and one rounded add (__fmul_rn,
// __fadd_rn, and the build's --fmad=false), as PyTorch rounds them.
// Integer adds commute, so the order of the adds does not change a bit.
//
// What bounds it on the H100. Its floor is its bytes: 66 bytes of inputs a
// ray read once and both int32 grids written once (chip_smoke.py's
// carve_bound); the visits cost less at the int32 add rate.
//
// carve_tiled counts each tile of the grid on chip, so that no voxel is
// zeroed first or read back by a device-memory atomic, and writes every
// voxel once, in four passes:
// 1. count: one thread a ray finds the tiles its walk enters and counts
//    one entry a tile (warp-aggregated atomics), plus its endpoint's. It
//    does not walk step by step: a walk is the merge of three nondecreasing
//    sequences of crossing times, one an axis (t = t0 + float(k) * dt,
//    monotone in k under round-to-nearest), taken in (t, axis) order. In a
//    tile each axis has a first advance that ends the walk there (it would
//    leave the tile, or its axis already holds its final coordinate); the
//    least of those three, E, ends the segment, and the other axes'
//    advances before E are counted on their sequences (from an estimate,
//    stepped to the exact count). So the pass costs a few crossing times a
//    segment, not one a step, and lands in the same voxel, with the same
//    crossing counters, as the walk.
// 2. scan: one block turns the counts into each tile's first entry and
//    lists the tile pass's work items: each tile with entries once (its
//    owner), each further CHUNK entries of it once more (its helpers),
//    and, spread evenly between them, the tiles without entries.
// 3. fill: the count pass again, writing each entry into its tile's list:
//    a segment is (ray, the voxel where the walk enters the tile), an
//    endpoint (-1 free / -2 filled, its voxel). The crossing counters need
//    not be stored: an axis steps by +-1, so k = |c - start|.
// 4. tile: persistent blocks take work items from a queue. An owner zeroes
//    the tile of seen_free in shared memory, re-walks the segments of its
//    chunk step by step from their saved state until they leave the tile
//    or stop, adding into shared memory, adds the free endpoints, and
//    stores the tile whole with 16-byte coalesced stores, with zeros for
//    the tile of seen_filled; a tile without entries is a store of zeros. A
//    helper counts its chunk the same way, then adds its nonzero counts
//    into the stored tile with device-memory atomics (in L2, where the
//    owner's stores just went), so that a tile crowded with rays (near the
//    camera, where every ray passes) is counted by many blocks. Filled
//    endpoints, few and scattered, are added with atomics after the tile is
//    stored.
// Every voxel of both grids is stored exactly once, so the caller zeroes
// nothing; only a helper's counts and the filled endpoints are added to
// what was stored. The entry lists are sized by an exact bound: a walk is
// monotone in every axis, so it enters at most 1 + sum(tiles along the
// axis - 1) tiles, and no more than its step budget; one more entry a ray
// holds its endpoint. The wrapper allocates n_rays times that, so no list
// overflows (a write past it would be skipped, never made).

#include <cuda_runtime.h>

namespace {

// The tile pass's block size, its registers held to 64 a thread (so that
// 1,024 threads an SM fit), and the most list entries a block counts of
// one tile (a tile with more is shared by an owner and helpers), picked
// from kernels/carve_timings.py's sweep on the pipeline's cameras.
constexpr int TILE_THREADS = 512;
constexpr int CHUNK = 4096;
constexpr int BIN_THREADS = 256;
constexpr int SCAN_THREADS = 1024;
constexpr int SCAN_ITEMS = 8;
// Entry kinds in a tile's list (a segment's first word is its ray, >= 0).
constexpr int END_FREE = -1;
constexpr int END_FILLED = -2;

// The grid and its tiles: extents e, counts of tiles nt (the last tile of
// an axis may be clipped by the grid).
struct Tiles {
  int n[3];
  int e[3];
  int nt[3];
};

__device__ __forceinline__ float cross_time(float t0, int k, float dt) {
  return __fadd_rn(t0, __fmul_rn(static_cast<float>(k), dt));
}

// Whether axis b's advance with crossing time tb comes before the event
// (te, axis a) in the walk's order: earlier time, or the same time and a
// lower axis (ties go x, then y, then z).
__device__ __forceinline__ bool before(float tb, int b, float te, int a) {
  return tb < te || (tb == te && b < a);
}

// How many of axis b's advances k, ..., k + m - 1 come before the event
// (te, axis a) in the walk's order. Their crossing times are nondecreasing,
// so the answer is where a monotone test turns false: found from the
// estimate (te - t0) / dt and stepped to exactly, one crossing time a step
// (a binary search where there is no estimate).
__device__ __forceinline__ int advances_before(float ts, float dd, int k,
                                               int m, int b, float te,
                                               int a) {
  if (m == 0) return 0;
  if (dd == 0.f) return before(ts, b, te, a) ? m : 0;
  const float est = ceilf((te - ts) / dd) - static_cast<float>(k);
  int j;
  if (est == est && fabsf(est) < 1e9f) {
    j = est <= 0.f ? 0 : est >= static_cast<float>(m) ? m
                                                      : static_cast<int>(est);
    while (j > 0 && !before(cross_time(ts, k + j - 1, dd), b, te, a)) --j;
    while (j < m && before(cross_time(ts, k + j, dd), b, te, a)) ++j;
    return j;
  }
  int lo = 0, hi = m;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (before(cross_time(ts, k + mid, dd), b, te, a))
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// One index in `counters[key]` for this lane, the lanes of the warp that
// pass the same key sharing one atomic.
__device__ __forceinline__ int aggregated_slot(int* counters, int key) {
  const unsigned active = __activemask();
  const unsigned peers = __match_any_sync(active, key);
  const int leader = __ffs(peers) - 1;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == leader) base = atomicAdd(counters + key, __popc(peers));
  base = __shfl_sync(peers, base, leader);
  return base + __popc(peers & ((1u << lane) - 1u));
}

template <bool FILL>
__device__ __forceinline__ void emit(int* counters, int2* entries,
                                     long long capacity, int tile, int a,
                                     int b) {
  const int slot = aggregated_slot(counters, tile);
  if (FILL && slot < capacity) entries[slot] = make_int2(a, b);
}

// Pass 1 (FILL = false: counters are the per-tile counts) and pass 3
// (FILL = true: counters are the per-tile cursors, starting at each tile's
// first entry), one thread a ray.
template <bool FILL>
__global__ void __launch_bounds__(BIN_THREADS)
carve_bin_kernel(const int* __restrict__ start, const int* __restrict__ fin,
                 const int* __restrict__ step, const float* __restrict__ t0,
                 const float* __restrict__ dt, const bool* __restrict__ hit,
                 const int* __restrict__ end_flat,
                 const bool* __restrict__ end_filled, long long n_rays,
                 Tiles g, int n_steps, int* counters, int2* entries,
                 long long capacity) {
  const long long r = blockIdx.x * static_cast<long long>(BIN_THREADS) +
                      threadIdx.x;
  if (r >= n_rays) return;
  const int lane = threadIdx.x & 31;
  const int nyz = g.n[1] * g.n[2];
  const int e_flat = end_flat[r];
  if (e_flat >= 0) {
    const int c[3] = {e_flat / nyz, (e_flat / g.n[2]) % g.n[1],
                      e_flat % g.n[2]};
    int tile = 0, local = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int ta = c[a] / g.e[a];
      tile = tile * g.nt[a] + ta;
      local = local * g.e[a] + (c[a] - ta * g.e[a]);
    }
    emit<FILL>(counters, entries, capacity, tile,
               end_filled[r] ? END_FILLED : END_FREE, local);
  }
  if (!hit[r]) return;
  const long long i = 3 * r;
  int c[3], f[3], sgn[3], k[3] = {0, 0, 0};
  float ts[3], dd[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c[a] = start[i + a];
    f[a] = fin[i + a];
    sgn[a] = step[i + a];
    ts[a] = t0[i + a];
    dd[a] = dt[i + a];
  }
  // The tile of the current voxel, along each axis (the walk changes one
  // at a time, by one).
  int ti[3];
#pragma unroll
  for (int a = 0; a < 3; ++a)
    ti[a] = c[a] >= 0 && c[a] < g.n[a] ? c[a] / g.e[a] : -1;
  int s = 0;
  while (s < n_steps) {
    bool inside = true, at_final = true;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      inside = inside && c[a] >= 0 && c[a] < g.n[a];
      at_final = at_final && c[a] == f[a];
    }
    if (!inside || at_final) break;
    int tile = 0, local = 0, lo[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = ti[a] * g.e[a];
      tile = tile * g.nt[a] + ti[a];
      local = local * g.e[a] + (c[a] - lo[a]);
    }
    // This segment's slot in its tile's list: the lanes that enter the same
    // tile share one atomic, whose result is read only after the segment's
    // end is found (the fill pass writes the entry there).
    const unsigned peers = __match_any_sync(__activemask(), tile);
    const int leader = __ffs(peers) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counters + tile, __popc(peers));
    // Each axis's advances in this tile before its ending one (m), whether
    // that one leaves the tile (else the axis is at its final coordinate),
    // and its crossing time.
    int m[3];
    bool leaves[3];
    float te[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int hi = min(lo[a] + g.e[a], g.n[a]);
      const int to_final = abs(f[a] - c[a]);
      const int in_tile = sgn[a] > 0 ? hi - 1 - c[a] : c[a] - lo[a];
      leaves[a] = sgn[a] != 0 && to_final > in_tile;
      m[a] = sgn[a] == 0 ? 0 : min(to_final, in_tile);
      te[a] = cross_time(ts[a], k[a] + m[a], dd[a]);
    }
    // E: the first ending advance in the walk's order.
    const int ea = (te[0] <= te[1] && te[0] <= te[2]) ? 0
                   : (te[1] <= te[0] && te[1] <= te[2]) ? 1 : 2;
    const float t_end = ea == 0 ? te[0] : ea == 1 ? te[1] : te[2];
    const bool exits = ea == 0 ? leaves[0] : ea == 1 ? leaves[1] : leaves[2];
    int n_adv[3];
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      if (b == ea) {
        n_adv[b] = m[b];
        continue;
      }
      n_adv[b] = advances_before(ts[b], dd[b], k[b], m[b], b, t_end, ea);
    }
    if (FILL) {
      const int slot = __shfl_sync(peers, base, leader) +
                       __popc(peers & ((1u << lane) - 1u));
      if (slot < capacity)
        entries[slot] = make_int2(static_cast<int>(r), local);
    }
    const int s_end = s + n_adv[0] + n_adv[1] + n_adv[2];
    if (s_end >= n_steps || !exits) break;
#pragma unroll
    for (int b = 0; b < 3; ++b) {
      const int adv = n_adv[b] + (b == ea ? 1 : 0);
      c[b] += adv * sgn[b];
      k[b] += adv;
      if (b == ea) ti[b] += sgn[b];
    }
    s = s_end + 1;
  }
}

// Exclusive prefixes over the block of Q values a thread (in thread
// order) and the block's totals. Every thread of the block calls it.
template <int Q>
__device__ __forceinline__ void block_scan(const int (&v)[Q],
                                           int (&prefix)[Q],
                                           int (&total)[Q]) {
  __shared__ int warp_sum[Q][SCAN_THREADS / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    incl[q] = v[q];
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, incl[q], d);
      if (lane >= d) incl[q] += u;
    }
    if (lane == 31) warp_sum[q][warp] = incl[q];
  }
  __syncthreads();
  if (warp == 0) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      int w = warp_sum[q][lane];
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int u = __shfl_up_sync(0xffffffffu, w, d);
        if (lane >= d) w += u;
      }
      warp_sum[q][lane] = w;
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    prefix[q] = incl[q] - v[q] + (warp > 0 ? warp_sum[q][warp - 1] : 0);
    total[q] = warp_sum[q][SCAN_THREADS / 32 - 1];
  }
  __syncthreads();  // warp_sum is reused by the next call
}

__device__ __forceinline__ int chunks_of(int entries) {
  return (entries + CHUNK - 1) / CHUNK;
}

// The queue merges the w work items and the e stores of empty tiles in the
// order of (i + 1/2) / w and (k + 1/2) / e (work first on a tie): before
// work item i come empty_before(i) stores, before store k work_before(k)
// work items.
__device__ __forceinline__ int empty_before(int i, int w, int e) {
  const long long num = (2LL * i + 1) * e - w;  // e's with (2k+1)w < num+w
  if (num <= 0) return 0;
  const long long n = (num + 2LL * w - 1) / (2LL * w);
  return static_cast<int>(n < e ? n : e);
}

__device__ __forceinline__ int work_before(int k, int w, int e) {
  const long long num = (2LL * k + 1) * w - e;  // i's with (2i+1)e <= ...
  if (num < 0) return 0;
  const long long n = num / (2LL * e) + 1;
  return static_cast<int>(n < w ? n : w);
}

// Pass 2, one block. offsets[t] = entries before tile t (offsets[n_tiles]
// the total) and cursors = offsets; flags = 0; the work items of the tile
// pass: (tile, 0) for every tile with entries (its owner), then (tile, c)
// for each further CHUNK entries (its helpers), and, spread
// evenly between them, (tile, 0) for every tile without entries (only
// stores, which so overlap the counting); *n_items their number; *queue =
// 0.
__global__ void __launch_bounds__(SCAN_THREADS)
carve_scan_kernel(const int* __restrict__ counts, int n_tiles,
                  int* offsets, int* cursors, int* flags, int* queue,
                  int* n_items, int2* items) {
  constexpr int STRIDE = SCAN_THREADS * SCAN_ITEMS;
  int carry = 0, n_busy = 0, n_help = 0;
  for (int base = 0; base < n_tiles; base += STRIDE) {
    const int first = base + threadIdx.x * SCAN_ITEMS;
    int v[3] = {0, 0, 0};
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int c = first + j < n_tiles ? counts[first + j] : 0;
      v[0] += c;
      v[1] += c > 0;
      v[2] += c > 0 ? chunks_of(c) - 1 : 0;
    }
    int prefix[3], total[3];
    block_scan<3>(v, prefix, total);
    int offset = carry + prefix[0];
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int t = first + j;
      if (t < n_tiles) {
        offsets[t] = offset;
        cursors[t] = offset;
        flags[t] = 0;
        offset += counts[t];
      }
    }
    carry += total[0];
    n_busy += total[1];
    n_help += total[2];
  }
  if (threadIdx.x == 0) {
    offsets[n_tiles] = carry;
    *n_items = n_tiles + n_help;
    *queue = 0;
  }
  const int n_work = n_busy + n_help, n_empty = n_tiles - n_busy;
  int busy_seen = 0, help_seen = 0, empty_seen = 0;
  for (int base = 0; base < n_tiles; base += STRIDE) {
    const int first = base + threadIdx.x * SCAN_ITEMS;
    int v[3] = {0, 0, 0};
#pragma unroll
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int c = first + j < n_tiles ? counts[first + j] : 0;
      v[0] += c > 0;
      v[1] += c > 0 ? chunks_of(c) - 1 : 0;
      v[2] += first + j < n_tiles && c == 0;
    }
    int prefix[3], total[3];
    block_scan<3>(v, prefix, total);
    int owner = busy_seen + prefix[0];
    int helper = n_busy + help_seen + prefix[1];
    int empty = empty_seen + prefix[2];
    for (int j = 0; j < SCAN_ITEMS; ++j) {
      const int t = first + j;
      if (t >= n_tiles) break;
      const int c = counts[t];
      if (c == 0) {
        items[empty + work_before(empty, n_work, n_empty)] = make_int2(t, 0);
        ++empty;
        continue;
      }
      items[owner + empty_before(owner, n_work, n_empty)] = make_int2(t, 0);
      ++owner;
      for (int h = 1; h < chunks_of(c); ++h, ++helper)
        items[helper + empty_before(helper, n_work, n_empty)] =
            make_int2(t, h);
    }
    busy_seen += total[0];
    help_seen += total[1];
    empty_seen += total[2];
  }
}

// A tile's rows: wx * wy runs of wz int32 along z, contiguous in the
// grid (row r at x = r / wy, y = r % wy) and in a shared-memory tile.
struct TileRows {
  int lo[3], w[3];
  __device__ __forceinline__ TileRows(const int l[3], const int h[3]) {
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      lo[a] = l[a];
      w[a] = h[a] - l[a];
    }
  }
  __device__ __forceinline__ int count() const { return w[0] * w[1]; }
  __device__ __forceinline__ long long global(const Tiles& g, int r) const {
    const int x = r / w[1], y = r - (r / w[1]) * w[1];
    return (lo[0] + x) * (static_cast<long long>(g.n[1]) * g.n[2]) +
           static_cast<long long>(lo[1] + y) * g.n[2] + lo[2];
  }
  __device__ __forceinline__ int shared(const Tiles& g, int r) const {
    const int x = r / w[1], y = r - (r / w[1]) * w[1];
    return (x * g.e[1] + y) * g.e[2];
  }
};

// Stores the tile's rows of `src` (or zeros where it is null) into `dst`
// with the threads' own stores (16 bytes a store where vec).
__device__ __forceinline__ void store_rows(const Tiles& g, const TileRows& t,
                                           bool vec, const int* src,
                                           int* dst) {
  const int per_row = vec ? t.w[2] >> 2 : t.w[2];
  const int total = t.count() * per_row;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / per_row;
    const int v = i - r * per_row;
    const long long out = t.global(g, r);
    if (vec) {
      reinterpret_cast<int4*>(dst + out)[v] =
          src != nullptr
              ? reinterpret_cast<const int4*>(src + t.shared(g, r))[v]
              : make_int4(0, 0, 0, 0);
    } else {
      dst[out + v] = src != nullptr ? src[t.shared(g, r) + v] : 0;
    }
  }
}

// A helper's share of a tile: its nonzero counts added into seen_free
// (which the tile's owner has stored).
__device__ __forceinline__ void add_rows(const Tiles& g, const TileRows& t,
                                         const int* src, int* seen_free) {
  const int total = t.count() * t.w[2];
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i / t.w[2];
    const int z = i - r * t.w[2];
    const int v = src[t.shared(g, r) + z];
    if (v != 0) atomicAdd(seen_free + t.global(g, r) + z, v);
  }
}

// One segment's walk through its tile, step by step from its saved state
// (the plain walk's loop; the tile bounds [lo, hi) stand in for the grid's,
// and the walk stops where it leaves them).
__device__ __forceinline__ void walk_segment(
    int ray, int local, const int* __restrict__ start,
    const int* __restrict__ fin, const int* __restrict__ step,
    const float* __restrict__ t0, const float* __restrict__ dt,
    const Tiles& g, const int lo[3], const int hi[3], int n_steps,
    int* s_free) {
  const long long i = 3LL * ray;
  const int x_stride = g.e[1] * g.e[2], y_stride = g.e[2];
  const int lx = local / x_stride;
  const int ly = (local - lx * x_stride) / y_stride;
  int cx = lo[0] + lx, cy = lo[1] + ly,
      cz = lo[2] + local - lx * x_stride - ly * y_stride;
  const int fx = fin[i], fy = fin[i + 1], fz = fin[i + 2];
  const int sx = step[i], sy = step[i + 1], sz = step[i + 2];
  const float tx0 = t0[i], ty0 = t0[i + 1], tz0 = t0[i + 2];
  const float dtx = dt[i], dty = dt[i + 1], dtz = dt[i + 2];
  int kx = abs(cx - start[i]), ky = abs(cy - start[i + 1]),
      kz = abs(cz - start[i + 2]);
  float tx = cross_time(tx0, kx, dtx), ty = cross_time(ty0, ky, dty),
        tz = cross_time(tz0, kz, dtz);
  const int dx = sx * x_stride, dy = sy * y_stride;
  for (int s = kx + ky + kz; s < n_steps; ++s) {
    if (cx == fx && cy == fy && cz == fz) break;
    atomicAdd(s_free + local, 1);
    if (tx <= ty && tx <= tz) {
      if (cx == fx) break;
      cx += sx;
      tx = cross_time(tx0, ++kx, dtx);
      local += dx;
      if (cx < lo[0] || cx >= hi[0]) break;
    } else if (ty <= tx && ty <= tz) {
      if (cy == fy) break;
      cy += sy;
      ty = cross_time(ty0, ++ky, dty);
      local += dy;
      if (cy < lo[1] || cy >= hi[1]) break;
    } else {
      if (cz == fz) break;
      cz += sz;
      tz = cross_time(tz0, ++kz, dtz);
      local += sz;
      if (cz < lo[2] || cz >= hi[2]) break;
    }
  }
}

// Pass 4: persistent blocks, one work item at a time from the queue. A
// tile without entries is stored as zeros in both grids. A tile's owner
// (chunk 0) counts its chunk of the tile's list into shared memory, stores
// the tile of seen_free and zeros for the tile of seen_filled and, where
// the tile has helpers, raises the tile's flag once the stores are
// visible; a helper (a further chunk) counts its chunk, waits for the flag
// and adds its nonzero counts with device-memory atomics. The owners come
// before their helpers in the queue and never wait, so a helper waits only
// for an owner that is running. Then each adds its chunk's filled
// endpoints.
__global__ void __launch_bounds__(TILE_THREADS, 1024 / TILE_THREADS)
carve_tile_kernel(const int* __restrict__ start, const int* __restrict__ fin,
                  const int* __restrict__ step, const float* __restrict__ t0,
                  const float* __restrict__ dt, Tiles g, int n_steps,
                  const int* __restrict__ offsets,
                  const int2* __restrict__ items,
                  const int* __restrict__ n_items, int* queue, int* flags,
                  const int2* __restrict__ entries, bool vec, int* seen_free,
                  int* seen_filled) {
  extern __shared__ int4 smem4[];
  int* const s_free = reinterpret_cast<int*>(smem4);
  const int vol = g.e[0] * g.e[1] * g.e[2];
  __shared__ int next, cursor;
  const int items_n = *n_items;
  const int x_stride = g.e[1] * g.e[2], y_stride = g.e[2];
  for (;;) {
    if (threadIdx.x == 0) next = atomicAdd(queue, 1);
    __syncthreads();
    const int q = next;
    if (q >= items_n) break;
    const int2 item = items[q];
    const int tile = item.x;
    const int lo[3] = {tile / (g.nt[1] * g.nt[2]) * g.e[0],
                       (tile / g.nt[2]) % g.nt[1] * g.e[1],
                       tile % g.nt[2] * g.e[2]};
    int hi[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) hi[a] = min(lo[a] + g.e[a], g.n[a]);
    const TileRows rows(lo, hi);
    const int beg = offsets[tile], end = offsets[tile + 1];
    if (beg == end) {
      store_rows(g, rows, vec, nullptr, seen_free);
      store_rows(g, rows, vec, nullptr, seen_filled);
      __syncthreads();  // `next` is read by every thread before it changes
      continue;
    }
    const int first = beg + item.y * CHUNK;
    const int last = min(end, first + CHUNK);
    if (threadIdx.x == 0) cursor = first;
    for (int j = threadIdx.x; j < vol >> 2; j += blockDim.x)
      smem4[j] = make_int4(0, 0, 0, 0);
    for (int j = (vol & ~3) + threadIdx.x; j < vol; j += blockDim.x)
      s_free[j] = 0;
    __syncthreads();
    // Each warp takes the next 32 entries when it is done with its last.
    for (;;) {
      int j = 0;
      if ((threadIdx.x & 31) == 0) j = atomicAdd(&cursor, 32);
      j = __shfl_sync(0xffffffffu, j, 0) + (threadIdx.x & 31);
      if (j - (threadIdx.x & 31) >= last) break;
      if (j < last) {
        const int2 en = entries[j];
        if (en.x >= 0)
          walk_segment(en.x, en.y, start, fin, step, t0, dt, g, lo, hi,
                       n_steps, s_free);
        else if (en.x == END_FREE)
          atomicAdd(s_free + en.y, 1);
      }
    }
    __syncthreads();
    if (item.y == 0) {
      store_rows(g, rows, vec, s_free, seen_free);
      store_rows(g, rows, vec, nullptr, seen_filled);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0 && end - beg > CHUNK) atomicExch(flags + tile, 1);
    } else {
      if (threadIdx.x == 0)
        while (atomicAdd(flags + tile, 0) == 0) __nanosleep(256);
      __syncthreads();
      __threadfence();
      add_rows(g, rows, s_free, seen_free);
    }
    for (int j = first + threadIdx.x; j < last; j += blockDim.x) {
      const int2 en = entries[j];
      if (en.x != END_FILLED) continue;
      const int lx = en.y / x_stride;
      const int ly = (en.y - lx * x_stride) / y_stride;
      const int lz = en.y - lx * x_stride - ly * y_stride;
      atomicAdd(seen_filled +
                    (lo[0] + lx) * (static_cast<long long>(g.n[1]) * g.n[2]) +
                    static_cast<long long>(lo[1] + ly) * g.n[2] + lo[2] + lz,
                1);
    }
    __syncthreads();  // shared memory and `next` are reused
  }
}

int tile_blocks(int device, size_t smem) {
  static int configured_smem = -1;
  if (static_cast<int>(smem) > configured_smem) {
    if (cudaFuncSetAttribute(carve_tile_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem)) != cudaSuccess)
      return -1;
    configured_smem = static_cast<int>(smem);
  }
  int sms = 0, per_sm = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, carve_tile_kernel, TILE_THREADS, smem) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

}  // namespace

extern "C" {

// Shared memory the tile pass needs for tiles of ex * ey * ez voxels.
long long carve_tile_smem_bytes(int ex, int ey, int ez) {
  return 1LL * ex * ey * ez * static_cast<long long>(sizeof(int));
}

// The most list entries the tile pass counts of one tile in a block (the
// caller sizes the work items by it).
int carve_tile_chunk() { return CHUNK; }

// The tiled carve. start, fin, step: int32 [n_rays, 3]; t0, dt: float32
// [n_rays, 3]; hit, end_filled: bool [n_rays]; end_flat: int32 [n_rays],
// all contiguous; the grid nx * ny * nz
// in tiles of ex * ey * ez; scratch: int32 [4 * n_tiles + 3] (counts,
// offsets [n_tiles + 1], cursors, flags, queue, the number of work items);
// entries: int32 [capacity, 2] (capacity: n_rays * (1 + the bound on the
// tiles a walk enters)); items: int32 [max_items, 2] (max_items: n_tiles +
// ceil(capacity / CHUNK)); seen_free and seen_filled: int32 [nx * ny * nz],
// written in full. Launches its four passes on `stream` without
// synchronizing and returns the first cudaError_t (0 on success).
int carve_tiled_launch(const int* start, const int* fin, const int* step,
                       const float* t0, const float* dt, const bool* hit,
                       const int* end_flat, const bool* end_filled,
                       long long n_rays, int nx, int ny, int nz, int ex,
                       int ey, int ez, int n_steps, int* scratch,
                       int* entries, long long capacity, int* items,
                       int* seen_free, int* seen_filled, int device,
                       void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  Tiles g;
  g.n[0] = nx; g.n[1] = ny; g.n[2] = nz;
  g.e[0] = ex; g.e[1] = ey; g.e[2] = ez;
  for (int a = 0; a < 3; ++a) g.nt[a] = (g.n[a] + g.e[a] - 1) / g.e[a];
  const int n_tiles = g.nt[0] * g.nt[1] * g.nt[2];
  int* counts = scratch;
  int* offsets = counts + n_tiles;
  int* cursors = offsets + n_tiles + 1;
  int* flags = cursors + n_tiles;
  int* queue = flags + n_tiles;
  int* n_items = queue + 1;
  int2* list = reinterpret_cast<int2*>(entries);
  int2* work = reinterpret_cast<int2*>(items);
  const unsigned bin_blocks =
      static_cast<unsigned>((n_rays + BIN_THREADS - 1) / BIN_THREADS);
  const size_t smem = static_cast<size_t>(carve_tile_smem_bytes(ex, ey, ez));
  const int blocks = tile_blocks(device, smem);
  if (blocks <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  err = cudaMemsetAsync(counts, 0, sizeof(int) * n_tiles, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Pass 1: count.
  if (n_rays > 0) {
    carve_bin_kernel<false><<<bin_blocks, BIN_THREADS, 0, st>>>(
        start, fin, step, t0, dt, hit, end_flat, end_filled, n_rays, g,
        n_steps, counts, list, capacity);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // Pass 2: scan.
  carve_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(
      counts, n_tiles, offsets, cursors, flags, queue, n_items, work);
  if ((err = cudaGetLastError()) != cudaSuccess)
    return static_cast<int>(err);
  // Pass 3: fill.
  if (n_rays > 0) {
    carve_bin_kernel<true><<<bin_blocks, BIN_THREADS, 0, st>>>(
        start, fin, step, t0, dt, hit, end_flat, end_filled, n_rays, g,
        n_steps, cursors, list, capacity);
    if ((err = cudaGetLastError()) != cudaSuccess)
      return static_cast<int>(err);
  }
  // Pass 4: tile.
  const bool vec =
      ez % 4 == 0 && nz % 4 == 0 &&
      reinterpret_cast<unsigned long long>(seen_free) % 16 == 0 &&
      reinterpret_cast<unsigned long long>(seen_filled) % 16 == 0;
  carve_tile_kernel<<<blocks, TILE_THREADS, smem, st>>>(
      start, fin, step, t0, dt, g, n_steps, offsets, work, n_items, queue,
      flags, list, vec, seen_free, seen_filled);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
