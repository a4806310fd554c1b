// Device code shared by the port's three envelope kernels (edt_bestfirst.cu,
// edt_envelope.cu, edt_windowed.cu). Each computes the exact 1-D
// squared-distance transform
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// on the same layout and tiles; they differ only in which 16-row chunks of k
// a tile visits and when it stops. (The staged variants of edt_bestfirst.cu
// and edt_envelope.cu take only the constants below; their layout in shared
// memory is edt_staged.cuh's.)
//
// Layout. Grid lines are the contiguous axis: lane i of a warp owns line
// l = 32 * line_block + i, so every load of one row f[b, k, :] and every store
// of out[b, q, :] is one coalesced 128-byte transaction. Positions and lines
// may have any strides on input; the output is contiguous [B, n, L].
//
// Work split. One warp computes one [TQ positions x 32 lines] output tile and
// keeps its TQ running minima per lane in registers. The WARPS warps of a
// block take consecutive q tiles of the same 32 lines, so they share rows of
// f in L1/L2. Ragged edges are masked, not padded: lanes past the last line
// and rows past n neither load nor take part in a stop test.
//
// Exactness. min is exact and order-independent, so any visit order and any
// sound stop give the plain version's bits. Each candidate is rounded as the
// plain version rounds it: (q - k) is an exact integer in f32, its square and
// the sum are written with __fmul_rn / __fadd_rn, and the files are built
// with --fmad=false, so no contraction can change a result.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace edt {

constexpr int CH = 16;     // k rows per chunk
constexpr int TQ = 32;     // q positions per warp tile (minima per lane)
constexpr int WARPS = 4;   // warps per block: WARPS q tiles of one line block
constexpr int SQ = TQ + CH - 1;  // distinct offsets q - k within one chunk
constexpr unsigned FULL = 0xffffffffu;

// Launch geometry: grid.x walks (b, line block), grid.y groups of WARPS q
// tiles.
struct Shape {
  int n_ch, n_lb, n_qt;
  dim3 grid;
};

inline Shape shape_of(long long B, long long n, long long L) {
  Shape s;
  s.n_ch = static_cast<int>((n + CH - 1) / CH);
  s.n_lb = static_cast<int>((L + 31) / 32);
  s.n_qt = static_cast<int>((n + TQ - 1) / TQ);
  s.grid = dim3(static_cast<unsigned>(B * s.n_lb),
                static_cast<unsigned>((s.n_qt + WARPS - 1) / WARPS));
  return s;
}

// This warp's output tile, and where its lane's line starts in f.
struct Tile {
  long long b;
  int lb, q0, q_count;
  bool active;   // false for warps past the last q tile
  bool line_ok;  // false for lanes past the last line
  const float* fl;
};

__device__ __forceinline__ Tile tile_of(const float* f, int n, int L,
                                        int n_lb, int n_qt, long long sB,
                                        long long sL) {
  Tile t;
  const int lane = threadIdx.x & 31;
  t.b = blockIdx.x / n_lb;
  t.lb = static_cast<int>(blockIdx.x % n_lb);
  const int qt = blockIdx.y * WARPS + (threadIdx.x >> 5);
  t.active = qt < n_qt;
  t.q0 = qt * TQ;
  t.q_count = min(TQ, n - t.q0);
  const int l = t.lb * 32 + lane;
  t.line_ok = l < L;
  t.fl = f + t.b * sB + static_cast<long long>(l) * sL;
  return t;
}

// d[q] = min(d[q], (q0 + q - k)^2 + f[k]) over the CH rows k of chunk c.
// The SQ distinct squares of the chunk are formed once; each candidate is
// then one rounded add and one min.
__device__ __forceinline__ void visit_chunk(float (&d)[TQ], const Tile& t,
                                            long long sK, int c, int n) {
  const int k0 = c * CH;
  float fk[CH];
#pragma unroll
  for (int u = 0; u < CH; ++u) {
    const int k = k0 + u;
    fk[u] = (t.line_ok && k < n) ? t.fl[static_cast<long long>(k) * sK]
                                 : CUDART_INF_F;
  }
  // sq[j] = (base + j)^2 = ((q0 + q) - (k0 + u))^2 for j = q - u + CH - 1.
  float sq[SQ];
  const int base = t.q0 - k0 - (CH - 1);
#pragma unroll
  for (int j = 0; j < SQ; ++j) {
    const float delta = static_cast<float>(base + j);
    sq[j] = __fmul_rn(delta, delta);
  }
#pragma unroll
  for (int u = 0; u < CH; ++u) {
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      d[q] = fminf(d[q], __fadd_rn(sq[q - u + CH - 1], fk[u]));
    }
  }
}

// The largest real entry of this lane's column of the tile (-inf on lanes
// past the last line), for a warp-wide stop test.
__device__ __forceinline__ float tile_dmax(const float (&d)[TQ],
                                           const Tile& t) {
  float m = -CUDART_INF_F;
  if (t.line_ok) {
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      if (q < t.q_count) m = fmaxf(m, d[q]);
    }
  }
  return m;
}

__device__ __forceinline__ void init_tile(float (&d)[TQ]) {
#pragma unroll
  for (int q = 0; q < TQ; ++q) d[q] = CUDART_INF_F;
}

__device__ __forceinline__ void store_tile(const float (&d)[TQ],
                                           const Tile& t, float* out, int n,
                                           int L) {
  if (!t.line_ok) return;
  float* o = out + t.b * static_cast<long long>(n) * L + t.lb * 32
             + (threadIdx.x & 31);
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
    if (q < t.q_count) o[static_cast<long long>(t.q0 + q) * L] = d[q];
  }
}

__device__ __forceinline__ float warp_min(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v = fminf(v, __shfl_xor_sync(FULL, v, off));
  }
  return v;
}

}  // namespace edt
