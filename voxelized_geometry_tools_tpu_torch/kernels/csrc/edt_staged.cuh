// Device code of the staged envelope kernels (edt_bestfirst.cu's staged
// and clustered variants, edt_envelope.cu's staged full sweep and
// edt_windowed.cu's staged walk): one CTA copies the whole [n x 32] block
// of a line block (or, in a cluster, its share of the rows) into dynamic
// shared memory with cp.async and reads it in place in either pass layout;
// its warps take [TQ x 32] output tiles of that block.
//
// Layouts of the staged block. kLinesContig (the y pass: lines on the
// contiguous axis) stages rows [n16][32 lines], so a warp reads one k-row of
// its 32 lines as one conflict-free wavefront and stores each q row as one
// 128-byte line. Positions contiguous (the z pass) stage lines [32][stride]
// with stride = 4 mod 32 words, so each lane reads its line's chunk as four
// conflict-free 16-byte loads, and a warp's result goes out through a padded
// [TQ][XS] shared tile, one coalesced 128-byte run of q per line. Pads past
// the real rows and lines hold +inf, which no candidate can take.

#pragma once

#include <cstdint>

#include "edt_common.cuh"

namespace edt {

constexpr int LINES = 32;   // lines of a block: one per lane
constexpr int XS = TQ + 1;  // row stride of a warp's output tile (z)

// The staged block of an axis of n: n_ch chunks, n16 = n_ch * CH rows,
// `stride` floats between rows (y) or lines (z), `block` floats in all.
struct BlockGeom {
  int n_ch, n16, stride, block;
};

__host__ __device__ inline BlockGeom block_geom(int n, bool lines_contig) {
  BlockGeom g;
  g.n_ch = (n + CH - 1) / CH;
  g.n16 = g.n_ch * CH;
  if (lines_contig) {
    g.stride = LINES;
    g.block = g.n16 * LINES;
  } else {
    g.stride = g.n16 + (g.n16 % 32 == 0 ? 4 : 20);
    g.block = LINES * g.stride;
  }
  return g;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Threads tid, tid + nt, ... copy a block (nl real lines from fb, line l
// at fb + l * sL, row k at + k * sK) into fs and fill every entry past the
// real lines and rows with +inf. `vec`: 16-byte pieces are aligned (strides
// and base). The copies are in flight until cp_async_wait_all.
template <bool kLinesContig>
__device__ __forceinline__ void stage_block(float* fs, const float* fb,
                                            const BlockGeom& g, int n,
                                            int nl, long long sK,
                                            long long sL, bool vec, int tid,
                                            int nt) {
  if (kLinesContig) {
    // fs[k * 32 + l]; a row of 32 lines is 8 pieces of 16 bytes.
    if (vec && nl == LINES) {
      for (int p = tid; p < n * 8; p += nt) {
        const int k = p >> 3;
        const int j = (p & 7) * 4;
        cp_async16(fs + k * LINES + j, fb + k * sK + j);
      }
    } else {
      for (int e = tid; e < n * LINES; e += nt) {
        const int k = e >> 5;
        const int l = e & 31;
        if (l < nl) {
          cp_async4(fs + e, fb + k * sK + l * sL);
        } else {
          fs[e] = CUDART_INF_F;
        }
      }
    }
    for (int e = n * LINES + tid; e < g.n16 * LINES; e += nt) {
      fs[e] = CUDART_INF_F;
    }
  } else {
    // fs[l * stride + k]; a line is n contiguous floats.
    const int whole = vec ? n / 4 : 0;  // 16-byte pieces per line
    for (int p = tid; p < nl * whole; p += nt) {
      const int l = p / whole;
      const int j = (p - l * whole) * 4;
      cp_async16(fs + l * g.stride + j, fb + l * sL + j);
    }
    const int rest = n - whole * 4;
    for (int e = tid; e < nl * rest; e += nt) {
      const int l = e / rest;
      const int k = whole * 4 + (e - l * rest);
      cp_async4(fs + l * g.stride + k, fb + l * sL + k * sK);
    }
    const int pad = g.n16 - n;
    for (int e = tid; e < nl * pad; e += nt) {
      const int l = e / pad;
      fs[l * g.stride + n + (e - l * pad)] = CUDART_INF_F;
    }
    for (int e = tid; e < (LINES - nl) * g.n16; e += nt) {
      const int l = nl + e / g.n16;
      fs[l * g.stride + e % g.n16] = CUDART_INF_F;
    }
  }
}

// This lane's CH rows of the chunk starting at row k0, from the staged block.
template <bool kLinesContig>
__device__ __forceinline__ void load_chunk(float (&fk)[CH], const float* fs,
                                           int stride, int k0, int lane) {
  if (kLinesContig) {
#pragma unroll
    for (int u = 0; u < CH; ++u) fk[u] = fs[(k0 + u) * LINES + lane];
  } else {
    const float4* p =
        reinterpret_cast<const float4*>(fs + lane * stride + k0);
#pragma unroll
    for (int i = 0; i < CH / 4; ++i) {
      const float4 v = p[i];
      fk[4 * i] = v.x;
      fk[4 * i + 1] = v.y;
      fk[4 * i + 2] = v.z;
      fk[4 * i + 3] = v.w;
    }
  }
}

// The chunk's squares from one conversion (the rest are exact adds of small
// integers): the same values as visit_chunk's squares (edt_common.cuh)
// without their SQ int-to-float conversions, which issue at an eighth of
// the FP32 rate.
__device__ __forceinline__ void staged_squares(float (&sq)[SQ], int q0,
                                               int k0) {
  const float base = static_cast<float>(q0 - k0 - (CH - 1));
#pragma unroll
  for (int j = 0; j < SQ; ++j) {
    const float delta = __fadd_rn(base, static_cast<float>(j));
    sq[j] = __fmul_rn(delta, delta);
  }
}

// v[i] = op(v[i], v[i + W]) for i < W, then the same for W / 2, ..., 1:
// v[0] ends as op over v[0, 2W), in a tree of depth log2(2W). (A loop over
// W >>= 1 is not unrolled, and its arrays would go to local memory.)
template <int W, typename Op>
__device__ __forceinline__ void fold_halves(float* v, Op op) {
#pragma unroll
  for (int i = 0; i < W; ++i) v[i] = op(v[i], v[i + W]);
  if constexpr (W > 1) fold_halves<W / 2>(v, op);
}

constexpr int QG = 8;  // positions of a group a visit may skip

// One chunk visit of a staged kernel (edt_bestfirst.cu's staged and
// clustered variants, edt_windowed.cu's staged walk): the chunk at row k0
// (this lane's rows fk) against the tile at q0, in groups of QG positions.
// A group takes the chunk's candidates unless no lane can lower one of its
// entries with them: each candidate of the group is >= gap^2 + (the lane's
// minimum over fk), rounded, where gap is the group's distance to the
// chunk, and a group whose every lane holds no entry above that is skipped
// (the whole visit, squares included, when every group is: a chunk that is
// +inf on every lane costs a fold of CH values and TQ / QG votes). The test
// holds for any f. d ends exactly as a full visit (edt_common.cuh's
// visit_chunk) would leave it.
__device__ __forceinline__ void visit_groups(float (&d)[TQ],
                                             const float (&fk)[CH], int q0,
                                             int k0) {
  float fmin[CH];
#pragma unroll
  for (int u = 0; u < CH; ++u) fmin[u] = fk[u];
  fold_halves<CH / 2>(fmin, [](float a, float b) { return fminf(a, b); });
  // base + g * QG = (first position of group g) - (last row of the chunk).
  const float base = static_cast<float>(q0 - k0 - (CH - 1));
  bool need[TQ / QG];
  bool any = false;
#pragma unroll
  for (int g = 0; g < TQ / QG; ++g) {
    const float lo = __fadd_rn(base, static_cast<float>(g * QG));
    const float hi = __fadd_rn(lo, static_cast<float>(QG - 1 + CH - 1));
    const float gap = fmaxf(fmaxf(lo, -hi), 0.0f);
    const float bound = __fadd_rn(__fmul_rn(gap, gap), fmin[0]);
    float gm[QG];
#pragma unroll
    for (int i = 0; i < QG; ++i) gm[i] = d[g * QG + i];
    fold_halves<QG / 2>(gm, [](float a, float b) { return fmaxf(a, b); });
    need[g] = __any_sync(FULL, bound < gm[0]);
    any = any || need[g];
  }
  if (!any) return;
  float sq[SQ];
  staged_squares(sq, q0, k0);
#pragma unroll
  for (int g = 0; g < TQ / QG; ++g) {
    if (!need[g]) continue;
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int i = 0; i < QG; ++i) {
        const int q = g * QG + i;
        d[q] = fminf(d[q], __fadd_rn(sq[q - u + CH - 1], fk[u]));
      }
    }
  }
}

// The largest entry of d (entries past the tile hold -inf).
__device__ __forceinline__ float tile_max(const float (&d)[TQ]) {
  float m[TQ / 2];
#pragma unroll
  for (int i = 0; i < TQ / 2; ++i) m[i] = fmaxf(d[i], d[i + TQ / 2]);
  fold_halves<TQ / 4>(m, [](float a, float b) { return fmaxf(a, b); });
  return m[0];
}

// The d of a staged tile before any visit: +inf at its q_count real
// positions, -inf past them (rows past n never hold a stop open).
__device__ __forceinline__ void init_staged_tile(float (&d)[TQ],
                                                 int q_count) {
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
    d[q] = q < q_count ? CUDART_INF_F : -CUDART_INF_F;
  }
}

// Stores one warp's [TQ x 32] tile d (position q0 + q of the lane's line,
// q_count real positions, nl real lines) to ob, the block's first line in
// the output (position q of line i at ob + q * oK + i * oL). With the lines
// contiguous each q row is one coalesced 128-byte store; otherwise the tile
// goes through xp, this warp's [TQ][XS] shared scratch, so each line's run
// of q is one coalesced store.
template <bool kLinesContig>
__device__ __forceinline__ void store_staged_tile(const float (&d)[TQ],
                                                  float* xp, int q0,
                                                  int q_count, int nl,
                                                  float* ob, long long oK,
                                                  long long oL) {
  const int lane = threadIdx.x & 31;
  if (kLinesContig) {
    if (lane < nl) {
      float* o = ob + lane * oL;
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        if (q < q_count) o[(q0 + q) * oK] = d[q];
      }
    }
  } else {
#pragma unroll
    for (int q = 0; q < TQ; ++q) xp[q * XS + lane] = d[q];
    __syncwarp();
    if (lane < q_count) {
      float* o = ob + (q0 + lane) * oK;
      for (int i = 0; i < nl; ++i) o[i * oL] = xp[lane * XS + i];
    }
    __syncwarp();
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

}  // namespace edt
