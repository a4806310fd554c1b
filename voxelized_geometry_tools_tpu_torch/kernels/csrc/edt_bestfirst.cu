// Exact 1-D squared-distance transform, best-first chunk order (Hopper, sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// Replaces two TPU kernels of voxelized_geometry_tools_tpu/kernels/
// edt_pallas.py, both launched by parabolic_envelope_last_pallas_bestfirst:
// _bestfirst_cmin_kernel (edt_pallas.py:301, hoist_cmin=True: the chunk
// minima come in precomputed) and _bestfirst_kernel (edt_pallas.py:241,
// hoist_cmin=False: the kernel reduces them itself). It computes the same
// function with the port's own design, in two variants chosen by shape:
//
// * Staged (edt_bestfirst_staged_kernel), for every axis whose 32-line block
//   fits a block's shared memory (n up to 1,536 or 1,776, by layout). It
//   serves both hoist_cmin values: the minima are always formed in shared
//   memory, so both give this kernel and the same bits.
// * Global (edt_bestfirst_kernel), for longer axes: each warp reads its rows
//   from global memory, on the layout and tiles of edt_common.cuh, with the
//   chunk minima hoisted (a cmin input) or reduced by each warp itself.
//
// Best-first order and stop (both variants). k is visited in chunks of CH
// rows. Each chunk c has the admissible bound geom(tile, c)^2 + cmin[c],
// where geom is the gap from the q tile to the chunk's nearest row and
// cmin[c] is the chunk's minimum over the tile's 32 lines. The warp visits
// chunks in ascending bound order (warp-wide argmin over the remaining
// bounds, kept in shared memory) and stops once the smallest remaining bound
// is >= every real entry of its tile (__all_sync). Every unvisited candidate
// is >= its chunk's bound, so it cannot lower any entry: the result equals
// the full min-plus for any f, negative values and +inf included. Chunks
// whose minimum is +inf are never read. The minima are taken over real lines
// and rows only, so no masked lane can hold the stop open.
//
// What bounds it on the H100. Bytes: f read once and d written once, 8 bytes
// per voxel (0.641 ms for a [1024, 512, 512] pass at 3.35 TB/s). Operations:
// no exact kernel forms fewer than one candidate per output, far below the
// bytes, so the bytes bind. What this kernel computes follows the data: one
// rounded add and one min per candidate, for the chunks its tile-level
// bounds do not rule out (edt_bestfirst.py::visit_count counts those chunks
// for a tile-level order; the group test below computes fewer candidates
// within them). PERF.md has the counts and the times against the bound.
//
// The staged design, against each bound:
// * One CTA per (b, 32-line block) copies the whole [n x 32] block into
//   dynamic shared memory with cp.async (16-byte pieces where the strides
//   and the base allow, else 4-byte ones), so f leaves HBM exactly once per
//   pass, coalesced along whichever axis is contiguous, and every chunk
//   visit of every q tile reads shared memory, not L2.
// * The CTA reduces the chunk minima once, from the staged block, its warps
//   splitting the chunks: no separate minima pass reads the field again.
// * Both pass layouts are read and written in place. Template kLinesContig:
//   lines on the contiguous axis (the y pass) stage as rows [k][32 lines], so
//   a warp reads one k-row of its 32 lines as one conflict-free wavefront and
//   stores each q row as one 128-byte line. Positions contiguous (the z
//   pass) stage as lines [l][k] with a line stride of 4 mod 32 words, so
//   each lane reads its line's chunk as four conflict-free 16-byte loads;
//   the warp's [TQ x 32] result goes out through a padded shared tile
//   (stride TQ + 1), one coalesced 128-byte run of q per line. No
//   transposed copy of the input or the output is made.
// * Fewer candidates than whole chunks: a visit tests each group of QG = 8
//   positions of the tile against the lane's own minimum over the chunk
//   (gap^2 + minimum, a bound on every candidate of the group) and skips a
//   group that no lane can lower. The chunk's squares are formed once per
//   visit from one int-to-float conversion; each candidate computed is one
//   __fadd_rn and one fminf, built with --fmad=false, as the plain version
//   rounds it. The fminf issues on the ALU pipe at half the FP32 rate, which
//   makes the visits the kernel's compute limit.
// * Warps per CTA: ptxas reports 125-128 registers a thread and no spills
//   (the __launch_bounds__ cap is 128; the d[32] minima, the chunk's 47
//   squares and its 16 rows live in registers), so 16 warps fill an SM's
//   65,536 registers. A 512-line axis stages 64-66 KiB, so two CTAs of 8
//   warps share an SM and one stages while the other computes (a lone CTA of
//   8 warps per SM is far slower: the loop needs the warps to hide its
//   latency); a 1024-line axis stages 128-130 KiB, one CTA of 16 warps. The
//   warps take q tiles from a shared counter, so a slow tile does not hold
//   its CTA's other warps idle.

#include "edt_staged.cuh"

namespace {

using namespace edt;

__device__ __forceinline__ float chunk_bound(int q0, int c, float cmin) {
  const int gap_lo = q0 - (c * CH + CH - 1);
  const int gap_hi = c * CH - (q0 + TQ - 1);
  const float g = static_cast<float>(max(max(gap_lo, gap_hi), 0));
  return __fadd_rn(__fmul_rn(g, g), cmin);
}

// ---------------------------------------------------------------------------
// Global variant: f read from global memory, tiles of edt_common.cuh.

template <bool kHoisted>
__global__ void __launch_bounds__(WARPS * 32)
edt_bestfirst_kernel(const float* __restrict__ f,
                     const float* __restrict__ cmin,
                     float* __restrict__ out,
                     int n, int L, int n_ch, int n_lb, int n_qt,
                     long long sB, long long sK, long long sL) {
  extern __shared__ float s_bounds[];  // [WARPS][n_ch]
  const Tile t = tile_of(f, n, L, n_lb, n_qt, sB, sL);
  // A whole warp leaves together; nothing below synchronizes the block.
  if (!t.active) return;
  const int lane = threadIdx.x & 31;
  float* bounds = s_bounds + (threadIdx.x >> 5) * n_ch;

  if (kHoisted) {
    const float* cm = cmin + (t.b * n_lb + t.lb) * n_ch;
    for (int c = lane; c < n_ch; c += 32) {
      bounds[c] = chunk_bound(t.q0, c, cm[c]);
    }
  } else {
    for (int c = 0; c < n_ch; ++c) {
      float m = CUDART_INF_F;
#pragma unroll
      for (int u = 0; u < CH; ++u) {
        const int k = c * CH + u;
        if (t.line_ok && k < n) {
          m = fminf(m, t.fl[static_cast<long long>(k) * sK]);
        }
      }
      m = warp_min(m);
      if (lane == (c & 31)) bounds[c] = chunk_bound(t.q0, c, m);
    }
  }
  __syncwarp();

  float d[TQ];
  init_tile(d);
  while (true) {
    // Warp-wide argmin over the remaining bounds (lane c % 32 owns chunk c;
    // ties go to the lower chunk so every lane agrees).
    float bm = CUDART_INF_F;
    int bc = n_ch;
    for (int c = lane; c < n_ch; c += 32) {
      const float v = bounds[c];
      if (v < bm) { bm = v; bc = c; }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_xor_sync(FULL, bm, off);
      const int oc = __shfl_xor_sync(FULL, bc, off);
      if (ov < bm || (ov == bm && oc < bc)) { bm = ov; bc = oc; }
    }
    // Stop once no remaining chunk can lower any real entry of the tile
    // (or none is left).
    if (bc >= n_ch || __all_sync(FULL, tile_dmax(d, t) <= bm)) break;
    visit_chunk(d, t, sK, bc, n);
    if (lane == (bc & 31)) bounds[bc] = CUDART_INF_F;
    __syncwarp();
  }
  store_tile(d, t, out, n, L);
}

// ---------------------------------------------------------------------------
// Staged variant.

// Shared-memory plan of one CTA, in floats: the staged block (BlockGeom of
// edt_staged.cuh), the n_ch chunk minima, then one region per warp that
// holds its tile's bounds and, with positions contiguous, afterwards its
// [TQ][XS] output tile. edt_bestfirst.py::staged_smem_bytes mirrors it.
struct StagedLayout : BlockGeom {
  int region;
  __host__ __device__ size_t bytes(int warps) const {
    return sizeof(float) * (static_cast<size_t>(block) + n_ch +
                            static_cast<size_t>(warps) * region);
  }
};

__host__ __device__ inline StagedLayout staged_layout(int n,
                                                      bool lines_contig) {
  StagedLayout g;
  static_cast<BlockGeom&>(g) = block_geom(n, lines_contig);
  if (lines_contig) {
    g.region = g.n_ch;
  } else {
    g.region = g.n_ch > TQ * XS ? g.n_ch : TQ * XS;
  }
  return g;
}

// An order-preserving map of floats (NaN excluded) to unsigned ints, so a
// warp-wide minimum is one redux.sync, and its inverse.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

constexpr int QG = 8;  // positions of a group a visit may skip

// One chunk visit of the staged kernel: the chunk at row k0 (this lane's
// rows fk) against the tile at q0, in groups of QG positions. A group takes
// the chunk's candidates unless no lane can lower one of its entries with
// them: each candidate of the group is >= gap^2 + (the lane's minimum over
// fk), rounded, where gap is the group's distance to the chunk, and a
// group whose every lane holds no entry above that is skipped (the whole
// visit, squares included, when every group is). d ends exactly as a
// full visit (edt_common.cuh's visit_chunk) would leave it.

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

// cmin[c] = min of the staged block's chunk c (pads are +inf), for chunks
// first, first + step, ... (one warp each).
template <bool kLinesContig>
__device__ __forceinline__ void block_minima(const float* fs, float* cmin,
                                             const StagedLayout& g,
                                             int first, int step) {
  const int lane = threadIdx.x & 31;
  for (int c = first; c < g.n_ch; c += step) {
    float fk[CH];
    load_chunk<kLinesContig>(fk, fs, g.stride, c * CH, lane);
    fold_halves<CH / 2>(fk, [](float a, float b) { return fminf(a, b); });
    const unsigned m = __reduce_min_sync(FULL, order_key(fk[0]));
    if (lane == 0) cmin[c] = key_value(m);
  }
}

// The remaining chunk with the smallest bound in this warp's bounds (the
// lowest on a tie), by two redux.sync; kmin gets its order_key. Spent
// chunks hold +inf, which stops any tile.
__device__ __forceinline__ int next_chunk(const float* bounds, int n_ch,
                                          unsigned& kmin) {
  const int lane = threadIdx.x & 31;
  unsigned key = 0xffffffffu;
  unsigned bc = 0xffffffffu;
  for (int c = lane; c < n_ch; c += 32) {
    const unsigned k = order_key(bounds[c]);
    if (k < key) { key = k; bc = c; }
  }
  kmin = __reduce_min_sync(FULL, key);
  return static_cast<int>(
      __reduce_min_sync(FULL, key == kmin ? bc : 0xffffffffu));
}

// One warp's [TQ x 32] output tile at q0 of a staged block (nl real lines):
// best-first over the block's chunks, then the store to ob, the block's
// first line in the output (position q of line i at ob + q * oK + i * oL).
// region: this warp's scratch (g.region floats).
template <bool kLinesContig>
__device__ __forceinline__ void staged_tile(const float* fs,
                                            const float* cmin, float* region,
                                            const StagedLayout& g, int n,
                                            int q0, int nl, float* ob,
                                            long long oK, long long oL) {
  const int lane = threadIdx.x & 31;
  const int q_count = min(TQ, n - q0);
  const bool line_ok = lane < nl;
  for (int c = lane; c < g.n_ch; c += 32) {
    region[c] = chunk_bound(q0, c, cmin[c]);
  }
  __syncwarp();
  // Rows past n start (and stay) at -inf, so they never hold the stop open;
  // lanes past the last line report -inf.
  float d[TQ];
#pragma unroll
  for (int q = 0; q < TQ; ++q) {
    d[q] = q < q_count ? CUDART_INF_F : -CUDART_INF_F;
  }
  // Best-first: the smallest remaining bound (lowest chunk on a tie), until
  // it is >= every real entry of the tile.
  while (true) {
    unsigned kmin;
    const int c = next_chunk(region, g.n_ch, kmin);
    const float dmax = line_ok ? tile_max(d) : -CUDART_INF_F;
    if (__all_sync(FULL, dmax <= key_value(kmin))) break;
    float fk[CH];
    load_chunk<kLinesContig>(fk, fs, g.stride, c * CH, lane);
    visit_groups(d, fk, q0, c * CH);
    if (lane == (c & 31)) region[c] = CUDART_INF_F;
    __syncwarp();
  }

  // Through the region (the bounds are spent) in the z layout.
  store_staged_tile<kLinesContig>(d, region, q0, q_count, nl, ob, oK, oL);
}

// One CTA per (b, 32-line block): all kWarps warps stage it and form its
// minima, then take its q tiles from a shared counter. f and out: [B, n, L]
// with element strides (sB, sK, sL) and (oB, oK, oL).
template <bool kLinesContig, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
edt_bestfirst_staged_kernel(const float* __restrict__ f,
                            float* __restrict__ out, int n, int L, int n_lb,
                            long long sB, long long sK, long long sL,
                            long long oB, long long oK, long long oL,
                            bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_next_tile;
  const StagedLayout g = staged_layout(n, kLinesContig);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / n_lb;
  const int l0 = static_cast<int>(blockIdx.x % n_lb) * LINES;
  const int nl = min(LINES, L - l0);
  float* fs = smem;
  float* cmin = smem + g.block;
  float* region = cmin + g.n_ch + warp * g.region;

  stage_block<kLinesContig>(fs, f + b * sB + l0 * sL, g, n, nl, sK, sL, vec,
                            threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) s_next_tile = kWarps;
  cp_async_wait_all();
  __syncthreads();
  block_minima<kLinesContig>(fs, cmin, g, warp, kWarps);
  __syncthreads();

  const int n_qt = (n + TQ - 1) / TQ;
  for (int qt = warp; qt < n_qt;) {
    staged_tile<kLinesContig>(fs, cmin, region, g, n, qt * TQ, nl,
                              out + b * oB + l0 * oL, oK, oL);
    int next = 0;
    if (lane == 0) next = atomicAdd(&s_next_tile, 1);
    qt = __shfl_sync(FULL, next, 0);
  }
}

template <bool kLinesContig>
cudaError_t launch_staged(const float* f, float* out, long long B, int n,
                          int L, long long sB, long long sK, long long sL,
                          long long oB, long long oK, long long oL,
                          int warps, bool vec, cudaStream_t stream) {
  if (warps != 8 && warps != 16) return cudaErrorInvalidValue;
  const auto kernel = warps == 8
                          ? edt_bestfirst_staged_kernel<kLinesContig, 8>
                          : edt_bestfirst_staged_kernel<kLinesContig, 16>;
  const size_t smem = staged_layout(n, kLinesContig).bytes(warps);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int n_lb = (L + LINES - 1) / LINES;
  kernel<<<static_cast<unsigned>(B * n_lb), warps * 32, smem, stream>>>(
      f, out, n, L, n_lb, sB, sK, sL, oB, oK, oL, vec);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Global variant. f: [B, n, L] with element strides (sB, sK, sL); cmin:
// [B, ceil(L/32), ceil(n/CH)] contiguous, the minimum of f over each (line
// block, chunk), or null to have the kernel reduce the minima itself; out:
// [B, n, L] contiguous. Launches on `stream` without synchronizing and
// returns the cudaError_t of the launch (0 on success).
int edt_bestfirst_launch(const float* f, const float* cmin, float* out,
                         long long B, long long n, long long L,
                         long long sB, long long sK, long long sL,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s = shape_of(B, n, L);
  const size_t smem = sizeof(float) * WARPS * s.n_ch;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (cmin != nullptr) {
    edt_bestfirst_kernel<true><<<s.grid, WARPS * 32, smem, st>>>(
        f, cmin, out, static_cast<int>(n), static_cast<int>(L), s.n_ch,
        s.n_lb, s.n_qt, sB, sK, sL);
  } else {
    edt_bestfirst_kernel<false><<<s.grid, WARPS * 32, smem, st>>>(
        f, nullptr, out, static_cast<int>(n), static_cast<int>(L), s.n_ch,
        s.n_lb, s.n_qt, sB, sK, sL);
  }
  return static_cast<int>(cudaGetLastError());
}

// Staged variant. f and out: [B, n, L] with element strides (sB, sK, sL)
// and (oB, oK, oL), not overlapping; lines_contiguous: sL == 1 (the y
// pass's layout), else sK == 1 (the z pass's); warps: 8 or 16 per CTA.
// Other strides are read correctly but not coalesced. Launches on `stream`
// without synchronizing and returns the cudaError_t (0 on success).
int edt_bestfirst_staged_launch(const float* f, float* out, long long B,
                                long long n, long long L, long long sB,
                                long long sK, long long sL, long long oB,
                                long long oK, long long oL,
                                int lines_contiguous, int warps, int device,
                                void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool even = sB % 4 == 0 && aligned16(f);
  const int ni = static_cast<int>(n);
  const int Li = static_cast<int>(L);
  if (lines_contiguous) {
    err = launch_staged<true>(f, out, B, ni, Li, sB, sK, sL, oB, oK, oL,
                              warps, even && sL == 1 && sK % 4 == 0, st);
  } else {
    err = launch_staged<false>(f, out, B, ni, Li, sB, sK, sL, oB, oK, oL,
                               warps, even && sK == 1 && sL % 4 == 0, st);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory of one staged CTA, in bytes (what the wrapper's
// staged_smem_bytes must give).
long long edt_bestfirst_staged_smem(long long n, int lines_contiguous,
                                    int warps) {
  return static_cast<long long>(
      staged_layout(static_cast<int>(n), lines_contiguous != 0)
          .bytes(warps));
}

int edt_bestfirst_chunk_rows() { return CH; }

int edt_bestfirst_tile_rows() { return TQ; }

}  // extern "C"
