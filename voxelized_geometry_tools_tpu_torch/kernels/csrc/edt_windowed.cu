// Exact 1-D squared-distance transform for f >= 0, outward walk (Hopper,
// sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]      (exact when f >= 0)
//
// Replaces the TPU kernel voxelized_geometry_tools_tpu/kernels/edt_pallas.py::
// _windowed_kernel (launched by parabolic_envelope_last_pallas_windowed:
// backend "pallas-windowed"). It computes the same function with the port's
// own design, in two variants chosen by shape (edt_windowed.py::plan):
//
// * Staged (edt_windowed_staged_kernel), wherever the 32-line block fits a
//   block's shared memory (edt_windowed.py::windowed_warps: n up to 1,536
//   with the positions contiguous, 1,808 with the lines contiguous): the
//   block staged, read and written in place as edt_staged.cuh sets out.
// * Global (edt_windowed_kernel), for longer axes: layout, tiles and
//   rounding of edt_common.cuh, each warp reading its rows from global
//   memory (lines on the contiguous axis, a transposed copy where they are
//   not).
//
// Walk and stop (both variants). A tile first visits the chunks that hold
// its own rows [q0, q0 + TQ), then widens the window [lo, hi] by one chunk
// on each side per step. Before each step it takes the geometric bound of
// the nearest unvisited rows, min((q0 - (lo*CH + CH-1))^2, (hi*CH - (q0 +
// TQ-1))^2), and stops once that is >= every real entry of the tile
// (__all_sync over the real lanes; masked lanes and rows past n report
// -inf). With f >= 0 every unvisited candidate is >= its squared offset >=
// the bound, so it cannot lower any entry. A negative f far away can, so
// the kernel is exact only for f >= 0, as the TPU kernel is; it does not
// check the sign (that would cost a reduction and a sync). Every EDT field
// is a squared distance, so >= 0.
//
// A tile that holds one all-+inf real line keeps max(d) at +inf and walks
// every chunk: that is the contract of the walk, as on the TPU.
//
// What bounds it on the H100. Bytes: f read once and d written once, 8
// bytes per voxel (0.641 ms for a [1024, 512, 512] pass at 3.35 TB/s); no
// exact kernel forms fewer than one candidate per output. What the walk
// computes follows the distance to the nearest seed, not its value: on the
// main path's 512^3 field a y-pass tile walks at least 12.85 of 32 chunks,
// three quarters of them +inf on all its lines (edt_windowed.py::
// walk_count). The staged design makes those dead chunks almost free:
// * One CTA per (b, 32-line block) stages the block with cp.async
//   (edt_staged.cuh's stage_block, both pass layouts in place: no
//   transposed copy), so f leaves HBM once per pass and every chunk of the
//   walk is read from shared memory.
// * Each visit is visit_groups (edt_staged.cuh): each group of 8 positions
//   is tested against the lane's minimum over the chunk, exact for any f, so
//   a chunk that is +inf on every lane costs a fold of 16 values and four
//   votes instead of 1,024 candidates; a live chunk forms its squares from
//   one conversion and computes only the groups some lane can lower.
// * The CTA's warps take q tiles from a shared counter, so the tiles that
//   walk the whole axis do not hold the others' warps idle. Two CTAs of 8
//   warps share an SM where they fit (one stages while the other walks),
//   else one of 16 (edt_bestfirst.py::fit_warps); at most 128 registers a
//   thread.

#include "edt_staged.cuh"

namespace {

using namespace edt;

__global__ void __launch_bounds__(WARPS * 32)
edt_windowed_kernel(const float* __restrict__ f, float* __restrict__ out,
                    int n, int L, int n_ch, int n_lb, int n_qt,
                    long long sB, long long sK, long long sL) {
  const Tile t = tile_of(f, n, L, n_lb, n_qt, sB, sL);
  if (!t.active) return;
  float d[TQ];
  init_tile(d);
  const int lo0 = t.q0 / CH;
  const int hi0 = min((t.q0 + TQ + CH - 1) / CH, n_ch);
  for (int c = lo0; c < hi0; ++c) visit_chunk(d, t, sK, c, n);

  int lo = lo0 - 1;
  int hi = hi0;
  while (lo >= 0 || hi < n_ch) {
    const float db = static_cast<float>(t.q0 - (lo * CH + CH - 1));
    const float dh = static_cast<float>(hi * CH - (t.q0 + TQ - 1));
    const float bound = fminf(lo >= 0 ? __fmul_rn(db, db) : CUDART_INF_F,
                              hi < n_ch ? __fmul_rn(dh, dh) : CUDART_INF_F);
    if (__all_sync(FULL, tile_dmax(d, t) <= bound)) break;
    if (lo >= 0) visit_chunk(d, t, sK, lo, n);
    if (hi < n_ch) visit_chunk(d, t, sK, hi, n);
    --lo;
    ++hi;
  }
  store_tile(d, t, out, n, L);
}

// ---------------------------------------------------------------------------
// Staged variant.

// Shared-memory plan of one staged CTA, in floats: the staged block
// (BlockGeom of edt_staged.cuh), then, with the positions contiguous, one
// [TQ][XS] output tile per warp. edt_windowed.py::windowed_smem_bytes
// mirrors it.
struct WindowedLayout : BlockGeom {
  int tile;
  __host__ __device__ size_t bytes(int warps) const {
    return sizeof(float) *
           (static_cast<size_t>(block) + static_cast<size_t>(warps) * tile);
  }
};

__host__ __device__ inline WindowedLayout windowed_layout(int n,
                                                          bool lines_contig) {
  WindowedLayout g;
  static_cast<BlockGeom&>(g) = block_geom(n, lines_contig);
  g.tile = lines_contig ? 0 : TQ * XS;
  return g;
}

// One warp's [TQ x 32] output tile at q0 of a staged block (nl real lines):
// the outward walk over the block's chunks, then the store to ob, the
// block's first line in the output (position q of line i at ob + q * oK +
// i * oL). xp: this warp's [TQ][XS] output tile (z layout). The walk visits
// the chunks of the global variant in its order (the tile's own, then per
// step lo and hi), from one call site of visit_groups, so the unrolled
// visit is emitted once.
template <bool kLinesContig>
__device__ __forceinline__ void windowed_tile(const float* fs,
                                              const WindowedLayout& g, int n,
                                              int q0, int nl, float* xp,
                                              float* ob, long long oK,
                                              long long oL) {
  const int lane = threadIdx.x & 31;
  const int q_count = min(TQ, n - q0);
  const bool line_ok = lane < nl;
  float d[TQ];
  init_staged_tile(d, q_count);
  const int hi0 = min((q0 + TQ + CH - 1) / CH, g.n_ch);
  int own = q0 / CH;  // the tile's own chunks, [q0 / CH, hi0), come first
  int lo = own - 1;
  int hi = hi0;
  bool hi_due = false;  // the current step's hi chunk follows its lo chunk
  while (true) {
    int c;
    if (own < hi0) {
      c = own++;
    } else if (hi_due) {
      c = hi++;
      hi_due = false;
    } else {
      // A step: stop once the nearest unvisited rows cannot lower any real
      // entry (or none is left), else visit lo, then hi.
      if (lo < 0 && hi >= g.n_ch) break;
      const float db = static_cast<float>(q0 - (lo * CH + CH - 1));
      const float dh = static_cast<float>(hi * CH - (q0 + TQ - 1));
      const float bound =
          fminf(lo >= 0 ? __fmul_rn(db, db) : CUDART_INF_F,
                hi < g.n_ch ? __fmul_rn(dh, dh) : CUDART_INF_F);
      const float dmax = line_ok ? tile_max(d) : -CUDART_INF_F;
      if (__all_sync(FULL, dmax <= bound)) break;
      if (lo >= 0) {
        c = lo--;
        hi_due = hi < g.n_ch;
      } else {
        c = hi++;
      }
    }
    float fk[CH];
    load_chunk<kLinesContig>(fk, fs, g.stride, c * CH, lane);
    visit_groups(d, fk, q0, c * CH);
  }
  store_staged_tile<kLinesContig>(d, xp, q0, q_count, nl, ob, oK, oL);
}

// One CTA per (b, 32-line block): all kWarps warps stage it, then take its
// q tiles from a shared counter. f and out: [B, n, L] with element strides
// (sB, sK, sL) and (oB, oK, oL).
template <bool kLinesContig, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
edt_windowed_staged_kernel(const float* __restrict__ f,
                           float* __restrict__ out, int n, int L, int n_lb,
                           long long sB, long long sK, long long sL,
                           long long oB, long long oK, long long oL,
                           bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_next_tile;
  const WindowedLayout g = windowed_layout(n, kLinesContig);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / n_lb;
  const int l0 = static_cast<int>(blockIdx.x % n_lb) * LINES;
  const int nl = min(LINES, L - l0);
  float* fs = smem;
  float* xp = smem + g.block + warp * g.tile;

  stage_block<kLinesContig>(fs, f + b * sB + l0 * sL, g, n, nl, sK, sL, vec,
                            threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) s_next_tile = kWarps;
  cp_async_wait_all();
  __syncthreads();

  const int n_qt = (n + TQ - 1) / TQ;
  for (int qt = warp; qt < n_qt;) {
    windowed_tile<kLinesContig>(fs, g, n, qt * TQ, nl, xp,
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
                          ? edt_windowed_staged_kernel<kLinesContig, 8>
                          : edt_windowed_staged_kernel<kLinesContig, 16>;
  const size_t smem = windowed_layout(n, kLinesContig).bytes(warps);
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

// Global variant. f: [B, n, L] with element strides (sB, sK, sL), f >= 0;
// out: [B, n, L] contiguous. Launches on `stream` without synchronizing and
// returns the cudaError_t of the launch (0 on success).
int edt_windowed_launch(const float* f, float* out, long long B, long long n,
                        long long L, long long sB, long long sK, long long sL,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s = shape_of(B, n, L);
  edt_windowed_kernel<<<s.grid, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      f, out, static_cast<int>(n), static_cast<int>(L), s.n_ch, s.n_lb,
      s.n_qt, sB, sK, sL);
  return static_cast<int>(cudaGetLastError());
}

// Staged variant. f and out: [B, n, L] with element strides (sB, sK, sL)
// and (oB, oK, oL), not overlapping, f >= 0; lines_contiguous: sL == 1 (the
// y pass's layout), else sK == 1 (the z pass's); warps: 8 or 16 per CTA.
// Other strides are read correctly but not coalesced. Launches on `stream`
// without synchronizing and returns the cudaError_t (0 on success).
int edt_windowed_staged_launch(const float* f, float* out, long long B,
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
// windowed_smem_bytes must give).
long long edt_windowed_staged_smem(long long n, int lines_contiguous,
                                   int warps) {
  return static_cast<long long>(
      windowed_layout(static_cast<int>(n), lines_contiguous != 0)
          .bytes(warps));
}

}  // extern "C"
