// Exact 1-D squared-distance transform, best-first chunk order (Hopper, sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// Replaces the TPU kernel voxelized_geometry_tools_tpu/kernels/edt_pallas.py::
// _bestfirst_cmin_kernel (launched by parabolic_envelope_last_pallas_bestfirst
// with hoist_cmin=True). It computes the same function; the design is the
// port's own.
//
// Layout. Grid lines are the contiguous axis: lane i of a warp owns line
// l = 32 * line_block + i, so every load of one row f[b, k, :] and every
// store of out[b, q, :] is one coalesced 128-byte transaction. (The TPU
// kernel's [n, lines] transpose existed only because Mosaic has no dynamic
// lane slices.) Positions and lines may have any strides; the wrapper hands
// the y pass of the EDT over in place and gives the z pass a transposed copy.
//
// Work split. One warp computes one [TQ positions x 32 lines] output tile and
// keeps its TQ running minima per lane in registers. The four warps of a
// block take four q tiles of the same 32 lines, so they share rows of f in
// L1/L2.
//
// Best-first order and stop. k is visited in chunks of CH rows. Each chunk c
// has the admissible bound geom(tile, c)^2 + cmin[b, line_block, c], where
// geom is the gap from the q tile to the chunk's nearest row and cmin (the
// chunk's minimum over the warp's 32 lines) comes in precomputed. The warp
// visits chunks in ascending bound order (warp-wide argmin over the
// remaining bounds, kept in shared memory) and stops once the smallest
// remaining bound is >= every entry of its tile (__all_sync). Every
// unvisited candidate is >= its chunk's bound, so it cannot lower any entry:
// the result equals the full min-plus for any f, negative values and +inf
// included. Chunks whose minimum is +inf are never read. Ragged edges are
// masked, not padded: lanes past the last line and rows past n neither load
// nor take part in the stop test, so no padded lane can hold the stop open.
//
// Exactness. min is exact and order-independent, so any admissible visit
// order and any sound stop give the same bits as the plain version. Each
// candidate is rounded once: (q - k) is an exact small integer in f32 and
// the square and sum are written with __fmul_rn / __fadd_rn (and the file is
// built with --fmad=false), so no contraction can change a result.
//
// What bounds it on the H100: f32 compare/add issue rate. Each visited
// candidate costs one add, one multiply, one add and one min per lane; the
// input is read about once per visited chunk per q tile (4 tiles share it
// through the cache). The best-first order keeps the visited chunks to the
// few near the seeds, so work per tile follows the data, not n.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int CH = 16;     // k rows per chunk
constexpr int TQ = 32;     // q positions per warp tile (minima per lane)
constexpr int WARPS = 4;   // warps per block: 4 q tiles of one line block
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(WARPS * 32)
edt_bestfirst_kernel(const float* __restrict__ f,
                     const float* __restrict__ cmin,
                     float* __restrict__ out,
                     int n, int L, int n_ch, int n_lb, int n_qt,
                     long long sB, long long sK, long long sL) {
  extern __shared__ float s_bounds[];  // [WARPS][n_ch]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / n_lb;
  const int lb = static_cast<int>(blockIdx.x % n_lb);
  const int qt = blockIdx.y * WARPS + warp;
  // A whole warp leaves together; nothing below synchronizes the block.
  if (qt >= n_qt) return;

  const int q0 = qt * TQ;
  const int q_count = min(TQ, n - q0);
  const int l = lb * 32 + lane;
  const bool line_ok = l < L;

  float* bounds = s_bounds + warp * n_ch;
  const float* cm = cmin + (b * n_lb + lb) * n_ch;
  for (int c = lane; c < n_ch; c += 32) {
    const int gap_lo = q0 - (c * CH + CH - 1);
    const int gap_hi = c * CH - (q0 + TQ - 1);
    const float g = static_cast<float>(max(max(gap_lo, gap_hi), 0));
    bounds[c] = __fadd_rn(__fmul_rn(g, g), cm[c]);
  }
  __syncwarp();

  float d[TQ];
#pragma unroll
  for (int q = 0; q < TQ; ++q) d[q] = CUDART_INF_F;

  const float* fl = f + b * sB + static_cast<long long>(l) * sL;

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
    float dmax = -CUDART_INF_F;
    if (line_ok) {
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        if (q < q_count) dmax = fmaxf(dmax, d[q]);
      }
    }
    if (bc >= n_ch || __all_sync(FULL, dmax <= bm)) break;

    const int k0 = bc * CH;
    float fk[CH];
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const int k = k0 + u;
      fk[u] = (line_ok && k < n) ? fl[static_cast<long long>(k) * sK]
                                 : CUDART_INF_F;
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
      const float base = static_cast<float>(q0 - (k0 + u));
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        const float delta = __fadd_rn(base, static_cast<float>(q));
        d[q] = fminf(d[q], __fadd_rn(__fmul_rn(delta, delta), fk[u]));
      }
    }
    if (lane == (bc & 31)) bounds[bc] = CUDART_INF_F;
    __syncwarp();
  }

  if (line_ok) {
    float* o = out + b * static_cast<long long>(n) * L + l;
#pragma unroll
    for (int q = 0; q < TQ; ++q) {
      if (q < q_count) o[static_cast<long long>(q0 + q) * L] = d[q];
    }
  }
}

}  // namespace

extern "C" {

// f: [B, n, L] with element strides (sB, sK, sL); cmin: [B, ceil(L/32),
// ceil(n/CH)] contiguous, the minimum of f over each (line block, chunk);
// out: [B, n, L] contiguous. Launches on `stream` without synchronizing and
// returns the cudaError_t of the launch (0 on success).
int edt_bestfirst_launch(const float* f, const float* cmin, float* out,
                         long long B, long long n, long long L,
                         long long sB, long long sK, long long sL,
                         int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_ch = static_cast<int>((n + CH - 1) / CH);
  const int n_lb = static_cast<int>((L + 31) / 32);
  const int n_qt = static_cast<int>((n + TQ - 1) / TQ);
  const dim3 grid(static_cast<unsigned>(B * n_lb),
                  static_cast<unsigned>((n_qt + WARPS - 1) / WARPS));
  const size_t smem = sizeof(float) * WARPS * n_ch;
  edt_bestfirst_kernel<<<grid, WARPS * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      f, cmin, out, static_cast<int>(n), static_cast<int>(L), n_ch, n_lb,
      n_qt, sB, sK, sL);
  return static_cast<int>(cudaGetLastError());
}

int edt_bestfirst_chunk_rows() { return CH; }

}  // extern "C"
