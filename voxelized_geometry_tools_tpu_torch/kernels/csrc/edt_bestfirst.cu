// Exact 1-D squared-distance transform, best-first chunk order (Hopper, sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// Replaces two TPU kernels of voxelized_geometry_tools_tpu/kernels/
// edt_pallas.py, both launched by parabolic_envelope_last_pallas_bestfirst:
// _bestfirst_cmin_kernel (hoist_cmin=True: the chunk minima come in
// precomputed) and _bestfirst_kernel (hoist_cmin=False: the kernel reduces
// them itself). One template covers both; it computes the same function as
// the TPU kernels, with the port's own design. Layout, tiles and rounding are
// those of edt_common.cuh.
//
// Best-first order and stop. k is visited in chunks of CH rows. Each chunk c
// has the admissible bound geom(tile, c)^2 + cmin[c], where geom is the gap
// from the q tile to the chunk's nearest row and cmin[c] is the chunk's
// minimum over the warp's 32 lines. The warp visits chunks in ascending bound
// order (warp-wide argmin over the remaining bounds, kept in shared memory)
// and stops once the smallest remaining bound is >= every real entry of its
// tile (__all_sync). Every unvisited candidate is >= its chunk's bound, so it
// cannot lower any entry: the result equals the full min-plus for any f,
// negative values and +inf included. Chunks whose minimum is +inf are never
// read. The minima are taken over real lines and rows only, so no masked lane
// can hold the stop open.
//
// In-kernel minima. Without a cmin input each warp first reads its whole
// [n x 32 lines] block once, reducing each chunk over its 16 rows in
// registers and over the 32 lanes with shuffles. That is the read the hoisted
// variant saves: four q tiles of one line block each repeat it.
//
// What bounds it on the H100: f32 add/min issue rate. Each visited candidate
// costs one add and one min per lane (the chunk's squares are formed once);
// the input is read about once per visited chunk per q tile (4 tiles share it
// through the cache). The best-first order keeps the visited chunks to the
// few near the seeds, so work per tile follows the data, not n.

#include "edt_common.cuh"

namespace {

using namespace edt;

__device__ __forceinline__ float chunk_bound(int q0, int c, float cmin) {
  const int gap_lo = q0 - (c * CH + CH - 1);
  const int gap_hi = c * CH - (q0 + TQ - 1);
  const float g = static_cast<float>(max(max(gap_lo, gap_hi), 0));
  return __fadd_rn(__fmul_rn(g, g), cmin);
}

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

}  // namespace

extern "C" {

// f: [B, n, L] with element strides (sB, sK, sL); cmin: [B, ceil(L/32),
// ceil(n/CH)] contiguous, the minimum of f over each (line block, chunk), or
// null to have the kernel reduce the minima itself; out: [B, n, L]
// contiguous. Launches on `stream` without synchronizing and returns the
// cudaError_t of the launch (0 on success).
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

int edt_bestfirst_chunk_rows() { return CH; }

}  // extern "C"
