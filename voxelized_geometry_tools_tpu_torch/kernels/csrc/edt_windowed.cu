// Exact 1-D squared-distance transform for f >= 0, outward walk (Hopper,
// sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]      (exact when f >= 0)
//
// Replaces the TPU kernel voxelized_geometry_tools_tpu/kernels/edt_pallas.py::
// _windowed_kernel (launched by parabolic_envelope_last_pallas_windowed:
// backend "pallas-windowed"). It computes the same function with the port's
// own design; layout, tiles and rounding are those of edt_common.cuh.
//
// Walk and stop. A tile first visits the chunks that hold its own rows
// [q0, q0 + TQ), then widens the window [lo, hi] by one chunk on each side
// per step. Before each step it takes the geometric bound of the nearest
// unvisited rows, min((q0 - (lo*CH + CH-1))^2, (hi*CH - (q0 + TQ-1))^2), and
// stops once that is >= every real entry of the tile (__all_sync over the
// real lanes; masked lanes report -inf). With f >= 0 every unvisited
// candidate is >= its squared offset >= the bound, so it cannot lower any
// entry. A negative f far away can, so the kernel is exact only for f >= 0,
// as the TPU kernel is; it does not check the sign (that would cost a
// reduction and a sync). Every EDT field is a squared distance, so >= 0.
//
// A tile that holds one all-+inf real line keeps max(d) at +inf and sweeps
// every chunk: that is the contract of the walk, as on the TPU.
//
// What bounds it on the H100: f32 add/min issue rate over the visited
// chunks, as for the other two kernels; the window follows the distance to
// the nearest seed, not its value, so empty space costs a full sweep where
// the best-first kernel skips it.

#include "edt_common.cuh"

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

}  // namespace

extern "C" {

// f: [B, n, L] with element strides (sB, sK, sL), f >= 0; out: [B, n, L]
// contiguous. Launches on `stream` without synchronizing and returns the
// cudaError_t of the launch (0 on success).
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

}  // extern "C"
