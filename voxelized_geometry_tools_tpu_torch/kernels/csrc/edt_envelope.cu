// Exact 1-D squared-distance transform, full sweep (Hopper, sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// Replaces the TPU kernel voxelized_geometry_tools_tpu/kernels/edt_pallas.py::
// _envelope_kernel (launched by parabolic_envelope_last_pallas and
// squared_edt_pallas: backend "pallas"). It computes the same function with
// the port's own design; layout, tiles and rounding are those of
// edt_common.cuh.
//
// Every tile visits every chunk of k, in order, with no early exit: O(n^2)
// candidates per line whatever the data, exact for any f (+inf and negative
// values included).
//
// What bounds it on the H100: f32 issue rate. Each candidate is one add and
// one min per lane (the chunk's 47 squares are formed once per chunk), and
// there are n^2 of them per line. The input is read once per q tile from L2
// (the block's 4 tiles share it through L1), far below what the arithmetic
// takes, so nothing but fewer candidates (the adaptive kernels) makes it
// faster.

#include "edt_common.cuh"

namespace {

using namespace edt;

__global__ void __launch_bounds__(WARPS * 32)
edt_envelope_kernel(const float* __restrict__ f, float* __restrict__ out,
                    int n, int L, int n_ch, int n_lb, int n_qt,
                    long long sB, long long sK, long long sL) {
  const Tile t = tile_of(f, n, L, n_lb, n_qt, sB, sL);
  if (!t.active) return;
  float d[TQ];
  init_tile(d);
  for (int c = 0; c < n_ch; ++c) visit_chunk(d, t, sK, c, n);
  store_tile(d, t, out, n, L);
}

}  // namespace

extern "C" {

// f: [B, n, L] with element strides (sB, sK, sL); out: [B, n, L]
// contiguous. Launches on `stream` without synchronizing and returns the
// cudaError_t of the launch (0 on success).
int edt_envelope_launch(const float* f, float* out, long long B, long long n,
                        long long L, long long sB, long long sK, long long sL,
                        int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Shape s = shape_of(B, n, L);
  edt_envelope_kernel<<<s.grid, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      f, out, static_cast<int>(n), static_cast<int>(L), s.n_ch, s.n_lb,
      s.n_qt, sB, sK, sL);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
