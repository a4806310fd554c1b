// The transform product on the card (Hopper, sm_90a): out = a @ b for
// small [m, K] @ [K, n] operands (the grid-frame transform's 4 x 4 and
// 3 x 3 products), each element as XLA's CPU dot forms it.
//
// Replaces no TPU kernel. The JAX package forms its transform products as
// XLA dots (voxelized_geometry_tools_tpu/core/transforms.py::
// invert_isometry, compose). The port formed them on the host
// (core/transforms.py::_fma_chain, _fma_chain_f64): each product copied
// both operands to the host and the result back, three copies that each
// wait for the card, six a carve's grid-frame transform.
//
// Exactness. Bit for bit the host chains, for finite operands:
// - float32: the k = 0 product rounded on its own (__fmul_rn), then
//   fma(a_k, b_k, acc) correctly rounded in k order (__fmaf_rn). Non-finite
//   operands give the same infinities; a NaN is a NaN (its bits are the
//   card's).
// - float64, K <= 3: the same chain with __dmul_rn and __fma_rn, a step
//   whose exact value is 0 made +0 (the host's exact fractions give it);
//   where a row of a or a column of b holds a non-finite value, the
//   products are rounded and summed in k order (__dmul_rn, __dadd_rn), as
//   the host chain takes them.
// (The float64 4 x 4 product, rounded products summed in k order, stays
// in eager operations: the wrapper does not send it here.)
//
// What bounds it: the launch. One thread an element, 16 for a 4 x 4.

#include <cmath>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

__device__ __forceinline__ float product(float x, float y) {
  return __fmul_rn(x, y);
}

__device__ __forceinline__ double product(double x, double y) {
  return __dmul_rn(x, y);
}

__device__ __forceinline__ float sum(float x, float y) {
  return __fadd_rn(x, y);
}

__device__ __forceinline__ double sum(double x, double y) {
  return __dadd_rn(x, y);
}

__device__ __forceinline__ float fused(float x, float y, float acc) {
  return __fmaf_rn(x, y, acc);
}

// The float64 host chain forms each step as an exact fraction and rounds
// it once. A fraction has no negative zero: where x y + acc is exactly 0
// the step is +0; where it is not 0 but rounds to 0 the rounding keeps its
// sign, as __fma_rn's does. Which of the two a zero is:
// - x or y is 0: the sum is acc, which rounded to 0, so it is 0;
// - acc is 0: the sum is x y, not 0;
// - |acc| >= 2^-960: x y, within 2^-1075 of -acc, is a multiple of
//   2^-1074 (its last bit lies at most 106 bits below it), as acc is, so
//   the sum is a multiple of 2^-1074 that rounded to 0: it is 0;
// - else the smaller factor and acc are scaled by 2^1000 (exactly, with
//   no overflow), and the scaled sum, if not 0, is at least 2^-181: it is
//   0 where its rounding is.
__device__ __forceinline__ double fused(double x, double y, double acc) {
  const double r = __fma_rn(x, y, acc);
  if (r != 0.0 || x == 0.0 || y == 0.0) return r == 0.0 ? 0.0 : r;
  if (acc == 0.0) return r;
  if (fabs(acc) >= 0x1p-960) return 0.0;
  const bool scale_x = fabs(x) < fabs(y);
  const double xs = scale_x ? __dmul_rn(x, 0x1p1000) : x;
  const double ys = scale_x ? y : __dmul_rn(y, 0x1p1000);
  return __fma_rn(xs, ys, __dmul_rn(acc, 0x1p1000)) == 0.0 ? 0.0 : r;
}

// Strides are in elements; out is a contiguous [m, n].
template <typename T>
__global__ void __launch_bounds__(THREADS)
transform_product_kernel(const T* __restrict__ a, long long sa0,
                         long long sa1, const T* __restrict__ b,
                         long long sb0, long long sb1, T* __restrict__ out,
                         int m, int k, int n) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= m * n) return;
  const int i = e / n;
  const int j = e % n;
  const T* row = a + i * sa0;
  const T* col = b + j * sb1;
  // The float64 host chain takes rounded products where the row or the
  // column holds a non-finite value.
  bool chain = true;
  if (sizeof(T) == sizeof(double)) {
    for (int q = 0; q < k; ++q) {
      chain = chain && isfinite(row[q * sa1]) && isfinite(col[q * sb0]);
    }
  }
  T acc = product(row[0], col[0]);
  for (int q = 1; q < k; ++q) {
    const T x = row[q * sa1];
    const T y = col[q * sb0];
    acc = chain ? fused(x, y, acc) : sum(acc, product(x, y));
  }
  out[e] = acc;
}

template <typename T>
int launch(const void* a, long long sa0, long long sa1, const void* b,
           long long sb0, long long sb1, void* out, int m, int k, int n,
           cudaStream_t stream) {
  const int blocks = (m * n + THREADS - 1) / THREADS;
  transform_product_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(a), sa0, sa1, static_cast<const T*>(b), sb0,
      sb1, static_cast<T*>(out), m, k, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// a: [m, k] with strides sa0, sa1; b: [k, n] with strides sb0, sb1 (in
// elements); out: contiguous [m, n]; float32 (is_double 0) or float64 (1),
// all on `device`; m, n, k >= 1 and m * n < 2^31 (the wrapper checks).
// Launches on `stream` without synchronizing and returns the cudaError_t
// of the launch (0 on success).
int transform_product_launch(const void* a, long long sa0, long long sa1,
                             const void* b, long long sb0, long long sb1,
                             void* out, int m, int k, int n, int is_double,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return launch<double>(a, sa0, sa1, b, sb0, sb1, out, m, k, n, s);
  }
  return launch<float>(a, sa0, sa1, b, sb0, sb1, out, m, k, n, s);
}

}  // extern "C"
