// The EDT's signed combine (Hopper, sm_90a): two float32 fields of squared
// distances in voxels, a (to the filled set) and b (to the free set), into
// the signed distance out = sqrt(a) * res - sqrt(b) * res, written as
// float32 or float64; and its one-field forms, out = sqrt(a) * res and
// out = out - sqrt(b) * res, which the streamed EDT takes in float64.
//
// Replaces no TPU kernel. The JAX package combines with XLA elementwise
// operations (voxelized_geometry_tools_tpu/ops/edt.py:229 and :346-350).
// Run eagerly in PyTorch through float64 (a cast of each field, a square
// root, a cast back, a product a field, a difference), the combine is a
// chain of whole-grid passes with 1 GiB float64 temporaries: 5.2 ms a 512^3
// frame on an H100, 22.3 ms at 1024 x 1024 x 512 in float64 chunks.
//
// Exactness. Bit for bit the plain version (kernels/edt_combine.py), for
// any float32 input: in float32 each step is one correctly rounded
// operation, __fsqrt_rn, __fmul_rn, __fsub_rn (explicit, so no multiply
// and subtract contract into an FMA, whatever the flags). The correctly
// rounded float32 root equals the plain version's float64 root rounded
// once to float32 (53 >= 2 * 24 + 2). In float64 the input widens exactly
// and __dsqrt_rn, __dmul_rn, __dsub_rn round each step. res is rounded to
// the output type by the host, as torch.tensor(resolution, dtype) rounds
// it. +inf gives +inf and inf - inf NaN, as the eager operations give.
//
// What bounds it on the H100: bytes. Each input is read once and the
// result written once: 12 B a voxel in float32 (at 512^3 from the stacked
// [1024, 512, 512] field, 1,610,612,736 B, 0.481 ms at 3.35 TB/s; in place
// over a 2^29 field, 6,442,450,944 B, 1.923 ms). Two correctly rounded
// square roots a voxel are a few tens of instructions, far below the
// card's rates.
//
// Design: one streaming pass, no intermediate in device memory.
// - A thread takes groups of 4 consecutive voxels: one 16-byte load of
//   each field it reads (float4), one 16-byte store of float32 results or
//   two of float64 results (double2), so a warp moves 512 contiguous bytes
//   an access of each input.
// - Inputs are read with streaming loads (__ldcs, evict-first, coherent:
//   out may be a itself, since each voxel is read and then written by the
//   same thread and nothing else touches it).
// - Each thread keeps UNROLL groups in flight (all their loads issued
//   before the first root), and a grid of as many blocks as every SM holds
//   at once strides over the groups, so no block waits for a second wave.
// - The 16-byte path needs every pointer it touches 16-byte aligned; the
//   last n % 4 voxels, or every voxel where that does not hold, take a
//   scalar path with the same arithmetic.
// - Indices are 64-bit: 2^29 voxels of float64 pass 2^31 bytes.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// 4-voxel groups each thread has in flight.
constexpr int UNROLL = 4;

// The forms: both fields; the first alone; the second alone, subtracted
// from what out holds.
constexpr int BOTH = 0;
constexpr int FIRST = 1;
constexpr int SUBTRACT_SECOND = 2;

__device__ __forceinline__ float scaled_root(float d2, float res) {
  return __fmul_rn(__fsqrt_rn(d2), res);
}

__device__ __forceinline__ double scaled_root(float d2, double res) {
  return __dmul_rn(__dsqrt_rn(static_cast<double>(d2)), res);
}

__device__ __forceinline__ float difference(float x, float y) {
  return __fsub_rn(x, y);
}

__device__ __forceinline__ double difference(double x, double y) {
  return __dsub_rn(x, y);
}

// One voxel of the form: a and b are the fields' squared distances, prior
// what out holds (read only by SUBTRACT_SECOND).
template <typename T, int FORM>
__device__ __forceinline__ T combine(float a, float b, T prior, T res) {
  if constexpr (FORM == BOTH) {
    return difference(scaled_root(a, res), scaled_root(b, res));
  } else if constexpr (FORM == FIRST) {
    return scaled_root(a, res);
  } else {
    return difference(prior, scaled_root(b, res));
  }
}

__device__ __forceinline__ void load4(const float* p, long long g,
                                      float (&x)[4]) {
  const float4 q = __ldcs(reinterpret_cast<const float4*>(p) + g);
  x[0] = q.x;
  x[1] = q.y;
  x[2] = q.z;
  x[3] = q.w;
}

__device__ __forceinline__ void load4(const double* p, long long g,
                                      double (&x)[4]) {
  const double2* q = reinterpret_cast<const double2*>(p) + 2 * g;
  const double2 lo = __ldcs(q);
  const double2 hi = __ldcs(q + 1);
  x[0] = lo.x;
  x[1] = lo.y;
  x[2] = hi.x;
  x[3] = hi.y;
}

__device__ __forceinline__ void store4(float* p, long long g,
                                       const float (&x)[4]) {
  reinterpret_cast<float4*>(p)[g] = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void store4(double* p, long long g,
                                       const double (&x)[4]) {
  double2* q = reinterpret_cast<double2*>(p) + 2 * g;
  q[0] = make_double2(x[0], x[1]);
  q[1] = make_double2(x[2], x[3]);
}

// Groups [0, groups) by 16-byte accesses, then voxels [4 groups, n) one at
// a time. a, b and out are not __restrict__: out may be a or b itself.
template <typename T, int FORM>
__global__ void __launch_bounds__(THREADS)
edt_combine_kernel(const float* a, const float* b, T* out, long long n,
                   long long groups, T res) {
  const long long tile = static_cast<long long>(THREADS) * UNROLL;
  for (long long g0 = blockIdx.x * tile + threadIdx.x; g0 < groups;
       g0 += gridDim.x * tile) {
    float x[UNROLL][4] = {};
    float y[UNROLL][4] = {};
    T prior[UNROLL][4] = {};
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * THREADS;
      if (g < groups) {
        if constexpr (FORM != SUBTRACT_SECOND) load4(a, g, x[u]);
        if constexpr (FORM != FIRST) load4(b, g, y[u]);
        if constexpr (FORM == SUBTRACT_SECOND) load4(out, g, prior[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * THREADS;
      if (g < groups) {
        T r[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          r[k] = combine<T, FORM>(x[u][k], y[u][k], prior[u][k], res);
        }
        store4(out, g, r);
      }
    }
  }
  for (long long i = 4 * groups +
                     static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * THREADS) {
    const float x = FORM != SUBTRACT_SECOND ? __ldcs(a + i) : 0.0f;
    const float y = FORM != FIRST ? __ldcs(b + i) : 0.0f;
    const T prior = FORM == SUBTRACT_SECOND ? out[i] : T(0);
    out[i] = combine<T, FORM>(x, y, prior, res);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, int FORM>
int launch(const float* a, const float* b, T* out, long long n, T res,
           int device, cudaStream_t stream) {
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edt_combine_kernel<T, FORM>, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(out) &&
                   (FORM == SUBTRACT_SECOND || aligned16(a)) &&
                   (FORM == FIRST || aligned16(b));
  const long long groups = vec ? n / 4 : 0;
  const long long work = groups > 0 ? groups : n;
  const long long per_block =
      groups > 0 ? static_cast<long long>(THREADS) * UNROLL : THREADS;
  const long long resident = static_cast<long long>(sms) * per_sm;
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  edt_combine_kernel<T, FORM><<<static_cast<unsigned>(blocks), THREADS, 0,
                                stream>>>(a, b, out, n, groups, res);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_form(const float* a, const float* b, T* out, long long n, T res,
                int form, int device, cudaStream_t stream) {
  switch (form) {
    case BOTH:
      return launch<T, BOTH>(a, b, out, n, res, device, stream);
    case FIRST:
      return launch<T, FIRST>(a, b, out, n, res, device, stream);
    case SUBTRACT_SECOND:
      return launch<T, SUBTRACT_SECOND>(a, b, out, n, res, device, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// a, b: float32 [n_voxels] (a unused by form 2, b by form 1); out: float32
// (out_double 0) or float64 (1) [n_voxels]; all C-contiguous, out either a
// or b itself or apart from both; n_voxels >= 1 (the wrapper checks).
// form: 0 out = sqrt(a) res - sqrt(b) res; 1 out = sqrt(a) res; 2 out =
// out - sqrt(b) res. resolution is rounded to out's type here. Launches
// on `stream` without synchronizing and returns the cudaError_t of the
// launch (0 on success).
int edt_combine_launch(const float* a, const float* b, void* out,
                       long long n_voxels, double resolution, int out_double,
                       int form, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (out_double) {
    return launch_form<double>(a, b, static_cast<double*>(out), n_voxels,
                               resolution, form, device, s);
  }
  return launch_form<float>(a, b, static_cast<float*>(out), n_voxels,
                            static_cast<float>(resolution), form, device, s);
}

}  // extern "C"
