// Primitive-rate probes (Hopper, sm_90a): the H100's rates of the memory
// primitives a fused render march or carve kernel would be built from.
//
// Replaces the four TPU probe kernels of benchmarks/inkernel_microbench.py:
//   vmem_gather_kernel       <- _vmem_gather_kernel      (vmem_gather_bench)
//   vmem_scatter_kernel      <- _vmem_scatter_kernel     (vmem_scatter_bench)
//   hbm_dma_kernel<DEPTH>    <- _hbm_dma_kernel          (hbm_dma_bench)
//   vmem_batch_march_kernel  <- _vmem_batch_march_kernel (vmem_batch_march_bench)
// Each computes what its TPU kernel computes; block b is replica b, which
// runs the probe with seed + b into row b of the output (replica 0 is the
// TPU kernel's result).
//
// Row indices come from the TPU kernels' LCG: state = state * 1664525 +
// 1013904223 in wrapping 32-bit arithmetic, row = abs(int32(state)) %
// n_rows. abs(INT_MIN) would be negative on the TPU; the wrapper rejects a
// sequence that reaches it, so the unsigned form here is exact.
//
// What bounds each on the H100, and the design:
// * gather / scatter / march keep the TPU's VMEM operand (table or
//   accumulator) in dynamic shared memory; above 48 KiB the kernel opts in
//   with cudaFuncSetAttribute, and the wrapper refuses sizes beyond the
//   device's opt-in limit (227 KiB on the H100). One thread owns one
//   column and computes the uniform LCG itself, so a row access is one
//   conflict-free shared-memory wavefront; the rate is bounded by that
//   access's latency chain and the index arithmetic (a 32-bit remainder).
// * the march probe gives each ray its own thread, which jumps ahead in the
//   LCG to its own states (ray j of step k reads state k * batch + j + 1),
//   so the batch's gathers run in parallel, as a fused march would.
// * the HBM probe is a global-memory row gather through a DEPTH-stage
//   cp.async ring: one warp moves a row in 16-byte pieces (a 512-byte row
//   in one instruction), and cp.async.wait_group retires one stage per
//   step. One warp's rate stops growing past depth 8 and is the same from
//   L2 as from DRAM, so the card's bandwidth takes several warps per SM
//   (replicas a multiple of the SM count).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr uint32_t kLcgA = 1664525u;
constexpr uint32_t kLcgC = 1013904223u;

__device__ __forceinline__ uint32_t lcg_next(uint32_t s) {
  return s * kLcgA + kLcgC;
}

// abs(int32(s)) % n_rows for every s but 0x80000000.
__device__ __forceinline__ uint32_t lcg_row(uint32_t s, uint32_t n_rows) {
  const uint32_t a = (s & 0x80000000u) ? 0u - s : s;
  return a % n_rows;
}

__device__ __forceinline__ void copy_to_shared(float* dst,
                                               const float* __restrict__ src,
                                               int count) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) dst[i] = src[i];
}

__global__ void vmem_gather_kernel(const float* __restrict__ table,
                                   float* __restrict__ out, uint32_t n_rows,
                                   int width, long long n_iters,
                                   uint32_t seed) {
  extern __shared__ float tab[];
  copy_to_shared(tab, table, static_cast<int>(n_rows) * width);
  __syncthreads();
  const int w = threadIdx.x;
  if (w >= width) return;
  uint32_t s = seed + blockIdx.x;
  float acc = 0.0f;
  for (long long i = 0; i < n_iters; ++i) {
    s = lcg_next(s);
    acc += tab[lcg_row(s, n_rows) * width + w];
  }
  out[static_cast<size_t>(blockIdx.x) * width + w] = acc;
}

__global__ void vmem_scatter_kernel(const float* __restrict__ mask,
                                    float* __restrict__ out, uint32_t n_rows,
                                    int width, long long n_iters,
                                    uint32_t seed) {
  extern __shared__ float acc[];
  const int w = threadIdx.x;
  if (w >= width) return;
  // Each thread touches only its own column: no barrier is needed.
  for (uint32_t r = 0; r < n_rows; ++r) acc[r * width + w] = 0.0f;
  const float m = mask[w];
  uint32_t s = seed + blockIdx.x;
  for (long long i = 0; i < n_iters; ++i) {
    s = lcg_next(s);
    acc[lcg_row(s, n_rows) * width + w] += m;
  }
  float* dst = out + static_cast<size_t>(blockIdx.x) * n_rows * width;
  for (uint32_t r = 0; r < n_rows; ++r) dst[r * width + w] = acc[r * width + w];
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// One warp per block. Sums the first n_iters - DEPTH rows of the sequence;
// the last DEPTH copies are started and not summed, as on the TPU (they
// are waited for before the block exits, since its shared memory goes).
template <int DEPTH>
__global__ void __launch_bounds__(32)
hbm_dma_kernel(const float* __restrict__ table, float* __restrict__ out,
               uint32_t n_rows, int width, long long n_iters, uint32_t seed) {
  extern __shared__ float4 ring[];  // [DEPTH][width / 4]
  const int lane = threadIdx.x;
  const int pieces = width / 4;
  const bool active = lane < pieces;
  uint32_t s = seed + blockIdx.x;
  auto start = [&](int slot) {
    s = lcg_next(s);
    const uint32_t row = lcg_row(s, n_rows);
    if (active) {
      cp_async16(ring + slot * pieces + lane,
                 reinterpret_cast<const float4*>(
                     table + static_cast<size_t>(row) * width) + lane);
    }
    cp_async_commit();
  };
  for (int slot = 0; slot < DEPTH; ++slot) start(slot);
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long i = 0; i < n_iters - DEPTH; ++i) {
    const int slot = static_cast<int>(i % DEPTH);
    cp_async_wait<DEPTH - 1>();  // the oldest stage has landed
    if (active) {
      const float4 v = ring[slot * pieces + lane];
      acc.x += v.x;
      acc.y += v.y;
      acc.z += v.z;
      acc.w += v.w;
    }
    start(slot);
  }
  cp_async_wait<0>();
  if (active) {
    reinterpret_cast<float4*>(out + static_cast<size_t>(blockIdx.x) * width)
        [lane] = acc;
  }
}

// One thread per ray (blockDim == batch).
__global__ void vmem_batch_march_kernel(const float* __restrict__ table,
                                        const float* __restrict__ t0,
                                        float* __restrict__ out,
                                        uint32_t n_rows, int width,
                                        int n_steps, int batch,
                                        uint32_t seed) {
  extern __shared__ float tab[];
  copy_to_shared(tab, table, static_cast<int>(n_rows) * width);
  __syncthreads();
  const int j = threadIdx.x;
  uint32_t s = seed + blockIdx.x;
  for (int i = 0; i <= j; ++i) s = lcg_next(s);
  // (a_b, c_b): s -> a_b * s + c_b advances the state by `batch` steps.
  uint32_t a_b = 1u, c_b = 0u;
  for (int i = 0; i < batch; ++i) {
    a_b *= kLcgA;
    c_b = c_b * kLcgA + kLcgC;
  }
  float t = t0[j];
  for (int k = 0; k < n_steps; ++k) {
    const float* row = tab + lcg_row(s, n_rows) * width;
    float d = 0.0f;
    for (int w = 0; w < width; ++w) d += row[w] * 0.125f;
    t += fmaxf(d, 0.001f);
    s = a_b * s + c_b;
  }
  out[static_cast<size_t>(blockIdx.x) * batch + j] = t;
}

int threads_for(int width) {
  const int warps = (width + 31) / 32;
  return warps * 32 < 256 ? 256 : warps * 32;
}

cudaError_t opt_in_shared(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

template <int DEPTH>
cudaError_t launch_dma(const float* table, float* out, uint32_t n_rows,
                       int width, long long n_iters, uint32_t seed,
                       int replicas, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(DEPTH) * width * sizeof(float);
  hbm_dma_kernel<DEPTH><<<replicas, 32, smem, stream>>>(
      table, out, n_rows, width, n_iters, seed);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// The largest dynamic shared memory a block of `device` may opt into, in
// bytes (0 on error).
int probes_max_shared_bytes(int device) {
  int v = 0;
  if (cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return v;
}

// Every launcher: table/mask/t0 inputs and the output contiguous float32 on
// `device`; launches `replicas` blocks on `stream` without synchronizing
// and returns the cudaError_t (0 on success). The wrapper checks shapes and
// shared-memory sizes before calling.

int probe_vmem_gather_launch(const float* table, float* out, int n_rows,
                             int width, long long n_iters, int seed,
                             int replicas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_rows) * width * sizeof(float);
  err = opt_in_shared(reinterpret_cast<const void*>(vmem_gather_kernel), smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vmem_gather_kernel<<<replicas, threads_for(width), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      table, out, static_cast<uint32_t>(n_rows), width, n_iters,
      static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}

int probe_vmem_scatter_launch(const float* mask, float* out, int n_rows,
                              int width, long long n_iters, int seed,
                              int replicas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_rows) * width * sizeof(float);
  err = opt_in_shared(reinterpret_cast<const void*>(vmem_scatter_kernel),
                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vmem_scatter_kernel<<<replicas, (width + 31) / 32 * 32, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      mask, out, static_cast<uint32_t>(n_rows), width, n_iters,
      static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}

// depth in [1, 16]; width a multiple of 4, at most 128.
int probe_hbm_dma_launch(const float* table, float* out, long long n_rows,
                         int width, long long n_iters, int depth, int seed,
                         int replicas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rows = static_cast<uint32_t>(n_rows);
  const auto sd = static_cast<uint32_t>(seed);
  switch (depth) {
#define PROBE_DMA_CASE(D) \
    case D: \
      return static_cast<int>( \
          launch_dma<D>(table, out, rows, width, n_iters, sd, replicas, s));
    PROBE_DMA_CASE(1) PROBE_DMA_CASE(2) PROBE_DMA_CASE(3) PROBE_DMA_CASE(4)
    PROBE_DMA_CASE(5) PROBE_DMA_CASE(6) PROBE_DMA_CASE(7) PROBE_DMA_CASE(8)
    PROBE_DMA_CASE(9) PROBE_DMA_CASE(10) PROBE_DMA_CASE(11)
    PROBE_DMA_CASE(12) PROBE_DMA_CASE(13) PROBE_DMA_CASE(14)
    PROBE_DMA_CASE(15) PROBE_DMA_CASE(16)
#undef PROBE_DMA_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

int probe_vmem_batch_march_launch(const float* table, const float* t0,
                                  float* out, int n_rows, int width,
                                  int n_steps, int batch, int seed,
                                  int replicas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t smem = static_cast<size_t>(n_rows) * width * sizeof(float);
  err = opt_in_shared(reinterpret_cast<const void*>(vmem_batch_march_kernel),
                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  vmem_batch_march_kernel<<<replicas, batch, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      table, t0, out, static_cast<uint32_t>(n_rows), width, n_steps, batch,
      static_cast<uint32_t>(seed));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
