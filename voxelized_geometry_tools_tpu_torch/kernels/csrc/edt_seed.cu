// The EDT's axis-0 seed pass (Hopper, sm_90a): for each (y, z) line of a
// bool mask [nx, ny, nz], the squared distance in voxels along x to the
// nearest True voxel (the filled field) and, with two fields, to the nearest
// False voxel (the free field), stacked as [fields * nx, ny, nz] float32,
// C-contiguous: rows [0, nx) the filled field, rows [nx, 2 nx) the free one.
// A line without a voxel of the sought kind reads +inf.
//
// Replaces no TPU kernel. The JAX package takes this pass with two XLA
// cummax prefix scans a field (voxelized_geometry_tools_tpu/ops/edt.py::
// _binary_squared_dist_last). Run eagerly in PyTorch, the same scans cost a
// field two movedim copies, four where and two flip passes, two cummax
// scans, a minimum and four blocking uploads of scalar constants, and the
// two fields a cat: about 25 ms for the 512^3 two-field pass on an H100,
// half of a mapping frame. This kernel computes the same values in one
// read of the mask.
//
// Exactness. Each value is float(m) * float(m) (m rounded to float, then
// one rounded multiply) for the least distance m to a seed on either side.
// The plain version rounds each side's distance and its square the same
// way and takes the lesser square; rounding is monotonic, so the least of
// the rounded squares is the rounded square of the least distance, and the
// two agree bit for bit at every nx (exact integers while m^2 < 2^24).
//
// What bounds it on the H100: bytes. The mask is read once (nx*ny*nz B)
// and the stacked field written once (4 * fields * nx*ny*nz B): at 512^3
// with two fields 134,217,728 + 1,073,741,824 B, 0.361 ms at 3.35 TB/s.
// Writes are 8/9 of it.
//
// Design. One thread owns one (y, z) line; a block takes 128 neighbouring
// lines, so the 32 threads of a warp hold 32 neighbouring z and every
// store of a step x is one coalesced 128-byte row segment a field.
// 1. Load: the thread reads its line's nx mask bytes once, 32 independent
//    loads a word (a warp reads 32 neighbouring bytes a load), and packs
//    them into nx / 32 words of bits in shared memory, word w of thread t
//    at bits[w * 128 + t] (no bank conflicts; no thread reads another's
//    words, so no barrier is needed).
// 2. Walk: all threads of a warp step x from 0 to nx - 1 together. Each
//    voxel is its own field's seed, so at every x one of the two outputs is
//    0, and the other is the squared distance to the nearest voxel of the
//    other kind. In a run [s, e) of equal voxels that voxel is s - 1 on the
//    left (if s > 0) or e on the right (if e < nx): the thread keeps s - 1,
//    e and the run's value in registers, and when x reaches e finds the
//    next run's end in its bits (first set bit of the word, xor'ed with
//    the run's value, beyond x: __ffs, word by word). Searches read shared
//    memory only, one word a run plus the words a run spans; the stores
//    never diverge. No intermediate goes to device memory.
// Long lines. The bits take 16 * nx bytes of shared memory a block; where
// that is more than a block of the device may hold (nx above 14,528 on an
// H100, edt_seed_packed_max_nx), the global variant skips step 1 and finds
// each run's end in the mask itself, a byte at a time: the search passes
// each voxel once, so the mask is read about twice, the second time from
// L1/L2 close behind the first. Same walk, same values.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;

// First index beyond x whose bit differs from v, or nx. Padding bits past
// nx are 0, so a run of True ends there at an index >= nx, clamped.
__device__ __forceinline__ int run_end(const uint32_t* my, int words, int nx,
                                       int x, bool v) {
  const uint32_t flip = v ? 0xffffffffu : 0u;
  int w = x >> 5;
  uint32_t word = (my[w * THREADS] ^ flip) & ((0xffffffffu << (x & 31)) << 1);
  while (word == 0) {
    if (++w >= words) return nx;
    word = my[w * THREADS] ^ flip;
  }
  return min(nx, (w << 5) + __ffs(word) - 1);
}

// The same from the mask itself (the global variant): p is the line's
// first byte, sx its stride along x.
__device__ __forceinline__ int run_end(const unsigned char* p, long long sx,
                                       int nx, int x, bool v) {
  int i = x + 1;
  while (i < nx && (p[i * sx] != 0) == v) ++i;
  return i;
}

template <int FIELDS, bool PACKED>
__global__ void __launch_bounds__(THREADS)
edt_seed_kernel(const unsigned char* __restrict__ mask,
                float* __restrict__ out, int nx, long long lines, long long nz,
                long long sx, long long sy, long long sz) {
  extern __shared__ uint32_t bits[];
  const long long l = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (l >= lines) return;
  uint32_t* my = bits + threadIdx.x;
  const int words = (nx + 31) >> 5;

  const long long y = l / nz;
  const unsigned char* p = mask + y * sy + (l - y * nz) * sz;
  for (int w = 0; PACKED && w < words; ++w) {
    const int x0 = w << 5;
    uint32_t word = 0;
    if (x0 + 32 <= nx) {
#pragma unroll
      for (int i = 0; i < 32; ++i)
        word |= static_cast<uint32_t>(p[(x0 + i) * sx] != 0) << i;
    } else {
      for (int i = 0; x0 + i < nx; ++i)
        word |= static_cast<uint32_t>(p[(x0 + i) * sx] != 0) << i;
    }
    my[w * THREADS] = word;
  }

  const float inf = __int_as_float(0x7f800000);
  float* o_filled = out + l;
  float* o_free = out + static_cast<long long>(nx) * lines + l;
  bool v = PACKED ? (my[0] & 1u) != 0 : p[0] != 0;
  int left = -1;  // s - 1 of the current run [s, e); -1 for none
  int e = PACKED ? run_end(my, words, nx, 0, v) : run_end(p, sx, nx, 0, v);
  for (int x = 0; x < nx; ++x) {
    if (x == e) {
      v = !v;
      left = x - 1;
      e = PACKED ? run_end(my, words, nx, x, v) : run_end(p, sx, nx, x, v);
    }
    int m = e < nx ? e - x : INT_MAX;
    if (left >= 0) m = min(m, x - left);
    const float fm = __int2float_rn(m);
    const float d = m == INT_MAX ? inf : __fmul_rn(fm, fm);
    const long long at = static_cast<long long>(x) * lines;
    o_filled[at] = v ? 0.0f : d;
    if (FIELDS == 2) o_free[at] = v ? d : 0.0f;
  }
}

// Shared memory of the packed variant's block for lines of nx voxels.
size_t packed_bytes(long long nx) {
  return static_cast<size_t>((nx + 31) / 32) * THREADS * sizeof(uint32_t);
}

template <int FIELDS, bool PACKED>
int launch(const unsigned char* mask, float* out, long long nx, long long ny,
           long long nz, long long sx, long long sy, long long sz,
           cudaStream_t stream) {
  const long long lines = ny * nz;
  const size_t smem = PACKED ? packed_bytes(nx) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        edt_seed_kernel<FIELDS, PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long blocks = (lines + THREADS - 1) / THREADS;
  edt_seed_kernel<FIELDS, PACKED><<<static_cast<unsigned>(blocks), THREADS,
                                    smem, stream>>>(
      mask, out, static_cast<int>(nx), lines, nz, sx, sy, sz);
  return static_cast<int>(cudaGetLastError());
}

template <int FIELDS>
int launch(const unsigned char* mask, float* out, long long nx, long long ny,
           long long nz, long long sx, long long sy, long long sz,
           bool packed, cudaStream_t stream) {
  return packed ? launch<FIELDS, true>(mask, out, nx, ny, nz, sx, sy, sz,
                                       stream)
                : launch<FIELDS, false>(mask, out, nx, ny, nz, sx, sy, sz,
                                        stream);
}

}  // namespace

extern "C" {

// The longest x axis whose bits the packed variant holds in a block's
// shared memory on `device` (0 on error); longer lines take the global
// variant.
long long edt_seed_packed_max_nx(int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess) {
    return 0;
  }
  return static_cast<long long>(optin) / packed_bytes(32) * 32;
}

// mask: bool [nx, ny, nz] with element (byte) strides (sx, sy, sz); out:
// [fields * nx, ny, nz] float32, C-contiguous; fields 1 or 2; 1 <= nx <
// 2^31 and ny * nz >= 1 (the wrapper checks). Launches on `stream` without
// synchronizing and returns the cudaError_t of the launch (0 on success).
int edt_seed_launch(const unsigned char* mask, float* out, long long nx,
                    long long ny, long long nz, long long sx, long long sy,
                    long long sz, int fields, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int optin = 0;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool packed = packed_bytes(nx) <= static_cast<size_t>(optin);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fields == 2
             ? launch<2>(mask, out, nx, ny, nz, sx, sy, sz, packed, s)
             : launch<1>(mask, out, nx, ny, nz, sx, sy, sz, packed, s);
}

}  // extern "C"
