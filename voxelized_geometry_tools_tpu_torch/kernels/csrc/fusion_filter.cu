// The fusion filter (Hopper, sm_90a): C cameras' int32 counter grids
// seen_free and seen_filled [C, n] and the static float32 occupancy [n],
// fused into a new float32 occupancy [n] (DoCombineAndFilterGrids: each
// camera votes by the CountsSeenAs rule; a static cell above 0.5 is kept,
// any other becomes 1.0 if some camera saw it filled, 0.0 if at least
// num_cameras_seen_free cameras saw it free, else 0.5).
//
// Replaces no TPU kernel. The JAX package fuses with XLA elementwise
// operations (voxelized_geometry_tools_tpu/ops/voxelize.py:1137-1170,
// counts_seen_as and combine_and_filter); this is the reference library's
// CUDA FilterGrids (cuda_voxelization_helpers.cu:358-426). Run eagerly in
// PyTorch, the same rule is about 30 whole-grid operations, each writing an
// int8, bool, int32 or float32 temporary that the next one reads back:
// 9.8 ms a one-camera 512^3 frame on an H100, 16.7 ms for two cameras.
//
// Exactness. Bit for bit the PyTorch version for any int32 counters and any
// float32 occupancy: the filtered count is `filled >= threshold ? filled :
// 0`; free + filtered wraps as PyTorch's int32 add does (added as unsigned,
// cast back: signed overflow is undefined in C++); pct is
// float(free) / max(float(sum), 1) with round-to-nearest conversions and an
// IEEE division (__int2float_rn, __fdiv_rn; no fast math, --fmad=false);
// `occupancy <= 0.5f` is false for NaN, which is kept, as torch.where
// keeps it.
//
// What bounds it on the H100: bytes. Each camera's two counters are read
// once and the occupancy read and written once: (8 C + 8) bytes a voxel,
// at 512^3 with one camera 2,147,483,648 B, 0.641 ms at 3.35 TB/s (two
// cameras 0.962 ms; 1024 x 1024 x 512 with one camera 2.564 ms). The work
// is a few integer compares a camera and, where a camera saw a voxel both
// free and filled, one division: far below the card's rates.
//
// Design: one streaming pass, no intermediate in device memory.
// - A thread takes groups of 4 consecutive voxels: one 16-byte load (int4)
//   of each counter a camera and one (float4) of the occupancy, one 16-byte
//   store of the result, so a warp moves 512 contiguous bytes an access.
// - It walks the C cameras at the same voxel offset (camera stride n) and
//   keeps two int32 tallies a voxel in registers: cameras that voted filled
//   and cameras that voted free. Nothing else is kept.
// - Every input is read exactly once, with streaming loads (__ldcs,
//   evict-first), so the counters do not push the output out of L2.
// - Each thread keeps UNROLL groups in flight (all their loads issued
//   before the first vote), and a grid of as many blocks as every SM
//   holds at once strides over the voxels, so no block waits for a second
//   wave.
// - The 16-byte path needs the four pointers 16-byte aligned and, for more
//   than one camera, n a multiple of 4 (so each camera's slice is aligned);
//   the last n % 4 voxels, or every voxel where that does not hold, take a
//   scalar path with the same rule.
// - Indices are 64-bit: C * n passes 2^31 at four cameras of 2^29 voxels.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
// 4-voxel groups each thread has in flight.
constexpr int UNROLL = 2;

struct Options {
  float percent_seen_free;
  int outlier_points_threshold;
  int num_cameras_seen_free;
};

// One camera's CountsSeenAs vote on one voxel, added to its tallies.
__device__ __forceinline__ void vote(int free, int filled, const Options& o,
                                     int& n_filled, int& n_free) {
  const int kept = filled >= o.outlier_points_threshold ? filled : 0;
  const bool seen_free = free > 0;
  const bool seen_filled = kept > 0;
  if (seen_free && seen_filled) {
    const int sum = static_cast<int>(static_cast<unsigned>(free) +
                                     static_cast<unsigned>(kept));
    const float pct = __fdiv_rn(__int2float_rn(free),
                                fmaxf(__int2float_rn(sum), 1.0f));
    if (pct >= o.percent_seen_free) {
      ++n_free;
    } else {
      ++n_filled;
    }
  } else if (seen_free) {
    ++n_free;
  } else if (seen_filled) {
    ++n_filled;
  }
}

__device__ __forceinline__ float fuse(float occupancy, int n_filled,
                                      int n_free, const Options& o) {
  const float fused = n_filled > 0 ? 1.0f
                      : n_free >= o.num_cameras_seen_free ? 0.0f
                                                           : 0.5f;
  return occupancy <= 0.5f ? fused : occupancy;
}

// Groups [0, groups) by 16-byte accesses, then voxels [4 groups, n) one at
// a time.
__global__ void __launch_bounds__(THREADS)
fusion_filter_kernel(const int* __restrict__ seen_free,
                     const int* __restrict__ seen_filled,
                     const float* __restrict__ occupancy,
                     float* __restrict__ out, long long cameras, long long n,
                     long long groups, Options o) {
  const long long tile = static_cast<long long>(THREADS) * UNROLL;
  for (long long g0 = blockIdx.x * tile + threadIdx.x; g0 < groups;
       g0 += gridDim.x * tile) {
    float4 occ[UNROLL] = {};
    int n_filled[UNROLL][4] = {};
    int n_free[UNROLL][4] = {};
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * THREADS;
      if (g < groups) {
        occ[u] = __ldcs(reinterpret_cast<const float4*>(occupancy) + g);
      }
    }
    for (long long c = 0; c < cameras; ++c) {
      const int4* free4 = reinterpret_cast<const int4*>(seen_free + c * n);
      const int4* filled4 =
          reinterpret_cast<const int4*>(seen_filled + c * n);
      int4 fr[UNROLL] = {};
      int4 fl[UNROLL] = {};
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const long long g = g0 + u * THREADS;
        if (g < groups) {
          fr[u] = __ldcs(free4 + g);
          fl[u] = __ldcs(filled4 + g);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        vote(fr[u].x, fl[u].x, o, n_filled[u][0], n_free[u][0]);
        vote(fr[u].y, fl[u].y, o, n_filled[u][1], n_free[u][1]);
        vote(fr[u].z, fl[u].z, o, n_filled[u][2], n_free[u][2]);
        vote(fr[u].w, fl[u].w, o, n_filled[u][3], n_free[u][3]);
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long g = g0 + u * THREADS;
      if (g < groups) {
        float4 r;
        r.x = fuse(occ[u].x, n_filled[u][0], n_free[u][0], o);
        r.y = fuse(occ[u].y, n_filled[u][1], n_free[u][1], o);
        r.z = fuse(occ[u].z, n_filled[u][2], n_free[u][2], o);
        r.w = fuse(occ[u].w, n_filled[u][3], n_free[u][3], o);
        reinterpret_cast<float4*>(out)[g] = r;
      }
    }
  }
  for (long long i = 4 * groups +
                     static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       i < n; i += static_cast<long long>(gridDim.x) * THREADS) {
    int n_filled = 0, n_free = 0;
    for (long long c = 0; c < cameras; ++c) {
      vote(__ldcs(seen_free + c * n + i), __ldcs(seen_filled + c * n + i), o,
           n_filled, n_free);
    }
    out[i] = fuse(__ldcs(occupancy + i), n_filled, n_free, o);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// seen_free, seen_filled: int32 [cameras, n_voxels]; occupancy, out:
// float32 [n_voxels]; all C-contiguous, out apart from every input;
// cameras >= 0 and n_voxels >= 1 (the wrapper checks). The options are
// the wrapper's: percent_seen_free rounded to float32, the two counts as
// the int32 the PyTorch version compares with. Launches on `stream`
// without synchronizing and returns the cudaError_t of the launch (0 on
// success).
int fusion_filter_launch(const int* seen_free, const int* seen_filled,
                         const float* occupancy, float* out,
                         long long cameras, long long n_voxels,
                         float percent_seen_free,
                         int outlier_points_threshold,
                         int num_cameras_seen_free, int device,
                         void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fusion_filter_kernel, THREADS, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = aligned16(occupancy) && aligned16(out) &&
                   (cameras == 0 ||
                    (aligned16(seen_free) && aligned16(seen_filled) &&
                     (cameras == 1 || n_voxels % 4 == 0)));
  const long long groups = vec ? n_voxels / 4 : 0;
  const long long work = groups > 0 ? groups : n_voxels;
  const long long per_block =
      groups > 0 ? static_cast<long long>(THREADS) * UNROLL : THREADS;
  const long long resident = static_cast<long long>(sms) * per_sm;
  long long blocks = (work + per_block - 1) / per_block;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;
  const Options o{percent_seen_free, outlier_points_threshold,
                  num_cameras_seen_free};
  fusion_filter_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      seen_free, seen_filled, occupancy, out, cameras, n_voxels, groups, o);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
