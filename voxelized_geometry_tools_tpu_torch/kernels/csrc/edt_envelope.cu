// Exact 1-D squared-distance transform, full sweep (Hopper, sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// Replaces the TPU kernel voxelized_geometry_tools_tpu/kernels/edt_pallas.py::
// _envelope_kernel (launched by parabolic_envelope_last_pallas and
// squared_edt_pallas: backend "pallas"). It computes the same function with
// the port's own design. Every tile visits every chunk of k, in order, with
// no early exit: n^2 candidates per line whatever the data, exact for any f
// (+inf and negative values included). Each candidate is one __fadd_rn and
// one fminf, built with --fmad=false, as the plain version rounds it.
//
// What bounds it on the H100. The function's bound is the bytes (f read
// once, d written once: 0.641 ms for a [1024, 512, 512] pass at 3.35 TB/s),
// but a full sweep forms n^2 candidates per line by contract, so its own
// floor is the candidates' issue: an fminf issues on the ALU pipe at 64
// lanes a clock an SM, and each candidate takes two of an SM's 128 issue
// slots a clock, so both limits give 64 candidates a clock an SM (2^37
// candidates a 512^3 pass: 8.20 ms at the 1.98 GHz boost clock). Anything
// else the inner loop issues comes on top of that floor.
//
// Two variants, chosen by shape (edt_envelope.py::plan):
// * Staged (edt_envelope_staged_y / _z), wherever the 32-line block fits a
//   block's shared memory (edt_envelope.py::envelope_warps): one CTA per
//   (b, 32-line block) copies the [n x 32] block into shared memory with
//   cp.async (edt_staged.cuh), reading both pass layouts in place with no
//   transposed copy, and its warps take q tiles of that block. The inner
//   loop of a chunk is the 512 adds and 512 mins of its [TQ x CH]
//   candidates, one shared-memory load per row (four 16-byte loads a chunk
//   in the z layout) and 12 broadcast 16-byte loads of the chunk's 47
//   squares from a table of (x)^2 the CTA fills once: no conversion and no
//   arithmetic beyond the candidates. The stage is small next to the sweep
//   (64 KiB against about 66 us of candidates a CTA at n = 512), so it does
//   not overlap its own CTA's sweep; two 8-warp CTAs share an SM where they
//   fit, and one stages while the other sweeps. On an H100 the inner loop
//   issues 3 % (z) and 7 % (y) besides the candidates (kernels/
//   sass_mix.py), and the passes reach 0.85 (z) and 0.87 (y) of the floor
//   (PERF.md).
// * Global (edt_envelope_kernel), for longer axes: each warp reads its rows
//   from global memory on the layout and tiles of edt_common.cuh (lines on
//   the contiguous axis, a transposed copy where they are not).

#include "edt_staged.cuh"

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

// Shared-memory plan of one staged CTA, in floats: the staged block
// (BlockGeom), the squares table sq[i] = (i - n16 + 1)^2 for i < 2 n16 + 16,
// then, with the positions contiguous, one [TQ][XS] output tile per warp.
// edt_envelope.py::envelope_smem_bytes mirrors it.
struct EnvelopeLayout : BlockGeom {
  int squares, tile;
  __host__ __device__ size_t bytes(int warps) const {
    return sizeof(float) * (static_cast<size_t>(block) + squares +
                            static_cast<size_t>(warps) * tile);
  }
};

__host__ __device__ inline EnvelopeLayout envelope_layout(int n,
                                                          bool lines_contig) {
  EnvelopeLayout g;
  static_cast<BlockGeom&>(g) = block_geom(n, lines_contig);
  g.squares = 2 * g.n16 + 16;
  g.tile = lines_contig ? 0 : TQ * XS;
  return g;
}

// The [TQ x 32] tile at q0 against every chunk of the staged block, in
// order. sq[j] = (q0 - k0 - (CH - 1) + j)^2 = sqt[q0 - k0 + n16 - CH + j]:
// that start is a multiple of 16, so the chunk's squares are 12 aligned
// 16-byte loads that every lane of the warp reads alike.
template <bool kLinesContig>
__device__ __forceinline__ void sweep_tile(float (&d)[TQ], const float* fs,
                                           const float* sqt,
                                           const EnvelopeLayout& g, int q0,
                                           int lane) {
#pragma unroll
  for (int q = 0; q < TQ; ++q) d[q] = CUDART_INF_F;
  for (int c = 0; c < g.n_ch; ++c) {
    const int k0 = c * CH;
    float fk[CH];
    load_chunk<kLinesContig>(fk, fs, g.stride, k0, lane);
    float sq[SQ + 1];
    const float4* s4 =
        reinterpret_cast<const float4*>(sqt + q0 - k0 + g.n16 - CH);
#pragma unroll
    for (int i = 0; i < (SQ + 1) / 4; ++i) {
      const float4 v = s4[i];
      sq[4 * i] = v.x;
      sq[4 * i + 1] = v.y;
      sq[4 * i + 2] = v.z;
      sq[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int u = 0; u < CH; ++u) {
#pragma unroll
      for (int q = 0; q < TQ; ++q) {
        d[q] = fminf(d[q], __fadd_rn(sq[q - u + CH - 1], fk[u]));
      }
    }
  }
}

// One CTA per (b, 32-line block): all kWarps warps stage it and fill the
// squares table, then warp w sweeps q tiles w, w + kWarps, ... f and out:
// [B, n, L] with element strides (sB, sK, sL) and (oB, oK, oL).
template <bool kLinesContig, int kWarps>
__device__ __forceinline__ void staged_sweep(
    const float* __restrict__ f, float* __restrict__ out, int n, int L,
    int n_lb, long long sB, long long sK, long long sL, long long oB,
    long long oK, long long oL, bool vec) {
  extern __shared__ __align__(16) float smem[];
  const EnvelopeLayout g = envelope_layout(n, kLinesContig);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / n_lb;
  const int l0 = static_cast<int>(blockIdx.x % n_lb) * LINES;
  const int nl = min(LINES, L - l0);
  float* fs = smem;
  float* sqt = smem + g.block;
  float* xp = sqt + g.squares + warp * g.tile;

  stage_block<kLinesContig>(fs, f + b * sB + l0 * sL, g, n, nl, sK, sL, vec,
                            threadIdx.x, blockDim.x);
  // Exact: |i - n16 + 1| is below 2^12 and its square below 2^24.
  for (int i = threadIdx.x; i < g.squares; i += blockDim.x) {
    const float x = static_cast<float>(i - g.n16 + 1);
    sqt[i] = __fmul_rn(x, x);
  }
  cp_async_wait_all();
  __syncthreads();

  const int n_qt = (n + TQ - 1) / TQ;
  float* ob = out + b * oB + l0 * oL;
  for (int qt = warp; qt < n_qt; qt += kWarps) {
    const int q0 = qt * TQ;
    float d[TQ];
    sweep_tile<kLinesContig>(d, fs, sqt, g, q0, lane);
    store_staged_tile<kLinesContig>(d, xp, q0, min(TQ, n - q0), nl, ob, oK,
                                    oL);
  }
}

#define EDT_ENVELOPE_STAGED_ARGS                                           \
  const float* __restrict__ f, float* __restrict__ out, int n, int L,      \
      int n_lb, long long sB, long long sK, long long sL, long long oB,    \
      long long oK, long long oL, bool vec

// The y layout: at most 128 registers a thread (16 warps an SM); ptxas
// takes 94.
template <int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
edt_envelope_staged_y(EDT_ENVELOPE_STAGED_ARGS) {
  staged_sweep<true, kWarps>(f, out, n, L, n_lb, sB, sK, sL, oB, oK, oL,
                             vec);
}

// The z layout, capped at kZRegisters: left to the 128 a thread that 16
// warps an SM allow, ptxas takes 124 and orders the candidates by position
// (half the operand reuse of the y layout's loop), and the pass runs about
// 2.6 % slower on an H100 than at 96 (PERF.md).
constexpr int kZRegisters = 96;

template <int kWarps>
__global__ void __maxnreg__(kZRegisters)
edt_envelope_staged_z(EDT_ENVELOPE_STAGED_ARGS) {
  staged_sweep<false, kWarps>(f, out, n, L, n_lb, sB, sK, sL, oB, oK, oL,
                              vec);
}

#undef EDT_ENVELOPE_STAGED_ARGS

template <bool kLinesContig>
cudaError_t launch_staged(const float* f, float* out, long long B, int n,
                          int L, long long sB, long long sK, long long sL,
                          long long oB, long long oK, long long oL,
                          int warps, bool vec, cudaStream_t stream) {
  if (warps != 8 && warps != 16) return cudaErrorInvalidValue;
  const auto kernel =
      kLinesContig
          ? (warps == 8 ? edt_envelope_staged_y<8> : edt_envelope_staged_y<16>)
          : (warps == 8 ? edt_envelope_staged_z<8> : edt_envelope_staged_z<16>);
  const size_t smem = envelope_layout(n, kLinesContig).bytes(warps);
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

// Global variant. f: [B, n, L] with element strides (sB, sK, sL); out:
// [B, n, L] contiguous. Launches on `stream` without synchronizing and
// returns the cudaError_t of the launch (0 on success).
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

// Staged variant. f and out: [B, n, L] with element strides (sB, sK, sL)
// and (oB, oK, oL), not overlapping; lines_contiguous: sL == 1 (the y
// pass's layout), else sK == 1 (the z pass's); warps: 8 or 16 per CTA.
// Other strides are read correctly but not coalesced. Launches on `stream`
// without synchronizing and returns the cudaError_t (0 on success).
int edt_envelope_staged_launch(const float* f, float* out, long long B,
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
// envelope_smem_bytes must give).
long long edt_envelope_staged_smem(long long n, int lines_contiguous,
                                   int warps) {
  return static_cast<long long>(
      envelope_layout(static_cast<int>(n), lines_contiguous != 0)
          .bytes(warps));
}

}  // extern "C"
