// Exact 1-D squared-distance transform, best-first chunk order (Hopper, sm_90a).
//
//   d[b, q, l] = min_k (q - k)^2 + f[b, k, l]
//
// Replaces two TPU kernels of voxelized_geometry_tools_tpu/kernels/
// edt_pallas.py, both launched by parabolic_envelope_last_pallas_bestfirst:
// _bestfirst_cmin_kernel (edt_pallas.py:301, hoist_cmin=True: the chunk
// minima come in precomputed) and _bestfirst_kernel (edt_pallas.py:241,
// hoist_cmin=False: the kernel reduces them itself). It computes the same
// function with the port's own design, in three variants chosen by shape:
//
// * Staged (edt_bestfirst_staged_kernel), for every axis whose 32-line block
//   fits a block's shared memory (n up to 1,536 or 1,776, by layout).
// * Clustered (edt_bestfirst_cluster_kernel), for longer axes whose block
//   fits the shared memory of a thread block cluster of 2, 4 or 8 CTAs (n
//   up to 12,032 or 12,672, by layout): each CTA stages a contiguous share
//   of the block's rows, and the CTAs read each other's shares through
//   distributed shared memory.
// * Global (edt_bestfirst_kernel), above a cluster's reach: each warp reads
//   its rows from global memory, on the layout and tiles of edt_common.cuh,
//   with the chunk minima hoisted (a cmin input) or reduced by each warp
//   itself.
//
// The staged and clustered variants serve both hoist_cmin values: the
// minima are always formed in shared memory, so both give the same kernel
// and the same bits.
//
// Best-first order and stop (every variant). k is visited in chunks of CH
// rows. Each chunk c has the admissible bound geom(tile, c)^2 + cmin[c],
// where geom is the gap from the q tile to the chunk's nearest row and
// cmin[c] is the chunk's minimum over the tile's 32 lines. The warp visits
// chunks in ascending bound order (warp-wide argmin over the remaining
// bounds, kept in shared memory) and stops once the smallest remaining bound
// is >= every real entry of its tile (__all_sync). Every unvisited candidate
// is >= its chunk's bound, so it cannot lower any entry: the result equals
// the full min-plus for any f, negative values and +inf included. Chunks
// whose minimum is +inf are never read. The minima are taken over real lines
// and rows only, so no masked lane can hold the stop open.
//
// What bounds it on the H100. Bytes: f read once and d written once, 8 bytes
// per voxel (0.641 ms for a [1024, 512, 512] pass at 3.35 TB/s). Operations:
// no exact kernel forms fewer than one candidate per output, far below the
// bytes, so the bytes bind. What this kernel computes follows the data: one
// rounded add and one min per candidate, for the chunks its tile-level
// bounds do not rule out (edt_bestfirst.py::visit_count counts those chunks
// for a tile-level order; the group test below computes fewer candidates
// within them). PERF.md has the counts and the times against the bound.
//
// The staged design, against each bound:
// * One CTA per (b, 32-line block) copies the whole [n x 32] block into
//   dynamic shared memory with cp.async (16-byte pieces where the strides
//   and the base allow, else 4-byte ones), so f leaves HBM exactly once per
//   pass, coalesced along whichever axis is contiguous, and every chunk
//   visit of every q tile reads shared memory, not L2.
// * The CTA reduces the chunk minima once, from the staged block, its warps
//   splitting the chunks: no separate minima pass reads the field again.
// * Both pass layouts are read and written in place. Template kLinesContig:
//   lines on the contiguous axis (the y pass) stage as rows [k][32 lines], so
//   a warp reads one k-row of its 32 lines as one conflict-free wavefront and
//   stores each q row as one 128-byte line. Positions contiguous (the z
//   pass) stage as lines [l][k] with a line stride of 4 mod 32 words, so
//   each lane reads its line's chunk as four conflict-free 16-byte loads;
//   the warp's [TQ x 32] result goes out through a padded shared tile
//   (stride TQ + 1), one coalesced 128-byte run of q per line. No
//   transposed copy of the input or the output is made.
// * Fewer candidates than whole chunks: a visit tests each group of QG = 8
//   positions of the tile against the lane's own minimum over the chunk
//   (gap^2 + minimum, a bound on every candidate of the group) and skips a
//   group that no lane can lower. The chunk's squares are formed once per
//   visit from one int-to-float conversion; each candidate computed is one
//   __fadd_rn and one fminf, built with --fmad=false, as the plain version
//   rounds it. The fminf issues on the ALU pipe at half the FP32 rate, which
//   makes the visits the kernel's compute limit.
// * Warps per CTA: ptxas reports 125-128 registers a thread and no spills
//   (the __launch_bounds__ cap is 128; the d[32] minima, the chunk's 47
//   squares and its 16 rows live in registers), so 16 warps fill an SM's
//   65,536 registers. A 512-line axis stages 64-66 KiB, so two CTAs of 8
//   warps share an SM and one stages while the other computes (a lone CTA of
//   8 warps per SM is far slower: the loop needs the warps to hide its
//   latency); a 1024-line axis stages 128-130 KiB, one CTA of 16 warps. The
//   warps take q tiles from a shared counter, so a slow tile does not hold
//   its CTA's other warps idle.
//
// The clustered design. A 2048-line block is 256 KiB, above the 227 KiB a
// CTA may opt into, and the global variant reads every row of it from L2 for
// each visit (and, reducing the minima itself, all of it once per q tile:
// the field 64 times over at n = 2048). A cluster of C CTAs on neighbouring
// SMs holds the block between them: CTA r stages rows [r * S, (r + 1) * S)
// (S = ceil(n_ch / C) chunks) in the staged layouts, with the z layout's
// line stride taken from the share, and forms its chunks' minima, writing
// each into every CTA's minima array (map_shared_rank). Its warps take the
// q tiles whose first row it holds, so the nearest chunks of a tile, which
// best-first visits first, are mostly its own; a chunk of another CTA is
// read through distributed shared memory with the same loads. Once its own
// tiles are taken, a CTA's warps take a peer's remaining ones from the
// peer's counter (a remote atomicAdd), so no CTA of the cluster idles at
// the final barrier while another still walks its far tiles. C is the
// smallest of 2, 4, 8 whose share fits (edt_bestfirst.py::cluster_plan: C =
// 2 with 16 warps at n = 2048), so f leaves HBM once per pass, with no
// minima pass and no transposed copy.

#include <cooperative_groups.h>

#include "edt_staged.cuh"

namespace {

namespace cg = cooperative_groups;
using namespace edt;

__device__ __forceinline__ float chunk_bound(int q0, int c, float cmin) {
  const int gap_lo = q0 - (c * CH + CH - 1);
  const int gap_hi = c * CH - (q0 + TQ - 1);
  const float g = static_cast<float>(max(max(gap_lo, gap_hi), 0));
  return __fadd_rn(__fmul_rn(g, g), cmin);
}

// ---------------------------------------------------------------------------
// Global variant: f read from global memory, tiles of edt_common.cuh.

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

// ---------------------------------------------------------------------------
// Staged variant.

// Shared-memory plan of one CTA, in floats: the staged block (BlockGeom of
// edt_staged.cuh), the n_ch chunk minima, then one region per warp that
// holds its tile's bounds and, with positions contiguous, afterwards its
// [TQ][XS] output tile. edt_bestfirst.py::staged_smem_bytes mirrors it.
struct StagedLayout : BlockGeom {
  int region;
  __host__ __device__ size_t bytes(int warps) const {
    return sizeof(float) * (static_cast<size_t>(block) + n_ch +
                            static_cast<size_t>(warps) * region);
  }
};

__host__ __device__ inline StagedLayout staged_layout(int n,
                                                      bool lines_contig) {
  StagedLayout g;
  static_cast<BlockGeom&>(g) = block_geom(n, lines_contig);
  if (lines_contig) {
    g.region = g.n_ch;
  } else {
    g.region = g.n_ch > TQ * XS ? g.n_ch : TQ * XS;
  }
  return g;
}

// An order-preserving map of floats (NaN excluded) to unsigned ints, so a
// warp-wide minimum is one redux.sync, and its inverse.
__device__ __forceinline__ unsigned order_key(float v) {
  const unsigned u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_value(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// The minima of the staged chunks first, first + step, ... below n_ch (one
// warp each; pads are +inf): lane 0 calls store(c, minimum of chunk c).
template <bool kLinesContig, typename Store>
__device__ __forceinline__ void block_minima(const float* fs, int stride,
                                             int n_ch, int first, int step,
                                             Store store) {
  const int lane = threadIdx.x & 31;
  for (int c = first; c < n_ch; c += step) {
    float fk[CH];
    load_chunk<kLinesContig>(fk, fs, stride, c * CH, lane);
    fold_halves<CH / 2>(fk, [](float a, float b) { return fminf(a, b); });
    const unsigned m = __reduce_min_sync(FULL, order_key(fk[0]));
    if (lane == 0) store(c, key_value(m));
  }
}

// The remaining chunk with the smallest bound in this warp's bounds (the
// lowest on a tie), by two redux.sync; kmin gets its order_key. Spent
// chunks hold +inf, which stops any tile.
__device__ __forceinline__ int next_chunk(const float* bounds, int n_ch,
                                          unsigned& kmin) {
  const int lane = threadIdx.x & 31;
  unsigned key = 0xffffffffu;
  unsigned bc = 0xffffffffu;
  for (int c = lane; c < n_ch; c += 32) {
    const unsigned k = order_key(bounds[c]);
    if (k < key) { key = k; bc = c; }
  }
  kmin = __reduce_min_sync(FULL, key);
  return static_cast<int>(
      __reduce_min_sync(FULL, key == kmin ? bc : 0xffffffffu));
}

// One warp's [TQ x 32] output tile at q0 (nl real lines) over the n_ch
// chunks of the axis, whose minima are cmin: best-first, each chunk's rows
// from load(fk, c), then the store to ob, the block's first line in the
// output (position q of line i at ob + q * oK + i * oL). region: this
// warp's scratch (the bounds of n_ch chunks and, in the z layout,
// afterwards its [TQ][XS] output tile).
template <bool kLinesContig, typename Load>
__device__ __forceinline__ void bestfirst_tile(const float* cmin,
                                               float* region, int n_ch, int n,
                                               int q0, int nl, float* ob,
                                               long long oK, long long oL,
                                               Load load) {
  const int lane = threadIdx.x & 31;
  const int q_count = min(TQ, n - q0);
  const bool line_ok = lane < nl;
  for (int c = lane; c < n_ch; c += 32) {
    region[c] = chunk_bound(q0, c, cmin[c]);
  }
  __syncwarp();
  // Lanes past the last line report -inf.
  float d[TQ];
  init_staged_tile(d, q_count);
  // Best-first: the smallest remaining bound (lowest chunk on a tie), until
  // it is >= every real entry of the tile.
  while (true) {
    unsigned kmin;
    const int c = next_chunk(region, n_ch, kmin);
    const float dmax = line_ok ? tile_max(d) : -CUDART_INF_F;
    if (__all_sync(FULL, dmax <= key_value(kmin))) break;
    float fk[CH];
    load(fk, c);
    visit_groups(d, fk, q0, c * CH);
    if (lane == (c & 31)) region[c] = CUDART_INF_F;
    __syncwarp();
  }

  // Through the region (the bounds are spent) in the z layout.
  store_staged_tile<kLinesContig>(d, region, q0, q_count, nl, ob, oK, oL);
}

// One CTA per (b, 32-line block): all kWarps warps stage it and form its
// minima, then take its q tiles from a shared counter. f and out: [B, n, L]
// with element strides (sB, sK, sL) and (oB, oK, oL).
template <bool kLinesContig, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
edt_bestfirst_staged_kernel(const float* __restrict__ f,
                            float* __restrict__ out, int n, int L, int n_lb,
                            long long sB, long long sK, long long sL,
                            long long oB, long long oK, long long oL,
                            bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_next_tile;
  const StagedLayout g = staged_layout(n, kLinesContig);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long b = blockIdx.x / n_lb;
  const int l0 = static_cast<int>(blockIdx.x % n_lb) * LINES;
  const int nl = min(LINES, L - l0);
  float* fs = smem;
  float* cmin = smem + g.block;
  float* region = cmin + g.n_ch + warp * g.region;

  stage_block<kLinesContig>(fs, f + b * sB + l0 * sL, g, n, nl, sK, sL, vec,
                            threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) s_next_tile = kWarps;
  cp_async_wait_all();
  __syncthreads();
  block_minima<kLinesContig>(fs, g.stride, g.n_ch, warp, kWarps,
                             [&](int c, float m) { cmin[c] = m; });
  __syncthreads();

  const auto load = [&](float (&fk)[CH], int c) {
    load_chunk<kLinesContig>(fk, fs, g.stride, c * CH, lane);
  };
  const int n_qt = (n + TQ - 1) / TQ;
  for (int qt = warp; qt < n_qt;) {
    bestfirst_tile<kLinesContig>(cmin, region, g.n_ch, n, qt * TQ, nl,
                                 out + b * oB + l0 * oL, oK, oL, load);
    int next = 0;
    if (lane == 0) next = atomicAdd(&s_next_tile, 1);
    qt = __shfl_sync(FULL, next, 0);
  }
}

// ---------------------------------------------------------------------------
// Clustered variant.

// Shared-memory plan of one CTA of a cluster of `cluster` CTAs, in floats:
// its share of the block (BlockGeom of share.n_ch = ceil(n_ch / cluster)
// chunks: rows [share.n16][32], or lines [32][stride] with stride = 4 mod
// 32), the minima of all n_ch chunks of the axis, then one region per warp
// (as StagedLayout's, for n_ch chunks).
// edt_bestfirst.py::cluster_smem_bytes mirrors it.
struct ClusterLayout {
  BlockGeom share;
  int n_ch, region;
  __host__ __device__ size_t bytes(int warps) const {
    return sizeof(float) * (static_cast<size_t>(share.block) + n_ch +
                            static_cast<size_t>(warps) * region);
  }
};

__host__ __device__ inline ClusterLayout cluster_layout(int n,
                                                        bool lines_contig,
                                                        int cluster) {
  ClusterLayout g;
  g.n_ch = (n + CH - 1) / CH;
  g.share = block_geom((g.n_ch + cluster - 1) / cluster * CH, lines_contig);
  g.region = lines_contig || g.n_ch > TQ * XS ? g.n_ch : TQ * XS;
  return g;
}

// One cluster of `cluster` CTAs per (b, 32-line block). CTA r stages rows
// [r * share.n16, (r + 1) * share.n16) of the block (its chunks r *
// share.n_ch, ...), forms their minima and writes each into every CTA's
// cmin (distributed shared memory); then its warps take the q tiles whose
// first row it holds from its own counter, then its peers' leftovers from
// theirs, reading a chunk another CTA holds through distributed shared
// memory. Cluster barriers: after the stage (every CTA has started and
// staged), after the minima, and before exit (a CTA's rows must outlive its
// peers' last reads).
template <bool kLinesContig, int kWarps>
__global__ void __launch_bounds__(kWarps * 32, 16 / kWarps)
edt_bestfirst_cluster_kernel(const float* __restrict__ f,
                             float* __restrict__ out, int n, int L, int n_lb,
                             int cluster, long long sB, long long sK,
                             long long sL, long long oB, long long oK,
                             long long oL, bool vec) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_next_tile;
  cg::cluster_group cl = cg::this_cluster();
  const ClusterLayout g = cluster_layout(n, kLinesContig, cluster);
  const int rank = static_cast<int>(cl.block_rank());
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long line_block = blockIdx.x / cluster;
  const long long b = line_block / n_lb;
  const int l0 = static_cast<int>(line_block % n_lb) * LINES;
  const int nl = min(LINES, L - l0);
  const int row0 = rank * g.share.n16;
  const int rows = max(0, min(g.share.n16, n - row0));
  float* fs = smem;
  float* cmin = smem + g.share.block;
  float* region = cmin + g.n_ch + warp * g.region;

  stage_block<kLinesContig>(fs, f + b * sB + l0 * sL + row0 * sK, g.share,
                            rows, nl, sK, sL, vec, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) s_next_tile = 0;
  cp_async_wait_all();
  cl.sync();
  const int c0 = rank * g.share.n_ch;
  block_minima<kLinesContig>(
      fs, g.share.stride, min(g.share.n_ch, g.n_ch - c0), warp, kWarps,
      [&](int c, float m) {
        for (int r = 0; r < cluster; ++r) {
          cl.map_shared_rank(cmin, r)[c0 + c] = m;
        }
      });
  cl.sync();

  const auto load = [&](float (&fk)[CH], int c) {
    const int owner = c / g.share.n_ch;
    const int k0 = (c - owner * g.share.n_ch) * CH;
    if (owner == rank) {
      load_chunk<kLinesContig>(fk, fs, g.share.stride, k0, lane);
    } else {
      load_chunk<kLinesContig>(fk, cl.map_shared_rank(fs, owner),
                               g.share.stride, k0, lane);
    }
  };
  // The q tiles whose first row lies in CTA v's share come from v's
  // counter: this CTA's own first, then each peer's in turn, so a CTA whose
  // tiles end early takes the rest of a slower peer's.
  int victim = rank;
  while (true) {
    const int v_row0 = victim * g.share.n16;
    const int v_qt0 = (v_row0 + TQ - 1) / TQ;
    const int v_end = (min(v_row0 + g.share.n16, n) + TQ - 1) / TQ;
    int next = 0;
    if (lane == 0) {
      next = atomicAdd(cl.map_shared_rank(&s_next_tile, victim), 1);
    }
    const int qt = v_qt0 + __shfl_sync(FULL, next, 0);
    if (qt < v_end) {
      bestfirst_tile<kLinesContig>(cmin, region, g.n_ch, n, qt * TQ, nl,
                                   out + b * oB + l0 * oL, oK, oL, load);
      continue;
    }
    victim = victim + 1 == cluster ? 0 : victim + 1;
    if (victim == rank) break;
  }
  cl.sync();
}

// The launch of the clustered variant: one cluster of `cluster` CTAs of
// `warps` warps per (b, 32-line block), the kernel's shared memory opted
// into. config and attr are filled; the caller passes them to
// cudaLaunchKernelEx or cudaOccupancyMaxActiveClusters.
template <bool kLinesContig>
cudaError_t cluster_config(long long B, int n, int L, int cluster, int warps,
                           cudaStream_t stream, const void** kernel,
                           cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr) {
  if ((warps != 8 && warps != 16) ||
      (cluster != 2 && cluster != 4 && cluster != 8)) {
    return cudaErrorInvalidValue;
  }
  *kernel = warps == 8
                ? reinterpret_cast<const void*>(
                      edt_bestfirst_cluster_kernel<kLinesContig, 8>)
                : reinterpret_cast<const void*>(
                      edt_bestfirst_cluster_kernel<kLinesContig, 16>);
  const size_t smem = cluster_layout(n, kLinesContig, cluster).bytes(warps);
  const cudaError_t err = cudaFuncSetAttribute(
      *kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(cluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(static_cast<unsigned>(
      B * ((L + LINES - 1) / LINES) * cluster));
  config->blockDim = dim3(warps * 32);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

template <bool kLinesContig>
cudaError_t launch_cluster(const float* f, float* out, long long B, int n,
                           int L, long long sB, long long sK, long long sL,
                           long long oB, long long oK, long long oL,
                           int cluster, int warps, bool vec,
                           cudaStream_t stream) {
  const void* kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  cudaError_t err = cluster_config<kLinesContig>(B, n, L, cluster, warps,
                                                 stream, &kernel, &config,
                                                 &attr);
  if (err != cudaSuccess) return err;
  int n_lb = (L + LINES - 1) / LINES;
  void* args[] = {&f, &out, &n, &L, &n_lb, &cluster,
                  &sB, &sK, &sL, &oB, &oK, &oL, &vec};
  err = cudaLaunchKernelExC(&config, kernel, args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <bool kLinesContig>
cudaError_t launch_staged(const float* f, float* out, long long B, int n,
                          int L, long long sB, long long sK, long long sL,
                          long long oB, long long oK, long long oL,
                          int warps, bool vec, cudaStream_t stream) {
  if (warps != 8 && warps != 16) return cudaErrorInvalidValue;
  const auto kernel = warps == 8
                          ? edt_bestfirst_staged_kernel<kLinesContig, 8>
                          : edt_bestfirst_staged_kernel<kLinesContig, 16>;
  const size_t smem = staged_layout(n, kLinesContig).bytes(warps);
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

// Global variant. f: [B, n, L] with element strides (sB, sK, sL); cmin:
// [B, ceil(L/32), ceil(n/CH)] contiguous, the minimum of f over each (line
// block, chunk), or null to have the kernel reduce the minima itself; out:
// [B, n, L] contiguous. Launches on `stream` without synchronizing and
// returns the cudaError_t of the launch (0 on success).
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

// Staged variant. f and out: [B, n, L] with element strides (sB, sK, sL)
// and (oB, oK, oL), not overlapping; lines_contiguous: sL == 1 (the y
// pass's layout), else sK == 1 (the z pass's); warps: 8 or 16 per CTA.
// Other strides are read correctly but not coalesced. Launches on `stream`
// without synchronizing and returns the cudaError_t (0 on success).
int edt_bestfirst_staged_launch(const float* f, float* out, long long B,
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

// Clustered variant: as the staged one, with `cluster` (2, 4 or 8) CTAs of
// `warps` warps per (b, 32-line block). The wrapper checks first that such
// a cluster can be resident (edt_bestfirst_cluster_max_active).
int edt_bestfirst_cluster_launch(const float* f, float* out, long long B,
                                 long long n, long long L, long long sB,
                                 long long sK, long long sL, long long oB,
                                 long long oK, long long oL,
                                 int lines_contiguous, int cluster, int warps,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool even = sB % 4 == 0 && aligned16(f);
  const int ni = static_cast<int>(n);
  const int Li = static_cast<int>(L);
  if (lines_contiguous) {
    err = launch_cluster<true>(f, out, B, ni, Li, sB, sK, sL, oB, oK, oL,
                               cluster, warps,
                               even && sL == 1 && sK % 4 == 0, st);
  } else {
    err = launch_cluster<false>(f, out, B, ni, Li, sB, sK, sL, oB, oK, oL,
                                cluster, warps,
                                even && sK == 1 && sL % 4 == 0, st);
  }
  return static_cast<int>(err);
}

// Clusters of the clustered variant for an axis of n that the device can
// hold at once (cudaOccupancyMaxActiveClusters); -1 on error.
int edt_bestfirst_cluster_max_active(long long n, int lines_contiguous,
                                     int cluster, int warps, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  const void* kernel;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  const int ni = static_cast<int>(n);
  const cudaError_t err =
      lines_contiguous
          ? cluster_config<true>(1, ni, LINES, cluster, warps, nullptr,
                                 &kernel, &config, &attr)
          : cluster_config<false>(1, ni, LINES, cluster, warps, nullptr,
                                  &kernel, &config, &attr);
  if (err != cudaSuccess) return -1;
  int count = 0;
  if (cudaOccupancyMaxActiveClusters(&count, kernel, &config) !=
      cudaSuccess) {
    return -1;
  }
  return count;
}

// Dynamic shared memory of one CTA of the clustered variant, in bytes (what
// the wrapper's cluster_smem_bytes must give).
long long edt_bestfirst_cluster_smem(long long n, int lines_contiguous,
                                     int cluster, int warps) {
  return static_cast<long long>(
      cluster_layout(static_cast<int>(n), lines_contiguous != 0, cluster)
          .bytes(warps));
}

// Dynamic shared memory of one staged CTA, in bytes (what the wrapper's
// staged_smem_bytes must give).
long long edt_bestfirst_staged_smem(long long n, int lines_contiguous,
                                    int warps) {
  return static_cast<long long>(
      staged_layout(static_cast<int>(n), lines_contiguous != 0)
          .bytes(warps));
}

int edt_bestfirst_chunk_rows() { return CH; }

int edt_bestfirst_tile_rows() { return TQ; }

}  // extern "C"
