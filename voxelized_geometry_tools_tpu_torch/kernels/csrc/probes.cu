// Primitive-rate probes (Hopper, sm_90a): the H100's rates of the memory
// primitives a fused render march or carve kernel would be built from.
//
// Replaces the four TPU probe kernels of benchmarks/inkernel_microbench.py:
//   vmem_gather_split_kernel    <- _vmem_gather_kernel (vmem_gather_bench)
//   vmem_scatter_cluster_kernel <- _vmem_scatter_kernel (vmem_scatter_bench)
//   hbm_dma_kernel<DEPTH>       <- _hbm_dma_kernel (hbm_dma_bench)
//   vmem_batch_march_split_kernel <- _vmem_batch_march_kernel
//                                    (vmem_batch_march_bench)
// Each computes what its TPU kernel computes; replica r runs the probe with
// seed + r into row r of the output (replica 0 is the TPU kernel's result).
//
// Row indices come from the TPU kernels' LCG: state = state * 1664525 +
// 1013904223 in wrapping 32-bit arithmetic, row = abs(int32(state)) %
// n_rows. abs(INT_MIN) would be negative on the TPU; the wrapper rejects a
// sequence that reaches it, so the unsigned form here is exact. The LCG is
// affine, so k steps are one map s -> a_k s + c_k (mod 2^32): the wrapper
// computes each thread's or warp's first state map and the stride map, and
// a thread jumps to its own share of the sequence.
//
// What bounds each on the H100, and the design:
// * gather spreads one replica's sequence over `ctas` CTAs of 1,024
//   threads (probes.gather_plan: one CTA an SM for one replica, divided
//   among the replicas), each with its own copy of the table in dynamic
//   shared memory (opt-in above 48 KiB, refused past the device's 227 KiB),
//   staged with cp.async in 16-byte pieces. A row group of threads takes
//   a contiguous share of the sequence and sums it in order, each thread
//   two 16-byte pieces of a row (one thread a row at width 8; one float a
//   thread where the width is not a multiple of 8); groups, then CTAs (the
//   last to arrive), are summed in a fixed order, so every launch gives
//   the same bits. Bound:
//   the rows' shared-memory wavefronts (128 bytes a clock an SM, up to
//   about twice that many for random rows' bank conflicts) with many
//   replicas; the launch, the stage and the two reductions with one.
// * march: the row of (ray j, step k), and so its step value, depends only
//   on LCG state k * batch + j + 1, never on t; only the adds into t are
//   sequential. Rays are split over `ctas` CTAs a replica (never steps, so
//   nothing is reduced across CTAs); in a CTA, G threads a ray each take
//   every G-th step of a chunk of steps, several rows in flight a thread
//   (first state from host jump maps, then the map of G * batch states),
//   and write max(row sum, 0.001) into a shared [chunk][rays] buffer; after
//   a barrier one thread a ray adds its chunk into t in step order, so t
//   gets the sequential chain's bits. Rows come from the table staged in
//   shared memory by the gather's stage code (route "staged"; register
//   loads from a full CTA, else bulk copies; 16-byte loads of the rows,
//   each thread's first load taking the half of its row that spreads a
//   warp's loads over all bank quads) or straight from device memory
//   through L1/L2 with read-only 16-byte loads (route "direct": a CTA reads
//   only its rows). probes.march_plan picks the route and the split. Bound:
//   with one replica, the launch and one row's latency (direct) or the
//   stage (staged); with many, the rows' L1/L2 or shared-memory wavefronts.
// * scatter spreads one replica over a thread block cluster of 8 CTAs (the
//   portable size; probes.scatter_plan): each CTA owns a contiguous slice
//   of the accumulator's rows in its shared memory. Thread t of the
//   cluster takes column t % width of iterations t / width, t / width + P,
//   ... (P = the cluster's threads / width), and adds that column of the
//   mask into the owning CTA's slice with one remote float reduction into
//   distributed shared memory (mapa + red.shared::cluster.add.f32), so a
//   warp's reduction covers whole rows. Slices are zeroed and written out
//   in 16-byte stores, a cluster barrier on either side of the adds. Every
//   add into a cell adds the same mask value, so every order of the adds
//   gives the same partial sums: the sequential adds' bits. Bound: the
//   remote reductions (800,000 at the probe's shape) and the cluster
//   launch with its two barriers.
// * the HBM probe is a device-memory row gather; one warp is latency-bound
//   (~109 ns a row on an H100), so one replica's sequence is split into
//   contiguous shares over enough warps to fill the card, each keeping
//   DEPTH rows in flight through a cp.async ring (a lane moves 16 bytes).
//   Warps sum their rows in order, CTAs sum their warps in order into a
//   scratch row, and the last CTA of a replica to arrive sums the CTAs in
//   order (threadfence + arrival counter): the same bits on every run.
//   Bound: the rows' bytes at the HBM rate.

#include <algorithm>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr uint32_t kLcgA = 1664525u;
constexpr uint32_t kLcgC = 1013904223u;
constexpr int kScatterThreads = 1024;
constexpr int kScatterCluster = 8;
constexpr int kDmaWarps = 16;
constexpr int kGatherThreads = 1024;
constexpr uint32_t kBulkChunk = 16384;  // bytes of one bulk copy
constexpr int kMarchThreads = 1024;     // most threads of a march CTA
constexpr int kMarchUnroll = 4;         // rows a march thread has in flight

__device__ __forceinline__ uint32_t lcg_next(uint32_t s) {
  return s * kLcgA + kLcgC;
}

// abs(int32(s)) % n_rows for every s but 0x80000000.
__device__ __forceinline__ uint32_t lcg_row(uint32_t s, uint32_t n_rows) {
  const uint32_t a = (s & 0x80000000u) ? 0u - s : s;
  return a % n_rows;
}

// floor(a / d) for a < 2^31 by the wrapper's magic pair (m, shift) of d
// (probes.magic_divisor: m = ceil(2^shift / d), exact below 2^31).
__device__ __forceinline__ uint32_t magic_div(uint32_t a, uint32_t m,
                                              uint32_t shift) {
  return static_cast<uint32_t>((static_cast<uint64_t>(a) * m) >> shift);
}

__global__ void empty_kernel() {}

struct ScatterArgs {
  long long n_iters;
  uint32_t n_rows, rows_m, rows_shift;       // n_rows and its magic pair
  uint32_t rows_per_cta, slice_m, slice_shift;
  uint32_t slice_vec4;                       // float4s of a CTA's slice
  uint32_t rows_per_pass;                    // P = cluster threads / width
  uint32_t stride_a, stride_c;               // the LCG map of P steps
  uint32_t seed;
  uint32_t width;
};

__device__ __forceinline__ uint32_t map_to_rank(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void red_cluster_add(uint32_t addr, float v) {
  asm volatile("red.shared::cluster.add.f32 [%0], %1;\n"
               :: "r"(addr), "f"(v) : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// One cluster of kScatterCluster CTAs per replica (clusters along x). CTA
// k owns the accumulator's rows [k rows_per_cta, (k + 1) rows_per_cta) as
// a float slice in its shared memory. Thread t of the cluster's threads
// takes column t % width of iterations t / width + j P (starts[t / width]
// maps the seed to state t / width + 1, the stride map steps P states) and
// adds mask[column] into the owner's slice with a remote reduction.
__global__ void __launch_bounds__(kScatterThreads)
vmem_scatter_cluster_kernel(const float* __restrict__ mask,
                            float* __restrict__ out,
                            const uint2* __restrict__ starts,
                            ScatterArgs args) {
  extern __shared__ float4 slice[];
  const uint32_t rank = cg::this_cluster().block_rank();
  const uint32_t replica = blockIdx.x / kScatterCluster;
  for (uint32_t i = threadIdx.x; i < args.slice_vec4; i += blockDim.x) {
    slice[i] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  // Every slice is zeroed before any remote add lands; the wait comes
  // after the thread's set-up, which hides part of the barrier.
  cluster_arrive();

  const uint32_t width = args.width;
  const uint32_t t = rank * blockDim.x + threadIdx.x;
  const uint32_t first = t / width;
  const uint32_t column = t - first * width;
  const bool active = first < args.rows_per_pass;
  float m = 0.0f;
  uint32_t s = 0u;
  if (active) {
    m = __ldg(mask + column);
    const uint2 st = starts[first];
    s = st.x * (args.seed + replica) + st.y;
  }
  const uint32_t base =
      static_cast<uint32_t>(__cvta_generic_to_shared(slice)) + column * 4u;
  const uint32_t row_bytes = width * 4u;
  cluster_wait();

  if (active) {
    for (long long i = first; i < args.n_iters; i += args.rows_per_pass) {
      const uint32_t a = (s & 0x80000000u) ? 0u - s : s;
      const uint32_t row =
          a - magic_div(a, args.rows_m, args.rows_shift) * args.n_rows;
      const uint32_t owner = magic_div(row, args.slice_m, args.slice_shift);
      const uint32_t local = row - owner * args.rows_per_cta;
      red_cluster_add(map_to_rank(base + local * row_bytes, owner), m);
      s = args.stride_a * s + args.stride_c;
    }
  }
  // Every remote add landed; no CTA touches another's memory after this.
  cluster_arrive();
  cluster_wait();

  const long long lo = static_cast<long long>(rank) * args.rows_per_cta;
  const long long hi = lo + args.rows_per_cta < args.n_rows
                           ? lo + args.rows_per_cta : args.n_rows;
  if (hi <= lo) return;
  const uint32_t count = static_cast<uint32_t>(hi - lo) * width;
  float* dst = out + (static_cast<long long>(replica) * args.n_rows + lo) *
                         width;
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0 && count % 4 == 0) {
    float4* dst4 = reinterpret_cast<float4*>(dst);
    for (uint32_t i = threadIdx.x; i < count / 4; i += blockDim.x) {
      dst4[i] = slice[i];
    }
  } else {
    const float* acc = reinterpret_cast<const float*>(slice);
    for (uint32_t i = threadIdx.x; i < count; i += blockDim.x) {
      dst[i] = acc[i];
    }
  }
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

__device__ __forceinline__ void add4(float4& a, const float4& b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(s), "l"(gmem) : "memory");
}

// atomicAdd(counter, 1) with acquire-release semantics at device scope;
// returns the old count.
__device__ __forceinline__ unsigned arrive_acq_rel(unsigned* counter) {
  unsigned old;
  asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;\n"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

__device__ __forceinline__ void add_to(float& a, float b) { a += b; }
__device__ __forceinline__ void add_to(float4& a, const float4& b) {
  add4(a, b);
}

__device__ __forceinline__ float shfl_xor(float v, int o) {
  return __shfl_xor_sync(0xffffffffu, v, o);
}

__device__ __forceinline__ float4 shfl_xor(const float4& v, int o) {
  return make_float4(shfl_xor(v.x, o), shfl_xor(v.y, o), shfl_xor(v.z, o),
                     shfl_xor(v.w, o));
}

// x summed over the row groups of a warp whose groups span `group` lanes
// (a power of two up to 32) by a fixed tree: lane l adds lane l ^ o at o =
// 16, 8, ..., group, so the warp's first group ends with the warp's sum.
template <typename T>
__device__ __forceinline__ T warp_tree(T x, uint32_t group) {
  for (uint32_t o = 16; o >= group; o >>= 1) add_to(x, shfl_xor(x, o));
  return x;
}

// buf holds `count` rows of `pieces` T; a fixed tree leaves their sum in
// row 0: row g += row g + h for g < min(h, count - h), at h = top / 2, ...,
// 1 (top the least power of two >= count), each level's rows [0, h) then
// taking the place of the count. Barriers before every level and after
// the last, so every thread of the block must call it.
template <typename T>
__device__ void tree_sum(T* buf, uint32_t count, uint32_t pieces) {
  for (uint32_t h = count > 1 ? 1u << (31 - __clz(count - 1)) : 0u; h > 0;
       h >>= 1) {
    __syncthreads();
    const uint32_t m = min(h, count - h) * pieces;
    for (uint32_t e = threadIdx.x; e < m; e += blockDim.x) {
      add_to(buf[e], buf[e + h * pieces]);
    }
    count = h;
  }
  __syncthreads();
}

// How a CTA stages a table into its shared memory.
enum class Stage : int {
  kAsync4 = 0,  // 4-byte cp.async by every thread (any alignment)
  kBulk = 1,    // bulk copies issued by one thread, completing on an mbarrier
  kLoads = 2,   // 16-byte read-only loads and shared stores by every thread
};

// Starts copying the `count` floats of `table` into shared memory at `dst`
// (kBulk and kLoads: `table` 16-byte aligned, `count` a multiple of 4).
// kBulk: thread 0 issues bulk copies of kBulkChunk bytes that complete on
// the mbarrier `bar`. kLoads: eight loads in flight a thread; a CTA of
// 1,024 threads requests a 128 KiB table at once, which on an H100 beat one
// thread's bulk copies of it with a CTA on every SM (PERF.md §6). Commits
// the thread's cp.async group, so stage_wait's wait_group 0 covers it.
// Every thread of the block calls it.
__device__ __forceinline__ void stage_start(float4* dst,
                                            const float* __restrict__ table,
                                            uint32_t count, Stage how,
                                            uint64_t* bar) {
  if (how == Stage::kBulk) {
    if (threadIdx.x == 0) {
      const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                   :: "r"(b) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      const uint32_t bytes = count * 4;
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(b), "r"(bytes) : "memory");
      const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
      const char* src = reinterpret_cast<const char*>(table);
      for (uint32_t off = 0; off < bytes; off += kBulkChunk) {
        const uint32_t n = min(kBulkChunk, bytes - off);
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(d + off), "l"(src + off), "r"(n), "r"(b) : "memory");
      }
    }
  } else if (how == Stage::kLoads) {
    const float4* t4 = reinterpret_cast<const float4*>(table);
#pragma unroll 8
    for (uint32_t i = threadIdx.x; i < count / 4; i += blockDim.x) {
      dst[i] = __ldg(t4 + i);
    }
  } else {
    float* tab = reinterpret_cast<float*>(dst);
    for (uint32_t i = threadIdx.x; i < count; i += blockDim.x) {
      cp_async4(tab + i, table + i);
    }
  }
  cp_async_commit();
}

// Waits until stage_start's copy has landed; every thread of the block
// calls it (its barrier also orders the mbarrier's init before the waits).
__device__ __forceinline__ void stage_wait(uint64_t* bar, Stage how) {
  cp_async_wait<0>();
  __syncthreads();
  if (how == Stage::kBulk) {
    const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(bar));
    asm volatile(
        "{\n .reg .pred p;\n WAIT_%=:\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%0], 0;\n"
        " @!p bra WAIT_%=;\n}\n" :: "r"(b) : "memory");
  }
}

struct GatherArgs {
  uint32_t n_rows, rows_m, rows_shift;  // n_rows and its magic pair
  uint32_t width, pieces;               // floats and T pieces of a row
  uint32_t group, groups;               // threads a row group, groups a CTA
  uint32_t ctas;                        // CTAs a replica
  uint32_t seed;
  bool bulk;  // the table staged by bulk copies, else by 4-byte cp.async
};

// `ctas` CTAs of kGatherThreads threads per replica, each with its own copy
// of the table in shared memory. Thread t is piece column (t % group) * V
// of row group t / group (threads past `groups` groups idle); group g of
// CTA c takes the iterations of shares[c * groups + g] = (a, c, lo, rows):
// its first state is a * (seed + replica) + c, and it sums its `rows` rows
// in order, V pieces of type T a thread. The CTA's groups are summed by a
// fixed tree in the table's memory; with several CTAs a replica, the last
// CTA to arrive (acquire-release arrival counter, back at 0 when it ends)
// sums their partials: set k of its threads sums CTAs k, k + sets, ... in
// order, and a fixed tree the sets. The same bits on every launch.
template <typename T, int V>
__global__ void __launch_bounds__(kGatherThreads)
vmem_gather_split_kernel(const float* __restrict__ table,
                         float* __restrict__ out, T* __restrict__ partials,
                         unsigned* __restrict__ arrivals,
                         const uint4* __restrict__ shares, GatherArgs args) {
  extern __shared__ float4 smem4[];
  __shared__ bool last;
  __shared__ __align__(8) uint64_t stage_bar;
  const uint32_t replica = blockIdx.x / args.ctas;
  const uint32_t cta = blockIdx.x - replica * args.ctas;
  const Stage how = args.bulk ? Stage::kBulk : Stage::kAsync4;
  stage_start(smem4, table, args.n_rows * args.width, how, &stage_bar);
  const uint32_t g = threadIdx.x / args.group;
  const uint32_t c0 = (threadIdx.x - g * args.group) * V;
  uint32_t s = 0u;
  uint32_t rows = 0u;
  if (g < args.groups) {
    const uint4 share = shares[cta * args.groups + g];
    s = share.x * (args.seed + replica) + share.y;
    rows = share.w;
  }
  T acc[V] = {};
  stage_wait(&stage_bar, how);

  const T* tab = reinterpret_cast<const T*>(smem4) + c0;
#pragma unroll 2
  for (uint32_t i = 0; i < rows; ++i) {
    const uint32_t a = (s & 0x80000000u) ? 0u - s : s;
    const uint32_t row =
        a - magic_div(a, args.rows_m, args.rows_shift) * args.n_rows;
    const T* r = tab + row * args.pieces;
#pragma unroll
    for (int v = 0; v < V; ++v) add_to(acc[v], r[v]);
    s = lcg_next(s);
  }

  // The CTA's groups: by warp-shuffle trees and a tree over the warps where
  // a group spans a power of two of lanes up to 32, else by a tree over the
  // groups; the table's memory is the trees' scratch once every row is read.
  T* buf = reinterpret_cast<T*>(smem4);
  const uint32_t warp = threadIdx.x >> 5;
  const uint32_t lane = threadIdx.x & 31;
  __syncthreads();
  if (32 % args.group == 0) {
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = warp_tree(acc[v], args.group);
    if (lane < args.group) {
#pragma unroll
      for (int v = 0; v < V; ++v) buf[warp * args.pieces + c0 + v] = acc[v];
    }
    tree_sum(buf, kGatherThreads / 32, args.pieces);
  } else {
    if (g < args.groups) {
#pragma unroll
      for (int v = 0; v < V; ++v) buf[g * args.pieces + c0 + v] = acc[v];
    }
    tree_sum(buf, args.groups, args.pieces);
  }
  T* dst = reinterpret_cast<T*>(out) + replica * args.pieces;
  if (args.ctas == 1) {
    if (threadIdx.x < args.pieces) dst[threadIdx.x] = buf[threadIdx.x];
    return;
  }
  // The CTA's partial, then one acquire-release arrival by thread 0 after
  // the barrier: it publishes the CTA's stores and, in the last CTA, makes
  // every CTA's partial visible to the threads past the next barrier.
  if (threadIdx.x < args.pieces) {
    partials[blockIdx.x * args.pieces + threadIdx.x] = buf[threadIdx.x];
  }
  __syncthreads();
  if (threadIdx.x == 0) last = arrive_acq_rel(arrivals + replica) ==
                               args.ctas - 1;
  __syncthreads();
  if (!last) return;
  // Set k of the last CTA's threads (a set spans `pieces` threads) sums
  // CTAs k, k + sets, ... in order; the sets are summed as the groups were.
  const bool by_warp = 32 % args.pieces == 0;
  const uint32_t sets = by_warp ? kGatherThreads / args.pieces
                                : min(kGatherThreads / args.pieces, args.ctas);
  const uint32_t k = threadIdx.x / args.pieces;
  const uint32_t p = threadIdx.x - k * args.pieces;
  T v = {};
  if (k < sets) {
    const T* rep = partials + replica * args.ctas * args.pieces + p;
    for (uint32_t c = k; c < args.ctas; c += sets) {
      add_to(v, __ldcg(rep + c * args.pieces));
    }
  }
  if (by_warp) {
    v = warp_tree(v, args.pieces);
    if (lane < args.pieces) buf[warp * args.pieces + lane] = v;
    tree_sum(buf, kGatherThreads / 32, args.pieces);
  } else {
    if (k < sets) buf[k * args.pieces + p] = v;
    tree_sum(buf, sets, args.pieces);
  }
  if (threadIdx.x < args.pieces) dst[threadIdx.x] = buf[threadIdx.x];
  if (threadIdx.x == 0) arrivals[replica] = 0u;
}

// kDmaWarps warps per CTA, `ctas` CTAs per replica. Warp w of CTA c reads
// its share of the replica's sequence, plan[c * kDmaWarps + w] = (a, c,
// rows, summed): state a * seed + c is its first iteration's, it reads
// `rows` rows and sums the first `summed` (only iterations below n_iters -
// DEPTH are summed, as on the TPU; every row is still read). Partials go
// to partials[replica][c][width]; arrivals[replica] counts the CTAs done
// and is back at 0 when the kernel ends.
template <int DEPTH>
__global__ void __launch_bounds__(kDmaWarps * 32)
hbm_dma_kernel(const float* __restrict__ table, float* __restrict__ out,
               float* __restrict__ partials, unsigned* __restrict__ arrivals,
               const uint4* __restrict__ plan, uint32_t n_rows, int width,
               int ctas, uint32_t seed) {
  extern __shared__ float4 ring[];  // [kDmaWarps][DEPTH][width / 4]
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int pieces = width / 4;
  const bool active = lane < pieces;
  const int replica = blockIdx.x / ctas;
  const int cta = blockIdx.x - replica * ctas;
  const uint4 share = plan[cta * kDmaWarps + warp];
  uint32_t s = share.x * (seed + replica) + share.y;
  float4* my = ring + warp * DEPTH * pieces;
  auto start = [&](int slot) {
    const uint32_t row = lcg_row(s, n_rows);
    s = lcg_next(s);
    if (active) {
      cp_async16(my + slot * pieces + lane,
                 reinterpret_cast<const float4*>(
                     table + static_cast<size_t>(row) * width) + lane);
    }
  };
  // One commit group per step, empty past the share's end, so the oldest
  // row has always landed after wait_group DEPTH - 1.
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) {
    if (static_cast<uint32_t>(k) < share.z) start(k);
    cp_async_commit();
  }
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int slot = 0;
  for (uint32_t i = 0; i < share.z; ++i) {
    cp_async_wait<DEPTH - 1>();
    if (active && i < share.w) add4(acc, my[slot * pieces + lane]);
    if (i + DEPTH < share.z) start(slot);
    cp_async_commit();
    slot = slot + 1 == DEPTH ? 0 : slot + 1;
  }
  cp_async_wait<0>();

  // The CTA's warps, summed in order.
  if (active) my[lane] = acc;
  __syncthreads();
  float4* part4 = reinterpret_cast<float4*>(partials);
  if (threadIdx.x < pieces) {
    float4 v = ring[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kDmaWarps; ++w) {
      add4(v, ring[w * DEPTH * pieces + threadIdx.x]);
    }
    part4[static_cast<size_t>(blockIdx.x) * pieces + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    last = atomicAdd(arrivals + replica, 1u) ==
           static_cast<unsigned>(ctas - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last CTA: warp w sums CTAs w, w + kDmaWarps, ... in order, then
  // the warps' sums are added in order.
  const float4* rep = part4 + static_cast<size_t>(replica) * ctas * pieces;
  if (active) {
    float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int c = warp; c < ctas; c += kDmaWarps) {
      add4(v, __ldcg(rep + static_cast<size_t>(c) * pieces + lane));
    }
    ring[warp * pieces + lane] = v;
  }
  __syncthreads();
  if (threadIdx.x < pieces) {
    float4 v = ring[threadIdx.x];
#pragma unroll
    for (int w = 1; w < kDmaWarps; ++w) {
      add4(v, ring[w * pieces + threadIdx.x]);
    }
    reinterpret_cast<float4*>(out)[static_cast<size_t>(replica) * pieces +
                                   threadIdx.x] = v;
  }
  if (threadIdx.x == 0) arrivals[replica] = 0u;
}

struct MarchArgs {
  uint32_t n_rows, rows_m, rows_shift;  // n_rows and its magic pair
  uint32_t width, batch, n_steps;
  uint32_t rays;        // R: rays a CTA (the last CTA's past `batch` idle)
  uint32_t group;       // G: threads a ray; a CTA has R * G threads
  uint32_t per_thread;  // U: steps a thread takes a chunk of U * G steps
  uint32_t ctas;        // CTAs a replica
  uint32_t stride_a, stride_c;  // the LCG map of G * batch states
  uint32_t seed;
  uint32_t table_vec4;  // float4s of the staged table (0: route direct)
  Stage stage;          // how the staged table is copied
};

// d += each of v's floats * 0.125, in order.
__device__ __forceinline__ void add_eighths(float& d, const float4& v) {
  d += v.x * 0.125f;
  d += v.y * 0.125f;
  d += v.z * 0.125f;
  d += v.w * 0.125f;
}

// A table row's piece, from shared memory (STAGED) or by a read-only load
// from device memory.
template <bool STAGED, typename T>
__device__ __forceinline__ T load_piece(const float* p) {
  if constexpr (STAGED) {
    return *reinterpret_cast<const T*>(p);
  } else {
    return __ldg(reinterpret_cast<const T*>(p));
  }
}

// A row's step value, max(sum_w row[w] * 0.125, 0.001), the sum from +0 in
// the order w = 0, 1, ...: in float4 pieces (VEC 1, a width that is a
// multiple of 4) or floats (VEC 0).
template <bool STAGED, int VEC>
__device__ __forceinline__ float row_step(const float* row, uint32_t width) {
  float d = 0.0f;
  if constexpr (VEC == 1) {
    for (uint32_t w = 0; w < width; w += 4) {
      add_eighths(d, load_piece<STAGED, float4>(row + w));
    }
  } else {
    for (uint32_t w = 0; w < width; ++w) {
      d += load_piece<STAGED, float>(row + w) * 0.125f;
    }
  }
  return fmaxf(d, 0.001f);
}

// `ctas` CTAs a replica of R * G threads. Thread t takes ray j = cta * R +
// t % R (idle where j >= batch) and, of each chunk of U * G steps from c0,
// steps c0 + g + u * G for u < U (g = t / R; those below n_steps): its
// first state is starts[batch + g] applied after starts[j] to seed +
// replica (state g * batch + j + 1 of the replica's sequence), each later
// one the stride map of the one before. The kMarchUnroll rows of a group
// of steps are loaded before any is summed. Each step's value goes to
// steps[k - c0][t % R]; after a barrier thread t < R adds its ray's chunk
// into t in step order, and a second barrier frees the buffer for the next
// chunk. VEC 2 is the width of 8 (two float4 loads a row).
template <bool STAGED, int VEC>
__global__ void __launch_bounds__(kMarchThreads)
vmem_batch_march_split_kernel(const float* __restrict__ table,
                              const float* __restrict__ t0,
                              float* __restrict__ out,
                              const uint2* __restrict__ starts,
                              MarchArgs args) {
  extern __shared__ float4 smem4[];
  __shared__ __align__(8) uint64_t stage_bar;
  if constexpr (STAGED) {
    stage_start(smem4, table, args.n_rows * args.width, args.stage,
                &stage_bar);
  }
  const uint32_t replica = blockIdx.x / args.ctas;
  const uint32_t cta = blockIdx.x - replica * args.ctas;
  const uint32_t rays = args.rays;
  const uint32_t group = args.group;
  const uint32_t g = threadIdx.x / rays;
  const uint32_t r = threadIdx.x - g * rays;
  const uint32_t j = cta * rays + r;
  const bool active = j < args.batch;
  const bool chain = active && g == 0;
  uint32_t s = 0u;
  float t = 0.0f;
  if (active) {
    const uint2 ray = starts[j];
    const uint2 step = starts[args.batch + g];
    s = step.x * (ray.x * (args.seed + replica) + ray.y) + step.y;
    if (chain) t = t0[j];
  }
  const float* tab = STAGED ? reinterpret_cast<const float*>(smem4) : table;
  float* steps = reinterpret_cast<float*>(smem4 + args.table_vec4);
  if constexpr (STAGED) stage_wait(&stage_bar, args.stage);

  const uint32_t per = args.per_thread;
  const uint32_t chunk = per * group;
  for (uint32_t c0 = 0; c0 < args.n_steps; c0 += chunk) {
    for (uint32_t u0 = 0; active && u0 < per; u0 += kMarchUnroll) {
      uint32_t row[kMarchUnroll];
      bool ok[kMarchUnroll];
#pragma unroll
      for (int v = 0; v < kMarchUnroll; ++v) {
        const uint32_t u = u0 + v;
        ok[v] = u < per && c0 + g + u * group < args.n_steps;
        const uint32_t a = (s & 0x80000000u) ? 0u - s : s;
        row[v] = a - magic_div(a, args.rows_m, args.rows_shift) * args.n_rows;
        if (u < per) s = args.stride_a * s + args.stride_c;
      }
      float d[kMarchUnroll];
      if constexpr (VEC == 2) {
        float4 lo[kMarchUnroll], hi[kMarchUnroll];
#pragma unroll
        for (int v = 0; v < kMarchUnroll; ++v) {
          if (!ok[v]) continue;
          const float* p = tab + row[v] * 8u;
          if constexpr (STAGED) {
            // Half b = bit 2 of the row first: a warp's first loads (and
            // its second) spread over all eight 16-byte bank quads, where
            // the rows' first halves alone take only the four even ones.
            const uint32_t b = (row[v] >> 2) & 1u;
            const float4 x = load_piece<true, float4>(p + 4u * b);
            const float4 y = load_piece<true, float4>(p + 4u * (b ^ 1u));
            lo[v] = b ? y : x;
            hi[v] = b ? x : y;
          } else {
            lo[v] = load_piece<false, float4>(p);
            hi[v] = load_piece<false, float4>(p + 4);
          }
        }
#pragma unroll
        for (int v = 0; v < kMarchUnroll; ++v) {
          if (!ok[v]) continue;
          d[v] = 0.0f;
          add_eighths(d[v], lo[v]);
          add_eighths(d[v], hi[v]);
          d[v] = fmaxf(d[v], 0.001f);
        }
      } else {
#pragma unroll
        for (int v = 0; v < kMarchUnroll; ++v) {
          if (ok[v]) {
            d[v] = row_step<STAGED, VEC>(tab + row[v] * args.width,
                                         args.width);
          }
        }
      }
#pragma unroll
      for (int v = 0; v < kMarchUnroll; ++v) {
        if (ok[v]) steps[(g + (u0 + v) * group) * rays + r] = d[v];
      }
    }
    __syncthreads();
    if (chain) {
      const uint32_t n = min(chunk, args.n_steps - c0);
      for (uint32_t i = 0; i < n; ++i) t += steps[i * rays + r];
    }
    if (c0 + chunk < args.n_steps) __syncthreads();
  }
  if (chain) out[replica * args.batch + j] = t;
}

cudaError_t opt_in_shared(const void* kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

// The launch configuration of `replicas` clusters of kScatterCluster CTAs
// with `smem` bytes each, the kernel's shared memory opted into.
cudaError_t scatter_config(size_t smem, int replicas, cudaStream_t stream,
                           cudaLaunchConfig_t* config,
                           cudaLaunchAttribute* attr) {
  cudaError_t err = opt_in_shared(
      reinterpret_cast<const void*>(vmem_scatter_cluster_kernel), smem);
  if (err != cudaSuccess) return err;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kScatterCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  *config = cudaLaunchConfig_t{};
  config->gridDim = dim3(replicas * kScatterCluster);
  config->blockDim = dim3(kScatterThreads);
  config->dynamicSmemBytes = smem;
  config->stream = stream;
  config->attrs = attr;
  config->numAttrs = 1;
  return cudaSuccess;
}

template <int DEPTH>
cudaError_t launch_dma(const float* table, float* out, float* partials,
                       unsigned* arrivals, const uint4* plan, uint32_t n_rows,
                       int width, int ctas, uint32_t seed, int replicas,
                       cudaStream_t stream) {
  const size_t smem =
      static_cast<size_t>(kDmaWarps) * DEPTH * width * sizeof(float);
  cudaError_t err = opt_in_shared(
      reinterpret_cast<const void*>(hbm_dma_kernel<DEPTH>), smem);
  if (err != cudaSuccess) return err;
  hbm_dma_kernel<DEPTH><<<replicas * ctas, kDmaWarps * 32, smem, stream>>>(
      table, out, partials, arrivals, plan, n_rows, width, ctas, seed);
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

// The scatter kernel's threads and CTAs per cluster, the DMA kernel's warps
// per CTA, the gather kernel's threads per CTA, and the march kernel's most
// threads per CTA and rows in flight a thread, which the wrapper's plans
// must use.
int probes_scatter_threads() { return kScatterThreads; }
int probes_scatter_cluster() { return kScatterCluster; }
int probes_dma_warps() { return kDmaWarps; }
int probes_gather_threads() { return kGatherThreads; }
int probes_march_threads() { return kMarchThreads; }
int probes_march_unroll() { return kMarchUnroll; }

// Clusters of the scatter kernel with `smem` bytes of shared memory a CTA
// that the device can hold at once (cudaOccupancyMaxActiveClusters); -1 on
// error.
int probe_vmem_scatter_max_clusters(long long smem, int device) {
  if (cudaSetDevice(device) != cudaSuccess) return -1;
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  if (scatter_config(static_cast<size_t>(smem), 1, nullptr, &config,
                     &attr) != cudaSuccess) {
    return -1;
  }
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(
          &n, reinterpret_cast<const void*>(vmem_scatter_cluster_kernel),
          &config) != cudaSuccess) {
    return -1;
  }
  return n;
}

// Every launcher: inputs and the output contiguous on `device`; launches on
// `stream` without synchronizing and returns the cudaError_t (0 on
// success). The wrapper checks shapes and shared-memory sizes and computes
// the plans before calling.

int probe_empty_launch(int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// shares: ctas * groups uint4 (a, c, lo, rows) of one replica; partials:
// replicas * ctas * width floats; arrivals: replicas zeroed counters; vec:
// 2 (two float4s a thread; width a multiple of 8) or 0 (one float);
// (rows_m, rows_shift) the magic pair of n_rows.
int probe_vmem_gather_launch(const float* table, float* out, float* partials,
                             unsigned* arrivals, const void* shares,
                             int n_rows, int width, int vec, int group,
                             int groups, int ctas, unsigned rows_m,
                             unsigned rows_shift, int seed, int replicas,
                             int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint32_t pieces = vec ? width / 4 : width;
  if ((vec != 0 && vec != 2) || (vec && width % 8) ||
      group * (vec ? vec : 1) != pieces || groups != kGatherThreads / group) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherArgs args;
  args.n_rows = static_cast<uint32_t>(n_rows);
  args.rows_m = rows_m;
  args.rows_shift = rows_shift;
  args.width = static_cast<uint32_t>(width);
  args.pieces = pieces;
  args.group = static_cast<uint32_t>(group);
  args.groups = static_cast<uint32_t>(groups);
  args.ctas = static_cast<uint32_t>(ctas);
  args.seed = static_cast<uint32_t>(seed);
  const size_t table_bytes = static_cast<size_t>(n_rows) * width * 4;
  args.bulk = table_bytes % 16 == 0 &&
              (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  // The table, or the scratch of either tree if that is larger.
  const size_t piece = vec ? 16 : 4;
  const uint32_t sets =
      std::min(static_cast<uint32_t>(kGatherThreads) / pieces, args.ctas);
  const size_t smem = std::max({(table_bytes + 15) / 16 * 16,
                                static_cast<size_t>(groups) * width * 4,
                                static_cast<size_t>(sets) * pieces * piece});
  const auto* sh = static_cast<const uint4*>(shares);
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(replicas) * args.ctas);
  switch (vec) {
#define PROBE_GATHER_CASE(VEC, T, V) \
    case VEC: { \
      const auto kernel = vmem_gather_split_kernel<T, V>; \
      err = opt_in_shared(reinterpret_cast<const void*>(kernel), smem); \
      if (err != cudaSuccess) return static_cast<int>(err); \
      kernel<<<grid, kGatherThreads, smem, st>>>( \
          table, out, reinterpret_cast<T*>(partials), arrivals, sh, args); \
      break; \
    }
    PROBE_GATHER_CASE(0, float, 1)
    PROBE_GATHER_CASE(2, float4, 2)
#undef PROBE_GATHER_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// starts: rows_per_pass (a, c) pairs, the map of i + 1 LCG steps for
// iteration i; (stride_a, stride_c) the map of rows_per_pass steps;
// (rows_m, rows_shift) and (slice_m, slice_shift) the magic pairs of n_rows
// and rows_per_cta; smem: a slice's rows_per_cta * width floats, rounded up
// to 16 bytes.
int probe_vmem_scatter_launch(const float* mask, float* out,
                              const void* starts, int n_rows, int width,
                              long long n_iters, int seed, int replicas,
                              int rows_per_cta, int rows_per_pass,
                              unsigned rows_m, unsigned rows_shift,
                              unsigned slice_m, unsigned slice_shift,
                              unsigned stride_a, unsigned stride_c,
                              long long smem, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  ScatterArgs args;
  args.n_iters = n_iters;
  args.n_rows = static_cast<uint32_t>(n_rows);
  args.rows_m = rows_m;
  args.rows_shift = rows_shift;
  args.rows_per_cta = static_cast<uint32_t>(rows_per_cta);
  args.slice_m = slice_m;
  args.slice_shift = slice_shift;
  args.slice_vec4 = static_cast<uint32_t>(
      (static_cast<long long>(rows_per_cta) * width + 3) / 4);
  args.rows_per_pass = static_cast<uint32_t>(rows_per_pass);
  args.stride_a = stride_a;
  args.stride_c = stride_c;
  args.seed = static_cast<uint32_t>(seed);
  args.width = static_cast<uint32_t>(width);
  if (static_cast<long long>(args.slice_vec4) * 16 != smem ||
      rows_per_pass != kScatterCluster * kScatterThreads / width) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaLaunchConfig_t config;
  cudaLaunchAttribute attr;
  err = scatter_config(static_cast<size_t>(smem), replicas,
                       static_cast<cudaStream_t>(stream), &config, &attr);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaLaunchKernelEx(&config, vmem_scatter_cluster_kernel, mask, out,
                           static_cast<const uint2*>(starts), args);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// depth in [1, 16]; width a multiple of 4, at most 128; plan: replicas'
// shared [ctas * probes_dma_warps()] uint4 shares; partials: replicas *
// ctas * width floats; arrivals: replicas zeroed counters.
int probe_hbm_dma_launch(const float* table, float* out, float* partials,
                         unsigned* arrivals, const void* plan,
                         long long n_rows, int width, int ctas, int depth,
                         int seed, int replicas, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto rows = static_cast<uint32_t>(n_rows);
  const auto sd = static_cast<uint32_t>(seed);
  const auto* p = static_cast<const uint4*>(plan);
  switch (depth) {
#define PROBE_DMA_CASE(D) \
    case D: \
      return static_cast<int>(launch_dma<D>(table, out, partials, arrivals, \
                                            p, rows, width, ctas, sd, \
                                            replicas, s));
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

// starts: `batch` ray maps (a, c) of j + 1 states, then `group` step maps
// of g * batch states; (stride_a, stride_c) the map of group * batch
// states; (rows_m, rows_shift) the magic pair of n_rows; staged: 1 to stage
// the table in shared memory, 0 to read it from device memory. A CTA's
// shared memory holds the staged table (rounded up to 16 bytes) and the
// [per_thread * group][rays] buffer of step values.
int probe_vmem_batch_march_launch(const float* table, const float* t0,
                                  float* out, const void* starts, int n_rows,
                                  int width, int batch, int n_steps, int rays,
                                  int group, int per_thread, int ctas,
                                  int staged, unsigned rows_m,
                                  unsigned rows_shift, unsigned stride_a,
                                  unsigned stride_c, int seed, int replicas,
                                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rays < 1 || group < 1 || per_thread < 1 || ctas < 1 ||
      rays * group > kMarchThreads ||
      static_cast<long long>(ctas) * rays < batch) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MarchArgs args;
  args.n_rows = static_cast<uint32_t>(n_rows);
  args.rows_m = rows_m;
  args.rows_shift = rows_shift;
  args.width = static_cast<uint32_t>(width);
  args.batch = static_cast<uint32_t>(batch);
  args.n_steps = static_cast<uint32_t>(n_steps);
  args.rays = static_cast<uint32_t>(rays);
  args.group = static_cast<uint32_t>(group);
  args.per_thread = static_cast<uint32_t>(per_thread);
  args.ctas = static_cast<uint32_t>(ctas);
  args.stride_a = stride_a;
  args.stride_c = stride_c;
  args.seed = static_cast<uint32_t>(seed);
  const size_t table_bytes = static_cast<size_t>(n_rows) * width * 4;
  const bool aligned = (reinterpret_cast<uintptr_t>(table) & 15) == 0;
  // Where aligned: register loads from a full CTA (faster than bulk copies
  // there: PERF.md §6), else bulk copies, which need no thread to load more
  // than its share of a full CTA's.
  args.stage = table_bytes % 16 || !aligned ? Stage::kAsync4
               : rays * group == kMarchThreads ? Stage::kLoads
                                               : Stage::kBulk;
  args.table_vec4 = staged ? static_cast<uint32_t>((table_bytes + 15) / 16)
                           : 0u;
  const size_t smem = static_cast<size_t>(args.table_vec4) * 16 +
                      static_cast<size_t>(per_thread) * group * rays * 4;
  // Rows in float4 pieces where they start on 16 bytes.
  const int vec = width % 4 || !(staged || aligned) ? 0 : width == 8 ? 2 : 1;
  const auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(replicas) * args.ctas);
  const dim3 block(static_cast<unsigned>(rays * group));
  const auto* sh = static_cast<const uint2*>(starts);
  switch ((staged ? 3 : 0) + vec) {
#define PROBE_MARCH_CASE(CASE, STAGED, VEC) \
    case CASE: { \
      const auto kernel = vmem_batch_march_split_kernel<STAGED, VEC>; \
      err = opt_in_shared(reinterpret_cast<const void*>(kernel), smem); \
      if (err != cudaSuccess) return static_cast<int>(err); \
      kernel<<<grid, block, smem, st>>>(table, t0, out, sh, args); \
      break; \
    }
    PROBE_MARCH_CASE(0, false, 0)
    PROBE_MARCH_CASE(1, false, 1)
    PROBE_MARCH_CASE(2, false, 2)
    PROBE_MARCH_CASE(3, true, 0)
    PROBE_MARCH_CASE(4, true, 1)
    PROBE_MARCH_CASE(5, true, 2)
#undef PROBE_MARCH_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
