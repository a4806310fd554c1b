// The carve's per-ray setup (Hopper, sm_90a): for every point of one
// cloud, the range clip, the far-endpoint clamp, the grid-entry clip and
// the walk's inputs, written as the eight arrays of RaySetup that
// carve_tiled reads (kernels/carve.py).
//
// Replaces no TPU kernel. The JAX package forms the setup with XLA
// elementwise operations (voxelized_geometry_tools_tpu/ops/voxelize.py::
// _prepare_rays and _ray_visits). Run eagerly in PyTorch
// (ops/voxelize.py::_prepare_rays and _ray_visits, the plain version) it is
// about 200 elementwise launches over the cloud's rays, each doing almost
// nothing on the card: 0.50 ms of device time for a 640 x 480 camera, and
// some milliseconds of the host's dispatch, which the card waits out.
//
// Exactness. Bit for bit the plain version on the card, for every field
// and every input, non-finite points included: one thread a ray repeats
// its operations in their order, each rounded on its own (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn, and the build's
// --fmad=false), with
// - rotate_vector's elementwise order, ((x m0 + y m1) + z m2) + t;
// - _norm3_canonical's ascending squares (a median-of-3 select), summed
//   (lo + mid) + hi, and the correctly rounded root (the plain version
//   takes it in float64 and rounds once: the same bits, 53 >= 2 * 24 + 2);
// - torch.minimum / torch.maximum's NaN propagation (a NaN operand is the
//   result), where fminf / fmaxf would drop it;
// - the slab test's axis loop in x, y, z order, as the carve takes it;
// - floor, then the float to int32 conversion PyTorch's cast makes
//   (static_cast: rounds toward zero, saturates, NaN to 0).
// The host rounds each constant to float32 as the plain version's
// torch.tensor does (grid sizes, 2 res, 1e-3 res, 1e-30, 1e-10).
//
// What bounds it on the H100: bytes. Each point is read once (12 B) and
// each ray's setup written once (66 B): 78 B a ray, 23,961,600 B for a
// 640 x 480 camera, 7.15 us at 3.35 TB/s. Its arithmetic, some 150
// operations a ray, is far below the card's rates.
//
// Design: one thread a ray, no shared memory. The transform and the
// range are read by every thread (one cached line). Each array is written
// with the ray's index as the word index, so a warp's stores of one field
// are contiguous.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

// torch.minimum and torch.maximum on the card: a NaN operand is the
// result, else fminf / fmaxf.
__device__ __forceinline__ float min_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fminf(a, b);
}

__device__ __forceinline__ float max_nan(float a, float b) {
  if (a != a) return a;
  if (b != b) return b;
  return fmaxf(a, b);
}

// The grid index of a grid-frame coordinate: floor(p / size), cast to
// int32 as PyTorch casts.
__device__ __forceinline__ int grid_index(float p, float size) {
  return static_cast<int>(floorf(__fdiv_rn(p, size)));
}

// (v0 + v1) + v2 of the squares (_sum3 of v * v), then the correctly
// rounded root.
__device__ __forceinline__ float norm_in_order(const float (&v)[3]) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(v[0], v[0]),
                                        __fmul_rn(v[1], v[1])),
                              __fmul_rn(v[2], v[2])));
}

// The grid and the plain version's float32 constants.
struct Params {
  int n[3];           // voxel counts
  float gs[3];        // grid sizes, counts * voxel size
  float res;          // the voxel size
  float two_res;      // 2 res: the far clamp's margin
  float nudge;        // 1e-3 res: the entry nudge
  float tiny;         // 1e-30: the divisors' floor
  float flat;         // 1e-10: a direction component below it is flat
};

__global__ void __launch_bounds__(THREADS)
ray_setup_kernel(const float* __restrict__ x_gc,
                 const float* __restrict__ points,
                 const float* __restrict__ max_range_p, long long n_rays,
                 Params g, int* __restrict__ start, int* __restrict__ fin,
                 int* __restrict__ step, float* __restrict__ t0,
                 float* __restrict__ dt, bool* __restrict__ hit,
                 int* __restrict__ end_flat,
                 bool* __restrict__ end_filled) {
  const long long r = static_cast<long long>(blockIdx.x) * THREADS +
                      threadIdx.x;
  if (r >= n_rays) return;
  const float max_range = *max_range_p;
  float m[3][4];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) m[i][j] = x_gc[4 * i + j];
  }
  const float px = points[3 * r];
  const float py = points[3 * r + 1];
  const float pz = points[3 * r + 2];
  const bool finite = isfinite(px) && isfinite(py) && isfinite(pz);

  // The origin, the point in the grid frame and the ray between them.
  float o[3], gp[3], ray[3], sq[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    o[i] = m[i][3];
    gp[i] = __fadd_rn(
        __fadd_rn(__fadd_rn(__fmul_rn(px, m[i][0]), __fmul_rn(py, m[i][1])),
                  __fmul_rn(pz, m[i][2])),
        m[i][3]);
    ray[i] = __fsub_rn(gp[i], o[i]);
    sq[i] = __fmul_rn(ray[i], ray[i]);
  }
  // _norm3_canonical: ascending squares by a median-of-3 select.
  const float lo = min_nan(min_nan(sq[0], sq[1]), sq[2]);
  const float hi = max_nan(max_nan(sq[0], sq[1]), sq[2]);
  const float mid = max_nan(min_nan(sq[0], sq[1]),
                            min_nan(max_nan(sq[0], sq[1]), sq[2]));
  const float ray_len = __fsqrt_rn(__fadd_rn(__fadd_rn(lo, mid), hi));
  const float len_floor = max_nan(ray_len, g.tiny);

  // The range clip.
  const bool clipped = ray_len > max_range;
  const float scale =
      ray_len > 0.0f ? __fdiv_rn(max_range, len_floor) : 0.0f;
  float p_final[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    p_final[i] =
        clipped ? __fadd_rn(o[i], __fmul_rn(ray[i], scale)) : gp[i];
  }

  // The far-endpoint clamp: an endpoint beyond the bounding sphere of
  // grid and origin (plus two voxels) moves onto it; the ray is kept.
  float corner[3], off[3], offn[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    corner[i] = max_nan(fabsf(o[i]), fabsf(__fsub_rn(g.gs[i], o[i])));
    off[i] = __fsub_rn(p_final[i], o[i]);
  }
  const float l_safe = __fadd_rn(norm_in_order(corner), g.two_res);
  // amax of |off|, NaN if any is NaN (the values are not negative, so the
  // reduction's order does not matter).
  const float m_abs =
      max_nan(max_nan(fabsf(off[0]), fabsf(off[1])), fabsf(off[2]));
  const float m_floor = max_nan(m_abs, g.tiny);
#pragma unroll
  for (int i = 0; i < 3; ++i) offn[i] = __fdiv_rn(off[i], m_floor);
  const float d_unit = norm_in_order(offn);
  const bool too_far = __fmul_rn(m_abs, min_nan(d_unit, 2.0f)) > l_safe;
  const float reach = __fdiv_rn(l_safe, max_nan(d_unit, g.tiny));
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    if (too_far) p_final[i] = __fadd_rn(o[i], __fmul_rn(offn[i], reach));
  }
  bool origin_in = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int c = grid_index(o[i], g.res);
    origin_in = origin_in && c >= 0 && c < g.n[i];
  }

  // The slab test for rays that start outside the grid, axis by axis in
  // x, y, z order (its miss flag depends on the order for grazing rays).
  float dir[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) dir[i] = __fdiv_rn(ray[i], len_floor);
  float tmin = 0.0f;
  float tmax = __fadd_rn(0.0f, max_range);
  bool miss = false;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float d = dir[a];
    const bool nearly_flat = fabsf(d) < g.flat;
    const bool in_slab = o[a] >= 0.0f && o[a] < g.gs[a];
    const float ood = __fdiv_rn(1.0f, nearly_flat ? 1.0f : d);
    const float tlow = __fmul_rn(__fsub_rn(0.0f, o[a]), ood);
    const float thigh = __fmul_rn(__fsub_rn(g.gs[a], o[a]), ood);
    const float t1 = min_nan(tlow, thigh);
    const float t2 = max_nan(tlow, thigh);
    const float tmin_new = nearly_flat ? tmin : max_nan(tmin, t1);
    // The reference widens tmax (if (t2 > tmax) tmax = t2), as written
    // upstream; the plain version mirrors it.
    const float tmax_new = nearly_flat ? tmax : max_nan(tmax, t2);
    miss = miss || (nearly_flat ? !in_slab : tmin_new > tmax_new);
    tmin = tmin_new;
    tmax = tmax_new;
  }
  const float entry = __fadd_rn(tmin, g.nudge);
  const bool walked = finite && (origin_in || !miss);

  // The walk's inputs (_ray_visits).
  const float half = __fmul_rn(g.res, 0.5f);
  int s[3], f[3];
  bool final_in = true;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float p_start =
        origin_in ? o[i] : __fadd_rn(o[i], __fmul_rn(dir[i], entry));
    s[i] = grid_index(p_start, g.res);
    f[i] = grid_index(p_final[i], g.res);
    final_in = final_in && f[i] >= 0 && f[i] < g.n[i];
    // int32 difference as PyTorch forms it (wrapping), then its sign.
    const int diff = static_cast<int>(static_cast<unsigned>(f[i]) -
                                      static_cast<unsigned>(s[i]));
    const float center = __fmul_rn(
        __fadd_rn(static_cast<float>(s[i]), 0.5f), g.res);
    const float bottom = __fsub_rn(center, half);
    const float top = __fadd_rn(center, half);
    const float t_pos = fabsf(__fdiv_rn(__fsub_rn(top, p_start), ray[i]));
    const float t_neg =
        fabsf(__fdiv_rn(__fsub_rn(p_start, bottom), ray[i]));
    const float delta =
        ray[i] != 0.0f ? fabsf(__fdiv_rn(g.res, ray[i])) : INFINITY;
    start[3 * r + i] = s[i];
    fin[3 * r + i] = f[i];
    step[3 * r + i] = (diff > 0) - (diff < 0);
    t0[3 * r + i] = ray[i] > 0.0f   ? t_pos
                    : ray[i] < 0.0f ? t_neg
                                    : INFINITY;
    dt[3 * r + i] = isfinite(delta) ? delta : 0.0f;
  }
  hit[r] = walked;
  end_flat[r] = walked && final_in
                    ? f[0] * (g.n[1] * g.n[2]) + f[1] * g.n[2] + f[2]
                    : -1;
  end_filled[r] = !clipped;
}

}  // namespace

extern "C" {

// points: float32 [n_rays, 3]; x_gc: float32 [4, 4] (the grid-frame
// transform X_GC); max_range: float32 [1]; all on `device`, contiguous.
// The grid: counts nx, ny, nz of voxels of size res, its sizes gx, gy, gz;
// two_res, nudge, tiny, flat: the plain version's constants, rounded to
// float32 by the caller. Outputs, contiguous: start, fin, step: int32
// [n_rays, 3]; t0, dt: float32 [n_rays, 3]; hit, end_filled: bool
// [n_rays]; end_flat: int32 [n_rays]. n_rays >= 1 (the wrapper checks).
// Launches on `stream` without synchronizing and returns the cudaError_t
// of the launch (0 on success).
int ray_setup_launch(const float* x_gc, const float* points,
                     const float* max_range, long long n_rays, int nx,
                     int ny, int nz, float gx, float gy, float gz, float res,
                     float two_res, float nudge, float tiny, float flat,
                     int* start, int* fin, int* step, float* t0, float* dt,
                     bool* hit, int* end_flat, bool* end_filled, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params g;
  g.n[0] = nx;
  g.n[1] = ny;
  g.n[2] = nz;
  g.gs[0] = gx;
  g.gs[1] = gy;
  g.gs[2] = gz;
  g.res = res;
  g.two_res = two_res;
  g.nudge = nudge;
  g.tiny = tiny;
  g.flat = flat;
  const long long blocks = (n_rays + THREADS - 1) / THREADS;
  ray_setup_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      x_gc, points, max_range, n_rays, g, start, fin, step, t0, dt, hit,
      end_flat, end_filled);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
