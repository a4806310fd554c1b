// Pointcloud carve: the voxel walk of every ray of one cloud, counted into
// int32 tracking grids (Hopper, sm_90a).
//
// Replaces no TPU kernel. The JAX package carves with XLA scatters inside
// while-loops (voxelized_geometry_tools_tpu/ops/voxelize.py::
// raycast_pointcloud and its column twin), shaped around the TPU's scatter
// engine; run eagerly in PyTorch each loop step costs tens of launches. The
// reference library's CUDA backend carves with one thread per ray and
// atomicAdd, and so does this kernel.
//
// What it computes, per ray r (one thread each), bit for bit as the plain
// walk kernels/carve.py::carve_plain does:
// * the endpoint mark: end_flat[r] >= 0 adds one to seen_filled there if
//   end_filled[r], else to seen_free (a range-clipped endpoint is free);
// * for a ray with hit[r], the walk from start to final: each step visits
//   the current voxel (one atomicAdd into seen_free) while it is in the
//   grid and not the final voxel, then advances the axis whose closed-form
//   crossing time t = t0 + float(k) * dt is least (ties x >= y >= z), and
//   stops where that axis already holds its final coordinate, or after
//   n_steps steps (the caller's budget, a whole number of 64-step segments).
// The per-ray setup (start and final voxels, step signs, t0, the safe
// deltas dt, the endpoint) is computed by the wrapper in PyTorch, with the
// same functions as the plain walk, so the kernel repeats no float setup.
// Each t is one rounded multiply and one rounded add (__fmul_rn,
// __fadd_rn, and the build's --fmad=false), as PyTorch rounds them.
// Integer adds commute, so the order of the atomics does not change a bit.
//
// What bounds it on the H100. Its floor is its bytes: 66 bytes of inputs a
// ray read once and both int32 grids written once (chip_smoke.py's
// carve_bound); the visits, one int32 atomic each (a red.global.add, since
// the result is not read), cost less at the int32 add rate. Above that
// floor it is held, by reading (the two are not measured apart), by the
// atomics' traffic into grids larger than L2 (at 512^3) and by each warp's
// wait for its longest ray. This is the simple first kernel: no sorting
// of rays by path length, no shared-memory or row accumulation.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
carve_walk_kernel(const int* __restrict__ start, const int* __restrict__ fin,
                  const int* __restrict__ step, const float* __restrict__ t0,
                  const float* __restrict__ dt,
                  const bool* __restrict__ hit,
                  const int* __restrict__ end_flat,
                  const bool* __restrict__ end_filled, long long n_rays,
                  int nx, int ny, int nz, int n_steps, int* seen_free,
                  int* seen_filled) {
  const long long r = blockIdx.x * static_cast<long long>(THREADS) +
                      threadIdx.x;
  if (r >= n_rays) return;
  const int e = end_flat[r];
  if (e >= 0) atomicAdd(end_filled[r] ? seen_filled + e : seen_free + e, 1);
  if (!hit[r]) return;
  const long long i = 3 * r;
  int cx = start[i], cy = start[i + 1], cz = start[i + 2];
  const int fx = fin[i], fy = fin[i + 1], fz = fin[i + 2];
  const int sx = step[i], sy = step[i + 1], sz = step[i + 2];
  const float tx0 = t0[i], ty0 = t0[i + 1], tz0 = t0[i + 2];
  const float dtx = dt[i], dty = dt[i + 1], dtz = dt[i + 2];
  const int nyz = ny * nz;
  int kx = 0, ky = 0, kz = 0;
  for (int s = 0; s < n_steps; ++s) {
    if (cx == fx && cy == fy && cz == fz) break;
    if (cx < 0 || cx >= nx || cy < 0 || cy >= ny || cz < 0 || cz >= nz)
      break;
    atomicAdd(seen_free + (cx * nyz + cy * nz + cz), 1);
    const float tx = __fadd_rn(tx0, __fmul_rn(static_cast<float>(kx), dtx));
    const float ty = __fadd_rn(ty0, __fmul_rn(static_cast<float>(ky), dty));
    const float tz = __fadd_rn(tz0, __fmul_rn(static_cast<float>(kz), dtz));
    if (tx <= ty && tx <= tz) {
      if (cx == fx) break;
      cx += sx;
      ++kx;
    } else if (ty <= tx && ty <= tz) {
      if (cy == fy) break;
      cy += sy;
      ++ky;
    } else {
      if (cz == fz) break;
      cz += sz;
      ++kz;
    }
  }
}

}  // namespace

extern "C" {

// start, fin, step: int32 [n_rays, 3]; t0, dt: float32 [n_rays, 3]; hit,
// end_filled: bool [n_rays]; end_flat: int32 [n_rays]; seen_free and
// seen_filled: int32 [nx * ny * nz], added into. All contiguous. Launches on
// `stream` without synchronizing and returns the cudaError_t of the launch
// (0 on success).
int carve_walk_launch(const int* start, const int* fin, const int* step,
                      const float* t0, const float* dt, const bool* hit,
                      const int* end_flat, const bool* end_filled,
                      long long n_rays, int nx, int ny, int nz, int n_steps,
                      int* seen_free, int* seen_filled, int device,
                      void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (n_rays <= 0) return 0;
  const long long blocks = (n_rays + THREADS - 1) / THREADS;
  carve_walk_kernel<<<static_cast<unsigned>(blocks), THREADS, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      start, fin, step, t0, dt, hit, end_flat, end_filled, n_rays, nx, ny, nz,
      n_steps, seen_free, seen_filled);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
