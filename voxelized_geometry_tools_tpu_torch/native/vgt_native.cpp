// Native CPU runtime for voxelized_geometry_tools_tpu.
//
// Multithreaded C++20 implementations (std::atomic_ref) of the three hot
// dense passes —
// the separable Euclidean distance transform, DDA ray carving, and the
// multi-camera fusion filter — exposed through a C ABI for ctypes.
//
// Roles:
//  * the "cpu-native" backend of the backend registry (the analogue of the
//    reference's CPU voxelizer backend, providing graceful fallback when no
//    accelerator is available),
//  * the performance baseline that bench.py compares the TPU path against
//    (the upstream reference library cannot be built here — it needs ROS +
//    common_robotics_utilities — so this stands in as the optimized CPU
//    implementation of the same algorithms),
//  * an independent correctness oracle for the JAX implementations.
//
// This is an original implementation written from the algorithm
// descriptions: Felzenszwalb & Huttenlocher, "Distance Transforms of
// Sampled Functions" (2012) for the EDT; Amanatides & Woo, "A Fast Voxel
// Traversal Algorithm" + Ericson RTCD slab clipping for the ray walk.

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr double kInf = std::numeric_limits<double>::infinity();

// Simple blocked parallel-for over [0, n).
template <typename Fn>
void ParallelFor(int64_t n, int num_threads, Fn&& fn) {
  if (num_threads <= 1 || n < 2) {
    for (int64_t i = 0; i < n; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  const int64_t block = std::max<int64_t>(1, n / (num_threads * 8));
  std::vector<std::thread> workers;
  workers.reserve(static_cast<size_t>(num_threads));
  for (int t = 0; t < num_threads; ++t) {
    workers.emplace_back([&] {
      for (;;) {
        const int64_t start = next.fetch_add(block);
        if (start >= n) break;
        const int64_t end = std::min(n, start + block);
        for (int64_t i = start; i < end; ++i) fn(i);
      }
    });
  }
  for (auto& w : workers) w.join();
}

// One-dimensional squared distance transform (lower envelope of parabolas).
// f is the input/output line of length n with stride `stride`.
// v/z/d are caller-provided scratch of sizes n, n+1, n.
void Envelope1D(double* f, int64_t n, int64_t stride, int64_t* v, double* z,
                double* d) {
  int64_t k = 0;
  v[0] = 0;
  z[0] = -kInf;
  z[1] = kInf;
  auto fval = [&](int64_t i) { return f[i * stride]; };
  for (int64_t q = 1; q < n; ++q) {
    const double fq = fval(q);
    if (fq == kInf && fval(v[k]) == kInf) {
      // Both parabolas at infinity: the intersection is degenerate; keep the
      // earlier site (matches the standard inf-guarded formulation).
      continue;
    }
    double s;
    for (;;) {
      const int64_t vk = v[k];
      const double fvk = fval(vk);
      double top;
      if (fq == kInf) {
        top = kInf;
      } else if (fvk == kInf) {
        top = -kInf;
      } else {
        top = (fq + double(q) * double(q)) - (fvk + double(vk) * double(vk));
      }
      s = top / (2.0 * double(q - vk));
      if (k > 0 && s <= z[k]) {
        --k;
      } else {
        break;
      }
    }
    ++k;
    v[k] = q;
    z[k] = s;
    z[k + 1] = kInf;
  }
  k = 0;
  for (int64_t q = 0; q < n; ++q) {
    while (z[k + 1] < double(q)) ++k;
    const int64_t vk = v[k];
    const double delta = double(q - vk);
    d[q] = delta * delta + fval(vk);
  }
  for (int64_t q = 0; q < n; ++q) f[q * stride] = d[q];
}

struct Scratch {
  std::vector<int64_t> v;
  std::vector<double> z;
  std::vector<double> d;
  void Resize(int64_t n) {
    v.resize(static_cast<size_t>(n));
    z.resize(static_cast<size_t>(n) + 1);
    d.resize(static_cast<size_t>(n));
  }
};

// 3-axis squared EDT over a seeded field (0 at seeds, +inf elsewhere).
void Edt3D(double* field, int64_t nx, int64_t ny, int64_t nz,
           int num_threads) {
  const int64_t sy = nz;        // stride of y step
  const int64_t sx = ny * nz;   // stride of x step
  const int nthreads = std::max(1, num_threads);

  // X axis: lines indexed by (y, z).
  if (nx > 1) {
    ParallelFor(ny * nz, nthreads, [&](int64_t line) {
      static thread_local Scratch s;
      s.Resize(nx);
      const int64_t y = line / nz, z = line % nz;
      Envelope1D(field + y * sy + z, nx, sx, s.v.data(), s.z.data(),
                 s.d.data());
    });
  }
  // Y axis: lines indexed by (x, z).
  if (ny > 1) {
    ParallelFor(nx * nz, nthreads, [&](int64_t line) {
      static thread_local Scratch s;
      s.Resize(ny);
      const int64_t x = line / nz, z = line % nz;
      Envelope1D(field + x * sx + z, ny, sy, s.v.data(), s.z.data(),
                 s.d.data());
    });
  }
  // Z axis: lines indexed by (x, y).
  if (nz > 1) {
    ParallelFor(nx * ny, nthreads, [&](int64_t line) {
      static thread_local Scratch s;
      s.Resize(nz);
      const int64_t x = line / ny, y = line % ny;
      Envelope1D(field + x * sx + y * sy, nz, 1, s.v.data(), s.z.data(),
                 s.d.data());
    });
  }
}

}  // namespace

extern "C" {

// Signed distance field from a filled mask. out[i] =
// (sqrt(d2_filled) - sqrt(d2_free)) * resolution.
void vgt_edt_sdf(const uint8_t* filled, int64_t nx, int64_t ny, int64_t nz,
                 float resolution, int num_threads, float* out) {
  const int64_t n = nx * ny * nz;
  std::vector<double> dist_filled(static_cast<size_t>(n));
  std::vector<double> dist_free(static_cast<size_t>(n));
  ParallelFor(n, num_threads, [&](int64_t i) {
    const bool f = filled[i] != 0;
    dist_filled[static_cast<size_t>(i)] = f ? 0.0 : kInf;
    dist_free[static_cast<size_t>(i)] = f ? kInf : 0.0;
  });
  // The two fields are independent: run them concurrently with the
  // thread budget split (they were serial, idling half the cores of the
  // baseline this function exists to provide).
  const int t_half = std::max(1, num_threads / 2);
  std::thread other([&] {
    Edt3D(dist_filled.data(), nx, ny, nz, t_half);
  });
  Edt3D(dist_free.data(), nx, ny, nz, std::max(1, num_threads - t_half));
  other.join();
  ParallelFor(n, num_threads, [&](int64_t i) {
    const double df = std::sqrt(dist_filled[static_cast<size_t>(i)]);
    const double dr = std::sqrt(dist_free[static_cast<size_t>(i)]);
    out[i] = static_cast<float>(df * double(resolution) -
                                dr * double(resolution));
  });
}

// DDA ray carving. Rays are given by a shared grid-frame origin and N
// grid-frame endpoints; counters accumulate seen-free / seen-filled marks.
// Semantics match ops/voxelize.py (range clip, slab entry clip, endpoint
// mark, min-t axis stepping, early exit at bounds).
void vgt_raycast(const float* origins, const float* points, int64_t n_points,
                 float max_range, int64_t nx, int64_t ny, int64_t nz,
                 float resolution, int num_threads, int32_t* seen_free,
                 int32_t* seen_filled) {
  const double res = double(resolution);
  const double gx = double(nx) * res, gy = double(ny) * res,
               gz = double(nz) * res;
  const int64_t sy = nz, sx = ny * nz;

  auto cell_of = [&](double p) { return (int64_t)std::floor(p / res); };
  auto in_bounds = [&](int64_t x, int64_t y, int64_t z) {
    return x >= 0 && y >= 0 && z >= 0 && x < nx && y < ny && z < nz;
  };

  ParallelFor(n_points, num_threads, [&](int64_t i) {
    const double ox = double(origins[i * 3 + 0]);
    const double oy = double(origins[i * 3 + 1]);
    const double oz = double(origins[i * 3 + 2]);
    double px = double(points[i * 3 + 0]);
    double py = double(points[i * 3 + 1]);
    double pz = double(points[i * 3 + 2]);
    if (!std::isfinite(px) || !std::isfinite(py) || !std::isfinite(pz))
      return;
    // A NaN origin would poison the slab test and cast to garbage cell
    // indices (UB) instead of skipping the ray.
    if (!std::isfinite(ox) || !std::isfinite(oy) || !std::isfinite(oz))
      return;

    double rx = px - ox, ry = py - oy, rz = pz - oz;
    const double len = std::sqrt(rx * rx + ry * ry + rz * rz);
    const bool clipped = len > double(max_range);
    if (clipped) {
      const double s = double(max_range) / len;
      px = ox + rx * s;
      py = oy + ry * s;
      pz = oz + rz * s;
    }
    // Far-endpoint clamp (mirrors ops/voxelize._prepare_rays): a huge
    // finite endpoint (FLT_MAX depth sentinel with max_range=inf)
    // overflows the float->int64 cast in cell_of (UB), flipping the DDA
    // step sign. Endpoints beyond the grid's far corner are
    // interchangeable — out of grid either way, identical in-grid span.
    {
      const double fcx = std::max(std::fabs(ox), std::fabs(gx - ox));
      const double fcy = std::max(std::fabs(oy), std::fabs(gy - oy));
      const double fcz = std::max(std::fabs(oz), std::fabs(gz - oz));
      const double l_safe =
          std::sqrt(fcx * fcx + fcy * fcy + fcz * fcz) + 2.0 * res;
      const double ex = px - ox, ey = py - oy, ez = pz - oz;
      const double d_fin = std::sqrt(ex * ex + ey * ey + ez * ez);
      if (d_fin > l_safe) {
        const double s = l_safe / d_fin;
        px = ox + ex * s;
        py = oy + ey * s;
        pz = oz + ez * s;
      }
    }

    double startx = ox, starty = oy, startz = oz;
    const bool origin_in = in_bounds(cell_of(ox), cell_of(oy), cell_of(oz));
    if (!origin_in) {
      // Slab clip to the grid box.
      if (len <= 0.0) return;
      const double dx = rx / len, dy = ry / len, dz = rz / len;
      double tmin = 0.0, tmax = double(max_range);
      const double dir[3] = {dx, dy, dz};
      const double o[3] = {ox, oy, oz};
      const double hi[3] = {gx, gy, gz};
      for (int a = 0; a < 3; ++a) {
        if (std::fabs(dir[a]) < 1e-10) {
          if (!(o[a] >= 0.0 && o[a] < hi[a])) return;
        } else {
          const double ood = 1.0 / dir[a];
          const double t1 = std::min((0.0 - o[a]) * ood, (hi[a] - o[a]) * ood);
          const double t2 = std::max((0.0 - o[a]) * ood, (hi[a] - o[a]) * ood);
          tmin = std::max(tmin, t1);
          tmax = std::max(tmax, t2);  // parity with the widening update
          if (tmin > tmax) return;
        }
      }
      startx = ox + dx * (tmin + 1e-10);
      starty = oy + dy * (tmin + 1e-10);
      startz = oz + dz * (tmin + 1e-10);
    }

    int64_t cx = cell_of(startx), cy = cell_of(starty), cz = cell_of(startz);
    const int64_t fx = cell_of(px), fy = cell_of(py), fz = cell_of(pz);
    const int64_t step_x = (fx > cx) - (fx < cx);
    const int64_t step_y = (fy > cy) - (fy < cy);
    const int64_t step_z = (fz > cz) - (fz < cz);

    // Endpoint mark first.
    if (in_bounds(fx, fy, fz)) {
      int32_t* target = clipped ? seen_free : seen_filled;
      std::atomic_ref<int32_t>(target[fx * sx + fy * sy + fz])
          .fetch_add(1, std::memory_order_relaxed);
    }

    auto axis_t = [&](double p, double r, int64_t c) {
      if (r > 0.0) return ((double(c) + 1.0) * res - p) / r;
      if (r < 0.0) return (p - double(c) * res) / (-r);
      return kInf;
    };
    double tx = axis_t(startx, rx, cx);
    double ty = axis_t(starty, ry, cy);
    double tz = axis_t(startz, rz, cz);
    const double dtx = rx != 0.0 ? std::fabs(res / rx) : kInf;
    const double dty = ry != 0.0 ? std::fabs(res / ry) : kInf;
    const double dtz = rz != 0.0 ? std::fabs(res / rz) : kInf;

    while (cx != fx || cy != fy || cz != fz) {
      if (!in_bounds(cx, cy, cz)) break;
      std::atomic_ref<int32_t>(seen_free[cx * sx + cy * sy + cz])
          .fetch_add(1, std::memory_order_relaxed);
      if (tx <= ty && tx <= tz) {
        if (cx == fx) break;
        cx += step_x;
        tx += dtx;
      } else if (ty <= tx && ty <= tz) {
        if (cy == fy) break;
        cy += step_y;
        ty += dty;
      } else {
        if (cz == fz) break;
        cz += step_z;
        tz += dtz;
      }
    }
  });
}

// Multi-camera fusion filter over stacked counters [n_cameras][n_voxels].
void vgt_filter(const int32_t* seen_free, const int32_t* seen_filled,
                int64_t n_cameras, int64_t n_voxels, float percent_seen_free,
                int32_t outlier_points_threshold, int32_t num_cameras_seen_free,
                int num_threads, float* occupancy) {
  ParallelFor(n_voxels, num_threads, [&](int64_t v) {
    if (occupancy[v] > 0.5f) return;  // filled cells stay filled
    int32_t cams_free = 0, cams_filled = 0;
    for (int64_t c = 0; c < n_cameras; ++c) {
      const int32_t nf = seen_free[c * n_voxels + v];
      int32_t nh = seen_filled[c * n_voxels + v];
      if (nh < outlier_points_threshold) nh = 0;
      if (nf > 0 && nh > 0) {
        // float, not double: the JAX path (counts_seen_as) computes the
        // percentage in f32, and this backend is its equality oracle —
        // double here flips voxels at exact threshold boundaries
        // (e.g. percent_seen_free = 1/3 with nf=1, nh=2).
        const float pct = float(nf) / float(nf + nh);
        if (pct >= percent_seen_free) {
          ++cams_free;
        } else {
          ++cams_filled;
        }
      } else if (nf > 0) {
        ++cams_free;
      } else if (nh > 0) {
        ++cams_filled;
      }
    }
    if (cams_filled > 0) {
      occupancy[v] = 1.0f;
    } else if (cams_free >= num_cameras_seen_free) {
      occupancy[v] = 0.0f;
    } else {
      occupancy[v] = 0.5f;
    }
  });
}

int vgt_hardware_threads() {
  return static_cast<int>(std::thread::hardware_concurrency());
}

}  // extern "C"
