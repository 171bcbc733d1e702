// Reference-equivalent CPU multiscale ICP: a well-optimized C++ stand-in
// for the reference's fragment-pair registration
// (reference: scripts/processing/reconstruction/depth_optimization/
// refine_fragment_poses.py:153-161 -> o3d.t.pipelines.registration.
// multi_scale_icp with PointToPoint estimation, voxel_sizes
// [0.05, 0.025, 0.0125], max_corr_dists [0.1, 0.05, 0.025],
// max_iterations [50, 31, 14] — reference config pipeline_config.yml:66).
// Used ONLY to measure the CPU baseline of the port's fragment-pair ICP
// (mq3d_tpu_torch/tools/bench_reference_stages.py); the port's path is
// mq3d_tpu_torch/ops/icp.py.  The port's copy of native/ref_icp_cpu.cpp,
// with guards for empty clouds and invalid pyramids and an entry that
// registers a list of pairs, one pair per thread.  The per-pair arithmetic
// is unchanged.
//
// Per scale: voxel-downsample both clouds (grid average, Open3D
// VoxelDownSample semantics), then iterate: for each source point find the
// nearest target point within max_corr_dist (uniform hash grid, 27-cell
// probe — the workload equivalent of Open3D's NN index), estimate the
// point-to-point rigid transform via Horn's quaternion method, apply,
// repeat until relative fitness/rmse change < 1e-6 (Open3D default) or the
// scale's max_iteration.
//
// Build (tools/bench_reference_stages.py does it on first use):
//   g++ -O3 -march=native -pthread -shared -fPIC ref_icp_cpu.cpp
//       -o libref_icp_cpu.so

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};

struct Grid {
  float cell;
  std::unordered_map<int64_t, std::vector<int32_t>> map;
  const std::vector<V3> *pts;

  static int64_t key(int64_t ix, int64_t iy, int64_t iz) {
    return (ix * 73856093LL) ^ (iy * 19349663LL) ^ (iz * 83492791LL);
  }

  void build(const std::vector<V3> &p, float c) {
    cell = c;
    pts = &p;
    map.clear();
    map.reserve(p.size());
    for (int32_t i = 0; i < int32_t(p.size()); ++i) {
      const int64_t ix = int64_t(std::floor(p[i].x / cell));
      const int64_t iy = int64_t(std::floor(p[i].y / cell));
      const int64_t iz = int64_t(std::floor(p[i].z / cell));
      map[key(ix, iy, iz)].push_back(i);
    }
  }

  // Nearest neighbor within `cell` (callers set cell = max_corr_dist).
  int32_t nearest(V3 q, float *d2_out) const {
    const int64_t ix = int64_t(std::floor(q.x / cell));
    const int64_t iy = int64_t(std::floor(q.y / cell));
    const int64_t iz = int64_t(std::floor(q.z / cell));
    int32_t best = -1;
    float best_d2 = cell * cell;
    for (int64_t dz = -1; dz <= 1; ++dz)
      for (int64_t dy = -1; dy <= 1; ++dy)
        for (int64_t dx = -1; dx <= 1; ++dx) {
          auto it = map.find(key(ix + dx, iy + dy, iz + dz));
          if (it == map.end()) continue;
          for (int32_t j : it->second) {
            const V3 &p = (*pts)[j];
            const float ddx = p.x - q.x, ddy = p.y - q.y, ddz = p.z - q.z;
            const float d2 = ddx * ddx + ddy * ddy + ddz * ddz;
            if (d2 < best_d2) {
              best_d2 = d2;
              best = j;
            }
          }
        }
    *d2_out = best_d2;
    return best;
  }
};

void voxel_down(const std::vector<V3> &in, float voxel, std::vector<V3> *out) {
  std::unordered_map<int64_t, std::pair<V3, int32_t>> cells;
  cells.reserve(in.size());
  for (const V3 &p : in) {
    const int64_t ix = int64_t(std::floor(p.x / voxel));
    const int64_t iy = int64_t(std::floor(p.y / voxel));
    const int64_t iz = int64_t(std::floor(p.z / voxel));
    auto &c = cells[Grid::key(ix, iy, iz)];
    c.first.x += p.x;
    c.first.y += p.y;
    c.first.z += p.z;
    c.second += 1;
  }
  out->clear();
  out->reserve(cells.size());
  for (auto &kv : cells) {
    const float inv = 1.f / float(kv.second.second);
    out->push_back({kv.second.first.x * inv, kv.second.first.y * inv,
                    kv.second.first.z * inv});
  }
}

// Horn's closed-form point-to-point alignment: max eigenvector of the 4x4
// quaternion matrix via power iteration (converges in ~30 iters; cost is
// negligible next to the NN pass).
void horn(const std::vector<V3> &src, const std::vector<V3> &dst,
          const std::vector<int32_t> &si, const std::vector<int32_t> &di,
          double T[16]) {
  const int64_t n = int64_t(si.size());
  double cs[3] = {0, 0, 0}, cd[3] = {0, 0, 0};
  for (int64_t i = 0; i < n; ++i) {
    cs[0] += src[si[i]].x; cs[1] += src[si[i]].y; cs[2] += src[si[i]].z;
    cd[0] += dst[di[i]].x; cd[1] += dst[di[i]].y; cd[2] += dst[di[i]].z;
  }
  for (int k = 0; k < 3; ++k) { cs[k] /= n; cd[k] /= n; }
  double H[9] = {0};
  for (int64_t i = 0; i < n; ++i) {
    const double a[3] = {src[si[i]].x - cs[0], src[si[i]].y - cs[1],
                         src[si[i]].z - cs[2]};
    const double b[3] = {dst[di[i]].x - cd[0], dst[di[i]].y - cd[1],
                         dst[di[i]].z - cd[2]};
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) H[r * 3 + c] += a[r] * b[c];
  }
  const double t = H[0] + H[4] + H[8];
  double N[16] = {
      t, H[5] - H[7], H[6] - H[2], H[1] - H[3],
      H[5] - H[7], H[0] - H[4] - H[8], H[1] + H[3], H[2] + H[6],
      H[6] - H[2], H[1] + H[3], H[4] - H[0] - H[8], H[5] + H[7],
      H[1] - H[3], H[2] + H[6], H[5] + H[7], H[8] - H[0] - H[4]};
  // Shift so the max eigenvalue dominates in power iteration.
  double shift = 0;
  for (int i = 0; i < 4; ++i) {
    double row = 0;
    for (int j = 0; j < 4; ++j) row += std::abs(N[i * 4 + j]);
    if (row > shift) shift = row;
  }
  for (int i = 0; i < 4; ++i) N[i * 4 + i] += shift;
  double q[4] = {1, 0, 0, 0};
  for (int it = 0; it < 50; ++it) {
    double r[4] = {0, 0, 0, 0};
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j < 4; ++j) r[i] += N[i * 4 + j] * q[j];
    double nn = std::sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2] + r[3] * r[3]);
    for (int i = 0; i < 4; ++i) q[i] = r[i] / nn;
  }
  const double w = q[0], x = q[1], y = q[2], z = q[3];
  double R[9] = {1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
                 2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                 2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)};
  double tr[3];
  for (int r = 0; r < 3; ++r)
    tr[r] = cd[r] - (R[r * 3] * cs[0] + R[r * 3 + 1] * cs[1] + R[r * 3 + 2] * cs[2]);
  std::memset(T, 0, sizeof(double) * 16);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) T[r * 4 + c] = R[r * 3 + c];
    T[r * 4 + 3] = tr[r];
  }
  T[15] = 1;
}

void mat_mul4(const double A[16], const double B[16], double C[16]) {
  double out[16];
  for (int r = 0; r < 4; ++r)
    for (int c = 0; c < 4; ++c) {
      double s = 0;
      for (int k = 0; k < 4; ++k) s += A[r * 4 + k] * B[k * 4 + c];
      out[r * 4 + c] = s;
    }
  std::memcpy(C, out, sizeof(out));
}

void register_pair(const float *src, int64_t n_src, const float *dst,
                   int64_t n_dst, const float *voxel_sizes,
                   const float *corr_dists, const int32_t *max_iters,
                   int64_t n_scales, double *T_out, double *fitness_out,
                   double *rmse_out, int32_t *iters_out) {
  std::vector<V3> S(n_src), D(n_dst);
  for (int64_t i = 0; i < n_src; ++i)
    S[i] = {src[i * 3], src[i * 3 + 1], src[i * 3 + 2]};
  for (int64_t i = 0; i < n_dst; ++i)
    D[i] = {dst[i * 3], dst[i * 3 + 1], dst[i * 3 + 2]};

  double T[16] = {1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1};
  int32_t total_iters = 0;
  double fitness = 0, rmse = 0;

  for (int64_t s = 0; s < n_scales; ++s) {
    std::vector<V3> Sd, Dd;
    voxel_down(S, voxel_sizes[s], &Sd);
    voxel_down(D, voxel_sizes[s], &Dd);
    Grid grid;
    grid.build(Dd, corr_dists[s]);

    std::vector<V3> St(Sd.size());
    std::vector<int32_t> si, di;
    si.reserve(Sd.size());
    di.reserve(Sd.size());
    double prev_fit = 0, prev_rmse = 0;
    for (int32_t it = 0; it < max_iters[s]; ++it) {
      for (size_t i = 0; i < Sd.size(); ++i) {
        const V3 &p = Sd[i];
        St[i] = {
            float(T[0] * p.x + T[1] * p.y + T[2] * p.z + T[3]),
            float(T[4] * p.x + T[5] * p.y + T[6] * p.z + T[7]),
            float(T[8] * p.x + T[9] * p.y + T[10] * p.z + T[11])};
      }
      si.clear();
      di.clear();
      double err2 = 0;
      for (size_t i = 0; i < St.size(); ++i) {
        float d2;
        const int32_t j = grid.nearest(St[i], &d2);
        if (j >= 0) {
          si.push_back(int32_t(i));
          di.push_back(j);
          err2 += d2;
        }
      }
      total_iters += 1;
      if (si.size() < 3) break;
      fitness = double(si.size()) / double(Sd.size());
      rmse = std::sqrt(err2 / double(si.size()));
      double dT[16];
      horn(St, Dd, si, di, dT);
      mat_mul4(dT, T, T);
      if (it > 0 && std::abs(fitness - prev_fit) < 1e-6 &&
          std::abs(rmse - prev_rmse) < 1e-6)
        break;
      prev_fit = fitness;
      prev_rmse = rmse;
    }
  }
  std::memcpy(T_out, T, sizeof(T));
  *fitness_out = fitness;
  *rmse_out = rmse;
  *iters_out = total_iters;
}

// A pyramid whose grids are defined: at least one scale, every voxel and
// correspondence distance positive (the grids divide by them), no
// negative iteration count.
bool bad_pyramid(const float *voxel_sizes, const float *corr_dists,
                 const int32_t *max_iters, int64_t n_scales) {
  if (n_scales <= 0) return true;
  for (int64_t s = 0; s < n_scales; ++s)
    if (!(voxel_sizes[s] > 0.f) || !(corr_dists[s] > 0.f) || max_iters[s] < 0)
      return true;
  return false;
}

}  // namespace

extern "C" {

// src/dst: (n, 3) float32.  Returns iterations executed across all scales
// via *iters_out, fitness and rmse at the final scale, and the 4x4
// transform (row-major double).  Returns 0, or -1 for invalid arguments
// (an empty cloud or an invalid pyramid); then nothing is written.
int icp_multiscale(const float *src, int64_t n_src, const float *dst,
                   int64_t n_dst, const float *voxel_sizes,
                   const float *corr_dists, const int32_t *max_iters,
                   int64_t n_scales, double *T_out, double *fitness_out,
                   double *rmse_out, int32_t *iters_out) {
  if (n_src <= 0 || n_dst <= 0 ||
      bad_pyramid(voxel_sizes, corr_dists, max_iters, n_scales))
    return -1;
  register_pair(src, n_src, dst, n_dst, voxel_sizes, corr_dists, max_iters,
                n_scales, T_out, fitness_out, rmse_out, iters_out);
  return 0;
}

// n_pairs registrations of srcs[p] (n_srcs[p] points) onto dsts[p] on one
// pyramid; pair p writes T_out[16p..16p+16), fitness_out[p], rmse_out[p]
// and iters_out[p].  Each pair runs whole on one of n_threads threads
// (<= 0: one thread), so its results equal icp_multiscale's on any thread
// count.  Returns 0, or -1 for invalid arguments (n_pairs <= 0, any empty
// cloud, an invalid pyramid); then nothing is written.
int icp_multiscale_pairs(const float *const *srcs, const int64_t *n_srcs,
                         const float *const *dsts, const int64_t *n_dsts,
                         int64_t n_pairs, const float *voxel_sizes,
                         const float *corr_dists, const int32_t *max_iters,
                         int64_t n_scales, int32_t n_threads, double *T_out,
                         double *fitness_out, double *rmse_out,
                         int32_t *iters_out) {
  if (n_pairs <= 0 || bad_pyramid(voxel_sizes, corr_dists, max_iters, n_scales))
    return -1;
  for (int64_t p = 0; p < n_pairs; ++p)
    if (n_srcs[p] <= 0 || n_dsts[p] <= 0) return -1;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (int64_t p = next++; p < n_pairs; p = next++)
      register_pair(srcs[p], n_srcs[p], dsts[p], n_dsts[p], voxel_sizes,
                    corr_dists, max_iters, n_scales, T_out + 16 * p,
                    fitness_out + p, rmse_out + p, iters_out + p);
  };
  int64_t nt = n_threads > 0 ? n_threads : 1;
  if (nt > n_pairs) nt = n_pairs;
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto &t : threads) t.join();
  return 0;
}

}  // extern "C"
