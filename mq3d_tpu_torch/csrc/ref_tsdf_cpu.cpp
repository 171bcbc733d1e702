// Reference-equivalent CPU TSDF integration: a well-optimized C++
// transcription of the Open3D VoxelBlockGrid allocate-then-integrate loop
// the reference pipeline runs on CPU (reference:
// scripts/processing/reconstruction/utils/o3d_utils.py:153-238 ->
// open3d::t::geometry::VoxelBlockGrid.{compute_unique_block_coordinates,
// integrate}).  Used ONLY to measure the CPU baseline of the port's bench
// (mq3d_tpu_torch/tools/bench_reference_cpu.py) — it is not part of the
// pipeline.  The port's copy of native/ref_tsdf_cpu.cpp, with guards for
// empty or invalid shapes and a setter of the OpenMP thread count.
//
// Semantics per frame (matching both Open3D and ops/tsdf.py):
//   1. allocation: subsampled valid depth pixels unproject to world, the
//      27 +-trunc cube offsets' blocks enter a hash table;
//   2. integration: every block touched BY THIS FRAME re-projects its
//      16^3 voxels into the frame, masks by depth validity and
//      sdf >= -trunc, and folds obs = clamp(sdf,trunc)/trunc into the
//      running mean tsdf' = (tsdf*w + obs)/(w+1).
//
// Optimizations a production C++ implementation would have (and Open3D
// largely has): incremental camera-space coordinates along the voxel z
// walk (3 adds instead of a 3x3 matvec per voxel), flat per-frame touch
// stamps, OpenMP over blocks.
//
// Build (tools/bench_reference_cpu.py does it on first use):
//   g++ -O3 -march=native -fopenmp -shared -fPIC ref_tsdf_cpu.cpp
//       -o libref_tsdf_cpu.so

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

struct Vec3 {
  float x, y, z;
};

inline int64_t block_key(int bx, int by, int bz) {
  // 21-bit signed packing per axis.
  const int64_t B = 1 << 20;
  return (((int64_t)(bx + B)) << 42) | (((int64_t)(by + B)) << 21) |
         (int64_t)(bz + B);
}

}  // namespace

extern "C" {

// Returns frames actually integrated (-1 for invalid arguments: a stride,
// block resolution or voxel that is not positive, or a negative size);
// fills n_blocks_out with the final allocated block count.  tsdf/weight
// are (max_blocks * R^3) caller-owned.
int ref_tsdf_integrate(const float* depth, int n_frames, int H, int W,
                       const float* K9,     // (n_frames, 9) row-major
                       const float* Twc16,  // (n_frames, 16) world-to-camera
                       float voxel, float trunc, float depth_max,
                       int block_res, int max_blocks, int alloc_stride,
                       float* tsdf, float* weight, int* n_blocks_out) {
  *n_blocks_out = 0;
  if (alloc_stride <= 0 || block_res <= 0 || !(voxel > 0.f) ||
      !(trunc > 0.f) || n_frames < 0 || H < 0 || W < 0 || max_blocks < 0)
    return -1;
  const int R = block_res;
  const int R3 = R * R * R;
  const float block_size = voxel * R;

  std::unordered_map<int64_t, int> table;
  table.reserve(1 << 16);
  std::vector<int> bx_of, by_of, bz_of;      // slot -> block coord
  std::vector<int> frame_touched;            // slots touched this frame
  std::vector<int32_t> stamp;                // slot -> last frame id + 1

  std::memset(tsdf, 0, sizeof(float) * (size_t)max_blocks * R3);
  std::memset(weight, 0, sizeof(float) * (size_t)max_blocks * R3);

  for (int f = 0; f < n_frames; ++f) {
    const float* D = depth + (size_t)f * H * W;
    const float* K = K9 + (size_t)f * 9;
    const float* T = Twc16 + (size_t)f * 16;
    const float fx = K[0], fy = K[4], cx = K[2], cy = K[5];

    // Rigid inverse: camera-to-world.
    float Rcw[9] = {T[0], T[4], T[8], T[1], T[5], T[9], T[2], T[6], T[10]};
    float tw[3] = {
        -(Rcw[0] * T[3] + Rcw[1] * T[7] + Rcw[2] * T[11]),
        -(Rcw[3] * T[3] + Rcw[4] * T[7] + Rcw[5] * T[11]),
        -(Rcw[6] * T[3] + Rcw[7] * T[7] + Rcw[8] * T[11])};

    // ---- allocation ----------------------------------------------------
    frame_touched.clear();
    for (int v = 0; v < H; v += alloc_stride) {
      for (int u = 0; u < W; u += alloc_stride) {
        float d = D[v * W + u];
        if (!(d > 0.f) || d > depth_max) continue;
        float xc = (u - cx) * d / fx, yc = (v - cy) * d / fy;
        float pw[3] = {Rcw[0] * xc + Rcw[1] * yc + Rcw[2] * d + tw[0],
                       Rcw[3] * xc + Rcw[4] * yc + Rcw[5] * d + tw[1],
                       Rcw[6] * xc + Rcw[7] * yc + Rcw[8] * d + tw[2]};
        for (int ox = -1; ox <= 1; ++ox)
          for (int oy = -1; oy <= 1; ++oy)
            for (int oz = -1; oz <= 1; ++oz) {
              int bx = (int)std::floor((pw[0] + ox * trunc) / block_size);
              int by = (int)std::floor((pw[1] + oy * trunc) / block_size);
              int bz = (int)std::floor((pw[2] + oz * trunc) / block_size);
              int64_t key = block_key(bx, by, bz);
              auto it = table.find(key);
              int slot;
              if (it == table.end()) {
                if ((int)bx_of.size() >= max_blocks) continue;
                slot = (int)bx_of.size();
                table.emplace(key, slot);
                bx_of.push_back(bx);
                by_of.push_back(by);
                bz_of.push_back(bz);
                stamp.push_back(0);
              } else {
                slot = it->second;
              }
              if (stamp[slot] != f + 1) {
                stamp[slot] = f + 1;
                frame_touched.push_back(slot);
              }
            }
      }
    }

    // ---- integration ---------------------------------------------------
    const float inv_trunc = 1.f / trunc;
    const int n_touch = (int)frame_touched.size();
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 8)
#endif
    for (int bi = 0; bi < n_touch; ++bi) {
      int slot = frame_touched[bi];
      float* ts = tsdf + (size_t)slot * R3;
      float* wt = weight + (size_t)slot * R3;
      // Camera-space position of voxel (0,0,0) of this block, plus the
      // camera-space steps for +x/+y/+z voxel walks.
      float bx0 = bx_of[slot] * block_size, by0 = by_of[slot] * block_size,
            bz0 = bz_of[slot] * block_size;
      float base[3] = {T[0] * bx0 + T[1] * by0 + T[2] * bz0 + T[3],
                       T[4] * bx0 + T[5] * by0 + T[6] * bz0 + T[7],
                       T[8] * bx0 + T[9] * by0 + T[10] * bz0 + T[11]};
      float sx[3] = {T[0] * voxel, T[4] * voxel, T[8] * voxel};
      float sy[3] = {T[1] * voxel, T[5] * voxel, T[9] * voxel};
      float sz[3] = {T[2] * voxel, T[6] * voxel, T[10] * voxel};
      int vi = 0;
      for (int ix = 0; ix < R; ++ix) {
        float px[3] = {base[0] + ix * sx[0], base[1] + ix * sx[1],
                       base[2] + ix * sx[2]};
        for (int iy = 0; iy < R; ++iy) {
          float p[3] = {px[0] + iy * sy[0], px[1] + iy * sy[1],
                        px[2] + iy * sy[2]};
          for (int iz = 0; iz < R; ++iz, ++vi) {
            float xc = p[0], yc = p[1], zc = p[2];
            p[0] += sz[0];
            p[1] += sz[1];
            p[2] += sz[2];
            if (!(zc > 0.f)) continue;
            int u = (int)std::floor(fx * xc / zc + cx + 0.5f);
            int v = (int)std::floor(fy * yc / zc + cy + 0.5f);
            if (u < 0 || u >= W || v < 0 || v >= H) continue;
            float d = D[v * W + u];
            if (!(d > 0.f) || d > depth_max) continue;
            float sdf = d - zc;
            if (sdf < -trunc) continue;
            float obs = (sdf < trunc ? sdf : trunc) * inv_trunc;
            float w = wt[vi];
            ts[vi] = (ts[vi] * w + obs) / (w + 1.f);
            wt[vi] = w + 1.f;
          }
        }
      }
    }
  }
  *n_blocks_out = (int)bx_of.size();
  return n_frames;
}

int ref_tsdf_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

// Threads of the integration loop from here on (n <= 0: left unchanged).
void ref_tsdf_set_num_threads(int n) {
#ifdef _OPENMP
  if (n > 0) omp_set_num_threads(n);
#else
  (void)n;
#endif
}

}  // extern "C"
