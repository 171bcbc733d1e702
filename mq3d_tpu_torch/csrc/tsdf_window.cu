// K5: Phase B of TSDF integration for one capacity window, in one launch.
//
// Replaces the tile loop of mq3d_tpu_torch/ops/tsdf.py on the card
// (`_integrate_pairs`, `_tile_observations`, `_accumulate_tile`,
// `_merge_window`), which is the JAX package's `_integrate_pairs`,
// `tile_body` and `_merge_window` (mq3d_tpu/ops/tsdf.py); the depth fetch
// of K1 (patch_lookup.cu) is folded in.  For every block of the window and
// every frame of the chunk that touched it, in frame order, each voxel is
// projected into the frame, its depth fetched and its truncated signed
// distance added to a running sum; after the block's last frame the sum is
// merged into the voxel tables in place:
//
//   w' = w + cnt,   tsdf' = cnt > 0 ? fma(tsdf, w, sum) / max(w', 1) : tsdf
//
// In its other form (`sums` given) it writes each window block's sums and
// counts instead, (n, R^3) float32 each, for a rank of the sharded step to
// all-reduce over its process group before the merge.
//
// Bound on the H100: operations.  Per (block, frame) pair and voxel about
// 40 float32 operations (the pose, an IEEE reciprocal, the projection, the
// tests) against one 4-byte depth read that the L1 and the 50 MB L2 serve
// (a chunk's 64 frames of 320x288 are 23.6 MB); the tables are read and
// written once per window block.
//
// Exactness: every operation is the one the tile path's PyTorch operators
// perform, spelled as a correctly rounded intrinsic so nvcc cannot contract
// or reorder it (the library is built without fast-math):
//  * the voxel's world point float(bc*R + off) * voxel_size, and the pose
//    in `_rotate_add`'s order fma(R2, z, fma(R0, x, R1*y)) + t;
//  * the IEEE reciprocal of z (of 1 where z <= 0), then
//    floor(fma(f*x, 1/z, c) + 0.5) and the card's saturating int32 cast
//    (NaN to 0), as PyTorch's CUDA cast compiles;
//  * Python scalars rounded to float32 on the host, as PyTorch rounds them
//    (depth_max, -trunc, trunc, 1/trunc, the block extent R*voxel_size);
//  * the sum taken in frame order, adding +0.0 for a voxel that is not ok,
//    as the tile path's rank loop adds +0.0 for an absent rank; the count
//    is an integer, exact as the tile path's float count.
// An in-image voxel reads depth[f, v, u]: inside its pair's 64x64 patch
// that is what K1 reads through the patch, outside it what the tile path's
// flat gather reads, so one flat fetch serves both and no patch is anchored.
//
// Design:
//  * One thread block per window block (the window's slots are distinct,
//    so blocks never share a voxel and no atomics touch the tables).  Each
//    of kThreads threads owns kPer voxels, kThreads apart, so a warp's 32
//    voxels are two z-runs that project to neighbouring pixels; sums and
//    counts stay in registers.  Blocks with more than kThreads*kPer voxels
//    take several passes over their pairs.
//  * The block's pairs come from the chunk's touch grid: its column of the
//    window block's key is read in frame order, kThreads frames at a time,
//    and compacted in shared memory with warp ballots, so no pair list is
//    made on the host or the card.
//  * Engagement counter: the (block, frame) pairs integrated, every one
//    through the flat fetch, added by one thread at the end of the block.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 16;  // voxels a thread owns in one pass

struct Params {
  const float* depth;             // (C, H, W)
  const float* K;                 // (C, 3, 3)
  const float* E;                 // (C, 4, 4) world-to-camera
  const unsigned char* touched;   // (C, touched_stride) bool
  long long touched_stride;
  const long long* wkeys;         // (n,) grid keys of the window's blocks
  const long long* slots;         // (n,) their slots
  const int* block_coords;        // (N, 3)
  float* tsdf;                    // (N, R^3), merged into in place
  float* weight;                  // (N, R^3)
  float* sums;                    // (n, R^3) or null: the sums form
  float* cnts;                    // (n, R^3)
  unsigned long long* pairs;      // (1,) or null
  int C, H, W, R;
  float voxel_size, depth_max, neg_trunc, trunc, inv_trunc;
};

// fma(r2, z, fma(r0, x, r1*y)) + t, rounded as `_rotate_add`.
__device__ __forceinline__ float rotate_add(const float* r, float x, float y, float z,
                                            float t) {
  return __fadd_rn(__fmaf_rn(r[2], z, __fmaf_rn(r[0], x, __fmul_rn(r[1], y))), t);
}

// floor(fma(f*x, rz, c) + 0.5) cast to int32 as the card casts: saturating,
// NaN to 0.
__device__ __forceinline__ int to_pixel(float f, float x, float rz, float c) {
  return __float2int_rz(floorf(__fadd_rn(__fmaf_rn(__fmul_rn(f, x), rz, c), 0.5f)));
}

__device__ __forceinline__ float recip_z(float z) {
  return __fdiv_rn(1.0f, z > 0.0f ? z : 1.0f);
}

__global__ void __launch_bounds__(kThreads)
tsdf_window_kernel(const Params p) {
  __shared__ int s_frame[kThreads];
  __shared__ int s_warp_count[kWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long key = p.wkeys[blockIdx.x];
  const long long slot = p.slots[blockIdx.x];
  const int R = p.R, R3 = R * R * R;
  const int bx = p.block_coords[slot * 3 + 0] * R, by = p.block_coords[slot * 3 + 1] * R,
            bz = p.block_coords[slot * 3 + 2] * R;
  unsigned long long pairs = 0;

  for (int base = 0; base < R3; base += kThreads * kPer) {
    int offs[kPer];  // x << 20 | y << 10 | z of each owned voxel (R <= 1024)
    float sum[kPer];
    int cnt[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int v = base + u * kThreads + tid;
      offs[u] = ((v / (R * R)) << 20) | (((v / R) % R) << 10) | (v % R);
      sum[u] = 0.0f;
      cnt[u] = 0;
    }

    for (int f0 = 0; f0 < p.C; f0 += kThreads) {
      // The frames of [f0, f0 + kThreads) that touched the block, in order.
      const int fr = f0 + tid;
      const bool hit = fr < p.C && p.touched[fr * p.touched_stride + key] != 0;
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (lane == 0) s_warp_count[warp] = __popc(ballot);
      __syncthreads();
      int before = 0, total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const int c = s_warp_count[w];
        before += w < warp ? c : 0;
        total += c;
      }
      if (hit) s_frame[before + __popc(ballot & ((1u << lane) - 1u))] = fr;
      __syncthreads();
      if (base == 0) pairs += total;

      for (int k = 0; k < total; ++k) {
        const int f = s_frame[k];
        const float* E = p.E + f * 16;
        const float r0[3] = {__ldg(E + 0), __ldg(E + 1), __ldg(E + 2)};
        const float r1[3] = {__ldg(E + 4), __ldg(E + 5), __ldg(E + 6)};
        const float r2[3] = {__ldg(E + 8), __ldg(E + 9), __ldg(E + 10)};
        const float t0 = __ldg(E + 3), t1 = __ldg(E + 7), t2 = __ldg(E + 11);
        const float* Kf = p.K + f * 9;
        const float fx = __ldg(Kf + 0), cx = __ldg(Kf + 2), fy = __ldg(Kf + 4),
                    cy = __ldg(Kf + 5);
        const float* frame = p.depth + static_cast<long long>(f) * p.H * p.W;
#pragma unroll
        for (int u = 0; u < kPer; ++u) {
          const int v = base + u * kThreads + tid;
          if (v >= R3) continue;
          const float px = __fmul_rn(static_cast<float>(bx + (offs[u] >> 20)), p.voxel_size);
          const float py =
              __fmul_rn(static_cast<float>(by + ((offs[u] >> 10) & 1023)), p.voxel_size);
          const float pz = __fmul_rn(static_cast<float>(bz + (offs[u] & 1023)), p.voxel_size);
          const float xw = rotate_add(r0, px, py, pz, t0);
          const float yw = rotate_add(r1, px, py, pz, t1);
          const float z = rotate_add(r2, px, py, pz, t2);
          const float rz = recip_z(z);
          const int ui = to_pixel(fx, xw, rz, cx);
          const int vi = to_pixel(fy, yw, rz, cy);
          float obs = 0.0f;
          if (static_cast<unsigned>(ui) < static_cast<unsigned>(p.W) &&
              static_cast<unsigned>(vi) < static_cast<unsigned>(p.H) && z > 0.0f) {
            const float d = __ldg(frame + vi * p.W + ui);
            const float sdf = __fsub_rn(d, z);
            if (d > 0.0f && d <= p.depth_max && sdf >= p.neg_trunc) {
              obs = __fmul_rn(sdf > p.trunc ? p.trunc : sdf, p.inv_trunc);
              ++cnt[u];
            }
          }
          sum[u] = __fadd_rn(sum[u], obs);
        }
      }
      __syncthreads();  // s_frame and s_warp_count are refilled next
    }

#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int v = base + u * kThreads + tid;
      if (v >= R3) continue;
      if (p.sums != nullptr) {
        const long long o = static_cast<long long>(blockIdx.x) * R3 + v;
        p.sums[o] = sum[u];
        p.cnts[o] = static_cast<float>(cnt[u]);
        continue;
      }
      const long long i = slot * R3 + v;
      const float w = p.weight[i];
      const float nw = __fadd_rn(w, static_cast<float>(cnt[u]));
      if (cnt[u] > 0)
        p.tsdf[i] = __fdiv_rn(__fmaf_rn(p.tsdf[i], w, sum[u]), nw < 1.0f ? 1.0f : nw);
      p.weight[i] = nw;
    }
  }

  if (p.pairs != nullptr && tid == 0) atomicAdd(p.pairs, pairs);
}

}  // namespace

// Integrate one capacity window of `n` blocks (n >= 0; 0 launches nothing).
// Pointers as in Params: with `sums` null the window is merged into tsdf and
// weight, else its sums and counts are written and the tables untouched.
// Floats are the host's float32 roundings of the configuration's scalars.
// R in [1, 1023]; `pairs` (one uint64) or null gains the pairs integrated.
extern "C" int mq3d_tsdf_window(const void* depth, const void* K, const void* E,
                                const void* touched, long long touched_stride,
                                const void* wkeys, const void* slots,
                                const void* block_coords, void* tsdf, void* weight,
                                void* sums, void* cnts, void* pairs, int n, int C, int H,
                                int W, int R, float voxel_size, float depth_max,
                                float neg_trunc, float trunc, float inv_trunc,
                                void* stream) {
  if (n < 0 || C < 0 || H < 1 || W < 1 || R < 1 || R > 1023 ||
      (sums == nullptr) != (cnts == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || C == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.depth = static_cast<const float*>(depth);
  p.K = static_cast<const float*>(K);
  p.E = static_cast<const float*>(E);
  p.touched = static_cast<const unsigned char*>(touched);
  p.touched_stride = touched_stride;
  p.wkeys = static_cast<const long long*>(wkeys);
  p.slots = static_cast<const long long*>(slots);
  p.block_coords = static_cast<const int*>(block_coords);
  p.tsdf = static_cast<float*>(tsdf);
  p.weight = static_cast<float*>(weight);
  p.sums = static_cast<float*>(sums);
  p.cnts = static_cast<float*>(cnts);
  p.pairs = static_cast<unsigned long long*>(pairs);
  p.C = C;
  p.H = H;
  p.W = W;
  p.R = R;
  p.voxel_size = voxel_size;
  p.depth_max = depth_max;
  p.neg_trunc = neg_trunc;
  p.trunc = trunc;
  p.inv_trunc = inv_trunc;
  tsdf_window_kernel<<<n, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
