// Reference-equivalent CPU confidence estimation: a well-optimized C++
// transcription of the reference's multi-view depth-consistency stage
// (reference: scripts/processing/reconstruction/confidence_estimation/
// compute_pixel_error_map.py:120-219 + estimate_depth_confidences.py:15-80).
// Used ONLY to measure the CPU baseline of the port's confidence stage
// (mq3d_tpu_torch/tools/bench_reference_stages.py) — it is not part of the
// pipeline (the port's path is mq3d_tpu_torch/recon/confidence.py).  The
// port's copy of native/ref_confidence_cpu.cpp, with guards for empty or
// invalid sizes and an entry that builds several reference frames' maps,
// one reference frame per thread.  The per-frame arithmetic is unchanged.
//
// Workload per reference frame (matching the reference exactly):
//   for each target frame within +-window (skipping self):
//     1. unproject the ref depth's valid pixels to world points
//     2. transform into the target camera, project, keep in-range points
//     3. bilinear-interpolate the target depth (valid only when all four
//        taps are valid depths)
//     4. back-project the sampled depth to world; 3D distance = error
//     5. threshold into consistent/valid counts
//   confidence = consistent / valid (0 where valid == 0).
//
// Reference-favorable implementation choices: valid-pixel compaction (like
// the reference's boolean indexing) so invalid pixels cost nothing, fused
// single pass per pair, no allocations inside the pair loop.
//
// Build (tools/bench_reference_stages.py does it on first use):
//   g++ -O3 -march=native -pthread -shared -fPIC ref_confidence_cpu.cpp
//       -o libref_confidence_cpu.so

#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct M34 {
  float m[12];  // row-major 3x4 (rotation + translation)
};

static inline void apply(const M34 &T, float x, float y, float z, float *o) {
  o[0] = T.m[0] * x + T.m[1] * y + T.m[2] * z + T.m[3];
  o[1] = T.m[4] * x + T.m[5] * y + T.m[6] * z + T.m[7];
  o[2] = T.m[8] * x + T.m[9] * y + T.m[10] * z + T.m[11];
}

void build_map(const float *depth, int64_t n, int64_t h, int64_t w,
               const float *K, const float *T_cw, const float *T_wc,
               int64_t ref_idx, int64_t window, float depth_max,
               float error_threshold, float *conf_out, int32_t *count_out) {
  const int64_t hw = h * w;
  const float *dref = depth + ref_idx * hw;
  const float fxr = K[ref_idx * 9 + 0], fyr = K[ref_idx * 9 + 4];
  const float cxr = K[ref_idx * 9 + 2], cyr = K[ref_idx * 9 + 5];
  M34 Tr;
  std::memcpy(Tr.m, T_cw + ref_idx * 12, sizeof(Tr.m));

  // Step 1 (once per ref frame, like the reference): compact valid ref
  // pixels and their world points.
  std::vector<int32_t> px;  // flat ref pixel index
  std::vector<float> pw;    // world points, xyz interleaved
  px.reserve(hw);
  pw.reserve(hw * 3);
  for (int64_t v = 0; v < h; ++v) {
    for (int64_t u = 0; u < w; ++u) {
      const float z = dref[v * w + u];
      if (!(z > 0.f) || z > depth_max) continue;
      const float x = (float(u) - cxr) * z / fxr;
      const float y = (float(v) - cyr) * z / fyr;
      float o[3];
      apply(Tr, x, y, z, o);
      px.push_back(int32_t(v * w + u));
      pw.push_back(o[0]);
      pw.push_back(o[1]);
      pw.push_back(o[2]);
    }
  }
  const int64_t m = int64_t(px.size());

  std::vector<int32_t> consistent(hw, 0);
  std::vector<int32_t> valid(hw, 0);

  const int64_t lo = ref_idx - window < 0 ? 0 : ref_idx - window;
  const int64_t hi = ref_idx + window + 1 > n ? n : ref_idx + window + 1;
  for (int64_t t = lo; t < hi; ++t) {
    if (t == ref_idx) continue;
    const float *dt = depth + t * hw;
    const float fxt = K[t * 9 + 0], fyt = K[t * 9 + 4];
    const float cxt = K[t * 9 + 2], cyt = K[t * 9 + 5];
    M34 Tw, Tc;
    std::memcpy(Tw.m, T_wc + t * 12, sizeof(Tw.m));
    std::memcpy(Tc.m, T_cw + t * 12, sizeof(Tc.m));

    for (int64_t i = 0; i < m; ++i) {
      float pc[3];
      apply(Tw, pw[i * 3], pw[i * 3 + 1], pw[i * 3 + 2], pc);
      const float zt = pc[2];
      if (!(zt > 0.f) || zt > depth_max) continue;
      const float ut = pc[0] * fxt / zt + cxt;
      const float vt = pc[1] * fyt / zt + cyt;
      // Bilinear sample (compute_pixel_error_map.py:4-92): all 4 taps must
      // be valid depths and inside the frame.
      const float uf = std::floor(ut), vf = std::floor(vt);
      const int64_t u0 = int64_t(uf), v0 = int64_t(vf);
      if (u0 < 0 || u0 + 1 >= w || v0 < 0 || v0 + 1 >= h) continue;
      const float Ia = dt[v0 * w + u0], Ib = dt[v0 * w + u0 + 1];
      const float Ic = dt[(v0 + 1) * w + u0], Id = dt[(v0 + 1) * w + u0 + 1];
      if (!(Ia > 0.f) || Ia > depth_max || !(Ib > 0.f) || Ib > depth_max ||
          !(Ic > 0.f) || Ic > depth_max || !(Id > 0.f) || Id > depth_max)
        continue;
      const float du = ut - uf, dv = vt - vf;
      const float zs = (1.f - du) * (1.f - dv) * Ia + du * (1.f - dv) * Ib +
                       (1.f - du) * dv * Ic + du * dv * Id;
      if (!(zs > 0.f)) continue;
      // Back-project sampled depth to world; 3D distance = error.
      const float xs = (ut - cxt) * zs / fxt;
      const float ys = (vt - cyt) * zs / fyt;
      float qw[3];
      apply(Tc, xs, ys, zs, qw);
      const float dx = qw[0] - pw[i * 3], dy = qw[1] - pw[i * 3 + 1],
                  dz = qw[2] - pw[i * 3 + 2];
      const float err = std::sqrt(dx * dx + dy * dy + dz * dz);
      const int32_t pix = px[i];
      valid[pix] += 1;
      if (err <= error_threshold) consistent[pix] += 1;
    }
  }

  for (int64_t i = 0; i < hw; ++i) {
    count_out[i] = valid[i];
    conf_out[i] = valid[i] > 0 ? float(consistent[i]) / float(valid[i]) : 0.f;
  }
}

bool bad_sizes(int64_t n, int64_t h, int64_t w, int64_t window) {
  return n <= 0 || h <= 0 || w <= 0 || window <= 0;
}

}  // namespace

extern "C" {

// depth:      (n, h, w) float32 depth maps
// K:          (n, 9) float32 row-major intrinsics
// T_cw:       (n, 12) float32 row-major camera->world (extrinsics)
// T_wc:       (n, 12) float32 row-major world->camera (inverse extrinsics)
// conf_out:   (h*w,) float32 confidence for frame ref_idx
// count_out:  (h*w,) int32 valid counts for frame ref_idx
// Returns 0, or -1 for invalid arguments (no frames, an empty image, a
// window that is not positive, ref_idx outside [0, n)); then nothing is
// written.
int conf_build_map(const float *depth, int64_t n, int64_t h, int64_t w,
                   const float *K, const float *T_cw, const float *T_wc,
                   int64_t ref_idx, int64_t window, float depth_max,
                   float error_threshold, float *conf_out,
                   int32_t *count_out) {
  if (bad_sizes(n, h, w, window) || ref_idx < 0 || ref_idx >= n) return -1;
  build_map(depth, n, h, w, K, T_cw, T_wc, ref_idx, window, depth_max,
            error_threshold, conf_out, count_out);
  return 0;
}

// The maps of n_refs reference frames refs[0..n_refs): conf_out and
// count_out are (n_refs, h*w), row r for refs[r].  Each reference frame
// runs whole on one of n_threads threads (<= 0: one thread), so the rows
// equal conf_build_map's on any thread count.  Returns 0, or -1 for
// invalid arguments (conf_build_map's, n_refs <= 0, or any ref outside
// [0, n)); then nothing is written.
int conf_build_maps(const float *depth, int64_t n, int64_t h, int64_t w,
                    const float *K, const float *T_cw, const float *T_wc,
                    const int64_t *refs, int64_t n_refs, int64_t window,
                    float depth_max, float error_threshold, int32_t n_threads,
                    float *conf_out, int32_t *count_out) {
  if (bad_sizes(n, h, w, window) || n_refs <= 0) return -1;
  for (int64_t r = 0; r < n_refs; ++r)
    if (refs[r] < 0 || refs[r] >= n) return -1;
  const int64_t hw = h * w;
  std::atomic<int64_t> next(0);
  auto worker = [&]() {
    for (int64_t r = next++; r < n_refs; r = next++)
      build_map(depth, n, h, w, K, T_cw, T_wc, refs[r], window, depth_max,
                error_threshold, conf_out + r * hw, count_out + r * hw);
  };
  int64_t nt = n_threads > 0 ? n_threads : 1;
  if (nt > n_refs) nt = n_refs;
  std::vector<std::thread> threads;
  for (int64_t t = 1; t < nt; ++t) threads.emplace_back(worker);
  worker();
  for (auto &t : threads) t.join();
  return 0;
}

}  // extern "C"
