// Reference-equivalent CPU mesh raycasting: a well-optimized C++ BVH ray
// tracer standing in for the reference's Embree path (reference:
// scripts/processing/reconstruction/utils/o3d_utils.py:324-341 ->
// open3d::t::geometry::RaycastingScene.cast_rays, which wraps Embree on
// CPU).  Used ONLY to measure the CPU baseline of the port's bench
// (mq3d_tpu_torch/tools/bench_reference_raycast.py) — it is not part of
// the pipeline.  The port's copy of native/ref_raycast_cpu.cpp, with guards
// for an empty mesh, an empty image and a zero thread count.
//
// Workload per frame (matching the reference's color-aligned depth
// rendering): pinhole rays for every pixel of a 1280x960 view through
// K^-1 (u,v,1) — UNNORMALIZED directions, so t_hit equals camera z-depth,
// Open3D's convention — against the scene triangle mesh; misses = inf.
//
// Implementation notes (kept reference-favorable):
//   - binned-SAH BVH (16 bins), max 4 tris/leaf, ~Embree BVH4 quality on
//     a single-ray traversal;
//   - Moeller-Trumbore intersection, slab AABB tests, near-node-first
//     ordered traversal;
//   - std::thread fan-out over row blocks (Embree's cast_rays is
//     internally threaded the same way).
//
// Build (tools/bench_reference_raycast.py does it on first use):
//   g++ -O3 -march=native -pthread -shared -fPIC ref_raycast_cpu.cpp
//       -o libref_raycast_cpu.so

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

struct V3 {
  float x, y, z;
};
static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

struct AABB {
  V3 lo{std::numeric_limits<float>::max(), std::numeric_limits<float>::max(),
        std::numeric_limits<float>::max()};
  V3 hi{-std::numeric_limits<float>::max(), -std::numeric_limits<float>::max(),
        -std::numeric_limits<float>::max()};
  void grow(V3 p) {
    lo.x = std::min(lo.x, p.x); lo.y = std::min(lo.y, p.y); lo.z = std::min(lo.z, p.z);
    hi.x = std::max(hi.x, p.x); hi.y = std::max(hi.y, p.y); hi.z = std::max(hi.z, p.z);
  }
  void grow(const AABB &b) { grow(b.lo); grow(b.hi); }
  float area() const {
    float dx = std::max(0.f, hi.x - lo.x), dy = std::max(0.f, hi.y - lo.y),
          dz = std::max(0.f, hi.z - lo.z);
    return 2.f * (dx * dy + dy * dz + dz * dx);
  }
};

struct Node {
  AABB box;
  int32_t left = -1;   // internal: left child; leaf: first tri index
  int32_t count = 0;   // leaf: tri count; internal: 0
  int32_t right = -1;  // internal: right child
};

struct BVH {
  std::vector<Node> nodes;
  std::vector<int32_t> tri_order;
  const float *verts = nullptr;
  const int32_t *tris = nullptr;

  V3 vert(int32_t vi) const {
    return {verts[3 * vi], verts[3 * vi + 1], verts[3 * vi + 2]};
  }
  AABB tri_box(int32_t t) const {
    AABB b;
    b.grow(vert(tris[3 * t]));
    b.grow(vert(tris[3 * t + 1]));
    b.grow(vert(tris[3 * t + 2]));
    return b;
  }

  int32_t build(std::vector<int32_t> &ids, std::vector<V3> &cents,
                std::vector<AABB> &boxes, int lo, int hi) {
    Node n;
    for (int i = lo; i < hi; i++) n.box.grow(boxes[ids[i]]);
    int count = hi - lo;
    int32_t self = (int32_t)nodes.size();
    nodes.push_back(n);
    if (count <= 4) {
      nodes[self].left = (int32_t)tri_order.size();
      nodes[self].count = count;
      for (int i = lo; i < hi; i++) tri_order.push_back(ids[i]);
      return self;
    }
    // Binned SAH over the widest centroid axis.
    AABB cb;
    for (int i = lo; i < hi; i++) cb.grow(cents[ids[i]]);
    V3 ext = sub(cb.hi, cb.lo);
    int axis = ext.x > ext.y ? (ext.x > ext.z ? 0 : 2) : (ext.y > ext.z ? 1 : 2);
    float cmin = axis == 0 ? cb.lo.x : axis == 1 ? cb.lo.y : cb.lo.z;
    float cext = axis == 0 ? ext.x : axis == 1 ? ext.y : ext.z;
    int mid;
    if (cext < 1e-12f) {
      mid = lo + count / 2;
    } else {
      constexpr int NB = 16;
      AABB bbox[NB];
      int bcnt[NB] = {0};
      float scale = NB / cext;
      auto bin_of = [&](int32_t id) {
        float c = axis == 0 ? cents[id].x : axis == 1 ? cents[id].y : cents[id].z;
        int b = (int)((c - cmin) * scale);
        return std::min(std::max(b, 0), NB - 1);
      };
      for (int i = lo; i < hi; i++) {
        int b = bin_of(ids[i]);
        bbox[b].grow(boxes[ids[i]]);
        bcnt[b]++;
      }
      float lArea[NB - 1], rArea[NB - 1];
      int lCnt[NB - 1], rCnt[NB - 1];
      AABB acc;
      int cacc = 0;
      for (int b = 0; b < NB - 1; b++) {
        acc.grow(bbox[b]); cacc += bcnt[b];
        lArea[b] = acc.area(); lCnt[b] = cacc;
      }
      acc = AABB(); cacc = 0;
      for (int b = NB - 1; b >= 1; b--) {
        acc.grow(bbox[b]); cacc += bcnt[b];
        rArea[b - 1] = acc.area(); rCnt[b - 1] = cacc;
      }
      float best = std::numeric_limits<float>::max();
      int bestb = NB / 2 - 1;
      for (int b = 0; b < NB - 1; b++) {
        if (!lCnt[b] || !rCnt[b]) continue;
        float c = lArea[b] * lCnt[b] + rArea[b] * rCnt[b];
        if (c < best) { best = c; bestb = b; }
      }
      auto it = std::partition(ids.begin() + lo, ids.begin() + hi,
                               [&](int32_t id) { return bin_of(id) <= bestb; });
      mid = (int)(it - ids.begin());
      if (mid == lo || mid == hi) mid = lo + count / 2;
    }
    int32_t l = build(ids, cents, boxes, lo, mid);
    int32_t r = build(ids, cents, boxes, mid, hi);
    nodes[self].left = l;
    nodes[self].right = r;
    nodes[self].count = 0;
    return self;
  }
};

static inline bool hit_box(const AABB &b, V3 o, V3 inv, float tmax, float &tn) {
  float t1 = (b.lo.x - o.x) * inv.x, t2 = (b.hi.x - o.x) * inv.x;
  float tmin = std::min(t1, t2), tM = std::max(t1, t2);
  t1 = (b.lo.y - o.y) * inv.y; t2 = (b.hi.y - o.y) * inv.y;
  tmin = std::max(tmin, std::min(t1, t2)); tM = std::min(tM, std::max(t1, t2));
  t1 = (b.lo.z - o.z) * inv.z; t2 = (b.hi.z - o.z) * inv.z;
  tmin = std::max(tmin, std::min(t1, t2)); tM = std::min(tM, std::max(t1, t2));
  tn = tmin;
  return tM >= std::max(tmin, 0.f) && tmin < tmax;
}

struct Scene {
  BVH bvh;
  std::vector<float> verts_store;
  std::vector<int32_t> tris_store;
  int32_t root = -1;

  float trace(V3 o, V3 d, float tmax) const {
    V3 inv = {1.f / (std::fabs(d.x) > 1e-12f ? d.x : copysignf(1e-12f, d.x)),
              1.f / (std::fabs(d.y) > 1e-12f ? d.y : copysignf(1e-12f, d.y)),
              1.f / (std::fabs(d.z) > 1e-12f ? d.z : copysignf(1e-12f, d.z))};
    float best = tmax;
    int32_t stack[64];
    int sp = 0;
    stack[sp++] = root;
    while (sp) {
      int32_t ni = stack[--sp];
      const Node &n = bvh.nodes[ni];
      float tn;
      if (!hit_box(n.box, o, inv, best, tn)) continue;
      if (n.count) {
        for (int i = 0; i < n.count; i++) {
          int32_t t = bvh.tri_order[n.left + i];
          V3 a = bvh.vert(bvh.tris[3 * t]);
          V3 e1 = sub(bvh.vert(bvh.tris[3 * t + 1]), a);
          V3 e2 = sub(bvh.vert(bvh.tris[3 * t + 2]), a);
          V3 p = cross(d, e2);
          float det = dot(e1, p);
          if (std::fabs(det) < 1e-12f) continue;
          float idet = 1.f / det;
          V3 s = sub(o, a);
          float u = dot(s, p) * idet;
          if (u < 0.f || u > 1.f) continue;
          V3 q = cross(s, e1);
          float v = dot(d, q) * idet;
          if (v < 0.f || u + v > 1.f) continue;
          float th = dot(e2, q) * idet;
          if (th > 1e-6f && th < best) best = th;
        }
      } else {
        // Near child first.
        float tl, tr2;
        const Node &L = bvh.nodes[n.left];
        const Node &R = bvh.nodes[n.right];
        bool hl = hit_box(L.box, o, inv, best, tl);
        bool hr = hit_box(R.box, o, inv, best, tr2);
        if (hl && hr) {
          if (tl < tr2) { stack[sp++] = n.right; stack[sp++] = n.left; }
          else { stack[sp++] = n.left; stack[sp++] = n.right; }
        } else if (hl) stack[sp++] = n.left;
        else if (hr) stack[sp++] = n.right;
      }
    }
    return best;
  }
};

}  // namespace

extern "C" {

// Returns nullptr for a mesh without triangles (rc_render then renders
// misses only).
void *rc_build(const float *verts, int64_t n_verts, const int32_t *tris,
               int64_t n_tris) {
  if (n_tris <= 0 || n_verts <= 0) return nullptr;
  auto *sc = new Scene();
  sc->verts_store.assign(verts, verts + 3 * n_verts);
  sc->tris_store.assign(tris, tris + 3 * n_tris);
  sc->bvh.verts = sc->verts_store.data();
  sc->bvh.tris = sc->tris_store.data();
  std::vector<int32_t> ids((size_t)n_tris);
  std::vector<V3> cents((size_t)n_tris);
  std::vector<AABB> boxes((size_t)n_tris);
  for (int64_t t = 0; t < n_tris; t++) {
    ids[t] = (int32_t)t;
    boxes[t] = sc->bvh.tri_box((int32_t)t);
    cents[t] = {0.5f * (boxes[t].lo.x + boxes[t].hi.x),
                0.5f * (boxes[t].lo.y + boxes[t].hi.y),
                0.5f * (boxes[t].lo.z + boxes[t].hi.z)};
  }
  sc->bvh.nodes.reserve((size_t)n_tris * 2);
  sc->root = sc->bvh.build(ids, cents, boxes, 0, (int)n_tris);
  return sc;
}

void rc_free(void *scene) { delete (Scene *)scene; }

// Render a z-depth map: t_hit of unnormalized K^-1(u,v,1) rays (== z-depth).
// K row-major 3x3 intrinsics (already cx-flipped), T_cw row-major 4x4
// camera-to-world.  out (h*w) floats; misses = +inf.  n_threads <= 0 uses
// hardware concurrency.
void rc_render(void *scene, const float *K, const float *T_cw, int32_t w,
               int32_t h, float t_max, int32_t n_threads, float *out) {
  if (w <= 0 || h <= 0) return;
  const Scene *sc = (const Scene *)scene;
  float fx = K[0], cx = K[2], fy = K[4], cy = K[5];
  V3 o = {T_cw[3], T_cw[7], T_cw[11]};
  const float inf = std::numeric_limits<float>::infinity();
  if (sc == nullptr) {
    for (size_t i = 0; i < (size_t)h * w; i++) out[i] = inf;
    return;
  }
  int nt = n_threads > 0 ? n_threads
                         : (int)std::thread::hardware_concurrency();
  if (nt <= 0) nt = 1;
  std::atomic<int32_t> next_row{0};
  auto worker = [&]() {
    for (;;) {
      int32_t y = next_row.fetch_add(4);
      if (y >= h) return;
      int32_t yend = std::min(y + 4, h);
      for (int32_t yy = y; yy < yend; yy++) {
        float vcam = ((float)yy + 0.5f - 0.5f - cy) / fy;
        for (int32_t x = 0; x < w; x++) {
          float ucam = ((float)x + 0.5f - 0.5f - cx) / fx;
          V3 dc = {ucam, vcam, 1.f};
          V3 d = {T_cw[0] * dc.x + T_cw[1] * dc.y + T_cw[2] * dc.z,
                  T_cw[4] * dc.x + T_cw[5] * dc.y + T_cw[6] * dc.z,
                  T_cw[8] * dc.x + T_cw[9] * dc.y + T_cw[10] * dc.z};
          float t = sc->trace(o, d, t_max);
          out[(size_t)yy * w + x] = t < t_max ? t : inf;
        }
      }
    }
  };
  std::vector<std::thread> threads;
  for (int i = 0; i < nt; i++) threads.emplace_back(worker);
  for (auto &t : threads) t.join();
}

}  // extern "C"
