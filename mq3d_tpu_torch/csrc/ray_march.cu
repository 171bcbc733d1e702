// K6: step 6's per-ray work of one pyramid level, in one launch.
//
// Replaces no Pallas kernel.  It replaces the JAX package's march, a
// `lax.while_loop` over every lane of a level (mq3d_tpu/ops/raycast.py
// `_march` :234), and its `_refine` (:305).  Their port in
// mq3d_tpu_torch/ops/raycast.py (`_march`, `_refine`, `_trilinear`,
// `_secant`) is K6's reference and the CPU path: a Python loop of about 70
// operators a step that reads `active.any()` from the card every few steps.
// Here one thread owns one lane:
//
//  * at the base level, the lane is a pixel (f, y, x): the thread builds its
//    ray as `_ray_dirs` does and clips it to the volume's AABB span;
//  * at a fine level, the lane is child `phase` of compacted parent `j`
//    (lane = phase * cap_p + j, as `_render_frames` orders them): the
//    thread finds its pixel, builds its ray, clips it to the AABB span and
//    to the parent's window [t0_p[j], t_hi_p[j]], and writes its depth into
//    the level's upsampled map; a dead lane (ids_p[j] == n_pp) writes
//    nothing.
//
// Then it marches up to `march_iters` steps (2 gathers a step: the slot
// distance and one z-pair; tsdf-proportional steps in the band, one voxel
// over an unobserved voxel, Chebyshev block skips in empty space) and stops
// as soon as its lane retires.  A retired lane changes nothing in the
// reference's loop, so this is the state that loop reaches, with no host
// read.  A lane that found a bracket refines it on the trilinear field
// (1 + 4 gathers a sample): `n_samples` dense samples, the first + -> -
// transition, `n_iters` false-position iterations and a closing secant.
// A lane that found none reads inf.
//
// Bound on the H100: memory latency.  Every gather is a random 4-byte read
// into the (G^3,) slot distances or the (n_bucket, 17^3) table of packed
// f16 z-pairs (hundreds of MB at 1 cm); neighbouring lanes are neighbouring
// rays, so their reads share sectors and the 50 MB L2 holds the surface's
// blocks.  The design keeps every lane's state in registers, issues its two
// dependent reads a step and nothing else to memory, and lets each warp
// retire as soon as its last lane does.  Neighbouring lanes read the same
// sectors, so the L1 and L2 serve most gathers: at 1 cm K6 runs in less
// time than one 32-byte sector a gather would take from HBM
// (chip_smoke.check_k6 prints both).
//
// Exactness: every operation is the one the reference's PyTorch operators
// perform on the card, spelled so that nvcc can neither contract nor
// reorder it (the library is built without fast-math; -fmad stays on for
// K1-K5, so no plain `a * b + c` appears here):
//  * `__fmaf_rn` where the reference calls `ops.fma.fma` (ray positions,
//    the refine's samples, the secant); `__fmul_rn`, `__fadd_rn`,
//    `__fsub_rn`, `__fdiv_rn` where it multiplies, adds, subtracts or
//    divides in separate operators, in its order;
//  * float32 scalars as PyTorch rounds Python floats (the wrapper rounds
//    them on the host; `_inv`'s reciprocals are float32 constants);
//  * `rintf` for torch.round, `floorf` for torch.floor, and the card's
//    saturating float-to-int32 cast (NaN to 0);
//  * `__half2float` for each f16 half of a packed z-pair;
//  * `_inv_norm`'s squares summed in its fixed order, the correctly rounded
//    square root (torch.sqrt's on the card equals the float64 root rounded
//    to float32 on every float32 in [1, 4) and on 2^26 random positive
//    ones) and the IEEE reciprocal;
//  * integer floor division, block keys and table indices as `_sample_ids`
//    and `_block_keys` compute them; a table index is 64 bits, since a slot
//    times 17^3 may pass 2^31.
//
// Engagement counters (`counts`, six uint64 or null): lanes, lanes that
// found a bracket, and march steps taken, at the base level and at the fine
// levels; each warp adds its sums once.

#include <cstdint>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxSamples = 3;  // the base level refines with 3 samples, the fine with 2
constexpr int kExt = 17;  // extended block side (block_resolution + 1)
constexpr int kExt3 = kExt * kExt * kExt;
constexpr int kDistMax = 15;  // the slot distance field's saturation

struct Params {
  const int* slot_dist;       // (G^3,) slot, or minus the Chebyshev block distance
  const unsigned* ext;        // (n_bucket * 17^3 + 1,) packed f16 z-pairs
  const float* aabb;          // (2, 3) the active blocks' box
  const float* K;             // (F, 3, 3)
  const float* Rcw;           // (F, 3, 3) camera-to-world rotations
  const float* origin;        // (F, 3) camera centres
  const long long* ids_p;     // (cap_p,) fine level: parent pixel ids, n_pp where dead
  const float* t0_p;          // (cap_p,) the parent's window
  const float* t_hi_p;        // (cap_p,)
  float* depth;               // base: (F, h, w) out; fine: (F, h, w) written at live lanes
  unsigned long long* counts;  // (6,) or null
  long long n_lanes;
  long long cap_p, n_pp;       // fine level only
  long long sentinel;          // n_bucket * 17^3: the sentinel pair, the table's last entry
  int h, w;                    // this level's map
  int hp, wp;                  // the parent level's map (fine level)
  int s, f;                    // this level's scale; upsample factor, 0 at the base
  int R, G, march_iters, n_iters;
  float vs, inv_vs, bs, trunc, band_min, t_min, t_max;
  float w_samples[kMaxSamples];  // the refine's sample weights in [0, 1]
};

__device__ __forceinline__ int floor_div(int a, int b) {
  const int q = a / b;
  return ((a % b) != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}

// `_sample_ids`: lattice point -> (slot distance value, table index).
__device__ __forceinline__ int sample_ids(const Params& p, int gx, int gy, int gz,
                                          long long* idx) {
  const int bx = floor_div(gx, p.R), by = floor_div(gy, p.R), bz = floor_div(gz, p.R);
  const long long half = p.G / 2;
  const long long sx = bx + half, sy = by + half, sz = bz + half;
  int sd = -kDistMax;
  if (sx >= 0 && sx < p.G && sy >= 0 && sy < p.G && sz >= 0 && sz < p.G)
    sd = __ldg(p.slot_dist + (sx * p.G + sy) * p.G + sz);
  const int li = ((gx - bx * p.R) * kExt + (gy - by * p.R)) * kExt + (gz - bz * p.R);
  *idx = sd >= 0 ? static_cast<long long>(sd) * kExt3 + li : p.sentinel;
  return sd;
}

__device__ __forceinline__ float low_half(unsigned u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u & 0xffffu)));
}

__device__ __forceinline__ float high_half(unsigned u) {
  return __half2float(__ushort_as_half(static_cast<unsigned short>(u >> 16)));
}

// `_at`: origin + dir * t, fused.
__device__ __forceinline__ void at(const float o[3], const float d[3], float t, float q[3]) {
#pragma unroll
  for (int k = 0; k < 3; ++k) q[k] = __fmaf_rn(d[k], t, o[k]);
}

// `_inv_norm`: 1 / max(|d|, 1e-9).
__device__ __forceinline__ float inv_norm(const float d[3]) {
  const float n2 = __fadd_rn(__fadd_rn(__fmul_rn(d[0], d[0]), __fmul_rn(d[1], d[1])),
                             __fmul_rn(d[2], d[2]));
  return __fdiv_rn(1.0f, fmaxf(__fsqrt_rn(n2), 1e-9f));
}

// `_trilinear`: the tsdf at a world point from 1 slot + 4 z-pair gathers.
__device__ float trilinear(const Params& p, const float q[3], bool* valid) {
  float gf[3], frac[3];
  int g0[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    gf[k] = __fmul_rn(q[k], p.inv_vs);
    g0[k] = __float2int_rz(floorf(gf[k]));
    frac[k] = __fsub_rn(gf[k], __int2float_rn(g0[k]));
  }
  long long idx0;
  const int sd = sample_ids(p, g0[0], g0[1], g0[2], &idx0);
  bool ok = sd >= 0;
  const float wz1 = frac[2], wz0 = __fsub_rn(1.0f, frac[2]);
  float acc = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int dx = (c >> 1) & 1, dy = c & 1;
    long long i = idx0 + (dx * kExt + dy) * kExt;
    if (i > p.sentinel) i = p.sentinel;
    const unsigned u = __ldg(p.ext + i);
    const float v0 = low_half(u), v1 = high_half(u);
    ok = ok && v0 < 1.5f && v1 < 1.5f;
    const float wx = dx ? frac[0] : __fsub_rn(1.0f, frac[0]);
    const float wy = dy ? frac[1] : __fsub_rn(1.0f, frac[1]);
    const float zz = __fadd_rn(__fmul_rn(wz0, v0 < 1.5f ? v0 : 0.0f),
                               __fmul_rn(wz1, v1 < 1.5f ? v1 : 0.0f));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(wx, wy), zz));
  }
  *valid = ok;
  return acc;
}

// `_secant`: the false-position point of a bracket.
__device__ __forceinline__ float secant(float ta, float va, float tb, float vb) {
  const float denom = __fsub_rn(va, vb);
  float f = 0.5f;
  if (fabsf(denom) > 1e-12f) f = __fdiv_rn(va, denom == 0.0f ? 1.0f : denom);
  f = fminf(fmaxf(f, 0.0f), 1.0f);
  return __fmaf_rn(f, __fsub_rn(tb, ta), ta);
}

// `ray_aabb_span` of `_render_frames`: entry and exit t of the slab test.
__device__ __forceinline__ void aabb_span(const Params& p, const float o[3], const float d[3],
                                          float* t_en, float* t_ex) {
  float en = 0.0f, ex = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float tiny = d[k] >= 0.0f ? 1e-12f : -1e-12f;
    const float inv = __fdiv_rn(1.0f, fabsf(d[k]) < 1e-12f ? tiny : d[k]);
    const float t1 = __fmul_rn(__fsub_rn(__ldg(p.aabb + k), o[k]), inv);
    const float t2 = __fmul_rn(__fsub_rn(__ldg(p.aabb + 3 + k), o[k]), inv);
    const float lo = fminf(t1, t2), hi = fmaxf(t1, t2);
    en = k == 0 ? lo : fmaxf(en, lo);
    ex = k == 0 ? hi : fminf(ex, hi);
  }
  *t_en = en;
  *t_ex = ex;
}

// `_rotate`: Rm @ (d0, d1, 1), each row summed left to right.
__device__ __forceinline__ void rotate(const float* Rm, float d0, float d1, float d[3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    d[i] = __fadd_rn(__fadd_rn(__fmul_rn(__ldg(Rm + 3 * i), d0), __fmul_rn(__ldg(Rm + 3 * i + 1), d1)),
                     __ldg(Rm + 3 * i + 2));
}

struct Bracket {
  bool found;
  float ta, tb, va, vb;
};

// `_march` for one lane; `*steps` gains the steps taken.
__device__ Bracket march(const Params& p, const float o[3], const float d[3], float inv_dn,
                         float t_init, float t_hi, int* steps) {
  Bracket b{false, 0.0f, 0.0f, 0.0f, 0.0f};
  float t = fmaxf(t_init, p.t_min);
  float prev_t = t, prev_v = 0.0f;
  bool prev_ok = false;
  bool active = t <= t_hi;
  int it = 0;
  while (active && it < p.march_iters) {
    ++it;
    float q[3];
    at(o, d, t, q);
    long long idx;
    const int sd = sample_ids(p, __float2int_rz(rintf(__fmul_rn(q[0], p.inv_vs))),
                              __float2int_rz(rintf(__fmul_rn(q[1], p.inv_vs))),
                              __float2int_rz(rintf(__fmul_rn(q[2], p.inv_vs))), &idx);
    const float v = low_half(__ldg(p.ext + idx));
    const bool valid = sd >= 0 && v < 1.5f;
    if (valid && prev_ok && prev_v > 0.0f && v <= 0.0f) {
      b = Bracket{true, prev_t, t, prev_v, v};
      break;
    }
    const float step_band = fmaxf(__fmul_rn(__fmul_rn(v, p.trunc), 0.7f), p.band_min);
    const float step_empty =
        __fmul_rn(fmaxf(__fsub_rn(__int2float_rn(-sd), 1.0f), 0.5f), p.bs);
    const float step = sd >= 0 ? (valid ? step_band : p.vs) : step_empty;
    prev_t = t;
    prev_v = v;
    prev_ok = valid;
    t = __fadd_rn(t, __fmul_rn(step, inv_dn));
    active = t <= t_hi;
  }
  *steps += it;
  return b;
}

// `_refine` for one lane that found a bracket.
template <int kSamples>
__device__ float refine(const Params& p, const float o[3], const float d[3], float inv_dn,
                        const Bracket& b) {
  const float vt = __fmul_rn(p.vs, inv_dn);
  const float lo = fmaxf(__fsub_rn(b.ta, vt), 0.0f);
  const float hi = __fadd_rn(b.tb, vt);
  const float span = __fsub_rn(hi, lo);
  float ts[kSamples], v[kSamples];
  bool ok[kSamples];
#pragma unroll
  for (int k = 0; k < kSamples; ++k) {
    ts[k] = __fmaf_rn(span, p.w_samples[k], lo);
    float q[3];
    at(o, d, ts[k], q);
    v[k] = trilinear(p, q, &ok[k]);
  }
  float ta = b.ta, tb = b.tb, va = b.va, vb = b.vb;
  // The first + -> - transition: walk down so that the lowest one wins.
#pragma unroll
  for (int k = kSamples - 2; k >= 0; --k) {
    if (ok[k] && ok[k + 1] && v[k] > 0.0f && v[k + 1] <= 0.0f) {
      ta = ts[k];
      tb = ts[k + 1];
      va = v[k];
      vb = v[k + 1];
    }
  }
  for (int i = 0; i < p.n_iters; ++i) {
    const float tm = secant(ta, va, tb, vb);
    float q[3];
    at(o, d, tm, q);
    bool ok_m;
    const float vm = trilinear(p, q, &ok_m);
    if (ok_m && vm > 0.0f) {
      ta = tm;
      va = vm;
    }
    if (ok_m && vm <= 0.0f) {
      tb = tm;
      vb = vm;
    }
  }
  return secant(ta, va, tb, vb);
}

template <int kSamples>
__global__ void __launch_bounds__(kThreads) ray_march_kernel(const Params p) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  int lanes = 0, hits = 0, steps = 0;
  if (lane < p.n_lanes) {
    lanes = 1;
    const float inf = __int_as_float(0x7f800000);
    const float* Kf;
    const float* Rm;
    float o[3], d[3], t_init, t_hi;
    long long out = -1;
    bool live = true;
    if (p.f == 0) {
      // Base level: pixel (fi, y, x) of `_ray_dirs`' grid.
      const long long hw = static_cast<long long>(p.h) * p.w;
      const int fi = static_cast<int>(lane / hw);
      const int r = static_cast<int>(lane % hw);
      const int y = r / p.w, x = r % p.w;
      Kf = p.K + 9 * fi;
      Rm = p.Rcw + 9 * fi;
      const float sf = static_cast<float>(p.s);
      const float u = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(x), 0.5f), sf), 0.5f);
      const float v = __fsub_rn(__fmul_rn(__fadd_rn(static_cast<float>(y), 0.5f), sf), 0.5f);
      rotate(Rm, __fdiv_rn(__fsub_rn(u, __ldg(Kf + 2)), __ldg(Kf + 0)),
             __fdiv_rn(__fsub_rn(v, __ldg(Kf + 5)), __ldg(Kf + 4)), d);
#pragma unroll
      for (int k = 0; k < 3; ++k) o[k] = __ldg(p.origin + 3 * fi + k);
      float t_en, t_ex;
      aabb_span(p, o, d, &t_en, &t_ex);
      t_init = fmaxf(__fsub_rn(t_en, p.vs), p.t_min);
      t_hi = fminf(__fadd_rn(t_ex, p.vs), p.t_max);
      out = lane;
    } else {
      // Fine level: child `phase` of compacted parent j.
      const long long phase = lane / p.cap_p, j = lane % p.cap_p;
      const long long id = __ldg(p.ids_p + j);
      live = id < p.n_pp;
      if (live) {
        const long long hw_p = static_cast<long long>(p.hp) * p.wp;
        const int fi = static_cast<int>(id / hw_p);
        const long long pp = id % hw_p;
        const long long py = (pp / p.wp) * p.f + phase / p.f;
        const long long px = (pp % p.wp) * p.f + phase % p.f;
        const float sf = static_cast<float>(p.s);
        const float off = __fsub_rn(__fmul_rn(0.5f, sf), 0.5f);  // exact for s <= 2^23
        const float pyf = __fadd_rn(__fmul_rn(static_cast<float>(py), sf), off);
        const float pxf = __fadd_rn(__fmul_rn(static_cast<float>(px), sf), off);
        Kf = p.K + 9 * fi;
        Rm = p.Rcw + 9 * fi;
        rotate(Rm, __fdiv_rn(__fsub_rn(pxf, __ldg(Kf + 2)), __ldg(Kf + 0)),
               __fdiv_rn(__fsub_rn(pyf, __ldg(Kf + 5)), __ldg(Kf + 4)), d);
#pragma unroll
        for (int k = 0; k < 3; ++k) o[k] = __ldg(p.origin + 3 * fi + k);
        float t_en, t_ex;
        aabb_span(p, o, d, &t_en, &t_ex);
        t_init = fmaxf(__ldg(p.t0_p + j), fmaxf(__fsub_rn(t_en, p.vs), p.t_min));
        t_hi = fminf(__ldg(p.t_hi_p + j), __fadd_rn(t_ex, p.vs));
        out = (static_cast<long long>(fi) * p.h + py) * p.w + px;
      }
    }
    if (live) {
      const float inv_dn = inv_norm(d);
      const Bracket b = march(p, o, d, inv_dn, t_init, t_hi, &steps);
      float z = inf;
      if (b.found) {
        hits = 1;
        z = refine<kSamples>(p, o, d, inv_dn, b);
      }
      p.depth[out] = z;
    }
  }
  if (p.counts != nullptr) {
    const unsigned full = 0xffffffffu;
    const unsigned l = __reduce_add_sync(full, static_cast<unsigned>(lanes));
    const unsigned h = __reduce_add_sync(full, static_cast<unsigned>(hits));
    const unsigned st = __reduce_add_sync(full, static_cast<unsigned>(steps));
    if ((threadIdx.x & 31) == 0 && l > 0) {
      unsigned long long* c = p.counts + (p.f == 0 ? 0 : 3);
      atomicAdd(c + 0, static_cast<unsigned long long>(l));
      atomicAdd(c + 1, static_cast<unsigned long long>(h));
      atomicAdd(c + 2, static_cast<unsigned long long>(st));
    }
  }
}

}  // namespace

// One pyramid level's march and refine: `n_lanes` lanes (0 launches
// nothing).  Base level (f == 0): lane = pixel of the (F, h, w) map `depth`,
// which every lane writes; ids_p, t0_p and t_hi_p are null.  Fine level
// (f >= 2): lane = phase * cap_p + j over f*f phases, each live lane writing
// its pixel of the (F, h, w) upsampled map `depth` in place; the parent map
// is (F, hp, wp), and ids_p holds ids of its pixels or F * hp * wp (dead).  n_bucket is the table's bucket
// (ext holds n_bucket * 17^3 + 1 pairs); n_samples in [2, 4] with its
// weights in `w_samples`; R = 16 (17^3 tables); `counts` (six uint64) or
// null gains the lanes, hits and steps.  Floats are the host's float32
// roundings.
extern "C" int mq3d_ray_march(const void* slot_dist, const void* ext, const void* aabb,
                              const void* K, const void* Rcw, const void* origin,
                              const void* ids_p, const void* t0_p, const void* t_hi_p,
                              void* depth, void* counts, long long n_lanes, long long cap_p,
                              long long n_bucket, int F, int h, int w, int hp, int wp, int s,
                              int f,
                              int R, int G, int march_iters, int n_samples, int n_iters,
                              const float* w_samples, float vs, float inv_vs, float bs,
                              float trunc, float band_min, float t_min, float t_max,
                              void* stream) {
  const bool fine = f != 0;
  if (n_lanes < 0 || F < 0 || h < 1 || w < 1 || s < 1 || R != kExt - 1 || G < 1 || march_iters < 0 ||
      n_iters < 0 || n_samples < 2 || n_samples > kMaxSamples || n_bucket < 0 ||
      (fine && (f < 2 || cap_p < 1 || hp < 1 || wp < 1 || ids_p == nullptr ||
                t0_p == nullptr || t_hi_p == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_lanes == 0) return static_cast<int>(cudaGetLastError());
  Params p;
  p.slot_dist = static_cast<const int*>(slot_dist);
  p.ext = static_cast<const unsigned*>(ext);
  p.aabb = static_cast<const float*>(aabb);
  p.K = static_cast<const float*>(K);
  p.Rcw = static_cast<const float*>(Rcw);
  p.origin = static_cast<const float*>(origin);
  p.ids_p = static_cast<const long long*>(ids_p);
  p.t0_p = static_cast<const float*>(t0_p);
  p.t_hi_p = static_cast<const float*>(t_hi_p);
  p.depth = static_cast<float*>(depth);
  p.counts = static_cast<unsigned long long*>(counts);
  p.n_lanes = n_lanes;
  p.cap_p = fine ? cap_p : 0;
  p.n_pp = fine ? static_cast<long long>(F) * hp * wp : 0;
  p.sentinel = n_bucket * kExt3;
  p.h = h;
  p.w = w;
  p.hp = hp;
  p.wp = wp;
  p.s = s;
  p.f = fine ? f : 0;
  p.R = R;
  p.G = G;
  p.march_iters = march_iters;
  p.n_iters = n_iters;
  p.vs = vs;
  p.inv_vs = inv_vs;
  p.bs = bs;
  p.trunc = trunc;
  p.band_min = band_min;
  p.t_min = t_min;
  p.t_max = t_max;
  for (int k = 0; k < kMaxSamples; ++k) p.w_samples[k] = k < n_samples ? w_samples[k] : 0.0f;
  const long long blocks = (n_lanes + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (n_samples) {
    case 2: ray_march_kernel<2><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p); break;
    case 3: ray_march_kernel<3><<<static_cast<unsigned>(blocks), kThreads, 0, st>>>(p); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
