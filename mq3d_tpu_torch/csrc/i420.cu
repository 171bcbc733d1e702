// K2: I420 -> BGR colour conversion, fixed-point BT.601 (bit-exact with
// OpenCV's cvtColor(COLOR_YUV2BGR_I420)).
//
// Replaces the Pallas TPU kernel mq3d_tpu/ops/yuv_pallas.py `_i420_kernel`
// (pallas_call in `_convert_padded`, driven by `yuv420_to_bgr_pallas`),
// which computes the same function as mq3d_tpu/ops/yuv.py `yuv420_to_8uc3`.
//
// Bound on the H100: memory.  Per pixel it reads 1 byte of luma and
// 2 x 1/4 byte of chroma and writes 3 bytes: 4.5 bytes per pixel against a
// few integer operations.  A thread per 2x2 quad with byte loads and
// byte stores at a 3-byte stride issues one store instruction per output
// byte, so the load/store units, not HBM, would set the pace.
//
// Design: one thread per strip of 16 pixels x 2 rows (8 quads).  On the
// vector path (W % 16 == 0 and 16-byte aligned luma and output, 8-byte
// aligned chroma) it loads the strip's two rows of luma as two 16-byte
// vectors and its U and V as one 8-byte vector each, and builds the
// 2 x 48 output bytes in registers.  A block of 256 threads takes
// R = 256 / (W / 16) whole strip rows (3 at W = 1280; one row where W / 16
// exceeds 256), whose output is one contiguous 6RW-byte range: the strips
// go into shared memory (a strip's offset is a multiple of 48 bytes, so
// its three 16-byte stores hit distinct banks), and the block then writes
// the range with consecutive 16-byte stores, every warp store filling four
// whole 128-byte lines.  Storing the 48 bytes straight from registers
// leaves each warp store spread over twelve lines; it was slower on the
// H100 (PERF.md) and is not kept.  The range must fit the 227 KB of shared
// memory a block can use (W <= 38741).  Otherwise (wider rows, ragged
// widths, unaligned plane views) every strip takes the scalar path: byte
// loads and stores, quad by quad.  The TPU kernel's quad split, padding
// and interleave were workarounds for the TPU compiler and are not carried
// over.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kShift = 20;
constexpr int kHalf = 1 << (kShift - 1);
constexpr int kCY = 1220542;
constexpr int kCUB = 2116026;
constexpr int kCUG = -409993;
constexpr int kCVG = -852492;
constexpr int kCVR = 1673527;
constexpr int kThreads = 256;
constexpr int kStrip = 16;  // pixels per strip row (8 quads)
constexpr size_t kMaxSmem = 232448;  // 227 KB a block can use

__device__ __forceinline__ uint32_t sat(int x) {
  x >>= kShift;  // arithmetic shift, as the reference's int32 `>>`
  return static_cast<uint32_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

struct Chroma {
  int b, g, r;  // the quad's shared terms, with the rounding half
};

__device__ __forceinline__ Chroma chroma(uint32_t u8, uint32_t v8) {
  const int uu = static_cast<int>(u8) - 128;
  const int vv = static_cast<int>(v8) - 128;
  return {kHalf + kCUB * uu, kHalf + kCVG * vv + kCUG * uu, kHalf + kCVR * vv};
}

__device__ __forceinline__ int luma(uint32_t y8) {
  const int yy = static_cast<int>(y8) - 16;
  return (yy > 0 ? yy : 0) * kCY;
}

__device__ __forceinline__ uint32_t byte_of(const uint4& q, int i) {
  const uint32_t w = i < 4 ? q.x : i < 8 ? q.y : i < 12 ? q.z : q.w;
  return (w >> (8 * (i & 3))) & 0xff;
}

// One row of a strip: 16 luma bytes -> 48 BGR bytes as twelve words.
__device__ __forceinline__ void strip_row(const uint4& ylum, const Chroma* c,
                                          uint32_t* w) {
#pragma unroll
  for (int i = 0; i < 12; ++i) w[i] = 0;
#pragma unroll
  for (int px = 0; px < kStrip; ++px) {
    const int yy = luma(byte_of(ylum, px));
    const Chroma& q = c[px >> 1];
    const uint32_t bgr[3] = {sat(yy + q.b), sat(yy + q.g), sat(yy + q.r)};
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const int i = 3 * px + ch;
      w[i >> 2] |= bgr[ch] << (8 * (i & 3));
    }
  }
}

// The strip at luma offset pix0 / chroma offset c0: both rows' words.
__device__ __forceinline__ void strip(const uint8_t* __restrict__ y,
                                      const uint8_t* __restrict__ u,
                                      const uint8_t* __restrict__ v,
                                      long long pix0, long long c0, int W,
                                      uint32_t* w0, uint32_t* w1) {
  const uint2 u8 = __ldcs(reinterpret_cast<const uint2*>(u + c0));
  const uint2 v8 = __ldcs(reinterpret_cast<const uint2*>(v + c0));
  const uint4 y0 = __ldcs(reinterpret_cast<const uint4*>(y + pix0));
  const uint4 y1 = __ldcs(reinterpret_cast<const uint4*>(y + pix0 + W));
  Chroma c[kStrip / 2];
#pragma unroll
  for (int q = 0; q < kStrip / 2; ++q) {
    const uint32_t uw = q < 4 ? u8.x : u8.y;
    const uint32_t vw = q < 4 ? v8.x : v8.y;
    c[q] = chroma((uw >> (8 * (q & 3))) & 0xff, (vw >> (8 * (q & 3))) & 0xff);
  }
  strip_row(y0, c, w0);
  strip_row(y1, c, w1);
}

// The scalar path: one thread per strip, byte loads and stores.
__global__ void __launch_bounds__(kThreads)
i420_to_bgr_scalar_kernel(const uint8_t* __restrict__ y,
                          const uint8_t* __restrict__ u,
                          const uint8_t* __restrict__ v,
                          uint8_t* __restrict__ out, int N, int H, int W) {
  const int hc = H / 2;
  const int wc = W / 2;
  const int strips = (W + kStrip - 1) / kStrip;
  const long long total = static_cast<long long>(N) * hc * strips;
  for (long long t = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       t < total; t += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int sx = static_cast<int>(t % strips);
    const long long row = t / strips;  // n * hc + cy
    const long long pix0 = 2 * row * W + static_cast<long long>(sx) * kStrip;
    const long long c0 = row * wc + static_cast<long long>(sx) * (kStrip / 2);
    const int quads = min(kStrip, W - sx * kStrip) / 2;
    for (int q = 0; q < quads; ++q) {
      const Chroma c = chroma(u[c0 + q], v[c0 + q]);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const long long pix = pix0 + dy * W + 2 * q + dx;
          const int yy = luma(y[pix]);
          uint8_t* o = out + 3 * pix;
          o[0] = static_cast<uint8_t>(sat(yy + c.b));
          o[1] = static_cast<uint8_t>(sat(yy + c.g));
          o[2] = static_cast<uint8_t>(sat(yy + c.r));
        }
      }
    }
  }
}

// The vector path: a block converts R whole strip rows (2R pixel rows,
// whose output is one contiguous 6RW-byte range) into shared memory, then
// writes the range with consecutive 16-byte stores.
__global__ void __launch_bounds__(kThreads)
i420_to_bgr_staged_kernel(const uint8_t* __restrict__ y,
                          const uint8_t* __restrict__ u,
                          const uint8_t* __restrict__ v,
                          uint8_t* __restrict__ out, long long rows, int W,
                          int R) {
  extern __shared__ __align__(16) unsigned char stage[];
  const int spr = W / kStrip;
  const long long r0 = static_cast<long long>(blockIdx.x) * R;
  const int nr = static_cast<int>(rows - r0 < R ? rows - r0 : R);
  for (int k = threadIdx.x; k < nr * spr; k += kThreads) {
    const int lr = k / spr;
    const int sx = k - lr * spr;
    const long long row = r0 + lr;
    uint32_t w0[12], w1[12];
    strip(y, u, v, 2 * row * W + sx * kStrip, row * (W / 2) + sx * (kStrip / 2),
          W, w0, w1);
    uint4* d0 = reinterpret_cast<uint4*>(stage + lr * 6 * W + 48 * sx);
    uint4* d1 = reinterpret_cast<uint4*>(stage + lr * 6 * W + 3 * W + 48 * sx);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      d0[i] = make_uint4(w0[4 * i], w0[4 * i + 1], w0[4 * i + 2], w0[4 * i + 3]);
      d1[i] = make_uint4(w1[4 * i], w1[4 * i + 1], w1[4 * i + 2], w1[4 * i + 3]);
    }
  }
  __syncthreads();
  const uint4* src = reinterpret_cast<const uint4*>(stage);
  uint4* dst = reinterpret_cast<uint4*>(out + r0 * 6 * W);
  const int n16 = nr * 6 * W / 16;
  for (int i = threadIdx.x; i < n16; i += kThreads) __stcs(dst + i, src[i]);
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

extern "C" int mq3d_i420_to_bgr(const void* y, const void* u, const void* v,
                                void* out, int N, int H, int W, void* stream) {
  const long long rows = static_cast<long long>(N) * (H / 2);
  const long long total = rows * ((W + kStrip - 1) / kStrip);
  if (total <= 0 || W <= 0) return static_cast<int>(cudaGetLastError());
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* yp = static_cast<const uint8_t*>(y);
  const auto* up = static_cast<const uint8_t*>(u);
  const auto* vp = static_cast<const uint8_t*>(v);
  auto* op = static_cast<uint8_t*>(out);
  const int spr = W / kStrip;  // 0 for W < 16: no vector path then
  const int R = spr > 0 && spr <= kThreads ? kThreads / spr : 1;
  const size_t smem = 6 * static_cast<size_t>(W) * R;
  const long long blocks = (rows + R - 1) / R;
  const bool vec = (W % kStrip == 0) && aligned(y, 16) && aligned(out, 16) &&
                   aligned(u, 8) && aligned(v, 8) && smem <= kMaxSmem &&
                   blocks <= 0x7fffffffLL;
  if (vec) {
    const cudaError_t err = cudaFuncSetAttribute(
        i420_to_bgr_staged_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    i420_to_bgr_staged_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
                                s>>>(yp, up, vp, op, rows, W, R);
  } else {
    long long grid = (total + kThreads - 1) / kThreads;
    if (grid > 65535LL * 32) grid = 65535LL * 32;  // grid-stride beyond
    i420_to_bgr_scalar_kernel<<<static_cast<unsigned>(grid), kThreads, 0, s>>>(
        yp, up, vp, op, N, H, W);
  }
  return static_cast<int>(cudaGetLastError());
}
