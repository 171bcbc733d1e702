// K2: I420 -> BGR colour conversion, fixed-point BT.601 (bit-exact with
// OpenCV's cvtColor(COLOR_YUV2BGR_I420)).
//
// Replaces the Pallas TPU kernel mq3d_tpu/ops/yuv_pallas.py `_i420_kernel`
// (pallas_call in `_convert_padded`, driven by `yuv420_to_bgr_pallas`),
// which computes the same function as mq3d_tpu/ops/yuv.py `yuv420_to_8uc3`.
//
// Bound on the H100: memory.  Per pixel it reads 1 byte of luma and
// 2 x 1/4 byte of chroma and writes 3 bytes: 4.5 bytes per pixel against a
// few integer operations.
//
// Design (the simple, correct first version; speed is left to later
// work): one thread per 2x2 luma quad over the full (N, H, W) batch.  The
// thread computes the quad's shared chroma terms once and writes its four
// BGR pixels.  The TPU kernel's quad-split, padding and interleave were
// workarounds for the TPU compiler and are not carried over.

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

__device__ __forceinline__ uint8_t sat(int x) {
  x >>= kShift;  // arithmetic shift, as the reference's int32 `>>`
  return static_cast<uint8_t>(x < 0 ? 0 : (x > 255 ? 255 : x));
}

__global__ void i420_to_bgr_kernel(const uint8_t* __restrict__ y,
                                   const uint8_t* __restrict__ u,
                                   const uint8_t* __restrict__ v,
                                   uint8_t* __restrict__ out, int N, int H,
                                   int W) {
  const int hc = H / 2;
  const int wc = W / 2;
  const long long total = static_cast<long long>(N) * hc * wc;
  for (long long q = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
       q < total; q += static_cast<long long>(gridDim.x) * blockDim.x) {
    const int cx = static_cast<int>(q % wc);
    const long long t = q / wc;
    const int cy = static_cast<int>(t % hc);
    const long long n = t / hc;
    const int uu = static_cast<int>(u[q]) - 128;
    const int vv = static_cast<int>(v[q]) - 128;
    const int ruv = kHalf + kCVR * vv;
    const int guv = kHalf + kCVG * vv + kCUG * uu;
    const int buv = kHalf + kCUB * uu;
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
      for (int dx = 0; dx < 2; ++dx) {
        const long long pix = (n * H + 2 * cy + dy) * W + 2 * cx + dx;
        int yy = static_cast<int>(y[pix]) - 16;
        yy = (yy > 0 ? yy : 0) * kCY;
        uint8_t* o = out + pix * 3;
        o[0] = sat(yy + buv);
        o[1] = sat(yy + guv);
        o[2] = sat(yy + ruv);
      }
    }
  }
}

}  // namespace

extern "C" int mq3d_i420_to_bgr(const void* y, const void* u, const void* v,
                                void* out, int N, int H, int W,
                                void* stream) {
  const long long total = static_cast<long long>(N) * (H / 2) * (W / 2);
  if (total <= 0) return static_cast<int>(cudaGetLastError());
  long long blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  i420_to_bgr_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(y), static_cast<const uint8_t*>(u),
      static_cast<const uint8_t*>(v), static_cast<uint8_t*>(out), N, H, W);
  return static_cast<int>(cudaGetLastError());
}
