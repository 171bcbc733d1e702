// K4: the correctly rounded float32 fused multiply-add,
//
//   out[i] = a[ia] * b[ib] + c[ic], rounded once (fma.rn.f32),
//
// over the operands' broadcast shape, each operand read through its own
// strides.
//
// Replaces no Pallas kernel.  It stands for XLA's fused multiply-add: the
// JAX package's projections, merge, ray march, ICP distances and the
// evaluation's dot products compile `a*b + c` to one FMA, and
// mq3d_tpu_torch/ops/fma.py `fma` reproduces it.  Its plain version there
// (`fma_plain`) emulates the single rounding in float64, about 17
// elementwise passes and 318 bytes an element; the hardware instruction is
// correctly rounded by definition, so one pass gives the same bits.
// `__fmaf_rn` is spelled out so the result does not depend on -fmad, and
// the library is built without --use_fast_math or --ftz=true, so subnormal
// inputs and results stay exact.
//
// Bound on the H100: memory, 3 float32 reads and 1 write an element at
// most (a broadcast operand is read once), about 16 bytes an element over
// 3.35 TB/s.  One FMA an element is nothing beside that.
//
// Design:
//  * The wrapper drops size-1 dimensions, merges the dimensions every
//    operand lets it merge, and passes the rest (at most kMaxDims, the
//    innermost first) with each operand's strides in elements by value as
//    a kernel parameter: a broadcast dimension has stride 0 and is never
//    materialised, and no metadata is copied to the card.
//  * Vector path: one dimension left, every operand either contiguous
//    (stride 1) and 16-byte aligned or a scalar (stride 0).  Each thread
//    loads float4s and stores a float4; the last n % 4 elements are done
//    one by one.
//  * Strided path: each thread owns kPer elements of a block's chunk,
//    kThreads apart so a warp's accesses to the output are contiguous, and
//    finds each operand's offset from the element's index.  Indices are 32
//    bits, with the division by each dimension's size done by a
//    multiply-high and a shift (a magic number made on the host), where
//    the element count and every operand's largest offset fit in 31 bits,
//    and 64 bits with plain division otherwise.
//  * Grids hold as many blocks as fit on the card at once (found once per
//    kernel and device), or fewer when the work needs fewer, and walk the
//    chunks grid-stride.

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxDims = 6;
constexpr int kThreads = 256;
constexpr int kPer = 4;  // elements a thread owns in a strided chunk

// n / d for n < 2^31 as ((umulhi(n, mul) + n) >> shift).
struct FastDiv {
  uint32_t div, mul, shift;
};

FastDiv make_div(uint32_t d) {
  uint32_t shift = 0;
  while (shift < 32 && (1ull << shift) < d) ++shift;
  const uint64_t mul = ((1ull << 32) * ((1ull << shift) - d)) / d + 1;
  return {d, static_cast<uint32_t>(mul), shift};
}

__device__ __forceinline__ uint32_t fast_div(uint32_t n, const FastDiv& f) {
  return (__umulhi(n, f.mul) + n) >> f.shift;
}

struct Layout32 {
  int ndim;
  FastDiv size[kMaxDims];
  uint32_t stride[3][kMaxDims];
};

struct Layout64 {
  int ndim;
  long long size[kMaxDims];
  long long stride[3][kMaxDims];
};

__device__ __forceinline__ void offsets(uint32_t i, const Layout32& L, uint32_t* o) {
  o[0] = o[1] = o[2] = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d == L.ndim - 1) {  // the outermost dimension: the rest is its coordinate
      o[0] += i * L.stride[0][d]; o[1] += i * L.stride[1][d]; o[2] += i * L.stride[2][d];
      break;
    }
    const uint32_t q = fast_div(i, L.size[d]);
    const uint32_t x = i - q * L.size[d].div;
    o[0] += x * L.stride[0][d]; o[1] += x * L.stride[1][d]; o[2] += x * L.stride[2][d];
    i = q;
  }
}

__device__ __forceinline__ void offsets(long long i, const Layout64& L, long long* o) {
  o[0] = o[1] = o[2] = 0;
#pragma unroll
  for (int d = 0; d < kMaxDims; ++d) {
    if (d == L.ndim - 1) {
      o[0] += i * L.stride[0][d]; o[1] += i * L.stride[1][d]; o[2] += i * L.stride[2][d];
      break;
    }
    const long long q = i / L.size[d];
    const long long x = i - q * L.size[d];
    o[0] += x * L.stride[0][d]; o[1] += x * L.stride[1][d]; o[2] += x * L.stride[2][d];
    i = q;
  }
}

template <typename Index, typename Layout>
__global__ void __launch_bounds__(kThreads)
fma_strided(const float* __restrict__ a, const float* __restrict__ b,
            const float* __restrict__ c, float* __restrict__ out, Index n,
            const Layout L) {
  const Index chunk = static_cast<Index>(kThreads) * kPer;
  for (Index base = static_cast<Index>(blockIdx.x) * chunk; base < n;
       base += static_cast<Index>(gridDim.x) * chunk) {
    float r[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const Index i = base + static_cast<Index>(u) * kThreads + threadIdx.x;
      if (i < n) {
        Index o[3];
        offsets(i, L, o);
        r[u] = __fmaf_rn(__ldg(a + o[0]), __ldg(b + o[1]), __ldg(c + o[2]));
      }
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const Index i = base + static_cast<Index>(u) * kThreads + threadIdx.x;
      if (i < n) out[i] = r[u];
    }
  }
}

__device__ __forceinline__ float4 load4(const float* p, long long q, bool scalar, float s) {
  return scalar ? make_float4(s, s, s, s) : __ldg(reinterpret_cast<const float4*>(p) + q);
}

// scalar_mask bit k: operand k (a, b, c) is one value.
__global__ void __launch_bounds__(kThreads)
fma_vec4(const float* __restrict__ a, const float* __restrict__ b,
         const float* __restrict__ c, float* __restrict__ out, long long n,
         int scalar_mask) {
  const bool sa = scalar_mask & 1, sb = scalar_mask & 2, sc = scalar_mask & 4;
  const float va = sa ? __ldg(a) : 0.f, vb = sb ? __ldg(b) : 0.f, vc = sc ? __ldg(c) : 0.f;
  const long long n4 = n / 4;
  for (long long q = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; q < n4;
       q += static_cast<long long>(gridDim.x) * kThreads) {
    const float4 x = load4(a, q, sa, va), y = load4(b, q, sb, vb), z = load4(c, q, sc, vc);
    reinterpret_cast<float4*>(out)[q] =
        make_float4(__fmaf_rn(x.x, y.x, z.x), __fmaf_rn(x.y, y.y, z.y),
                    __fmaf_rn(x.z, y.z, z.z), __fmaf_rn(x.w, y.w, z.w));
  }
  if (blockIdx.x == 0 && threadIdx.x < n - n4 * 4) {
    const long long e = n4 * 4 + threadIdx.x;
    out[e] = __fmaf_rn(sa ? va : a[e], sb ? vb : b[e], sc ? vc : c[e]);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

constexpr int kMaxDevices = 64;

// Blocks of `kernel` that fit on the card at once, capped by `wanted`.  The
// card's count is asked for once per kernel and device, and kept.
template <auto kernel>
cudaError_t grid_for(long long wanted, unsigned* grid) {
  static std::atomic<long long> resident[kMaxDevices];  // 0: not asked yet
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  long long g = dev < kMaxDevices ? resident[dev].load(std::memory_order_relaxed) : 0;
  if (g == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    g = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
    if (dev < kMaxDevices) resident[dev].store(g, std::memory_order_relaxed);
  }
  if (g > wanted) g = wanted;
  *grid = static_cast<unsigned>(g < 1 ? 1 : g);
  return cudaSuccess;
}

}  // namespace

// out (n contiguous floats) = fma(a, b, c) over a layout of ndim dimensions,
// the innermost first: sizes[d] (each >= 2, product n) and strides[k * ndim
// + d], operand k's stride in elements along dimension d (0: broadcast).
// ndim 0 is a single element.
extern "C" int mq3d_fma(const void* a, const void* b, const void* c, void* out, int ndim,
                        const long long* sizes, const long long* strides, void* stream) {
  if (ndim < 0 || ndim > kMaxDims) return static_cast<int>(cudaErrorInvalidValue);
  const long long one = 1, zeros[3] = {0, 0, 0};
  if (ndim == 0) {  // one element: a dimension of size 1 that every operand broadcasts
    ndim = 1;
    sizes = &one;
    strides = zeros;
  }
  long long n = 1;
  long long reach[3] = {0, 0, 0};  // each operand's largest offset
  for (int d = 0; d < ndim; ++d) {
    if (sizes[d] < 1) return static_cast<int>(cudaErrorInvalidValue);
    n *= sizes[d];
    for (int k = 0; k < 3; ++k) {
      if (strides[k * ndim + d] < 0) return static_cast<int>(cudaErrorInvalidValue);
      reach[k] += (sizes[d] - 1) * strides[k * ndim + d];
    }
  }
  const float* p[3] = {static_cast<const float*>(a), static_cast<const float*>(b),
                       static_cast<const float*>(c)};
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  unsigned grid = 0;
  cudaError_t err;

  bool vec = ndim == 1 && aligned16(out);
  int scalar_mask = 0;
  for (int k = 0; k < 3 && vec; ++k) {
    const long long st = strides[k];
    if (st == 0) scalar_mask |= 1 << k;
    else vec = st == 1 && aligned16(p[k]);
  }
  if (vec) {
    err = grid_for<fma_vec4>((n / 4 + kThreads - 1) / kThreads, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    fma_vec4<<<grid, kThreads, 0, s>>>(p[0], p[1], p[2], o, n, scalar_mask);
    return static_cast<int>(cudaGetLastError());
  }

  const long long chunks = (n + kThreads * kPer - 1) / (kThreads * kPer);
  const long long limit = 1ll << 31;
  if (n < limit && reach[0] < limit && reach[1] < limit && reach[2] < limit) {
    Layout32 L{};
    L.ndim = ndim;
    for (int d = 0; d < ndim; ++d) {
      L.size[d] = make_div(static_cast<uint32_t>(sizes[d]));
      for (int k = 0; k < 3; ++k) L.stride[k][d] = static_cast<uint32_t>(strides[k * ndim + d]);
    }
    err = grid_for<fma_strided<uint32_t, Layout32>>(chunks, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    fma_strided<uint32_t, Layout32><<<grid, kThreads, 0, s>>>(
        p[0], p[1], p[2], o, static_cast<uint32_t>(n), L);
  } else {
    Layout64 L{};
    L.ndim = ndim;
    for (int d = 0; d < ndim; ++d) {
      L.size[d] = sizes[d];
      for (int k = 0; k < 3; ++k) L.stride[k][d] = strides[k * ndim + d];
    }
    err = grid_for<fma_strided<long long, Layout64>>(chunks, &grid);
    if (err != cudaSuccess) return static_cast<int>(err);
    fma_strided<long long, Layout64><<<grid, kThreads, 0, s>>>(p[0], p[1], p[2], o, n, L);
  }
  return static_cast<int>(cudaGetLastError());
}
