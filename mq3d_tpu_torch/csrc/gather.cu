// K3: gather from a flat float32 table, out[i] = table[idx[i]].
//
// Replaces the three Pallas TPU kernels of tools/probe_pallas_gather.py,
// `gather_take_kernel` (`try_take`), `gather2d_kernel` (`try_index2d`) and
// `gather_grid_kernel` (`try_grid`).  They asked one question of the TPU
// compiler (Mosaic): can a kernel gather with a vector of runtime indices
// from a table held in VMEM, whole, as (rows, 128), or over a grid of index
// blocks?  On the card the three layouts are one function: any thread can
// load any address, and where the table lives follows from its size.  A
// table under 227 KB fits one block's shared memory; under the 50 MB L2 it
// stays in cache across the launch; larger tables are read from HBM.
//
// Bound on the H100: memory.  Each index and output is moved once (8 bytes
// per element), and each distinct table element is read once at best; a
// random gather fetches a whole 32-byte sector per element, so over a
// table that does not sit in L2 it moves up to 8x the bound's table bytes.
//
// Design: one thread per four outputs.  Indices are loaded as 16-byte
// vectors streaming past L1, the four table reads go through the
// read-only path (__ldg), and the four results leave as one float4.  An
// index outside [0, n) reads NaN, as jnp.take's default fill mode does
// (the plain version, torch.take, rejects it).  When the element count is
// not a multiple of 4 or a pointer is not 16-byte aligned, the kernel
// takes its scalar path: one element per load and store.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float fetch(const float* __restrict__ table, int i,
                                       int n) {
  return static_cast<unsigned>(i) < static_cast<unsigned>(n) ? __ldg(table + i)
                                                             : __int_as_float(0x7fc00000);
}

__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, int n, const int* __restrict__ idx,
              float* __restrict__ out, long long m, bool vec) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long t0 = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (vec) {
    const int4* idx4 = reinterpret_cast<const int4*>(idx);
    float4* out4 = reinterpret_cast<float4*>(out);
    for (long long t = t0; t < m / 4; t += stride) {
      const int4 i = __ldcs(idx4 + t);
      float4 r;
      r.x = fetch(table, i.x, n);
      r.y = fetch(table, i.y, n);
      r.z = fetch(table, i.z, n);
      r.w = fetch(table, i.w, n);
      __stcs(out4 + t, r);
    }
  } else {
    for (long long t = t0; t < m; t += stride)
      out[t] = fetch(table, __ldcs(idx + t), n);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int mq3d_gather(const void* table, int n, const void* idx, void* out,
                           long long m, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = m % 4 == 0 && aligned16(idx) && aligned16(out);
  const long long work = vec ? m / 4 : m;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 65535LL * 32) blocks = 65535LL * 32;  // grid-stride beyond
  gather_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), n, static_cast<const int*>(idx),
      static_cast<float*>(out), m, vec);
  return static_cast<int>(cudaGetLastError());
}
