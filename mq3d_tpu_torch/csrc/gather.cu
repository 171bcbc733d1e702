// K3: gather from a flat float32 table, out[i] = table[idx[i]], with the
// out-of-range rules of the TPU kernels it replaces.
//
// Replaces the three Pallas TPU kernels of tools/probe_pallas_gather.py:
// `gather_take_kernel` (`try_take`) and `gather_grid_kernel` (`try_grid`),
// which compute jnp.take in its fill mode, and `gather2d_kernel`
// (`try_index2d`), which computes x.reshape(-1)[i], XLA's clip mode.  Both
// modes wrap an index in [-n, 0) to n + i; past that, fill mode (mode 0)
// reads NaN (0x7fc00000, jnp.take's fill value) and clip mode (mode 1)
// clamps to [0, n-1].  An index is resolved with a few integer operations
// and an out-of-range draw in fill mode issues no load, so neither costs
// time.
//
// Bound on the H100: memory, but not its byte rate.  The probe's 2^19
// uniform draws move 4 MB of indices and outputs and touch 4 to 16 MB of
// 32-byte table sectors, a few microseconds at 3.35 TB/s.  Timed from a
// cold L2 (mq3d_tpu_torch/utils/devtime.py), a launch costs ~5 us before
// it does anything; tables that fit the L2 then pay two dependent trips to
// HBM (the index, then the table); and beyond the L2 a random draw costs
// HBM a 64-byte access, at about two thirds of its byte rate: draws that
// share 64-byte segments run faster at the same count of 32-byte sectors.
//
// Design: each thread owns kPer elements of a block's chunk.  It issues all
// of its index loads (16-byte vectors, streaming past L1, where the index
// and output pointers are 16-byte aligned), then all kPer table loads, and
// only then stores.  The grid holds as many blocks as fit on the card at
// once (SM count x occupancy), or fewer when the indices need fewer chunks,
// and walks the chunks grid-stride.  Table loads take the read-only path
// and allocate in L1 (__ldg).  The alternatives were timed against this
// one in turns (PERF.md) and lost at the probe's sizes: loads that bypass
// L1, an L2 evict_last policy on the table (its lines also outlive the
// launch and the timer's flush), a table staged in shared memory by
// cp.async.bulk (0.125 MB), and 4 or 16 elements a thread (no change).
// Unaligned index or output pointers take scalar index loads; with aligned
// ones the last m % 4 elements are gathered one by one.  It is a pure
// gather, so the result is bit-identical to the plain PyTorch version
// (mq3d_tpu_torch/ops/gather.py gather_plain).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 8;  // elements a thread owns in a chunk
constexpr long long kChunk = static_cast<long long>(kThreads) * kPer;
constexpr unsigned kNaN = 0x7fc00000u;

// Position of index i in the table, and whether it reads the table (false:
// fill mode's NaN).  In clip mode every index reads (n >= 1).
__device__ __forceinline__ int resolve(int i, int n, bool clip, bool* ok) {
  int j = i < 0 ? i + n : i;
  if (clip) j = min(max(j, 0), n - 1);
  *ok = static_cast<unsigned>(j) < static_cast<unsigned>(n);
  return j;
}

// table[j] if ok, else NaN; no load is issued when !ok.
__device__ __forceinline__ float load_table(const float* __restrict__ table, int j,
                                            bool ok) {
  return ok ? __ldg(table + j) : __uint_as_float(kNaN);
}

// kVec is 4 (16-byte index and output vectors) or 1.  The chunks cover the
// first m rounded down to kVec elements; the last block gathers the rest.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
gather_kernel(const float* __restrict__ table, int n, const int* __restrict__ idx,
              float* __restrict__ out, long long m, bool clip) {
  const long long limit = m / kVec * kVec;
  for (long long base = blockIdx.x * kChunk; base < limit;
       base += static_cast<long long>(gridDim.x) * kChunk) {
    int iv[kPer];
#pragma unroll
    for (int u = 0; u < kPer / kVec; ++u) {
      const long long e = base + (static_cast<long long>(u) * kThreads + threadIdx.x) * kVec;
      if (e >= limit) {
#pragma unroll
        for (int k = 0; k < kVec; ++k) iv[u * kVec + k] = 0;
      } else if constexpr (kVec == 4) {
        const int4 t = __ldcs(reinterpret_cast<const int4*>(idx + e));
        iv[4 * u] = t.x; iv[4 * u + 1] = t.y; iv[4 * u + 2] = t.z; iv[4 * u + 3] = t.w;
      } else {
        iv[u] = __ldcs(idx + e);
      }
    }
    float r[kPer];
#pragma unroll
    for (int u = 0; u < kPer / kVec; ++u) {
      const long long e = base + (static_cast<long long>(u) * kThreads + threadIdx.x) * kVec;
#pragma unroll
      for (int k = 0; k < kVec; ++k) {
        bool ok;
        const int j = resolve(iv[u * kVec + k], n, clip, &ok);
        r[u * kVec + k] = load_table(table, j, ok && e < limit);
      }
    }
#pragma unroll
    for (int u = 0; u < kPer / kVec; ++u) {
      const long long e = base + (static_cast<long long>(u) * kThreads + threadIdx.x) * kVec;
      if (e >= limit) continue;
      if constexpr (kVec == 4)
        __stcs(reinterpret_cast<float4*>(out + e),
               make_float4(r[4 * u], r[4 * u + 1], r[4 * u + 2], r[4 * u + 3]));
      else
        __stcs(out + e, r[u]);
    }
  }
  if (kVec > 1 && blockIdx.x == gridDim.x - 1 && threadIdx.x < m - limit) {
    const long long e = limit + threadIdx.x;
    bool ok;
    const int j = resolve(__ldcs(idx + e), n, clip, &ok);
    __stcs(out + e, load_table(table, j, ok));
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <int kVec>
cudaError_t launch(const float* table, int n, const int* idx, float* out, long long m,
                   bool clip, cudaStream_t stream) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, gather_kernel<kVec>, kThreads, 0);
  if (err != cudaSuccess) return err;
  const long long chunks = (m / kVec * kVec + kChunk - 1) / kChunk;
  long long grid = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (grid > chunks) grid = chunks;
  if (grid < 1) grid = 1;  // m < kVec: the last elements alone
  gather_kernel<kVec><<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(
      table, n, idx, out, m, clip);
  return cudaGetLastError();
}

}  // namespace

// mode: 0 fill (jnp.take), 1 clip (x.reshape(-1)[i]).
extern "C" int mq3d_gather(const void* table, int n, const void* idx, void* out,
                           long long m, int mode, void* stream) {
  if (m <= 0) return static_cast<int>(cudaGetLastError());
  if (n < 0 || (mode != 0 && mode != 1) || (mode == 1 && n == 0))
    return static_cast<int>(cudaErrorInvalidValue);
  auto t = static_cast<const float*>(table);
  auto i = static_cast<const int*>(idx);
  auto o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  const bool clip = mode == 1;
  const cudaError_t err = aligned16(idx) && aligned16(out)
                              ? launch<4>(t, n, i, o, m, clip, s)
                              : launch<1>(t, n, i, o, m, clip, s);
  return static_cast<int>(err);
}
