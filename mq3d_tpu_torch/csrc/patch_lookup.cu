// K1: per-pair depth-patch lookup of TSDF integration.
//
// Replaces the Pallas TPU kernel mq3d_tpu/ops/tsdf_pallas.py
// `_lookup_kernel` (pallas_call in `patch_lookup`), reached from
// mq3d_tpu/ops/tsdf.py `_integrate_pairs` when depth_lookup="pallas".
//
//   out[p, v] = patch[p, vi[p, v], ui[p, v]]  if 0 <= vi, ui < PS
//             = 0.0f                          otherwise
//
// Bound on the H100: memory.  Per pair it reads the PSxPS float patch
// (16 KB at PS=64) and the two V-long int32 index rows (16 KB each at
// V=4096) and writes V floats (16 KB): 64 KB per pair against one
// compare-and-load per output, so only the bytes matter.  The whole call
// (33.6 MB at TP=512) takes ~10 us at 3.35 TB/s, so what decides its time
// is how early each SM has enough loads in flight to cover HBM latency.
//
// Design:
//  * The patch is one contiguous row: one thread issues it as a single
//    asynchronous bulk copy (cp.async.bulk) into shared memory, completing
//    on an mbarrier.  No thread spends instructions or registers on it.
//  * While the copy runs, every thread loads its own indices as 16-byte
//    vectors (int4: four voxels; up to kUnroll of them per row), streaming
//    past L1.  Only then does it wait on the barrier, gather four depths
//    from shared memory and store them as one float4.
//  * A block walks pairs blockIdx.x, +gridDim.x, ... with a ring of up to
//    two patch buffers: the copy of pair k+2 is issued as soon as pair k's
//    gathers are done, so it lands while pair k+1 gathers.  The grid holds
//    as many blocks as fit on the card at once (at most TP), so each SM
//    keeps several blocks' loads in flight.
//  * Every shape the wrapper accepts works: the bulk copy needs a 16-byte
//    aligned patch row whose size is a multiple of 16 (even PS); the vector
//    index path needs V % 4 == 0 and 16-byte aligned index and output rows.
//    Otherwise the kernel takes its scalar path for that part (plain loads
//    into shared memory behind __syncthreads, one voxel per load).  Two
//    patch buffers need PS <= 170; up to PS = 238 the ring has one stage.
// It is a pure gather, so the result is bit-identical to the plain
// PyTorch version (mq3d_tpu_torch/ops/tsdf_patch.py patch_lookup_plain).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;      // index vectors (or scalars) loaded per wait
constexpr int kBarBytes = 128;  // barrier area ahead of the patch buffers
constexpr size_t kMaxSmem = 232448;  // 227 KB a block can use

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Spins until the barrier's phase `parity` completes.  A copy that never
// lands (a fault) traps after ~2^30 polls instead of hanging the card.
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 30)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float look(const float* tile, int r, int c, int PS) {
  const bool in_patch = (static_cast<unsigned>(r) < static_cast<unsigned>(PS)) &
                        (static_cast<unsigned>(c) < static_cast<unsigned>(PS));
  return in_patch ? tile[r * PS + c] : 0.0f;
}

__global__ void __launch_bounds__(kThreads)
patch_lookup_kernel(const float* __restrict__ patch, const int* __restrict__ vi,
                    const int* __restrict__ ui, float* __restrict__ out,
                    int TP, int PS, int V, int stages, bool bulk, bool vec) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* bufs = reinterpret_cast<float*>(smem + kBarBytes);
  const int n = PS * PS;
  const int tid = threadIdx.x;

  if (bulk) {
    if (tid == 0) {
      for (int s = 0; s < stages; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :: "r"(smem_addr(bars + s)) : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    if (tid == 0) {
      for (int s = 0; s < stages; ++s) {
        const long long p = blockIdx.x + static_cast<long long>(s) * gridDim.x;
        if (p < TP) bulk_load(bufs + s * n, patch + p * n, n * 4u, bars + s);
      }
    }
  }

  int k = 0;
  for (long long p = blockIdx.x; p < TP; p += gridDim.x, ++k) {
    const int s = k % stages;
    const float* tile = bufs + s * n;
    if (!bulk) {  // scalar staging: odd PS or an unaligned patch
      __syncthreads();  // the previous pair's gathers are done
      const float* src = patch + p * n;
      for (int i = tid; i < n; i += kThreads) bufs[i] = src[i];
      __syncthreads();
    }
    const uint32_t parity = (k / stages) & 1;

    if (vec) {
      const int nv = V >> 2;
      const int4* vrow = reinterpret_cast<const int4*>(vi + p * V);
      const int4* urow = reinterpret_cast<const int4*>(ui + p * V);
      float4* orow = reinterpret_cast<float4*>(out + p * V);
      for (int base = tid, first = 1; first || base < nv;
           base += kThreads * kUnroll, first = 0) {
        int4 a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + u * kThreads;
          if (j < nv) {
            a[u] = __ldcs(vrow + j);
            b[u] = __ldcs(urow + j);
          }
        }
        if (first && bulk) bar_wait(bars + s, parity);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + u * kThreads;
          if (j < nv) {
            float4 r;
            r.x = look(tile, a[u].x, b[u].x, PS);
            r.y = look(tile, a[u].y, b[u].y, PS);
            r.z = look(tile, a[u].z, b[u].z, PS);
            r.w = look(tile, a[u].w, b[u].w, PS);
            __stcs(orow + j, r);
          }
        }
      }
    } else {  // scalar indices: V % 4 != 0 or unaligned rows
      const int* vrow = vi + p * V;
      const int* urow = ui + p * V;
      float* orow = out + p * V;
      for (int base = tid, first = 1; first || base < V;
           base += kThreads * kUnroll, first = 0) {
        int a[kUnroll], b[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + u * kThreads;
          if (j < V) {
            a[u] = __ldcs(vrow + j);
            b[u] = __ldcs(urow + j);
          }
        }
        if (first && bulk) bar_wait(bars + s, parity);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int j = base + u * kThreads;
          if (j < V) __stcs(orow + j, look(tile, a[u], b[u], PS));
        }
      }
    }

    if (bulk) {
      __syncthreads();  // every thread is done with buffer s
      const long long next = p + static_cast<long long>(stages) * gridDim.x;
      if (tid == 0 && next < TP)
        bulk_load(bufs + s * n, patch + next * n, n * 4u, bars + s);
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int mq3d_patch_lookup(const void* patch, const void* vi,
                                 const void* ui, void* out, int TP, int PS,
                                 int V, void* stream) {
  if (TP <= 0 || V <= 0) return static_cast<int>(cudaGetLastError());
  const size_t tile_bytes = static_cast<size_t>(PS) * PS * sizeof(float);
  const bool bulk = PS > 0 && PS % 2 == 0 && aligned16(patch);
  const bool vec = (V % 4 == 0) && aligned16(vi) && aligned16(ui) && aligned16(out);
  const int stages = (bulk && kBarBytes + 2 * tile_bytes <= kMaxSmem) ? 2 : 1;
  const size_t smem = kBarBytes + stages * tile_bytes;
  cudaError_t err = cudaFuncSetAttribute(
      patch_lookup_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, patch_lookup_kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int grid = sms * (per_sm > 0 ? per_sm : 1);
  if (grid > TP) grid = TP;
  patch_lookup_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(patch), static_cast<const int*>(vi),
      static_cast<const int*>(ui), static_cast<float*>(out), TP, PS, V, stages,
      bulk, vec);
  return static_cast<int>(cudaGetLastError());
}
