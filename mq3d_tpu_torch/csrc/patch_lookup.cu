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
// V=4096) and writes V floats (16 KB): about 64 KB per pair and one
// compare-and-load per output, so no arithmetic limit is near.
//
// Design (the simple, correct first version; speed is left to later
// work): one thread block per pair stages the pair's patch in shared
// memory, then one thread per voxel (a block-stride loop over V) reads
// its two indices and fetches from shared memory.  It is a pure gather,
// so the result is bit-identical to the plain PyTorch version
// (mq3d_tpu_torch/ops/tsdf_patch.py patch_lookup_plain).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void patch_lookup_kernel(const float* __restrict__ patch,
                                    const int* __restrict__ vi,
                                    const int* __restrict__ ui,
                                    float* __restrict__ out, int PS, int V) {
  extern __shared__ float tile[];
  const long long p = blockIdx.x;
  const int n = PS * PS;
  const float* src = patch + p * n;
  for (int i = threadIdx.x; i < n; i += blockDim.x) tile[i] = src[i];
  __syncthreads();

  const int* vrow = vi + p * V;
  const int* urow = ui + p * V;
  float* orow = out + p * V;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    const int r = vrow[v];
    const int c = urow[v];
    const bool in_patch = (r >= 0) & (r < PS) & (c >= 0) & (c < PS);
    orow[v] = in_patch ? tile[r * PS + c] : 0.0f;
  }
}

}  // namespace

extern "C" int mq3d_patch_lookup(const void* patch, const void* vi,
                                 const void* ui, void* out, int TP, int PS,
                                 int V, void* stream) {
  if (TP <= 0 || V <= 0) return static_cast<int>(cudaGetLastError());
  const size_t smem = static_cast<size_t>(PS) * PS * sizeof(float);
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(patch_lookup_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  patch_lookup_kernel<<<TP, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(patch), static_cast<const int*>(vi),
      static_cast<const int*>(ui), static_cast<float*>(out), PS, V);
  return static_cast<int>(cudaGetLastError());
}
