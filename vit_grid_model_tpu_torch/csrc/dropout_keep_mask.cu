// Standalone writer of the attention-dropout keep mask, so that the card
// can hold the in-kernel hash (dropout_hash.cuh, the port of
// vit_grid_model_tpu/ops/pallas/attention.py::_hash_keep / _keep_mask)
// bit for bit against its plain version, ops/dropout.py::keep_mask.
//
// The attention kernels never call this: they evaluate vgm_keep inline.
// One thread per element; it is bound by the 4-byte store of each element.

#include <cuda_runtime.h>

#include "dropout_hash.cuh"

namespace {

__global__ void dropout_keep_mask_kernel(float* __restrict__ out, long total,
                                         int heads, int n, int n_pad,
                                         unsigned seed, unsigned threshold,
                                         float scale) {
  for (long e = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<long>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(e % n);
    const int row = static_cast<int>((e / n) % n);
    const long wh = e / (static_cast<long>(n) * n);
    const int h = static_cast<int>(wh % heads);
    const unsigned win = static_cast<unsigned>(wh / heads);
    out[e] = vgm_keep(seed, win, h, row, col, heads, n_pad, threshold, scale);
  }
}

}  // namespace

// out: f32 (bw, heads, n, n), contiguous.  Returns cudaGetLastError().
extern "C" int vgm_dropout_keep_mask(void* out, int bw, int heads, int n,
                                     int seed, int threshold, float scale,
                                     void* stream) {
  if (bw < 1 || heads < 1 || n < 1) return static_cast<int>(
      cudaErrorInvalidValue);
  const long total = static_cast<long>(bw) * heads * n * n;
  const int threads = 256;
  const long want = (total + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 65535 * 8 ? want : 65535 * 8);
  dropout_keep_mask_kernel<<<blocks, threads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), total, heads, n, vgm_hash_n_pad(n),
      static_cast<unsigned>(seed), static_cast<unsigned>(threshold), scale);
  return static_cast<int>(cudaGetLastError());
}
