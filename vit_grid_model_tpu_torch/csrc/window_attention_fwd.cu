// Fused MaxViT window-attention forward for Hopper (sm_90a).
//
// Replaces vit_grid_model_tpu/ops/pallas/attention.py::_attention_kernel
// (per-head layout), with its in-kernel attention dropout.  For every
// window of n <= 64 tokens it computes, in one CTA and without writing any
// intermediate to device memory:
//
//   xn   = LayerNorm(x) (eps 1e-5, no affine) * gamma + beta    (FiLM, or
//          the LN affine for unconditioned layers, or nothing)
//   per head h:
//     q, k, v = xn . Wqkv_h
//     q <- q * rsqrt(max(sum q^2, 1e-24)) * sqrt(dh) * gq_h   (same for k)
//     S  = q k^T + bias_h, -1e30 on key columns >= n
//     P  = softmax(S) with this head's own row max
//     P *= keep(seed, window, h, row, col)   (training dropout, rate > 0;
//          dropout_hash.cuh, the same values the backward regenerates)
//     Y += (P . v) . Wout_h
//
// in f32.  For bf16 inputs the normalized x and each head's P.v are rounded
// to bf16 before their products, as the TPU kernel does; every sum is f32.
//
// What bounds it on an H100.  At the flagship shape (dim 128, 32 heads x
// 32, n = 53) one window costs ~67 MFLOP (qkv 41.7, out-projection 13.9,
// scores + P.v 11.5) and reads or writes only ~27 KB of activations, so
// the kernel is bound by arithmetic, not by device memory: at batch 25 the
// two calls of a layer run ~1.2 TFLOP over 2 x 9,000 windows.  The
// Wqkv + Wout weights (~1 MB in bf16) are re-read from L2 once per CTA.
//
// What this design does about it.  One CTA of 256 threads owns one window
// with its tokens padded to 64 rows; everything between the x load and the
// output store (normalized x, q/k/v, scores, the f32 output accumulator)
// stays in shared memory, sized so two CTAs fit on an SM at the flagship
// shape.  In bf16 (dim and dh multiples of 16) the two projections, 83% of
// the FLOPs, run on the tensor cores through wmma 16x16x16 tiles with f32
// sums, their weight fragments read straight from L2; everything else, and
// the whole f32 path, runs register-tiled 4x4 per thread on CUDA-core FMAs
// (f32 keeps its exact products: TF32 would not meet the f32 tolerance).
// This is the simple first version: wgmma, TMA staging and several windows
// per CTA, to share weight loads, are later work.  The per-window body lives
// in window_attention_body.cuh, which the MaxViT layer megakernel shares.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attention_body.cuh"

namespace {

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 2)
    window_attention_fwd_kernel(
        const T* __restrict__ x, const float* __restrict__ gamma,
        const float* __restrict__ beta, const T* __restrict__ wqkv,
        const float* __restrict__ q_gamma, const float* __restrict__ k_gamma,
        const T* __restrict__ wout, const float* __restrict__ bias,
        T* __restrict__ out, int n, int dim, int heads, int dh,
        int windows_per_sample, int has_film, unsigned seed,
        unsigned keep_threshold, float keep_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan plan = make_plan<kTC>(dim, dh);
  const int win = blockIdx.x;
  const T* xw = x + static_cast<size_t>(win) * n * dim;
  const size_t sample = static_cast<size_t>(win / windows_per_sample) * dim;
  layer_norm_rows<T, kTC>(
      smem, plan, [&](int r, int c) { return to_f32(xw[r * dim + c]); }, n,
      dim, gamma + sample, beta + sample, has_film);
  __syncthreads();
  attend_window<T, kTC>(smem, plan, wqkv, q_gamma, k_gamma, wout, bias, n,
                        dim, heads, dh, win, seed, keep_threshold,
                        keep_scale);
  const float* y = reinterpret_cast<const float*>(smem + plan.y);
  T* ow = out + static_cast<size_t>(win) * n * dim;
  for (int e = threadIdx.x; e < n * dim; e += kThreads)
    ow[e] = from_f32<T>(y[e]);
}

template <typename T, bool kTC>
int launch(const void* x, const void* gamma, const void* beta,
           const void* wqkv, const void* q_gamma, const void* k_gamma,
           const void* wout, const void* bias, void* out, int bw, int n,
           int dim, int heads, int dh, int windows_per_sample, int has_film,
           unsigned seed, unsigned keep_threshold, float keep_scale,
           cudaStream_t stream) {
  const size_t smem = make_plan<kTC>(dim, dh).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd_kernel<T, kTC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_fwd_kernel<T, kTC><<<bw, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(wqkv),
      static_cast<const float*>(q_gamma), static_cast<const float*>(k_gamma),
      static_cast<const T*>(wout), static_cast<const float*>(bias),
      static_cast<T*>(out), n, dim, heads, dh, windows_per_sample, has_film,
      seed, keep_threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (bw, n, dim) in f32 or bf16 (is_bf16); gamma, beta: f32
// (bw / windows_per_sample, dim), read only when has_film; wqkv: (heads,
// dim, 3*dh) and wout: (heads, dh, dim) in x's type; q_gamma, k_gamma:
// f32 (heads, dh); bias: f32 (heads, n, n).  All contiguous.  Dropout:
// keep_threshold = 0 turns it off, else see dropout_hash.cuh.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vgm_window_attention_fwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* q_gamma, const void* k_gamma, const void* wout,
    const void* bias, void* out, int bw, int n, int dim, int heads, int dh,
    int windows_per_sample, int has_film, int is_bf16, int seed,
    int keep_threshold, float keep_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned sd = static_cast<unsigned>(seed);
  const unsigned thr = static_cast<unsigned>(keep_threshold);
  if (n < 1 || n > kRows || dim < 1 || dim > kMaxDim || dh < 1 ||
      dh > kMaxDimHead)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && dim % 16 == 0 && dh % 16 == 0)
    return launch<__nv_bfloat16, true>(x, gamma, beta, wqkv, q_gamma, k_gamma,
                                       wout, bias, out, bw, n, dim, heads, dh,
                                       windows_per_sample, has_film, sd, thr,
                                       keep_scale, st);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, gamma, beta, wqkv, q_gamma,
                                        k_gamma, wout, bias, out, bw, n, dim,
                                        heads, dh, windows_per_sample,
                                        has_film, sd, thr, keep_scale, st);
  return launch<float, false>(x, gamma, beta, wqkv, q_gamma, k_gamma, wout,
                              bias, out, bw, n, dim, heads, dh,
                              windows_per_sample, has_film, sd, thr,
                              keep_scale, st);
}
