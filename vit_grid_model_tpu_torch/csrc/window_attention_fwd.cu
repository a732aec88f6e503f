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
// Two paths, one CTA of 256 threads a window with its tokens padded to a
// 64-row tile, everything between the x load and the output store in
// shared memory or registers.
//
// The strip path (bf16, dim and dh multiples of 16, dim <= 128, dh <=
// 32: the path of the --fast evaluation and training) runs every product
// on mma.sync m16n8k16 tensor-core tiles in warp-owned 16-row strips: the
// q|k|v product with the QK-RMSNorm in its epilogue, S = qn kn^T and
// O = P v from f32 operands split into bf16 high and low parts (the TPU
// kernel feeds both f32 operands; hi.hi + hi.lo + lo.hi, ~2^-16 relative
// error), softmax and the dropout keep value in registers, y += o . Wout_h
// into y's register fragments.  Each head's Wqkv_h and Wout_h (35 KB at
// the flagship shape) are staged in shared memory by cp.async ahead of
// use.  No score tile and no y tile live in shared memory: 84 KB a CTA at
// the flagship shape, two CTAs an SM, 127 registers a thread.  The body is
// window_attention_strips.cuh, which the MaxViT layer megakernel (R7)
// shares with an epilogue of its own; here the epilogue stores y's rows
// < n in bf16.  At the flagship shape on an NVIDIA H100 80GB HBM3 at 700 W
// it takes ~9.7 ms at Bw = 9,000 and ~2.0 ms at Bw = 1,440 with dropout,
// against ~32.5 and ~5.8 for the first design's bf16 path (wmma
// projections with their weight fragments read from L2, the n x n
// products on CUDA cores); one CTA an SM with a whole head's weights in
// flight took ~15 ms.
//
// The first design runs f32, and bf16 that the strip path does not take,
// as it did: every product as register-tiled 4x4 f32 CUDA-core FMAs (f32
// keeps its exact products: TF32 would not meet the f32 tolerance), the
// n x n products through a 64 x 64 shared score tile, in
// window_attention_body.cuh, whose wmma projections R7 runs in bf16 off
// the strip path.  Until the strip path, K1 ran those wmma projections for
// bf16 at every width of 16 multiples; bf16 wider than the strip path
// takes (dim > 128 or dh > 32, which no configuration uses) now runs the
// CUDA-core products.  wgmma, TMA staging, several windows per CTA (to
// share weight loads) and a persistent grid are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "window_attention_body.cuh"
#include "window_attention_strips.cuh"

namespace {

// The first design (f32, and bf16 that the strip path does not take).
template <typename T>
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
  const Plan plan = make_plan<false>(dim, dh);
  const int win = blockIdx.x;
  const T* xw = x + static_cast<size_t>(win) * n * dim;
  const size_t sample = static_cast<size_t>(win / windows_per_sample) * dim;
  layer_norm_rows<T, false>(
      smem, plan, [&](int r, int c) { return to_f32(xw[r * dim + c]); }, n,
      dim, gamma + sample, beta + sample, has_film);
  __syncthreads();
  attend_window<T, false>(smem, plan, wqkv, q_gamma, k_gamma, wout, bias,
                          n, dim, heads, dh, win, seed, keep_threshold,
                          keep_scale);
  const float* y = reinterpret_cast<const float*>(smem + plan.y);
  T* ow = out + static_cast<size_t>(win) * n * dim;
  for (int e = threadIdx.x; e < n * dim; e += kThreads)
    ow[e] = from_f32<T>(y[e]);
}

// ---- the strip path: the body in window_attention_strips.cuh ----

__global__ void __launch_bounds__(kThreads, 2)
    window_attention_fwd_strips(
        const bf16* __restrict__ x, const float* __restrict__ gamma,
        const float* __restrict__ beta, const bf16* __restrict__ wqkv,
        const float* __restrict__ q_gamma, const float* __restrict__ k_gamma,
        const bf16* __restrict__ wout, const float* __restrict__ bias,
        bf16* __restrict__ out, int n, int dim, int heads, int dh,
        int windows_per_sample, int has_film, unsigned seed,
        unsigned keep_threshold, float keep_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StripPlan plan = make_strip_plan(dim, dh, dim);
  const int win = blockIdx.x;
  const bf16* xw = x + static_cast<size_t>(win) * n * dim;
  const size_t sample = static_cast<size_t>(win / windows_per_sample) * dim;
  attend_window_strips(
      smem, plan,
      norm_rows([&](int r, int c) { return to_f32(xw[r * dim + c]); },
                gamma + sample, beta + sample, has_film),
      n, dim, wqkv, q_gamma, k_gamma, wout, bias, heads, dh, dim, win, seed,
      keep_threshold, keep_scale,
      [&](int r, int c, float v0, float v1) {
        // the row's address from the parameters: nothing held across the
        // heads
        bf16* ow = out + static_cast<size_t>(blockIdx.x) * n * dim;
        *reinterpret_cast<uint32_t*>(ow + r * dim + c) = pack_bf16(v0, v1);
      });
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta,
           const void* wqkv, const void* q_gamma, const void* k_gamma,
           const void* wout, const void* bias, void* out, int bw, int n,
           int dim, int heads, int dh, int windows_per_sample, int has_film,
           unsigned seed, unsigned keep_threshold, float keep_scale,
           cudaStream_t stream) {
  const size_t smem = make_plan<false>(dim, dh).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_fwd_kernel<T><<<bw, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(wqkv),
      static_cast<const float*>(q_gamma), static_cast<const float*>(k_gamma),
      static_cast<const T*>(wout), static_cast<const float*>(bias),
      static_cast<T*>(out), n, dim, heads, dh, windows_per_sample, has_film,
      seed, keep_threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_strips(const void* x, const void* gamma, const void* beta,
                  const void* wqkv, const void* q_gamma, const void* k_gamma,
                  const void* wout, const void* bias, void* out, int bw,
                  int n, int dim, int heads, int dh, int windows_per_sample,
                  int has_film, unsigned seed, unsigned keep_threshold,
                  float keep_scale, cudaStream_t stream) {
  const size_t smem = make_strip_plan(dim, dh, dim).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_fwd_strips,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  window_attention_fwd_strips<<<bw, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(q_gamma), static_cast<const float*>(k_gamma),
      static_cast<const bf16*>(wout), static_cast<const float*>(bias),
      static_cast<bf16*>(out), n, dim, heads, dh, windows_per_sample,
      has_film, seed, keep_threshold, keep_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The design a launch takes: the strip path (1) for bf16 at dim and dh
// multiples of 16, dim <= kMaxStripDim and dh <= kMaxStripDimHead, else
// the first design (0).
static bool strip_route(int is_bf16, int dim, int dh) {
  return is_bf16 && dim % 16 == 0 && dh % 16 == 0 && dim <= kMaxStripDim &&
         dh <= kMaxStripDimHead;
}

extern "C" int vgm_window_attention_fwd_route(int is_bf16, int dim, int dh) {
  return strip_route(is_bf16, dim, dh) ? 1 : 0;
}

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
  if (strip_route(is_bf16, dim, dh))
    return launch_strips(x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias,
                         out, bw, n, dim, heads, dh, windows_per_sample,
                         has_film, sd, thr, keep_scale, st);
  if (is_bf16)
    return launch<bf16>(x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias,
                        out, bw, n, dim, heads, dh, windows_per_sample,
                        has_film, sd, thr, keep_scale, st);
  return launch<float>(x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias,
                       out, bw, n, dim, heads, dh, windows_per_sample,
                       has_film, sd, thr, keep_scale, st);
}
