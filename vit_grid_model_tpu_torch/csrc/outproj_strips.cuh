// The out-projection family's strip kernel and its launcher, shared by
// outproj_attention.cu (R12, R13, R2, R8) and headpack_attention.cu (R5,
// R6), which compute one function: R1's attention with the out-
// projection.  Each window runs K1's strip body (window_attention_strips.cuh)
// with x's bf16 rows copied by cp.async, no q/k gain and out_dim as y's
// width; a cast product (R2) takes the high parts alone.  See
// outproj_attention.cu for the design and its numbers.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attention_strips.cuh"

namespace {

bool strip_route(int dim, int dh, int out_dim, int is_bf16) {
  return is_bf16 && dim % 16 == 0 && dh % 16 == 0 && out_dim % 16 == 0 &&
         dim <= kMaxStripDim && dh <= kMaxStripDimHead &&
         out_dim <= kMaxStripDim;
}

template <bool kSplitScore, bool kSplitAgg>
__global__ void __launch_bounds__(kThreads, 2)
    outproj_attention_strips(const bf16* __restrict__ x,
                             const bf16* __restrict__ wqkv,
                             const float* __restrict__ bias,
                             const bf16* __restrict__ wout,
                             void* __restrict__ out, int bw, int n, int dim,
                             int heads, int dh, int out_dim,
                             int windows_per_cta, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StripPlan plan = make_strip_plan(dim, dh, out_dim);
  // rows n..63 of the tile stay zero: the copies write rows < n only
  bf16* xs = reinterpret_cast<bf16*>(smem + plan.xs);
  for (int e = threadIdx.x; e < (kRows - n) * plan.ldx; e += kThreads)
    xs[n * plan.ldx + e] = __float2bfloat16(0.f);
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last CTA is ragged
  for (int wi = 0; wi < nw; ++wi) {
    const auto store = [&](int r, int c, float v0, float v1) {
      const size_t e =
          (static_cast<size_t>(w0 + wi) * n + r) * out_dim + c;
      if (out_bf16)
        *reinterpret_cast<uint32_t*>(static_cast<bf16*>(out) + e) =
            pack_bf16(v0, v1);
      else
        *reinterpret_cast<float2*>(static_cast<float*>(out) + e) =
            make_float2(v0, v1);
    };
    attend_window_strips<false, kSplitScore, kSplitAgg>(
        smem, plan, CopyRows{x + static_cast<size_t>(w0 + wi) * n * dim}, n,
        dim, wqkv, nullptr, nullptr, wout, bias, heads, dh, out_dim, 0, 0u,
        0u, 1.f,
        store);
  }
}

// The strip kernel of these casts (a cast product takes no low parts).
using StripKernel = decltype(&outproj_attention_strips<true, true>);

StripKernel strip_kernel(int bf16_score, int bf16_agg) {
  if (bf16_score)
    return bf16_agg ? &outproj_attention_strips<false, false>
                    : &outproj_attention_strips<false, true>;
  return bf16_agg ? &outproj_attention_strips<true, false>
                  : &outproj_attention_strips<true, true>;
}

int launch_strips(StripKernel kernel, const void* x, const void* wqkv,
                  const void* bias, const void* wout, void* out, int bw,
                  int n, int dim, int heads, int dh, int out_dim,
                  int windows_per_cta, int out_bf16, cudaStream_t stream) {
  const size_t smem = make_strip_plan(dim, dh, out_dim).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  kernel<<<ctas, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bias), static_cast<const bf16*>(wout), out,
      bw, n, dim, heads, dh, out_dim, windows_per_cta, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
