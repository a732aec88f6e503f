// Device helpers shared by the window-attention forward
// (window_attention_fwd.cu) and backward (window_attention_bwd.cu) kernels:
// conversions between f32 and the activation type T (f32 or bf16), warp
// reductions, and the wmma tile product their bf16 paths run the
// projections on.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid for the 64-row tiles
constexpr int kRows = 64;      // token rows per window tile (n <= 64)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to T's precision, keeping it in f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
}

// Offset of element (r, c) of a matrix with leading dimension ld stored in
// wmma layout L.
template <typename L>
__device__ __forceinline__ size_t wmma_offset(int r, int c, int ld) {
  return std::is_same<L, nvcuda::wmma::row_major>::value
             ? static_cast<size_t>(r) * ld + c
             : r + static_cast<size_t>(c) * ld;
}

// C[M x N] (+)= A[M x K] . B[K x N] on the tensor cores: bf16 operands in
// layouts LA and LB (shared or device memory), f32 sums, C f32 row-major
// in shared or device memory (this CTA its only writer).  M, N, K are
// multiples of 16, and every 16 x 16 tile starts 32-byte aligned.  Warp w
// owns the output tiles w, w + 8, ...
template <typename LA, typename LB>
__device__ void wmma_mm(int M, int N, int K, const __nv_bfloat16* A,
                        int lda, const __nv_bfloat16* B, int ldb, float* C,
                        int ldc, bool accumulate) {
  namespace wmma = nvcuda::wmma;
  const int mt = M / 16;
  const int tiles = mt * (N / 16);
  for (int t = threadIdx.x >> 5; t < tiles; t += kThreads / 32) {
    const int r0 = (t % mt) * 16;
    const int c0 = (t / mt) * 16;
    float* cp = C + static_cast<size_t>(r0) * ldc + c0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, A + wmma_offset<LA>(r0, k, lda), lda);
      wmma::load_matrix_sync(b, B + wmma_offset<LB>(k, c0, ldb), ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
  __syncthreads();
}

}  // namespace
