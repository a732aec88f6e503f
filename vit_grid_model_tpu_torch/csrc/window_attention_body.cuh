// The per-window body of the fused window-attention forward's first design
// (f32, and bf16 off the strip path of window_attention_strips.cuh), shared
// by K1 (window_attention_fwd.cu, one window per CTA) and the MaxViT layer
// megakernel (maxvit_layer_attention.cu, R7, a cluster per sample-lead):
// the shared-memory plan of one 64-row window tile, the LayerNorm + FiLM
// of its rows, and the attention of every head into an f32 output sum.
//
// The math, in f32 (see window_attention_fwd.cu for the derivation):
//   xn   = LayerNorm(x) (eps 1e-5, no affine) * gamma + beta
//   per head h:
//     q, k, v = xn . Wqkv_h
//     q <- q * rsqrt(max(sum q^2, 1e-24)) * sqrt(dh) * gq_h   (same for k)
//     S  = q k^T + bias_h, -1e30 on key columns >= n
//     P  = softmax(S) with this head's own row max (times the dropout keep
//          value when keep_threshold != 0)
//     Y += (P . v) . Wout_h
// For bf16 inputs the normalized x and each head's P.v are rounded to bf16
// before their products; every sum is f32.

#pragma once

#include <cuda_bf16.h>

#include "attention_common.cuh"
#include "dropout_hash.cuh"

namespace {

constexpr int kChunkK = 32;    // rows of a staged weight tile
constexpr int kChunkN = 64;    // columns of one GEMM pass
constexpr int kMaxDim = 256;   // model width
constexpr int kMaxDimHead = 64;

// C[r][c] (+)= sum_k A[r][k] * B[k][c] for r < 64, c < N, k < K.
// A: shared f32 (row stride lda); B: global, row-major with stride ldb;
// C: shared f32 (row stride ldc).  Thread (ty, tx) of the 16 x 16 grid owns
// rows 4ty..4ty+3 and columns tx + 16j of each 64-column pass.
template <typename W>
__device__ void gemm_rows64(const float* A, int lda, const W* __restrict__ B,
                            int ldb, float* C, int ldc, int K, int N,
                            bool accumulate, float* stage) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int c0 = 0; c0 < N; c0 += kChunkN) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        acc[i][j] = (accumulate && c < N) ? C[(4 * ty + i) * ldc + c] : 0.f;
      }
    for (int k0 = 0; k0 < K; k0 += kChunkK) {
      __syncthreads();  // the previous tile is consumed
      for (int e = tid; e < kChunkK * kChunkN; e += kThreads) {
        const int kk = e / kChunkN;
        const int cc = e % kChunkN;
        const int k = k0 + kk;
        const int c = c0 + cc;
        stage[e] = (k < K && c < N) ? to_f32(B[k * ldb + c]) : 0.f;
      }
      __syncthreads();
      const int kmax = min(kChunkK, K - k0);
      for (int kk = 0; kk < kmax; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * lda + k0 + kk];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = stage[kk * kChunkN + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < N) C[(4 * ty + i) * ldc + c] = acc[i][j];
      }
  }
  __syncthreads();
}

// Shared-memory plan of one window tile: element strides and byte offsets.
// kTC keeps the normalized x and each head's P.v in bf16 for the tensor
// cores (strides padded to the 16-byte multiples wmma needs); otherwise
// they are f32, with odd strides that keep row-strided reads free of bank
// conflicts, and a staging tile for the weights.
struct Plan {
  int ldx, ldq, ldo;
  size_t xs, qkv, s, y, aux, bytes;
};

template <bool kTC>
__host__ __device__ Plan make_plan(int dim, int dh) {
  Plan p{};
  p.ldx = kTC ? dim + 8 : dim + 1;
  p.ldq = kTC ? 3 * dh + 4 : 3 * dh + 1;
  p.ldo = kTC ? dh + 8 : 0;
  const size_t xbytes = kTC ? 2 : 4;
  size_t off = 0;
  p.xs = off;
  off = align128(off + kRows * p.ldx * xbytes);
  p.qkv = off;
  off = align128(off + kRows * p.ldq * sizeof(float));
  p.s = off;
  off = align128(off + kRows * kRows * sizeof(float));
  p.y = off;
  off = align128(off + static_cast<size_t>(kRows) * dim * sizeof(float));
  p.aux = off;
  off = align128(off + (kTC ? kRows * p.ldo * 2
                            : kChunkK * kChunkN * sizeof(float)));
  p.bytes = off;
  return p;
}

// LayerNorm + FiLM of the tile's rows into the plan's normalized x, one
// warp per token row with the row in registers; load(r, c) gives the f32
// input of row r < n.  Rows n..63 are written as zeros.  g, bt: this
// window's FiLM (or LN affine) rows, read when has_film.  The caller
// synchronises before the tile is read.
template <typename T, bool kTC, typename Load>
__device__ void layer_norm_rows(unsigned char* smem, const Plan& plan,
                                Load load, int n, int dim, const float* g,
                                const float* bt, int has_film) {
  __nv_bfloat16* xs_h = reinterpret_cast<__nv_bfloat16*>(smem + plan.xs);
  float* xs = reinterpret_cast<float*>(smem + plan.xs);
  const int lane = threadIdx.x & 31;
  const int nwarps = kThreads / 32;
  for (int r = threadIdx.x >> 5; r < kRows; r += nwarps) {
    float v[kMaxDim / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDim / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = (r < n && c < dim) ? load(r, c) : 0.f;
      sum += v[i];
    }
    const float mean = warp_sum(sum) / dim;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDim / 32; ++i) {
      const float d = (lane + 32 * i < dim) ? v[i] - mean : 0.f;
      sq += d * d;
    }
    const float inv = rsqrtf(warp_sum(sq) / dim + 1e-5f);
#pragma unroll
    for (int i = 0; i < kMaxDim / 32; ++i) {
      const int c = lane + 32 * i;
      if (c >= dim) continue;
      float val = 0.f;  // padded token rows stay zero
      if (r < n) {
        val = (v[i] - mean) * inv;
        if (has_film) val = val * g[c] + bt[c];
      }
      if constexpr (kTC)
        xs_h[r * plan.ldx + c] = __float2bfloat16(val);
      else
        xs[r * plan.ldx + c] = round_to<T>(val);
    }
  }
}

// Every head's attention of the normalized tile into the plan's f32 output
// sum y (64 x dim, row-major; rows >= n are not meaningful).  The caller
// has synchronised after layer_norm_rows; y is complete, and every thread
// past its last barrier, on return.  `win` indexes the dropout hash.
template <typename T, bool kTC>
__device__ void attend_window(unsigned char* smem, const Plan& plan,
                              const T* __restrict__ wqkv,
                              const float* __restrict__ q_gamma,
                              const float* __restrict__ k_gamma,
                              const T* __restrict__ wout,
                              const float* __restrict__ bias, int n, int dim,
                              int heads, int dh, int win, unsigned seed,
                              unsigned keep_threshold, float keep_scale) {
  const int ldx = plan.ldx;
  const int ldq = plan.ldq;
  // normalized x: bf16 for the tensor cores, else f32 rounded to T
  __nv_bfloat16* xs_h = reinterpret_cast<__nv_bfloat16*>(smem + plan.xs);
  float* xs = reinterpret_cast<float*>(smem + plan.xs);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);  // q | k | v
  float* s = reinterpret_cast<float*>(smem + plan.s);      // scores, then P
  float* y = reinterpret_cast<float*>(smem + plan.y);      // f32 output sum
  // P.v in bf16 for the tensor cores; else the weight staging tile (P.v
  // then goes over q, which is no longer read)
  __nv_bfloat16* o_h = reinterpret_cast<__nv_bfloat16*>(smem + plan.aux);
  float* stage = reinterpret_cast<float*>(smem + plan.aux);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  for (int e = tid; e < kRows * dim; e += kThreads) y[e] = 0.f;
  __syncthreads();

  const float sqrt_dh = sqrtf(static_cast<float>(dh));
  for (int h = 0; h < heads; ++h) {
    // q | k | v = xn . Wqkv_h      (Wqkv_h: dim x 3dh, row-major)
    const T* wq = wqkv + static_cast<size_t>(h) * dim * 3 * dh;
    if constexpr (kTC)
      wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
          kRows, 3 * dh, dim, xs_h, ldx, wq, 3 * dh, qkv, ldq, false);
    else
      gemm_rows64(xs, ldx, wq, 3 * dh, qkv, ldq, dim, 3 * dh, false, stage);

    // QK-RMSNorm: one warp per (row, q-or-k) vector
    for (int t = warp; t < 2 * kRows; t += nwarps) {
      const int r = t >> 1;
      const int part = t & 1;
      float* vec = qkv + r * ldq + part * dh;
      const float* gm = (part ? k_gamma : q_gamma) + h * dh;
      float ss = 0.f;
      for (int d = lane; d < dh; d += 32) ss += vec[d] * vec[d];
      const float scale = rsqrtf(fmaxf(warp_sum(ss), 1e-24f)) * sqrt_dh;
      for (int d = lane; d < dh; d += 32) vec[d] = vec[d] * scale * gm[d];
    }
    __syncthreads();

    // S = q k^T + bias_h; padded key columns get -1e30
    const float* bh = bias + static_cast<size_t>(h) * n * n;
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int d = 0; d < dh; ++d) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = qkv[(4 * ty + i) * ldq + d];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = qkv[(tx + 16 * j) * ldq + dh + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = 4 * ty + i;
          const int c = tx + 16 * j;
          float v;
          if (c >= n)
            v = -1e30f;
          else
            v = acc[i][j] + (r < n ? bh[r * n + c] : 0.f);
          s[r * kRows + c] = v;
        }
    }
    __syncthreads();

    // softmax per row with this head's own row max, then the dropout
    // keep value on the real (row, col) scores
    const int n_pad = vgm_hash_n_pad(n);
    for (int r = warp; r < kRows; r += nwarps) {
      float* sr = s + r * kRows;
      const float v0 = sr[lane];
      const float v1 = sr[lane + 32];
      const float m = warp_max(fmaxf(v0, v1));
      const float e0 = expf(v0 - m);
      const float e1 = expf(v1 - m);
      const float den = warp_sum(e0 + e1);
      float p0 = e0 / den;
      float p1 = e1 / den;
      if (keep_threshold != 0 && r < n) {
        if (lane < n)
          p0 *= vgm_keep(seed, win, h, r, lane, heads, n_pad, keep_threshold,
                         keep_scale);
        if (lane + 32 < n)
          p1 *= vgm_keep(seed, win, h, r, lane + 32, heads, n_pad,
                         keep_threshold, keep_scale);
      }
      sr[lane] = p0;
      sr[lane + 32] = p1;
    }
    __syncthreads();

    // o = P . v, rounded to T
    for (int d0 = 0; d0 < dh; d0 += 16) {
      const int d = d0 + tx;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      if (d < dh) {
        for (int j = 0; j < kRows; ++j) {
          const float vj = qkv[j * ldq + 2 * dh + d];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            acc[i] = fmaf(s[(4 * ty + i) * kRows + j], vj, acc[i]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kTC)
            o_h[(4 * ty + i) * plan.ldo + d] = __float2bfloat16(acc[i]);
          else
            qkv[(4 * ty + i) * ldq + d] = round_to<T>(acc[i]);
        }
      }
    }
    __syncthreads();

    // y += o . Wout_h      (Wout_h: dh x dim, row-major)
    const T* wo = wout + static_cast<size_t>(h) * dh * dim;
    if constexpr (kTC)
      wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
          kRows, dim, dh, o_h, plan.ldo, wo, dim, y, dim, true);
    else
      gemm_rows64(qkv, ldq, wo, dim, y, dim, dh, dim, true, stage);
  }
}

}  // namespace
