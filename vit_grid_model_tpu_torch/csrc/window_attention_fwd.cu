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
// per CTA, to share weight loads, are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

// Shared-memory plan of one CTA: element strides and byte offsets.
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

  const int win = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  // ---- LayerNorm + FiLM, one warp per token row, the row in registers ----
  const T* xw = x + static_cast<size_t>(win) * n * dim;
  const float* g = gamma + static_cast<size_t>(win / windows_per_sample) * dim;
  const float* bt = beta + static_cast<size_t>(win / windows_per_sample) * dim;
  for (int r = warp; r < kRows; r += nwarps) {
    float v[kMaxDim / 32];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kMaxDim / 32; ++i) {
      const int c = lane + 32 * i;
      v[i] = (r < n && c < dim) ? to_f32(xw[r * dim + c]) : 0.f;
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
        xs_h[r * ldx + c] = __float2bfloat16(val);
      else
        xs[r * ldx + c] = round_to<T>(val);
    }
  }
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

  T* ow = out + static_cast<size_t>(win) * n * dim;
  for (int e = tid; e < n * dim; e += kThreads) ow[e] = from_f32<T>(y[e]);
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
