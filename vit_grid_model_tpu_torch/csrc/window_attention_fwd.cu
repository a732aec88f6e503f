// Fused MaxViT window-attention forward for Hopper (sm_90a).
//
// Replaces vit_grid_model_tpu/ops/pallas/attention.py::_attention_kernel
// (the no-dropout branch, per-head layout).  For every window of n <= 64
// tokens it computes, in one CTA and without writing any intermediate to
// device memory:
//
//   xn   = LayerNorm(x) (eps 1e-5, no affine) * gamma + beta    (FiLM, or
//          the LN affine for unconditioned layers, or nothing)
//   per head h:
//     q, k, v = xn . Wqkv_h
//     q <- q * rsqrt(max(sum q^2, 1e-24)) * sqrt(dh) * gq_h   (same for k)
//     S  = q k^T + bias_h, -1e30 on key columns >= n
//     P  = softmax(S) with this head's own row max
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
#include <mma.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid for the 64-row tiles
constexpr int kRows = 64;      // token rows per window tile (n <= 64)
constexpr int kChunkK = 32;    // rows of a staged weight tile
constexpr int kChunkN = 64;    // columns of one GEMM pass
constexpr int kMaxDim = 256;   // model width
constexpr int kMaxDimHead = 64;

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

// C[64 x N] (+)= A[64 x K] * B[K x N] on the tensor cores (bf16 operands,
// f32 sums), K and N multiples of 16.  A: shared, row stride lda; B:
// global, row-major with stride ldb; C: shared f32, row stride ldc.  Warp w
// takes the 16x16 output tiles w, w+8, ...; consecutive warps share B's
// column tile.
__device__ void wmma_rows64(const __nv_bfloat16* A, int lda,
                            const __nv_bfloat16* __restrict__ B, int ldb,
                            float* C, int ldc, int K, int N,
                            bool accumulate) {
  namespace wmma = nvcuda::wmma;
  const int warp = threadIdx.x >> 5;
  const int tiles = (kRows / 16) * (N / 16);
  for (int t = warp; t < tiles; t += kThreads / 32) {
    const int r0 = (t % (kRows / 16)) * 16;
    const int c0 = (t / (kRows / 16)) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, C + r0 * ldc + c0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, A + r0 * lda + k, lda);
      wmma::load_matrix_sync(b, B + static_cast<size_t>(k) * ldb + c0, ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + r0 * ldc + c0, acc, ldc, wmma::mem_row_major);
  }
  __syncthreads();
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
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
        int windows_per_sample, int has_film) {
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
      wmma_rows64(xs_h, ldx, wq, 3 * dh, qkv, ldq, dim, 3 * dh, false);
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

    // softmax per row with this head's own row max
    for (int r = warp; r < kRows; r += nwarps) {
      float* sr = s + r * kRows;
      const float v0 = sr[lane];
      const float v1 = sr[lane + 32];
      const float m = warp_max(fmaxf(v0, v1));
      const float e0 = expf(v0 - m);
      const float e1 = expf(v1 - m);
      const float den = warp_sum(e0 + e1);
      sr[lane] = e0 / den;
      sr[lane + 32] = e1 / den;
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
      wmma_rows64(o_h, plan.ldo, wo, dim, y, dim, dh, dim, true);
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
      static_cast<T*>(out), n, dim, heads, dh, windows_per_sample, has_film);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: (bw, n, dim) in f32 or bf16 (is_bf16); gamma, beta: f32
// (bw / windows_per_sample, dim), read only when has_film; wqkv: (heads,
// dim, 3*dh) and wout: (heads, dh, dim) in x's type; q_gamma, k_gamma:
// f32 (heads, dh); bias: f32 (heads, n, n).  All contiguous.  Launches on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vgm_window_attention_fwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* q_gamma, const void* k_gamma, const void* wout,
    const void* bias, void* out, int bw, int n, int dim, int heads, int dh,
    int windows_per_sample, int has_film, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || n > kRows || dim < 1 || dim > kMaxDim || dh < 1 ||
      dh > kMaxDimHead)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16 && dim % 16 == 0 && dh % 16 == 0)
    return launch<__nv_bfloat16, true>(x, gamma, beta, wqkv, q_gamma, k_gamma,
                                       wout, bias, out, bw, n, dim, heads, dh,
                                       windows_per_sample, has_film, st);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, gamma, beta, wqkv, q_gamma,
                                        k_gamma, wout, bias, out, bw, n, dim,
                                        heads, dh, windows_per_sample,
                                        has_film, st);
  return launch<float, false>(x, gamma, beta, wqkv, q_gamma, k_gamma, wout,
                              bias, out, bw, n, dim, heads, dh,
                              windows_per_sample, has_film, st);
}
