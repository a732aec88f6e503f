// Per-head window attention for Hopper (sm_90a): R1 and R14.
//
// Replaces benchmarks/mosaic_repros/repro_baseline_perhead.py::kernel, its
// pallas_call (:60) at 8 windows a program (R1) and the same call at 16
// windows a program (repro_16window_tile.py, R14).  For each window w of
// n <= 64 tokens and each head h, in f32:
//
//   q | k | v = x_w . Wqkv_h                  (Wqkv_h: dim x 3dh)
//   q <- q * rsqrt(max(sum q^2, 1e-24))       (same for k; no gain, no scale)
//   S = q k^T + bias_h                        (no mask: all n tokens are real)
//   out[w, :, h*dh:(h+1)*dh] = softmax(S) . v (stored as T)
//
// What bounds it on an H100.  At the repro's shape (n = 56, dim 128, 32
// heads x 32) one window costs 56.89 MFLOP (qkv 44.04, scores 6.42, P.v
// 6.42) and moves 14 KB in and 115 KB out, so it is bound by arithmetic:
// 163.8 GFLOP = 0.166 ms at Bw = 2,880 against 0.111 ms for the bytes.
//
// What this design does about it.  The TPU kernel holds a tile of windows'
// x and all of Wqkv in VMEM and runs one qkv product for the tile.  Here a
// CTA of 256 threads owns `windows_per_cta` consecutive windows (8 for R1,
// 16 for R14) and loops heads outside windows: each head's 128 x 96 weight
// slice is staged in shared memory once and serves every window of the
// CTA, which is what more windows a CTA buys.  Sixteen windows' x alone
// (229,376 B in bf16) would fill the 232,448 B a block may have, so x is
// streamed: each (head, window) step copies that window's x from L2 with
// cp.async into one of two buffers while the other is in use.  Shared
// memory per CTA, at the repro's widths in bf16: two x buffers 2 x 17,408 B
// (64 rows x 136), the weight slice 26,624 B (128 x 104), q|k|v in f32
// 25,600 B (64 x 100), the scores 16,384 B: 103,424 B whatever the windows
// a CTA, so two CTAs share an SM.  In bf16 the qkv product runs on the
// tensor cores (wmma 16x16x16, f32 sums); the norms, scores, softmax and
// P.v run in f32 on CUDA cores, as on the TPU.  f32 inputs run every
// product on CUDA-core FMAs (TF32 would not meet the f32 tolerance).  This
// is the simple first version: wgmma, TMA and a tensor-core score path are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kMaxDimHead = 64;

struct PerheadPlan {
  int ldx, ldw, ldq;
  size_t xs0, xs1, ws, qkv, s, bytes;
};

// Rows padded by 16 bytes keep every row 16-byte aligned for cp.async and
// wmma; q|k|v's stride is a multiple of 4 floats, as wmma's f32 store needs.
template <typename T>
__host__ __device__ PerheadPlan make_perhead_plan(int dim, int dh) {
  constexpr int pad = 16 / sizeof(T);
  PerheadPlan p{};
  p.ldx = dim + pad;
  p.ldw = 3 * dh + pad;
  p.ldq = 3 * dh + 4;
  size_t off = 0;
  p.xs0 = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.xs1 = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.ws = off;
  off = align128(off + static_cast<size_t>(dim) * p.ldw * sizeof(T));
  p.qkv = off;
  off = align128(off + kRows * p.ldq * sizeof(float));
  p.s = off;
  off = align128(off + kRows * kRows * sizeof(float));
  p.bytes = off;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying rows x cols of T from global (row stride lds) into shared
// memory (row stride ldd), 16 bytes a thread at a time; one commit group.
template <typename T>
__device__ void copy_rows_async(T* dst, int ldd, const T* src, int lds,
                                int rows, int cols) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = cols / kPer;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int k = (e % chunks) * kPer;
    cp_async16(dst + r * ldd + k, src + static_cast<size_t>(r) * lds + k);
  }
  cp_async_commit();
}

// C[r][c] = sum_k A[r][k] * B[k][c] for r < 64, c < N, k < K, all f32 in
// shared memory.  Thread (ty, tx) of the 16 x 16 grid owns rows
// 4ty..4ty+3 and columns tx + 16j of each 64-column pass.
__device__ void gemm_smem_f32(const float* A, int lda, const float* B,
                              int ldb, float* C, int ldc, int K, int N) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int c0 = 0; c0 < N; c0 += 64) {
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        b[j] = c < N ? B[k * ldb + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
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

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 2)
    perhead_attention_kernel(const T* __restrict__ x,
                             const T* __restrict__ wqkv,
                             const float* __restrict__ bias,
                             T* __restrict__ out, int bw, int n, int dim,
                             int heads, int dh, int windows_per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PerheadPlan plan = make_perhead_plan<T>(dim, dh);
  const int ldx = plan.ldx;
  const int ldw = plan.ldw;
  const int ldq = plan.ldq;
  T* xs[2] = {reinterpret_cast<T*>(smem + plan.xs0),
              reinterpret_cast<T*>(smem + plan.xs1)};
  T* ws = reinterpret_cast<T*>(smem + plan.ws);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);
  float* s = reinterpret_cast<float*>(smem + plan.s);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int inner = heads * dh;

  // rows n..63 of both x buffers stay zero: the copies write rows < n only
  for (int e = tid; e < (kRows - n) * ldx; e += kThreads) {
    xs[0][n * ldx + e] = from_f32<T>(0.f);
    xs[1][n * ldx + e] = from_f32<T>(0.f);
  }

  // step it = (head it / nw, window it % nw); x of step it goes to buffer
  // it & 1, and the next step's copy is in flight during this one
  const int steps = heads * nw;
  copy_rows_async(xs[0], ldx, x + static_cast<size_t>(w0) * n * dim, dim, n,
                  dim);
  for (int it = 0; it < steps; ++it) {
    const int h = it / nw;
    const int w = w0 + it % nw;
    const T* xw = xs[it & 1];
    if (it % nw == 0)  // this head's weight slice, for every window here
      copy_rows_async(ws, ldw, wqkv + static_cast<size_t>(h) * dim * 3 * dh,
                      3 * dh, dim, 3 * dh);
    if (it + 1 < steps) {
      copy_rows_async(xs[(it + 1) & 1], ldx,
                      x + static_cast<size_t>(w0 + (it + 1) % nw) * n * dim,
                      dim, n, dim);
      cp_async_wait<1>();  // all but the copy just started
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x and the weights are in; the last step is done

    // q | k | v = x_w . Wqkv_h
    if constexpr (kTC)
      wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
          kRows, 3 * dh, dim, xw, ldx, ws, ldw, qkv, ldq, false);
    else
      gemm_smem_f32(xw, ldx, ws, ldw, qkv, ldq, dim, 3 * dh);

    // l2 norm of q and k: one warp per (row, q-or-k) vector
    for (int t = warp; t < 2 * n; t += nwarps) {
      float* vec = qkv + (t >> 1) * ldq + (t & 1) * dh;
      float ss = 0.f;
      for (int d = lane; d < dh; d += 32) ss += vec[d] * vec[d];
      const float scale = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
      for (int d = lane; d < dh; d += 32) vec[d] *= scale;
    }
    __syncthreads();

    // S = q k^T + bias_h; columns >= n (the 64-row padding) get -1e30
    const float* bh = bias + static_cast<size_t>(h) * n * n;
    {
      float acc[4][4] = {};
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
          s[r * kRows + c] =
              c >= n ? -1e30f : acc[i][j] + (r < n ? bh[r * n + c] : 0.f);
        }
    }
    __syncthreads();

    // softmax of the real rows, one warp per row
    for (int r = warp; r < n; r += nwarps) {
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

    // out[w, r, h*dh + d] = sum_j P[r][j] v[j][d]
    T* ow = out + static_cast<size_t>(w) * n * inner + h * dh;
    for (int d0 = 0; d0 < dh; d0 += 16) {
      const int d = d0 + tx;
      if (d >= dh) continue;
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int j = 0; j < n; ++j) {
        const float vj = qkv[j * ldq + 2 * dh + d];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i] = fmaf(s[(4 * ty + i) * kRows + j], vj, acc[i]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = 4 * ty + i;
        if (r < n)
          ow[static_cast<size_t>(r) * inner + d] = from_f32<T>(acc[i]);
      }
    }
  }
}

template <typename T, bool kTC>
int launch(const void* x, const void* wqkv, const void* bias, void* out,
           int bw, int n, int dim, int heads, int dh, int windows_per_cta,
           cudaStream_t stream) {
  const size_t smem = make_perhead_plan<T>(dim, dh).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      perhead_attention_kernel<T, kTC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  perhead_attention_kernel<T, kTC><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const float*>(bias), static_cast<T*>(out), bw, n, dim,
      heads, dh, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of the kernel takes at these widths.
extern "C" long vgm_perhead_attention_smem_bytes(int dim, int dh,
                                                 int is_bf16) {
  return static_cast<long>(
      is_bf16 ? make_perhead_plan<__nv_bfloat16>(dim, dh).bytes
              : make_perhead_plan<float>(dim, dh).bytes);
}

// x: (bw, n, dim) and out: (bw, n, heads*dh), f32 or bf16 (is_bf16);
// wqkv: (heads, dim, 3*dh) in x's type, each head's q | k | v columns;
// bias: f32 (heads, n, n).  All contiguous.  dim and dh are multiples of 16
// (dh <= 64), n <= 64.  Launches ceil(bw / windows_per_cta) CTAs on
// `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vgm_perhead_attention(const void* x, const void* wqkv,
                                     const void* bias, void* out, int bw,
                                     int n, int dim, int heads, int dh,
                                     int windows_per_cta, int is_bf16,
                                     void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, wqkv, bias, out, bw, n, dim, heads,
                                       dh, windows_per_cta, st);
  return launch<float, false>(x, wqkv, bias, out, bw, n, dim, heads, dh,
                              windows_per_cta, st);
}
