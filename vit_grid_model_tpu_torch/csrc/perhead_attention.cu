// Per-head window attention for Hopper (sm_90a): R9's structure, which
// also runs R1 and R14.
//
// Replaces benchmarks/mosaic_repros/repro_baseline_perhead.py::kernel, its
// pallas_call (:60) at 8 windows a program (R1), the same call at 16
// windows a program (repro_16window_tile.py, R14), and
// repro_perhead_weight_gemm.py::kernel (:27-55, pallas_call :68, R9).  For
// each window w of n <= 64 tokens and each head h, in f32:
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
// What this design does about it.  R1's TPU kernel holds a tile of
// windows' x and all of Wqkv in VMEM and runs one (R, dim) . (dim, 3hd)
// qkv product for the tile, then slices its output by head.  That product
// does not fit here even for one window: 56 x 3,072 is 688 KB in f32 and
// 344 KB in bf16, against 227 KB of shared memory a block.  So this kernel
// is R9's structure (repro_perhead_weight_gemm.py:27-41, the weight
// pre-sliced by head at :67): one small (R, dim) . (dim, 3dh) product per
// head on that head's weight slice, laid out (heads, dim, 3dh) by the
// wrapper.  R1, R14 and R9 all run it.  A CTA of 256 threads owns
// `windows_per_cta` consecutive windows (8 for R1 and R9, 16 for R14) and
// loops heads outside windows: each head's 128 x 96 weight slice is staged
// in shared memory once and serves every window of the CTA, which is what
// more windows a CTA buys.  Sixteen windows' x alone (229,376 B in bf16)
// would fill the 232,448 B a block may have, so x is
// streamed: each (head, window) step copies that window's x from L2 with
// cp.async into one of two buffers while the other is in use.  Shared
// memory per CTA, at the repro's widths in bf16: two x buffers 2 x 17,408 B
// (64 rows x 136), the weight slice 26,624 B (128 x 104), q|k|v in f32
// 25,600 B (64 x 100), the scores 16,384 B: 103,424 B whatever the windows
// a CTA, so two CTAs share an SM.  In bf16 the qkv product runs on the
// tensor cores (wmma 16x16x16, f32 sums); the norms, scores, softmax and
// P.v run in f32 on CUDA cores, as on the TPU (attention_common.cuh's
// per-head steps, shared with R10's kernel).  f32 inputs run every
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

    // l2 norms; S = q k^T + bias_h; its softmax; out[w, r, h*dh + d] =
    // sum_j P[r][j] v[j][d]
    l2_normalize_qk(qkv, ldq, n, dh);
    scores_tile(qkv, ldq, dh, bias + static_cast<size_t>(h) * n * n, n, s);
    softmax_rows(s, 1, n);
    pv_tile<T>(s, qkv + 2 * dh, ldq, n, dh,
               out + static_cast<size_t>(w) * n * inner + h * dh, inner);
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
