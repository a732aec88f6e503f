// Per-head window attention for Hopper (sm_90a): R1, R14 and R9.
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
// 163.8 GFLOP = 0.166 ms at Bw = 2,880 and 0.518 ms at Bw = 9,000, against
// 0.111 / 0.35 ms for the bytes.
//
// The wgmma design (bf16 at dh 16 or 32, dim a multiple of 16 up to 176 at
// dh 32 and 288 at dh 16, n <= 64; vgm_perhead_attention_route says 1; its
// body, shared with R4's and R3's kernels, is perhead_wgmma_body.cuh at one
// head a staged x with the shuffle norm).  Every product runs on warpgroup MMA (wgmma_common.cuh): a window's rows,
// padded to 64 (rows n..63 of x zero, so a padded q or k normalises to 0),
// are one warpgroup's M.  q | k | v is m64n(3dh)k16 with x and Wqkv_h^T
// from shared memory, dim / 16 steps; its epilogue takes the l2 norms (a
// row's columns lie in one quad of lanes: quad shuffles), keeps qn in
// registers as the A fragments of S, split into bf16 hi/lo, and writes kn
// and v^T, split, as core-matrix planes.  S = qn kn^T (m64n64k16) and
// O = P v (m64n(dh)k16) keep R1's f32 operands as hi.hi + hi.lo + lo.hi
// with f32 sums; the softmax adds bias_h to rows < n, sets keys j >= n to
// -inf before each row's max, and P's A fragments are S's accumulator
// packed in place (the layout identity in wgmma_common.cuh, tabulated and
// checked in tests/test_torch_port_perhead_split.py).  The heads are the
// outer loop and a CTA's windows_per_cta windows (8 for R1 and R9, 16 for
// R14) the inner, as on the TPU: each head's Wqkv_h^T tiles (24,576 B) and
// bias rows (16,128 B at n 56) arrive by two bulk copies (TMA) on an
// mbarrier a head ahead, into one of two buffers that the last warpgroup
// done with a head refills, and serve every window of the CTA.  x is
// streamed: each warpgroup copies its next window's x by cp.async as soon
// as its qkv product has read the last one.  L2 bytes a window at the
// repro's widths: x 32 x 14,336 = 459 KB, the weights 32 x 24,576 / 8 =
// 98 KB, the bias 32 x 16,128 / 8 = 65 KB, ~620 KB against the strip
// body's ~1.19 MB (R10's kernel stages both per window and head).  Three
// consumer warpgroups a CTA (each its own windows, so one's softmax and
// epilogue overlap another's products), 179,840 B, one CTA an SM; no
// producer warp, since the copies are issued a step or a head ahead.
//
// The first design (f32 and every other width).  R1's TPU kernel holds a
// tile of windows' x and all of Wqkv in VMEM and runs one (R, dim) . (dim,
// 3hd) qkv product for the tile, then slices its output by head. That
// product does not fit here even for one window: 56 x 3,072 is 688 KB in f32
// and 344 KB in bf16, against 227 KB of shared memory a block.  So this
// kernel is R9's structure (repro_perhead_weight_gemm.py:27-41, the weight
// pre-sliced by head at :67): one small (R, dim) . (dim, 3dh) product per
// head on that head's weight slice, laid out (heads, dim, 3dh) by the
// wrapper.  R1, R14 and R9 all run it.  A CTA of 256 threads owns
// `windows_per_cta` consecutive windows (8 for R1 and R9, 16 for R14) and
// loops heads outside windows: each head's 128 x 96 weight slice is staged
// in shared memory once and serves every window of the CTA, which is what
// more windows a CTA buys.  Sixteen windows' x alone (229,376 B in bf16)
// would fill the 232,448 B a block may have, so x is streamed: each (head,
// window) step copies that window's x from L2 with cp.async into one of two
// buffers while the other is in use.  Shared memory per CTA, at the repro's
// widths in bf16: two x buffers 2 x 17,408 B (64 rows x 136), the weight
// slice 26,624 B (128 x 104), q|k|v in f32 25,600 B (64 x 100), the scores
// 16,384 B: 103,424 B whatever the windows a CTA, so two CTAs share an SM.
// In bf16 the qkv product runs on the tensor cores (wmma 16x16x16, f32
// sums); the norms, scores, softmax and P.v run in f32 on CUDA cores, as on
// the TPU (attention_common.cuh's per-head steps, shared with R10's kernel).
// f32 inputs run every product on CUDA-core FMAs (TF32 would not meet the
// f32 tolerance).  This is the simple first version; the wgmma design above
// replaces it in bf16 at its widths.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "perhead_wgmma_body.cuh"

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

// ---------------------------------------------------------------------------
// The wgmma design (bf16, dh 16 or 32, dim a multiple of 16 while the plan
// fits, n <= 64): the body of perhead_wgmma_body.cuh at one head a staged
// x (G = 1) with the shuffle norm.  Warpgroup wgi of a CTA runs the CTA's
// windows wgi, wgi + kWarpgroups, ... of each head in turn; the heads are
// the outer loop, so head h's weight tiles and bias rows serve every window
// of the CTA.  Shared memory: two buffers of (Wqkv_h^T tiles, bias_h rows),
// filled by bulk copies a head ahead and completed on an mbarrier each;
// per warpgroup one x buffer (64 rows in core matrices, rows n..63 zero)
// and the kn hi/lo and v^T hi/lo planes that S and P.v read.

constexpr int kWarpgroups = 3;  // consumer warpgroups a CTA
constexpr int kHeadBuffers = 2;

size_t wgmma_smem_bytes(int n, int dim, int dh) {
  return wgmma_plan_bytes<kHeadBuffers, kWarpgroups, false>(n, dim, dh);
}

// The wgmma design takes bf16 at dh 16 or 32, dim a multiple of 16 whose
// plan fits a CTA's shared memory (dim <= 176 at dh 32, <= 288 at dh 16),
// n <= 64.
bool wgmma_takes(int n, int dim, int dh, int is_bf16) {
  return is_bf16 && wgmma_widths(n, dim, dh) &&
         wgmma_smem_bytes(n, dim, dh) <= kMaxSmem;
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

// The design a launch at these widths takes: 1 the wgmma design
// (vgm_perhead_attention_wgmma), 0 the first (vgm_perhead_attention).
extern "C" int vgm_perhead_attention_route(int n, int dim, int dh,
                                           int is_bf16) {
  return wgmma_takes(n, dim, dh, is_bf16) ? 1 : 0;
}

// x: (bw, n, dim) bf16; w_tiles: (heads, 3dh / 8, dim / 8, 8, 8) bf16, each
// head's Wqkv_h^T (rows q | k | v, dh each) in 8 x 8 core matrices;
// bias_rows: (heads, n, 72) f32, bias_h's rows with their first n columns
// read; out: (bw, n, heads*dh) bf16.  All contiguous.  Takes the widths of
// vgm_perhead_attention_route's 1.  Launches ceil(bw / windows_per_cta)
// CTAs on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int vgm_perhead_attention_wgmma(const void* x, const void* w_tiles,
                                           const void* bias_rows, void* out,
                                           int bw, int n, int dim, int heads,
                                           int dh, int windows_per_cta,
                                           void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || heads < 1 || windows_per_cta < 1 ||
      !wgmma_takes(n, dim, dh, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return launch_wgmma_body_dh<1, false, kHeadBuffers, kWarpgroups>(
      x, w_tiles, bias_rows, out, bw, n, dim, heads, dh, windows_per_cta, st);
}

// The routed design's registers, local bytes a thread, shared memory a CTA
// and CTAs an SM into out[0..3]; returns the route (-1 on failure).
extern "C" int vgm_perhead_attention_occupancy(int n, int dim, int dh,
                                               int is_bf16, int* out) {
  int err;
  const int route = vgm_perhead_attention_route(n, dim, dh, is_bf16);
  if (route == 1)
    err = wgmma_body_occupancy<1, false, kHeadBuffers, kWarpgroups>(n, dim,
                                                                   dh, out);
  else if (is_bf16)
    err = occupancy_of(perhead_attention_kernel<__nv_bfloat16, true>,
                       make_perhead_plan<__nv_bfloat16>(dim, dh).bytes, out);
  else
    err = occupancy_of(perhead_attention_kernel<float, false>,
                       make_perhead_plan<float>(dim, dh).bytes, out);
  return err < 0 ? -1 : route;
}
