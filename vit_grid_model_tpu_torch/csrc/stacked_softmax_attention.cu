// Stacked-softmax window attention for Hopper (sm_90a): R10.
//
// Replaces benchmarks/mosaic_repros/repro_stacked_softmax.py::kernel
// (:22-59, pallas_call :64).  It computes R1's function: for each window w
// of n <= 64 tokens and each head h, in f32,
//
//   q | k | v = x_w . Wqkv_h                  (Wqkv_h: dim x 3dh)
//   q <- q * rsqrt(max(sum q^2, 1e-24))       (same for k)
//   S_h = q k^T + bias_h
//   out[w, :, h*dh:(h+1)*dh] = softmax(S_h) . v   (stored as T)
//
// The TPU kernel computes every head's scores + bias, runs ONE max/exp/sum
// softmax over the stacked (heads * blk, n, n) array, then P.v per head.
//
// What bounds it on an H100: the same arithmetic as R1, 56.89 MFLOP a
// window at the repro's shape, 0.166 ms at Bw = 2,880 on the bf16 peak.
//
// What this design does about it.  One window's stack of 32 heads' f32
// scores is 401 KB, and rounding the scores to bf16 would compute another
// function, so the stack holds a group of G heads (the wrapper picks the
// largest power of two that fits: G = 4 in bf16, 2 in f32).  A CTA of 256
// threads owns `windows_per_cta` windows and walks (window, head) steps,
// window outer.  Each head step, as R1's kernel: the head's weight slice
// (prefetched with cp.async into one of two buffers during the step
// before), q|k|v = x_w . Wqkv_h (wmma 16x16x16 bf16 with f32 sums, or
// CUDA-core f32), the l2 norms, then S_h + bias_h into slot g of a
// (G, 64, 64) f32 stack (keys >= n at -1e30) and v into slot g of a v
// stack.
// When a group is complete, ONE softmax pass runs over all G * n rows of
// the stack with all 256 threads (a warp a row), then P.v for the G heads
// with no barrier between them.  That is the contrast with R1's kernel,
// which runs a softmax pass of 56 rows, and its block barrier, per head.
// Shared memory at the repro's widths in bf16, G = 4: x 17,408 B, two
// weight slices 2 x 26,624 B, q|k|v 25,600 B, the score stack 65,536 B, the
// v stack 32,768 B: 194,560 B, one CTA an SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kMaxDimHead = 64;

struct StackedPlan {
  int ldx, ldw, ldq;
  size_t xs, ws0, ws1, qkv, stack, vs, bytes;
};

template <typename T>
__host__ __device__ StackedPlan make_stacked_plan(int dim, int dh,
                                                  int group) {
  constexpr int pad = 16 / sizeof(T);
  StackedPlan p{};
  p.ldx = dim + pad;
  p.ldw = 3 * dh + pad;
  p.ldq = 3 * dh + 4;
  size_t off = 0;
  p.xs = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.ws0 = off;
  off = align128(off + static_cast<size_t>(dim) * p.ldw * sizeof(T));
  p.ws1 = off;
  off = align128(off + static_cast<size_t>(dim) * p.ldw * sizeof(T));
  p.qkv = off;
  off = align128(off + kRows * p.ldq * sizeof(float));
  p.stack = off;
  off = align128(off + static_cast<size_t>(group) * kRows * kRows *
                           sizeof(float));
  p.vs = off;
  off = align128(off + static_cast<size_t>(group) * kRows * dh *
                           sizeof(float));
  p.bytes = off;
  return p;
}

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 1)
    stacked_softmax_kernel(const T* __restrict__ x,
                           const T* __restrict__ wqkv,
                           const float* __restrict__ bias,
                           T* __restrict__ out, int bw, int n, int dim,
                           int heads, int dh, int group,
                           int windows_per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StackedPlan plan = make_stacked_plan<T>(dim, dh, group);
  const int ldx = plan.ldx;
  const int ldw = plan.ldw;
  const int ldq = plan.ldq;
  T* xs = reinterpret_cast<T*>(smem + plan.xs);
  T* ws[2] = {reinterpret_cast<T*>(smem + plan.ws0),
              reinterpret_cast<T*>(smem + plan.ws1)};
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);
  float* stack = reinterpret_cast<float*>(smem + plan.stack);
  float* vs = reinterpret_cast<float*>(smem + plan.vs);

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int inner = heads * dh;
  const size_t wsize = static_cast<size_t>(dim) * 3 * dh;

  // rows n..63 of x stay zero: the copies write rows < n only
  for (int e = tid; e < (kRows - n) * ldx; e += kThreads)
    xs[n * ldx + e] = from_f32<T>(0.f);

  // step it = (window it / heads, head it % heads); the weight slice of
  // step it is in buffer it & 1, copied during step it - 1
  const int steps = nw * heads;
  copy_rows_async(xs, ldx, x + static_cast<size_t>(w0) * n * dim, dim, n,
                  dim);
  copy_rows_async(ws[0], ldw, wqkv, 3 * dh, dim, 3 * dh);
  for (int it = 0; it < steps; ++it) {
    const int h = it % heads;
    const int w = w0 + it / heads;
    const int hg0 = h - h % group;           // the group's first head
    const int g = h - hg0;                   // this head's slot
    const int gn = min(group, heads - hg0);  // the last group may be ragged
    if (h == 0 && it > 0)  // a new window: the last product of the one
      copy_rows_async(xs, ldx, x + static_cast<size_t>(w) * n * dim, dim, n,
                      dim);  // before finished at its barrier
    if (it + 1 < steps) {
      copy_rows_async(ws[(it + 1) & 1], ldw,
                      wqkv + ((it + 1) % heads) * wsize, 3 * dh, dim, 3 * dh);
      cp_async_wait<1>();  // all but the copy just started
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // x and this head's weights are in

    // q | k | v = x_w . Wqkv_h (both products end in a block barrier)
    if constexpr (kTC)
      wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
          kRows, 3 * dh, dim, xs, ldx, ws[it & 1], ldw, qkv, ldq, false);
    else
      gemm_smem_f32(xs, ldx, ws[it & 1], ldw, qkv, ldq, dim, 3 * dh);

    // slot g of the v stack; l2 norms; S_h + bias_h into slot g of the
    // score stack, keys >= n at -1e30
    float* vg = vs + static_cast<size_t>(g) * kRows * dh;
    for (int e = tid; e < kRows * dh; e += kThreads)
      vg[e] = qkv[(e / dh) * ldq + 2 * dh + e % dh];
    l2_normalize_qk(qkv, ldq, n, dh);
    scores_tile(qkv, ldq, dh, bias + static_cast<size_t>(h) * n * n, n,
                stack + static_cast<size_t>(g) * kRows * kRows);
    if (g + 1 < gn) continue;  // q|k|v may be overwritten now

    // ONE softmax over the G * n real rows of the stack, a warp a row; then
    // out[w, r, h*dh + d] = sum_j P_h[r][j] v_h[j][d] for the group's heads
    // (the next group's scores come three block barriers later)
    softmax_rows(stack, gn, n);
    for (int gg = 0; gg < gn; ++gg)
      pv_tile<T>(stack + static_cast<size_t>(gg) * kRows * kRows,
                 vs + static_cast<size_t>(gg) * kRows * dh, dh, n, dh,
                 out + static_cast<size_t>(w) * n * inner + (hg0 + gg) * dh,
                 inner);
  }
}

template <typename T, bool kTC>
int launch(const void* x, const void* wqkv, const void* bias, void* out,
           int bw, int n, int dim, int heads, int dh, int group,
           int windows_per_cta, cudaStream_t stream) {
  const size_t smem = make_stacked_plan<T>(dim, dh, group).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      stacked_softmax_kernel<T, kTC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  stacked_softmax_kernel<T, kTC><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const float*>(bias), static_cast<T*>(out), bw, n, dim,
      heads, dh, group, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of the kernel takes at these widths and G.
extern "C" long vgm_stacked_softmax_attention_smem_bytes(int dim, int dh,
                                                         int group,
                                                         int is_bf16) {
  return static_cast<long>(
      is_bf16 ? make_stacked_plan<__nv_bfloat16>(dim, dh, group).bytes
              : make_stacked_plan<float>(dim, dh, group).bytes);
}

// x: (bw, n, dim) and out: (bw, n, heads*dh), f32 or bf16 (is_bf16);
// wqkv: (heads, dim, 3*dh) in x's type, each head's q | k | v columns;
// bias: f32 (heads, n, n).  All contiguous.  dim and dh are multiples of 16
// (dh <= 64), n <= 64; the stack holds `group` heads (the last group may
// hold fewer).  Launches ceil(bw / windows_per_cta) CTAs on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int vgm_stacked_softmax_attention(const void* x, const void* wqkv,
                                             const void* bias, void* out,
                                             int bw, int n, int dim,
                                             int heads, int dh, int group,
                                             int windows_per_cta,
                                             int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      group < 1 || group > heads || windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, wqkv, bias, out, bw, n, dim, heads,
                                       dh, group, windows_per_cta, st);
  return launch<float, false>(x, wqkv, bias, out, bw, n, dim, heads, dh,
                              group, windows_per_cta, st);
}
