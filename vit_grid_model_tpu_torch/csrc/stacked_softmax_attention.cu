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
// Two designs.  The route (vgm_stacked_softmax_attention_route) is the
// strip design for bf16 with dim and dh multiples of 16, dim <= 128 and dh
// <= 32 (the repro's shape), the first design for f32 and for bf16 off
// those widths (dh 64, dim > 128).
//
// The strip design (stacked_softmax_strips), since the first design below
// ran at one CTA an SM with its n x n products on CUDA cores in f32 (41.25
// ms at Bw = 9,000 on an H100, 84x the bound): K1's strip body
// (window_attention_strips.cuh) without its out-projection (kOutProj
// false), with x's bf16 rows copied by cp.async (rows n..63 of the tile
// zeroed once a CTA, so that a padded q, k or v row is 0, never NaN) and no
// q/k gain.  Each head: q|k|v on mma.sync m16n8k16 in warp-owned 16-row
// strips, the l2 norms in the product's epilogue, S = qn kn^T and O = P v
// from hi/lo-split operands (hi.hi + hi.lo + lo.hi, f32 sums), the softmax
// of each row in registers with this head's own max, o_h rounded to bf16
// into the o plane; once a strip's o_h is whole (its two warps' named
// barrier), its 64 threads store its rows < n to out[w, r, h dh + c], 16
// bytes a thread in row order (a row's 64 bytes from four neighbouring
// threads).  Each head's Wqkv_h is staged by cp.async a head ahead.  The
// stack selects nothing here: one softmax over a stack of rows is each
// row's own softmax, so group is not read.  A CTA runs windows_per_cta
// windows in turn.  Shared memory at the repro's widths: x 17,408 B, the
// hi and lo planes 13,312 each, o 5,120, Wqkv_h 26,624: 75,776 B, which
// three CTAs an SM fit.  kStripCtasPerSm sets the launch bounds' CTAs an
// SM: at two ptxas gives 119 registers and no spill, at three 80 registers
// and 28 B of spill stores, and three ran 2-5% faster on an H100 (repros/
// headpack_stacked_sections.py, in turns at Bw 2,880 and 9,000), so it is
// built for three.
// The output is 8x the bytes of the out-projection family's y at these
// widths (1.03 GB at Bw = 9,000, 0.31 ms at 3.35 TB/s), below the
// operations' 0.519 ms.
//
// The first design.  One window's stack of 32 heads' f32
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
#include "window_attention_strips.cuh"

namespace {

// CTAs an SM the strip kernel is built for (its launch bounds)
constexpr int kStripCtasPerSm = 3;

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

// ---- the strip design: the body in window_attention_strips.cuh ----

bool strip_route(int dim, int dh, int is_bf16) {
  return is_bf16 && dim % 16 == 0 && dh % 16 == 0 && dim <= kMaxStripDim &&
         dh <= kMaxStripDimHead;
}

__global__ void __launch_bounds__(kThreads, kStripCtasPerSm)
    stacked_softmax_strips(const bf16* __restrict__ x,
                           const bf16* __restrict__ wqkv,
                           const float* __restrict__ bias,
                           bf16* __restrict__ out, int bw, int n, int dim,
                           int heads, int dh, int windows_per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StripPlan plan = make_strip_plan(dim, dh, 0);
  // rows n..63 of the tile stay zero: the copies write rows < n only
  bf16* xs = reinterpret_cast<bf16*>(smem + plan.xs);
  for (int e = threadIdx.x; e < (kRows - n) * plan.ldx; e += kThreads)
    xs[n * plan.ldx + e] = __float2bfloat16(0.f);
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last CTA is ragged
  const int inner = heads * dh;
  for (int wi = 0; wi < nw; ++wi) {
    bf16* ow = out + static_cast<size_t>(w0 + wi) * n * inner;
    const auto store = [&](int h, int r, int c, uint4 v) {
      *reinterpret_cast<uint4*>(ow + static_cast<size_t>(r) * inner +
                                h * dh + c) = v;
    };
    attend_window_strips<false, true, true, false>(
        smem, plan, CopyRows{x + static_cast<size_t>(w0 + wi) * n * dim}, n,
        dim, wqkv, nullptr, nullptr, nullptr, bias, heads, dh, 0, 0, 0u, 0u,
        1.f,
        store);
  }
}

int launch_strips(const void* x, const void* wqkv, const void* bias,
                  void* out, int bw, int n, int dim, int heads, int dh,
                  int windows_per_cta, cudaStream_t stream) {
  const size_t smem = make_strip_plan(dim, dh, 0).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      stacked_softmax_strips, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  stacked_softmax_strips<<<ctas, kThreads, smem, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(wqkv),
      static_cast<const float*>(bias), static_cast<bf16*>(out), bw, n, dim,
      heads, dh, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// 1 when a launch at these widths takes the strip design, 0 when it takes
// the first design.
extern "C" int vgm_stacked_softmax_attention_route(int n, int dim, int dh,
                                                   int is_bf16) {
  return n >= 1 && n <= kRows && strip_route(dim, dh, is_bf16);
}

// The occupancy of the kernel a launch at these widths and G takes:
// out[0..3] = registers, local (spill) bytes a thread, shared memory a
// CTA, CTAs an SM.  Returns the route (0 first design, 1 strip design), or
// -1 on an error.
extern "C" int vgm_stacked_softmax_attention_occupancy(int n, int dim,
                                                       int dh, int group,
                                                       int is_bf16,
                                                       int* out) {
  if (vgm_stacked_softmax_attention_route(n, dim, dh, is_bf16))
    return occupancy_of(stacked_softmax_strips,
                        make_strip_plan(dim, dh, 0).bytes, out)
               ? -1
               : 1;
  const int err =
      is_bf16 ? occupancy_of(stacked_softmax_kernel<__nv_bfloat16, true>,
                             make_stacked_plan<__nv_bfloat16>(dim, dh, group)
                                 .bytes,
                             out)
              : occupancy_of(stacked_softmax_kernel<float, false>,
                             make_stacked_plan<float>(dim, dh, group).bytes,
                             out);
  return err ? -1 : 0;
}

// Shared memory one CTA of the first design takes at these widths and G.
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
// (dh <= 64), n <= 64; the first design's stack holds `group` heads (the
// last group may hold fewer; the strip design reads no group).  Launches
// ceil(bw / windows_per_cta) CTAs of the design
// vgm_stacked_softmax_attention_route names on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int vgm_stacked_softmax_attention(const void* x, const void* wqkv,
                                             const void* bias, void* out,
                                             int bw, int n, int dim,
                                             int heads, int dh, int group,
                                             int windows_per_cta,
                                             int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (strip_route(dim, dh, is_bf16))
    return launch_strips(x, wqkv, bias, out, bw, n, dim, heads, dh,
                         windows_per_cta, st);
  if (group < 1 || group > heads)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, wqkv, bias, out, bw, n, dim, heads,
                                       dh, group, windows_per_cta, st);
  return launch<float, false>(x, wqkv, bias, out, bw, n, dim, heads, dh,
                              group, windows_per_cta, st);
}
