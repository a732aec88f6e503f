// Head-major batched window attention for Hopper (sm_90a): R4.
//
// Replaces benchmarks/mosaic_repros/repro_headmajor_batched.py::kernel
// (:23-58, pallas_call :63).  It computes R1's function: for each window w
// of n <= 64 tokens and each head h, in f32,
//
//   q | k | v = x_w . Wqkv_h                  (Wqkv_h: dim x 3dh)
//   q <- q * rsqrt(max(sum q^2, 1e-24))       (same for k)
//   out[w, :, h*dh:(h+1)*dh] = softmax(q k^T + bias_h) . v   (stored as T)
//
// The TPU kernel runs one qkv product for a tile of windows, relays it out
// head-major (3h, R, d) once, and runs the norm, the scores, the softmax and
// P.v each as one op batched over every (head, window) pair.
//
// What bounds it on an H100: the same arithmetic as R1, 56.89 MFLOP a
// window at the repro's shape (n = 56, dim 128, 32 heads x 32), 0.166 ms at
// Bw = 2,880 on the bf16 peak (repros/baseline_perhead.py::bound_ms).
//
// The wgmma design (bf16 at dh 16 or 32, dim a multiple of 16 while the
// plan fits, n <= 64, G 1 or 2; vgm_headmajor_attention_route says 1).
// "All heads at once" becomes what a CTA can hold and what costs the
// per-head wgmma kernel most: x, which that kernel streams again for every
// head (459 KB a window of its ~620 KB from L2 at the repro's widths), is
// staged once for a group of G heads, and the group's heads run one after
// another on it, each on the per-head kernel's wgmma body
// (perhead_wgmma_body.cuh: every product on warpgroup MMA, S and P.v
// hi/lo split, norms and softmax by quad shuffles).  Steps go (group,
// window, head in the group); each head's weight tiles and bias rows arrive
// by bulk copies into one of kGroupBuffers buffers and serve every window
// of the CTA.  At the repro's widths, G = 2 (the wrapper's default):
// three consumer warpgroups and three head buffers (the third takes the
// next group's first head ahead), 220,416 B at n 56, one CTA an SM.  The
// output is bit-identical to the per-head kernel's wgmma design at any G.
//
// The first design (f32 and every other width).  "All heads at once"
// cannot mean one window's whole q|k|v here: that is 688 KB in f32.  It
// becomes a group of G heads at once; the wrapper picks the largest G (up
// to 2) of which two CTAs share an SM, since the kernel is latency-bound.
// A CTA of 256 threads owns `windows_per_cta` windows and loops head groups
// outside them, so each group's G weight slices (dim x 3dh each) are staged
// once per CTA; x is streamed per (group, window) step into one of two
// buffers with cp.async while the other is in use.  Each step:
//   1. the group's q|k|v = x_w . [Wqkv_h for h in the group] on the tensor
//      cores (wmma 16x16x16 bf16, f32 sums; CUDA-core FMAs for f32 inputs),
//      one warp per (16-row tile, head, q|k|v) unit, stored head-major in
//      f32, (G, 3, 64, dh + 4); the warp that stores a q or k tile
//      l2-normalizes its 16 rows itself after a __syncwarp, two lanes a
//      row;
//   2. one block barrier, then warp i takes query rows i, i + 8, ... of
//      every head of the group and runs the scores, the softmax and P.v of
//      its rows alone, four interleaved (attend_rows: a row's 56 scores in
//      registers, two a lane, max and sum by shuffles).
// Two block barriers a step, one before and one after the product, and
// none between the heads of a group: R1's kernel runs five a head.  Steps 1
// and 2 are attention_common.cuh's group_qkv and attend_group, which R3's
// kernel (crosshead_norm_attention.cu) shares with its own norm between.
// Shared memory at the repro's widths in bf16: two x buffers 2 x 17,408 B,
// G weight slices of 26,624 B and G q|k|v of 27,648 B: 89,088 B at G = 1,
// two CTAs an SM (the wrapper's pick), and 143,360 B at G = 2, one.  In
// f32 no G lets two CTAs share an SM, and G = 2 takes 225,280 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "perhead_wgmma_body.cuh"

namespace {

constexpr int kMaxDimHead = 64;

struct HeadmajorPlan {
  int ldx, ldw, ldh;
  size_t xs0, xs1, ws, qkv, bytes;
};

// Rows padded by 16 bytes keep every row 16-byte aligned for cp.async and
// wmma; a q|k|v row of dh + 4 floats keeps the float4 reads of attend_rows
// free of bank conflicts and wmma's f32 tiles 32-byte aligned.
template <typename T>
__host__ __device__ HeadmajorPlan make_headmajor_plan(int dim, int dh,
                                                      int group) {
  constexpr int pad = 16 / sizeof(T);
  HeadmajorPlan p{};
  p.ldx = dim + pad;
  p.ldw = 3 * dh + pad;
  p.ldh = dh + 4;
  size_t off = 0;
  p.xs0 = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.xs1 = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.ws = off;
  off = align128(off + static_cast<size_t>(group) * dim * p.ldw * sizeof(T));
  p.qkv = off;
  off = align128(off + static_cast<size_t>(group) * 3 * kRows * p.ldh *
                           sizeof(float));
  p.bytes = off;
  return p;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    headmajor_attention_kernel(const T* __restrict__ x,
                               const T* __restrict__ wqkv,
                               const float* __restrict__ bias,
                               T* __restrict__ out, int bw, int n, int dim,
                               int heads, int dh, int group,
                               int windows_per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadmajorPlan plan = make_headmajor_plan<T>(dim, dh, group);
  const int ldx = plan.ldx;
  const int ldw = plan.ldw;
  const int ldh = plan.ldh;
  T* xs[2] = {reinterpret_cast<T*>(smem + plan.xs0),
              reinterpret_cast<T*>(smem + plan.xs1)};
  T* ws = reinterpret_cast<T*>(smem + plan.ws);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);

  const int tid = threadIdx.x;
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int inner = heads * dh;
  const int groups = (heads + group - 1) / group;  // the last may be ragged
  const int mtiles = (n + 15) / 16;
  const size_t wslice = static_cast<size_t>(dim) * ldw;  // one head's slice
  const size_t hblock = static_cast<size_t>(kRows) * ldh;  // one q, k or v
  const GroupLayout layout{3 * hblock, hblock, ldh};

  // rows n..63 of both x buffers stay zero: the copies write rows < n only,
  // so the padded rows of q, k and v come out zero
  for (int e = tid; e < (kRows - n) * ldx; e += kThreads) {
    xs[0][n * ldx + e] = from_f32<T>(0.f);
    xs[1][n * ldx + e] = from_f32<T>(0.f);
  }

  // step it = (group it / nw, window it % nw); x of step it goes to buffer
  // it & 1, and the next step's copy is in flight during this one
  const int steps = groups * nw;
  copy_rows_async(xs[0], ldx, x + static_cast<size_t>(w0) * n * dim, dim, n,
                  dim);
  for (int it = 0; it < steps; ++it) {
    const int h0 = (it / nw) * group;
    const int gn = min(group, heads - h0);
    const int w = w0 + it % nw;
    const T* xw = xs[it & 1];
    if (it % nw == 0)  // this group's weight slices, for every window here
      for (int g = 0; g < gn; ++g)
        copy_rows_async(ws + g * wslice, ldw,
                        wqkv + static_cast<size_t>(h0 + g) * dim * 3 * dh,
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

    // the group's q|k|v, head-major, each q or k tile l2-normalized by the
    // warp that stored it
    group_qkv(xw, ldx, ws, wslice, ldw, qkv, layout, mtiles, gn, dim, dh,
              true);
    __syncthreads();  // q|k|v of the group are in

    // warp i runs query rows i, i + 8, ... of every head of the group,
    // kRowsAtOnce of them interleaved
    attend_group<T>(qkv, layout, gn, h0, bias, n, dh,
                    out + static_cast<size_t>(w) * n * inner, inner);
  }
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* bias, void* out,
           int bw, int n, int dim, int heads, int dh, int group,
           int windows_per_cta, cudaStream_t stream) {
  const size_t smem = make_headmajor_plan<T>(dim, dh, group).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      headmajor_attention_kernel<T>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  headmajor_attention_kernel<T><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const float*>(bias), static_cast<T*>(out), bw, n, dim,
      heads, dh, group, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of the kernel takes at these widths and G.
extern "C" long vgm_headmajor_attention_smem_bytes(int dim, int dh,
                                                   int group, int is_bf16) {
  return static_cast<long>(
      is_bf16 ? make_headmajor_plan<__nv_bfloat16>(dim, dh, group).bytes
              : make_headmajor_plan<float>(dim, dh, group).bytes);
}

// x: (bw, n, dim) and out: (bw, n, heads*dh), f32 or bf16 (is_bf16);
// wqkv: (heads, dim, 3*dh) in x's type, each head's q | k | v columns;
// bias: f32 (heads, n, n).  All contiguous.  dim and dh are multiples of 16
// (dh <= 64), n <= 64; `group` heads a step (the last group may hold
// fewer).  Launches ceil(bw / windows_per_cta) CTAs on `stream` and
// returns cudaGetLastError() (0 on success).
extern "C" int vgm_headmajor_attention(const void* x, const void* wqkv,
                                       const void* bias, void* out, int bw,
                                       int n, int dim, int heads, int dh,
                                       int group, int windows_per_cta,
                                       int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      group < 1 || group > heads || windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, wqkv, bias, out, bw, n, dim, heads, dh,
                                 group, windows_per_cta, st);
  return launch<float>(x, wqkv, bias, out, bw, n, dim, heads, dh, group,
                       windows_per_cta, st);
}

// The design a launch at these widths and G takes: 1 the wgmma design
// (vgm_headmajor_attention_wgmma), 0 the first (vgm_headmajor_attention).
extern "C" int vgm_headmajor_attention_route(int n, int dim, int dh,
                                             int group, int is_bf16) {
  return grouped_wgmma_takes<false>(n, dim, dh, group, is_bf16) ? 1 : 0;
}

// x: (bw, n, dim) bf16; w_tiles: (heads, 3dh / 8, dim / 8, 8, 8) bf16, each
// head's Wqkv_h^T in 8 x 8 core matrices; bias_rows: (heads, n, 72) f32;
// out: (bw, n, heads*dh) bf16.  All contiguous.  Takes the widths and G of
// vgm_headmajor_attention_route's 1 (the last group may hold fewer heads).
// Launches ceil(bw / windows_per_cta) CTAs on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int vgm_headmajor_attention_wgmma(
    const void* x, const void* w_tiles, const void* bias_rows, void* out,
    int bw, int n, int dim, int heads, int dh, int group,
    int windows_per_cta, void* stream) {
  return launch_grouped_wgmma<false>(x, w_tiles, bias_rows, out, bw, n, dim,
                                     heads, dh, group, windows_per_cta,
                                     static_cast<cudaStream_t>(stream));
}

// The routed design's registers, local bytes a thread, shared memory a CTA
// and CTAs an SM into out[0..3]; returns the route (-1 on failure).
extern "C" int vgm_headmajor_attention_occupancy(int n, int dim, int dh,
                                                 int group, int is_bf16,
                                                 int* out) {
  int err;
  const int route = vgm_headmajor_attention_route(n, dim, dh, group, is_bf16);
  if (route == 1)
    err = grouped_wgmma_occupancy<false>(n, dim, dh, group, out);
  else if (is_bf16)
    err = occupancy_of(headmajor_attention_kernel<__nv_bfloat16>,
                       make_headmajor_plan<__nv_bfloat16>(dim, dh, group).bytes,
                       out);
  else
    err = occupancy_of(headmajor_attention_kernel<float>,
                       make_headmajor_plan<float>(dim, dh, group).bytes, out);
  return err < 0 ? -1 : route;
}
