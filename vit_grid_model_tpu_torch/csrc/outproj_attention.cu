// Window attention with its out-projection for Hopper (sm_90a): R12, R13,
// R2 and R8, one kernel.
//
// Replaces, in benchmarks/mosaic_repros/:
//   repro_weightsliced_variants.py::baseline_kernel (:88-125, pallas_call
//     :140, R12) and ::kernel (:35-85, pallas_call :155, R13's four
//     variants ws_{1,2}pass and ws_{1,2}pass_pwout);
//   repro_bf16_mxu_operands.py::kernel (:42-81, pallas_call :94, R2);
//   repro_npad_and_kfold.py::kernel (:41-80, pallas_call :88, R8).
// All compute, for each window w of n <= 64 tokens, in f32:
//
//   per head h:  q | k | v = x_w . Wqkv_h          (Wqkv_h: dim x 3dh)
//                q <- q * rsqrt(max(sum q^2, 1e-24))     (same for k)
//                [bf16_score: q, k rounded to T]
//                P = softmax(q k^T + bias_h)
//                [bf16_agg: P, v rounded to T]
//                o_h = P . v, rounded to T
//   y[w] = sum_h o_h . Wout_h   (Wout_h: dh x out_dim; stored in out_dtype)
//
// The variants differ in structure only: one pass over the heads or two
// (every head's scores first, then the softmax and P.v), and the head
// outputs concatenated into one (R, hd) . (hd, out_dim) product or one
// (R, dh) . (dh, out_dim) product a head summed in f32.  In f32 they are one
// function up to the order of the f32 sums.  This kernel takes those choices
// and R2's casts, R8's windows a CTA and its n at run time.
//
// What bounds it on an H100.  At the repros' shape (n = 56, dim 128, 32
// heads x 32, out_dim 128) a window costs 71.57 MFLOP (R1's 56.89 plus the
// out-projection's 14.68) and moves 14 KB in and 14 KB out: 0.208 ms at
// Bw = 2,880 on the bf16 peak against 0.025 ms for the bytes; at n = 64,
// 83.89 MFLOP, 0.244 ms (repros/weightsliced_variants.py::bound_ms).
//
// What this design does about it.  The qkv runs from per-head weight
// slices, (heads, dim, 3dh), R9's layout.  R13, R2 and R8 hand their (3,
// heads, dim, dh) weight, R12 R1's (dim, 3hd) one; the wrapper lays both
// out once.  R12's one wide qkv product does not fit a window here (56 x
// 3,072 is 688 KB in f32, against 227 KB of shared memory a block:
// perhead_attention.cu), so R12 runs R13's ws_2pass structure: two passes,
// concat out-projection.  A window's (n, out_dim) f32 sum has to live
// across every head (32 KB at n = 64), and a CTA's windows' sums do not fit
// together (8 windows take 256 KB), so a CTA of 256 threads loops its
// `windows_per_cta` windows in turn (R8's kfold chunks) and each window's
// heads inside, as K1's body does (window_attention_body.cuh), keeping one
// window's y in shared memory in f32.  Each head's 128 x 96 qkv slice and
// its 32 x 128 Wout slice stream from L2 (the weights are 768 KB + 256 KB
// in bf16) with cp.async into a buffer refilled as soon as its last reader
// is done: the next head's qkv slice right after this head's qkv product, so
// the copy runs during the norm, scores, softmax, P.v and out-projection;
// x of the next window after its last head's product.  A second buffer
// would cost 26 KB (bf16) or 51 KB (f32) and overlap nothing more.
// Per head, after the qkv product (wmma 16x16x16 bf16 with f32 sums; CUDA-
// core FMAs for f32 inputs) and the l2 norms (attention_common.cuh):
//   * one pass: each warp runs whole query rows, four at once
//     (attend_rows: scores in registers, max and sum by shuffles, P.v), and
//     writes o_h in T;
//   * two passes: a window's 32 heads' f32 scores would take 401 KB, so the
//     first pass runs over a group of G heads, stacking each head's scores +
//     bias (keys >= n at -inf before the max) and its v, as R10's kernel
//     (stacked_softmax_attention.cu); the second runs one softmax over the
//     G * n rows of the stack, then P.v for each of the G heads into o_h.
//     With bf16_score (bf16_agg) in bf16 the score (aggregation) product
//     runs on mma.sync m16n8k16 with f32 sums, with R11's fragments
//     (attention_common.cuh); its A and B fragments are read from the f32
//     tiles and rounded to bf16 in registers, as the repro's casts, P among
//     them.  Without the flag, or for f32 inputs, it runs in f32 on CUDA
//     cores.
// Out-projection:
//   * per head (pwout): y += o_h . Wout_h after each head, in head order;
//     the group's G Wout slices are copied when the group starts;
//   * concat: o_h is kept in T at columns (h mod C) dh of a (64, C dh)
//     buffer, and every C heads y += that buffer . Wout's C dh rows, in
//     one tensor-core product whose B operand streams through two slice
//     buffers, one head's dh rows at a time.  C is as many heads as fit.
// Both products run on wmma bf16 with f32 sums, or CUDA-core FMAs in f32.
// After the last head, rows < n of y are stored in out_dtype (f32 or bf16).
// Padded rows (n..63) of x and of the head outputs stay zero and are never
// stored.  The wrapper picks G (two passes: up to 2 heads, as R4's pick)
// and C (concat) as the largest powers of two that fit one CTA.
// Shared memory at the repros' widths in bf16 (all one CTA an SM): x
// 17,408 B, a qkv slice 26,624, q|k|v in f32 25,600 and y 33,792, plus
//   ws_2pass_pwout (G = 2): stacks 2 x (16,384 + 9,216), o 5,120, two Wout
//     slices 17,408: 177,152 B;
//   ws_1pass_pwout: o 5,120, one Wout slice 8,704: 117,248 B;
//   ws_2pass and R12 (G = 2, C = 8): stacks 51,200, the concat 33,792, two
//     Wout slices 17,408: 205,824 B;
//   ws_1pass (C = 16): the concat 66,560, two slices 17,408: 187,392 B.
// In f32: ws_2pass_pwout G = 1, 196,096 B; ws_1pass_pwout 170,496;
// ws_2pass G = 1, C = 2, 221,184; ws_1pass C = 4, 211,968.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kMaxDimHead = 64;
constexpr int kMaxGroup = 8;

struct OutprojPlan {
  int ldx, ldw, ldq, ldv, ldo, ldwo, ldy, nwo;
  size_t xs, ws, qkv, stack, vs, o, wos, y, bytes;
};

// group: heads a stack (0: one pass); cat_heads: heads a concat product
// (0: per-head out-projection).  Rows padded by 16 bytes keep every row
// 16-byte aligned for cp.async and every wmma tile 32-byte aligned.
template <typename T>
__host__ __device__ OutprojPlan make_outproj_plan(int dim, int dh,
                                                  int out_dim, int group,
                                                  int cat_heads) {
  constexpr int pad = 16 / sizeof(T);
  OutprojPlan p{};
  p.ldx = dim + pad;
  p.ldw = 3 * dh + pad;
  p.ldq = 3 * dh + 4;
  p.ldv = dh + 4;
  p.ldo = (cat_heads ? cat_heads : 1) * dh + pad;
  p.ldwo = out_dim + pad;
  p.ldy = out_dim + 4;
  p.nwo = cat_heads ? 2 : (group ? group : 1);
  size_t off = 0;
  p.xs = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.ws = off;
  off = align128(off + static_cast<size_t>(dim) * p.ldw * sizeof(T));
  p.qkv = off;
  off = align128(off + kRows * p.ldq * sizeof(float));
  p.stack = off;
  off = align128(off + static_cast<size_t>(group) * kRows * kRows *
                           sizeof(float));
  p.vs = off;
  off = align128(off + static_cast<size_t>(group) * kRows * p.ldv *
                           sizeof(float));
  p.o = off;
  off = align128(off + kRows * p.ldo * sizeof(T));
  p.wos = off;
  off = align128(off + static_cast<size_t>(p.nwo) * dh * p.ldwo * sizeof(T));
  p.y = off;
  off = align128(off + kRows * p.ldy * sizeof(float));
  p.bytes = off;
  return p;
}

// s = q k^T + bh (keys >= n at -inf, rows >= n without bias) with q and k
// rounded to bf16 (R2's bf16_score), on mma.sync m16n8k16 with f32 sums.
// Warp i owns row tile i & 3 and key tiles 4 (i >> 2) .. + 3; the fragments
// are read from the f32 q|k|v (rows ldq apart, k at column dh).  Ends in a
// block barrier.
__device__ void scores_mma(const float* qkv, int ldq, int dh,
                           const float* bh, int n, float* s) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (warp & 3) * 16 + g;
  const int r1 = r0 + 8;
  uint32_t qa[kMaxDimHead / 16][4];
#pragma unroll
  for (int kk = 0; kk < kMaxDimHead / 16; ++kk) {
    if (kk * 16 >= dh) break;
    const float* q0 = qkv + r0 * ldq + kk * 16 + 2 * t;
    const float* q1 = qkv + r1 * ldq + kk * 16 + 2 * t;
    qa[kk][0] = pack_bf16(q0[0], q0[1]);
    qa[kk][1] = pack_bf16(q1[0], q1[1]);
    qa[kk][2] = pack_bf16(q0[8], q0[9]);
    qa[kk][3] = pack_bf16(q1[8], q1[9]);
  }
  for (int nt = (warp >> 2) * 4; nt < (warp >> 2) * 4 + 4; ++nt) {
    float c[4] = {0.f, 0.f, 0.f, 0.f};
    const float* kr = qkv + (nt * 8 + g) * ldq + dh + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kMaxDimHead / 16; ++kk) {
      if (kk * 16 >= dh) break;
      mma_bf16_16816(c, qa[kk], pack_bf16(kr[kk * 16], kr[kk * 16 + 1]),
                     pack_bf16(kr[kk * 16 + 8], kr[kk * 16 + 9]));
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i < 2 ? r0 : r1;
      const int col = nt * 8 + 2 * t + (i & 1);
      s[r * kRows + col] =
          col < n ? c[i] + (r < n ? bh[r * n + col] : 0.f) : -INFINITY;
    }
  }
  __syncthreads();
}

// out[r * ldo + d] = sum_j p[r][j] v[j][d] for r < n, d < dh with P and v
// rounded to bf16 (R2's bf16_agg), on mma.sync m16n8k16 with f32 sums,
// stored as bf16.  p: a 64 x 64 f32 tile whose rows < n are softmaxed (0 on
// keys >= n); v: f32, rows ldv apart, zero on rows >= n.  Warp i owns row
// tile i & 3 and every other 8-column tile.  No barrier.
__device__ void pv_mma(const float* p, const float* v, int ldv, int n,
                       int dh, __nv_bfloat16* out, int ldo) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = (warp & 3) * 16 + g;
  const int r1 = r0 + 8;
  uint32_t pa[kRows / 16][4];
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const float* p0 = p + r0 * kRows + kk * 16 + 2 * t;
    const float* p1 = p + r1 * kRows + kk * 16 + 2 * t;
    pa[kk][0] = pack_bf16(p0[0], p0[1]);
    pa[kk][1] = pack_bf16(p1[0], p1[1]);
    pa[kk][2] = pack_bf16(p0[8], p0[9]);
    pa[kk][3] = pack_bf16(p1[8], p1[9]);
  }
  for (int nd = warp >> 2; nd < dh / 8; nd += 2) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    const float* vc = v + nd * 8 + g;
#pragma unroll
    for (int kk = 0; kk < kRows / 16; ++kk) {
      const int j = kk * 16 + 2 * t;
      mma_bf16_16816(o, pa[kk], pack_bf16(vc[j * ldv], vc[(j + 1) * ldv]),
                     pack_bf16(vc[(j + 8) * ldv], vc[(j + 9) * ldv]));
    }
    const int c = nd * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(out + r0 * ldo + c) = pack_bf16(o[0], o[1]);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(out + r1 * ldo + c) = pack_bf16(o[2], o[3]);
  }
}

// C[64 x N] += A[64 x K] . B[K x N]: wmma bf16 (kTC) or CUDA-core f32, all
// in shared memory.  Ends in a block barrier.
template <typename T, bool kTC>
__device__ void accumulate_product(const T* A, int lda, const T* B, int ldb,
                                   float* C, int ldc, int K, int N) {
  if constexpr (kTC)
    wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
        kRows, N, K, A, lda, B, ldb, C, ldc, true);
  else
    gemm_smem_f32(A, lda, B, ldb, C, ldc, K, N, true);
}

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 1)
    outproj_attention_kernel(const T* __restrict__ x,
                             const T* __restrict__ wqkv,
                             const float* __restrict__ bias,
                             const T* __restrict__ wout,
                             void* __restrict__ out,
                             int bw, int n, int dim, int heads, int dh,
                             int out_dim, int group, int cat_heads,
                             int bf16_score, int bf16_agg,
                             int windows_per_cta, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  const OutprojPlan plan =
      make_outproj_plan<T>(dim, dh, out_dim, group, cat_heads);
  const int ldx = plan.ldx;
  const int ldw = plan.ldw;
  const int ldq = plan.ldq;
  const int ldv = plan.ldv;
  const int ldo = plan.ldo;
  const int ldwo = plan.ldwo;
  const int ldy = plan.ldy;
  T* xs = reinterpret_cast<T*>(smem + plan.xs);
  T* ws = reinterpret_cast<T*>(smem + plan.ws);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);
  float* stack = reinterpret_cast<float*>(smem + plan.stack);
  float* vs = reinterpret_cast<float*>(smem + plan.vs);
  T* o = reinterpret_cast<T*>(smem + plan.o);
  T* wos = reinterpret_cast<T*>(smem + plan.wos);
  float* y = reinterpret_cast<float*>(smem + plan.y);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const bool two_pass = group > 0;
  const int gsize = two_pass ? group : 1;
  const size_t wslice = static_cast<size_t>(dim) * 3 * dh;
  const size_t oslice = static_cast<size_t>(dh) * out_dim;  // Wout_h
  const size_t woslot = static_cast<size_t>(dh) * ldwo;
  const size_t sslot = static_cast<size_t>(kRows) * kRows;
  const size_t vslot = static_cast<size_t>(kRows) * ldv;

  // rows n..63 of x and of the head outputs stay zero: the copies and the
  // P.v stores write rows < n only
  for (int e = tid; e < (kRows - n) * ldx; e += kThreads)
    xs[n * ldx + e] = from_f32<T>(0.f);
  for (int e = tid; e < (kRows - n) * ldo; e += kThreads)
    o[n * ldo + e] = from_f32<T>(0.f);

  auto copy_wout = [&](int slot, int h) {
    copy_rows_async(wos + slot * woslot, ldwo, wout + h * oslice, out_dim, dh,
                    out_dim);
  };

  // y += the head outputs in o . Wout, once o_h (head h, group slot g) is
  // in o.  `pending`: a copy for a later step is in flight behind the Wout
  // copies.
  auto out_projection = [&](int h, int g, bool pending) {
    if (!cat_heads) {
      if (pending)
        cp_async_wait<1>();
      else
        cp_async_wait<0>();
      __syncthreads();  // the group's Wout slices are in
      accumulate_product<T, kTC>(o, ldo, wos + g * woslot, ldwo, y, ldy, dh,
                                 out_dim);
      return;
    }
    const int j = h % cat_heads;
    if (j + 1 < cat_heads && h + 1 < heads) return;  // the concat is not full
    const int hc0 = h - j;
    copy_wout(0, hc0);
    for (int jj = 0; jj <= j; ++jj) {
      if (jj < j) {
        copy_wout((jj + 1) & 1, hc0 + jj + 1);
        cp_async_wait<1>();  // all but the copy just started
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();  // Wout_{hc0 + jj} is in
      accumulate_product<T, kTC>(o + jj * dh, ldo, wos + (jj & 1) * woslot,
                                 ldwo, y, ldy, dh, out_dim);
    }
  };

  copy_rows_async(xs, ldx, x + static_cast<size_t>(w0) * n * dim, dim, n,
                  dim, false);
  copy_rows_async(ws, ldw, wqkv, 3 * dh, dim, 3 * dh);
  bool pending = true;
  for (int wi = 0; wi < nw; ++wi) {
    const int w = w0 + wi;
    for (int e = tid; e < kRows * ldy; e += kThreads) y[e] = 0.f;
    for (int h0 = 0; h0 < heads; h0 += gsize) {
      const int gn = min(gsize, heads - h0);
      for (int g = 0; g < gn; ++g) {
        const int h = h0 + g;
        cp_async_wait<0>();
        __syncthreads();  // x and Wqkv_h are in; the last reader of q|k|v
                          // is done

        // q | k | v = x_w . Wqkv_h (both products end in a block barrier)
        if constexpr (kTC)
          wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
              kRows, 3 * dh, dim, xs, ldx, ws, ldw, qkv, ldq, false);
        else
          gemm_smem_f32(xs, ldx, ws, ldw, qkv, ldq, dim, 3 * dh);

        // refills: the group's Wout slices (per-head out-projection), then
        // the next head's qkv slice and, after a window's last head, the
        // next window's x
        if (!cat_heads && g == 0)
          for (int gg = 0; gg < gn; ++gg) copy_wout(gg, h0 + gg);
        pending = h + 1 < heads || wi + 1 < nw;
        if (h + 1 == heads && wi + 1 < nw)
          copy_rows_async(xs, ldx, x + static_cast<size_t>(w + 1) * n * dim,
                          dim, n, dim, false);
        if (pending)
          copy_rows_async(ws, ldw, wqkv + ((h + 1) % heads) * wslice, 3 * dh,
                          dim, 3 * dh);

        l2_normalize_qk(qkv, ldq, n, dh);
        const float* bh = bias + static_cast<size_t>(h) * n * n;
        T* oh = o + (cat_heads ? (h % cat_heads) * dh : 0);
        if (!two_pass) {
          // one pass: warp i runs query rows i, i + 8, ..., four at once
          for (int r = warp; r < n; r += kRowsAtOnce * kWarps)
            attend_rows<T>(qkv + r * ldq, static_cast<size_t>(kWarps) * ldq,
                           min(kRowsAtOnce, (n - r + kWarps - 1) / kWarps),
                           qkv + dh, ldq, qkv + 2 * dh, ldq, bh + r * n,
                           static_cast<size_t>(kWarps) * n, n, dh,
                           oh + r * ldo, static_cast<size_t>(kWarps) * ldo);
          __syncthreads();  // o_h is in
          out_projection(h, 0, pending);
          continue;
        }
        // two passes, first: slot g of the v stack and of the score stack
        float* vg = vs + g * vslot;
        for (int e = tid; e < kRows * dh; e += kThreads)
          vg[(e / dh) * ldv + e % dh] = qkv[(e / dh) * ldq + 2 * dh + e % dh];
        if constexpr (kTC) {
          if (bf16_score) {
            scores_mma(qkv, ldq, dh, bh, n, stack + g * sslot);
            continue;
          }
        }
        scores_tile(qkv, ldq, dh, bh, n, stack + g * sslot);
      }
      if (!two_pass) continue;

      // two passes, second: ONE softmax over the group's G * n rows, then
      // per head P.v into o_h and the out-projection
      softmax_rows(stack, gn, n);
      for (int g = 0; g < gn; ++g) {
        const int h = h0 + g;
        T* oh = o + (cat_heads ? (h % cat_heads) * dh : 0);
        bool done = false;
        if constexpr (kTC) {
          if (bf16_agg) {
            pv_mma(stack + g * sslot, vs + g * vslot, ldv, n, dh, oh, ldo);
            done = true;
          }
        }
        if (!done)
          pv_tile<T>(stack + g * sslot, vs + g * vslot, ldv, n, dh, oh, ldo);
        __syncthreads();  // o_h is in
        out_projection(h, g, pending);
      }
    }

    // rows < n of y, in out_dtype
    const size_t base = static_cast<size_t>(w) * n * out_dim;
    for (int e = tid; e < n * out_dim; e += kThreads) {
      const float v = y[(e / out_dim) * ldy + e % out_dim];
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[base + e] = __float2bfloat16(v);
      else
        static_cast<float*>(out)[base + e] = v;
    }
    __syncthreads();  // y is read before the next window zeroes it
  }
}

template <typename T, bool kTC>
int launch(const void* x, const void* wqkv, const void* bias,
           const void* wout, void* out, int bw, int n, int dim, int heads,
           int dh, int out_dim, int group, int cat_heads, int bf16_score,
           int bf16_agg, int windows_per_cta, int out_bf16,
           cudaStream_t stream) {
  const size_t smem =
      make_outproj_plan<T>(dim, dh, out_dim, group, cat_heads).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      outproj_attention_kernel<T, kTC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  outproj_attention_kernel<T, kTC><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const float*>(bias), static_cast<const T*>(wout), out, bw,
      n, dim, heads, dh, out_dim, group, cat_heads, bf16_score, bf16_agg,
      windows_per_cta, out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of the kernel takes at these widths, G (0: one
// pass) and C (0: per-head out-projection).
extern "C" long vgm_outproj_attention_smem_bytes(int dim, int dh, int out_dim,
                                                 int group, int cat_heads,
                                                 int is_bf16) {
  return static_cast<long>(
      is_bf16 ? make_outproj_plan<__nv_bfloat16>(dim, dh, out_dim, group,
                                                 cat_heads).bytes
              : make_outproj_plan<float>(dim, dh, out_dim, group, cat_heads)
                    .bytes);
}

// x: (bw, n, dim), f32 or bf16 (is_bf16); wqkv: (heads, dim, 3*dh) in x's
// type, each head's q | k | v columns; bias: f32 (heads, n, n); wout:
// (heads*dh, out_dim) in x's type; out: (bw, n, out_dim), bf16 if out_bf16
// else f32.  All contiguous.  dim, dh and out_dim are multiples of 16 (dh
// <= 64), n <= 64; group: heads a two-pass stack (1..8; 0 = one pass);
// cat_heads: heads a concat out-projection (0 = per head); bf16_score and
// bf16_agg round those products' operands to bf16 (no-ops for f32).
// Launches ceil(bw / windows_per_cta) CTAs on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int vgm_outproj_attention(const void* x, const void* wqkv,
                                     const void* bias, const void* wout,
                                     void* out, int bw, int n, int dim,
                                     int heads, int dh, int out_dim,
                                     int group, int cat_heads, int bf16_score,
                                     int bf16_agg, int windows_per_cta,
                                     int is_bf16, int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      out_dim < 16 || out_dim % 16 != 0 || group < 0 || group > heads ||
      group > kMaxGroup || cat_heads < 0 || cat_heads > heads ||
      windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(
        x, wqkv, bias, wout, out, bw, n, dim, heads, dh, out_dim, group,
        cat_heads, bf16_score, bf16_agg, windows_per_cta, out_bf16, st);
  return launch<float, false>(x, wqkv, bias, wout, out, bw, n, dim, heads, dh,
                              out_dim, group, cat_heads, 0, 0,
                              windows_per_cta, out_bf16, st);
}
