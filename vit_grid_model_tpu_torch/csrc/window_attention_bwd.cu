// Fused MaxViT window-attention backward for Hopper (sm_90a).
//
// Replaces vit_grid_model_tpu/ops/pallas/attention.py::_attention_bwd_kernel
// and its tail _attention_bwd_ln_film (the per-head branch), with the
// in-kernel dropout mask regenerated from the forward's seed
// (dropout_hash.cuh).  For every window it recomputes the forward inside
// the CTA and runs every gradient contraction there:
//
//   xf = LN(x) * gamma + beta                      (rounded to T)
//   per head h:
//     q|k|v = xf . Wqkv_h;  u = q / max(|q|, 1e-12) (same for k)
//     qn = u_q * sqrt(dh) * qg_h;  kn = u_k * sqrt(dh) * kg_h
//     P = softmax(qn kn^T + bias_h) (own row max, -1e30 on padded keys)
//     Pm = P * keep
//     dO = dY . Wout_h^T;  O = Pm . v (rounded to T);  dWout_h += O^T . dY
//     dV = Pm^T . dO;  dP = (dO . v^T) * keep
//     dS = P * (dP - rowsum(dP * P));  dbias_h += dS
//     dQn = dS . kn;  dKn = dS^T . qn;  dqg_h += sqrt(dh) sum(dQn * u_q)
//     dQ = (dQn s_q - u_q <dQn s_q, u_q>) / |q|  (the projection term is 0
//          where |q|^2 <= 1e-24, the clamped branch; same for K)
//     dWqkv_h += xf^T . [dQ|dK|dV]  (dQ, dK, dV rounded to T)
//     dXf += [dQ|dK|dV] . Wqkv_h^T
//   dgamma_w = sum_rows dXf * xn;  dbeta_w = sum_rows dXf
//   dx = LayerNorm VJP of dXf * gamma                (stored as T)
//
// Every sum is f32; T is f32 or bf16 and sets only the rounding points,
// which are those of the TPU kernel.  Padded query rows get dY = 0 and so
// contribute to no gradient; padded key columns get P = 0.
//
// A GPU grid runs in no order and nothing carries between CTAs, whereas
// the TPU kernel adds its weight gradients into one output block across a
// sequential grid.  Here CTA c owns a contiguous chunk of windows and an f32
// slot of its own, into which it adds each window's per-head products with
// plain loads and stores; a second kernel sums the slots in slot order.
// Two runs of the same inputs therefore give bit-identical gradients; no
// float atomics are used.  On the f32 path the slot holds dWqkv, dWout,
// dqg, dkg and dbias (heads*(4*dim*dh + 2*dh + n*n) floats, 2.5 MB at the
// flagship shape, ~0.3 GB for one CTA per SM).  On the tensor-core path it
// holds dqg, dkg and dbias (0.37 MB): the kernel writes, once, the
// T-rounded operands of the weight-gradient products (xf, dQ|dK|dV and O,
// rows < n, bf16; 0.65 GB at Bw = 1,440) and window_attention_wgrad.cu sums
// dWqkv = xf^T [dQ|dK|dV] and dWout = O^T dY over all rows.
//
// What bounds it on an H100.  One window costs ~190-220 MFLOP at the
// flagship shape (dim 128, 32 heads x 32, n = 53, rows padded to 64), ~3x
// the forward, of which the five projection products (qkv recompute, dO,
// dWout, dWqkv, dXf) are ~83%; one call at Bw = 1,440 is ~0.3 TFLOP, so it
// is bound by arithmetic.  What held the first design back (clock64 stamps
// at the block barriers, bf16, Bw = 1,440): the n x n products on CUDA
// cores with their softmax and dS passes (~57% of the cycles), the slot
// read-modify-writes (~19%: dbias's per-row adds and the dWqkv, dWout
// tiles in device memory) and ~16 exposed barriers a head at one CTA an SM.
//
// Two paths.  The f32 path, and bf16 with dim or dh off the 16-multiples,
// runs every product as 4x4 register tiles of a 16x16 thread grid on
// CUDA-core FMAs (TF32 would not meet the f32 tolerance), each product
// ending in a block barrier.  The tensor-core path (kTC: bf16, dim and dh
// multiples of 16) runs
//   - the three projections left to it (q|k|v, dO, dXf) on wmma 16x16x16
//     tiles with f32 sums (bf16 operands in shared memory, weight fragments
//     read straight from L2);
//   - the six n x n products (S, O, dV, dPm, dQn, dKn) on mma.sync
//     m16n8k16.  The TPU kernel feeds them f32 operands, so each operand is
//     split into a bf16 high part and the bf16 rounding of its remainder,
//     and each product is taken three times (hi.hi + hi.lo + lo.hi, f32
//     sums, ~2^-16 relative error).
// Warp w of the 8 owns the 16-row strip w % 4 of the 64-row tile.  Warps w
// and w + 4 both compute their strip's scores and softmax in registers
// (the row max and sum across the four lanes of a quad by shuffles, the
// bias read ahead); then warp w stores Pm and takes O = Pm.v from its
// registers, and warp w + 4 takes dPm = dO.v^T, dS, dbias (its slot values
// read ahead) and dQn = dS.kn from its registers, with dQ's l2-norm
// backward row-local.  After one barrier warp w takes dV = Pm^T.dO and
// warp w + 4 dKn = dS^T.qn over the strip's 16 keys.  A head costs four
// block barriers.  Pm's padded rows (n..63) are zeroed before any product
// that sums over rows (dV, and through O dWout); O's and dQ|dK|dV's padded
// rows are never written and stay zero; strips wholly past n are skipped.
// The ~160 KB of per-window state (xf, dY, dXf, q|k|v, dQ|dK|dV, Pm, dS,
// dO, O) stays in shared memory, so one 256-thread CTA runs per SM.  At
// Bw = 1,440 in bf16 on an NVIDIA H100 80GB HBM3 at 700 W the kernel takes
// 12.2-12.5 ms and window_attention_wgrad.cu 0.39-0.40 ms, against
// 22.7-23.3 ms for the first design (every n x n product on CUDA cores, the
// weight gradients in the slots); the f32 path takes ~52 ms.  The weight
// fragments' L2 latency in the wmma products, the two warps' shared score
// strip, wgmma and several CTAs per SM are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"
#include "dropout_hash.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kLdS = kRows + 1;
constexpr int kChunkK = 32;    // rows of a staged weight tile
constexpr int kChunkN = 64;    // columns of one GEMM pass
constexpr int kMaxDim = 128;
constexpr int kMaxDimHead = 64;
constexpr int kStrips = kRows / 16;          // 16-row strips (kTC)
constexpr int kKeyTiles = kRows / 8;         // 8-key tiles of a score strip
constexpr int kHeadTiles = kMaxDimHead / 8;  // 8-column tiles of a head
constexpr size_t kMaxSmem = 232448;

// C[m][c] (+)= nscale[c] * sum_k A(m, k) * kscale[k] * B(k, c) for m < M,
// c < N, k < K, on CUDA-core FMAs.  A(m, k) = A[m*am + k*ak] in shared
// memory (f32).  B(k, c) = B[k*bk + c*bn]: with kGlobalB a weight in device
// memory (type W), staged through `stage` in kChunkK x kChunkN tiles; else
// f32 in shared memory.  C may live in shared or device memory: this CTA is
// its only writer.  kscale and nscale may be null.  Thread (ty, tx) owns
// rows 4ty..4ty+3 and columns tx + 16j of each 64 x 64 pass.
template <bool kGlobalB, typename W>
__device__ void mm(int M, int N, int K, const float* A, int am, int ak,
                   const W* B, int bk, int bn, float* C, int ldc,
                   bool accumulate, const float* kscale, const float* nscale,
                   float* stage) {
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int m0 = 0; m0 < M; m0 += kRows) {
    for (int c0 = 0; c0 < N; c0 += kChunkN) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      const int kc = kGlobalB ? kChunkK : K;
      for (int k0 = 0; k0 < K; k0 += kc) {
        const int kmax = min(kc, K - k0);
        if constexpr (kGlobalB) {
          __syncthreads();  // the previous tile is consumed
          // walk the tile along B's unit-stride axis for coalesced loads
          for (int e = tid; e < kChunkK * kChunkN; e += kThreads) {
            int kk, cc;
            if (bk == 1) {
              kk = e % kChunkK;
              cc = e / kChunkK;
            } else {
              kk = e / kChunkN;
              cc = e % kChunkN;
            }
            const int k = k0 + kk;
            const int c = c0 + cc;
            stage[kk * kChunkN + cc] =
                (k < K && c < N)
                    ? to_f32(B[static_cast<size_t>(k) * bk +
                               static_cast<size_t>(c) * bn])
                    : 0.f;
          }
          __syncthreads();
        }
        for (int kk = 0; kk < kmax; ++kk) {
          const int k = k0 + kk;
          const float ks = kscale ? kscale[k] : 1.f;
          float a[4], b[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int m = m0 + 4 * ty + i;
            a[i] = m < M ? A[m * am + k * ak] * ks : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + tx + 16 * j;
            if constexpr (kGlobalB)
              b[j] = stage[kk * kChunkN + tx + 16 * j];
            else
              b[j] = c < N ? to_f32(B[k * bk + c * bn]) : 0.f;
          }
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
          const int m = m0 + 4 * ty + i;
          const int c = c0 + tx + 16 * j;
          if (m < M && c < N) {
            const float v = nscale ? acc[i][j] * nscale[c] : acc[i][j];
            float* dst = C + static_cast<size_t>(m) * ldc + c;
            *dst = accumulate ? *dst + v : v;
          }
        }
    }
  }
  __syncthreads();
}

// Round rows < rows, columns < cols of a shared f32 buffer to T in place.
template <typename T>
__device__ void round_buffer(float* buf, int ld, int rows, int cols) {
  if constexpr (!std::is_same<T, float>::value) {
    for (int e = threadIdx.x; e < rows * cols; e += kThreads) {
      float* p = buf + (e / cols) * ld + e % cols;
      *p = round_to<T>(*p);
    }
    __syncthreads();
  }
}
// A strip of dQn (or dKn): rows r0..r0+15 of acc . diag(nscale), held in
// the accumulators of dh / 8 column tiles.  Writes the strip's column sums
// of dQn * u to part[c] (c < dh; for dqg_h) and, for rows r < n, the
// l2-norm backward dQ = rs[r] (dQn sc - u <dQn sc, u> ok[r]) in bf16 to
// out (rows ldo apart).  u: the normalized q (or k) rows, ldu apart.
__device__ __forceinline__ void l2_backward_strip(
    float (&acc)[kHeadTiles][4], int r0, int n, int dh, const float* nscale,
    const float* sc, const float* u, int ldu, const float* rs,
    const float* ok, float* part, __nv_bfloat16* out, int ldo) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  const int ra = r0 + g;
  const int rb = ra + 8;
  const float* ua = u + ra * ldu;
  const float* ub = u + rb * ldu;
  float proj_a = 0.f, proj_b = 0.f;
#pragma unroll
  for (int j = 0; j < kHeadTiles; ++j) {
    if (j < dh / 8) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = 8 * j + 2 * t + e;
        acc[j][e] *= nscale[c];
        acc[j][2 + e] *= nscale[c];
        float cs = acc[j][e] * ua[c] + acc[j][2 + e] * ub[c];
        cs += __shfl_xor_sync(0xffffffffu, cs, 4);
        cs += __shfl_xor_sync(0xffffffffu, cs, 8);
        cs += __shfl_xor_sync(0xffffffffu, cs, 16);
        if (g == 0) part[c] = cs;
        proj_a += acc[j][e] * sc[c] * ua[c];
        proj_b += acc[j][2 + e] * sc[c] * ub[c];
      }
    }
  }
  proj_a += __shfl_xor_sync(0xffffffffu, proj_a, 1);
  proj_a += __shfl_xor_sync(0xffffffffu, proj_a, 2);
  proj_b += __shfl_xor_sync(0xffffffffu, proj_b, 1);
  proj_b += __shfl_xor_sync(0xffffffffu, proj_b, 2);
  proj_a *= ok[ra];
  proj_b *= ok[rb];
#pragma unroll
  for (int j = 0; j < kHeadTiles; ++j) {
    if (j < dh / 8) {
      const int c = 8 * j + 2 * t;
      if (ra < n)
        *reinterpret_cast<uint32_t*>(out + ra * ldo + c) = pack_bf16(
            rs[ra] * (acc[j][0] * sc[c] - ua[c] * proj_a),
            rs[ra] * (acc[j][1] * sc[c + 1] - ua[c + 1] * proj_a));
      if (rb < n)
        *reinterpret_cast<uint32_t*>(out + rb * ldo + c) = pack_bf16(
            rs[rb] * (acc[j][2] * sc[c] - ub[c] * proj_b),
            rs[rb] * (acc[j][3] * sc[c + 1] - ub[c + 1] * proj_b));
    }
  }
}

// Shared-memory plan of one CTA (element strides and byte offsets).  The
// f32 path keeps odd strides, which keep column-strided reads free of bank
// conflicts, and f32 xf, dY, P, Pm|dS and dQ|dK|dV.  kTC keeps xf and dY in
// bf16, dQ|dK|dV and O only in bf16 (for the tensor cores), Pm and dS in
// f32, and the strips' dqg|dkg column sums; its strides keep the wmma tiles
// 32-byte aligned and the fragment reads of a quad on distinct banks.
struct Plan {
  int ldx, ldxf, ldq, ldqh, ldo, ldoh, ldp;
  size_t xf, dy, dxf, qkv, dqkv, dqkv_h, p, ds, d_o, o_h, stage, part, vec,
      bytes;
};

template <bool kTC>
__host__ __device__ Plan make_plan(int dim, int dh) {
  Plan p{};
  p.ldx = kTC ? dim + 8 : dim + 1;    // xf, dY: bf16 with kTC, else f32
  p.ldxf = kTC ? dim + 4 : dim + 1;
  p.ldq = kTC ? 3 * dh + 4 : 3 * dh + 1;
  p.ldqh = 3 * dh + 8;
  p.ldo = kTC ? dh + 4 : dh + 1;
  p.ldoh = dh + 8;
  p.ldp = kTC ? kRows + 4 : kLdS;
  const size_t xbytes = kTC ? 2 : 4;
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = align128(off + bytes);
    return at;
  };
  p.xf = take(kRows * p.ldx * xbytes);
  p.dy = take(kRows * p.ldx * xbytes);
  p.dxf = take(kRows * p.ldxf * sizeof(float));
  p.qkv = take(kRows * p.ldq * sizeof(float));
  p.dqkv = take(kTC ? 0 : kRows * p.ldq * sizeof(float));
  p.dqkv_h = take(kTC ? kRows * p.ldqh * 2 : 0);
  p.p = take(kRows * p.ldp * sizeof(float));   // P; kTC: Pm
  p.ds = take(kRows * p.ldp * sizeof(float));  // Pm, then dS; kTC: dS
  p.d_o = take(kRows * p.ldo * sizeof(float));
  p.o_h = take(kTC ? kRows * p.ldoh * 2 : 0);
  p.stage = take(kTC ? 0 : kChunkK * kChunkN * sizeof(float));
  // kTC: each strip's column sums for dqg_h | dkg_h
  p.part = take(kTC ? kStrips * 2 * kMaxDimHead * sizeof(float) : 0);
  // per-row mean, 1/std, 1/|q|, 1/|k|, |q|^2 > eps, |k|^2 > eps; per-column
  // s_q, s_k, s_q * s_k
  p.vec = take((6 * kRows + 3 * kMaxDimHead) * sizeof(float));
  p.bytes = off;
  return p;
}

// Layout of one f32 gradient slot, and with the weights of the reduced
// output; kTC's slot holds no weight gradients (window_attention_wgrad.cu
// computes them).  floats is padded to a multiple of 8, so that every slot
// starts 32-byte aligned.
struct Slot {
  size_t dwqkv, dwout, dqg, dkg, dbias, floats;
};

__host__ __device__ Slot make_slot(int n, int dim, int heads, int dh,
                                   bool weights) {
  Slot s{};
  s.dwqkv = 0;
  s.dwout = weights ? static_cast<size_t>(heads) * dim * 3 * dh : 0;
  s.dqg = s.dwout + (weights ? static_cast<size_t>(heads) * dh * dim : 0);
  s.dkg = s.dqg + static_cast<size_t>(heads) * dh;
  s.dbias = s.dkg + static_cast<size_t>(heads) * dh;
  s.floats = (s.dbias + static_cast<size_t>(heads) * n * n + 7) / 8 * 8;
  return s;
}

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 1)
    window_attention_bwd_kernel(
        const T* __restrict__ x, const float* __restrict__ gamma,
        const float* __restrict__ beta, const T* __restrict__ wqkv,
        const float* __restrict__ q_gamma, const float* __restrict__ k_gamma,
        const T* __restrict__ wout, const float* __restrict__ bias,
        const T* __restrict__ dy, T* __restrict__ dx,
        float* __restrict__ dgamma_w, float* __restrict__ dbeta_w,
        float* __restrict__ slots, __nv_bfloat16* __restrict__ scratch,
        int bw, int windows_per_cta, int n,
        int dim, int heads, int dh, int windows_per_sample, int has_film,
        unsigned seed, unsigned keep_threshold, float keep_scale) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan plan = make_plan<kTC>(dim, dh);
  const Slot lay = make_slot(n, dim, heads, dh, !kTC);
  const int ldx = plan.ldx;
  const int ldxf = plan.ldxf;
  const int ldq = plan.ldq;
  const int ldqh = plan.ldqh;
  const int ldo = plan.ldo;
  const int ldoh = plan.ldoh;
  const int ldp = plan.ldp;
  // xf and dY: f32 (rounded to T), or bf16 for the tensor cores
  float* xf = reinterpret_cast<float*>(smem + plan.xf);
  float* dys = reinterpret_cast<float*>(smem + plan.dy);
  bf16* xf_h = reinterpret_cast<bf16*>(smem + plan.xf);
  bf16* dy_h = reinterpret_cast<bf16*>(smem + plan.dy);
  float* dxf = reinterpret_cast<float*>(smem + plan.dxf);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);    // u_q|u_k|v
  float* dqkv = reinterpret_cast<float*>(smem + plan.dqkv);  // dQ|dK|dV
  bf16* dqkv_h = reinterpret_cast<bf16*>(smem + plan.dqkv_h);
  float* P = reinterpret_cast<float*>(smem + plan.p);        // kTC: Pm
  float* S2 = reinterpret_cast<float*>(smem + plan.ds);      // Pm, dS
  float* dO = reinterpret_cast<float*>(smem + plan.d_o);
  bf16* o_h = reinterpret_cast<bf16*>(smem + plan.o_h);
  float* stage = reinterpret_cast<float*>(smem + plan.stage);
  float* part = reinterpret_cast<float*>(smem + plan.part);
  float* vec = reinterpret_cast<float*>(smem + plan.vec);
  float* mean_s = vec;
  float* rln_s = vec + kRows;
  float* rq_s = vec + 2 * kRows;                  // rq | rk
  float* ok_s = vec + 4 * kRows;                  // okq | okk
  float* sq_s = vec + 6 * kRows;                  // s_q | s_k | s_q s_k
  float* sk_s = sq_s + kMaxDimHead;
  float* ssk_s = sk_s + kMaxDimHead;
  // kTC: the weight-gradient operands of window_attention_wgrad.cu, rows
  // < n of every window: xf (R, dim), dQ|dK|dV (R, heads * 3dh) and O (R,
  // heads * dh) in bf16, R = bw * n
  bf16* scr_xf = scratch;
  bf16* scr_dqkv = scratch + static_cast<size_t>(bw) * n * dim;
  bf16* scr_o = scr_dqkv + static_cast<size_t>(bw) * n * heads * 3 * dh;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = kThreads / 32;
  const bool dropout = keep_threshold != 0;
  const int n_pad = vgm_hash_n_pad(n);
  const float sqrt_dh = sqrtf(static_cast<float>(dh));

  float* slot = slots + static_cast<size_t>(blockIdx.x) * lay.floats;
  for (size_t e = tid; e < lay.floats; e += kThreads) slot[e] = 0.f;
  if constexpr (kTC) {
    // rows >= n of the bf16 operands are never written: they stay zero
    for (int e = tid; e < kRows * ldqh; e += kThreads)
      dqkv_h[e] = __float2bfloat16(0.f);
    for (int e = tid; e < kRows * ldoh; e += kThreads)
      o_h[e] = __float2bfloat16(0.f);
  }
  __syncthreads();

  const int w_begin = blockIdx.x * windows_per_cta;
  const int w_end = min(bw, w_begin + windows_per_cta);
  for (int win = w_begin; win < w_end; ++win) {
    const T* xw = x + static_cast<size_t>(win) * n * dim;
    const T* dyw = dy + static_cast<size_t>(win) * n * dim;
    const float* g = gamma + static_cast<size_t>(win / windows_per_sample) *
                                 dim;
    const float* bt = beta + static_cast<size_t>(win / windows_per_sample) *
                                 dim;

    // ---- LayerNorm + FiLM recompute, dY, zeroed dXf: one warp per row ----
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
      if (lane == 0) {
        mean_s[r] = mean;
        rln_s[r] = inv;
      }
#pragma unroll
      for (int i = 0; i < kMaxDim / 32; ++i) {
        const int c = lane + 32 * i;
        if (c >= dim) continue;
        float val = 0.f;  // padded token rows stay zero
        float dv = 0.f;
        if (r < n) {
          val = (v[i] - mean) * inv;
          if (has_film) val = val * g[c] + bt[c];
          dv = to_f32(dyw[r * dim + c]);
        }
        if constexpr (kTC) {
          xf_h[r * ldx + c] = __float2bfloat16(val);
          dy_h[r * ldx + c] = __float2bfloat16(dv);
          if (r < n)
            scr_xf[(static_cast<size_t>(win) * n + r) * dim + c] =
                __float2bfloat16(val);
        } else {
          xf[r * ldx + c] = round_to<T>(val);
          dys[r * ldx + c] = dv;
        }
        dxf[r * ldxf + c] = 0.f;
      }
    }
    __syncthreads();

    for (int h = 0; h < heads; ++h) {
      const T* wq = wqkv + static_cast<size_t>(h) * dim * 3 * dh;
      const T* wo = wout + static_cast<size_t>(h) * dh * dim;
      const float* bh = bias + static_cast<size_t>(h) * n * n;
      float* dbias_h = slot + lay.dbias + static_cast<size_t>(h) * n * n;
      float* u_q = qkv;
      float* u_k = qkv + dh;
      float* v = qkv + 2 * dh;

      if constexpr (kTC) {
        // q|k|v = xf . Wqkv_h (Wqkv_h: dim x 3dh, row-major) and dO = dY .
        // Wout_h^T (Wout_h: dh x dim) in one pass; the head's gains are
        // read meanwhile
        float qg = 0.f, kg = 0.f;
        if (tid < dh) {
          qg = q_gamma[h * dh + tid];
          kg = k_gamma[h * dh + tid];
        }
        wmma_mm<wmma::row_major, wmma::row_major>(
            kRows, 3 * dh, dim, xf_h, ldx, wq, 3 * dh, qkv, ldq, false,
            false);
        wmma_mm<wmma::row_major, wmma::col_major>(
            kRows, dh, dim, dy_h, ldx, wo, dim, dO, ldo, false);

        // l2-normalize q and k rows: a quad per (row, q-or-k)
        const int gq = lane >> 2;  // the quad: rows gq and gq + 8 of a strip
        const int tq = lane & 3;   // its columns 2tq, 2tq + 1 of a tile
        for (int t = tid >> 2; t < 2 * kRows; t += kThreads / 4) {
          const int r = t >> 1;
          const int which = t & 1;
          float* vecp = qkv + r * ldq + which * dh;
          float ss = 0.f;
          for (int d = tq; d < dh; d += 4) ss += vecp[d] * vecp[d];
          ss += __shfl_xor_sync(0xffffffffu, ss, 1);
          ss += __shfl_xor_sync(0xffffffffu, ss, 2);
          const float rs = rsqrtf(fmaxf(ss, 1e-24f));
          for (int d = tq; d < dh; d += 4) vecp[d] *= rs;
          if (tq == 0) {
            rq_s[which * kRows + r] = rs;
            ok_s[which * kRows + r] = ss > 1e-24f ? 1.f : 0.f;
          }
        }
        if (tid < dh) {
          sq_s[tid] = sqrt_dh * qg;
          sk_s[tid] = sqrt_dh * kg;
          ssk_s[tid] = sq_s[tid] * sk_s[tid];
        }
        __syncthreads();

        // ---- the n x n products: warp w owns the 16-row strip w % 4 ----
        const int strip = warp % kStrips;
        const bool second = warp >= kStrips;  // dPm, dS, dQn, dKn
        const int r0 = 16 * strip;
        const int nk = (n + 15) / 16;  // 16-row strips (and key steps) < n
        const int dht = dh / 8;        // 8-column tiles of a head
        uint32_t ahi[4], alo[4], bhi[2], blo[2];
        if (strip < nk) {
          // the strip's bias (rows gq and gq + 8: a quad's four lanes
          // share each row), read before the product that waits for it
          const int ra = r0 + gq;
          const int rb = ra + 8;
          float bv[kKeyTiles][4];
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i < 2 ? ra : rb;
              const int c = 8 * j + 2 * tq + (i & 1);
              bv[j][i] = j < 2 * nk && c < n && r < n ? bh[r * n + c] : 0.f;
            }
          }
          // S = qn kn^T for the strip: 2nk tiles of 8 keys
          float s[kKeyTiles][4];
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j)
            s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          for (int k0 = 0; k0 < dh; k0 += 16) {
            frag_a(u_q + r0 * ldq + k0, ldq, ssk_s + k0, ahi, alo);
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j) {
              if (j < 2 * nk) {
                frag_b_t(u_k + 8 * j * ldq + k0, ldq, bhi, blo);
                mma_split_16816(s[j], ahi, alo, bhi, blo);
              }
            }
          }
          // + bias, softmax with this head's own row max
          float ma = -1e30f, mb = -1e30f;
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const int r = i < 2 ? ra : rb;
              const int c = 8 * j + 2 * tq + (i & 1);
              const float val = j < 2 * nk && c < n ? s[j][i] + bv[j][i]
                                                    : -1e30f;
              s[j][i] = val;
              if (i < 2)
                ma = fmaxf(ma, val);
              else
                mb = fmaxf(mb, val);
            }
          }
          ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 1));
          ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, 2));
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
          mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
          float da = 0.f, db = 0.f;
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float e = expf(s[j][i] - (i < 2 ? ma : mb));
              s[j][i] = e;
              if (i < 2)
                da += e;
              else
                db += e;
            }
          }
          da += __shfl_xor_sync(0xffffffffu, da, 1);
          da += __shfl_xor_sync(0xffffffffu, da, 2);
          db += __shfl_xor_sync(0xffffffffu, db, 1);
          db += __shfl_xor_sync(0xffffffffu, db, 2);
          da = 1.f / da;
          db = 1.f / db;
#pragma unroll
          for (int j = 0; j < kKeyTiles; ++j) {
            s[j][0] *= da;
            s[j][1] *= da;
            s[j][2] *= db;
            s[j][3] *= db;
          }
          if (!second) {
            // Pm = P * keep, padded rows zeroed; to shared memory for dV
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j) {
              if (j < 2 * nk) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int r = i < 2 ? ra : rb;
                  const int c = 8 * j + 2 * tq + (i & 1);
                  float keep = 1.f;
                  if (dropout && r < n && c < n)
                    keep = vgm_keep(seed, win, h, r, c, heads, n_pad,
                                    keep_threshold, keep_scale);
                  s[j][i] = r < n ? s[j][i] * keep : 0.f;
                }
                const int c = 8 * j + 2 * tq;
                *reinterpret_cast<float2*>(P + ra * ldp + c) =
                    make_float2(s[j][0], s[j][1]);
                *reinterpret_cast<float2*>(P + rb * ldp + c) =
                    make_float2(s[j][2], s[j][3]);
              }
            }
            // O = Pm . v, rounded to T, rows < n
            float o[kHeadTiles][4];
#pragma unroll
            for (int j = 0; j < kHeadTiles; ++j)
              o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < kStrips; ++kk) {
              if (kk < nk) {
                frag_a_acc(s[2 * kk], s[2 * kk + 1], ahi, alo);
#pragma unroll
                for (int j = 0; j < kHeadTiles; ++j) {
                  if (j < dht) {
                    frag_b(v + 16 * kk * ldq + 8 * j, ldq, bhi, blo);
                    mma_split_16816(o[j], ahi, alo, bhi, blo);
                  }
                }
              }
            }
#pragma unroll
            for (int j = 0; j < kHeadTiles; ++j) {
              if (j < dht) {
                const int c = 8 * j + 2 * tq;
                if (ra < n)
                  *reinterpret_cast<uint32_t*>(o_h + ra * ldoh + c) =
                      pack_bf16(o[j][0], o[j][1]);
                if (rb < n)
                  *reinterpret_cast<uint32_t*>(o_h + rb * ldoh + c) =
                      pack_bf16(o[j][2], o[j][3]);
              }
            }
          } else {
            // the slot's dbias_h of the strip, read before the product
            // that waits for it (into the bias' registers)
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = i < 2 ? ra : rb;
                const int c = 8 * j + 2 * tq + (i & 1);
                bv[j][i] = j < 2 * nk && c < n && r < n ? dbias_h[r * n + c]
                                                        : 0.f;
              }
            }
            // dPm = dO . v^T for the strip
            float dp[kKeyTiles][4];
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j)
              dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
            for (int k0 = 0; k0 < dh; k0 += 16) {
              frag_a(dO + r0 * ldo + k0, ldo, nullptr, ahi, alo);
#pragma unroll
              for (int j = 0; j < kKeyTiles; ++j) {
                if (j < 2 * nk) {
                  frag_b_t(v + 8 * j * ldq + k0, ldq, bhi, blo);
                  mma_split_16816(dp[j], ahi, alo, bhi, blo);
                }
              }
            }
            // dP = dPm * keep (0 on padding); dS = P * (dP - rowsum(dP * P))
            float sa = 0.f, sb = 0.f;
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int r = i < 2 ? ra : rb;
                const int c = 8 * j + 2 * tq + (i & 1);
                float d = 0.f;
                if (j < 2 * nk && r < n && c < n) {
                  d = dp[j][i];
                  if (dropout)
                    d *= vgm_keep(seed, win, h, r, c, heads, n_pad,
                                  keep_threshold, keep_scale);
                }
                dp[j][i] = d;
                if (i < 2)
                  sa += d * s[j][i];
                else
                  sb += d * s[j][i];
              }
            }
            sa += __shfl_xor_sync(0xffffffffu, sa, 1);
            sa += __shfl_xor_sync(0xffffffffu, sa, 2);
            sb += __shfl_xor_sync(0xffffffffu, sb, 1);
            sb += __shfl_xor_sync(0xffffffffu, sb, 2);
            // dbias_h += dS; dS to shared memory for dKn
#pragma unroll
            for (int j = 0; j < kKeyTiles; ++j) {
              if (j < 2 * nk) {
#pragma unroll
                for (int i = 0; i < 4; ++i) {
                  const int r = i < 2 ? ra : rb;
                  const int c = 8 * j + 2 * tq + (i & 1);
                  dp[j][i] = s[j][i] * (dp[j][i] - (i < 2 ? sa : sb));
                  if (r < n && c < n) dbias_h[r * n + c] = bv[j][i] + dp[j][i];
                }
                const int c = 8 * j + 2 * tq;
                *reinterpret_cast<float2*>(S2 + ra * ldp + c) =
                    make_float2(dp[j][0], dp[j][1]);
                *reinterpret_cast<float2*>(S2 + rb * ldp + c) =
                    make_float2(dp[j][2], dp[j][3]);
              }
            }
            // dQn = dS . kn = (dS . u_k) s_k, then dQ's l2-norm backward
            float dq[kHeadTiles][4];
#pragma unroll
            for (int j = 0; j < kHeadTiles; ++j)
              dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;
#pragma unroll
            for (int kk = 0; kk < kStrips; ++kk) {
              if (kk < nk) {
                frag_a_acc(dp[2 * kk], dp[2 * kk + 1], ahi, alo);
#pragma unroll
                for (int j = 0; j < kHeadTiles; ++j) {
                  if (j < dht) {
                    frag_b(u_k + 16 * kk * ldq + 8 * j, ldq, bhi, blo);
                    mma_split_16816(dq[j], ahi, alo, bhi, blo);
                  }
                }
              }
            }
            l2_backward_strip(dq, r0, n, dh, sk_s, sq_s, u_q, ldq, rq_s,
                              ok_s, part + strip * 2 * kMaxDimHead, dqkv_h,
                              ldqh);
          }
        }
        __syncthreads();

        // dV = Pm^T . dO (warp w) and dKn = dS^T . qn (warp w + 4) for the
        // strip's 16 keys, summed over the nk row steps
        if (strip < nk) {
          const float* at = second ? S2 : P;
          const float* b = second ? u_q : dO;
          const int ldb = second ? ldq : ldo;
          float acc[kHeadTiles][4];
#pragma unroll
          for (int j = 0; j < kHeadTiles; ++j)
            acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
          for (int k0 = 0; k0 < 16 * nk; k0 += 16) {
            frag_a_t(at + k0 * ldp + r0, ldp, ahi, alo);
#pragma unroll
            for (int j = 0; j < kHeadTiles; ++j) {
              if (j < dht) {
                frag_b(b + k0 * ldb + 8 * j, ldb, bhi, blo);
                mma_split_16816(acc[j], ahi, alo, bhi, blo);
              }
            }
          }
          if (second) {
            // dKn = (dS^T . u_q) s_q, then dK's l2-norm backward
            l2_backward_strip(acc, r0, n, dh, sq_s, sk_s, u_k, ldq,
                              rq_s + kRows, ok_s + kRows,
                              part + (strip * 2 + 1) * kMaxDimHead,
                              dqkv_h + dh, ldqh);
          } else {
            // dV, rounded to T, rows < n
            const int ra = r0 + gq;
            const int rb = ra + 8;
#pragma unroll
            for (int j = 0; j < kHeadTiles; ++j) {
              if (j < dht) {
                const int c = 2 * dh + 8 * j + 2 * tq;
                if (ra < n)
                  *reinterpret_cast<uint32_t*>(dqkv_h + ra * ldqh + c) =
                      pack_bf16(acc[j][0], acc[j][1]);
                if (rb < n)
                  *reinterpret_cast<uint32_t*>(dqkv_h + rb * ldqh + c) =
                      pack_bf16(acc[j][2], acc[j][3]);
              }
            }
          }
        }
        __syncthreads();

        // dqg_h, dkg_h += sqrt(dh) * the strips' column sums, in strip
        // order; dQ|dK|dV and O of the rows < n to the operand scratch, 16
        // bytes a thread; dXf += [dQ|dK|dV] . Wqkv_h^T.  The next head's
        // first pass writes none of what these read, so no barrier ends the
        // head.
        for (int t = tid; t < 2 * dh; t += kThreads) {
          const int which = t / dh;
          const int d = t % dh;
          float acc = 0.f;
          for (int st = 0; st < nk; ++st)
            acc += part[(st * 2 + which) * kMaxDimHead + d];
          slot[(which ? lay.dkg : lay.dqg) + h * dh + d] += sqrt_dh * acc;
        }
        const int qp = 3 * dh / 8;  // 16-byte pieces of a dQ|dK|dV row
        for (int e = tid; e < n * (qp + dh / 8); e += kThreads) {
          const int r = e / (qp + dh / 8);
          const int c = e % (qp + dh / 8);
          const size_t row = static_cast<size_t>(win) * n + r;
          if (c < qp)
            *reinterpret_cast<uint4*>(scr_dqkv + (row * heads + h) * 3 * dh +
                                      8 * c) =
                *reinterpret_cast<const uint4*>(dqkv_h + r * ldqh + 8 * c);
          else
            *reinterpret_cast<uint4*>(scr_o + (row * heads + h) * dh +
                                      8 * (c - qp)) =
                *reinterpret_cast<const uint4*>(o_h + r * ldoh +
                                                8 * (c - qp));
        }
        wmma_mm<wmma::row_major, wmma::col_major>(
            kRows, dim, 3 * dh, dqkv_h, ldqh, wq, 3 * dh, dxf, ldxf, true,
            false);
      } else {
        // q|k|v = xf . Wqkv_h          (Wqkv_h: dim x 3dh, row-major)
        mm<true>(kRows, 3 * dh, dim, xf, ldx, 1, wq, 3 * dh, 1, qkv, ldq,
                 false, nullptr, nullptr, stage);

        // l2-normalize q and k rows: one warp per (row, q-or-k)
        for (int t = warp; t < 2 * kRows; t += nwarps) {
          const int r = t >> 1;
          const int which = t & 1;
          float* vecp = qkv + r * ldq + which * dh;
          float ss = 0.f;
          for (int d = lane; d < dh; d += 32) ss += vecp[d] * vecp[d];
          ss = warp_sum(ss);
          const float rs = rsqrtf(fmaxf(ss, 1e-24f));
          for (int d = lane; d < dh; d += 32) vecp[d] *= rs;
          if (lane == 0) {
            rq_s[which * kRows + r] = rs;
            ok_s[which * kRows + r] = ss > 1e-24f ? 1.f : 0.f;
          }
        }
        for (int d = tid; d < dh; d += kThreads) {
          const float a = sqrt_dh * q_gamma[h * dh + d];
          const float b = sqrt_dh * k_gamma[h * dh + d];
          sq_s[d] = a;
          sk_s[d] = b;
          ssk_s[d] = a * b;
        }
        __syncthreads();

        float* dwout_h = slot + lay.dwout + static_cast<size_t>(h) * dh * dim;
        float* dwqkv_h =
            slot + lay.dwqkv + static_cast<size_t>(h) * dim * 3 * dh;
        // S = qn . kn^T = u_q diag(s_q s_k) u_k^T
        mm<false>(kRows, kRows, dh, u_q, ldq, 1, u_k, 1, ldq, P, kLdS, false,
                  ssk_s, nullptr, stage);

        // + bias, softmax with this head's own row max; Pm = P * keep
        for (int r = warp; r < kRows; r += nwarps) {
          float* pr = P + r * kLdS;
          float s0 = -1e30f, s1 = -1e30f;
          if (lane < n) s0 = pr[lane] + (r < n ? bh[r * n + lane] : 0.f);
          if (lane + 32 < n)
            s1 = pr[lane + 32] + (r < n ? bh[r * n + lane + 32] : 0.f);
          const float m = warp_max(fmaxf(s0, s1));
          const float e0 = expf(s0 - m);
          const float e1 = expf(s1 - m);
          const float den = warp_sum(e0 + e1);
          const float p0 = e0 / den;
          const float p1 = e1 / den;
          float k0 = 1.f, k1 = 1.f;
          if (dropout && r < n) {
            if (lane < n)
              k0 = vgm_keep(seed, win, h, r, lane, heads, n_pad,
                            keep_threshold, keep_scale);
            if (lane + 32 < n)
              k1 = vgm_keep(seed, win, h, r, lane + 32, heads, n_pad,
                            keep_threshold, keep_scale);
          }
          pr[lane] = p0;
          pr[lane + 32] = p1;
          S2[r * kLdS + lane] = p0 * k0;
          S2[r * kLdS + lane + 32] = p1 * k1;
        }
        __syncthreads();

        // dO = dY . Wout_h^T           (Wout_h: dh x dim, row-major)
        mm<true>(n, dh, dim, dys, ldx, 1, wo, 1, dim, dO, ldo, false,
                 nullptr, nullptr, stage);
        // O = Pm . v, rounded to T, into the dQ slot for now
        mm<false>(n, dh, n, S2, kLdS, 1, v, ldq, 1, dqkv, ldq, false,
                  nullptr, nullptr, stage);
        // dWout_h += O^T . dY
        round_buffer<T>(dqkv, ldq, n, dh);
        mm<false>(dh, dim, n, dqkv, 1, ldq, dys, ldx, 1, dwout_h, dim, true,
                  nullptr, nullptr, stage);
        // dV = Pm^T . dO
        mm<false>(n, dh, n, S2, 1, kLdS, dO, ldo, 1, dqkv + 2 * dh, ldq,
                  false, nullptr, nullptr, stage);
        // dPm = dO . v^T  (over Pm, which is no longer read)
        mm<false>(n, n, dh, dO, ldo, 1, v, 1, ldq, S2, kLdS, false, nullptr,
                  nullptr, stage);

        // dP = dPm * keep; dS = P * (dP - rowsum(dP * P)); dbias_h += dS
        for (int r = warp; r < kRows; r += nwarps) {
          float* sr = S2 + r * kLdS;
          const float* pr = P + r * kLdS;
          float d0 = 0.f, d1 = 0.f;
          if (r < n) {
            if (lane < n) d0 = sr[lane];
            if (lane + 32 < n) d1 = sr[lane + 32];
            if (dropout) {
              if (lane < n)
                d0 *= vgm_keep(seed, win, h, r, lane, heads, n_pad,
                               keep_threshold, keep_scale);
              if (lane + 32 < n)
                d1 *= vgm_keep(seed, win, h, r, lane + 32, heads, n_pad,
                               keep_threshold, keep_scale);
            }
          }
          const float p0 = pr[lane];
          const float p1 = pr[lane + 32];
          const float row = warp_sum(d0 * p0 + d1 * p1);
          const float s0 = p0 * (d0 - row);
          const float s1 = p1 * (d1 - row);
          sr[lane] = s0;
          sr[lane + 32] = s1;
          if (r < n) {
            if (lane < n) dbias_h[r * n + lane] += s0;
            if (lane + 32 < n) dbias_h[r * n + lane + 32] += s1;
          }
        }
        __syncthreads();

        // dQn = dS . kn = (dS . u_k) s_k;  dKn = dS^T . qn = (dS^T . u_q) s_q
        mm<false>(n, dh, n, S2, kLdS, 1, u_k, ldq, 1, dqkv, ldq, false,
                  nullptr, sk_s, stage);
        mm<false>(n, dh, n, S2, 1, kLdS, u_q, ldq, 1, dqkv + dh, ldq, false,
                  nullptr, sq_s, stage);

        // dqg_h += sqrt(dh) sum_rows dQn * u_q (same for k)
        for (int t = tid; t < 2 * dh; t += kThreads) {
          const int which = t / dh;
          const int d = t % dh;
          float acc = 0.f;
          for (int r = 0; r < n; ++r)
            acc += dqkv[r * ldq + which * dh + d] *
                   qkv[r * ldq + which * dh + d];
          slot[(which ? lay.dkg : lay.dqg) + h * dh + d] += sqrt_dh * acc;
        }
        __syncthreads();

        // l2-normalize backward, one warp per (row, q-or-k):
        // dQ = (dU - u <dU, u>) / |q| with dU = dQn s_q
        for (int t = warp; t < 2 * n; t += nwarps) {
          const int r = t >> 1;
          const int which = t & 1;
          float* dr = dqkv + r * ldq + which * dh;
          const float* ur = qkv + r * ldq + which * dh;
          const float* sc = which ? sk_s : sq_s;
          float proj = 0.f;
          for (int d = lane; d < dh; d += 32) proj += dr[d] * sc[d] * ur[d];
          proj = warp_sum(proj) * ok_s[which * kRows + r];
          const float rs = rq_s[which * kRows + r];
          for (int d = lane; d < dh; d += 32)
            dr[d] = round_to<T>(rs * (dr[d] * sc[d] - ur[d] * proj));
        }
        __syncthreads();
        round_buffer<T>(dqkv + 2 * dh, ldq, n, dh);
        // dWqkv_h += xf^T . [dQ|dK|dV];  dXf += [dQ|dK|dV] . Wqkv_h^T
        mm<false>(dim, 3 * dh, n, xf, 1, ldx, dqkv, ldq, 1, dwqkv_h, 3 * dh,
                  true, nullptr, nullptr, stage);
        mm<true>(n, dim, 3 * dh, dqkv, ldq, 1, wq, 1, 3 * dh, dxf, ldxf,
                 true, nullptr, nullptr, stage);
      }
    }
    if constexpr (kTC) __syncthreads();  // the last head's dXf is complete

    // ---- FiLM grads and the LayerNorm VJP ----
    float* dgw = dgamma_w + static_cast<size_t>(win) * dim;
    float* dbw = dbeta_w + static_cast<size_t>(win) * dim;
    for (int c = tid; c < dim; c += kThreads) {
      float sg = 0.f, sb = 0.f;
      if (has_film) {
        for (int r = 0; r < n; ++r) {
          const float xn = (to_f32(xw[r * dim + c]) - mean_s[r]) * rln_s[r];
          const float d = dxf[r * ldxf + c];
          sg += d * xn;
          sb += d;
        }
      }
      dgw[c] = sg;
      dbw[c] = sb;
    }
    T* dxw = dx + static_cast<size_t>(win) * n * dim;
    for (int r = warp; r < n; r += nwarps) {
      float xn[kMaxDim / 32], dn[kMaxDim / 32];
      float s_d = 0.f, s_dx = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxDim / 32; ++i) {
        const int c = lane + 32 * i;
        xn[i] = 0.f;
        dn[i] = 0.f;
        if (c < dim) {
          xn[i] = (to_f32(xw[r * dim + c]) - mean_s[r]) * rln_s[r];
          dn[i] = dxf[r * ldxf + c] * (has_film ? g[c] : 1.f);
        }
        s_d += dn[i];
        s_dx += dn[i] * xn[i];
      }
      const float mean_d = warp_sum(s_d) / dim;
      const float mean_dx = warp_sum(s_dx) / dim;
#pragma unroll
      for (int i = 0; i < kMaxDim / 32; ++i) {
        const int c = lane + 32 * i;
        if (c < dim)
          dxw[r * dim + c] =
              from_f32<T>(rln_s[r] * (dn[i] - mean_d - xn[i] * mean_dx));
      }
    }
    __syncthreads();
  }
}

// out[i] = sum_s slots[s][i], s = 0, 1, ... in order: a fixed summation
// order, so the result does not depend on how the CTAs were scheduled.
__global__ void sum_slots_kernel(const float* __restrict__ slots,
                                 float* __restrict__ out, int num_slots,
                                 size_t floats) {
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       i < floats; i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int s = 0; s < num_slots; ++s) acc += slots[s * floats + i];
    out[i] = acc;
  }
}

template <typename T, bool kTC>
int launch(const void* x, const void* gamma, const void* beta,
           const void* wqkv, const void* q_gamma, const void* k_gamma,
           const void* wout, const void* bias, const void* dy, void* dx,
           void* dgamma_w, void* dbeta_w, void* grads, void* slots,
           void* scratch, int bw, int n, int dim, int heads, int dh,
           int windows_per_sample, int has_film, int num_slots,
           unsigned seed, unsigned threshold, float scale,
           cudaStream_t stream) {
  const size_t smem = make_plan<kTC>(dim, dh).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      window_attention_bwd_kernel<T, kTC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per = (bw + num_slots - 1) / num_slots;
  const int ctas = (bw + per - 1) / per;
  window_attention_bwd_kernel<T, kTC><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const T*>(wqkv),
      static_cast<const float*>(q_gamma), static_cast<const float*>(k_gamma),
      static_cast<const T*>(wout), static_cast<const float*>(bias),
      static_cast<const T*>(dy), static_cast<T*>(dx),
      static_cast<float*>(dgamma_w), static_cast<float*>(dbeta_w),
      static_cast<float*>(slots), static_cast<__nv_bfloat16*>(scratch), bw,
      per, n, dim, heads, dh, windows_per_sample, has_film, seed, threshold,
      scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  // kTC's slots hold the output's dqg | dkg | dbias
  const size_t floats = make_slot(n, dim, heads, dh, !kTC).floats;
  const size_t at = kTC ? make_slot(n, dim, heads, dh, true).dqg : 0;
  const int blocks = static_cast<int>((floats + 255) / 256);
  sum_slots_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(slots), static_cast<float*>(grads) + at, ctas,
      floats);
  return static_cast<int>(cudaGetLastError());
}

bool tensor_core_path(int dim, int dh, int is_bf16) {
  return is_bf16 && dim % 16 == 0 && dh % 16 == 0;
}

}  // namespace

// Floats of `grads`: [dWqkv (heads, dim, 3dh) | dWout (heads, dh, dim) |
// dqg (heads, dh) | dkg (heads, dh) | dbias (heads, n, n) | padding to a
// multiple of 8].
extern "C" long vgm_window_attention_bwd_grad_floats(int n, int dim,
                                                     int heads, int dh) {
  return static_cast<long>(make_slot(n, dim, heads, dh, true).floats);
}

// Floats of one gradient slot: the layout of `grads`, or on the
// tensor-core path its dqg | dkg | dbias alone.
extern "C" long vgm_window_attention_bwd_slot_floats(int n, int dim,
                                                     int heads, int dh,
                                                     int is_bf16) {
  return static_cast<long>(
      make_slot(n, dim, heads, dh, !tensor_core_path(dim, dh, is_bf16))
          .floats);
}

// bf16 elements of the weight-gradient operands the tensor-core path
// writes (xf, dQ|dK|dV, O of the bw * n rows); 0 on the other paths.
extern "C" long vgm_window_attention_bwd_scratch_elems(int bw, int n,
                                                       int dim, int heads,
                                                       int dh, int is_bf16) {
  if (!tensor_core_path(dim, dh, is_bf16)) return 0;
  return static_cast<long>(bw) * n * (dim + 4L * heads * dh);
}

// Shared memory one CTA needs; above 232,448 bytes the shape is refused.
extern "C" long vgm_window_attention_bwd_smem_bytes(int dim, int dh,
                                                    int is_bf16) {
  return static_cast<long>(tensor_core_path(dim, dh, is_bf16)
                               ? make_plan<true>(dim, dh).bytes
                               : make_plan<false>(dim, dh).bytes);
}

// Inputs as for vgm_window_attention_fwd, plus dy (bw, n, dim) in x's type.
// Outputs: dx (bw, n, dim) in x's type; dgamma_w, dbeta_w f32 (bw, dim),
// zero without FiLM; grads f32 in the layout above.  slots: f32 scratch of
// num_slots slots; the kernel runs min(num_slots, bw) CTAs.  All
// contiguous.  bf16 with dim and dh multiples of 16 runs the projections
// and the n x n products on the tensor cores and leaves dWqkv and dWout to
// vgm_window_attention_wgrad: it writes their operands to scratch (bf16, of
// vgm_window_attention_bwd_scratch_elems) and the rest of grads.  Launches
// on `stream` and returns cudaGetLastError().
extern "C" int vgm_window_attention_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* q_gamma, const void* k_gamma, const void* wout,
    const void* bias, const void* dy, void* dx, void* dgamma_w,
    void* dbeta_w, void* grads, void* slots, void* scratch, int bw, int n,
    int dim, int heads, int dh, int windows_per_sample, int has_film,
    int is_bf16, int num_slots, int seed, int keep_threshold,
    float keep_scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 1 || dim > kMaxDim || dh < 1 ||
      dh > kMaxDimHead || num_slots < 1 ||
      vgm_window_attention_bwd_smem_bytes(dim, dh, is_bf16) >
          static_cast<long>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned sd = static_cast<unsigned>(seed);
  const unsigned thr = static_cast<unsigned>(keep_threshold);
  if (tensor_core_path(dim, dh, is_bf16))
    return launch<__nv_bfloat16, true>(
        x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias, dy, dx, dgamma_w,
        dbeta_w, grads, slots, scratch, bw, n, dim, heads, dh,
        windows_per_sample, has_film, num_slots, sd, thr, keep_scale, st);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(
        x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias, dy, dx, dgamma_w,
        dbeta_w, grads, slots, scratch, bw, n, dim, heads, dh,
        windows_per_sample, has_film, num_slots, sd, thr, keep_scale, st);
  return launch<float, false>(
      x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias, dy, dx, dgamma_w,
      dbeta_w, grads, slots, scratch, bw, n, dim, heads, dh,
      windows_per_sample, has_film, num_slots, sd, thr, keep_scale, st);
}
