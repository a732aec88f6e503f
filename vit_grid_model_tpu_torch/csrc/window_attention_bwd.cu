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
// slot of its own (dWqkv, dWout, dqg, dkg, dbias: heads*(4*dim*dh + 2*dh +
// n*n) floats, 2.5 MB at the flagship shape), into which it adds each
// window's per-head products with plain loads and stores.  A second kernel
// sums the slots in slot order.  Two runs of the same inputs therefore give
// bit-identical gradients; no float atomics are used.  The slots cost one
// slot per CTA: ~0.3 GB at the flagship shape with one CTA per SM.
//
// What bounds it on an H100.  One window costs ~190-220 MFLOP at the
// flagship shape (dim 128, 32 heads x 32, n = 53, rows padded to 64), ~3x
// the forward, of which the five projection products (qkv recompute, dO,
// dWout, dWqkv, dXf) are ~83%; one call at Bw = 1,440 is ~0.3 TFLOP, so it
// is bound by arithmetic.  The slot read-modify-writes add ~5 MB of
// traffic per window (~7 GB a call, a few ms of device-memory time).  In
// bf16, with dim and dh multiples of 16, the five projection products run
// on the tensor cores through wmma 16x16x16 tiles with f32 sums (bf16
// operands in shared memory, weight fragments read straight from L2, the
// slot's f32 tiles loaded and stored by the owning warp); the f32 path,
// and everything else, runs 4x4 register tiles of a 16x16 thread grid on
// CUDA-core FMAs (TF32 would not meet the f32 tolerance).  The ~190-200 KB
// of per-window state (xf, dY, dXf, q|k|v, dQ|dK|dV, P, dS, dO) stays in
// shared memory, so one 256-thread CTA runs per SM.  At Bw = 1,440 on an
// NVIDIA H100 80GB HBM3 at 700 W a call took 23.2 ms in bf16 (52.2 ms with
// every product on CUDA cores) and 51.5 ms in f32, against 39.5 and 44.6 ms
// for autograd through the plain version.  Several CTAs per SM, wgmma and
// weight tiles staged by TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "dropout_hash.cuh"

namespace {

namespace wmma = nvcuda::wmma;

constexpr int kLdS = kRows + 1;
constexpr int kChunkK = 32;    // rows of a staged weight tile
constexpr int kChunkN = 64;    // columns of one GEMM pass
constexpr int kMaxDim = 128;
constexpr int kMaxDimHead = 64;
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

// Shared-memory plan of one CTA (element strides and byte offsets).  The
// f32 path keeps odd strides, which keep column-strided reads free of bank
// conflicts.  kTC (bf16, dim and dh multiples of 16) keeps xf and dY only
// in bf16, adds bf16 copies of O and of dQ|dK|dV for the tensor cores, and
// pads the strides that wmma reads or writes to 16-byte multiples.
struct Plan {
  int ldx, ldxf, ldq, ldqh, ldo, ldoh;
  size_t xf, dy, dxf, qkv, dqkv, dqkv_h, p, ds, d_o, o_h, stage, vec, bytes;
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
  p.dqkv = take(kRows * p.ldq * sizeof(float));
  p.dqkv_h = take(kTC ? kRows * p.ldqh * 2 : 0);
  p.p = take(kRows * kLdS * sizeof(float));
  p.ds = take(kRows * kLdS * sizeof(float));
  p.d_o = take(kRows * p.ldo * sizeof(float));
  p.o_h = take(kTC ? kRows * p.ldoh * 2 : 0);
  p.stage = take(kChunkK * kChunkN * sizeof(float));
  // per-row mean, 1/std, 1/|q|, 1/|k|, |q|^2 > eps, |k|^2 > eps; per-column
  // s_q, s_k, s_q * s_k
  p.vec = take((6 * kRows + 3 * kMaxDimHead) * sizeof(float));
  p.bytes = off;
  return p;
}

// Layout of one f32 gradient slot (and of the reduced output); floats is
// padded to a multiple of 8, so that every slot starts 32-byte aligned.
struct Slot {
  size_t dwqkv, dwout, dqg, dkg, dbias, floats;
};

__host__ __device__ Slot make_slot(int n, int dim, int heads, int dh) {
  Slot s{};
  s.dwqkv = 0;
  s.dwout = s.dwqkv + static_cast<size_t>(heads) * dim * 3 * dh;
  s.dqg = s.dwout + static_cast<size_t>(heads) * dh * dim;
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
        float* __restrict__ slots, int bw, int windows_per_cta, int n,
        int dim, int heads, int dh, int windows_per_sample, int has_film,
        unsigned seed, unsigned keep_threshold, float keep_scale) {
  using bf16 = __nv_bfloat16;
  extern __shared__ __align__(128) unsigned char smem[];
  const Plan plan = make_plan<kTC>(dim, dh);
  const Slot lay = make_slot(n, dim, heads, dh);
  const int ldx = plan.ldx;
  const int ldxf = plan.ldxf;
  const int ldq = plan.ldq;
  const int ldqh = plan.ldqh;
  const int ldo = plan.ldo;
  const int ldoh = plan.ldoh;
  // xf and dY: f32 (rounded to T), or bf16 for the tensor cores
  float* xf = reinterpret_cast<float*>(smem + plan.xf);
  float* dys = reinterpret_cast<float*>(smem + plan.dy);
  bf16* xf_h = reinterpret_cast<bf16*>(smem + plan.xf);
  bf16* dy_h = reinterpret_cast<bf16*>(smem + plan.dy);
  float* dxf = reinterpret_cast<float*>(smem + plan.dxf);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);    // u_q|u_k|v
  float* dqkv = reinterpret_cast<float*>(smem + plan.dqkv);  // dQ|dK|dV
  bf16* dqkv_h = reinterpret_cast<bf16*>(smem + plan.dqkv_h);
  float* P = reinterpret_cast<float*>(smem + plan.p);
  float* S2 = reinterpret_cast<float*>(smem + plan.ds);      // Pm, dS
  float* dO = reinterpret_cast<float*>(smem + plan.d_o);
  bf16* o_h = reinterpret_cast<bf16*>(smem + plan.o_h);
  float* stage = reinterpret_cast<float*>(smem + plan.stage);
  float* vec = reinterpret_cast<float*>(smem + plan.vec);
  float* mean_s = vec;
  float* rln_s = vec + kRows;
  float* rq_s = vec + 2 * kRows;                  // rq | rk
  float* ok_s = vec + 4 * kRows;                  // okq | okk
  float* sq_s = vec + 6 * kRows;                  // s_q | s_k | s_q s_k
  float* sk_s = sq_s + kMaxDimHead;
  float* ssk_s = sk_s + kMaxDimHead;

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
      float* u_q = qkv;
      float* u_k = qkv + dh;
      float* v = qkv + 2 * dh;

      // q|k|v = xf . Wqkv_h          (Wqkv_h: dim x 3dh, row-major)
      if constexpr (kTC)
        wmma_mm<wmma::row_major, wmma::row_major>(
            kRows, 3 * dh, dim, xf_h, ldx, wq, 3 * dh, qkv, ldq, false);
      else
        mm<true>(kRows, 3 * dh, dim, xf, ldx, 1, wq, 3 * dh, 1, qkv, ldq,
                 false, nullptr, nullptr, stage);

      // l2-normalize q and k rows: one warp per (row, q-or-k)
      for (int t = warp; t < 2 * kRows; t += nwarps) {
        const int r = t >> 1;
        const int part = t & 1;
        float* vecp = qkv + r * ldq + part * dh;
        float ss = 0.f;
        for (int d = lane; d < dh; d += 32) ss += vecp[d] * vecp[d];
        ss = warp_sum(ss);
        const float rs = rsqrtf(fmaxf(ss, 1e-24f));
        for (int d = lane; d < dh; d += 32) vecp[d] *= rs;
        if (lane == 0) {
          rq_s[part * kRows + r] = rs;
          ok_s[part * kRows + r] = ss > 1e-24f ? 1.f : 0.f;
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

      // S = qn . kn^T = u_q diag(s_q s_k) u_k^T
      mm<false>(kRows, kRows, dh, u_q, ldq, 1, u_k, 1, ldq, P, kLdS, false,
                ssk_s, nullptr, stage);

      // + bias, softmax with this head's own row max; Pm = P * keep
      const float* bh = bias + static_cast<size_t>(h) * n * n;
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
            k0 = vgm_keep(seed, win, h, r, lane, heads, n_pad, keep_threshold,
                          keep_scale);
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
      if constexpr (kTC)
        wmma_mm<wmma::row_major, wmma::col_major>(
            kRows, dh, dim, dy_h, ldx, wo, dim, dO, ldo, false);
      else
        mm<true>(n, dh, dim, dys, ldx, 1, wo, 1, dim, dO, ldo, false,
                 nullptr, nullptr, stage);
      // O = Pm . v, rounded to T, into the dQ slot for now
      mm<false>(n, dh, n, S2, kLdS, 1, v, ldq, 1, dqkv, ldq, false, nullptr,
                nullptr, stage);
      // dWout_h += O^T . dY
      float* dwout_h = slot + lay.dwout + static_cast<size_t>(h) * dh * dim;
      if constexpr (kTC) {
        for (int e = tid; e < n * dh; e += kThreads)
          o_h[(e / dh) * ldoh + e % dh] =
              __float2bfloat16(dqkv[(e / dh) * ldq + e % dh]);
        __syncthreads();
        wmma_mm<wmma::col_major, wmma::row_major>(
            dh, dim, kRows, o_h, ldoh, dy_h, ldx, dwout_h, dim, true);
      } else {
        round_buffer<T>(dqkv, ldq, n, dh);
        mm<false>(dh, dim, n, dqkv, 1, ldq, dys, ldx, 1, dwout_h, dim, true,
                  nullptr, nullptr, stage);
      }
      // dV = Pm^T . dO
      mm<false>(n, dh, n, S2, 1, kLdS, dO, ldo, 1, dqkv + 2 * dh, ldq, false,
                nullptr, nullptr, stage);
      // dPm = dO . v^T  (over Pm, which is no longer read)
      mm<false>(n, n, dh, dO, ldo, 1, v, 1, ldq, S2, kLdS, false, nullptr,
                nullptr, stage);

      // dP = dPm * keep; dS = P * (dP - rowsum(dP * P)); dbias_h += dS
      float* dbias_h = slot + lay.dbias + static_cast<size_t>(h) * n * n;
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
        const int part = t / dh;
        const int d = t % dh;
        float acc = 0.f;
        for (int r = 0; r < n; ++r)
          acc += dqkv[r * ldq + part * dh + d] * qkv[r * ldq + part * dh + d];
        slot[(part ? lay.dkg : lay.dqg) + h * dh + d] += sqrt_dh * acc;
      }
      __syncthreads();

      // l2-normalize backward, one warp per (row, q-or-k):
      // dQ = (dU - u <dU, u>) / |q| with dU = dQn s_q
      for (int t = warp; t < 2 * n; t += nwarps) {
        const int r = t >> 1;
        const int part = t & 1;
        float* dr = dqkv + r * ldq + part * dh;
        const float* ur = qkv + r * ldq + part * dh;
        const float* sc = part ? sk_s : sq_s;
        float proj = 0.f;
        for (int d = lane; d < dh; d += 32) proj += dr[d] * sc[d] * ur[d];
        proj = warp_sum(proj) * ok_s[part * kRows + r];
        const float rs = rq_s[part * kRows + r];
        for (int d = lane; d < dh; d += 32) {
          const float val = rs * (dr[d] * sc[d] - ur[d] * proj);
          if constexpr (kTC)
            dqkv_h[r * ldqh + part * dh + d] = __float2bfloat16(val);
          else
            dr[d] = round_to<T>(val);
        }
      }
      if constexpr (kTC) {
        for (int e = tid; e < n * dh; e += kThreads)
          dqkv_h[(e / dh) * ldqh + 2 * dh + e % dh] =
              __float2bfloat16(dqkv[(e / dh) * ldq + 2 * dh + e % dh]);
        __syncthreads();
        // dWqkv_h += xf^T . [dQ|dK|dV];  dXf += [dQ|dK|dV] . Wqkv_h^T
        wmma_mm<wmma::col_major, wmma::row_major>(
            dim, 3 * dh, kRows, xf_h, ldx, dqkv_h, ldqh,
            slot + lay.dwqkv + static_cast<size_t>(h) * dim * 3 * dh, 3 * dh,
            true);
        wmma_mm<wmma::row_major, wmma::col_major>(
            kRows, dim, 3 * dh, dqkv_h, ldqh, wq, 3 * dh, dxf, ldxf, true);
      } else {
        __syncthreads();
        round_buffer<T>(dqkv + 2 * dh, ldq, n, dh);
        mm<false>(dim, 3 * dh, n, xf, 1, ldx, dqkv, ldq, 1,
                  slot + lay.dwqkv + static_cast<size_t>(h) * dim * 3 * dh,
                  3 * dh, true, nullptr, nullptr, stage);
        mm<true>(n, dim, 3 * dh, dqkv, ldq, 1, wq, 1, 3 * dh, dxf, ldxf,
                 true, nullptr, nullptr, stage);
      }
    }

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
           void* dgamma_w, void* dbeta_w, void* grads, void* slots, int bw,
           int n, int dim, int heads, int dh, int windows_per_sample,
           int has_film, int num_slots, unsigned seed, unsigned threshold,
           float scale, cudaStream_t stream) {
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
      static_cast<float*>(slots), bw, per, n, dim, heads, dh,
      windows_per_sample, has_film, seed, threshold, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const size_t floats = make_slot(n, dim, heads, dh).floats;
  const int blocks = static_cast<int>((floats + 255) / 256);
  sum_slots_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(slots), static_cast<float*>(grads), ctas,
      floats);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Floats of one gradient slot, which is also the size of `grads`:
// [dWqkv (heads, dim, 3dh) | dWout (heads, dh, dim) | dqg (heads, dh) |
//  dkg (heads, dh) | dbias (heads, n, n) | padding to a multiple of 8].
extern "C" long vgm_window_attention_bwd_slot_floats(int n, int dim,
                                                     int heads, int dh) {
  return static_cast<long>(make_slot(n, dim, heads, dh).floats);
}

// Shared memory one CTA needs; above 232,448 bytes the shape is refused.
extern "C" long vgm_window_attention_bwd_smem_bytes(int dim, int dh,
                                                    int is_bf16) {
  const bool tc = is_bf16 && dim % 16 == 0 && dh % 16 == 0;
  return static_cast<long>(tc ? make_plan<true>(dim, dh).bytes
                              : make_plan<false>(dim, dh).bytes);
}

// Inputs as for vgm_window_attention_fwd, plus dy (bw, n, dim) in x's type.
// Outputs: dx (bw, n, dim) in x's type; dgamma_w, dbeta_w f32 (bw, dim),
// zero without FiLM; grads f32 in the slot layout above.  slots: f32
// scratch of num_slots slots; the kernel runs min(num_slots, bw) CTAs.  All
// contiguous.  bf16 with dim and dh multiples of 16 runs the projections
// on the tensor cores.  Launches on `stream` and returns cudaGetLastError().
extern "C" int vgm_window_attention_bwd(
    const void* x, const void* gamma, const void* beta, const void* wqkv,
    const void* q_gamma, const void* k_gamma, const void* wout,
    const void* bias, const void* dy, void* dx, void* dgamma_w,
    void* dbeta_w, void* grads, void* slots, int bw, int n, int dim,
    int heads, int dh, int windows_per_sample, int has_film, int is_bf16,
    int num_slots, int seed, int keep_threshold, float keep_scale,
    void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 1 || dim > kMaxDim || dh < 1 ||
      dh > kMaxDimHead || num_slots < 1 ||
      vgm_window_attention_bwd_smem_bytes(dim, dh, is_bf16) >
          static_cast<long>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned sd = static_cast<unsigned>(seed);
  const unsigned thr = static_cast<unsigned>(keep_threshold);
  if (is_bf16 && dim % 16 == 0 && dh % 16 == 0)
    return launch<__nv_bfloat16, true>(
        x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias, dy, dx, dgamma_w,
        dbeta_w, grads, slots, bw, n, dim, heads, dh, windows_per_sample,
        has_film, num_slots, sd, thr, keep_scale, st);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(
        x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias, dy, dx, dgamma_w,
        dbeta_w, grads, slots, bw, n, dim, heads, dh, windows_per_sample,
        has_film, num_slots, sd, thr, keep_scale, st);
  return launch<float, false>(
      x, gamma, beta, wqkv, q_gamma, k_gamma, wout, bias, dy, dx, dgamma_w,
      dbeta_w, grads, slots, bw, n, dim, heads, dh, windows_per_sample,
      has_film, num_slots, sd, thr, keep_scale, st);
}
