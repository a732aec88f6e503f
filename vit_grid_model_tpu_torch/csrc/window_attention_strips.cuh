// The strip body of the window-attention forward on the tensor cores,
// shared by K1's strip path (window_attention_fwd.cu, one window a CTA),
// R7's (maxvit_layer_attention.cu, a cluster of CTAs a sample-lead, each
// running its windows one after another), the out-projection family's
// (outproj_strips.cuh: outproj_attention.cu's R12, R13, R2 and R8 and
// headpack_attention.cu's R5 and R6, several windows a CTA, one after
// another) and R10's (stacked_softmax_attention.cu, the same without the
// out-projection): the shared-memory plan of one 64-row window tile, and
// one window's rows and attention of every head, y kept in registers and
// handed to the caller's epilogue (or, without the out-projection, each
// head's o_h handed to it).
//
// bf16, dim and dh multiples of 16, dim <= 128, dh <= 32, out_dim (y's
// width) a multiple of 16 <= 128.  The math is window_attention_body.cuh's
// (see window_attention_fwd.cu for the derivation), with three
// compile-time choices for the out-projection family, whose function has
// no LayerNorm, FiLM or q/k gain (outproj_attention.cu): where the rows
// come from (NormRows: LayerNorm + FiLM of the caller's loader, K1 and R7;
// CopyRows: x's bf16 rows copied as they are by cp.async), whether the
// normalized q and k carry sqrt(dh) times the head's gain, and whether
// each n x n product takes its split operands (hi.hi + hi.lo + lo.hi) or
// their high parts alone (R2's casts: the high part is the round-to-
// nearest bf16 of the value, which is the repro's cast).  K1 and R7 take
// rows from NormRows, the gain, the split products and out_dim = dim.  A
// fourth choice, kOutProj, is off for R10's function, R1's (attention with
// no out-projection): no Wout_h is staged (the plan has no wo plane at
// out_dim 0), no y is kept, and once a strip's o_h is whole in the o plane
// its 64 threads hand its rows < n to the epilogue, 16 bytes (8 columns) a
// thread, so that the caller's stores are coalesced vectors.
// The design:
//   - q|k|v = xn . Wqkv_h on mma.sync m16n8k16 tiles: warp w of the 8 owns
//     the 16-row strip w % 4 of the tile, warps w and w + 4 share it; warp
//     w takes its strip's q (w < 4) or k rows and half of its v rows, in
//     independent accumulators, and in their epilogue l2-normalizes the q
//     (or k) rows (the sum of squares across a quad's four lanes), times
//     sqrt(dh) gq_h (or gk_h) with the gain.  qn|kn|v go to shared memory
//     once, each f32 value split into a bf16 high part and the bf16
//     rounding of its remainder (two bf16 planes; the low part only for a
//     split product);
//   - S = qn kn^T and O = P v from the split parts (hi.hi + hi.lo + lo.hi,
//     f32 sums, ~2^-16 relative error), or from the high parts alone (one
//     bf16 product, f32 sums): both warps of a strip compute its
//     scores and softmax in registers (the bias read ahead as the scores'
//     initial sums; the row max and sum across the quad; one reciprocal a
//     row; the dropout keep value on K1-d's counters), then each takes half
//     of O's dh columns, its A fragments the score accumulators themselves,
//     rounded to bf16 where the TPU kernel casts o_h;
//   - y += o . Wout_h: the strip's two warps meet at a named barrier (ids
//     1..4, 64 threads), and each adds the strip's o . Wout_h into its half
//     of the strip's y (out_dim columns), which stays in registers until
//     the epilogue.
// Each head's Wqkv_h and Wout_h are staged in shared memory by cp.async
// ahead of use; a head costs two block barriers (without the
// out-projection the first one's wait for Wout_h finds nothing in
// flight).  Strips wholly past n are skipped; the rows n..63 of a strip
// that is not hold finite values and never reach the epilogue.

#pragma once

#include <cuda_bf16.h>

#include <cstdint>
#include <type_traits>

#include "window_attention_body.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kStrips = kRows / 16;          // 16-row strips of the tile
constexpr int kKeyTiles = kRows / 8;         // 8-key tiles of a score strip
constexpr int kMaxStripDim = 128;            // widest dim of the strip path
constexpr int kMaxStripDimHead = 32;         // widest dh of the strip path
// 8-column tiles of a warp's share of q|k|v: q or k, and half of v (the
// half rounded up to a pair)
constexpr int kQkvTiles = kMaxStripDimHead / 8 + 2;
constexpr int kYTiles = kMaxStripDim / 16;   // 8-column tiles of half of y

// Shared-memory plan of the strip path (element strides, byte offsets):
// the normalized x in bf16 (its offset and stride those of make_plan<true>,
// so that layer_norm_rows fills it); qn|kn|v split into bf16 high and low
// parts, the two planes of the same layout; o = P.v in bf16; the head's
// weights Wqkv_h and Wout_h (dh x out_dim; none at out_dim 0) staged in
// bf16.  The strides keep the rows of a quad's fragment reads and of each
// ldmatrix on distinct banks.
struct StripPlan {
  int ldx, ldh, ldo, ldwq, ldwo;
  size_t xs, hi, lo, o, wq, wo, bytes;
};

__host__ __device__ StripPlan make_strip_plan(int dim, int dh, int out_dim) {
  StripPlan p{};
  p.ldx = dim + 8;
  p.ldh = 3 * dh + 8;
  p.ldo = dh + 8;
  p.ldwq = 3 * dh + 8;
  p.ldwo = out_dim ? out_dim + 8 : 0;  // out_dim 0: no wo plane
  size_t off = 0;
  auto take = [&](size_t bytes) {
    const size_t at = off;
    off = align128(off + bytes);
    return at;
  };
  p.xs = take(kRows * p.ldx * sizeof(bf16));
  p.hi = take(kRows * p.ldh * sizeof(bf16));
  p.lo = take(kRows * p.ldh * sizeof(bf16));
  p.o = take(kRows * p.ldo * sizeof(bf16));
  p.wq = take(static_cast<size_t>(dim) * p.ldwq * sizeof(bf16));
  p.wo = take(static_cast<size_t>(dh) * p.ldwo * sizeof(bf16));
  p.bytes = off;
  return p;
}

// bar.sync on barrier `id` (1..kStrips) for the 64 threads of a strip's
// two warps.
__device__ __forceinline__ void strip_barrier(int id) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(id) : "memory");
}

// The A fragment of rows r..r+15, columns c..c+15 of a bf16 matrix (rows
// ld apart) in shared memory.
__device__ __forceinline__ void frag_a_bf16(const bf16* m, int ld, int r,
                                            int c, uint32_t (&a)[4]) {
  const int g = (threadIdx.x & 31) >> 2;
  const int t = threadIdx.x & 3;
  a[0] = load_u32(m + (r + g) * ld + c + 2 * t);
  a[1] = load_u32(m + (r + g + 8) * ld + c + 2 * t);
  a[2] = load_u32(m + (r + g) * ld + c + 8 + 2 * t);
  a[3] = load_u32(m + (r + g + 8) * ld + c + 8 + 2 * t);
}

// Where a window's rows come from.  NormRows: the LayerNorm + FiLM of
// load(r, c) (the f32 input of row r < n, column c; gamma, beta: the
// window's FiLM rows, read when has_film), rows n..63 written zero.
// CopyRows: rows < n of the (n, dim) bf16 window at x, by cp.async; rows
// n..63 are not written, so the caller zeroes them once before the first
// window (a padded q, k or v row must be finite: 0 x NaN is NaN in P.v).
template <typename Load>
struct NormRows {
  Load load;
  const float* gamma;
  const float* beta;
  int has_film;
};

template <typename Load>
__device__ __forceinline__ NormRows<Load> norm_rows(Load load,
                                                    const float* gamma,
                                                    const float* beta,
                                                    int has_film) {
  return {load, gamma, beta, has_film};
}

struct CopyRows {
  const bf16* x;
};

// One window: head 0's weights in flight while the rows fill the tile,
// then every head, then epilogue(r, c, y[r][c], y[r][c + 1]) once for each
// row r < n and even column c < out_dim, from the thread that holds them
// (the same thread for the same (r, c) in every call).  Every thread is
// past the window's last block barrier when the epilogue runs, and shared
// memory may be refilled by the next call at once.  `win` indexes the
// dropout hash (keep_threshold 0: none).  Named barriers 1..4 are the
// body's.  kQkGain: qn, kn times sqrt(dh) q_gamma_h, k_gamma_h (else
// neither is read); kSplitScore, kSplitAgg: S, O from split operands (else
// from their high parts).  Without kOutProj (plan of out_dim 0; wout and
// out_dim are not read) there is no y: instead, for each head h,
// epilogue(h, r, c, v) once for each row r < n and column c < dh, c a
// multiple of 8, v (a uint4) o_h[r][c..c+7] in bf16, each from one of the
// strip's 64 threads, before the head's last block barrier.
template <bool kQkGain = true, bool kSplitScore = true, bool kSplitAgg = true,
          bool kOutProj = true, typename Rows, typename Epilogue>
__device__ __forceinline__ void attend_window_strips(
    unsigned char* smem, const StripPlan& plan, Rows rows, int n, int dim,
    const bf16* __restrict__ wqkv, const float* __restrict__ q_gamma,
    const float* __restrict__ k_gamma, const bf16* __restrict__ wout,
    const float* __restrict__ bias, int heads, int dh, int out_dim, int win,
    unsigned seed, unsigned keep_threshold, float keep_scale,
    Epilogue epilogue) {
  const int ldh = plan.ldh;
  const int ldo = plan.ldo;
  bf16* xs = reinterpret_cast<bf16*>(smem + plan.xs);
  bf16* hi = reinterpret_cast<bf16*>(smem + plan.hi);  // qn|kn|v, high
  bf16* lo = reinterpret_cast<bf16*>(smem + plan.lo);  // and low parts
  bf16* o_h = reinterpret_cast<bf16*>(smem + plan.o);
  bf16* wq_s = reinterpret_cast<bf16*>(smem + plan.wq);
  bf16* wo_s = reinterpret_cast<bf16*>(smem + plan.wo);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const size_t wq_elems = static_cast<size_t>(dim) * 3 * dh;
  const size_t wo_elems = static_cast<size_t>(dh) * out_dim;

  // head 0's weights in flight while the rows fill xs
  copy_rows_async(wq_s, plan.ldwq, wqkv, 3 * dh, dim, 3 * dh, false);
  if constexpr (kOutProj)
    copy_rows_async(wo_s, plan.ldwo, wout, out_dim, dh, out_dim);
  else
    cp_async_commit();  // Wqkv_0's group
  if constexpr (std::is_same_v<Rows, CopyRows>) {
    copy_rows_async(xs, plan.ldx, rows.x, dim, n, dim);
  } else {
    Plan ln{};
    ln.ldx = plan.ldx;
    ln.xs = plan.xs;
    layer_norm_rows<bf16, true>(smem, ln, rows.load, n, dim, rows.gamma,
                                rows.beta, rows.has_film);
  }
  cp_async_wait<0>();
  __syncthreads();

  const int strip = warp % kStrips;
  const bool second = warp >= kStrips;
  const int r0 = 16 * strip;
  const int nk = (n + 15) / 16;  // 16-row strips (and key steps) < n
  const int gq = lane >> 2;      // the quad: rows gq and gq + 8 of a strip
  const int tq = lane & 3;       // its columns 2tq, 2tq + 1 of a tile
  const int ra = r0 + gq;
  const int rb = ra + 8;
  // this warp's share of q|k|v: k (second) or q, and the upper (second)
  // or lower half of v, as 8-column tiles, the v tiles in whole pairs
  const int qk_tiles = dh / 8;
  const int v_tiles = dh / 16;
  const int qkv_pairs = (qk_tiles + v_tiles + 1) / 2;
  const int c_qk = second ? dh : 0;
  const int c_v = 2 * dh + (second ? dh / 2 : 0);
  const int o_tiles = dh / 16;   // 8-column tiles of O a warp takes
  const int c_o = second ? 8 * o_tiles : 0;
  const int y_tiles = out_dim / 16;  // 8-column tiles of y a warp takes
  const int c_y = second ? 8 * y_tiles : 0;
  // ldmatrix row of this lane in a 16 x 16 block
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = (lane >> 4) * 8;
  const bool dropout = keep_threshold != 0;
  const int n_pad = vgm_hash_n_pad(n);
  const float sqrt_dh = sqrtf(static_cast<float>(dh));

  // the strip's rows of this warp's half of y, as m16n8 accumulators
  float yacc[kYTiles][4];
#pragma unroll
  for (int j = 0; j < kYTiles; ++j)
    yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;

  for (int h = 0; h < heads; ++h) {
    const bool next = h + 1 < heads;
    const float* bh = bias + static_cast<size_t>(h) * n * n;

    float s[kKeyTiles][4];  // the strip's scores, then P

    // this warp's share of the strip's q|k|v = xn . Wqkv_h, then its q (or
    // k) rows l2-normalized (times sqrt(dh) gq_h or gk_h with the gain): qn
    // (or kn) and v, split into bf16 high and low parts (the high part
    // alone for a product that takes no low part)
    if (strip < nk) {
      float acc[kQkvTiles][4];
#pragma unroll
      for (int j = 0; j < kQkvTiles; ++j)
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      for (int k0 = 0; k0 < dim; k0 += 16) {
        uint32_t a[4];
        frag_a_bf16(xs, plan.ldx, r0, k0, a);
#pragma unroll
        for (int p = 0; p < kQkvTiles / 2; ++p) {
          if (p < qkv_pairs) {
            const int j = 2 * p;
            const int c = j < qk_tiles ? c_qk + 8 * j
                                       : c_v + 8 * (j - qk_tiles);
            uint32_t b[4];
            ldmatrix_x4_trans(b, wq_s + (k0 + b_k) * plan.ldwq + c + b_n);
            mma_bf16_16816(acc[j], a, b[0], b[1]);
            mma_bf16_16816(acc[j + 1], a, b[2], b[3]);
          }
        }
      }
      // the strip's bias (rows ra and rb: a quad's four lanes share each
      // row) as the scores' initial sums, in flight until the S product
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i < 2 ? ra : rb;
          const int c = 8 * j + 2 * tq + (i & 1);
          s[j][i] = j < 2 * nk && c < n && r < n ? bh[r * n + c] : 0.f;
        }
      }
      float ssa = 0.f, ssb = 0.f;
#pragma unroll
      for (int j = 0; j < kQkvTiles; ++j) {
        if (j < qk_tiles) {
          ssa += acc[j][0] * acc[j][0] + acc[j][1] * acc[j][1];
          ssb += acc[j][2] * acc[j][2] + acc[j][3] * acc[j][3];
        }
      }
      ssa += __shfl_xor_sync(0xffffffffu, ssa, 1);
      ssa += __shfl_xor_sync(0xffffffffu, ssa, 2);
      ssb += __shfl_xor_sync(0xffffffffu, ssb, 1);
      ssb += __shfl_xor_sync(0xffffffffu, ssb, 2);
      const float rsa = rsqrtf(fmaxf(ssa, 1e-24f));
      const float rsb = rsqrtf(fmaxf(ssb, 1e-24f));
      const float* gain = (second ? k_gamma : q_gamma) + h * dh;
#pragma unroll
      for (int j = 0; j < kQkvTiles; ++j) {
        if (j < qk_tiles + v_tiles) {
          const bool qk = j < qk_tiles;
          const int c = qk ? 8 * j + 2 * tq : 8 * (j - qk_tiles) + 2 * tq;
          float sa0 = 1.f, sa1 = 1.f, sb0 = 1.f, sb1 = 1.f;
          if (qk) {
            if constexpr (kQkGain) {
              const float g0 = sqrt_dh * gain[c];
              const float g1 = sqrt_dh * gain[c + 1];
              sa0 = rsa * g0;
              sa1 = rsa * g1;
              sb0 = rsb * g0;
              sb1 = rsb * g1;
            } else {
              sa0 = sa1 = rsa;
              sb0 = sb1 = rsb;
            }
          }
          const int col = (qk ? c_qk : c_v) + c;
          const bool split = qk ? kSplitScore : kSplitAgg;
          uint32_t h2, l2;
          split_bf16(acc[j][0] * sa0, acc[j][1] * sa1, h2, l2);
          *reinterpret_cast<uint32_t*>(hi + ra * ldh + col) = h2;
          if (split) *reinterpret_cast<uint32_t*>(lo + ra * ldh + col) = l2;
          split_bf16(acc[j][2] * sb0, acc[j][3] * sb1, h2, l2);
          *reinterpret_cast<uint32_t*>(hi + rb * ldh + col) = h2;
          if (split) *reinterpret_cast<uint32_t*>(lo + rb * ldh + col) = l2;
        }
      }
    }
    cp_async_wait<0>();  // Wout_h has landed
    __syncthreads();     // qn|kn|v whole; Wqkv_h free
    // Wqkv_{h+1} in flight until the head's last barrier
    if (next)
      copy_rows_async(wq_s, plan.ldwq, wqkv + (h + 1) * wq_elems, 3 * dh,
                      dim, 3 * dh);

    if (strip < nk) {
      // S = bias + qn kn^T for the strip: 2nk tiles of 8 keys
      uint32_t ahi[4], alo[4];
      for (int k0 = 0; k0 < dh; k0 += 16) {
        frag_a_bf16(hi, ldh, r0, k0, ahi);
        if constexpr (kSplitScore) frag_a_bf16(lo, ldh, r0, k0, alo);
#pragma unroll
        for (int j = 0; j < kKeyTiles; ++j) {
          if (j < 2 * nk) {
            const int at = (8 * j + gq) * ldh + dh + k0 + 2 * tq;
            const uint32_t bhi[2] = {load_u32(hi + at), load_u32(hi + at + 8)};
            if constexpr (kSplitScore) {
              const uint32_t blo[2] = {load_u32(lo + at),
                                       load_u32(lo + at + 8)};
              mma_split_16816(s[j], ahi, alo, bhi, blo);
            } else {
              mma_bf16_16816(s[j], ahi, bhi[0], bhi[1]);
            }
          }
        }
      }
      // -1e30 on padded keys, softmax with this head's own row max, then
      // the dropout keep value on the real (row, col) scores
      float ma = -1e30f, mb = -1e30f;
#pragma unroll
      for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int c = 8 * j + 2 * tq + (i & 1);
          const float val = j < 2 * nk && c < n ? s[j][i] : -1e30f;
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
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = i < 2 ? ra : rb;
          const int c = 8 * j + 2 * tq + (i & 1);
          float p = s[j][i] * (i < 2 ? da : db);
          if (dropout && j < 2 * nk && r < n && c < n)
            p *= vgm_keep(seed, win, h, r, c, heads, n_pad, keep_threshold,
                          keep_scale);
          s[j][i] = p;
        }
      }
      // this warp's half of O = P . v (its columns in one pair of 8-column
      // tiles, the second unused when the half is one tile), rounded to
      // bf16 into o_h
      float o[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < kStrips; ++kk) {
        if (kk < nk) {
          frag_a_acc(s[2 * kk], s[2 * kk + 1], ahi, alo);
          uint32_t vh[4];
          const int at = (16 * kk + b_k) * ldh + 2 * dh + c_o + b_n;
          ldmatrix_x4_trans(vh, hi + at);
          if constexpr (kSplitAgg) {
            uint32_t vl[4];
            ldmatrix_x4_trans(vl, lo + at);
            const uint32_t bh0[2] = {vh[0], vh[1]}, bl0[2] = {vl[0], vl[1]};
            const uint32_t bh1[2] = {vh[2], vh[3]}, bl1[2] = {vl[2], vl[3]};
            mma_split_16816(o[0], ahi, alo, bh0, bl0);
            mma_split_16816(o[1], ahi, alo, bh1, bl1);
          } else {
            mma_bf16_16816(o[0], ahi, vh[0], vh[1]);
            mma_bf16_16816(o[1], ahi, vh[2], vh[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (j < o_tiles) {
          const int c = c_o + 8 * j + 2 * tq;
          *reinterpret_cast<uint32_t*>(o_h + ra * ldo + c) =
              pack_bf16(o[j][0], o[j][1]);
          *reinterpret_cast<uint32_t*>(o_h + rb * ldo + c) =
              pack_bf16(o[j][2], o[j][3]);
        }
      }
      strip_barrier(1 + strip);  // the strip's o is whole

      if constexpr (kOutProj) {
        // y[strip rows, this warp's columns] += o_strip . Wout_h: bf16
        // operands, so one product is exact
        for (int k0 = 0; k0 < dh; k0 += 16) {
          uint32_t a[4];
          frag_a_bf16(o_h, ldo, r0, k0, a);
#pragma unroll
          for (int j = 0; j < kYTiles; j += 2) {
            if (j < y_tiles) {
              uint32_t b[4];
              ldmatrix_x4_trans(
                  b, wo_s + (k0 + b_k) * plan.ldwo + c_y + 8 * j + b_n);
              mma_bf16_16816(yacc[j], a, b[0], b[1]);
              mma_bf16_16816(yacc[j + 1], a, b[2], b[3]);
            }
          }
        }
      } else {
        // the strip's rows < n of o_h to the epilogue: its 64 threads take
        // 8-column chunks in row order, so that a row's chunks go to
        // neighbouring threads
        const int chunks = dh / 8;
        for (int e = lane + (second ? 32 : 0); e < 16 * chunks; e += 64) {
          const int r = r0 + e / chunks;
          const int c = 8 * (e % chunks);
          if (r < n)
            epilogue(h, r, c,
                     *reinterpret_cast<const uint4*>(o_h + r * ldo + c));
        }
      }
    }
    cp_async_wait<0>();  // Wqkv_{h+1} has landed
    __syncthreads();     // qn|kn|v, o and Wout_h are free
    // Wout_{h+1} in flight until the next head's first barrier
    if (kOutProj && next)
      copy_rows_async(wo_s, plan.ldwo, wout + (h + 1) * wo_elems, out_dim,
                      dh, out_dim);
  }

  // y rows < n of this warp's columns, to the epilogue
  if constexpr (kOutProj) {
    if (strip < nk) {
#pragma unroll
      for (int j = 0; j < kYTiles; ++j) {
        if (j < y_tiles) {
          const int c = c_y + 8 * j + 2 * tq;
          if (ra < n) epilogue(ra, c, yacc[j][0], yacc[j][1]);
          if (rb < n) epilogue(rb, c, yacc[j][2], yacc[j][3]);
        }
      }
    }
  }
}

}  // namespace
