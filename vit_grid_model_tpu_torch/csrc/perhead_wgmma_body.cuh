// The per-head kernel's wgmma body for Hopper (sm_90a), shared by R1, R14
// and R9 (perhead_attention.cu), R4 (headmajor_attention.cu) and R3
// (crosshead_norm_attention.cu).  For each window w of n <= 64 tokens and
// each head h, in bf16 operands with f32 sums:
//
//   q | k | v = x_w . Wqkv_h                  (Wqkv_h: dim x 3dh)
//   q <- q * rsqrt(max(sum q^2, 1e-24))       (same for k; no gain, no scale)
//   S = q k^T + bias_h                        (no mask: all n tokens are real)
//   out[w, :, h*dh:(h+1)*dh] = softmax(S) . v (stored as bf16)
//
// Every product runs on warpgroup MMA (wgmma_common.cuh): a window's rows,
// padded to 64 (rows n..63 of x zero, so a padded q or k normalises to 0),
// are one warpgroup's M.  q | k | v is m64n(3dh)k16 with x and Wqkv_h^T
// from shared memory, dim / 16 steps; its epilogue takes the l2 norms,
// keeps qn in registers as the A fragments of S, split into bf16 hi/lo, and
// writes kn and v^T, split, as core-matrix planes.  S = qn kn^T (m64n64k16)
// and O = P v (m64n(dh)k16) keep R1's f32 operands as hi.hi + hi.lo + lo.hi
// with f32 sums; the softmax adds bias_h to rows < n, sets keys j >= n to
// -inf before each row's max, and P's A fragments are S's accumulator
// packed in place (the layout identity in wgmma_common.cuh).
//
// Two compile-time choices make the callers' designs:
//
// * kGroup (G): the heads that one staged x of a window serves.  Warpgroup
//   wgi of a CTA runs steps in the order (head group, window, head in the
//   group) over the CTA's windows wgi, wgi + kWgs, ...: it copies a
//   window's x once for the group (cp.async, as soon as the group's last
//   qkv product has read the one before), then runs each head of the
//   group from it in turn, with the same k-order as G = 1, so a head's
//   output does not depend on G.  Its kn / v^T planes serve head after
//   head.  R1, R14 and R9 are G = 1; R4 and R3 take G = 2 at the repros'
//   widths, which halves the x bytes a window reads from L2 (459 KB of
//   R1's ~620 KB at 32 heads).
// * kIndicatorNorm: R3's norm step.  The sums of squares of q and k are
//   one product of the squared q | k accumulator (64 x 2dh) with the exact
//   0/1 indicator (2dh x 8: column 0 is q's, column 1 k's; v left out), as
//   register-A m64n8k16 steps: each square is split into a bf16 high and
//   low part (rounding it to bf16 would cost ~2^-9 of the norm), so the
//   sum is within ~2^-16 of the f32 one.  The indicator is built once a
//   CTA in shared memory as core matrices (1 KB at dh 32); lane 4 g holds
//   both columns of rows r0 and r0 + 8, and each thread of its quad reads
//   them by a shuffle.  Without it the sums are quad shuffles.  The
//   indicator spans the q | k accumulators that are live together, one
//   head's: two heads' q | k | v accumulators (96 f32) held across the
//   first head's scores, softmax and P.v would pass the 168 registers a
//   thread three warpgroups allow, and a second set of planes does not
//   fit beside three head buffers.
//
// Shared memory: kBufs buffers of (Wqkv_h^T tiles, bias_h rows), head h in
// buffer h % kBufs, each filled by two bulk copies (TMA) and completed on
// its own mbarrier (the k-th fill of a buffer completes its phase k); per
// warpgroup one x buffer and the four n x n operand planes; R3's
// indicator; the kBufs mbarriers and kBufs counters of the warpgroups done
// with a group (group g's is g % kBufs).  The first kBufs heads are staged
// at the start.  The last warpgroup to finish a group refills the group's
// buffers with heads h + kBufs, so no warpgroup waits for another except
// where a group needs a head not yet staged; kBufs >= G keeps a group's
// heads resident together.  A group's first head is staged only when
// every warpgroup is done with the group that held head h - kBufs, so a
// warpgroup runs at most ceil(kBufs / G) - 1 groups ahead of the slowest
// and no two live groups share a counter.  Each warpgroup waits for a
// head's fill before its first window of the group reads it (all of them
// at the group's start at G = 1 or when it has no window), so no read
// precedes its fill and no fill lands in a buffer still being read
// (tests/test_torch_port_grouped_split.py steps through the schedule).
//
// The places marked "// section: <name>" are where
// repros/perhead_sections.py and repros/grouped_sections.py stamp clock64.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

namespace {

constexpr int kBiasLd = 72;     // floats a bias row (n <= 64, padded)
constexpr size_t kMaxSmem = 232448;

struct WgmmaPlan {
  int w_bytes, bias_bytes, x_bytes, kv_bytes;
  size_t w_step, bias_at, bias_step, wgs, wg_stride, ind, bar, bytes;
};

// kBufs head buffers of weight tiles, then kBufs of bias rows, then each
// warpgroup's x and planes, R3's indicator (kInd), kBufs mbarriers and
// kBufs counters; every part 128-byte aligned.
template <int kDh, int kBufs, int kWgs, bool kInd>
__host__ __device__ WgmmaPlan make_wgmma_plan(int n, int dim) {
  WgmmaPlan p{};
  p.w_bytes = 3 * kDh * dim * 2;
  p.bias_bytes = n * kBiasLd * 4;
  p.x_bytes = kRows * dim * 2;
  p.kv_bytes = kRows * kDh * 2;
  p.w_step = align128(p.w_bytes);
  p.bias_at = kBufs * p.w_step;
  p.bias_step = align128(p.bias_bytes);
  p.wgs = p.bias_at + kBufs * p.bias_step;
  p.wg_stride = align128(p.x_bytes + 4 * p.kv_bytes);
  p.ind = p.wgs + kWgs * p.wg_stride;
  p.bar = p.ind + (kInd ? align128(8 * 2 * kDh * 2) : 0);
  p.bytes = align128(p.bar + kBufs * (sizeof(uint64_t) + sizeof(unsigned)));
  return p;
}

template <int kBufs, int kWgs, bool kInd>
size_t wgmma_plan_bytes(int n, int dim, int dh) {
  return dh == 16 ? make_wgmma_plan<16, kBufs, kWgs, kInd>(n, dim).bytes
                  : make_wgmma_plan<32, kBufs, kWgs, kInd>(n, dim).bytes;
}

// The widths the body takes whatever its plan: dh 16 or 32, dim a
// multiple of 16, n <= 64 (the plan must also fit, kMaxSmem).
inline bool wgmma_widths(int n, int dim, int dh) {
  return n >= 1 && n <= kRows && dim >= 16 && dim % 16 == 0 &&
         (dh == 16 || dh == 32);
}

// x: (bw, n, dim) bf16; w_tiles: per head Wqkv_h^T (3dh x dim) in 8 x 8
// core matrices (wg::core_offset); bias_rows: (heads, n, kBiasLd) f32, the
// first n of each row read; out: (bw, n, heads dh) bf16.
template <int kDh, int kGroup, bool kIndicatorNorm, int kBufs, int kWgs>
__global__ void __launch_bounds__(kWgs * wg::kThreads, 1)
    perhead_attention_wgmma(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w_tiles,
                            const float* __restrict__ bias_rows,
                            __nv_bfloat16* __restrict__ out, int bw, int n,
                            int dim, int heads, int windows_per_cta) {
  static_assert(kGroup >= 1 && kGroup <= kBufs, "a group's heads resident");
  constexpr int kQkv = 3 * kDh;  // the qkv product's N
  constexpr int kC = kDh / 8;    // 8-column chunks of q, k or v
  constexpr int kKs = kDh / 16;  // k16 steps of S
  extern __shared__ __align__(128) unsigned char smem[];
  const WgmmaPlan plan =
      make_wgmma_plan<kDh, kBufs, kWgs, kIndicatorNorm>(n, dim);
  // the plan's fields the loop reads, as scalars (registers, not a struct)
  const uint32_t w_bytes = plan.w_bytes;
  const uint32_t bias_bytes = plan.bias_bytes;
  const size_t w_step = plan.w_step;
  const size_t bias_at = plan.bias_at, bias_step = plan.bias_step;
  const int tid = threadIdx.x;
  const int wgi = tid / wg::kThreads;
  const int lt = tid % wg::kThreads;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int r0 = 16 * (lt >> 5) + g;  // this thread's rows r0 and r0 + 8
  unsigned char* own = smem + plan.wgs + wgi * plan.wg_stride;
  unsigned char* kh = own + plan.x_bytes;
  unsigned char* kl = kh + plan.kv_bytes;
  unsigned char* vh = kl + plan.kv_bytes;
  unsigned char* vl = vh + plan.kv_bytes;
  const unsigned char* ind = smem + plan.ind;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bar);
  unsigned* done = reinterpret_cast<unsigned*>(full + kBufs);

  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int count = (nw - wgi + kWgs - 1) / kWgs;
  const int inner = heads * kDh;
  const int chunks = dim / 8;

  // rows n..63 of the x buffer stay zero: the copies write rows < n only
  for (int e = lt; e < (kRows - n) * chunks; e += wg::kThreads)
    *reinterpret_cast<uint4*>(
        own + wg::core_offset(n + e / chunks, 8 * (e % chunks), dim)) =
        make_uint4(0, 0, 0, 0);
  if constexpr (kIndicatorNorm) {
    // the indicator^T (8 x 2dh, K-major): row c is 1 on q's columns (c 0)
    // or k's (c 1)
    for (int e = tid; e < 8 * 2 * kDh; e += kWgs * wg::kThreads) {
      const int c = e / (2 * kDh);
      const int k = e % (2 * kDh);
      *reinterpret_cast<__nv_bfloat16*>(
          smem + plan.ind + wg::core_offset(c, k, 2 * kDh)) =
          __float2bfloat16(c == k / kDh ? 1.f : 0.f);
    }
    wg::fence_proxy_async();
  }
  if (tid == 0) {
    for (int b = 0; b < kBufs; ++b) {
      wg::mbar_init(&full[b], 1);
      done[b] = 0;
    }
    wg::mbar_init_fence();
  }
  __syncthreads();

  // head h's weight tiles and bias rows into buffer h % kBufs (one thread)
  auto stage = [=](int h) {
    const int b = h % kBufs;
    uint64_t* bar = full + b;
    wg::mbar_expect_bytes(bar, w_bytes + bias_bytes);
    wg::bulk_copy(smem + b * w_step,
                  w_tiles + static_cast<size_t>(h) * kQkv * dim, w_bytes,
                  bar);
    wg::bulk_copy(smem + bias_at + b * bias_step,
                  bias_rows + static_cast<size_t>(h) * n * kBiasLd,
                  bias_bytes, bar);
  };
  if (tid == 0)
    for (int h = 0; h < kBufs && h < heads; ++h) stage(h);

  // x of window w; eight threads fill one core matrix's 128 bytes, a warp
  // four neighbours along a row
  auto copy_x = [=](int w) {
    const __nv_bfloat16* src = x + static_cast<size_t>(w) * n * dim;
    for (int r = lt & 7; r < n; r += 8)
      for (int c = lt >> 3; c < chunks; c += wg::kThreads / 8)
        cp_async16(own + wg::core_offset(r, 8 * c, dim),
                   src + static_cast<size_t>(r) * dim + 8 * c);
    cp_async_commit();
  };

  // one x copy a (group, window) step of this warpgroup
  const int steps = (heads + kGroup - 1) / kGroup * count;
  if (count > 0) copy_x(w0 + wgi);
  int s = 0;
  for (int h0 = 0; h0 < heads; h0 += kGroup) {
    // the last group may be ragged
    const int gn = kGroup == 1 ? 1 : min(kGroup, heads - h0);
    const int b0 = h0 % kBufs;  // the group's first head's buffer
    // a group's heads are waited for here at G = 1 or when this warpgroup
    // has no window, else before the first window reads each
    const bool lazy = kGroup > 1 && count > 0;
    if (!lazy)
      for (int gh = 0; gh < gn; ++gh)
        wg::mbar_wait(&full[(h0 + gh) % kBufs], ((h0 + gh) / kBufs) & 1);
    for (int j = 0; j < count; ++j, ++s) {
      const int w = w0 + wgi + kWgs * j;
      for (int gh = 0; gh < gn; ++gh) {
        const int h = h0 + gh;
        const int b = b0 + gh < kBufs ? b0 + gh : b0 + gh - kBufs;
        const unsigned char* ws = smem + b * w_step;
        const float* bh =
            reinterpret_cast<const float*>(smem + bias_at + b * bias_step);
        if (lazy && j == 0) wg::mbar_wait(&full[b], (h / kBufs) & 1);
        if (gh == 0) {
          cp_async_wait<0>();
          wg::fence_proxy_async();
        }
        wg::barrier(1 + wgi);  // x is in; the last step's products are done
        // section: copy wait

        // q | k | v = x_w . Wqkv_h: dim / 16 steps of m64n(3dh)k16
        float acc[kQkv / 2];
        wg::fence();
        for (int kk = 0; kk < dim / 16; ++kk)
          wg::Mma<kQkv>::ss(acc, wg::desc(own + 256 * kk, dim),
                            wg::desc(ws + 256 * kk, dim), kk);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc);
        // section: qkv

        // the l2 norms of q and k, as rsqrt of rows r0 and r0 + 8
        float sq[2] = {0.f, 0.f}, sk[2] = {0.f, 0.f};
        if constexpr (kIndicatorNorm) {
          // squares of q | k (columns 0 .. 2dh - 1), split, as the A
          // fragments of 2dh / 16 k16 steps against the indicator
          uint32_t ah[2 * kKs][4], al[2 * kKs][4];
#pragma unroll
          for (int j2 = 0; j2 < 2 * kKs; ++j2)
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const int i = 8 * j2 + 2 * r;
              split_bf16(acc[i] * acc[i], acc[i + 1] * acc[i + 1],
                         ah[j2][r], al[j2][r]);
            }
          float nrm[4];
          wg::fence();
#pragma unroll
          for (int j2 = 0; j2 < 2 * kKs; ++j2) {
            const uint64_t d = wg::desc(ind + 256 * j2, 2 * kDh);
            wg::Mma<8>::rs(nrm, al[j2], d, j2);
            wg::Mma<8>::rs(nrm, ah[j2], d, 1);
          }
          wg::commit();
          wg::wait<0>();
          wg::fence_regs(nrm);
#pragma unroll
          for (int j2 = 0; j2 < 2 * kKs; ++j2) {
            wg::fence_regs(ah[j2]);
            wg::fence_regs(al[j2]);
          }
          // lane 4 g holds columns 0 (q) and 1 (k) of rows r0, r0 + 8
          const int src = lane & ~3;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sq[i] = rsqrtf(fmaxf(
                __shfl_sync(0xffffffffu, nrm[2 * i], src), 1e-24f));
            sk[i] = rsqrtf(fmaxf(
                __shfl_sync(0xffffffffu, nrm[2 * i + 1], src), 1e-24f));
          }
          // section: indicator norm
        } else {
          // a row's columns lie in one quad
#pragma unroll
          for (int c = 0; c < kC; ++c)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              sq[e >> 1] += acc[4 * c + e] * acc[4 * c + e];
              sk[e >> 1] += acc[4 * (kC + c) + e] * acc[4 * (kC + c) + e];
            }
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 1);
            sq[i] += __shfl_xor_sync(0xffffffffu, sq[i], 2);
            sk[i] += __shfl_xor_sync(0xffffffffu, sk[i], 1);
            sk[i] += __shfl_xor_sync(0xffffffffu, sk[i], 2);
            sq[i] = rsqrtf(fmaxf(sq[i], 1e-24f));
            sk[i] = rsqrtf(fmaxf(sk[i], 1e-24f));
          }
        }
        // qn split as the A fragments of S's k16 steps
        uint32_t qh[kKs][4], ql[kKs][4];
#pragma unroll
        for (int j2 = 0; j2 < kKs; ++j2)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * j2 + 2 * r;
            split_bf16(acc[i] * sq[r & 1], acc[i + 1] * sq[r & 1], qh[j2][r],
                       ql[j2][r]);
          }
        // kn split into its planes (rows: keys), v^T into its (rows: d).
        // A v^T row holds neighbouring keys side by side: lanes g and g ^ 1
        // swap one value, so the even lane stores column d's pair of keys
        // (r, r + 1) and the odd lane column d + 1's (r - 1, r)
        const bool odd = g & 1;
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            const int i = 4 * (kC + c) + 2 * half;
            uint32_t hi, lo;
            split_bf16(acc[i] * sk[half], acc[i + 1] * sk[half], hi, lo);
            const int off = wg::core_offset(r, 8 * c + 2 * t, kDh);
            *reinterpret_cast<uint32_t*>(kh + off) = hi;
            *reinterpret_cast<uint32_t*>(kl + off) = lo;
            const float* v = acc + 4 * (2 * kC + c) + 2 * half;
            const float other =
                __shfl_xor_sync(0xffffffffu, odd ? v[0] : v[1], 4);
            split_bf16(odd ? other : v[0], odd ? v[1] : other, hi, lo);
            const int voff =
                wg::core_offset(8 * c + 2 * t + odd, r - odd, kRows);
            *reinterpret_cast<uint32_t*>(vh + voff) = hi;
            *reinterpret_cast<uint32_t*>(vl + voff) = lo;
          }
        wg::fence_proxy_async();
        wg::barrier(1 + wgi);  // the planes are in; x is free after the
                               // group's last head
        if (gh + 1 == gn && s + 1 < steps)
          copy_x(j + 1 < count ? w + kWgs : w0 + wgi);
        // section: epilogue

        // S = qn kn^T: hi.hi + hi.lo + lo.hi, m64n64k16, the small ones
        // first
        float sc[kRows / 2];
        wg::fence();
#pragma unroll
        for (int j2 = 0; j2 < kKs; ++j2) {
          const uint64_t dhi = wg::desc(kh + 256 * j2, kDh);
          const uint64_t dlo = wg::desc(kl + 256 * j2, kDh);
          wg::Mma<kRows>::rs(sc, ql[j2], dhi, j2);
          wg::Mma<kRows>::rs(sc, qh[j2], dlo, 1);
          wg::Mma<kRows>::rs(sc, qh[j2], dhi, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(sc);
#pragma unroll
        for (int j2 = 0; j2 < kKs; ++j2) {
          wg::fence_regs(qh[j2]);
          wg::fence_regs(ql[j2]);
        }
        // section: scores

        // + bias_h (rows < n), keys >= n at -inf, a row softmax with the
        // head's own max (quad shuffles)
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int c = 0; c < kRows / 8; ++c)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            const int col = 8 * c + 2 * t;
            float2 b = make_float2(0.f, 0.f);
            if (r < n)
              b = *reinterpret_cast<const float2*>(bh + r * kBiasLd + col);
            float& s0 = sc[4 * c + 2 * half];
            float& s1 = sc[4 * c + 2 * half + 1];
            s0 = col < n ? s0 + b.x : -INFINITY;
            s1 = col + 1 < n ? s1 + b.y : -INFINITY;
            mx[half] = fmaxf(mx[half], fmaxf(s0, s1));
          }
        float sum[2] = {0.f, 0.f};
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          mx[half] =
              fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
          mx[half] =
              fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
        }
#pragma unroll
        for (int i = 0; i < kRows / 2; ++i) {
          sc[i] = __expf(sc[i] - mx[(i >> 1) & 1]);
          sum[(i >> 1) & 1] += sc[i];
        }
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 1);
          sum[half] += __shfl_xor_sync(0xffffffffu, sum[half], 2);
          sum[half] = 1.f / sum[half];
        }
        // P split as the A fragments of P.v's k16 steps, from S's
        // accumulator in place
        uint32_t ph[kRows / 16][4], pl[kRows / 16][4];
#pragma unroll
        for (int j2 = 0; j2 < kRows / 16; ++j2)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int i = 8 * j2 + 2 * r;
            split_bf16(sc[i] * sum[r & 1], sc[i + 1] * sum[r & 1], ph[j2][r],
                       pl[j2][r]);
          }
        // section: softmax

        // O = P v: hi.hi + hi.lo + lo.hi, m64n(dh)k16 over the 64 keys
        float o[kDh / 2];
        wg::fence();
#pragma unroll
        for (int j2 = 0; j2 < kRows / 16; ++j2) {
          const uint64_t dhi = wg::desc(vh + 256 * j2, kRows);
          const uint64_t dlo = wg::desc(vl + 256 * j2, kRows);
          wg::Mma<kDh>::rs(o, pl[j2], dhi, j2);
          wg::Mma<kDh>::rs(o, ph[j2], dlo, 1);
          wg::Mma<kDh>::rs(o, ph[j2], dhi, 1);
        }
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(o);
#pragma unroll
        for (int j2 = 0; j2 < kRows / 16; ++j2) {
          wg::fence_regs(ph[j2]);
          wg::fence_regs(pl[j2]);
        }
        // section: P.v

        // out[w, r, h dh + d] for rows r < n
        __nv_bfloat16* ow =
            out + static_cast<size_t>(w) * n * inner + h * kDh;
#pragma unroll
        for (int c = 0; c < kC; ++c)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int r = r0 + 8 * half;
            if (r < n)
              *reinterpret_cast<uint32_t*>(
                  ow + static_cast<size_t>(r) * inner + 8 * c + 2 * t) =
                  pack_bf16(o[4 * c + 2 * half], o[4 * c + 2 * half + 1]);
          }
        // section: store
      }
    }
    // the last warpgroup done with the group refills its buffers with
    // heads h + kBufs; none waits for the others
    wg::barrier(1 + wgi);
    if (lt == 0) {
      __threadfence_block();
      unsigned* d = &done[(h0 / kGroup) % kBufs];
      if (atomicAdd(d, 1u) == kWgs - 1) {
        *d = 0;
        if (h0 + kBufs < heads) {
          wg::fence_proxy_async();
          for (int gh = 0; gh < gn && h0 + gh + kBufs < heads; ++gh)
            stage(h0 + gh + kBufs);
        }
      }
    }
  }
}

template <int kDh, int kGroup, bool kInd, int kBufs, int kWgs>
int launch_wgmma_body(const void* x, const void* w_tiles,
                      const void* bias_rows, void* out, int bw, int n,
                      int dim, int heads, int windows_per_cta,
                      cudaStream_t stream) {
  const size_t smem = make_wgmma_plan<kDh, kBufs, kWgs, kInd>(n, dim).bytes;
  auto kernel = perhead_attention_wgmma<kDh, kGroup, kInd, kBufs, kWgs>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  kernel<<<ctas, kWgs * wg::kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w_tiles),
      static_cast<const float*>(bias_rows), static_cast<__nv_bfloat16*>(out),
      bw, n, dim, heads, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

template <int kGroup, bool kInd, int kBufs, int kWgs>
int launch_wgmma_body_dh(const void* x, const void* w_tiles,
                         const void* bias_rows, void* out, int bw, int n,
                         int dim, int heads, int dh, int windows_per_cta,
                         cudaStream_t stream) {
  return dh == 16 ? launch_wgmma_body<16, kGroup, kInd, kBufs, kWgs>(
                        x, w_tiles, bias_rows, out, bw, n, dim, heads,
                        windows_per_cta, stream)
                  : launch_wgmma_body<32, kGroup, kInd, kBufs, kWgs>(
                        x, w_tiles, bias_rows, out, bw, n, dim, heads,
                        windows_per_cta, stream);
}

template <int kGroup, bool kInd, int kBufs, int kWgs>
int wgmma_body_occupancy(int n, int dim, int dh, int* out) {
  const size_t smem = wgmma_plan_bytes<kBufs, kWgs, kInd>(n, dim, dh);
  return dh == 16
             ? wg::occupancy_of(
                   perhead_attention_wgmma<16, kGroup, kInd, kBufs, kWgs>,
                   smem, kWgs * wg::kThreads, out)
             : wg::occupancy_of(
                   perhead_attention_wgmma<32, kGroup, kInd, kBufs, kWgs>,
                   smem, kWgs * wg::kThreads, out);
}

// ---------------------------------------------------------------------------
// R4's (headmajor_attention.cu) and R3's (crosshead_norm_attention.cu)
// layout: G 1 or 2 heads a staged x, chosen at run time, kGroupWarpgroups
// consumer warpgroups and kGroupBuffers head buffers a CTA (at G = 2 the
// third buffer takes the next group's first head ahead); kInd is R3's
// indicator norm.  Each kernel's exports instantiate these.

constexpr int kGroupWarpgroups = 3;  // consumer warpgroups a CTA
constexpr int kGroupBuffers = 3;     // head buffers a CTA
constexpr int kMaxWgmmaGroup = 2;
static_assert(kMaxWgmmaGroup <= kGroupBuffers, "a group's heads resident");

// Whether a launch at these widths and G takes the grouped design: bf16,
// the body's widths, G 1 or 2, and the plan within a CTA's shared memory.
template <bool kInd>
bool grouped_wgmma_takes(int n, int dim, int dh, int group, int is_bf16) {
  return is_bf16 && group >= 1 && group <= kMaxWgmmaGroup &&
         wgmma_widths(n, dim, dh) &&
         wgmma_plan_bytes<kGroupBuffers, kGroupWarpgroups, kInd>(
             n, dim, dh) <= kMaxSmem;
}

// The grouped design's launch (cudaErrorInvalidValue off its widths).
template <bool kInd>
int launch_grouped_wgmma(const void* x, const void* w_tiles,
                         const void* bias_rows, void* out, int bw, int n,
                         int dim, int heads, int dh, int group,
                         int windows_per_cta, cudaStream_t stream) {
  if (bw < 1 || heads < 1 || windows_per_cta < 1 || group > heads ||
      !grouped_wgmma_takes<kInd>(n, dim, dh, group, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  return group == 1
             ? launch_wgmma_body_dh<1, kInd, kGroupBuffers, kGroupWarpgroups>(
                   x, w_tiles, bias_rows, out, bw, n, dim, heads, dh,
                   windows_per_cta, stream)
             : launch_wgmma_body_dh<2, kInd, kGroupBuffers, kGroupWarpgroups>(
                   x, w_tiles, bias_rows, out, bw, n, dim, heads, dh,
                   windows_per_cta, stream);
}

// The grouped design's registers, local bytes a thread, shared memory a
// CTA and CTAs an SM into out[0..3]; negative on failure.
template <bool kInd>
int grouped_wgmma_occupancy(int n, int dim, int dh, int group, int* out) {
  return group == 1
             ? wgmma_body_occupancy<1, kInd, kGroupBuffers, kGroupWarpgroups>(
                   n, dim, dh, out)
             : wgmma_body_occupancy<2, kInd, kGroupBuffers, kGroupWarpgroups>(
                   n, dim, dh, out);
}

}  // namespace
