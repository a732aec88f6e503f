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
// dh 32 and 288 at dh 16, n <= 64; vgm_perhead_attention_route says 1).
// Every product runs on warpgroup MMA (wgmma_common.cuh): a window's rows,
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
#include "wgmma_common.cuh"

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
// fits, n <= 64).  Warpgroup wgi of a CTA runs the CTA's windows wgi,
// wgi + kWarpgroups, ... of each head in turn; the heads are the outer
// loop, so head h's weight tiles and bias rows serve every window of the
// CTA.  Shared memory: two buffers of (Wqkv_h^T tiles, bias_h rows), filled
// by bulk copies a head ahead and completed on an mbarrier each; per
// warpgroup one x buffer (64 rows in core matrices, rows n..63 zero) and
// the kn hi/lo and v^T hi/lo planes that S and P.v read.

constexpr int kWarpgroups = 3;  // consumer warpgroups a CTA
constexpr int kWgmmaThreads = kWarpgroups * wg::kThreads;
constexpr int kBiasLd = 72;     // floats a bias row (n <= 64, padded)
constexpr size_t kMaxSmem = 232448;

struct WgmmaPlan {
  int w_bytes, bias_bytes, x_bytes, kv_bytes;
  size_t w[2], bias[2], wgs, wg_stride, bar, bytes;
};

template <int kDh>
__host__ __device__ WgmmaPlan make_wgmma_plan(int n, int dim) {
  WgmmaPlan p{};
  p.w_bytes = 3 * kDh * dim * 2;
  p.bias_bytes = n * kBiasLd * 4;
  p.x_bytes = kRows * dim * 2;
  p.kv_bytes = kRows * kDh * 2;
  size_t off = 0;
  for (int b = 0; b < 2; ++b) {
    p.w[b] = off;
    off = align128(off + p.w_bytes);
  }
  for (int b = 0; b < 2; ++b) {
    p.bias[b] = off;
    off = align128(off + p.bias_bytes);
  }
  p.wgs = off;
  p.wg_stride = align128(p.x_bytes + 4 * p.kv_bytes);
  off += kWarpgroups * p.wg_stride;
  p.bar = off;  // two mbarriers, then two counters
  p.bytes = align128(off + 2 * sizeof(uint64_t) + 2 * sizeof(unsigned));
  return p;
}

// x: (bw, n, dim) bf16; w_tiles: per head Wqkv_h^T (3dh x dim) in 8 x 8
// core matrices (wg::core_offset); bias_rows: (heads, n, kBiasLd) f32, the
// first n of each row read; out: (bw, n, heads dh) bf16.
template <int kDh>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    perhead_attention_wgmma(const __nv_bfloat16* __restrict__ x,
                            const __nv_bfloat16* __restrict__ w_tiles,
                            const float* __restrict__ bias_rows,
                            __nv_bfloat16* __restrict__ out, int bw, int n,
                            int dim, int heads, int windows_per_cta) {
  constexpr int kQkv = 3 * kDh;  // the qkv product's N
  constexpr int kC = kDh / 8;    // 8-column chunks of q, k or v
  constexpr int kKs = kDh / 16;  // k16 steps of S
  extern __shared__ __align__(128) unsigned char smem[];
  const WgmmaPlan plan = make_wgmma_plan<kDh>(n, dim);
  // the plan's fields the loop reads, as scalars (registers, not a struct)
  const uint32_t w_bytes = plan.w_bytes;
  const uint32_t bias_bytes = plan.bias_bytes;
  const size_t w_at = plan.w[0], w_step = plan.w[1] - plan.w[0];
  const size_t bias_at = plan.bias[0], bias_step = plan.bias[1] - plan.bias[0];
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
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bar);
  unsigned* done = reinterpret_cast<unsigned*>(full + 2);

  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int count = (nw - wgi + kWarpgroups - 1) / kWarpgroups;
  const int inner = heads * kDh;
  const int chunks = dim / 8;

  // rows n..63 of the x buffer stay zero: the copies write rows < n only
  for (int e = lt; e < (kRows - n) * chunks; e += wg::kThreads)
    *reinterpret_cast<uint4*>(
        own + wg::core_offset(n + e / chunks, 8 * (e % chunks), dim)) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    wg::mbar_init(&full[0], 1);
    wg::mbar_init(&full[1], 1);
    wg::mbar_init_fence();
    done[0] = done[1] = 0;
  }
  __syncthreads();

  // head h's weight tiles and bias rows into buffer h & 1 (one thread)
  auto stage = [=](int h) {
    uint64_t* bar = full + (h & 1);
    wg::mbar_expect_bytes(bar, w_bytes + bias_bytes);
    wg::bulk_copy(smem + w_at + (h & 1) * w_step,
                  w_tiles + static_cast<size_t>(h) * kQkv * dim, w_bytes,
                  bar);
    wg::bulk_copy(smem + bias_at + (h & 1) * bias_step,
                  bias_rows + static_cast<size_t>(h) * n * kBiasLd,
                  bias_bytes, bar);
  };
  if (tid == 0) {
    stage(0);
    if (heads > 1) stage(1);
  }

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

  const int steps = heads * count;
  if (count > 0) copy_x(w0 + wgi);
  int s = 0;
  for (int h = 0; h < heads; ++h) {
    const unsigned char* ws = smem + w_at + (h & 1) * w_step;
    const float* bh =
        reinterpret_cast<const float*>(smem + bias_at + (h & 1) * bias_step);
    wg::mbar_wait(&full[h & 1], (h >> 1) & 1);
    for (int j = 0; j < count; ++j, ++s) {
      const int w = w0 + wgi + kWarpgroups * j;
      cp_async_wait<0>();
      wg::fence_proxy_async();
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

      // the l2 norms of q and k (a row's columns lie in one quad)
      float sq[2] = {0.f, 0.f}, sk[2] = {0.f, 0.f};
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
      // kn split into its planes (rows: keys), v^T into its (rows: d).  A
      // v^T row holds neighbouring keys side by side: lanes g and g ^ 1
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
      wg::barrier(1 + wgi);  // the planes are in, the x buffer is free
      if (s + 1 < steps)
        copy_x(j + 1 < count ? w + kWarpgroups : w0 + wgi);
      // section: epilogue

      // S = qn kn^T: hi.hi + hi.lo + lo.hi, m64n64k16, the small ones first
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
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 1));
        mx[half] = fmaxf(mx[half], __shfl_xor_sync(0xffffffffu, mx[half], 2));
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
      __nv_bfloat16* ow = out + static_cast<size_t>(w) * n * inner + h * kDh;
#pragma unroll
      for (int c = 0; c < kC; ++c)
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int r = r0 + 8 * half;
          if (r < n)
            *reinterpret_cast<uint32_t*>(ow + static_cast<size_t>(r) * inner +
                                         8 * c + 2 * t) =
                pack_bf16(o[4 * c + 2 * half], o[4 * c + 2 * half + 1]);
        }
      // section: store
    }
    // the last warpgroup done with head h's buffer refills it with head
    // h + 2's; none waits for the others
    wg::barrier(1 + wgi);
    if (lt == 0) {
      __threadfence_block();
      if (atomicAdd(&done[h & 1], 1u) == kWarpgroups - 1) {
        done[h & 1] = 0;
        if (h + 2 < heads) {
          wg::fence_proxy_async();
          stage(h + 2);
        }
      }
    }
  }
}

template <int kDh>
int launch_wgmma(const void* x, const void* w_tiles, const void* bias_rows,
                 void* out, int bw, int n, int dim, int heads,
                 int windows_per_cta, cudaStream_t stream) {
  const size_t smem = make_wgmma_plan<kDh>(n, dim).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      perhead_attention_wgmma<kDh>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  perhead_attention_wgmma<kDh><<<ctas, kWgmmaThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x),
      static_cast<const __nv_bfloat16*>(w_tiles),
      static_cast<const float*>(bias_rows), static_cast<__nv_bfloat16*>(out),
      bw, n, dim, heads, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

size_t wgmma_smem_bytes(int n, int dim, int dh) {
  return dh == 16 ? make_wgmma_plan<16>(n, dim).bytes
                  : make_wgmma_plan<32>(n, dim).bytes;
}

// The wgmma design takes bf16 at dh 16 or 32, dim a multiple of 16 whose
// plan fits a CTA's shared memory (dim <= 176 at dh 32, <= 288 at dh 16),
// n <= 64.
bool wgmma_takes(int n, int dim, int dh, int is_bf16) {
  return is_bf16 && n >= 1 && n <= kRows && dim >= 16 && dim % 16 == 0 &&
         (dh == 16 || dh == 32) && wgmma_smem_bytes(n, dim, dh) <= kMaxSmem;
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
  if (dh == 16)
    return launch_wgmma<16>(x, w_tiles, bias_rows, out, bw, n, dim, heads,
                            windows_per_cta, st);
  return launch_wgmma<32>(x, w_tiles, bias_rows, out, bw, n, dim, heads,
                          windows_per_cta, st);
}

// The routed design's registers, local bytes a thread, shared memory a CTA
// and CTAs an SM into out[0..3]; returns the route (-1 on failure).
extern "C" int vgm_perhead_attention_occupancy(int n, int dim, int dh,
                                               int is_bf16, int* out) {
  int err;
  const int route = vgm_perhead_attention_route(n, dim, dh, is_bf16);
  if (route == 1)
    err = dh == 16 ? wg::occupancy_of(perhead_attention_wgmma<16>,
                                      wgmma_smem_bytes(n, dim, dh),
                                      kWgmmaThreads, out)
                   : wg::occupancy_of(perhead_attention_wgmma<32>,
                                      wgmma_smem_bytes(n, dim, dh),
                                      kWgmmaThreads, out);
  else if (is_bf16)
    err = occupancy_of(perhead_attention_kernel<__nv_bfloat16, true>,
                       make_perhead_plan<__nv_bfloat16>(dim, dh).bytes, out);
  else
    err = occupancy_of(perhead_attention_kernel<float, false>,
                       make_perhead_plan<float>(dim, dh).bytes, out);
  return err < 0 ? -1 : route;
}
