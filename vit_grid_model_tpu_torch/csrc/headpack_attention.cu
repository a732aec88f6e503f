// Head-packed window attention with a per-pack out-projection for Hopper
// (sm_90a): R5 and R6.
//
// Replaces, in benchmarks/mosaic_repros/:
//   repro_headpair_lanepack.py::pair_kernel (:54-115, pallas_call :139, R5:
//     two heads a pack);
//   repro_headquad_lanepack.py::group_kernel (:46-106, pallas_call :129, R6:
//     four or eight heads a pack).
// Both compute R1's function plus the out-projection: for each window w of
// n <= 64 tokens, in f32,
//
//   per head h:  q | k | v = x_w . Wqkv_h
//                q <- q * rsqrt(max(sum q^2, 1e-24))     (same for k)
//                o_h = softmax(q k^T + bias_h) . v, rounded to T
//   y[w] = sum over packs p of [o_h | h in p] . Wout[p's K dh rows]
//
// with f32 sums, y stored in out_dtype.  The TPU kernels place a pack's K
// heads' 56-key score rows side by side in the 128 VPU lanes, against
// block-diagonal keys and values (K^2 blocks, K of them live), and shift
// each packed row by the JOINT max of its K heads.  That shift underflows
// when one head's row lies ~87 below another's: its exps are all 0, the row
// is 0/0 = NaN, and the out-projection spreads the NaN to every column.
// This kernel shifts each head's row by its own max (exact, no NaN).  It
// packs no lanes either: a warp already holds a row's 56 scores in 64 lane
// slots (attend_rows), and the block-diagonal products would multiply the
// score and P.v work by K.  What carries over is the rest of the structure:
//   1. the pack's q|k|v = x_w . [Wq | Wk | Wv of its K heads], one product
//      over 3 K dh columns, from R4's per-head weight slices (heads, dim,
//      3 dh), in which a pack's K heads are K consecutive slices, one warp
//      per (16-row tile, head, q|k|v) unit (attention_common.cuh's
//      group_qkv: wmma 16x16x16 bf16 with f32 sums, CUDA-core FMAs in f32);
//      the warp that stores a q or k tile l2-normalizes its rows;
//   2. each head's attention, in f32 on CUDA cores, its bias read from the
//      (heads, n, n) bias:
//      * one pass: warp i runs query rows i, i + 8, ... of each head, four
//        at once (attend_rows: scores in registers, max and sum by shuffles);
//      * two passes: every head's scores + bias first, stacked as 64 x 64
//        f32 tiles (keys >= n at -1e30), then ONE softmax pass over the
//        stacked rows, then P.v for each head;
//   3. o_pack (64, K dh) in T, then y += o_pack . Wout[pack rows] (K dh x
//      out_dim) in one product with f32 sums (wmma bf16 or CUDA-core f32).
//
// What bounds it on an H100: the function's arithmetic, 71.57 MFLOP a window
// at the repros' shape (n = 56, dim 128, 32 heads x 32, out_dim 128), 0.208
// ms at Bw = 2,880 on the bf16 peak against 0.025 ms for the bytes
// (repros/weightsliced_variants.py::bound_ms).  Packing changes neither the
// qkv nor the out-projection FLOPs.
//
// What this design does about it.  A window's f32 y (64 x out_dim) has to
// live across every pack, and a CTA's windows' y do not fit together, so a
// CTA of 256 threads runs its `windows_per_cta` windows (the repros' blk) in
// turn and each window's packs inside, keeping one y in shared memory, as
// outproj_attention.cu does.  x is copied with cp.async, the next window's
// during the last steps of this one; the weights are read from L2 (wmma
// loads from device memory; 1 MB in bf16 at the repros' widths).  A pack's
// K heads' f32 q|k|v (27 KB a head at dh 32) need not fit beside x, y and
// o_pack: steps 1 and 2 run on sub-packs of S heads (S divides K; the
// wrapper takes the largest S that fits), and the out-projection still
// spans the K heads.  In two passes a head's score tile overwrites its own
// q|k, which its scores were the last to read: each thread computes its 16
// scores in registers, a block barrier, then it stores them.  So the stack
// costs no shared memory (q|k is padded to the tile's 16 KB when 2 x 64 x
// (dh + 4) floats are fewer, i.e. dh < 28).
// Shared memory at the repros' widths in bf16: x 17,408 B, y 33,792,
// o_pack 64 x (K dh + 8) bf16, S heads' q|k|v 27,648 each: K = 2 (S = 2)
// 115,712 B, K = 4 (S = 4) 179,200, K = 8 (S = 4) 195,584; one CTA an SM.
// In f32: K = 2 (S = 2) 140,288 B, K = 4 (S = 4) 211,968, K = 8 (S = 2)
// 189,440.  At S = 1 every K would fit two CTAs an SM in bf16 by shared
// memory (83,968 B at K = 1 to 112,640 at K = 8), but the kernel takes more
// than 128 registers a thread (ptxas for sm_90a: 161 in bf16, 167 in f32),
// so it runs one CTA an SM at every S.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kMaxDimHead = 64;
constexpr int kMaxPack = 8;

struct HeadpackPlan {
  int ldx, ldh, ldo, ldy;
  size_t part, xs, qkv, o, y, bytes;
};

// Rows padded by 16 bytes keep every row 16-byte aligned for cp.async and
// every wmma tile 32-byte aligned; q|k|v is R4's head-major (S, 3, 64,
// dh + 4) f32 layout, each part `part` floats.
template <typename T>
__host__ __device__ HeadpackPlan make_headpack_plan(int dim, int dh,
                                                    int out_dim, int k_pack,
                                                    int sub_pack,
                                                    bool two_pass) {
  constexpr int pad = 16 / sizeof(T);
  HeadpackPlan p{};
  p.ldx = dim + pad;
  p.ldh = dh + 4;
  p.ldo = k_pack * dh + pad;
  p.ldy = out_dim + 4;
  p.part = static_cast<size_t>(kRows) * p.ldh;
  if (two_pass && 2 * p.part < kRows * kRows)  // q|k holds the score tile
    p.part = kRows * kRows / 2;
  size_t off = 0;
  p.xs = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.qkv = off;
  off = align128(off + static_cast<size_t>(sub_pack) * 3 * p.part *
                           sizeof(float));
  p.o = off;
  off = align128(off + kRows * p.ldo * sizeof(T));
  p.y = off;
  off = align128(off + kRows * p.ldy * sizeof(float));
  p.bytes = off;
  return p;
}

// Two passes, first: head qh's s = q k^T + bias (q at qh, k at qh + part,
// rows ldh apart; bias rows ldb apart), keys >= n at -1e30, rows >= n
// without bias, stored as a 64 x 64 tile (rows kRows apart) over its own
// q|k.  Thread (ty, tx) of the 16 x 16 grid computes rows 4ty..4ty+3 at
// columns tx + 16j in registers; a block barrier; then the stores.  No
// trailing barrier: the next head's scores read another head's q|k.
__device__ void scores_over_qk(float* qh, size_t part, int ldh, int dh,
                               const float* bh, int ldb, int n) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const float* kh = qh + part;
  float acc[4][4] = {};
  for (int d = 0; d < dh; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qh[(4 * ty + i) * ldh + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = kh[(tx + 16 * j) * ldh + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
  __syncthreads();  // every thread has read this head's q and k
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * ty + i;
      const int c = tx + 16 * j;
      qh[r * kRows + c] =
          c >= n ? -1e30f : acc[i][j] + (r < n ? bh[r * ldb + c] : 0.f);
    }
}

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 1)
    headpack_attention_kernel(const T* __restrict__ x,
                              const T* __restrict__ w,
                              const float* __restrict__ bias,
                              const T* __restrict__ wo,
                              void* __restrict__ out, int bw, int n, int dim,
                              int heads, int dh, int out_dim, int k_pack,
                              int sub_pack, int two_pass,
                              int windows_per_cta, int out_bf16) {
  extern __shared__ __align__(128) unsigned char smem[];
  const HeadpackPlan plan = make_headpack_plan<T>(dim, dh, out_dim, k_pack,
                                                  sub_pack, two_pass);
  const int ldx = plan.ldx;
  const int ldh = plan.ldh;
  const int ldo = plan.ldo;
  const int ldy = plan.ldy;
  T* xs = reinterpret_cast<T*>(smem + plan.xs);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);
  T* o = reinterpret_cast<T*>(smem + plan.o);
  float* y = reinterpret_cast<float*>(smem + plan.y);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int packs = heads / k_pack;
  const int kd = k_pack * dh;  // a pack's q (k, v) columns, its Wout rows
  const int mtiles = (n + 15) / 16;
  const GroupLayout layout{3 * plan.part, plan.part, ldh};
  const size_t wslice = static_cast<size_t>(dim) * 3 * dh;  // a head's w

  // rows n..63 of x and of o_pack stay zero: the copies and the P.v stores
  // write rows < n only
  for (int e = tid; e < (kRows - n) * ldx; e += kThreads)
    xs[n * ldx + e] = from_f32<T>(0.f);
  for (int e = tid; e < (kRows - n) * ldo; e += kThreads)
    o[n * ldo + e] = from_f32<T>(0.f);

  copy_rows_async(xs, ldx, x + static_cast<size_t>(w0) * n * dim, dim, n,
                  dim);
  for (int wi = 0; wi < nw; ++wi) {
    const int wn = w0 + wi;
    for (int j = 0; j < packs; ++j) {
      const T* wpack = w + static_cast<size_t>(j) * k_pack * wslice;
      const float* bpack = bias + static_cast<size_t>(j) * k_pack * n * n;
      for (int s0 = 0; s0 < k_pack; s0 += sub_pack) {
        cp_async_wait<0>();
        __syncthreads();  // x is in; the last reader of q|k|v is done

        // 1. the sub-pack's q|k|v, head-major, q and k l2-normalized
        group_qkv(xs, ldx, wpack + s0 * wslice, wslice, 3 * dh, qkv, layout,
                  mtiles, sub_pack, dim, dh, true);
        __syncthreads();  // q|k|v of the sub-pack are in
        if (j + 1 == packs && s0 + sub_pack == k_pack && wi + 1 < nw)
          copy_rows_async(xs, ldx, x + static_cast<size_t>(wn + 1) * n * dim,
                          dim, n, dim);  // x's last reader is done

        // 2. each head's attention into its columns of o_pack, a per-head
        // row max
        if (!two_pass) {
          for (int g = 0; g < sub_pack; ++g) {
            const int hp = s0 + g;  // the head's place in the pack
            const float* hq = qkv + g * layout.head;
            for (int r = warp; r < n; r += kRowsAtOnce * kWarps)
              attend_rows<T>(hq + r * ldh, static_cast<size_t>(kWarps) * ldh,
                             min(kRowsAtOnce, (n - r + kWarps - 1) / kWarps),
                             hq + layout.part, ldh, hq + 2 * layout.part, ldh,
                             bpack + (hp * n + r) * n,
                             static_cast<size_t>(kWarps) * n, n, dh,
                             o + r * ldo + hp * dh,
                             static_cast<size_t>(kWarps) * ldo);
          }
          continue;
        }
        for (int g = 0; g < sub_pack; ++g)
          scores_over_qk(qkv + g * layout.head, layout.part, ldh, dh,
                         bpack + (s0 + g) * n * n, n, n);
        __syncthreads();  // the sub-pack's score tiles are in
        softmax_rows(qkv, sub_pack, n, layout.head);
        for (int g = 0; g < sub_pack; ++g)
          pv_tile<T>(qkv + g * layout.head, qkv + g * layout.head +
                     2 * layout.part, ldh, n, dh, o + (s0 + g) * dh, ldo);
      }
      __syncthreads();  // o_pack is in

      // 3. y (+)= o_pack . Wout[pack rows]; the first pack overwrites y
      const T* wout_pack = wo + static_cast<size_t>(j) * kd * out_dim;
      if constexpr (kTC)
        wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
            kRows, out_dim, kd, o, ldo, wout_pack, out_dim, y, ldy, j > 0);
      else
        gemm_smem_f32(o, ldo, wout_pack, out_dim, y, ldy, kd, out_dim,
                      j > 0);
    }

    // rows < n of y, in out_dtype (the next window's first write of y comes
    // after the barriers of its first sub-pack)
    const size_t base = static_cast<size_t>(wn) * n * out_dim;
    for (int e = tid; e < n * out_dim; e += kThreads) {
      const float v = y[(e / out_dim) * ldy + e % out_dim];
      if (out_bf16)
        static_cast<__nv_bfloat16*>(out)[base + e] = __float2bfloat16(v);
      else
        static_cast<float*>(out)[base + e] = v;
    }
  }
}

template <typename T, bool kTC>
int launch(const void* x, const void* w, const void* bias, const void* wo,
           void* out, int bw, int n, int dim, int heads, int dh, int out_dim,
           int k_pack, int sub_pack, int two_pass, int windows_per_cta,
           int out_bf16, cudaStream_t stream) {
  const size_t smem = make_headpack_plan<T>(dim, dh, out_dim, k_pack,
                                            sub_pack, two_pass).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      headpack_attention_kernel<T, kTC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  headpack_attention_kernel<T, kTC><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const float*>(bias), static_cast<const T*>(wo), out, bw, n,
      dim, heads, dh, out_dim, k_pack, sub_pack, two_pass, windows_per_cta,
      out_bf16);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of the kernel takes at these widths, K heads a
// pack and S heads a sub-pack, in one pass or two.
extern "C" long vgm_headpack_attention_smem_bytes(int dim, int dh,
                                                  int out_dim, int k_pack,
                                                  int sub_pack, int two_pass,
                                                  int is_bf16) {
  return static_cast<long>(
      is_bf16 ? make_headpack_plan<__nv_bfloat16>(dim, dh, out_dim, k_pack,
                                                  sub_pack, two_pass).bytes
              : make_headpack_plan<float>(dim, dh, out_dim, k_pack, sub_pack,
                                          two_pass).bytes);
}

// x: (bw, n, dim), f32 or bf16 (is_bf16); w: (heads, dim, 3 * dh) in x's
// type, head h's q | k | v weights; bias: f32 (heads, n, n); wo: (heads *
// dh, out_dim) in x's type; out: (bw, n, out_dim), bf16 if out_bf16 else
// f32.  All contiguous.  dim, dh and out_dim are multiples of 16 (dh <=
// 64), n <= 64; k_pack (<= 8) divides heads and sub_pack divides k_pack.
// Pack j is heads j k_pack .. j k_pack + k_pack - 1.  Launches ceil(bw /
// windows_per_cta) CTAs on `stream` and returns cudaGetLastError() (0 on
// success).
extern "C" int vgm_headpack_attention(const void* x, const void* w,
                                      const void* bias, const void* wo,
                                      void* out, int bw, int n, int dim,
                                      int heads, int dh, int out_dim,
                                      int k_pack, int sub_pack, int two_pass,
                                      int windows_per_cta, int is_bf16,
                                      int out_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      out_dim < 16 || out_dim % 16 != 0 || k_pack < 1 || k_pack > kMaxPack ||
      heads % k_pack != 0 || sub_pack < 1 || k_pack % sub_pack != 0 ||
      windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16, true>(x, w, bias, wo, out, bw, n, dim,
                                       heads, dh, out_dim, k_pack, sub_pack,
                                       two_pass, windows_per_cta, out_bf16,
                                       st);
  return launch<float, false>(x, w, bias, wo, out, bw, n, dim, heads, dh,
                              out_dim, k_pack, sub_pack, two_pass,
                              windows_per_cta, out_bf16, st);
}
