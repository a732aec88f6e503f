// Cross-head indicator-norm window attention for Hopper (sm_90a): R3.
//
// Replaces benchmarks/mosaic_repros/repro_crosshead_rmsnorm_gemm.py::kernel
// (:25-59, pallas_call :69, indicator built at :63-66).  It computes R1's
// function: for each window w of n <= 64 tokens and each head h, in f32,
//
//   q | k | v = x_w . Wqkv_h                  (Wqkv_h: dim x 3dh)
//   q <- q * rsqrt(max(sum q^2, 1e-24))       (same for k; v as it is)
//   out[w, :, h*dh:(h+1)*dh] = softmax(q k^T + bias_h) . v   (stored as T)
//
// The TPU kernel takes every head's sums of squares at once, as ONE product
// of the squared (R, 3hd) qkv with a (3hd, 3h) 0/1 block indicator, then
// broadcasts each rsqrt back through the indicator's transpose (a second
// product) and multiplies; v's sums are taken and discarded (:47).
//
// What bounds it on an H100: R1's arithmetic, 56.89 MFLOP a window at the
// repro's shape (n = 56, dim 128, 32 heads x 32), 0.166 ms at Bw = 2,880 on
// the bf16 peak (repros/baseline_perhead.py::bound_ms); the norm's product
// adds no work the function needs.
//
// What this design does about it.  One window's whole q|k|v is 688 KB in
// f32, so the norm runs over a group of G heads, on R4's structure
// (headmajor_attention.cu), with only the norm step swapped; the two
// kernels' times answer the TPU repro's question.  A CTA of 256 threads
// owns `windows_per_cta` windows and loops head groups outside them; each
// (group, window) step:
//   1. the group's q|k|v = x_w . [Wqkv_h for h in the group]
//      (attention_common.cuh's group_qkv: wmma 16x16x16 bf16 with f32 sums,
//      CUDA-core FMAs for f32 inputs), stored row-major as the TPU's (R,
//      3hd) tile restricted to the group: (64, 3 G dh + 4) f32, the group's
//      q columns, then its k columns, then its v columns;
//   2. one block barrier; then the norm.  The (64, 2G) sums of squares of
//      q and k are one product of the squared (64, 2 G dh) q|k with the
//      (2 G dh, 2G) 0/1 indicator (v left out: the repro discards v's
//      sums), cut into (16-row tile, q or k) blocks, a warp each.  In
//      bf16 it runs on the tensor cores (mma.sync m16n8k16, f32 sums);
//      rounding the f32 squares to bf16 would cost ~2^-9 of the norm, so
//      each square is split into a bf16 high part and a bf16 remainder,
//      and two products run against the exact 0/1 indicator.  Its A fragments are built from the f32 q|k
//      in registers and its B fragments (the indicator) computed in
//      registers, so nothing is staged.  f32 inputs run the product on
//      CUDA-core FMAs, where each (row, vector) sum meets the indicator's
//      one nonzero block only (TF32 would miss the f32 tolerance).  The
//      broadcast back through the indicator's transpose selects one rsqrt
//      per column, so on this card it is that indexed multiply, by the
//      warp that took the sums, not a second product;
//   3. one block barrier; then attention_common.cuh's attend_group, as R4:
//      warp i runs query rows i, i + 8, ... of each head of the group,
//      four at once (attend_rows).
// Three block barriers a step, one more than R4's.
// Shared memory at the repro's widths in bf16: two x buffers 2 x 17,408 B,
// G weight slices of 26,624 B, the group's q|k|v (64 x (96 G + 4) f32) and
// the rsqrts (64 x 2G f32): 87,552 B at G = 1, two CTAs an SM (the
// wrapper's pick, as R4's), and 139,264 B at G = 2, one.  In f32 G = 1
// takes 144,896 B and G = 2 221,184 B.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"

namespace {

constexpr int kMaxDimHead = 64;
constexpr int kMaxGroup = 8;  // 2G <= 16 vectors: two n-tiles of 8

struct CrossheadPlan {
  int ldx, ldw, ldr;
  size_t xs0, xs1, ws, qkv, inv, bytes;
};

template <typename T>
__host__ __device__ CrossheadPlan make_crosshead_plan(int dim, int dh,
                                                      int group) {
  constexpr int pad = 16 / sizeof(T);
  CrossheadPlan p{};
  p.ldx = dim + pad;
  p.ldw = 3 * dh + pad;
  p.ldr = 3 * group * dh + 4;
  size_t off = 0;
  p.xs0 = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.xs1 = off;
  off = align128(off + kRows * p.ldx * sizeof(T));
  p.ws = off;
  off = align128(off + static_cast<size_t>(group) * dim * p.ldw * sizeof(T));
  p.qkv = off;
  off = align128(off + static_cast<size_t>(kRows) * p.ldr * sizeof(float));
  p.inv = off;
  off = align128(off + static_cast<size_t>(kRows) * 2 * group *
                           sizeof(float));
  p.bytes = off;
  return p;
}

// The sums of squares of one row tile's q (part 0) or k (part 1) vectors
// (rows ldr apart; vector j of the 2G at columns j * dh) against the 0/1
// indicator, as rsqrt(max(sum, 1e-24)) into inv (2G a row).  Vectors of
// heads >= gn are skipped (a ragged last group).  One warp.
template <typename T>
__device__ void indicator_norm_sums(const float* rows, int ldr, int group,
                                    int gn, int dh, int part, float* inv) {
  const int lane = threadIdx.x & 31;
  const int nv = 2 * group;
  const int j0 = part * group;  // the part's vectors: j0 .. j0 + G - 1
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int g = lane >> 2;
    const int t = lane & 3;
    const float* r0 = rows + g * ldr;
    const float* r1 = rows + (g + 8) * ldr;
    for (int nt = 0; nt < (nv + 7) / 8; ++nt) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      for (int k0 = j0 * dh; k0 < (j0 + group) * dh; k0 += 16) {
        const int j = k0 / dh;  // the vector of this k-step (dh % 16 == 0)
        if (j % group >= gn) continue;
        // the indicator's 16 x 8 tile: column nt * 8 + g is 1 on vector j
        const uint32_t b = nt * 8 + g == j ? pack_bf16(1.f, 1.f) : 0u;
        const float2 s[4] = {
            *reinterpret_cast<const float2*>(r0 + k0 + 2 * t),
            *reinterpret_cast<const float2*>(r1 + k0 + 2 * t),
            *reinterpret_cast<const float2*>(r0 + k0 + 2 * t + 8),
            *reinterpret_cast<const float2*>(r1 + k0 + 2 * t + 8)};
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float x = s[i].x * s[i].x;
          const float y = s[i].y * s[i].y;
          const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
          hi[i] = *reinterpret_cast<const uint32_t*>(&h);
          lo[i] = pack_bf16(x - __low2float(h), y - __high2float(h));
        }
        mma_bf16_16816(c, hi, b, b);
        mma_bf16_16816(c, lo, b, b);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = nt * 8 + 2 * t + (i & 1);
        const int r = g + (i >> 1) * 8;
        if (col >= j0 && col < j0 + group)
          inv[r * nv + col] = rsqrtf(fmaxf(c[i], 1e-24f));
      }
    }
  } else {
    for (int e = lane; e < 16 * group; e += 32) {
      const int r = e / group;
      const int j = j0 + e % group;
      if (j % group >= gn) continue;
      const float* vec = rows + r * ldr + j * dh;
      float ss = 0.f;
      for (int d = 0; d < dh; ++d) ss = fmaf(vec[d], vec[d], ss);
      inv[r * nv + j] = rsqrtf(fmaxf(ss, 1e-24f));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    crosshead_norm_kernel(const T* __restrict__ x, const T* __restrict__ wqkv,
                          const float* __restrict__ bias, T* __restrict__ out,
                          int bw, int n, int dim, int heads, int dh,
                          int group, int windows_per_cta) {
  extern __shared__ __align__(128) unsigned char smem[];
  const CrossheadPlan plan = make_crosshead_plan<T>(dim, dh, group);
  const int ldx = plan.ldx;
  const int ldw = plan.ldw;
  const int ldr = plan.ldr;
  T* xs[2] = {reinterpret_cast<T*>(smem + plan.xs0),
              reinterpret_cast<T*>(smem + plan.xs1)};
  T* ws = reinterpret_cast<T*>(smem + plan.ws);
  float* qkv = reinterpret_cast<float*>(smem + plan.qkv);
  float* inv = reinterpret_cast<float*>(smem + plan.inv);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int w0 = blockIdx.x * windows_per_cta;
  const int nw = min(windows_per_cta, bw - w0);  // the last tile is ragged
  const int inner = heads * dh;
  const int groups = (heads + group - 1) / group;  // the last may be ragged
  const int mtiles = (n + 15) / 16;
  const int nv = 2 * group;
  const size_t wslice = static_cast<size_t>(dim) * ldw;  // one head's slice
  // row-major (64, 3 G dh + 4): head g's q at column g dh, its k at
  // (G + g) dh, its v at (2G + g) dh
  const GroupLayout layout{static_cast<size_t>(dh),
                           static_cast<size_t>(group) * dh, ldr};

  // rows n..63 of both x buffers stay zero: the copies write rows < n only,
  // so the padded rows of q, k and v come out zero (and their norms 0)
  for (int e = tid; e < (kRows - n) * ldx; e += kThreads) {
    xs[0][n * ldx + e] = from_f32<T>(0.f);
    xs[1][n * ldx + e] = from_f32<T>(0.f);
  }

  // step it = (group it / nw, window it % nw), as R4's kernel
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

    // 1. the group's q|k|v, row-major
    group_qkv(xw, ldx, ws, wslice, ldw, qkv, layout, mtiles, gn, dim, dh,
              false);
    __syncthreads();  // q|k|v of the group are in

    // 2. warp (part, row tile): the tile's q (part 0) or k (part 1) sums of
    // squares through the indicator, then each of their columns times its
    // vector's rsqrt
    for (int u = warp; u < 2 * mtiles; u += kWarps) {
      const int mt = u % mtiles;
      const int part = u / mtiles;
      float* rows = qkv + static_cast<size_t>(mt) * 16 * ldr;
      float* tinv = inv + mt * 16 * nv;
      indicator_norm_sums<T>(rows, ldr, group, gn, dh, part, tinv);
      __syncwarp();
      for (int c = part * group * dh + lane; c < (part + 1) * group * dh;
           c += 32) {  // lane l: columns l + 32i of the part
        const int j = c / dh;
        if (j % group >= gn) continue;
#pragma unroll 4
        for (int r = 0; r < 16; ++r) rows[r * ldr + c] *= tinv[r * nv + j];
      }
    }
    __syncthreads();  // q and k are normalized

    // 3. warp i runs query rows i, i + 8, ... of every head of the group
    attend_group<T>(qkv, layout, gn, h0, bias, n, dh,
                    out + static_cast<size_t>(w) * n * inner, inner);
  }
}

template <typename T>
int launch(const void* x, const void* wqkv, const void* bias, void* out,
           int bw, int n, int dim, int heads, int dh, int group,
           int windows_per_cta, cudaStream_t stream) {
  const size_t smem = make_crosshead_plan<T>(dim, dh, group).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      crosshead_norm_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ctas = (bw + windows_per_cta - 1) / windows_per_cta;
  crosshead_norm_kernel<T><<<ctas, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(wqkv),
      static_cast<const float*>(bias), static_cast<T*>(out), bw, n, dim,
      heads, dh, group, windows_per_cta);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory one CTA of the kernel takes at these widths and G.
extern "C" long vgm_crosshead_norm_attention_smem_bytes(int dim, int dh,
                                                        int group,
                                                        int is_bf16) {
  return static_cast<long>(
      is_bf16 ? make_crosshead_plan<__nv_bfloat16>(dim, dh, group).bytes
              : make_crosshead_plan<float>(dim, dh, group).bytes);
}

// x: (bw, n, dim) and out: (bw, n, heads*dh), f32 or bf16 (is_bf16);
// wqkv: (heads, dim, 3*dh) in x's type, each head's q | k | v columns;
// bias: f32 (heads, n, n).  All contiguous.  dim and dh are multiples of 16
// (dh <= 64), n <= 64; `group` heads a step (<= 8; the last group may hold
// fewer).  Launches ceil(bw / windows_per_cta) CTAs on `stream` and returns
// cudaGetLastError() (0 on success).
extern "C" int vgm_crosshead_norm_attention(const void* x, const void* wqkv,
                                            const void* bias, void* out,
                                            int bw, int n, int dim, int heads,
                                            int dh, int group,
                                            int windows_per_cta, int is_bf16,
                                            void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bw < 1 || n < 1 || n > kRows || dim < 16 || dim % 16 != 0 ||
      heads < 1 || dh < 16 || dh % 16 != 0 || dh > kMaxDimHead ||
      group < 1 || group > heads || group > kMaxGroup ||
      windows_per_cta < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (is_bf16)
    return launch<__nv_bfloat16>(x, wqkv, bias, out, bw, n, dim, heads, dh,
                                 group, windows_per_cta, st);
  return launch<float>(x, wqkv, bias, out, bw, n, dim, heads, dh, group,
                       windows_per_cta, st);
}
