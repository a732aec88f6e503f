// Device helpers shared by the attention kernels under csrc/: conversions
// between f32 and the activation type T (f32 or bf16), warp reductions, the
// wmma tile product the bf16 paths run the projections on, the mma.sync
// m16n8k16 bf16 fragments, the cp.async copies, the CUDA-core f32 product
// and the per-head steps (norm, scores, softmax, P.v) of the per-head
// kernels, a few query rows' attention run by one warp (attend_rows), and
// the steps of the head-group kernels (R4's and R3's): a group's q|k|v
// product and its attention.

#pragma once

#include <cuda_bf16.h>
#include <mma.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 16 x 16 thread grid for the 64-row tiles
constexpr int kRows = 64;      // token rows per window tile (n <= 64)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Round an f32 value to T's precision, keeping it in f32.
template <typename T>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__host__ __device__ constexpr size_t align128(size_t b) {
  return (b + 127) & ~static_cast<size_t>(127);
}

// Offset of element (r, c) of a matrix with leading dimension ld stored in
// wmma layout L.
template <typename L>
__device__ __forceinline__ size_t wmma_offset(int r, int c, int ld) {
  return std::is_same<L, nvcuda::wmma::row_major>::value
             ? static_cast<size_t>(r) * ld + c
             : r + static_cast<size_t>(c) * ld;
}

// C[M x N] (+)= A[M x K] . B[K x N] on the tensor cores: bf16 operands in
// layouts LA and LB (shared or device memory), f32 sums, C f32 row-major
// in shared or device memory (this CTA its only writer).  M, N, K are
// multiples of 16, and every 16 x 16 tile starts 32-byte aligned.  Warp w
// owns the output tiles w, w + 8, ...
template <typename LA, typename LB>
__device__ void wmma_mm(int M, int N, int K, const __nv_bfloat16* A,
                        int lda, const __nv_bfloat16* B, int ldb, float* C,
                        int ldc, bool accumulate) {
  namespace wmma = nvcuda::wmma;
  const int mt = M / 16;
  const int tiles = mt * (N / 16);
  for (int t = threadIdx.x >> 5; t < tiles; t += kThreads / 32) {
    const int r0 = (t % mt) * 16;
    const int c0 = (t / mt) * 16;
    float* cp = C + static_cast<size_t>(r0) * ldc + c0;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (accumulate)
      wmma::load_matrix_sync(acc, cp, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, A + wmma_offset<LA>(r0, k, lda), lda);
      wmma::load_matrix_sync(b, B + wmma_offset<LB>(k, c0, ldb), ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(cp, acc, ldc, wmma::mem_row_major);
  }
  __syncthreads();
}

// One m16n8k16 tensor-core step, c += a . b: bf16 operands in registers
// (a: the 16 x 16 A fragment, b0/b1: the 16 x 8 B fragment), f32 sums.
// Lane l = 4g + t holds A's rows g and g + 8, columns 2t, 2t + 1 (a[0],
// a[1]) and 2t + 8, 2t + 9 (a[2], a[3]); B's rows 2t, 2t + 1 (b0) and
// 2t + 8, 2t + 9 (b1) of column g; C's rows g (c[0], c[1]) and g + 8 (c[2],
// c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_bf16_16816(float (&c)[4],
                                               const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (to nearest even), packed low first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t load_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Start copying rows x cols of T from global (row stride lds) into shared
// memory (row stride ldd), 16 bytes a thread at a time; one commit group
// (or none: then it joins the next copy's group).
template <typename T>
__device__ void copy_rows_async(T* dst, int ldd, const T* src, int lds,
                                int rows, int cols, bool commit = true) {
  constexpr int kPer = 16 / sizeof(T);
  const int chunks = cols / kPer;
  for (int e = threadIdx.x; e < rows * chunks; e += kThreads) {
    const int r = e / chunks;
    const int k = (e % chunks) * kPer;
    cp_async16(dst + r * ldd + k, src + static_cast<size_t>(r) * lds + k);
  }
  if (commit) cp_async_commit();
}

// C[r][c] (+)= sum_k A[r][k] * B[k][c] for r < 64, c < N, k < K, all f32
// in shared memory.  Thread (ty, tx) of the 16 x 16 grid owns rows
// 4ty..4ty+3 and columns tx + 16j of each 64-column pass.
__device__ inline void gemm_smem_f32(const float* A, int lda,
                                     const float* B, int ldb, float* C,
                                     int ldc, int K, int N,
                                     bool accumulate = false) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int c0 = 0; c0 < N; c0 += 64) {
    float acc[4][4] = {};
    if (accumulate) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + tx + 16 * j;
          if (c < N) acc[i][j] = C[(4 * ty + i) * ldc + c];
        }
    }
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        b[j] = c < N ? B[k * ldb + c] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = c0 + tx + 16 * j;
        if (c < N) C[(4 * ty + i) * ldc + c] = acc[i][j];
      }
  }
  __syncthreads();
}

// The per-head steps of the 64-row q|k|v tiles of R1's and R10's kernels,
// all f32 in shared memory, each ending in a block barrier.  q, k and v of
// row r sit at qkv + r * ldq, + dh and + 2dh; a score tile holds 64 rows
// kRows apart.  Thread (ty, tx) of the 16 x 16 grid owns rows 4ty..4ty+3.

// q and k of rows < n scaled by rsqrt(max(sum^2, 1e-24)): a warp a vector.
__device__ inline void l2_normalize_qk(float* qkv, int ldq, int n, int dh) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < 2 * n; t += kThreads / 32) {
    float* vec = qkv + (t >> 1) * ldq + (t & 1) * dh;
    float ss = 0.f;
    for (int d = lane; d < dh; d += 32) ss += vec[d] * vec[d];
    const float scale = rsqrtf(fmaxf(warp_sum(ss), 1e-24f));
    for (int d = lane; d < dh; d += 32) vec[d] *= scale;
  }
  __syncthreads();
}

// s = q k^T + bias_h (bh: n x n); columns >= n (the 64-row padding) get
// -1e30, rows >= n no bias.
__device__ inline void scores_tile(const float* qkv, int ldq, int dh,
                                   const float* bh, int n, float* s) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  float acc[4][4] = {};
  for (int d = 0; d < dh; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = qkv[(4 * ty + i) * ldq + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = qkv[(tx + 16 * j) * ldq + dh + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = 4 * ty + i;
      const int c = tx + 16 * j;
      s[r * kRows + c] =
          c >= n ? -1e30f : acc[i][j] + (r < n ? bh[r * n + c] : 0.f);
    }
  __syncthreads();
}

// Softmax of rows r < n of `tiles` score tiles, `stride` floats apart, in
// one pass: a warp a row.
__device__ inline void softmax_rows(float* s, int tiles, int n,
                                    size_t stride = kRows * kRows) {
  const int lane = threadIdx.x & 31;
  for (int t = threadIdx.x >> 5; t < tiles * n; t += kThreads / 32) {
    float* sr = s + (t / n) * stride + (t % n) * kRows;
    const float v0 = sr[lane];
    const float v1 = sr[lane + 32];
    const float m = warp_max(fmaxf(v0, v1));
    const float e0 = expf(v0 - m);
    const float e1 = expf(v1 - m);
    const float den = warp_sum(e0 + e1);
    sr[lane] = e0 / den;
    sr[lane + 32] = e1 / den;
  }
  __syncthreads();
}

// out[r * ldo + d] = sum_j p[r][j] v[j][d] for r < n, d < dh (v rows ldv
// apart), stored as T.  No barrier: it only reads the tiles.
template <typename T>
__device__ inline void pv_tile(const float* p, const float* v, int ldv,
                               int n, int dh, T* out, size_t ldo) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int d0 = 0; d0 < dh; d0 += 16) {
    const int d = d0 + tx;
    if (d >= dh) continue;
    float acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j < n; ++j) {
      const float vj = v[j * ldv + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        acc[i] = fmaf(p[(4 * ty + i) * kRows + j], vj, acc[i]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i;
      if (r < n) out[r * ldo + d] = from_f32<T>(acc[i]);
    }
  }
}

// Up to kRowsAtOnce query rows of one head's attention, run by one warp
// with no block barrier: for each row i < rows (row i at q + i * qstep,
// its bias at bias + i * bstep, its output at out + i * ostep)
//   out[d] = sum_j softmax_j(q . k_j + bias[j]) v_j[d]
// for j < n (n <= 64) and d < dh (a multiple of 16, <= 64), all in f32.
// Lane l holds each row's scores of keys l and l + 32 in registers; the max
// and the sum reduce by shuffles, and P.v takes each p_j from its lane by a
// shuffle.  The rows run interleaved, so each key and v row read from
// memory serves all of them and their dependency chains overlap.  q, k and
// v are f32 in shared or device memory (k and v rows ldk and ldv apart;
// every row 16-byte aligned).
constexpr int kRowsAtOnce = 4;

template <typename T>
__device__ __forceinline__ void attend_rows(const float* q, size_t qstep,
                                            int rows, const float* k,
                                            int ldk, const float* v, int ldv,
                                            const float* bias, size_t bstep,
                                            int n, int dh, T* out,
                                            size_t ostep) {
  const int lane = threadIdx.x & 31;
  const int j0 = lane;
  const int j1 = lane + 32;
  // keys >= n read key n - 1 and are dropped below
  const float* k0 = k + min(j0, n - 1) * ldk;
  const float* k1 = k + min(j1, n - 1) * ldk;
  float s0[kRowsAtOnce], s1[kRowsAtOnce];
#pragma unroll
  for (int i = 0; i < kRowsAtOnce; ++i) s0[i] = s1[i] = 0.f;
  for (int d = 0; d < dh; d += 4) {
    const float4 a = *reinterpret_cast<const float4*>(k0 + d);
    const float4 b = *reinterpret_cast<const float4*>(k1 + d);
#pragma unroll
    for (int i = 0; i < kRowsAtOnce; ++i) {
      // rows past `rows` repeat the last one and are not stored
      const float4 qd = *reinterpret_cast<const float4*>(
          q + min(i, rows - 1) * qstep + d);
      s0[i] = fmaf(qd.x, a.x, s0[i]);
      s0[i] = fmaf(qd.y, a.y, s0[i]);
      s0[i] = fmaf(qd.z, a.z, s0[i]);
      s0[i] = fmaf(qd.w, a.w, s0[i]);
      s1[i] = fmaf(qd.x, b.x, s1[i]);
      s1[i] = fmaf(qd.y, b.y, s1[i]);
      s1[i] = fmaf(qd.z, b.z, s1[i]);
      s1[i] = fmaf(qd.w, b.w, s1[i]);
    }
  }
  // keys >= n take no part: -inf before the max, 0 after the exp
  float p0[kRowsAtOnce], p1[kRowsAtOnce];
#pragma unroll
  for (int i = 0; i < kRowsAtOnce; ++i) {
    const float* bi = bias + min(i, rows - 1) * bstep;
    const float a = j0 < n ? s0[i] + bi[j0] : -INFINITY;
    const float b = j1 < n ? s1[i] + bi[j1] : -INFINITY;
    const float m = warp_max(fmaxf(a, b));
    const float e0 = j0 < n ? expf(a - m) : 0.f;
    const float e1 = j1 < n ? expf(b - m) : 0.f;
    const float den = warp_sum(e0 + e1);
    p0[i] = e0 / den;
    p1[i] = e1 / den;
  }
  const bool has0 = lane < dh;
  const bool has1 = lane + 32 < dh;
  float acc0[kRowsAtOnce], acc1[kRowsAtOnce];
#pragma unroll
  for (int i = 0; i < kRowsAtOnce; ++i) acc0[i] = acc1[i] = 0.f;
  for (int j = 0; j < n; ++j) {
    const float v0 = has0 ? v[j * ldv + lane] : 0.f;
    const float v1 = has1 ? v[j * ldv + lane + 32] : 0.f;
#pragma unroll
    for (int i = 0; i < kRowsAtOnce; ++i) {
      const float pj = __shfl_sync(0xffffffffu, j < 32 ? p0[i] : p1[i],
                                   j & 31);
      acc0[i] = fmaf(pj, v0, acc0[i]);
      acc1[i] = fmaf(pj, v1, acc1[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kRowsAtOnce; ++i) {
    if (i >= rows) break;
    if (has0) out[i * ostep + lane] = from_f32<T>(acc0[i]);
    if (has1) out[i * ostep + lane + 32] = from_f32<T>(acc1[i]);
  }
}

// The steps of the head-group kernels (R4's headmajor_attention.cu and R3's
// crosshead_norm_attention.cu): a CTA of kWarps warps computes a group of
// heads' q|k|v for one window tile at once, then runs their attention.
constexpr int kWarps = kThreads / 32;

// C[16 x dh] = A[16 x dim] . B[dim x dh] for one warp: rows of A ldx
// apart, of B ldw apart, of C ldc apart.  bf16 on the tensor cores.
__device__ inline void unit_product(const __nv_bfloat16* A, int ldx,
                                    const __nv_bfloat16* B, int ldw, float* C,
                                    int ldc, int dim, int dh) {
  namespace wmma = nvcuda::wmma;
  for (int c0 = 0; c0 < dh; c0 += 16) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < dim; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> b;
      wmma::load_matrix_sync(a, A + k, ldx);
      wmma::load_matrix_sync(b, B + static_cast<size_t>(k) * ldw + c0, ldw);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(C + c0, acc, ldc, wmma::mem_row_major);
  }
}

// The same in f32 on CUDA cores: lane l owns columns l and l + 32 of the
// 16 rows.
__device__ inline void unit_product(const float* A, int ldx, const float* B,
                                    int ldw, float* C, int ldc, int dim,
                                    int dh) {
  const int lane = threadIdx.x & 31;
  const bool has0 = lane < dh;
  const bool has1 = lane + 32 < dh;
  float acc0[16] = {};
  float acc1[16] = {};
  for (int k = 0; k < dim; ++k) {
    const float b0 = has0 ? B[k * ldw + lane] : 0.f;
    const float b1 = has1 ? B[k * ldw + lane + 32] : 0.f;
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const float a = A[r * ldx + k];
      acc0[r] = fmaf(a, b0, acc0[r]);
      acc1[r] = fmaf(a, b1, acc1[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    if (has0) C[r * ldc + lane] = acc0[r];
    if (has1) C[r * ldc + lane + 32] = acc1[r];
  }
}

// Where a group's f32 q|k|v sits in shared memory: element d of row r of
// part p (0 q, 1 k, 2 v) of the group's head g is at
//   qkv[g * head + p * part + r * row + d].
// R4 stores it head-major, (G, 3, 64, dh + 4); R3 row-major as the TPU's
// (R, 3hd) tile restricted to the group, (64, 3 G dh + 4) with the group's
// q columns, then its k columns, then its v columns.  row is a multiple of
// 4 floats (16-byte rows for attend_rows' float4 reads and wmma's store).
struct GroupLayout {
  size_t head, part;
  int row;
};

// Step 1: the group's q|k|v = x_w . [Wqkv_h for its gn heads] for the
// first mtiles 16-row tiles, one warp per (row tile, head, part) unit; the
// gn weight slices (dim x 3dh, rows ldw apart) sit wslice apart in ws.
// With norm_in_warp (R4) the warp that stores a q or k tile l2-normalizes
// its 16 rows itself after a __syncwarp, two lanes a row.  No block
// barrier.
template <typename T>
__device__ void group_qkv(const T* xw, int ldx, const T* ws, size_t wslice,
                          int ldw, float* qkv, const GroupLayout& L,
                          int mtiles, int gn, int dim, int dh,
                          bool norm_in_warp) {
  const int lane = threadIdx.x & 31;
  for (int u = threadIdx.x >> 5; u < mtiles * gn * 3; u += kWarps) {
    const int mt = u % mtiles;
    const int part = (u / mtiles) % 3;
    const int g = u / (mtiles * 3);
    float* c = qkv + g * L.head + part * L.part +
               static_cast<size_t>(mt) * 16 * L.row;
    unit_product(xw + mt * 16 * ldx, ldx, ws + g * wslice + part * dh, ldw,
                 c, L.row, dim, dh);
    if (norm_in_warp && part < 2) {  // lanes 2r, 2r + 1 split row r
      __syncwarp();
      const int half = dh / 2;
      float* vec = c + (lane >> 1) * L.row + (lane & 1) * half;
      float ss = 0.f;
      for (int d = 0; d < half; ++d) ss = fmaf(vec[d], vec[d], ss);
      ss += __shfl_xor_sync(0xffffffffu, ss, 1);
      const float scale = rsqrtf(fmaxf(ss, 1e-24f));
      for (int d = 0; d < half; ++d) vec[d] *= scale;
    }
  }
}

// Step 3: warp i runs query rows i, i + 8, ... of each of the group's gn
// heads (the first is head h0), kRowsAtOnce of them interleaved
// (attend_rows), into out_w, the window's (n, inner) output (head h at
// columns h * dh).  No block barrier.
template <typename T>
__device__ void attend_group(const float* qkv, const GroupLayout& L, int gn,
                             int h0, const float* bias, int n, int dh,
                             T* out_w, int inner) {
  const int warp = threadIdx.x >> 5;
  for (int g = 0; g < gn; ++g) {
    const int h = h0 + g;
    const float* hq = qkv + g * L.head;
    for (int r = warp; r < n; r += kRowsAtOnce * kWarps)
      attend_rows<T>(hq + static_cast<size_t>(r) * L.row,
                     static_cast<size_t>(kWarps) * L.row,
                     min(kRowsAtOnce, (n - r + kWarps - 1) / kWarps),
                     hq + L.part, L.row, hq + 2 * L.part, L.row,
                     bias + (static_cast<size_t>(h) * n + r) * n,
                     static_cast<size_t>(kWarps) * n, n, dh,
                     out_w + static_cast<size_t>(r) * inner + h * dh,
                     static_cast<size_t>(kWarps) * inner);
  }
}

}  // namespace
