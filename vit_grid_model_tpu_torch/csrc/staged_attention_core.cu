// The core of staged head-major window attention for Hopper (sm_90a): R11.
//
// Replaces benchmarks/mosaic_repros/repro_staged_headmajor.py::core_kernel
// (:31-47, pallas_call :68).  The repro computes the qkv product, the l2
// norm and a head-major layout outside the kernel (:59-67) and leaves that
// to XLA; the port leaves it to stock PyTorch (ops/cuda/
// attention_variants.py::staged_attention).  This kernel is the core: for
// each head h and window w, on head-major operands qn, kn, v (heads, bw, n,
// dh) in T and bias (heads, n, n) f32,
//
//   S = qn[h, w] kn[h, w]^T + bias_h          (f32 sums)
//   P = softmax(S), rounded to T              (attn.astype(v.dtype))
//   out[h, w] = P . v[h, w]                   (f32 sums, stored as T)
//
// What bounds it on an H100: bytes.  At the repro's shape (n = 56, 32
// heads x 32, bf16) q, k, v and out plus the bias are 1.32 GB at Bw =
// 2,880, 0.394 ms at 3.35 TB/s, against 37.0 GFLOP (0.037 ms) of products.
//
// bf16, the ring design ("ring"): what keeps bytes in flight.
//
// * A persistent grid: as many CTAs as the card holds at once, CTA c
//   owning the pairs [c P / G, (c + 1) P / G) of the P = heads * bw pairs
//   (h, w) in head-major order.  Its q, k, v and out are one contiguous run
//   in each operand, spanning a head or two.
// * A ring of kStages windows in shared memory, each slot q | k | v of 64
//   rows at a row stride of dh + 8 elements (so that ldmatrix reads of 8
//   rows fall on 32 distinct banks), rows n..63 zeroed once: a window's
//   rows are copied into its own slot, never back to back, so P = 0 on the
//   keys >= n meets zeros in v and never a neighbour's rows.  All 128
//   threads copy a window's 3 n dh bf16 values by cp.async, 16 bytes at a
//   time with an L2 prefetch hint of 256 bytes, one commit group a window,
//   kStages - 1 windows ahead of the one the CTA computes; one barrier a
//   window hands the slots over.  Two slots (30,720 B at dh 32) let four
//   CTAs share an SM, which measured faster on an H100 than three or four
//   slots at three or four CTAs an SM.
// * Warp i owns query rows 16i..16i+15 of each window.  q's A fragments,
//   k's B fragments (ldmatrix) and v's (ldmatrix.trans) come from the slot;
//   both products run on mma.sync m16n8k16 with f32 sums (the products
//   are 3% of the time the bytes take).  S stays in the accumulators; each
//   thread holds its two rows' bias for the CTA's current head in
//   registers, keys >= n at -inf folded in, and reloads them only when the
//   head changes.  The softmax runs in f32 (row max and sum across the
//   four lanes of a quad by shuffles), P = e * (1 / sum) is rounded to
//   bf16 in registers, where the accumulator layout of two 8-key tiles is
//   the A fragment of one 16-key step of P.V.
// * The output: each lane stores its P.V values (bf16 pairs, rows < n)
//   straight from the accumulators, 4 bytes at a time; L2 merges a row's
//   pieces.  Staging the rows in shared memory first, for 16-byte stores
//   or for one 1-D bulk copy a window, measured no faster on an H100
//   (PERF.md, section 6).
//
// f32 operands keep the first design: a CTA a (head, window), k and v in
// shared memory, four query rows a warp at once on CUDA cores
// (attend_rows), no rounding.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kCoreThreads = 128;  // f32: one CTA a (head, window)
constexpr int kCoreWarps = kCoreThreads / 32;

// the ring design
constexpr int kRingThreads = 128;  // four warps, a 16-row strip each
constexpr int kStages = 2;         // windows in the ring
constexpr int kKeyTiles = kRows / 8;

__host__ __device__ constexpr int ring_ld(int dh) { return dh + 8; }
__host__ __device__ constexpr size_t ring_slot_elems(int dh) {
  return 3 * static_cast<size_t>(kRows) * ring_ld(dh);
}
__host__ __device__ constexpr size_t ring_smem_bytes(int dh) {
  return kStages * ring_slot_elems(dh) * sizeof(__nv_bfloat16);
}

// Four 8 x 8 bf16 blocks of shared memory into r, lane l giving the
// address of row l % 8 of block l / 8 (16 bytes, 16-byte aligned).
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4],
                                            const __nv_bfloat16* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// cp.async of 16 bytes, with the hint that L2 fetch the 256 bytes around
// them (a window's rows are contiguous in each operand)
__device__ __forceinline__ void cp_async16_l2(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global.L2::256B [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// Start the copies of window j of the CTA's run (pair `pair`) into its
// slot: rows 0..n-1 of q, k and v, 16 bytes a thread at a time; one commit
// group, empty when j is past the run.
template <int kDh>
__device__ __forceinline__ void copy_window(
    __nv_bfloat16* slot, const __nv_bfloat16* __restrict__ qn,
    const __nv_bfloat16* __restrict__ kn,
    const __nv_bfloat16* __restrict__ v, long pair, int n, bool live) {
  constexpr int ld = ring_ld(kDh);
  constexpr int kChunksARow = kDh / 8;
  if (live) {
    const size_t base = static_cast<size_t>(pair) * n * kDh;
    const int chunks = n * kChunksARow;
    const __nv_bfloat16* src[3] = {qn + base, kn + base, v + base};
#pragma unroll
    for (int op = 0; op < 3; ++op)
      for (int c = threadIdx.x; c < chunks; c += kRingThreads)
        cp_async16_l2(slot + op * kRows * ld + (c / kChunksARow) * ld +
                          (c % kChunksARow) * 8,
                      src[op] + c * 8);
  }
  cp_async_commit();
}

template <int kDh>
__global__ void __launch_bounds__(kRingThreads)
    core_ring_bf16(const __nv_bfloat16* __restrict__ qn,
                   const __nv_bfloat16* __restrict__ kn,
                   const __nv_bfloat16* __restrict__ v,
                   const float* __restrict__ bias,
                   __nv_bfloat16* __restrict__ out, int bw, int n,
                   long pairs) {
  constexpr int ld = ring_ld(kDh);
  constexpr int kSlot = static_cast<int>(ring_slot_elems(kDh));
  extern __shared__ __align__(16) __nv_bfloat16 ring[];

  const long first = pairs * blockIdx.x / gridDim.x;
  const int count = static_cast<int>(pairs * (blockIdx.x + 1) / gridDim.x -
                                     first);
  // rows n..63 of every slot's q, k and v: zero, once
  {
    const int pad = (kRows - n) * (ld / 8);  // 16-byte chunks a plane
    for (int e = threadIdx.x; e < kStages * 3 * pad; e += kRingThreads) {
      const int plane = e / pad;
      const int c = e - plane * pad;
      *reinterpret_cast<uint4*>(ring + plane * kRows * ld + n * ld +
                                c * 8) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < kStages - 1; ++j)
    copy_window<kDh>(ring + j * kSlot, qn, kn, v, first + j, n, j < count);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row (and B's column) group
  const int t = lane & 3;   // its pair of k indices
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  const bool rows_live = warp * 16 < n;  // else every row is padding
  int h = static_cast<int>(first / bw);
  int w = static_cast<int>(first - static_cast<long>(h) * bw);
  int bias_head = -1;
  float bb[kKeyTiles][4];  // this thread's bias, keys >= n at -inf

  for (int j = 0; j < count; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // window j has landed; window j - 1's slot is free
    copy_window<kDh>(ring + ((j + kStages - 1) % kStages) * kSlot, qn, kn,
                     v, first + j + kStages - 1, n, j + kStages - 1 < count);
    const __nv_bfloat16* qs = ring + (j % kStages) * kSlot;
    const __nv_bfloat16* ks = qs + kRows * ld;
    const __nv_bfloat16* vs = ks + kRows * ld;
    if (h != bias_head) {
      bias_head = h;
      const float* b0 = bias + (static_cast<size_t>(h) * n + r0) * n;
      const float* b1 = bias + (static_cast<size_t>(h) * n + r1) * n;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int c = nt * 8 + 2 * t + i;
          bb[nt][i] = c < n ? (r0 < n ? b0[c] : 0.f) : -INFINITY;
          bb[nt][2 + i] = c < n ? (r1 < n ? b1[c] : 0.f) : -INFINITY;
        }
    }
    if (rows_live) {
      // section: math
      uint32_t qa[kDh / 16][4];
#pragma unroll
      for (int kk = 0; kk < kDh / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 15)) * ld + kk * 16 +
                                (lane >> 4) * 8);

      // S = q k^T, key tiles in pairs; pairs wholly past n stay 0
      float s[kKeyTiles][4];
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
        s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int np = 0; np < kKeyTiles / 2; ++np) {
        if (np * 16 >= n) continue;
#pragma unroll
        for (int kk = 0; kk < kDh / 16; ++kk) {
          uint32_t b[4];
          ldmatrix_x4(b, ks + (np * 16 + ((lane >> 4) << 3) + (lane & 7)) *
                                  ld + kk * 16 + ((lane >> 3) & 1) * 8);
          mma_bf16_16816(s[2 * np], qa[kk], b[0], b[1]);
          mma_bf16_16816(s[2 * np + 1], qa[kk], b[2], b[3]);
        }
      }

      // + bias (keys >= n at -inf); the row max and sum over the quad
      float m0 = -INFINITY;
      float m1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[nt][i] += bb[nt][i];
          s[nt][2 + i] += bb[nt][2 + i];
          m0 = fmaxf(m0, s[nt][i]);
          m1 = fmaxf(m1, s[nt][2 + i]);
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        m0 = fmaxf(m0, __shfl_xor_sync(0xffffffffu, m0, o));
        m1 = fmaxf(m1, __shfl_xor_sync(0xffffffffu, m1, o));
      }
      float l0 = 0.f;
      float l1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          s[nt][i] = __expf(s[nt][i] - m0);
          s[nt][2 + i] = __expf(s[nt][2 + i] - m1);
          l0 += s[nt][i];
          l1 += s[nt][2 + i];
        }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, o);
        l1 += __shfl_xor_sync(0xffffffffu, l1, o);
      }
      const float i0 = 1.f / l0;
      const float i1 = 1.f / l1;

      // P rounded to bf16; tiles 2kk and 2kk + 1 of S are the A fragment
      // of P.V's k-step kk
      uint32_t pa[kKeyTiles / 2][4];
#pragma unroll
      for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
        pa[kk][0] = pack_bf16(s[2 * kk][0] * i0, s[2 * kk][1] * i0);
        pa[kk][1] = pack_bf16(s[2 * kk][2] * i1, s[2 * kk][3] * i1);
        pa[kk][2] = pack_bf16(s[2 * kk + 1][0] * i0, s[2 * kk + 1][1] * i0);
        pa[kk][3] = pack_bf16(s[2 * kk + 1][2] * i1, s[2 * kk + 1][3] * i1);
      }

      // out = P . v, two 8-column tiles at a time; rows >= n not stored
      __nv_bfloat16* const ob = out + (static_cast<size_t>(first) + j) * n *
                                          kDh;
#pragma unroll
      for (int nd = 0; nd < kDh / 8; nd += 2) {
        float o[2][4] = {};
#pragma unroll
        for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
          if (kk * 16 >= n) continue;
          uint32_t b[4];
          ldmatrix_x4_trans(b, vs + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                     (lane & 7)) * ld + nd * 8 +
                                   (lane >> 4) * 8);
          mma_bf16_16816(o[0], pa[kk], b[0], b[1]);
          mma_bf16_16816(o[1], pa[kk], b[2], b[3]);
        }
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int c = (nd + u) * 8 + 2 * t;
          // section: store
          if (r0 < n)
            *reinterpret_cast<uint32_t*>(ob + r0 * kDh + c) =
                pack_bf16(o[u][0], o[u][1]);
          if (r1 < n)
            *reinterpret_cast<uint32_t*>(ob + r1 * kDh + c) =
                pack_bf16(o[u][2], o[u][3]);
          // section: end store
        }
      }
      // section: end math
    }
    if (++w == bw) {
      w = 0;
      ++h;
    }
  }
  cp_async_wait<0>();
}

// f32: k and v in shared memory, warp i on query rows i, i + 4, ..., no
// rounding.
__global__ void __launch_bounds__(kCoreThreads)
    core_kernel_f32(const float* __restrict__ qn,
                    const float* __restrict__ kn,
                    const float* __restrict__ v,
                    const float* __restrict__ bias, float* __restrict__ out,
                    int bw, int n, int dh) {
  extern __shared__ __align__(16) float kv[];
  const int ld = dh + 4;
  float* ks = kv;
  float* vs = kv + kRows * ld;
  const int pair = blockIdx.x;
  const int h = pair / bw;
  const size_t base = static_cast<size_t>(pair) * n * dh;
  for (int e = threadIdx.x; e < n * dh; e += kCoreThreads) {
    ks[(e / dh) * ld + e % dh] = kn[base + e];
    vs[(e / dh) * ld + e % dh] = v[base + e];
  }
  __syncthreads();
  for (int r = threadIdx.x >> 5; r < n; r += kRowsAtOnce * kCoreWarps)
    attend_rows<float>(
        qn + base + static_cast<size_t>(r) * dh,
        static_cast<size_t>(kCoreWarps) * dh,
        min(kRowsAtOnce, (n - r + kCoreWarps - 1) / kCoreWarps), ks, ld, vs,
        ld, bias + (static_cast<size_t>(h) * n + r) * n,
        static_cast<size_t>(kCoreWarps) * n, n, dh,
        out + base + static_cast<size_t>(r) * dh,
        static_cast<size_t>(kCoreWarps) * dh);
}

template <int kDh>
int launch_ring(const void* qn, const void* kn, const void* v,
                const void* bias, void* out, long pairs, int bw, int n,
                cudaStream_t stream) {
  const auto kernel = core_ring_bf16<kDh>;
  const size_t smem = ring_smem_bytes(kDh);
  int device = 0;
  int sms = 0;
  int per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, kernel, kRingThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long grid = std::min(pairs, static_cast<long>(per_sm) * sms);
  kernel<<<static_cast<int>(grid), kRingThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(qn),
      static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), bw, n, pairs);
  return static_cast<int>(cudaGetLastError());
}

template <int kDh>
int ring_occupancy(int* out) {
  const auto kernel = core_ring_bf16<kDh>;
  const size_t smem = ring_smem_bytes(kDh);
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kRingThreads, smem);
  if (err != cudaSuccess) return -1;
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.localSizeBytes);
  out[2] = static_cast<int>(smem);
  out[3] = blocks;
  out[4] = kStages;
  return 0;
}

}  // namespace

// The design a launch at these widths takes: 1 ("ring") in bf16 at every
// width the entry takes (n <= 64, dh 16, 32, 48 or 64), else 0 ("first").
extern "C" int vgm_staged_attention_core_route(int n, int dh, int is_bf16) {
  return is_bf16 && n >= 1 && n <= kRows && dh >= 16 && dh <= 64 &&
         dh % 16 == 0;
}

// The ring design's registers, local bytes a thread, shared memory a CTA,
// CTAs an SM and ring depth (windows) at dim_head dh into out[0..4]; 0, or
// -1 on an error.
extern "C" int vgm_staged_attention_core_occupancy(int dh, int* out) {
  switch (dh) {
    case 16: return ring_occupancy<16>(out);
    case 32: return ring_occupancy<32>(out);
    case 48: return ring_occupancy<48>(out);
    case 64: return ring_occupancy<64>(out);
    default: return -1;
  }
}

// qn, kn, v and out: (heads, bw, n, dh), f32 or bf16 (is_bf16); bias: f32
// (heads, n, n).  All contiguous, 16-byte aligned.  n <= 64; dh a multiple
// of 16, <= 64.  bf16 launches the ring design's persistent grid, f32
// heads * bw CTAs of the first design, on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int vgm_staged_attention_core(const void* qn, const void* kn,
                                         const void* v, const void* bias,
                                         void* out, int heads, int bw, int n,
                                         int dh, int is_bf16, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long pairs = static_cast<long>(heads) * bw;
  if (heads < 1 || bw < 1 || pairs > 0x7fffffffL || n < 1 || n > kRows ||
      dh < 16 || dh % 16 != 0 || dh > 64)
    return static_cast<int>(cudaErrorInvalidValue);
  if (!is_bf16) {
    const size_t smem = 2 * static_cast<size_t>(kRows) * (dh + 4) *
                        sizeof(float);
    core_kernel_f32<<<static_cast<int>(pairs), kCoreThreads, smem, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(kn),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), bw, n, dh);
    return static_cast<int>(cudaGetLastError());
  }
  const void* const operands[] = {qn, kn, v, out};
  for (const void* p : operands)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  switch (dh) {
    case 16: return launch_ring<16>(qn, kn, v, bias, out, pairs, bw, n, st);
    case 32: return launch_ring<32>(qn, kn, v, bias, out, pairs, bw, n, st);
    case 48: return launch_ring<48>(qn, kn, v, bias, out, pairs, bw, n, st);
    default: return launch_ring<64>(qn, kn, v, bias, out, pairs, bw, n, st);
  }
}
