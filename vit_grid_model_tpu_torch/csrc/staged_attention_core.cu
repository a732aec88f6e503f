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
// What this design does about it: one pass over the operands, every byte
// read once.  A CTA of one warpgroup (128 threads) owns one (head, window)
// pair; the pairs are small (3.5 KB each of q, k and v in bf16), so the
// grid holds heads * bw CTAs and many CTAs share an SM to keep loads in
// flight.  The CTA copies k (row-major) and v (transposed) into shared
// memory, keys >= n as zeros; warp i then owns query rows 16i..16i+15.  In
// bf16 both products run on the tensor cores (mma.sync m16n8k16, f32
// sums): q's A fragments come straight from device memory, S stays in the
// accumulators, the softmax runs on them in f32 (row max and sum across the
// four lanes of a quad by shuffles; keys >= n at -inf before the max), and
// P is rounded to bf16 in registers, where the accumulator layout of two
// 8-key tiles is the A fragment of one 16-key step of P.V.  Padded rows are
// never stored.  f32 operands run on CUDA cores with no rounding, four
// query rows a warp at once (attend_rows).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

constexpr int kCoreThreads = 128;  // one warpgroup per (head, window)
constexpr int kCoreWarps = kCoreThreads / 32;
constexpr int kKeyTiles = kRows / 8;  // n-tiles of 8 keys in the scores

// Row strides in shared memory, in elements: k rows of dh + 8 and the
// transposed v's rows of 64 + 8 keep the fragment reads of a warp on 32
// distinct banks.
__host__ __device__ constexpr int ld_k(int dh) { return dh + 8; }
constexpr int kLdVt = kRows + 8;

template <int kDh>
__global__ void __launch_bounds__(kCoreThreads)
    core_kernel_bf16(const __nv_bfloat16* __restrict__ qn,
                     const __nv_bfloat16* __restrict__ kn,
                     const __nv_bfloat16* __restrict__ v,
                     const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int bw, int n) {
  constexpr int ldk = ld_k(kDh);
  __shared__ __align__(16) __nv_bfloat16 ks[kRows * ldk];
  __shared__ __align__(16) __nv_bfloat16 vt[kDh * kLdVt];

  const int pair = blockIdx.x;  // head * bw + window
  const int h = pair / bw;
  const size_t base = static_cast<size_t>(pair) * n * kDh;
  // 16 bytes (8 values) a thread at a time; v's scattered into columns
  for (int e = threadIdx.x; e < kRows * kDh / 8; e += kCoreThreads) {
    const int j = e * 8 / kDh;
    const int d0 = e * 8 % kDh;
    uint4 kq = make_uint4(0u, 0u, 0u, 0u);
    uint4 vq = kq;
    if (j < n) {
      kq = *reinterpret_cast<const uint4*>(kn + base + e * 8);
      vq = *reinterpret_cast<const uint4*>(v + base + e * 8);
    }
    *reinterpret_cast<uint4*>(ks + j * ldk + d0) = kq;
    const __nv_bfloat16* vv = reinterpret_cast<const __nv_bfloat16*>(&vq);
#pragma unroll
    for (int i = 0; i < 8; ++i) vt[(d0 + i) * kLdVt + j] = vv[i];
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // the fragment's row (and B's column) group
  const int t = lane & 3;   // its pair of k indices
  const int r0 = warp * 16 + g;
  const int r1 = r0 + 8;
  if (warp * 16 >= n) return;  // every row of this warp is padding

  // q's A fragments, straight from device memory; padded rows are zeros
  uint32_t qa[kDh / 16][4];
  const __nv_bfloat16* q0 = qn + base + static_cast<size_t>(r0) * kDh;
  const __nv_bfloat16* q1 = qn + base + static_cast<size_t>(r1) * kDh;
#pragma unroll
  for (int kk = 0; kk < kDh / 16; ++kk) {
    const int c = kk * 16 + 2 * t;
    qa[kk][0] = r0 < n ? load_u32(q0 + c) : 0u;
    qa[kk][1] = r1 < n ? load_u32(q1 + c) : 0u;
    qa[kk][2] = r0 < n ? load_u32(q0 + c + 8) : 0u;
    qa[kk][3] = r1 < n ? load_u32(q1 + c + 8) : 0u;
  }

  // S = q k^T: eight 16 x 8 tiles of keys
  float s[kKeyTiles][4];
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    const __nv_bfloat16* kr = ks + (nt * 8 + g) * ldk + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kDh / 16; ++kk)
      mma_bf16_16816(s[nt], qa[kk], load_u32(kr + kk * 16),
                     load_u32(kr + kk * 16 + 8));
  }

  // + bias, keys >= n at -inf; the row max and sum over the quad's lanes
  const float* b0 = bias + (static_cast<size_t>(h) * n + r0) * n;
  const float* b1 = bias + (static_cast<size_t>(h) * n + r1) * n;
  float m0 = -INFINITY;
  float m1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < kKeyTiles; ++nt)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = nt * 8 + 2 * t + i;
      s[nt][i] = c < n ? s[nt][i] + (r0 < n ? b0[c] : 0.f) : -INFINITY;
      s[nt][2 + i] =
          c < n ? s[nt][2 + i] + (r1 < n ? b1[c] : 0.f) : -INFINITY;
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
      s[nt][i] = expf(s[nt][i] - m0);
      s[nt][2 + i] = expf(s[nt][2 + i] - m1);
      l0 += s[nt][i];
      l1 += s[nt][2 + i];
    }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o);
  }

  // P = e / sum rounded to bf16; tiles 2kk and 2kk + 1 of S are the A
  // fragment of P.V's k-step kk
  uint32_t pa[kKeyTiles / 2][4];
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    pa[kk][0] = pack_bf16(s[2 * kk][0] / l0, s[2 * kk][1] / l0);
    pa[kk][1] = pack_bf16(s[2 * kk][2] / l1, s[2 * kk][3] / l1);
    pa[kk][2] = pack_bf16(s[2 * kk + 1][0] / l0, s[2 * kk + 1][1] / l0);
    pa[kk][3] = pack_bf16(s[2 * kk + 1][2] / l1, s[2 * kk + 1][3] / l1);
  }

  // out = P . v, 8 columns a tile; rows >= n are not stored
  __nv_bfloat16* o0 = out + base + static_cast<size_t>(r0) * kDh;
  __nv_bfloat16* o1 = out + base + static_cast<size_t>(r1) * kDh;
#pragma unroll
  for (int nd = 0; nd < kDh / 8; ++nd) {
    float o[4] = {0.f, 0.f, 0.f, 0.f};
    const __nv_bfloat16* vr = vt + (nd * 8 + g) * kLdVt + 2 * t;
#pragma unroll
    for (int kk = 0; kk < kKeyTiles / 2; ++kk)
      mma_bf16_16816(o, pa[kk], load_u32(vr + kk * 16),
                     load_u32(vr + kk * 16 + 8));
    const int c = nd * 8 + 2 * t;
    if (r0 < n)
      *reinterpret_cast<uint32_t*>(o0 + c) = pack_bf16(o[0], o[1]);
    if (r1 < n)
      *reinterpret_cast<uint32_t*>(o1 + c) = pack_bf16(o[2], o[3]);
  }
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
int launch_bf16(const void* qn, const void* kn, const void* v,
                const void* bias, void* out, int pairs, int bw, int n,
                cudaStream_t stream) {
  core_kernel_bf16<kDh><<<pairs, kCoreThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(qn),
      static_cast<const __nv_bfloat16*>(kn),
      static_cast<const __nv_bfloat16*>(v), static_cast<const float*>(bias),
      static_cast<__nv_bfloat16*>(out), bw, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qn, kn, v and out: (heads, bw, n, dh), f32 or bf16 (is_bf16); bias: f32
// (heads, n, n).  All contiguous.  n <= 64; dh a multiple of 16, <= 64.
// Launches heads * bw CTAs of 128 threads on `stream` and returns
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
  const int p = static_cast<int>(pairs);
  if (!is_bf16) {
    const size_t smem = 2 * static_cast<size_t>(kRows) * (dh + 4) *
                        sizeof(float);
    core_kernel_f32<<<p, kCoreThreads, smem, st>>>(
        static_cast<const float*>(qn), static_cast<const float*>(kn),
        static_cast<const float*>(v), static_cast<const float*>(bias),
        static_cast<float*>(out), bw, n, dh);
    return static_cast<int>(cudaGetLastError());
  }
  switch (dh) {
    case 16: return launch_bf16<16>(qn, kn, v, bias, out, p, bw, n, st);
    case 32: return launch_bf16<32>(qn, kn, v, bias, out, p, bw, n, st);
    case 48: return launch_bf16<48>(qn, kn, v, bias, out, p, bw, n, st);
    default: return launch_bf16<64>(qn, kn, v, bias, out, p, bw, n, st);
  }
}
