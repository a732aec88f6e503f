// The core of the legacy station and grid models' single-head masked
// self-attention, for the inference forward (ops/cuda/joint_attention.py;
// ops/recurrent.py::mha_self_attention):
//
//   S = q k^T / sqrt(E), with the keys that key_padding_mask excludes at -inf
//   P = softmax(S) over each row; a row with no valid key gives zeros
//   out = P v
//
// batch first, one head of width E: q, k and v are the three column blocks
// of the in-projection's (B, n, 3E) output, read in place at row stride
// 3E; out is (B, n, E).  The in- and out-projections stay cuBLAS products.
//
// It replaces no TPU kernel: the JAX package's
// ops/recurrent.py::mha_self_attention is plain jnp, fused by XLA.  Eager
// PyTorch formed the (B, n, n) f32 score map and passed over it about eight
// times (scale, masked_fill's copy, amax, subtract, exp, sum, divide,
// where) before P v: at the grid model's B 24, n 6,044 a pass is 3.51 GB.
//
// What bounds it on an H100: f32 operations on the CUDA cores.  q k^T and
// P v are 2 x 2 B n^2 E operations, 449 GFLOP at B 24, n 6,044, E 128:
// 6.70 ms at 67 TFLOP/s (FFMA; no tensor core, since the callers run in
// f32 with TF32 off), where q, k, v read once and out written once are
// 0.30 GB (0.09 ms).  An SM issues one warp instruction a clock on each of
// its four schedulers and an FFMA fills one; measured on an H100, every
// 16-byte shared-memory load also holds the SM about two more clocks,
// whatever the lanes' addresses.  So the design keeps the map on chip and
// spends the registers on large lane tiles, which need the fewest loads an
// FFMA:
//
// * One CTA a tile of kRows = 128 query rows of one sample, 8 warps of 16
//   rows; the CTA streams the sample's keys in tiles of kKeys = 64.  q's
//   tile is staged once.  k's and v's tiles come by 16-byte cp.async
//   copies, each while the other is in use: v's while q k^T runs, the next
//   k's while P v runs (a ragged last tile, and q's rows >= n,
//   zero-filled), so one buffer each fits beside q and P (168,192 bytes,
//   one CTA an SM).  The tile's key bias (-inf past n or where the bool
//   mask excludes the key, else 0) is read from the mask a tile ahead.
// * S = q k^T is register-tiled as an SGEMM: lane (tr, tc) of a warp holds
//   rows tr + 2i (i < 8) and keys tc + 16j (j < 4) and walks d four at a
//   time with 16-byte loads of q's and k's rows, both in their own [row][d]
//   layout at a stride of E + 4 floats (the lanes' rows on distinct banks):
//   12 loads a 128 FFMA.  Laying q and k d-major would take as many loads
//   for as many FFMA and a transpose of every k tile; this way k arrives by
//   cp.async as it lies.
// * Online softmax in the log2 domain: scores scaled by log2(e)/sqrt(E),
//   the bias added, the row's tile max by four xor shuffles among the 16
//   lanes of a row, the running max and each lane's part of the running
//   sum rescaled by exp2f(m_old - m_new), p = exp2f(s - m).  A row whose
//   keys so far are all masked keeps max -inf and sums 0, so it ends at 0
//   and stores zeros, as the eager version's where(denom > 0) does.
// * P goes through shared memory key-major ([key][row], a lane's eight
//   rows as two 16-byte vectors); a warp reads back only its own rows.  O
//   (8 rows x 8 columns a lane, columns 4 tc + 64 g) accumulates P v from
//   two 16-byte loads of P and two of v a key: 4 loads a 64 FFMA.  O is
//   rescaled with the sum.
// * The end: the row sum over the 16 lanes, o / l (0 where l is 0) in
//   16-byte stores, 256 contiguous bytes a row.
//
// On an H100 SXM at 700 W, B 24, n 6,044: 10.9-11.0 ms, 61% of the bound,
// against 12.2 ms for 32-key tiles with 4 x 4 and 4 x 16 lane tiles (the
// 16-byte loads an FFMA cut by a fifth); prefetching the next operands into
// registers and 12 warps an SM (spilling) measured no faster.  Sums run in
// a fixed order (d ascending in a score, keys ascending in O), so a launch
// is deterministic.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 128;       // query rows a CTA
constexpr int kWarpRows = 16;    // query rows a warp
constexpr int kKeys = 64;        // keys a tile
constexpr int kPad = 4;          // floats of row padding
constexpr unsigned kFull = 0xffffffffu;

static_assert(kThreads / 32 * kWarpRows == kRows, "a warp a row strip");
static_assert(kKeys <= kThreads, "a thread a key's bias");

template <int E>
struct Plan {
  static_assert(E % 64 == 0, "E a multiple of 64");
  static constexpr int kQld = E + kPad;        // q and k tiles' row stride
  static constexpr int kPld = kRows + kPad;    // P's row (key) stride
  static constexpr int kQ = kRows * kQld;
  static constexpr int kK = kKeys * kQld;
  static constexpr int kV = kKeys * E;
  static constexpr int kP = kKeys * kPld;
  // q, k, v, P and the key bias
  static constexpr size_t kSmem =
      sizeof(float) * (kQ + kK + kV + kP + kKeys);
  static constexpr int kGroups = E / 64;       // O's 4-column groups a lane
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float neg_inf() {
  return __int_as_float(0xff800000);
}

// Rows r0.. of one column block (column offset col0 in a row of 3E) into
// dst at row stride ld: `rows` of them, those from row n on zero.
template <int E>
__device__ __forceinline__ void stage(float* dst, int ld, const float* src,
                                      int col0, int r0, int rows, int n) {
  constexpr int kChunks = E / 4;
  for (int c = threadIdx.x; c < rows * kChunks; c += kThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 4;
    const int row = r0 + r;
    cp_async16_zfill(
        dst + r * ld + col,
        src + static_cast<size_t>(min(row, n - 1)) * 3 * E + col0 + col,
        row < n);
  }
  cp_async_commit();
}

// The score bias of a key: -inf past n or where the mask excludes it.
__device__ __forceinline__ float key_bias(const unsigned char* mask, int key,
                                          int n) {
  if (key >= n) return neg_inf();
  return (mask != nullptr && mask[key] != 0) ? neg_inf() : 0.f;
}

template <int E>
__global__ void __launch_bounds__(kThreads, 1)
    joint_attention_kernel(const float* __restrict__ qkv,
                           const unsigned char* __restrict__ mask,
                           float* __restrict__ out, int n, float scale_log2) {
  using P = Plan<E>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + P::kQ;
  float* vs = ks + P::kK;
  float* ps = vs + P::kV;
  float* kbias = ps + P::kP;

  const int b = blockIdx.y;
  const int q0 = blockIdx.x * kRows;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int tr = lane >> 4, tc = lane & 15;
  const float* src = qkv + static_cast<size_t>(b) * n * 3 * E;
  const unsigned char* mrow =
      mask == nullptr ? nullptr : mask + static_cast<size_t>(b) * n;
  const int tiles = (n + kKeys - 1) / kKeys;

  stage<E>(qs, P::kQld, src, 0, q0, kRows, n);
  stage<E>(ks, P::kQld, src, E, 0, kKeys, n);
  if (tid < kKeys) kbias[tid] = key_bias(mrow, tid, n);

  // this lane's rows are warp * 16 + tr + 2 i (i < 8), its keys tc + 16 j
  // (j < 4), its O columns 4 tc + 64 g; P holds row tr + 2 i of the warp
  // at column 8 tr + i, so a lane's eight rows are two 16-byte vectors
  float o[8][4 * P::kGroups];
  float m[8], l[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = neg_inf();
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * P::kGroups; ++c) o[i][c] = 0.f;
  }
  const float* qrow = qs + (warp * kWarpRows + tr) * P::kQld;
  const float* krow = ks + tc * P::kQld;
  const float* vcol = vs + 4 * tc;
  float* pcol = ps + warp * kWarpRows + 8 * tr;

  for (int t = 0; t < tiles; ++t) {
    // k's tile and its bias arrived; every warp has left v's buffer
    cp_async_wait_all();
    __syncthreads();
    stage<E>(vs, E, src, 2 * E, t * kKeys, kKeys, n);
    const float next_bias =
        tid < kKeys ? key_bias(mrow, (t + 1) * kKeys + tid, n) : 0.f;

    float s[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < E; d += 4) {
      float4 k4[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) k4[j] = ld4(krow + 16 * j * P::kQld + d);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float4 a = ld4(qrow + 2 * i * P::kQld + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a.x, k4[j].x, s[i][j]);
          s[i][j] = fmaf(a.y, k4[j].y, s[i][j]);
          s[i][j] = fmaf(a.z, k4[j].z, s[i][j]);
          s[i][j] = fmaf(a.w, k4[j].w, s[i][j]);
        }
      }
    }

    float bias[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) bias[j] = kbias[tc + 16 * j];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = neg_inf();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(s[i][j], scale_log2, bias[j]);
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 16; w <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, w));
      const float m_new = fmaxf(m[i], mx);
      // no valid key yet: p = 0 for every key so far
      const float m_use = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = exp2f(s[i][j] - m_use);
        sum += s[i][j];
      }
      l[i] = fmaf(l[i], alpha, sum);
#pragma unroll
      for (int c = 0; c < 4 * P::kGroups; ++c) o[i][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float* dst = pcol + (tc + 16 * j) * P::kPld;
      st4(dst, make_float4(s[0][j], s[1][j], s[2][j], s[3][j]));
      st4(dst + 4, make_float4(s[4][j], s[5][j], s[6][j], s[7][j]));
    }

    // v's tile arrived and every warp has left k's buffer and the bias
    cp_async_wait_all();
    __syncthreads();
    if (t + 1 < tiles) {
      stage<E>(ks, P::kQld, src, E, (t + 1) * kKeys, kKeys, n);
      if (tid < kKeys) kbias[tid] = next_bias;
    }

#pragma unroll 8
    for (int k = 0; k < kKeys; ++k) {
      const float4 p0 = ld4(pcol + k * P::kPld);
      const float4 p1 = ld4(pcol + k * P::kPld + 4);
      const float pi[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int g = 0; g < P::kGroups; ++g) {
        const float4 v = ld4(vcol + k * E + 64 * g);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          o[i][4 * g + 0] = fmaf(pi[i], v.x, o[i][4 * g + 0]);
          o[i][4 * g + 1] = fmaf(pi[i], v.y, o[i][4 * g + 1]);
          o[i][4 * g + 2] = fmaf(pi[i], v.z, o[i][4 * g + 2]);
          o[i][4 * g + 3] = fmaf(pi[i], v.w, o[i][4 * g + 3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float sum = l[i];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) sum += __shfl_xor_sync(kFull, sum, w);
    const int row = q0 + warp * kWarpRows + tr + 2 * i;
    if (row >= n) continue;
    float* dst = out + (static_cast<size_t>(b) * n + row) * E + 4 * tc;
#pragma unroll
    for (int g = 0; g < P::kGroups; ++g) {
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (sum > 0.f)
        y = make_float4(o[i][4 * g] / sum, o[i][4 * g + 1] / sum,
                        o[i][4 * g + 2] / sum, o[i][4 * g + 3] / sum);
      st4(dst + 64 * g, y);
    }
  }
}

template <int E>
int run(const float* qkv, const unsigned char* mask, float* out, int batch,
        int n, cudaStream_t stream) {
  const size_t smem = Plan<E>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(
      joint_attention_kernel<E>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((n + kRows - 1) / kRows),
                  static_cast<unsigned>(batch));
  const float scale_log2 =
      static_cast<float>(1.4426950408889634 / sqrt(static_cast<double>(E)));
  joint_attention_kernel<E>
      <<<grid, kThreads, smem, stream>>>(qkv, mask, out, n, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// qkv (batch, n, 3 e) f32, mask (batch, n) bool or null, out (batch, n, e)
// f32; every pointer 16-byte aligned but the mask's.  Widths: 128.
extern "C" int vgm_joint_attention(const void* qkv, const void* mask,
                                   void* out, int batch, int n, int e,
                                   void* stream) {
  if (batch < 1 || batch > 65535 || n < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (reinterpret_cast<uintptr_t>(qkv) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* q = static_cast<const float*>(qkv);
  const auto* mk = static_cast<const unsigned char*>(mask);
  auto* y = static_cast<float*>(out);
  switch (e) {
    case 128:
      return run<128>(q, mk, y, batch, n, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
