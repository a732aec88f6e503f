// The weight gradients of the window-attention backward for Hopper
// (sm_90a), from the per-window operands that K3 writes.
//
// Replaces the weight-gradient products of
// vit_grid_model_tpu/ops/pallas/attention.py::_attention_bwd_kernel, which
// the TPU kernel adds into one output block across its sequential grid:
//   dWqkv_h += xf^T . [dQ|dK|dV]_h      (dim x 3dh per head)
//   dWout_h += O_h^T . dY               (dh x dim per head)
// K3's tensor-core path (window_attention_bwd.cu) writes, for the rows < n
// of every window, the T-rounded operands of those products in bf16: xf
// (R, dim), dQ|dK|dV (R, heads * 3dh) and O (R, heads * dh), R = Bw * n.
// This kernel sums them over all R rows: two products C = A^T B with A
// (R x M) and B (R x N) row-major bf16, f32 sums (M x N = dim x heads * 3dh
// from xf and dQ|dK|dV; heads * dh x dim from O and dY).
//
// What bounds it on an H100: bytes.  At Bw = 1,440 (R = 76,320, dim 128, 32
// heads x 32) the operands are 664 MB, 0.198 ms at 3.35 TB/s, against 80
// GFLOP, 0.081 ms at 989 TFLOP/s.
//
// Design.  A CTA of 8 warps computes one 128 x 128 tile of C over one fixed
// chunk of kChunkRows rows (split-K: 32 tiles x 19 chunks at that shape),
// the chunk streamed through shared memory in 32-row stages by cp.async,
// one stage loading while the other is used.  Warp w owns the 64 x 32
// sub-tile (w % 2, w / 2), reads its fragments with ldmatrix.trans (the
// operands sit row by row, transposed to the products' view) and runs
// mma.sync m16n8k16.  Rows past the chunk and columns past M or N are
// zero-filled by the copies.  Each (tile, chunk) writes its f32 partial in
// the layout of K3's gradient output; a second kernel sums the chunks in
// chunk order, so two runs give bit-identical gradients, with no atomics.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kBM = 128;            // tile rows (of A's columns)
constexpr int kBN = 128;            // tile columns (of B's columns)
constexpr int kBK = 32;             // operand rows a stage
constexpr int kChunkRows = 4096;    // operand rows a split-K chunk
constexpr int kLdA = kBM + 8;       // stage row strides (bf16): 16-byte rows
constexpr int kLdB = kBN + 8;       // on distinct banks for ldmatrix
constexpr int kStageElems = kBK * (kLdA + kLdB);
constexpr int kSmemBytes = 2 * kStageElems * 2;

// One product C = A^T B: A (rows x m) and B (rows x n) bf16 row-major.
// Element (i, j) of C goes to out + (j / group) * m * group + i * group +
// j % group of a partial: for dWqkv (group 3dh) the (heads, dim, 3dh)
// layout, for dWout (group n) the (heads * dh, dim) one.
struct Product {
  const bf16* a;
  const bf16* b;
  int m, n, group, tiles_m, tiles;
  long out;
};

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool full) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(full ? 16 : 0));
}

// Rows k0..k0+kBK-1 of the chunk (those < k_end; the rest zero) of A's
// columns m0.. and B's columns n0.. into one stage.
__device__ __forceinline__ void load_stage(bf16* st, const Product& p,
                                           int m0, int n0, int k0,
                                           int k_end) {
  constexpr int kChunksA = kBM / 8;  // 16-byte pieces of a row
  for (int e = threadIdx.x; e < kBK * (kChunksA + kBN / 8); e += kThreads) {
    const bool is_a = e < kBK * kChunksA;
    const int f = is_a ? e : e - kBK * kChunksA;
    const int per = is_a ? kChunksA : kBN / 8;
    const int r = f / per;
    const int c = (f % per) * 8;
    const int row = k0 + r;
    const int col = (is_a ? m0 : n0) + c;
    const int width = is_a ? p.m : p.n;
    const bool full = row < k_end && col < width;
    const bf16* src = is_a ? p.a : p.b;
    if (full) src += static_cast<size_t>(row) * width + col;
    bf16* dst = is_a ? st + r * kLdA + c : st + kBK * kLdA + r * kLdB + c;
    cp_async16_zfill(dst, src, full);
  }
  cp_async_commit();
}

__global__ void __launch_bounds__(kThreads, 2)
    wgrad_kernel(Product p0, Product p1, float* __restrict__ partials,
                 long partial_floats, int rows) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  const bool second = blockIdx.x >= p0.tiles;
  const Product p = second ? p1 : p0;
  const int tile = second ? blockIdx.x - p0.tiles : blockIdx.x;
  const int m0 = (tile % p.tiles_m) * kBM;
  const int n0 = (tile / p.tiles_m) * kBN;
  const int chunk = blockIdx.y;
  const int k_begin = chunk * kChunkRows;
  const int k_end = min(rows, k_begin + kChunkRows);
  const int steps = (k_end - k_begin + kBK - 1) / kBK;

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = (warp & 1) * 64;  // the warp's 64 x 32 sub-tile
  const int wn = (warp >> 1) * 32;
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  // ldmatrix row addresses: A's 8 x 8 blocks (k 0-7 | 8-15) x (m 0-7 |
  // 8-15) in the order of the A fragment; B's (k 0-7 | 8-15) x (two 8-column
  // tiles) in the order b0, b1 of each tile
  const int a_k = (lane & 7) + ((lane >> 4) << 3);
  const int a_m = ((lane >> 3) & 1) * 8;
  const int b_k = (lane & 7) + (((lane >> 3) & 1) << 3);
  const int b_n = (lane >> 4) * 8;

  load_stage(stages, p, m0, n0, k_begin, k_end);
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) {
      load_stage(stages + ((s + 1) & 1) * kStageElems, p, m0, n0,
                 k_begin + (s + 1) * kBK, k_end);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* sa = stages + (s & 1) * kStageElems;
    const bf16* sb = sa + kBK * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldmatrix_x4_trans(a[i], sa + (kk + a_k) * kLdA + wm + 16 * i + a_m);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, sb + (kk + b_k) * kLdB + wn + 16 * j + b_n);
        b[2 * j][0] = r[0];
        b[2 * j][1] = r[1];
        b[2 * j + 1][0] = r[2];
        b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_bf16_16816(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the stage is consumed before it is loaded again
  }

  float* out = partials + static_cast<size_t>(chunk) * partial_floats +
               p.out;
  const int g = lane >> 2;
  const int t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + wn + 8 * j + 2 * t;  // even: col, col + 1 share
      if (col >= p.n) continue;                // a group (group is even)
      const size_t at = static_cast<size_t>(col / p.group) * p.m * p.group +
                        col % p.group;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm + 16 * i + g + 8 * half;
        if (row < p.m)
          *reinterpret_cast<float2*>(out + at +
                                     static_cast<size_t>(row) * p.group) =
              make_float2(acc[i][j][2 * half], acc[i][j][2 * half + 1]);
      }
    }
  }
}

// out[i] = sum_c partials[c][i], c = 0, 1, ... in order.
__global__ void sum_chunks_kernel(const float* __restrict__ partials,
                                  float* __restrict__ out, int chunks,
                                  long floats) {
  for (long i = blockIdx.x * static_cast<long>(blockDim.x) + threadIdx.x;
       i < floats; i += static_cast<long>(gridDim.x) * blockDim.x) {
    float acc = 0.f;
    for (int c = 0; c < chunks; ++c) acc += partials[c * floats + i];
    out[i] = acc;
  }
}

Product make_product(const void* a, const void* b, int m, int n, int group,
                     long out) {
  Product p;
  p.a = static_cast<const bf16*>(a);
  p.b = static_cast<const bf16*>(b);
  p.m = m;
  p.n = n;
  p.group = group;
  p.tiles_m = (m + kBM - 1) / kBM;
  p.tiles = p.tiles_m * ((n + kBN - 1) / kBN);
  p.out = out;
  return p;
}

}  // namespace

// Floats of the f32 partials the kernel needs for R operand rows: one
// (dWqkv | dWout) block, heads * 4 * dim * dh floats, per chunk of rows.
extern "C" long vgm_window_attention_wgrad_partial_floats(int rows, int dim,
                                                          int heads, int dh) {
  const long chunks = (rows + kChunkRows - 1) / kChunkRows;
  return chunks * 4L * heads * dim * dh;
}

// dwqkv (heads, dim, 3dh) and dwout (heads, dh, dim), f32, contiguous (the
// first two blocks of K3's gradient output), from xf (rows, dim), dqkv
// (rows, heads * 3dh), o (rows, heads * dh) and dy (rows, dim), all bf16
// and contiguous; dim and dh multiples of 16.  partials: f32 scratch of
// vgm_window_attention_wgrad_partial_floats.  Launches on `stream` and
// returns cudaGetLastError().
extern "C" int vgm_window_attention_wgrad(const void* xf, const void* dqkv,
                                          const void* o, const void* dy,
                                          void* dwqkv, void* partials,
                                          int rows, int dim, int heads,
                                          int dh, void* stream) {
  if (rows < 1 || dim < 16 || dim % 16 != 0 || heads < 1 || dh < 16 ||
      dh % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long floats = 4L * heads * dim * dh;
  const Product pq = make_product(xf, dqkv, dim, heads * 3 * dh, 3 * dh, 0);
  const Product po = make_product(o, dy, heads * dh, dim, dim,
                                  3L * heads * dim * dh);
  const int chunks = (rows + kChunkRows - 1) / kChunkRows;
  cudaError_t err = cudaFuncSetAttribute(
      wgrad_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  wgrad_kernel<<<dim3(pq.tiles + po.tiles, chunks), kThreads, kSmemBytes,
                 st>>>(pq, po, static_cast<float*>(partials), floats, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sum_chunks_kernel<<<static_cast<int>((floats + 255) / 256), 256, 0, st>>>(
      static_cast<const float*>(partials), static_cast<float*>(dwqkv),
      chunks, floats);
  return static_cast<int>(cudaGetLastError());
}
