// Fused inference MBConv for Hopper (sm_90a).
//
// Replaces benchmarks/mosaic_repros/repro_fused_mbconv.py::kernel (:63),
// as its `build` launches it at :101 (one sample per program) and :113
// (four samples per program).  With the BatchNorms folded into the convs it
// computes, for x of (N, H, W, C) channels-last:
//
//   h1 = gelu(x . we + be)                        1x1 expand, C -> HID
//   h2 = gelu(dw3x3(h1) + bd)                     depthwise, SAME zero pad
//   g  = sigmoid(relu(mean_HW(h2) . w1 + b1) . w2 + b2)   squeeze-excite
//   y  = (h2 * g) . wp + bp + x                   1x1 project + residual
//
// with the exact (erf) GELU.  Every product takes its operands rounded to
// x's type and sums in f32; h1, mean(h2), the SE hidden and h2 * g are
// rounded to x's type before the product that reads them, as
// repro_fused_mbconv.py::xla_reference casts.  The weights arrive in f32 and
// are rounded as they are staged.
//
// What bounds it on an H100.  At 42 x 35, 128 -> 512 one sample costs
// ~399 MFLOP (expand 193, project 193, depthwise 13.5) against 376 KB of x
// and y in bf16, ~1,060 operations a byte: above the card's ~295, so the
// tensor cores bound the whole block (0.155 ms for BN = 384 at 989
// TFLOP/s, against 0.086 ms to read x and write y once).
//
// What this design does about it, and where the TPU design does not carry
// over.  The TPU kernel holds a whole sample (h1 and h2, 3 MB each in f32)
// in VMEM; a block here has 227 KB.  The SE gate needs the mean of h2 over
// the whole sample before the project can start, so the work is split in
// three launches, with no float atomics (a second launch is bit-identical):
//   (a) row tiles of `th` rows with a one-row halo: stage x, then per chunk
//       of 64 hidden channels run the expand on the tile and its halo (the
//       halo's expand is recomputed), GELU, the depthwise conv and GELU;
//       write h2 in x's type and the tile's per-channel sums of the f32 h2;
//   (b) per sample, sum the tiles' partial sums in tile order and run the
//       SE MLP on CUDA cores;
//   (c) tiles of 64 pixels: h2 * g -> project -> + bp + x.
// In bf16 the two 1x1 products run on the tensor cores (wmma 16x16x16, f32
// sums), the ragged last M tile zero-padded; the f32 path runs them on
// CUDA-core FMAs (TF32 would miss the f32 tolerance).  The h2 round trip
// through device memory costs ~1.16 GB at BN = 384 in bf16 (~0.35 ms at
// 3.35 TB/s); one pass with h2 kept on chip, wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "attention_common.cuh"

namespace {

constexpr int kChunk = 64;       // hidden channels per pass; K chunk of (c)
constexpr int kPix = 64;         // pixels per tile of the project stage
constexpr int kMaxRowTile = 8;   // most output rows per tile of stage (a)
constexpr size_t kSmemMax = 232448;
constexpr size_t kSmemTwoBlocks = 113 * 1024;  // two blocks on one SM

__device__ __forceinline__ float gelu(float v) {
  return 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
}

// C[M x N] (+)= A[M x K] . B[K x N] on CUDA cores, f32 in shared memory,
// all row-major; M and N multiples of 4.  Thread t owns the 4 x 4 blocks
// t, t + kThreads, ...
__device__ void fma_mm(int M, int N, int K, const float* A, int lda,
                       const float* B, int ldb, float* C, int ldc,
                       bool accumulate) {
  const int nb = N / 4;
  for (int blk = threadIdx.x; blk < (M / 4) * nb; blk += kThreads) {
    const int r0 = (blk / nb) * 4;
    const int c0 = (blk % nb) * 4;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[i][j] = accumulate ? C[(r0 + i) * ldc + c0 + j] : 0.f;
    for (int k = 0; k < K; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = A[(r0 + i) * lda + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = B[k * ldb + c0 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) C[(r0 + i) * ldc + c0 + j] = acc[i][j];
  }
  __syncthreads();
}

// C = A . B (accumulate: C +=) with T operands in shared memory.
template <typename T>
__device__ void tile_mm(int M, int N, int K, const T* A, int lda, const T* B,
                        int ldb, float* C, int ldc, bool accumulate) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    wmma_mm<nvcuda::wmma::row_major, nvcuda::wmma::row_major>(
        M, N, K, A, lda, B, ldb, C, ldc, accumulate);
  else
    fma_mm(M, N, K, A, lda, B, ldb, C, ldc, accumulate);
}

// ---------------------------------------------------------------------------
// (a) expand -> GELU -> depthwise -> GELU on row tiles
// ---------------------------------------------------------------------------

// Shared memory of stage (a) for a tile of `rows` image rows (the halo
// included) of `w` pixels: the x tile (rows padded to 16), one chunk of the
// expand weights, h1 of the chunk in f32, the chunk's taps and biases, and
// the channel sums of the thread groups.  bf16 strides are padded to the
// 16-byte multiples wmma needs; f32 A strides are odd to spread banks.
struct PlanA {
  int m_pad, ldx, ldw, ldh;
  size_t xs, ws, h1, wd, bias, sums, bytes;
};

template <typename T>
__host__ __device__ PlanA plan_a(int rows, int w, int c) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  PlanA p{};
  p.m_pad = (rows * w + 15) / 16 * 16;
  p.ldx = kTC ? c + 8 : c + 1;
  p.ldw = kTC ? kChunk + 8 : kChunk;
  p.ldh = kChunk + 4;
  size_t off = 0;
  p.xs = off;
  off = align128(off + sizeof(T) * p.m_pad * p.ldx);
  p.ws = off;
  off = align128(off + sizeof(T) * c * p.ldw);
  p.h1 = off;
  off = align128(off + sizeof(float) * p.m_pad * p.ldh);
  p.wd = off;
  off = align128(off + sizeof(float) * 9 * kChunk);
  p.bias = off;
  off = align128(off + sizeof(float) * 2 * kChunk);
  p.sums = off;
  off = align128(off + sizeof(float) * kThreads);
  p.bytes = off;
  return p;
}

// The output rows of a tile of stage (a): the most that fit two blocks on
// an SM, else the most that fit one; 0 when not even one row fits.
template <typename T>
int row_tile(int w, int c) {
  for (size_t budget : {kSmemTwoBlocks, kSmemMax})
    for (int th = kMaxRowTile; th >= 1; --th)
      if (plan_a<T>(th + 2, w, c).bytes <= budget) return th;
  return 0;
}

// grid (tiles, ceil(N / spb)); block (tile, j) runs samples j*spb ..
// j*spb + spb - 1.  h2: (N, H, W, HID) in T; partial: (N, tiles, HID) f32.
template <typename T, int C, int HID>
__global__ void __launch_bounds__(kThreads)
    mbconv_expand_dw_kernel(const T* __restrict__ x,
                            const float* __restrict__ we,
                            const float* __restrict__ be,
                            const float* __restrict__ wd,
                            const float* __restrict__ bd, T* __restrict__ h2,
                            float* __restrict__ partial, int n_samples, int h,
                            int w, int th, int spb) {
  static_assert(kThreads % kChunk == 0 && HID % kChunk == 0, "chunking");
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanA p = plan_a<T>(th + 2, w, C);
  T* xs = reinterpret_cast<T*>(smem + p.xs);
  T* ws = reinterpret_cast<T*>(smem + p.ws);
  float* h1 = reinterpret_cast<float*>(smem + p.h1);
  float* wds = reinterpret_cast<float*>(smem + p.wd);
  float* bes = reinterpret_cast<float*>(smem + p.bias);
  float* bds = bes + kChunk;
  float* sums = reinterpret_cast<float*>(smem + p.sums);

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int r0 = tile * th;             // first output row of the tile
  const int m = (th + 2) * w;           // staged pixels, halo rows included
  const int hw = h * w;
  const int out_rows = min(th, h - r0);
  const int j = tid % kChunk;           // this thread's channel in stage 3

  for (int s = 0; s < spb; ++s) {
    const int n = blockIdx.y * spb + s;
    if (n >= n_samples) break;
    const T* xn = x + static_cast<size_t>(n) * hw * C;
    __syncthreads();                    // the previous sample's xs is read
    // staged pixel q is image row r0 - 1 + q / w, column q % w; rows off
    // the image and the padding past m are zero
    for (int e = tid; e < p.m_pad * C; e += kThreads) {
      const int q = e / C;
      const int k = e % C;
      const int r = r0 - 1 + q / w;
      T v = from_f32<T>(0.f);
      if (q < m && r >= 0 && r < h)
        v = xn[(static_cast<size_t>(r) * w + q % w) * C + k];
      xs[q * p.ldx + k] = v;
    }
    for (int c0 = 0; c0 < HID; c0 += kChunk) {
      __syncthreads();                  // the previous chunk is consumed
      for (int e = tid; e < C * kChunk; e += kThreads) {
        const int k = e / kChunk;
        const int cc = e % kChunk;
        ws[k * p.ldw + cc] = from_f32<T>(we[static_cast<size_t>(k) * HID +
                                            c0 + cc]);
      }
      for (int e = tid; e < 9 * kChunk; e += kThreads)
        wds[e] = round_to<T>(wd[(e / kChunk) * HID + c0 + e % kChunk]);
      if (tid < kChunk) {
        bes[tid] = be[c0 + tid];
        bds[tid] = bd[c0 + tid];
      }
      __syncthreads();

      // 1. h1 = x . we over the tile and its halo (f32 sums)
      tile_mm<T>(p.m_pad, kChunk, C, xs, p.ldx, ws, p.ldw, h1, p.ldh, false);

      // 2. h1 <- gelu(h1 + be) rounded to T; zero on rows off the image,
      //    which is the depthwise conv's padding
      for (int e = tid; e < m * kChunk; e += kThreads) {
        const int q = e / kChunk;
        const int cc = e % kChunk;
        const int r = r0 - 1 + q / w;
        float* hp = h1 + q * p.ldh + cc;
        *hp = (r >= 0 && r < h) ? round_to<T>(gelu(*hp + bes[cc])) : 0.f;
      }
      __syncthreads();

      // 3. h2 = gelu(dw3x3(h1) + bd) on the tile's own rows; thread tid
      //    keeps channel j (kThreads is a multiple of kChunk) and sums the
      //    f32 h2 of its pixels in order
      float csum = 0.f;
      for (int e = tid; e < out_rows * w * kChunk; e += kThreads) {
        const int px = e / kChunk;
        const int ri = px / w + 1;      // staged row of the output pixel
        const int col = px % w;
        float acc = 0.f;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int cc = col + dx - 1;
            if (cc >= 0 && cc < w)
              acc = fmaf(h1[((ri + dy - 1) * w + cc) * p.ldh + j],
                         wds[(dy * 3 + dx) * kChunk + j], acc);
          }
        const float v = gelu(acc + bds[j]);
        csum += v;
        h2[(static_cast<size_t>(n) * hw +
            static_cast<size_t>(r0 + ri - 1) * w + col) * HID + c0 + j] =
            from_f32<T>(v);
      }
      sums[tid] = csum;
      __syncthreads();
      if (tid < kChunk) {
        float t = 0.f;
        for (int g = 0; g < kThreads / kChunk; ++g) t += sums[g * kChunk + tid];
        partial[(static_cast<size_t>(n) * gridDim.x + tile) * HID + c0 + tid] =
            t;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// (b) the squeeze-excite gate, one block per sample
// ---------------------------------------------------------------------------

template <typename T, int HID, int SE>
__global__ void __launch_bounds__(kThreads)
    mbconv_se_kernel(const float* __restrict__ partial,
                     const float* __restrict__ w1,
                     const float* __restrict__ b1,
                     const float* __restrict__ w2,
                     const float* __restrict__ b2, float* __restrict__ gate,
                     int tiles, int hw) {
  __shared__ float mean[HID];
  __shared__ float hidden[SE];
  const int n = blockIdx.x;
  const float* pn = partial + static_cast<size_t>(n) * tiles * HID;
  for (int c = threadIdx.x; c < HID; c += kThreads) {
    float t = 0.f;
    for (int i = 0; i < tiles; ++i) t += pn[i * HID + c];
    mean[c] = round_to<T>(t / static_cast<float>(hw));
  }
  __syncthreads();
  for (int k = threadIdx.x; k < SE; k += kThreads) {
    float a = 0.f;
    for (int c = 0; c < HID; ++c)
      a = fmaf(mean[c], round_to<T>(w1[c * SE + k]), a);
    hidden[k] = round_to<T>(fmaxf(a + b1[k], 0.f));
  }
  __syncthreads();
  for (int c = threadIdx.x; c < HID; c += kThreads) {
    float a = 0.f;
    for (int k = 0; k < SE; ++k)
      a = fmaf(hidden[k], round_to<T>(w2[k * HID + c]), a);
    gate[static_cast<size_t>(n) * HID + c] = 1.f / (1.f + expf(-(a + b2[c])));
  }
}

// ---------------------------------------------------------------------------
// (c) h2 * g -> project -> + bp + x on tiles of kPix pixels
// ---------------------------------------------------------------------------

struct PlanC {
  int ldh, ldw, ldy;
  size_t hs, ws, y, g, bytes;
};

template <typename T>
__host__ __device__ PlanC plan_c(int c, int hid) {
  constexpr bool kTC = std::is_same<T, __nv_bfloat16>::value;
  PlanC p{};
  p.ldh = kTC ? kChunk + 8 : kChunk + 1;
  p.ldw = kTC ? c + 8 : c;
  p.ldy = c + 4;
  size_t off = 0;
  p.hs = off;
  off = align128(off + sizeof(T) * kPix * p.ldh);
  p.ws = off;
  off = align128(off + sizeof(T) * kChunk * p.ldw);
  p.y = off;
  off = align128(off + sizeof(float) * kPix * p.ldy);
  p.g = off;
  off = align128(off + sizeof(float) * hid);
  p.bytes = off;
  return p;
}

// grid (ceil(HW / kPix), ceil(N / spb)).
template <typename T, int C, int HID>
__global__ void __launch_bounds__(kThreads)
    mbconv_project_kernel(const T* __restrict__ x, const T* __restrict__ h2,
                          const float* __restrict__ gate,
                          const float* __restrict__ wp,
                          const float* __restrict__ bp, T* __restrict__ out,
                          int n_samples, int hw, int spb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanC p = plan_c<T>(C, HID);
  T* hs = reinterpret_cast<T*>(smem + p.hs);
  T* ws = reinterpret_cast<T*>(smem + p.ws);
  float* y = reinterpret_cast<float*>(smem + p.y);
  float* g = reinterpret_cast<float*>(smem + p.g);
  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * kPix;
  const int np = min(kPix, hw - p0);

  for (int s = 0; s < spb; ++s) {
    const int n = blockIdx.y * spb + s;
    if (n >= n_samples) break;
    __syncthreads();                    // the previous sample is written
    for (int c = tid; c < HID; c += kThreads)
      g[c] = gate[static_cast<size_t>(n) * HID + c];
    const size_t base = static_cast<size_t>(n) * hw + p0;
    for (int k0 = 0; k0 < HID; k0 += kChunk) {
      __syncthreads();                  // g is staged; the last chunk read
      // h3 = h2 * g rounded to T, zero past the last pixel
      for (int e = tid; e < kPix * kChunk; e += kThreads) {
        const int pp = e / kChunk;
        const int k = e % kChunk;
        float v = 0.f;
        if (pp < np) v = to_f32(h2[(base + pp) * HID + k0 + k]) * g[k0 + k];
        hs[pp * p.ldh + k] = from_f32<T>(v);
      }
      for (int e = tid; e < kChunk * C; e += kThreads) {
        const int k = e / C;
        const int c = e % C;
        ws[k * p.ldw + c] = from_f32<T>(wp[static_cast<size_t>(k0 + k) * C +
                                           c]);
      }
      __syncthreads();
      tile_mm<T>(kPix, C, kChunk, hs, p.ldh, ws, p.ldw, y, p.ldy, k0 > 0);
    }
    for (int e = tid; e < np * C; e += kThreads) {
      const int pp = e / C;
      const int c = e % C;
      const size_t idx = (base + pp) * C + c;
      out[idx] = from_f32<T>(y[pp * p.ldy + c] + bp[c] + to_f32(x[idx]));
    }
  }
}

template <typename T, int C, int HID, int SE>
int launch(const void* x, const float* we, const float* be, const float* wd,
           const float* bd, const float* w1, const float* b1,
           const float* w2, const float* b2, const float* wp,
           const float* bp, void* out, void* h2, float* partial, float* gate,
           int n, int h, int w, int spb, cudaStream_t stream) {
  const int th = row_tile<T>(w, C);
  if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (h + th - 1) / th;
  const int groups = (n + spb - 1) / spb;
  const size_t smem_a = plan_a<T>(th + 2, w, C).bytes;
  const size_t smem_c = plan_c<T>(C, HID).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_expand_dw_kernel<T, C, HID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mbconv_project_kernel<T, C, HID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);

  mbconv_expand_dw_kernel<T, C, HID>
      <<<dim3(tiles, groups), kThreads, smem_a, stream>>>(
          static_cast<const T*>(x), we, be, wd, bd, static_cast<T*>(h2),
          partial, n, h, w, th, spb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mbconv_se_kernel<T, HID, SE><<<n, kThreads, 0, stream>>>(
      partial, w1, b1, w2, b2, gate, tiles, h * w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mbconv_project_kernel<T, C, HID>
      <<<dim3((h * w + kPix - 1) / kPix, groups), kThreads, smem_c,
         stream>>>(static_cast<const T*>(x), static_cast<const T*>(h2), gate,
                   wp, bp, static_cast<T*>(out), n, h * w, spb);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* x, const float* we, const float* be,
             const float* wd, const float* bd, const float* w1,
             const float* b1, const float* w2, const float* b2,
             const float* wp, const float* bp, void* out, void* h2,
             float* partial, float* gate, int n, int h, int w, int c,
             int hid, int se, int spb, cudaStream_t stream) {
  if (c == 128 && hid == 512 && se == 128)
    return launch<T, 128, 512, 128>(x, we, be, wd, bd, w1, b1, w2, b2, wp, bp,
                                     out, h2, partial, gate, n, h, w, spb,
                                     stream);
  if (c == 32 && hid == 128 && se == 32)
    return launch<T, 32, 128, 32>(x, we, be, wd, bd, w1, b1, w2, b2, wp, bp,
                                  out, h2, partial, gate, n, h, w, spb,
                                  stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Output rows per tile of the expand/depthwise stage for rows of w pixels
// and c input channels; 0 when a tile does not fit in shared memory.  The
// wrapper sizes `partial` with it: (n, ceil(h / tile), hid).
extern "C" int vgm_fused_mbconv_row_tile(int w, int c, int is_bf16) {
  if (w < 1 || c < 1) return 0;
  return is_bf16 ? row_tile<__nv_bfloat16>(w, c) : row_tile<float>(w, c);
}

// x, out: (n, h, w, c) channels-last in f32 or bf16 (is_bf16); weights f32:
// we (c, hid), be (hid), wd (3, 3, hid), bd (hid), w1 (hid, se), b1 (se),
// w2 (se, hid), b2 (hid), wp (hid, c), bp (c).  Scratch: h2 (n, h, w, hid)
// in x's type, partial (n, tiles, hid) and gate (n, hid) f32.  All
// contiguous.  (c, hid, se) is (128, 512, 128) or (32, 128, 32).  Launches
// the three stages on `stream` and returns the first CUDA error (0 on
// success).
extern "C" int vgm_fused_mbconv(const void* x, const void* we, const void* be,
                                const void* wd, const void* bd,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* wp, const void* bp, void* out,
                                void* h2, void* partial, void* gate, int n,
                                int h, int w, int c, int hid, int se,
                                int is_bf16, int samples_per_block,
                                void* stream) {
  if (n < 1 || h < 1 || w < 1 || samples_per_block < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (is_bf16)
    return dispatch<__nv_bfloat16>(
        x, f(we), f(be), f(wd), f(bd), f(w1), f(b1), f(w2), f(b2), f(wp),
        f(bp), out, h2, static_cast<float*>(partial),
        static_cast<float*>(gate), n, h, w, c, hid, se, samples_per_block, st);
  return dispatch<float>(x, f(we), f(be), f(wd), f(bd), f(w1), f(b1), f(w2),
                         f(b2), f(wp), f(bp), out, h2,
                         static_cast<float*>(partial),
                         static_cast<float*>(gate), n, h, w, c, hid, se,
                         samples_per_block, st);
}
