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
// repro_fused_mbconv.py::xla_reference casts.  Both designs also store h2
// in x's type between their stages, so in bf16 h2 * g is taken from h2
// rounded once more (the mean reads the f32 h2).  No float atomics: a
// second launch is bit-identical.
//
// What bounds it on an H100.  At 42 x 35, 128 -> 512 one sample costs
// ~399 MFLOP (expand 193, project 193, depthwise 13.5) against 376 KB of x
// and y in bf16: the tensor cores bound the whole block at 0.155 ms for
// BN = 384 (989 TFLOP/s), against 0.086 ms to read x and write y once.  Two
// costs sit beside that bound: the h2 round trip in bf16 (1.16 GB at BN =
// 384, ~0.35 ms at 3.35 TB/s), and the two exact GELUs and the depthwise
// conv, which run outside the tensor cores (~15 G operations, ~0.45 ms at
// the CUDA cores' 33.5 T operations/s).  The bands design below runs both
// products on wgmma (the expand on 1.31x its useful rows), writes and
// reads h2 once in bf16, and gives the GELUs and the conv five
// warpgroups of CUDA cores.  On an H100 (700 W) at BN = 384 it takes
// ~2.0 ms, 13x the bound: the GELUs and the conv are ~83% of stage (A),
// and (A) ~77% of the call (repros/mbconv_sections.py).
//
// The TPU kernel holds a whole sample (h1 and h2, 3 MB each in f32) in
// VMEM; a CTA here has 227 KB, and the SE gate needs the mean of h2 over
// the whole sample before the project can start.  So the work is split in
// three launches after a prep launch.  bf16 takes the bands design
// (vgm_fused_mbconv_route):
//
//   prep  we^T (HID x C) and wp^T (C x HID) rounded to bf16 once a call and
//         packed as the no-swizzle core matrices of wgmma_common.cuh (B = W^T
//         K-major; a 64-channel chunk of we^T is one contiguous block), the
//         depthwise taps rounded to bf16; the biases stay f32;
//   (A)   bands of kBandRows = 7 output rows with a one-row halo above and
//         below: 9 staged rows (315 pixels at W = 35, five m64 tiles), so
//         the expand runs on 1.31x the useful rows where two-row tiles ran
//         2.06x (rows of more than 49 pixels at C = 128 take the most rows
//         whose plan fits a CTA: 6 at W = 56, 1 up to W = 149).  x's band is staged once by cp.async into core matrices;
//         per 64-channel hidden chunk, wgmma m64n64k16 reads it and the
//         chunk of we^T (double-buffered by 1-D bulk copies on mbarriers, a
//         fill ahead across bands), GELU(acc + be) runs in registers and h1
//         goes to shared memory in bf16 (zero on rows off the image: the
//         depthwise conv's padding), pixel-major with a padded stride; the depthwise conv and GELU
//         then run on CUDA cores, a warp a column and a lane a channel
//         pair, sliding down the band with the 3 x 3 window in registers
//         (three shared loads an output, rows unrolled); each h2 pair
//         is stored in bf16 (a warp writes a pixel's 128-byte chunk), and
//         the f32 h2's per-channel sums go, in warp order, into one row of
//         `partial` a band.  CTA (band b, group j) walks band b of the
//         samples j spb .. j spb + spb - 1 in turn, so the output does not
//         depend on spb;
//   (B)   per sample, the bands' partial sums in band order and the SE MLP
//         on CUDA cores;
//   (C)   persistent CTAs stage wp^T once (bulk copies) and walk 64-pixel
//         tiles (a tile never straddles two samples; the ragged last tile of
//         a sample is masked on load and store), a tile a warpgroup: h2's
//         64 x 64 k-chunks come by cp.async into a ring in shared memory,
//         three chunks ahead, h3 = round(h2 * g) is made there in place,
//         wgmma m64nCk16 runs over K = HID, and the epilogue adds bp and x
//         in f32 and rounds once.
//
// f32 takes the first design: row tiles of th rows with a one-row halo
// (stage (a): stage x, per 64-channel chunk the expand on the tile and its
// halo, GELU, the depthwise conv and GELU, h2 and the tile's sums), the
// same SE stage, and the project on 64-pixel tiles; its products run on
// CUDA-core FMAs (TF32 would miss the f32 tolerance).
//
// The places marked "// section: <name>" are where
// repros/mbconv_sections.py stamps clock64.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_common.cuh"
#include "wgmma_common.cuh"

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
__device__ __forceinline__ void fma_mm(int M, int N, int K, const float* A,
                                       int lda, const float* B, int ldb,
                                       float* C, int ldc, bool accumulate) {
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

// ---------------------------------------------------------------------------
// the first design (f32): (a) expand -> GELU -> depthwise -> GELU on row
// tiles
// ---------------------------------------------------------------------------

// Shared memory of stage (a) for a tile of `rows` image rows (the halo
// included) of `w` pixels: the x tile (rows padded to 16), one chunk of the
// expand weights, h1 of the chunk, the chunk's taps and biases, and the
// channel sums of the thread groups.  The x stride is odd to spread banks.
struct PlanA {
  int m_pad, ldx, ldh;
  size_t xs, ws, h1, wd, bias, sums, bytes;
};

__host__ __device__ PlanA plan_a(int rows, int w, int c) {
  PlanA p{};
  p.m_pad = (rows * w + 15) / 16 * 16;
  p.ldx = c + 1;
  p.ldh = kChunk + 4;
  size_t off = 0;
  p.xs = off;
  off = align128(off + sizeof(float) * p.m_pad * p.ldx);
  p.ws = off;
  off = align128(off + sizeof(float) * c * kChunk);
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
int row_tile(int w, int c) {
  for (size_t budget : {kSmemTwoBlocks, kSmemMax})
    for (int th = kMaxRowTile; th >= 1; --th)
      if (plan_a(th + 2, w, c).bytes <= budget) return th;
  return 0;
}

// grid (tiles, ceil(N / spb)); block (tile, j) runs samples j*spb ..
// j*spb + spb - 1.  h2: (N, H, W, HID); partial: (N, tiles, HID).
template <int C, int HID>
__global__ void __launch_bounds__(kThreads, 1)
    mbconv_expand_dw_kernel(const float* __restrict__ x,
                            const float* __restrict__ we,
                            const float* __restrict__ be,
                            const float* __restrict__ wd,
                            const float* __restrict__ bd,
                            float* __restrict__ h2,
                            float* __restrict__ partial, int n_samples, int h,
                            int w, int th, int spb) {
  static_assert(kThreads % kChunk == 0 && HID % kChunk == 0, "chunking");
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanA p = plan_a(th + 2, w, C);
  float* xs = reinterpret_cast<float*>(smem + p.xs);
  float* ws = reinterpret_cast<float*>(smem + p.ws);
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
    const float* xn = x + static_cast<size_t>(n) * hw * C;
    __syncthreads();                    // the previous sample's xs is read
    // staged pixel q is image row r0 - 1 + q / w, column q % w; rows off
    // the image and the padding past m are zero
    for (int e = tid; e < p.m_pad * C; e += kThreads) {
      const int q = e / C;
      const int k = e % C;
      const int r = r0 - 1 + q / w;
      float v = 0.f;
      if (q < m && r >= 0 && r < h)
        v = xn[(static_cast<size_t>(r) * w + q % w) * C + k];
      xs[q * p.ldx + k] = v;
    }
    for (int c0 = 0; c0 < HID; c0 += kChunk) {
      __syncthreads();                  // the previous chunk is consumed
      for (int e = tid; e < C * kChunk; e += kThreads) {
        const int k = e / kChunk;
        const int cc = e % kChunk;
        ws[k * kChunk + cc] = we[static_cast<size_t>(k) * HID + c0 + cc];
      }
      for (int e = tid; e < 9 * kChunk; e += kThreads)
        wds[e] = wd[(e / kChunk) * HID + c0 + e % kChunk];
      if (tid < kChunk) {
        bes[tid] = be[c0 + tid];
        bds[tid] = bd[c0 + tid];
      }
      __syncthreads();

      // 1. h1 = x . we over the tile and its halo
      fma_mm(p.m_pad, kChunk, C, xs, p.ldx, ws, kChunk, h1, p.ldh, false);

      // 2. h1 <- gelu(h1 + be); zero on rows off the image, which is the
      //    depthwise conv's padding
      for (int e = tid; e < m * kChunk; e += kThreads) {
        const int q = e / kChunk;
        const int cc = e % kChunk;
        const int r = r0 - 1 + q / w;
        float* hp = h1 + q * p.ldh + cc;
        *hp = (r >= 0 && r < h) ? gelu(*hp + bes[cc]) : 0.f;
      }
      __syncthreads();

      // 3. h2 = gelu(dw3x3(h1) + bd) on the tile's own rows; thread tid
      //    keeps channel j (kThreads is a multiple of kChunk) and sums the
      //    h2 of its pixels in order
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
            static_cast<size_t>(r0 + ri - 1) * w + col) * HID + c0 + j] = v;
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
// (b) the squeeze-excite gate, one block per sample (both designs)
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
// the first design's (c): h2 * g -> project -> + bp + x on tiles of kPix
// pixels
// ---------------------------------------------------------------------------

struct PlanC {
  int ldh, ldy;
  size_t hs, ws, y, g, bytes;
};

__host__ __device__ PlanC plan_c(int c, int hid) {
  PlanC p{};
  p.ldh = kChunk + 1;
  p.ldy = c + 4;
  size_t off = 0;
  p.hs = off;
  off = align128(off + sizeof(float) * kPix * p.ldh);
  p.ws = off;
  off = align128(off + sizeof(float) * kChunk * c);
  p.y = off;
  off = align128(off + sizeof(float) * kPix * p.ldy);
  p.g = off;
  off = align128(off + sizeof(float) * hid);
  p.bytes = off;
  return p;
}

// grid (ceil(HW / kPix), ceil(N / spb)).
template <int C, int HID>
__global__ void __launch_bounds__(kThreads)
    mbconv_project_kernel(const float* __restrict__ x,
                          const float* __restrict__ h2,
                          const float* __restrict__ gate,
                          const float* __restrict__ wp,
                          const float* __restrict__ bp,
                          float* __restrict__ out, int n_samples, int hw,
                          int spb) {
  extern __shared__ __align__(128) unsigned char smem[];
  const PlanC p = plan_c(C, HID);
  float* hs = reinterpret_cast<float*>(smem + p.hs);
  float* ws = reinterpret_cast<float*>(smem + p.ws);
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
      // h3 = h2 * g, zero past the last pixel
      for (int e = tid; e < kPix * kChunk; e += kThreads) {
        const int pp = e / kChunk;
        const int k = e % kChunk;
        float v = 0.f;
        if (pp < np) v = h2[(base + pp) * HID + k0 + k] * g[k0 + k];
        hs[pp * p.ldh + k] = v;
      }
      for (int e = tid; e < kChunk * C; e += kThreads)
        ws[e] = wp[static_cast<size_t>(k0) * C + e];
      __syncthreads();
      fma_mm(kPix, C, kChunk, hs, p.ldh, ws, C, y, p.ldy, k0 > 0);
    }
    for (int e = tid; e < np * C; e += kThreads) {
      const int pp = e / C;
      const int c = e % C;
      const size_t idx = (base + pp) * C + c;
      out[idx] = y[pp * p.ldy + c] + bp[c] + x[idx];
    }
  }
}

template <int C, int HID, int SE>
int launch_first(const void* x, const float* we, const float* be,
                 const float* wd, const float* bd, const float* w1,
                 const float* b1, const float* w2, const float* b2,
                 const float* wp, const float* bp, void* out, void* h2,
                 float* partial, float* gate, int n, int h, int w, int spb,
                 cudaStream_t stream) {
  const int th = row_tile(w, C);
  if (th == 0) return static_cast<int>(cudaErrorInvalidValue);
  const int tiles = (h + th - 1) / th;
  const int groups = (n + spb - 1) / spb;
  const size_t smem_a = plan_a(th + 2, w, C).bytes;
  const size_t smem_c = plan_c(C, HID).bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_expand_dw_kernel<C, HID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mbconv_project_kernel<C, HID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);

  mbconv_expand_dw_kernel<C, HID>
      <<<dim3(tiles, groups), kThreads, smem_a, stream>>>(
          static_cast<const float*>(x), we, be, wd, bd,
          static_cast<float*>(h2), partial, n, h, w, th, spb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mbconv_se_kernel<float, HID, SE><<<n, kThreads, 0, stream>>>(
      partial, w1, b1, w2, b2, gate, tiles, h * w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mbconv_project_kernel<C, HID>
      <<<dim3((h * w + kPix - 1) / kPix, groups), kThreads, smem_c,
         stream>>>(static_cast<const float*>(x),
                   static_cast<const float*>(h2), gate, wp, bp,
                   static_cast<float*>(out), n, h * w, spb);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// the bands design (bf16): prep, (A) on bands of kBandRows rows, (C) on
// wgmma
// ---------------------------------------------------------------------------

constexpr int kBandRows = 7;           // most output rows of a band
constexpr int kBandWarpgroups = 5;     // stage (A): a warpgroup an m64 tile
constexpr int kWeightBuffers = 2;      // stage (A): we^T chunks in flight
constexpr int kH1Ld = kChunk + 8;      // a pixel's h1 row: 72 elements
constexpr int kProjectWarpgroups = 2;  // stage (C): a 64-pixel tile each
constexpr int kRingStages = 5;         // stage (C): h2 k-chunks a warpgroup,
                                       // kRingStages - 2 copied ahead
constexpr int kPackThreads = 256;

// Elements of the packed bf16 operands: we^T (HID x C) and wp^T (C x HID)
// in core matrices, then the taps (9, HID).
__host__ __device__ constexpr int packed_elems(int c, int hid) {
  return 2 * c * hid + 9 * hid;
}

// bf16 pair (low first) as two f32 values.
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return make_float2(__uint_as_float(v << 16),
                     __uint_as_float(v & 0xffff0000u));
}

// h1 in shared memory, a bf16 pair at a time.  A row of kH1Ld elements
// (144 bytes) keeps the accumulator's pair stores and the conv's row loads
// free of bank conflicts.
using H1 = __nv_bfloat16;

__device__ __forceinline__ void store_h1(H1* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ float2 load_h1(const H1* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}

// The prep: packed[e] for every element e, each from its f32 source.
template <int C, int HID>
__global__ void __launch_bounds__(kPackThreads)
    mbconv_pack_kernel(const float* __restrict__ we,
                       const float* __restrict__ wd,
                       const float* __restrict__ wp,
                       __nv_bfloat16* __restrict__ packed) {
  const int e = blockIdx.x * kPackThreads + threadIdx.x;
  if (e >= packed_elems(C, HID)) return;
  float v;
  if (e < 2 * C * HID) {
    // element o of a K-major operand with k_cols columns sits at byte 2 o
    // = wg::core_offset(r, k, k_cols): core matrix o / 64, its row
    // (o / 8) % 8 and column o % 8
    const bool proj = e >= C * HID;
    const int o = proj ? e - C * HID : e;
    const int k_cols = proj ? HID : C;
    const int cm = o >> 6;
    const int r = cm / (k_cols / 8) * 8 + ((o >> 3) & 7);
    const int k = cm % (k_cols / 8) * 8 + (o & 7);
    v = proj ? wp[static_cast<size_t>(k) * C + r]
             : we[static_cast<size_t>(k) * HID + r];
  } else {
    v = wd[e - 2 * C * HID];
  }
  packed[e] = __float2bfloat16(v);
}

// Shared memory of stage (A) for bands of `rows` output rows of w pixels:
// x's band (m64 tiles of C channels in core matrices), the we^T chunk
// buffers, h1 of a chunk for the band's staged pixels, each warp's channel
// sums, the mbarriers.
struct BandPlan {
  int m_tiles;
  size_t xs, ws, h1, sums, bar, bytes;
};

template <int C>
__host__ __device__ BandPlan band_plan(int rows, int w) {
  BandPlan p{};
  const int m = (rows + 2) * w;
  p.m_tiles = (m + 63) / 64;
  size_t off = 0;
  p.xs = off;
  off = align128(off + static_cast<size_t>(p.m_tiles) * 64 * C * 2);
  p.ws = off;
  off = align128(off + kWeightBuffers * kChunk * C * 2);
  p.h1 = off;
  off = align128(off + static_cast<size_t>(m) * kH1Ld * sizeof(H1));
  p.sums = off;
  off = align128(off + kBandWarpgroups * 4 * kChunk * 4);
  p.bar = off;
  off = align128(off + kWeightBuffers * sizeof(uint64_t));
  p.bytes = off;
  return p;
}

// grid (bands, ceil(N / spb)), kBandWarpgroups warpgroups; a band is
// `rows` <= kBandRows output rows.  h2: (N, H, W, HID) bf16; partial: (N,
// bands, HID) f32.
template <int C, int HID>
__global__ void __launch_bounds__(kBandWarpgroups * wg::kThreads, 1)
    mbconv_bands_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ packed,
                        const float* __restrict__ be,
                        const float* __restrict__ bd,
                        __nv_bfloat16* __restrict__ h2,
                        float* __restrict__ partial, int n_samples, int h,
                        int w, int rows, int spb) {
  constexpr int kWgs = kBandWarpgroups;
  constexpr int kWarps = 4 * kWgs;
  constexpr int kBufs = kWeightBuffers;
  constexpr int kChunks = HID / kChunk;
  constexpr int kSegs = C / 8;  // 16-byte pieces of a pixel's x
  constexpr uint32_t kWBytes = kChunk * C * 2;
  static_assert(C % 16 == 0 && HID % kChunk == 0, "chunking");
  extern __shared__ __align__(128) unsigned char smem[];
  const BandPlan plan = band_plan<C>(rows, w);
  unsigned char* xs = smem + plan.xs;
  unsigned char* wbuf = smem + plan.ws;
  H1* h1 = reinterpret_cast<H1*>(smem + plan.h1);
  float* sums = reinterpret_cast<float*>(smem + plan.sums);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + plan.bar);
  const int m_tiles = plan.m_tiles;

  const int tid = threadIdx.x;
  const int wgi = tid / wg::kThreads;
  const int lt = tid % wg::kThreads;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int band = blockIdx.x;
  const int r0 = band * rows;             // first output row of the band
  const int out_rows = min(rows, h - r0);
  const int m = (rows + 2) * w;           // staged pixels, halo included
  const int hw = h * w;
  const int n0 = blockIdx.y * spb;
  const int items = min(spb, n_samples - n0);
  const int total = items * kChunks;      // we^T fills, in order
  const __nv_bfloat16* taps = packed + 2 * C * HID;

  // x's pad rows m .. 64 m_tiles - 1 stay zero: the copies write rows < m
  for (int e = tid; e < (64 * m_tiles - m) * kSegs; e += kWgs * wg::kThreads)
    *reinterpret_cast<uint4*>(
        xs + wg::core_offset(m + e / kSegs, 8 * (e % kSegs), C)) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int b = 0; b < kBufs; ++b) wg::mbar_init(&full[b], 1);
    wg::mbar_init_fence();
  }
  wg::fence_proxy_async();
  __syncthreads();

  // fill k: chunk k % kChunks of we^T into buffer k % kBufs, completing
  // phase k / kBufs of its mbarrier (one thread)
  auto stage_w = [=](int k) {
    uint64_t* bar = full + k % kBufs;
    wg::mbar_expect_bytes(bar, kWBytes);
    wg::bulk_copy(wbuf + (k % kBufs) * kWBytes,
                  packed + static_cast<size_t>(k % kChunks) * kChunk * C,
                  kWBytes, bar);
  };
  if (tid == 0)
    for (int k = 0; k < kBufs && k < total; ++k) stage_w(k);

  // x's band of sample n: staged pixel q is image row r0 - 1 + q / w,
  // column q % w, zero off the image.  Eight threads fill one core
  // matrix's 128 bytes (eight pixels' piece s)
  auto stage_x = [=](int n) {
    const __nv_bfloat16* xn = x + static_cast<size_t>(n) * hw * C;
    const int m8 = (m + 7) / 8 * 8;
    for (int e = tid; e < m8 * kSegs; e += kWgs * wg::kThreads) {
      const int q = e / (8 * kSegs) * 8 + (e & 7);
      const int s = (e >> 3) % kSegs;
      if (q >= m) continue;
      const int r = r0 - 1 + q / w;
      unsigned char* dst = xs + wg::core_offset(q, 8 * s, C);
      if (r >= 0 && r < h)
        cp_async16(dst, xn + (static_cast<size_t>(r) * w + q % w) * C + 8 * s);
      else
        *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
    cp_async_commit();
  };
  if (items > 0) stage_x(n0);

  int k = 0;  // we^T fills consumed
  for (int it = 0; it < items; ++it) {
    const int n = n0 + it;
    cp_async_wait<0>();
    wg::fence_proxy_async();
    __syncthreads();  // x's band is in
    // section: x wait
    for (int j = 0; j < kChunks; ++j, ++k) {
      const int c0 = j * kChunk;
      const int b = k % kBufs;
      wg::mbar_wait(&full[b], (k / kBufs) & 1);
      // section: weight wait
      const unsigned char* wb = wbuf + b * kWBytes;
      for (int mt = wgi; mt < m_tiles; mt += kWgs) {
        // h1 = x . we over the m64 tile (f32 sums)
        float acc[kChunk / 2];
        wg::fence();
#pragma unroll
        for (int kk = 0; kk < C / 16; ++kk)
          wg::Mma<kChunk>::ss(acc,
                              wg::desc(xs + mt * 64 * C * 2 + 256 * kk, C),
                              wg::desc(wb + 256 * kk, C), kk);
        wg::commit();
        wg::wait<0>();
        wg::fence_regs(acc);
        // section: expand
        // h1 <- gelu(h1 + be) rounded to bf16, zero on rows off the image
        // (the depthwise conv's padding); pad pixels >= m are not stored
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int q = mt * 64 + 16 * (lt >> 5) + g + 8 * half;
          if (q >= m) continue;
          const int r = r0 - 1 + q / w;
          const bool on = r >= 0 && r < h;
#pragma unroll
          for (int c = 0; c < kChunk / 8; ++c) {
            const int col = 8 * c + 2 * t;
            const float2 bias =
                *reinterpret_cast<const float2*>(be + c0 + col);
            float a = 0.f, b = 0.f;
            if (on) {
              a = gelu(acc[4 * c + 2 * half] + bias.x);
              b = gelu(acc[4 * c + 2 * half + 1] + bias.y);
            }
            store_h1(h1 + q * kH1Ld + col, a, b);
          }
        }
      }
      __syncthreads();  // h1 is in; buffer b is read
      // section: h1
      if (tid == 0 && k + kBufs < total) {
        wg::fence_proxy_async();
        stage_w(k + kBufs);
      }
      if (j + 1 == kChunks && it + 1 < items) stage_x(n + 1);  // x is read

      // h2 = gelu(dw3x3(h1) + bd) on the band's own rows: warp `warp` takes
      // columns warp, warp + kWarps, ..., lane its channel pair, and slides
      // down the rows with the window in registers
      float2 tp[9];
#pragma unroll
      for (int i = 0; i < 9; ++i)
        tp[i] = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            taps + i * HID + c0 + 2 * lane));
      const float2 bdv = *reinterpret_cast<const float2*>(bd + c0 + 2 * lane);
      float2 csum = make_float2(0.f, 0.f);
      __nv_bfloat16* h2n = h2 + static_cast<size_t>(n) * hw * HID + c0 +
                           2 * lane;
      for (int col = warp; col < w; col += kWarps) {
        // staged row s at columns col - 1, col, col + 1 (zero off the image)
        auto ld = [&](int s, float2 (&v)[3]) {
          const H1* p = h1 + (s * w + col) * kH1Ld + 2 * lane;
          v[0] = col > 0 ? load_h1(p - kH1Ld) : make_float2(0.f, 0.f);
          v[1] = load_h1(p);
          v[2] = col + 1 < w ? load_h1(p + kH1Ld) : make_float2(0.f, 0.f);
        };
        float2 win[3][3];
        ld(0, win[0]);
        ld(1, win[1]);
        // unrolled over the most rows a band has, so the window's rotation
        // below renames registers and moves none
#pragma unroll
        for (int s = 1; s <= kBandRows; ++s) {
          if (s > out_rows) break;
          ld(s + 1, win[2]);
          float ax = 0.f, ay = 0.f;
#pragma unroll
          for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx) {
              ax = fmaf(win[dy][dx].x, tp[3 * dy + dx].x, ax);
              ay = fmaf(win[dy][dx].y, tp[3 * dy + dx].y, ay);
            }
          const float vx = gelu(ax + bdv.x);
          const float vy = gelu(ay + bdv.y);
          csum.x += vx;
          csum.y += vy;
          *reinterpret_cast<uint32_t*>(
              h2n + (static_cast<size_t>(r0 + s - 1) * w + col) * HID) =
              pack_bf16(vx, vy);
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            win[0][i] = win[1][i];
            win[1][i] = win[2][i];
          }
        }
      }
      // section: depthwise
      *reinterpret_cast<float2*>(sums + warp * kChunk + 2 * lane) = csum;
      __syncthreads();  // every warp's sums are in; h1 is read
      if (tid < kChunk) {
        float s = 0.f;
        for (int v = 0; v < kWarps; ++v) s += sums[v * kChunk + tid];
        partial[(static_cast<size_t>(n) * gridDim.x + band) * HID + c0 +
                tid] = s;
      }
      // section: sums
    }
  }
}

// Shared memory of stage (C): wp^T in core matrices, then each
// warpgroup's ring of h2 k-chunks (64 pixels x 64 channels in core
// matrices, scaled by g in place) and its sample's gate, then the
// mbarrier.
struct ProjectPlan {
  size_t wp, ring, ring_step, g, bar, bytes;
};

template <int C, int HID>
__host__ __device__ ProjectPlan project_plan() {
  ProjectPlan p{};
  size_t off = 0;
  p.wp = off;
  off = align128(off + static_cast<size_t>(C) * HID * 2);
  p.ring = off;
  p.ring_step = align128(kRingStages * kPix * kChunk * 2);
  off += kProjectWarpgroups * p.ring_step;
  p.g = off;
  off = align128(off + kProjectWarpgroups * HID * 4);
  p.bar = off;
  off = align128(off + sizeof(uint64_t));
  p.bytes = off;
  return p;
}

// Persistent: warpgroup wgi of CTA b takes the 64-pixel tiles b kWgs +
// wgi, then every gridDim.x kWgs further; tile i is pixels 64 (i % tps) ..
// of sample i / tps.  Its steps are (tile, k-chunk) in order; step q's h2
// chunk is copied (cp.async, zero past the sample's last pixel) into ring
// stage q % kRingStages, kAhead steps ahead.
template <int C, int HID>
__global__ void __launch_bounds__(kProjectWarpgroups * wg::kThreads, 1)
    mbconv_project_wgmma(const __nv_bfloat16* __restrict__ x,
                         const __nv_bfloat16* __restrict__ h2,
                         const float* __restrict__ gate,
                         const __nv_bfloat16* __restrict__ packed,
                         const float* __restrict__ bp,
                         __nv_bfloat16* __restrict__ out, int n_samples,
                         int hw) {
  constexpr int kWgs = kProjectWarpgroups;
  constexpr int kChunks = HID / kChunk;
  constexpr int kAhead = kRingStages - 2;
  constexpr uint32_t kWBytes = C * HID * 2;
  constexpr uint32_t kPiece = kWBytes < 32768 ? kWBytes : 32768;
  constexpr int kItems = kPix * kChunk / 8 / wg::kThreads;  // 16 B a thread
  constexpr int kStage = kPix * kChunk * 2;
  static_assert(kWBytes % kPiece == 0 && kItems == 4 && kAhead >= 1,
                "tiling");
  extern __shared__ __align__(128) unsigned char smem[];
  const ProjectPlan plan = project_plan<C, HID>();
  const int tid = threadIdx.x;
  const int wgi = tid / wg::kThreads;
  const int lt = tid % wg::kThreads;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const unsigned char* wps = smem + plan.wp;
  unsigned char* ring = smem + plan.ring + wgi * plan.ring_step;
  float* gs = reinterpret_cast<float*>(smem + plan.g) + wgi * HID;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + plan.bar);

  if (tid == 0) {
    wg::mbar_init(bar, 1);
    wg::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    wg::mbar_expect_bytes(bar, kWBytes);
    for (uint32_t off = 0; off < kWBytes; off += kPiece)
      wg::bulk_copy(smem + plan.wp + off,
                    reinterpret_cast<const unsigned char*>(packed + C * HID) +
                        off,
                    kPiece, bar);
  }

  const int tps = (hw + kPix - 1) / kPix;  // tiles a sample
  const int tiles = n_samples * tps;
  const int stride = gridDim.x * kWgs;
  const int t0 = blockIdx.x * kWgs + wgi;
  const int steps = t0 < tiles ? (tiles - t0 + stride - 1) / stride * kChunks
                               : 0;
  // item i of thread lt: pixel px of the chunk (a quarter-warp's eight
  // lanes eight pixels, so its 16-byte pieces fill one core matrix) and
  // 16-byte piece s
  auto item = [&](int i, int& px, int& s) {
    const int e = lt + wg::kThreads * i;
    px = (e & 7) + 8 * ((e >> 5) & 7);
    s = ((e >> 3) & 3) + 4 * (e >> 8);
  };
  // step q's h2 chunk into its ring stage; one commit group a step, empty
  // past the last
  auto copy_step = [&](int q) {
    if (q < steps) {
      const int tile = t0 + q / kChunks * stride;
      const int p0 = tile % tps * kPix;
      const int np = min(kPix, hw - p0);
      const __nv_bfloat16* src = h2 +
          (static_cast<size_t>(tile / tps) * hw + p0) * HID +
          q % kChunks * kChunk;
      unsigned char* stage = ring + q % kRingStages * kStage;
#pragma unroll
      for (int i = 0; i < kItems; ++i) {
        int px, s;
        item(i, px, s);
        unsigned char* dst = stage + wg::core_offset(px, 8 * s, kChunk);
        if (px < np)
          cp_async16(dst, src + static_cast<size_t>(px) * HID + 8 * s);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  };
  for (int q = 0; q < kAhead; ++q) copy_step(q);
  if (steps > 0) wg::mbar_wait(bar, 0);

  int gn = -1;  // the sample whose gate gs holds
  float acc[C / 2];
  for (int q = 0; q < steps; ++q) {
    const int tile = t0 + q / kChunks * stride;
    const int j = q % kChunks;
    const int n = tile / tps;
    const int p0 = tile % tps * kPix;
    const int np = min(kPix, hw - p0);
    if (j == 0 && n != gn) {
      // every thread has scaled its last chunk before the last barrier
      for (int c = lt; c < HID; c += wg::kThreads)
        gs[c] = gate[static_cast<size_t>(n) * HID + c];
      wg::barrier(1 + wgi);
      gn = n;
    }
    // h3 = round(h2 * g) in place, each thread on the pieces it copied
    cp_async_wait<kAhead - 1>();
    unsigned char* stage = ring + q % kRingStages * kStage;
#pragma unroll
    for (int i = 0; i < kItems; ++i) {
      int px, s;
      item(i, px, s);
      uint4* p = reinterpret_cast<uint4*>(
          stage + wg::core_offset(px, 8 * s, kChunk));
      const uint4 v = *p;
      const float* gp = gs + j * kChunk + 8 * s;
      const float4 ga = *reinterpret_cast<const float4*>(gp);
      const float4 gb = *reinterpret_cast<const float4*>(gp + 4);
      const float2 v0 = unpack_bf16(v.x), v1 = unpack_bf16(v.y);
      const float2 v2 = unpack_bf16(v.z), v3 = unpack_bf16(v.w);
      *p = make_uint4(pack_bf16(v0.x * ga.x, v0.y * ga.y),
                      pack_bf16(v1.x * ga.z, v1.y * ga.w),
                      pack_bf16(v2.x * gb.x, v2.y * gb.y),
                      pack_bf16(v3.x * gb.z, v3.y * gb.w));
    }
    wg::fence_proxy_async();
    wg::barrier(1 + wgi);  // the chunk is in; every warp's product of step
                           // q - 2 is done (wait<1> below), so its stage
                           // takes step q + kAhead
    copy_step(q + kAhead);
    // y += h3 . wp over the chunk's four k16 steps
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk)
      wg::Mma<C>::ss(acc, wg::desc(stage + 256 * kk, kChunk),
                     wg::desc(wps + 256 * (j * kChunk / 16 + kk), HID),
                     j > 0 || kk > 0);
    wg::commit();
    wg::wait<1>();
    if (j + 1 < kChunks) continue;
    wg::wait<0>();
    wg::fence_regs(acc);
    // out = acc + bp + x in f32, rounded once; rows < np
    const size_t base = static_cast<size_t>(n) * hw + p0;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = 16 * (lt >> 5) + g + 8 * half;
      if (row >= np) continue;
      const size_t at = (base + row) * C;
#pragma unroll
      for (int c = 0; c < C / 8; ++c) {
        const int col = 8 * c + 2 * t;
        const float2 xv =
            unpack_bf16(*reinterpret_cast<const uint32_t*>(x + at + col));
        const float2 bias = *reinterpret_cast<const float2*>(bp + col);
        *reinterpret_cast<uint32_t*>(out + at + col) =
            pack_bf16(acc[4 * c + 2 * half] + bias.x + xv.x,
                      acc[4 * c + 2 * half + 1] + bias.y + xv.y);
      }
    }
  }
  cp_async_wait<0>();
}

// The output rows of a band at rows of w pixels: kBandRows, or on rows
// too wide for that the most whose plan fits a CTA; 0 when not even one
// row fits.
template <int C, int HID>
int band_rows(int w) {
  if (project_plan<C, HID>().bytes > kSmemMax) return 0;
  for (int rows = kBandRows; rows >= 1; --rows)
    if (band_plan<C>(rows, w).bytes <= kSmemMax) return rows;
  return 0;
}

template <int C, int HID, int SE>
int launch_bands(const void* x, const float* we, const float* be,
                 const float* wd, const float* bd, const float* w1,
                 const float* b1, const float* w2, const float* b2,
                 const float* wp, const float* bp, void* out, void* h2,
                 float* partial, float* gate, void* packed, int n, int h,
                 int w, int spb, cudaStream_t stream) {
  using bf16 = __nv_bfloat16;
  const int rows = band_rows<C, HID>(w);
  if (packed == nullptr || rows == 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bands = (h + rows - 1) / rows;
  const int groups = (n + spb - 1) / spb;
  const size_t smem_a = band_plan<C>(rows, w).bytes;
  const size_t smem_c = project_plan<C, HID>().bytes;
  cudaError_t err = cudaFuncSetAttribute(
      mbconv_bands_kernel<C, HID>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_a));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(mbconv_project_wgmma<C, HID>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem_c));
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);

  bf16* pk = static_cast<bf16*>(packed);
  mbconv_pack_kernel<C, HID>
      <<<(packed_elems(C, HID) + kPackThreads - 1) / kPackThreads,
         kPackThreads, 0, stream>>>(we, wd, wp, pk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mbconv_bands_kernel<C, HID>
      <<<dim3(bands, groups), kBandWarpgroups * wg::kThreads, smem_a,
         stream>>>(static_cast<const bf16*>(x), pk, be, bd,
                   static_cast<bf16*>(h2), partial, n, h, w, rows, spb);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mbconv_se_kernel<bf16, HID, SE><<<n, kThreads, 0, stream>>>(
      partial, w1, b1, w2, b2, gate, bands, h * w);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = n * ((h * w + kPix - 1) / kPix);
  const int wanted = (tiles + kProjectWarpgroups - 1) / kProjectWarpgroups;
  const int ctas = wanted < sms ? wanted : sms;
  mbconv_project_wgmma<C, HID>
      <<<ctas, kProjectWarpgroups * wg::kThreads, smem_c, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(h2), gate,
          pk, bp, static_cast<bf16*>(out), n, h * w);
  return static_cast<int>(cudaGetLastError());
}

// The design a launch at these widths takes: 1 the bands design (bf16),
// 0 the first design (f32), -1 neither (other widths, or rows too wide
// for either design's plan).
int route_of(int h, int w, int c, int hid, int se, int is_bf16) {
  if (h < 1 || w < 1) return -1;
  const bool wide = c == 128 && hid == 512 && se == 128;
  const bool narrow = c == 32 && hid == 128 && se == 32;
  if (!wide && !narrow) return -1;
  if (is_bf16)
    return (wide ? band_rows<128, 512>(w) : band_rows<32, 128>(w)) > 0 ? 1
                                                                      : -1;
  return row_tile(w, c) > 0 ? 0 : -1;
}

}  // namespace

// The design a launch takes: 1 "bands", 0 "first", -1 none (widths other
// than (c, hid, se) = (128, 512, 128) or (32, 128, 32), or no plan fits).
extern "C" int vgm_fused_mbconv_route(int n, int h, int w, int c, int hid,
                                      int se, int is_bf16) {
  if (n < 1) return -1;
  return route_of(h, w, c, hid, se, is_bf16);
}

// Output rows a row of `partial` covers on the design a launch on rows of
// w pixels at the instantiated widths with c input channels takes: a
// band's rows in bf16, a row tile's in f32 (0 when none fits).  The
// wrapper sizes `partial` with it: (n, ceil(h / rows), hid).
extern "C" int vgm_fused_mbconv_row_tile(int w, int c, int is_bf16) {
  if (w < 1 || c < 1) return 0;
  if (!is_bf16) return row_tile(w, c);
  if (c == 128) return band_rows<128, 512>(w);
  if (c == 32) return band_rows<32, 128>(w);
  return 0;
}

// Elements of the bands design's packed bf16 operands (the wrapper's
// scratch `packed`).
extern "C" int vgm_fused_mbconv_packed_elems(int c, int hid) {
  return packed_elems(c, hid);
}

// The bands design's prep alone: we (c, hid), wd (3, 3, hid) and wp (hid,
// c) f32 into `packed` (bf16, vgm_fused_mbconv_packed_elems), on `stream`.
extern "C" int vgm_fused_mbconv_pack(const void* we, const void* wd,
                                     const void* wp, void* packed, int c,
                                     int hid, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto* pk = static_cast<__nv_bfloat16*>(packed);
  const int blocks = (packed_elems(c, hid) + kPackThreads - 1) / kPackThreads;
  if (c == 128 && hid == 512)
    mbconv_pack_kernel<128, 512>
        <<<blocks, kPackThreads, 0, st>>>(f(we), f(wd), f(wp), pk);
  else if (c == 32 && hid == 128)
    mbconv_pack_kernel<32, 128>
        <<<blocks, kPackThreads, 0, st>>>(f(we), f(wd), f(wp), pk);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Registers, local bytes a thread, shared memory a CTA and CTAs an SM of
// the bands design's stage (A) (stage 0, at rows of w pixels) or stage (C)
// (stage 1) into out[0..3]; 0, or -1 on an error, other widths or rows
// too wide for a band.
extern "C" int vgm_fused_mbconv_occupancy(int stage, int w, int c, int hid,
                                          int* out) {
  if (w < 1) return -1;
  if (c == 128 && hid == 512) {
    const int rows = band_rows<128, 512>(w);
    if (rows == 0) return -1;
    return stage == 0
               ? wg::occupancy_of(mbconv_bands_kernel<128, 512>,
                                  band_plan<128>(rows, w).bytes,
                                  kBandWarpgroups * wg::kThreads, out)
               : wg::occupancy_of(mbconv_project_wgmma<128, 512>,
                                  project_plan<128, 512>().bytes,
                                  kProjectWarpgroups * wg::kThreads, out);
  }
  if (c == 32 && hid == 128) {
    const int rows = band_rows<32, 128>(w);
    if (rows == 0) return -1;
    return stage == 0
               ? wg::occupancy_of(mbconv_bands_kernel<32, 128>,
                                  band_plan<32>(rows, w).bytes,
                                  kBandWarpgroups * wg::kThreads, out)
               : wg::occupancy_of(mbconv_project_wgmma<32, 128>,
                                  project_plan<32, 128>().bytes,
                                  kProjectWarpgroups * wg::kThreads, out);
  }
  return -1;
}

// x, out: (n, h, w, c) channels-last in f32 or bf16 (is_bf16); weights f32:
// we (c, hid), be (hid), wd (3, 3, hid), bd (hid), w1 (hid, se), b1 (se),
// w2 (se, hid), b2 (hid), wp (hid, c), bp (c).  Scratch: h2 (n, h, w, hid)
// in x's type, partial (n, ceil(h / rows), hid) with the rows of
// vgm_fused_mbconv_row_tile and gate (n, hid) f32, and in bf16 `packed`
// (vgm_fused_mbconv_packed_elems bf16; null in f32).  All contiguous.
// Launches the design vgm_fused_mbconv_route names on `stream` and returns
// the first CUDA error (0 on success).
extern "C" int vgm_fused_mbconv(const void* x, const void* we, const void* be,
                                const void* wd, const void* bd,
                                const void* w1, const void* b1,
                                const void* w2, const void* b2,
                                const void* wp, const void* bp, void* out,
                                void* h2, void* partial, void* gate,
                                void* packed, int n, int h, int w, int c,
                                int hid, int se, int is_bf16,
                                int samples_per_block, void* stream) {
  if (n < 1 || samples_per_block < 1 ||
      route_of(h, w, c, hid, se, is_bf16) < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  float* pt = static_cast<float*>(partial);
  float* gt = static_cast<float*>(gate);
  const int spb = samples_per_block;
  if (is_bf16)
    return c == 128
               ? launch_bands<128, 512, 128>(
                     x, f(we), f(be), f(wd), f(bd), f(w1), f(b1), f(w2),
                     f(b2), f(wp), f(bp), out, h2, pt, gt, packed, n, h, w,
                     spb, st)
               : launch_bands<32, 128, 32>(
                     x, f(we), f(be), f(wd), f(bd), f(w1), f(b1), f(w2),
                     f(b2), f(wp), f(bp), out, h2, pt, gt, packed, n, h, w,
                     spb, st);
  return c == 128
             ? launch_first<128, 512, 128>(x, f(we), f(be), f(wd), f(bd),
                                           f(w1), f(b1), f(w2), f(b2), f(wp),
                                           f(bp), out, h2, pt, gt, n, h, w,
                                           spb, st)
             : launch_first<32, 128, 32>(x, f(we), f(be), f(wd), f(bd),
                                         f(w1), f(b1), f(w2), f(b2), f(wp),
                                         f(bp), out, h2, pt, gt, n, h, w, spb,
                                         st);
}
