// The epilogue of a MetNet3 resnet Block in one pass over its map, for the
// inference forward (ops/cuda/norm_act.py; models/metnet3.py::_norm_act):
//
//   h = (x - mean_c(x)) * rsqrt(max(var_c(x), eps)) * g + b   (ChanLayerNorm)
//   h = h * (scale + 1) + shift                  (FiLM, where the Block has it)
//   y = relu(h) + r                              (r, the residual, in block2)
//
// It replaces no TPU kernel: XLA fuses these elementwise ops and the two
// channel means by itself on the TPU, while eager PyTorch ran them as ~15
// passes over the map (ops/nn.py::chan_layer_norm, the FiLM, the ReLU and
// the residual add), each rounding to the working dtype.
//
// What bounds it on an H100: bytes.  x is read once, r once where there is
// one, and y written once: at 288 x 128 x 84 x 70 in bf16, 0.867 GB
// (0.259 ms at 3.35 TB/s), 1.30 GB (0.388 ms) with r; a few operations an
// element.  The design keeps every other access on chip:
//
// * One CTA a tile of tile_px pixels of one row (sample x lead) with all C
//   channels: 128 pixels in bf16, 64 in f32 (32 KB of x at C 128; half
//   where x's and r's tiles would not fit shared memory).  The CTAs run in
//   the tiles' order, so the ones resident at once work on one band of
//   neighbouring tiles: an NCHW map's runs (a channel's 256 bytes of a
//   tile) are read next to their neighbours' in DRAM.  On an H100 a
//   persistent grid, a run of tiles a CTA with a ring of prefetched tiles,
//   measured slower in both layouts.
// * x's tile, and r's, are staged in shared memory by 16-byte cp.async
//   copies in the input's own layout: channels_last as [pixel][channel],
//   NCHW as [channel][pixel] (a channel's run of pixels a multiple of 16
//   bytes, which the wrapper asks of an NCHW map), rows padded so the
//   sums' reads fall on distinct banks.  The row's (g, b, scale + 1, shift) are read
//   while the copies run and land as one float4 a channel.
// * split threads a pixel (4 in bf16, 8 in f32) sum its channels j,
//   j + split, ... in f32, in that order, and combine by xor shuffles; the
//   centred sum of squares follows from the staged tile, so device memory
//   is read once.  Both layouts run this same code on the same values in
//   the same order whatever the tile, and the elementwise tail is pinned to
//   _rn intrinsics (no contraction), so their outputs are bit-identical.
// * y is written in the input's layout, 16 bytes a thread with streaming
//   stores: a channels_last thread keeps its chunk's channels' float4s in
//   registers and walks pixels, an NCHW thread its run's pixels' means and
//   rstds and walks channels; everything in f32, rounded once, at the
//   store.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 512;
// a CTA's shared memory, at most
constexpr int kMaxSmem = 232448;
// channels_last row padding, in elements: the threads of a pixel and the
// pixels of a warp land on distinct banks in the sums
constexpr int kNhwcPad = 8;

// the staged layouts: NCHW (by 16-byte runs of a channel), channels_last
enum { kNchw = 0, kNhwc = 1 };

template <typename T>
struct NormActArgs {
  const T* x;
  const T* g;
  const T* b;
  const T* scale;   // nullptr: no FiLM
  const T* shift;
  const T* res;     // nullptr: no residual
  T* y;
  int channels, pixels, tile_px, tiles_a_row;
  int scale_sn, scale_sc, shift_sn, shift_sc;
  float eps;
};

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
  return __float2bfloat16_rn(v);
}

// elements in 16 bytes
template <typename T>
__host__ __device__ constexpr int vec() {
  return 16 / static_cast<int>(sizeof(T));
}

// threads a pixel in the sums, and so pixels a pass of the CTA
template <typename T>
__host__ __device__ constexpr int split() {
  return sizeof(T) == 2 ? 4 : 8;
}
template <typename T>
__host__ __device__ constexpr int pass_px() {
  return kThreads / split<T>();
}

// a staged tile's row stride, in elements: channels_last C plus the
// padding; NCHW a run of px pixels plus 16 bytes
template <typename T>
__host__ __device__ constexpr int tile_ld(int layout, int c, int px) {
  return layout == kNhwc ? c + kNhwcPad : px + vec<T>();
}

template <typename T>
__host__ __device__ constexpr size_t tile_elems(int layout, int c, int px) {
  return static_cast<size_t>(layout == kNhwc ? px : c) *
         tile_ld<T>(layout, c, px);
}

// dynamic shared memory: the channels' float4s, the pixels' means and
// rstds, then the x tile and, with a residual, the r tile (16-byte aligned:
// C float4s and 2 px floats before them, px a multiple of 8)
template <typename T>
size_t smem_bytes(int layout, int c, bool has_res, int px) {
  return static_cast<size_t>(c) * sizeof(float4) + 2 * px * sizeof(float) +
         (has_res ? 2 : 1) * tile_elems<T>(layout, c, px) * sizeof(T);
}

// pixels a tile: two passes of the CTA (a channel's run 256 bytes), or one
// where two do not fit a CTA's shared memory
template <typename T>
int tile_px(int layout, int c, bool has_res) {
  const int px = 2 * pass_px<T>();
  return smem_bytes<T>(layout, c, has_res, px) <= kMaxSmem ? px
                                                            : pass_px<T>();
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// 16 bytes as f32 values, and back
__device__ __forceinline__ void unpack(uint4 u, float (&v)[4]) {
  v[0] = __uint_as_float(u.x);
  v[1] = __uint_as_float(u.y);
  v[2] = __uint_as_float(u.z);
  v[3] = __uint_as_float(u.w);
}
__device__ __forceinline__ void unpack(uint4 u, float (&v)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ uint4 pack(const float (&v)[4]) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                    __float_as_uint(v[2]), __float_as_uint(v[3]));
}
__device__ __forceinline__ uint4 pack(const float (&v)[8]) {
  unsigned w[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    w[i] = *reinterpret_cast<const unsigned*>(&h);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// one output element from x, its pixel's (mean, rstd), its channel's
// (g, b, scale + 1, shift) and the residual (0 where there is none), in the
// order of the eager ops, each step rounded to f32 alone
__device__ __forceinline__ float norm_act(float x, float mean, float rstd,
                                          float4 par, float r) {
  float t = __fmul_rn(__fsub_rn(x, mean), rstd);
  t = __fadd_rn(__fmul_rn(t, par.x), par.y);
  t = __fadd_rn(__fmul_rn(t, par.z), par.w);
  t = t <= 0.f ? 0.f : t;   // relu, NaN passes as torch.relu passes it
  return __fadd_rn(t, r);
}

// the float4 of channel c in shared memory: c's low three bits xor its next
// three, so that the eight threads of a quarter-warp reading channels
// c0 + k, c0 = 0, V, ..., 7 V (a pixel's chunks), fall on distinct banks
__device__ __forceinline__ int par_slot(int c) { return c ^ ((c >> 3) & 7); }

// Start the copies of tile t (row n, pixels p0 .. p0 + valid - 1) of `src`
// (x or r) into `tile`.
template <typename T, int kLayout>
__device__ __forceinline__ void stage(T* tile, const T* src,
                                      const NormActArgs<T>& a, long t) {
  constexpr int V = vec<T>();
  const int px = a.tile_px;
  const int C = a.channels;
  const int P = a.pixels;
  const int ld = tile_ld<T>(kLayout, C, px);
  const int n = static_cast<int>(t / a.tiles_a_row);
  const int p0 = static_cast<int>(t % a.tiles_a_row) * px;
  const int valid = min(px, P - p0);
  if (kLayout == kNhwc) {
    const int chunks_a_px = C / V;
    src += (static_cast<size_t>(n) * P + p0) * C;
    for (int k = threadIdx.x; k < valid * chunks_a_px; k += kThreads) {
      const int p = k / chunks_a_px;
      cp_async16(tile + p * ld + (k - p * chunks_a_px) * V,
                 src + static_cast<size_t>(k) * V);
    }
  } else {
    const int runs = px / V;   // 16-byte runs a channel's tile
    src += static_cast<size_t>(n) * C * P + p0;
    for (int k = threadIdx.x; k < C * runs; k += kThreads) {
      const int c = k / runs;
      const int q = k - c * runs;
      if (q * V < valid)
        cp_async16(tile + c * ld + q * V,
                   src + static_cast<size_t>(c) * P + q * V);
    }
  }
}

template <typename T, int kLayout>
__device__ __forceinline__ float staged(const T* tile, int ld, int p, int c) {
  return to_f32(kLayout == kNhwc ? tile[p * ld + c] : tile[c * ld + p]);
}

template <typename T, int kLayout>
__global__ void __launch_bounds__(kThreads)
    chan_norm_act_kernel(const __grid_constant__ NormActArgs<T> a) {
  constexpr int V = vec<T>();
  constexpr int kSplit = split<T>();
  const int px = a.tile_px;
  extern __shared__ __align__(16) unsigned char smem[];
  const int C = a.channels;
  const int P = a.pixels;
  const bool has_res = a.res != nullptr;
  float4* s_par = reinterpret_cast<float4*>(smem);
  float* s_mean = reinterpret_cast<float*>(s_par + C);
  float* s_rstd = s_mean + px;
  T* tile = reinterpret_cast<T*>(s_rstd + px);
  T* tile_r = tile + tile_elems<T>(kLayout, C, px);
  const int ld = tile_ld<T>(kLayout, C, px);
  const int tid = threadIdx.x;

  // this CTA's tile
  const long t = blockIdx.x;
  const int n = static_cast<int>(t / a.tiles_a_row);
  const int p0 = static_cast<int>(t % a.tiles_a_row) * px;
  const int valid = min(px, P - p0);
  stage<T, kLayout>(tile, a.x, a, t);
  if (has_res) stage<T, kLayout>(tile_r, a.res, a, t);
  cp_async_commit();
  // the row's operands, while the copies run
  for (int c = tid; c < C; c += kThreads) {
    float4 par;
    par.x = to_f32(a.g[c]);
    par.y = to_f32(a.b[c]);
    par.z = a.scale == nullptr
                ? 1.f
                : __fadd_rn(to_f32(a.scale[static_cast<size_t>(n) *
                                               a.scale_sn +
                                           static_cast<size_t>(c) *
                                               a.scale_sc]),
                            1.f);
    par.w = a.shift == nullptr
                ? 0.f
                : to_f32(a.shift[static_cast<size_t>(n) * a.shift_sn +
                                 static_cast<size_t>(c) * a.shift_sc]);
    s_par[par_slot(c)] = par;
  }
  cp_async_wait_all();
  __syncthreads();

  // each pixel's mean and rstd: kSplit threads, channels j, j + kSplit,
  // ... in order, combined by xor shuffles (the same sum on every lane)
  for (int p = tid / kSplit; p < px; p += pass_px<T>()) {
    const int j = tid % kSplit;
    float s = 0.f;
    for (int c = j; c < C; c += kSplit)
      s = __fadd_rn(s, staged<T, kLayout>(tile, ld, p, c));
#pragma unroll
    for (int m = 1; m < kSplit; m <<= 1)
      s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, m));
    const float mean = __fdiv_rn(s, static_cast<float>(C));
    float q = 0.f;
    for (int c = j; c < C; c += kSplit) {
      const float d = __fsub_rn(staged<T, kLayout>(tile, ld, p, c), mean);
      q = __fmaf_rn(d, d, q);
    }
#pragma unroll
    for (int m = 1; m < kSplit; m <<= 1)
      q = __fadd_rn(q, __shfl_xor_sync(0xffffffffu, q, m));
    float var = __fdiv_rn(q, static_cast<float>(C));
    var = var < a.eps ? a.eps : var;   // max(var, eps); NaN passes
    if (j == 0) {
      s_mean[p] = mean;
      s_rstd[p] = rsqrtf(var);
    }
  }
  __syncthreads();

  // y in the input's layout, 16 bytes a thread at a time
  if (kLayout == kNhwc) {
    // thread (pixel slot, chunk): the chunk's channels' operands stay in
    // registers while the thread walks its pixels
    const int chunks_a_px = C / V;
    const int slots = kThreads / chunks_a_px;
    const int c0 = (tid % chunks_a_px) * V;
    if (tid < slots * chunks_a_px) {
      float4 par[V];
#pragma unroll
      for (int k = 0; k < V; ++k) par[k] = s_par[par_slot(c0 + k)];
      const size_t base = (static_cast<size_t>(n) * P + p0) * C + c0;
      for (int p = tid / chunks_a_px; p < valid; p += slots) {
        float xv[V], rv[V] = {};
        unpack(*reinterpret_cast<const uint4*>(tile + p * ld + c0), xv);
        if (has_res)
          unpack(*reinterpret_cast<const uint4*>(tile_r + p * ld + c0),
                 rv);
        const float mean = s_mean[p], rstd = s_rstd[p];
#pragma unroll
        for (int k = 0; k < V; ++k)
          xv[k] = norm_act(xv[k], mean, rstd, par[k], rv[k]);
        __stcs(reinterpret_cast<uint4*>(a.y + base +
                                        static_cast<size_t>(p) * C),
               pack(xv));
      }
    }
  } else {
    // thread (run, channel): the run's pixels' statistics stay in
    // registers while the thread walks its channels
    const int runs = px / V;   // a divisor of kThreads
    const int pv = (tid % runs) * V;
    if (pv < valid) {
      float mean[V], rstd[V];
#pragma unroll
      for (int k = 0; k < V; ++k) {
        mean[k] = s_mean[pv + k];
        rstd[k] = s_rstd[pv + k];
      }
      const size_t base = static_cast<size_t>(n) * C * P + p0 + pv;
      for (int c = tid / runs; c < C; c += kThreads / runs) {
        float xv[V], rv[V] = {};
        unpack(*reinterpret_cast<const uint4*>(tile + c * ld + pv), xv);
        if (has_res)
          unpack(*reinterpret_cast<const uint4*>(tile_r + c * ld + pv),
                 rv);
        const float4 par = s_par[par_slot(c)];
#pragma unroll
        for (int k = 0; k < V; ++k)
          xv[k] = norm_act(xv[k], mean[k], rstd[k], par, rv[k]);
        __stcs(reinterpret_cast<uint4*>(a.y + base +
                                        static_cast<size_t>(c) * P),
               pack(xv));
      }
    }
  }
}

// One CTA a tile, in the tiles' order: the CTAs resident at once work on
// one band of neighbouring tiles, which is what keeps an NCHW map's short
// runs (a channel's tile_px pixels) together in DRAM.
template <typename T, int kLayout>
int launch(const NormActArgs<T>& a, long tiles, cudaStream_t stream) {
  const auto kernel = chan_norm_act_kernel<T, kLayout>;
  const size_t smem =
      smem_bytes<T>(kLayout, a.channels, a.res != nullptr, a.tile_px);
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(tiles), kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* x, const void* g, const void* b, const void* scale,
        const void* shift, const void* res, void* y, int rows, int channels,
        int pixels, int scale_sn, int scale_sc, int shift_sn, int shift_sc,
        int nhwc, float eps, cudaStream_t stream) {
  const int layout = nhwc ? kNhwc : kNchw;
  if (layout == kNchw && (static_cast<long>(pixels) * sizeof(T)) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int px = tile_px<T>(layout, channels, res != nullptr);
  const int tiles_a_row = (pixels + px - 1) / px;
  const long tiles = static_cast<long>(rows) * tiles_a_row;
  if (tiles > 0x7fffffffL) return static_cast<int>(cudaErrorInvalidValue);
  const NormActArgs<T> a{
      static_cast<const T*>(x), static_cast<const T*>(g),
      static_cast<const T*>(b), static_cast<const T*>(scale),
      static_cast<const T*>(shift), static_cast<const T*>(res),
      static_cast<T*>(y), channels, pixels, px, tiles_a_row, scale_sn,
      scale_sc, shift_sn, shift_sc, eps};
  return layout == kNhwc ? launch<T, kNhwc>(a, tiles, stream)
                         : launch<T, kNchw>(a, tiles, stream);
}

}  // namespace

// x, res, y: (rows, channels, pixels) NCHW-contiguous with a channel's run
// of pixels a multiple of 16 bytes, or (rows, pixels, channels) where
// nhwc, f32 or bf16 (is_bf16), 16-byte aligned; res may be null.  g, b:
// (channels,) contiguous.  scale, shift: element (n, c) at
// n * s*_sn + c * s*_sc, or both null (no FiLM).  channels a multiple of 8,
// 8..512; fewer than 2^31 tiles.  Launches on `stream`; returns
// cudaGetLastError() (0 on success).
extern "C" int vgm_chan_norm_act(const void* x, const void* g, const void* b,
                                 const void* scale, const void* shift,
                                 const void* res, void* y, int rows,
                                 int channels, int pixels, int scale_sn,
                                 int scale_sc, int shift_sn, int shift_sc,
                                 int nhwc, int is_bf16, float eps,
                                 void* stream) {
  if (rows < 1 || pixels < 1 || channels < 8 || channels % 8 != 0 ||
      channels > kMaxChannels || (scale == nullptr) != (shift == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* const aligned[] = {x, res, y};
  for (const void* p : aligned)
    if (reinterpret_cast<uintptr_t>(p) % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return run<__nv_bfloat16>(x, g, b, scale, shift, res, y, rows, channels,
                              pixels, scale_sn, scale_sc, shift_sn, shift_sc,
                              nhwc, eps, st);
  return run<float>(x, g, b, scale, shift, res, y, rows, channels, pixels,
                    scale_sn, scale_sc, shift_sn, shift_sc, nhwc, eps, st);
}
