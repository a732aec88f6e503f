// One MaxViT layer's block and grid attention in one launch, for Hopper
// (sm_90a): R7.
//
// Replaces benchmarks/mosaic_repros/repro_megakernel.py::kernel (its
// pallas_call at :283; the per-window math of _attn_inner, :73).  For each
// sample-lead s, with the (H, W, dim) map x_s cut into win x win windows
// (nx = H / win rows of ny = W / win) and nr register tokens:
//
//   block windows: tokens = regs ++ the window's pixels (n = nr + win^2)
//     tokens += Attn_block(tokens)   (K1's math: LN, FiLM gamma/beta of s
//                                     as the LN affine, qkv, QK-RMSNorm,
//                                     rel-pos bias, softmax, P.v, out-proj)
//   regs2 = mean over the nx*ny windows of their register rows
//   grid windows (token (i, j) of window (gx, gy) is pixel
//   (i*nx + gx, j*ny + gy)): tokens = regs2 ++ those pixels
//     tokens += Attn_grid(tokens)
//   out_s = the grid windows' pixels, back at their map positions
//
// The residuals and the register mean stay in f32 and the output is
// rounded once, as on the TPU; each head is shifted by its own max; the
// register mean sums the CTAs' partial sums in rank order, so a second
// launch is bit-identical.  In bf16 the normalized x and each head's P.v
// are rounded to bf16 before their products (K1's rounding points).
//
// What bounds it on an H100.  Each window costs K1's 67.08 MFLOP at the
// flagship shape (dim 128, 32 heads x 32, n = 53), 60 windows a
// sample-lead: 1,207 GFLOP = 1.221 ms at S = 300 on the tensor cores' bf16
// peak, against 0.03 ms for reading and writing the map once.  It is bound
// by arithmetic, so what matters is K1's: the per-window body and two CTAs
// an SM.
//
// The strip design (bf16, dim and dh multiples of 16, dim <= 128, dh <= 32:
// K1's strip conditions).  A sample-lead is a thread-block cluster of C
// CTAs (C a divisor of the nx*ny windows, <= 8, portable; a launch
// parameter, by default 6 at the flagship map), each owning nx*ny / C block
// windows and as many grid windows.  Every window runs K1's strip body
// (window_attention_strips.cuh: mma.sync products in warp-owned strips, y in
// registers) with an epilogue of its own:
//   - block stage: the LayerNorm reads the registers and the window's
//     pixels from x; the epilogue writes x + y of each pixel row in f32 to a
//     scratch map (S, H, W, dim) in device memory that the wrapper
//     allocates, and adds y + regs of the register rows into the CTA's
//     register sums in shared memory (each element has one owner thread);
//   - a cluster barrier (release/acquire at cluster scope) makes every
//     pixel and every sum final; each CTA then sums the C CTAs' register
//     sums in rank order through distributed shared memory into its own
//     register mean, and arrives at a second cluster barrier, which it
//     waits on only before it exits, so that no CTA leaves while a peer may
//     still read its sums;
//   - grid stage: the LayerNorm reads the register mean and the window's
//     pixels from the scratch map, and the epilogue writes y + pixel to
//     the map position in `out`, rounded once.
// The scratch map is written and read in the same launch, so it is read
// through L2 (ld.global.cg), never through the non-coherent path.  A live
// cluster writes and reads its own 753 KB of it within its lifetime, so it
// mostly stays in the 50 MB L2: at most 0.45 GB of traffic at S = 300,
// ~0.14 ms at the memory rate.  Shared memory a CTA: the strip plan (84,480
// B at the flagship shape) and the register sums and mean (2 x 2,048 B), so
// two CTAs an SM under __launch_bounds__(kThreads, 2), as K1.
//
// The first design (f32, and bf16 off the strip conditions) keeps the map
// out of device memory: each CTA runs K1's first per-window body
// (window_attention_body.cuh; wmma projections for bf16) over its block
// windows and keeps their residual-updated pixels in its own shared memory
// in f32, with the partial sum of their register rows; after a cluster
// barrier it reads each grid window's pixels from its peers' shared memory
// and the register mean from the C partial sums in rank order, and a last
// cluster barrier keeps every CTA's memory alive until its peers are done.
// The cluster is the smallest whose share of the windows fits a CTA (6 in
// bf16 at the flagship shape, one CTA an SM; 10 in f32, non-portable).  On
// an NVIDIA H100 80GB HBM3 at 700 W that design took ~129 ms at S = 300 in
// bf16, against ~21 for two K1 launches with the glue between them.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attention_body.cuh"
#include "window_attention_strips.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster
constexpr int kMaxPortableCluster = 8;
// the strip design's default cluster: the largest divisor of the windows up
// to 6 (the fastest of 2, 3, 5 and 6 at the flagship map at S = 96 and
// 300: its CTAs hold the fewest windows, so its last wave is the shortest)
constexpr int kDefaultCluster = 6;
constexpr int kMaxSmem = 232448;  // what one block may take

// One attention's operands: FiLM gamma/beta (S, dim) f32 (rounded to T);
// wqkv (heads, dim, 3dh) and wout (heads, dh, dim) in T; qg, kg (heads, dh)
// and bias (heads, n, n) f32.
template <typename T>
struct LayerOps {
  const float* gamma;
  const float* beta;
  const T* wqkv;
  const T* wout;
  const float* qg;
  const float* kg;
  const float* bias;
};

struct MegaPlan {
  Plan body;
  size_t res, regsum, bytes;
};

template <bool kTC>
__host__ __device__ MegaPlan make_mega_plan(int dim, int dh, int pixels,
                                            int nr, int windows_per_cta) {
  MegaPlan p{};
  p.body = make_plan<kTC>(dim, dh);
  size_t off = p.body.bytes;
  p.res = off;
  off = align128(off + static_cast<size_t>(windows_per_cta) * pixels * dim *
                           sizeof(float));
  p.regsum = off;
  off = align128(off + static_cast<size_t>(nr) * dim * sizeof(float));
  p.bytes = off;
  return p;
}

// The smallest cluster that divides the windows and whose share of them
// fits in one CTA's shared memory; 0 when none does.
template <bool kTC>
int pick_cluster(int windows, int pixels, int nr, int dim, int dh) {
  for (int c = 1; c <= kMaxCluster; ++c)
    if (windows % c == 0 &&
        make_mega_plan<kTC>(dim, dh, pixels, nr, windows / c).bytes <=
            static_cast<size_t>(kMaxSmem))
      return c;
  return 0;
}

// ---- the first design ----

template <typename T, bool kTC>
__global__ void __launch_bounds__(kThreads, 1)
    maxvit_layer_attention_kernel(const T* __restrict__ x,
                                  const T* __restrict__ regs,
                                  LayerOps<T> blk, LayerOps<T> grd,
                                  T* __restrict__ out, int H, int W, int win,
                                  int nr, int dim, int heads, int dh) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / csize;
  const int nx = H / win;
  const int ny = W / win;
  const int nwin = nx * ny;
  const int wpc = nwin / csize;
  const int np = win * win;
  const int n = nr + np;
  const MegaPlan mp = make_mega_plan<kTC>(dim, dh, np, nr, wpc);
  const Plan& plan = mp.body;
  // res: this CTA's block windows' pixels (wpc, np, dim), after the block
  // attention's residual; regsum: their register rows' sum (nr, dim)
  float* res = reinterpret_cast<float*>(smem + mp.res);
  float* regsum = reinterpret_cast<float*>(smem + mp.regsum);
  const float* y = reinterpret_cast<const float*>(smem + plan.y);
  const T* xmap = x + static_cast<size_t>(s) * H * W * dim;
  T* omap = out + static_cast<size_t>(s) * H * W * dim;
  const size_t film = static_cast<size_t>(s) * dim;
  const int tid = threadIdx.x;

  for (int e = tid; e < nr * dim; e += kThreads) regsum[e] = 0.f;

  // ---- block attention over this CTA's windows ----
  for (int j = 0; j < wpc; ++j) {
    const int b = rank * wpc + j;
    const int bx = b / ny;
    const int by = b % ny;
    float* rw = res + static_cast<size_t>(j) * np * dim;
    for (int e = tid; e < np * dim; e += kThreads) {
      const int t = e / dim;
      const int pr = bx * win + t / win;
      const int pc = by * win + t % win;
      rw[e] =
          to_f32(xmap[(static_cast<size_t>(pr) * W + pc) * dim + e % dim]);
    }
    __syncthreads();
    layer_norm_rows<T, kTC>(
        smem, plan,
        [&](int r, int c) {
          return r < nr ? to_f32(regs[r * dim + c]) : rw[(r - nr) * dim + c];
        },
        n, dim, blk.gamma + film, blk.beta + film, 1);
    __syncthreads();
    attend_window<T, kTC>(smem, plan, blk.wqkv, blk.qg, blk.kg, blk.wout,
                          blk.bias, n, dim, heads, dh, 0, 0u, 0u, 1.f);
    // residual: each element has one owner thread, so no race
    for (int e = tid; e < n * dim; e += kThreads) {
      if (e < nr * dim)
        regsum[e] += y[e] + to_f32(regs[e]);
      else
        rw[e - nr * dim] += y[e];
    }
    __syncthreads();
  }
  cluster.sync();  // every CTA's pixels and register sums are final

  // ---- grid attention over this CTA's windows, pixels from the peers ----
  for (int j = 0; j < wpc; ++j) {
    const int g = rank * wpc + j;
    const int gx = g / ny;
    const int gy = g % ny;
    // the block-stage row of grid token t, in its owner's shared memory
    auto pixel = [&](int t) -> const float* {
      const int pr = (t / win) * nx + gx;
      const int pc = (t % win) * ny + gy;
      const int b = (pr / win) * ny + pc / win;
      const float* peer = cluster.map_shared_rank(res, b / wpc);
      return peer + (static_cast<size_t>(b % wpc) * np +
                     (pr % win) * win + pc % win) * dim;
    };
    layer_norm_rows<T, kTC>(
        smem, plan,
        [&](int r, int c) {
          if (r >= nr) return pixel(r - nr)[c];
          float sum = 0.f;  // in rank order: deterministic
          for (int q = 0; q < csize; ++q)
            sum += cluster.map_shared_rank(regsum, q)[r * dim + c];
          return sum / nwin;
        },
        n, dim, grd.gamma + film, grd.beta + film, 1);
    __syncthreads();
    attend_window<T, kTC>(smem, plan, grd.wqkv, grd.qg, grd.kg, grd.wout,
                          grd.bias, n, dim, heads, dh, 0, 0u, 0u, 1.f);
    for (int e = tid; e < np * dim; e += kThreads) {
      const int t = e / dim;
      const int c = e % dim;
      const int pr = (t / win) * nx + gx;
      const int pc = (t % win) * ny + gy;
      omap[(static_cast<size_t>(pr) * W + pc) * dim + c] =
          from_f32<T>(y[(nr + t) * dim + c] + pixel(t)[c]);
    }
    __syncthreads();
  }
  cluster.sync();  // no CTA leaves while a peer may still read its memory
}

// ---- the strip design ----

// Bytes of shared memory a CTA of the strip design takes: the strip plan,
// then the register sums and the register mean, (nr, dim) f32 each.
size_t strip_smem(int dim, int dh, int nr) {
  return make_strip_plan(dim, dh, dim).bytes +
         2 * align128(static_cast<size_t>(nr) * dim * sizeof(float));
}

// The cluster barrier in two halves: arrive (release) and wait (acquire).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

__global__ void __launch_bounds__(kThreads, 2)
    maxvit_layer_attention_strips(const bf16* __restrict__ x,
                                  const bf16* __restrict__ regs,
                                  LayerOps<bf16> blk, LayerOps<bf16> grd,
                                  float* scratch, bf16* __restrict__ out,
                                  int H, int W, int win, int nr, int dim,
                                  int heads, int dh) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.x / csize;
  const int nx = H / win;
  const int ny = W / win;
  const int nwin = nx * ny;
  const int wpc = nwin / csize;
  const int n = nr + win * win;
  const StripPlan plan = make_strip_plan(dim, dh, dim);
  // regsum: this CTA's block windows' register rows' sum (nr, dim); regmean:
  // the mean over the sample-lead's windows
  float* regsum = reinterpret_cast<float*>(smem + plan.bytes);
  float* regmean = reinterpret_cast<float*>(
      smem + plan.bytes +
      align128(static_cast<size_t>(nr) * dim * sizeof(float)));
  const size_t map = static_cast<size_t>(s) * H * W * dim;
  const bf16* xmap = x + map;
  float* smap = scratch + map;  // written here and read back: no __ldg
  bf16* omap = out + map;
  const size_t film = static_cast<size_t>(s) * dim;

  for (int e = threadIdx.x; e < nr * dim; e += kThreads) regsum[e] = 0.f;

  // ---- block attention over this CTA's windows: x + y to the scratch ----
  for (int j = 0; j < wpc; ++j) {
    const int b = rank * wpc + j;
    const int r0 = (b / ny) * win;  // the window's first map row, column
    const int c0 = (b % ny) * win;
    // map offset of the pixel of token t >= nr
    const auto at = [&](int t) {
      t -= nr;
      return (static_cast<size_t>(r0 + t / win) * W + c0 + t % win) * dim;
    };
    const auto block_load = [&](int r, int c) {
      return to_f32(r < nr ? regs[r * dim + c] : xmap[at(r) + c]);
    };
    const auto block_store = [&](int r, int c, float v0, float v1) {
      if (r < nr) {
        regsum[r * dim + c] += v0 + to_f32(regs[r * dim + c]);
        regsum[r * dim + c + 1] += v1 + to_f32(regs[r * dim + c + 1]);
      } else {
        const size_t e = at(r) + c;
        __stcg(reinterpret_cast<float2*>(smap + e),
               make_float2(to_f32(xmap[e]) + v0, to_f32(xmap[e + 1]) + v1));
      }
    };
    attend_window_strips(
        smem, plan,
        norm_rows(block_load, blk.gamma + film, blk.beta + film, 1), n, dim,
        blk.wqkv, blk.qg, blk.kg, blk.wout, blk.bias, heads, dh, dim, 0, 0u,
        0u, 1.f,
        block_store);
  }
  cluster.sync();  // every pixel of the scratch and every sum is final

  // the register mean from the cluster's sums in rank order: deterministic
  for (int e = threadIdx.x; e < nr * dim; e += kThreads) {
    float sum = 0.f;
    for (int q = 0; q < csize; ++q)
      sum += cluster.map_shared_rank(regsum, q)[e];
    regmean[e] = sum / nwin;
  }
  cluster_arrive();  // done with the peers' sums
  __syncthreads();   // regmean is whole

  // ---- grid attention over this CTA's windows: y + pixel to out ----
  for (int j = 0; j < wpc; ++j) {
    const int g = rank * wpc + j;
    const int gx = g / ny;
    const int gy = g % ny;
    // map offset of the pixel of grid token t >= nr
    const auto at = [&](int t) {
      t -= nr;
      return (static_cast<size_t>((t / win) * nx + gx) * W +
              (t % win) * ny + gy) *
             dim;
    };
    const auto grid_load = [&](int r, int c) {
      return r < nr ? regmean[r * dim + c] : __ldcg(smap + at(r) + c);
    };
    const auto grid_store = [&](int r, int c, float v0, float v1) {
      if (r < nr) return;
      const size_t e = at(r) + c;
      const float2 p = __ldcg(reinterpret_cast<const float2*>(smap + e));
      *reinterpret_cast<uint32_t*>(omap + e) = pack_bf16(v0 + p.x, v1 + p.y);
    };
    attend_window_strips(
        smem, plan,
        norm_rows(grid_load, grd.gamma + film, grd.beta + film, 1), n, dim,
        grd.wqkv, grd.qg, grd.kg, grd.wout, grd.bias, heads, dh, dim, 0, 0u,
        0u, 1.f,
        grid_store);
  }
  cluster_wait();  // no CTA leaves while a peer may still read its sums
}

// ---- the host side ----

bool valid(int S, int H, int W, int win, int nr, int dim, int heads,
           int dh) {
  return S >= 1 && win >= 1 && H >= win && W >= win && H % win == 0 &&
         W % win == 0 && nr >= 0 && nr + win * win <= kRows && dim >= 1 &&
         dim <= kMaxDim && heads >= 1 && dh >= 1 && dh <= kMaxDimHead;
}

bool tensor_cores(int is_bf16, int dim, int dh) {
  return is_bf16 && dim % 16 == 0 && dh % 16 == 0;
}

bool strip_design(int is_bf16, int dim, int dh) {
  return tensor_cores(is_bf16, dim, dh) && dim <= kMaxStripDim &&
         dh <= kMaxStripDimHead;
}

// The CTAs a cluster of the launch at these shapes: `cluster` when the
// strip design takes it (a divisor of the windows, <= 8; 0: the largest
// divisor up to kDefaultCluster), the first design's pick when `cluster`
// is 0; 0 when none fits or `cluster` is not one the design takes.
int cluster_size(int H, int W, int win, int nr, int dim, int dh, int is_bf16,
                 int cluster) {
  const int nwin = (H / win) * (W / win);
  if (strip_design(is_bf16, dim, dh)) {
    if (cluster == 0) {
      for (int c = kDefaultCluster; c > 1; --c)
        if (nwin % c == 0) return c;
      return 1;
    }
    return cluster >= 1 && cluster <= kMaxPortableCluster &&
                   nwin % cluster == 0
               ? cluster
               : 0;
  }
  if (cluster != 0) return 0;
  return tensor_cores(is_bf16, dim, dh)
             ? pick_cluster<true>(nwin, win * win, nr, dim, dh)
             : pick_cluster<false>(nwin, win * win, nr, dim, dh);
}

size_t smem_bytes(int H, int W, int win, int nr, int dim, int dh,
                  int is_bf16, int csize) {
  if (strip_design(is_bf16, dim, dh)) return strip_smem(dim, dh, nr);
  const int wpc = (H / win) * (W / win) / csize;
  return tensor_cores(is_bf16, dim, dh)
             ? make_mega_plan<true>(dim, dh, win * win, nr, wpc).bytes
             : make_mega_plan<false>(dim, dh, win * win, nr, wpc).bytes;
}

// Sets `kernel`'s attributes and fills `cfg` (with `attr`, its cluster
// shape) for S clusters of csize CTAs; 0 on success, else the error.
template <typename Kernel>
int configure(Kernel kernel, int S, int csize, size_t smem,
              cudaStream_t stream, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && csize > kMaxPortableCluster)
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  cfg = {};
  cfg.gridDim = dim3(S * csize);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = csize;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(err);
}

template <typename T>
LayerOps<T> layer_ops(const void* const* p) {
  return LayerOps<T>{static_cast<const float*>(p[0]),
                     static_cast<const float*>(p[1]),
                     static_cast<const T*>(p[2]),
                     static_cast<const T*>(p[3]),
                     static_cast<const float*>(p[4]),
                     static_cast<const float*>(p[5]),
                     static_cast<const float*>(p[6])};
}

// Runs f(kernel) on the kernel that takes these shapes.
template <typename F>
int with_kernel(int is_bf16, int dim, int dh, F f) {
  if (strip_design(is_bf16, dim, dh)) return f(maxvit_layer_attention_strips);
  if (tensor_cores(is_bf16, dim, dh))
    return f(maxvit_layer_attention_kernel<bf16, true>);
  if (is_bf16) return f(maxvit_layer_attention_kernel<bf16, false>);
  return f(maxvit_layer_attention_kernel<float, false>);
}

template <typename T, bool kTC>
int launch_first(const void* x, const void* regs, const void* const* bops,
                 const void* const* gops, void* out, int S, int H, int W,
                 int win, int nr, int dim, int heads, int dh, int csize,
                 size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  auto kernel = maxvit_layer_attention_kernel<T, kTC>;
  int err = configure(kernel, S, csize, smem, stream, cfg, attr);
  if (err != 0) return err;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const T*>(x), static_cast<const T*>(regs),
      layer_ops<T>(bops), layer_ops<T>(gops), static_cast<T*>(out), H, W,
      win, nr, dim, heads, dh));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

int launch_strips(const void* x, const void* regs, const void* const* bops,
                  const void* const* gops, void* scratch, void* out, int S,
                  int H, int W, int win, int nr, int dim, int heads, int dh,
                  int csize, size_t smem, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure(maxvit_layer_attention_strips, S, csize, smem, stream,
                      cfg, attr);
  if (err != 0) return err;
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, maxvit_layer_attention_strips, static_cast<const bf16*>(x),
      static_cast<const bf16*>(regs), layer_ops<bf16>(bops),
      layer_ops<bf16>(gops), static_cast<float*>(scratch),
      static_cast<bf16*>(out), H, W, win, nr, dim, heads, dh));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// CTAs in the cluster of one sample-lead at these shapes with `cluster`
// asked for (0: the default); 0 when none fits or the shapes, or
// `cluster`, are out of range.
extern "C" int vgm_maxvit_layer_attention_cluster(int H, int W, int win,
                                                  int nr, int dim, int dh,
                                                  int is_bf16, int cluster) {
  if (!valid(1, H, W, win, nr, dim, 1, dh)) return 0;
  return cluster_size(H, W, win, nr, dim, dh, is_bf16, cluster);
}

// f32 elements of the scratch map the launch at these shapes needs: S x H
// x W x dim on the strip design, 0 on the first.
extern "C" long vgm_maxvit_layer_attention_scratch_floats(int S, int H,
                                                          int W, int dim,
                                                          int dh,
                                                          int is_bf16) {
  return strip_design(is_bf16, dim, dh)
             ? static_cast<long>(S) * H * W * dim
             : 0;
}

// At these shapes and cluster (0: the default): clusters of one
// sample-lead each that the device holds at once (which = 0), or CTAs of
// the kernel an SM holds (which = 1); -1 when the shapes are out of range
// or the query fails.
extern "C" int vgm_maxvit_layer_attention_occupancy(int H, int W, int win,
                                                    int nr, int dim, int dh,
                                                    int is_bf16, int cluster,
                                                    int which) {
  if (!valid(1, H, W, win, nr, dim, 1, dh)) return -1;
  const int csize = cluster_size(H, W, win, nr, dim, dh, is_bf16, cluster);
  if (csize == 0) return -1;
  const size_t smem = smem_bytes(H, W, win, nr, dim, dh, is_bf16, csize);
  return with_kernel(is_bf16, dim, dh, [&](auto kernel) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    int count = -1;
    if (configure(kernel, 1, csize, smem, nullptr, cfg, attr) != 0)
      return -1;
    const cudaError_t err =
        which == 0
            ? cudaOccupancyMaxActiveClusters(&count, kernel, &cfg)
            : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                  &count, kernel, kThreads, smem);
    return err == cudaSuccess ? count : -1;
  });
}

// x, out: (S, H, W, dim) maps in f32 or bf16 (is_bf16); regs: (nr, dim) in
// x's type; block_ops and grid_ops: 7 pointers each, in LayerOps order
// (gamma, beta, wqkv, wout, qg, kg, bias; bias (heads, nr + win^2,
// nr + win^2)); scratch: vgm_maxvit_layer_attention_scratch_floats() f32
// elements (unused when 0).  All contiguous.  cluster: the CTAs a
// sample-lead (0: the default; the strip design takes any divisor of the
// windows up to 8, the first design only 0).  One cluster launch on
// `stream`; returns the launch's CUDA error (0 on success).
extern "C" int vgm_maxvit_layer_attention(
    const void* x, const void* regs, const void* b_gamma, const void* b_beta,
    const void* b_wqkv, const void* b_wout, const void* b_qg,
    const void* b_kg, const void* b_bias, const void* g_gamma,
    const void* g_beta, const void* g_wqkv, const void* g_wout,
    const void* g_qg, const void* g_kg, const void* g_bias, void* scratch,
    void* out, int S, int H, int W, int win, int nr, int dim, int heads,
    int dh, int is_bf16, int cluster, void* stream) {
  if (!valid(S, H, W, win, nr, dim, heads, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const int csize = cluster_size(H, W, win, nr, dim, dh, is_bf16, cluster);
  if (csize == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(H, W, win, nr, dim, dh, is_bf16, csize);
  const void* bops[7] = {b_gamma, b_beta, b_wqkv, b_wout, b_qg, b_kg, b_bias};
  const void* gops[7] = {g_gamma, g_beta, g_wqkv, g_wout, g_qg, g_kg, g_bias};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (strip_design(is_bf16, dim, dh))
    return launch_strips(x, regs, bops, gops, scratch, out, S, H, W, win, nr,
                         dim, heads, dh, csize, smem, st);
  if (tensor_cores(is_bf16, dim, dh))
    return launch_first<bf16, true>(x, regs, bops, gops, out, S, H, W, win,
                                    nr, dim, heads, dh, csize, smem, st);
  if (is_bf16)
    return launch_first<bf16, false>(x, regs, bops, gops, out, S, H, W, win,
                                     nr, dim, heads, dh, csize, smem, st);
  return launch_first<float, false>(x, regs, bops, gops, out, S, H, W, win,
                                    nr, dim, heads, dh, csize, smem, st);
}
