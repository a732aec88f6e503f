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
// rounded once, as on the TPU.  In bf16 the normalized x and each head's
// P.v are rounded to bf16 before their products (K1's rounding points).
//
// What bounds it on an H100.  Each window costs K1's 67.08 MFLOP at the
// flagship shape (dim 128, 32 heads x 32, n = 53), 60 windows a sample-lead:
// 1,207 GFLOP = 1.221 ms at S = 300 on the tensor cores' bf16 peak, against
// 0.03 ms for reading and writing the map once.  It is bound by arithmetic.
//
// What this design does about it.  The TPU program keeps one sample-lead's
// whole map in VMEM (42 x 35 x 128 = 753 KB in f32); a block has 227 KB.
// Here a sample-lead is a thread-block cluster of C CTAs, each owning
// nx*ny / C block windows (C = 6 and 5 windows at the flagship shape in
// bf16).  Each CTA runs K1's per-window body (window_attention_body.cuh)
// over its block windows one after another and keeps their residual-updated
// pixels in its own shared memory in f32, with the partial sum of their
// register rows.  After a cluster barrier every CTA runs its grid windows:
// it reads the 49 pixels of each from its peers' shared memory (distributed
// shared memory) and the register mean from the C partial sums in rank
// order, so the result does not depend on scheduling, and writes its
// pixels straight to their map positions in `out`.  A last cluster barrier
// keeps every CTA's memory alive until its peers are done reading it.  No
// intermediate touches device memory, and one launch does the layer.
// Shared memory per CTA at the flagship shape in bf16: K1's plan 97,280 B,
// five windows' pixels in f32 5 x 49 x 128 x 4 = 125,440 B, the register
// sums 2,048 B: 224,768 of 232,448 B, so one CTA an SM.  In f32, K1's plan
// is 115,200 B and six CTAs do not fit; the host then takes the next
// cluster size that does (10, non-portable, three windows a CTA).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "window_attention_body.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxCluster = 16;   // the largest (non-portable) cluster
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

// Sets the kernel's attributes and fills `cfg` (with `attr`, its cluster
// shape) for S sample-leads at these shapes; 0 on success, else the error.
template <typename T, bool kTC>
int configure(int S, int H, int W, int win, int nr, int dim, int dh,
              cudaStream_t stream, cudaLaunchConfig_t& cfg,
              cudaLaunchAttribute& attr) {
  const int nwin = (H / win) * (W / win);
  const int csize = pick_cluster<kTC>(nwin, win * win, nr, dim, dh);
  if (csize == 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem =
      make_mega_plan<kTC>(dim, dh, win * win, nr, nwin / csize).bytes;
  auto kernel = maxvit_layer_attention_kernel<T, kTC>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err == cudaSuccess && csize > 8)
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

template <typename T, bool kTC>
int launch(const void* x, const void* regs, const void* const* bops,
           const void* const* gops, void* out, int S, int H, int W, int win,
           int nr, int dim, int heads, int dh, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int err = configure<T, kTC>(S, H, W, win, nr, dim, dh, stream, cfg, attr);
  if (err != 0) return err;
  auto ops = [](const void* const* p) {
    return LayerOps<T>{static_cast<const float*>(p[0]),
                       static_cast<const float*>(p[1]),
                       static_cast<const T*>(p[2]),
                       static_cast<const T*>(p[3]),
                       static_cast<const float*>(p[4]),
                       static_cast<const float*>(p[5]),
                       static_cast<const float*>(p[6])};
  };
  err = static_cast<int>(cudaLaunchKernelEx(
      &cfg, maxvit_layer_attention_kernel<T, kTC>, static_cast<const T*>(x),
      static_cast<const T*>(regs), ops(bops), ops(gops), static_cast<T*>(out),
      H, W, win, nr, dim, heads, dh));
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}

// Clusters of the launch that the device holds at once; -1 on an error.
template <typename T, bool kTC>
int active_clusters(int H, int W, int win, int nr, int dim, int dh) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  int clusters = -1;
  if (configure<T, kTC>(1, H, W, win, nr, dim, dh, nullptr, cfg, attr) != 0 ||
      cudaOccupancyMaxActiveClusters(
          &clusters, maxvit_layer_attention_kernel<T, kTC>, &cfg) !=
          cudaSuccess)
    return -1;
  return clusters;
}

bool valid(int S, int H, int W, int win, int nr, int dim, int heads,
           int dh) {
  return S >= 1 && win >= 1 && H >= win && W >= win && H % win == 0 &&
         W % win == 0 && nr >= 0 && nr + win * win <= kRows && dim >= 1 &&
         dim <= kMaxDim && heads >= 1 && dh >= 1 && dh <= kMaxDimHead;
}

bool tensor_cores(int is_bf16, int dim, int dh) {
  return is_bf16 && dim % 16 == 0 && dh % 16 == 0;
}

}  // namespace

// CTAs in the cluster of one sample-lead at these shapes (0: none fits).
extern "C" int vgm_maxvit_layer_attention_cluster(int H, int W, int win,
                                                  int nr, int dim, int dh,
                                                  int is_bf16) {
  if (!valid(1, H, W, win, nr, dim, 1, dh)) return 0;
  const int nwin = (H / win) * (W / win);
  return tensor_cores(is_bf16, dim, dh)
             ? pick_cluster<true>(nwin, win * win, nr, dim, dh)
             : pick_cluster<false>(nwin, win * win, nr, dim, dh);
}

// Clusters of one sample-lead each that the device holds at once at these
// shapes (-1 when the shapes are out of range or the query fails).
extern "C" int vgm_maxvit_layer_attention_active_clusters(int H, int W,
                                                          int win, int nr,
                                                          int dim, int dh,
                                                          int is_bf16) {
  if (!valid(1, H, W, win, nr, dim, 1, dh)) return -1;
  if (tensor_cores(is_bf16, dim, dh))
    return active_clusters<__nv_bfloat16, true>(H, W, win, nr, dim, dh);
  if (is_bf16)
    return active_clusters<__nv_bfloat16, false>(H, W, win, nr, dim, dh);
  return active_clusters<float, false>(H, W, win, nr, dim, dh);
}

// x, out: (S, H, W, dim) maps in f32 or bf16 (is_bf16); regs: (nr, dim) in
// x's type; block_ops and grid_ops: 7 pointers each, in LayerOps order
// (gamma, beta, wqkv, wout, qg, kg, bias; bias (heads, nr + win^2,
// nr + win^2)).  All contiguous.  One cluster launch on `stream`; returns
// the launch's CUDA error (0 on success).
extern "C" int vgm_maxvit_layer_attention(
    const void* x, const void* regs, const void* b_gamma, const void* b_beta,
    const void* b_wqkv, const void* b_wout, const void* b_qg,
    const void* b_kg, const void* b_bias, const void* g_gamma,
    const void* g_beta, const void* g_wqkv, const void* g_wout,
    const void* g_qg, const void* g_kg, const void* g_bias, void* out, int S,
    int H, int W, int win, int nr, int dim, int heads, int dh, int is_bf16,
    void* stream) {
  if (!valid(S, H, W, win, nr, dim, heads, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  const void* bops[7] = {b_gamma, b_beta, b_wqkv, b_wout, b_qg, b_kg, b_bias};
  const void* gops[7] = {g_gamma, g_beta, g_wqkv, g_wout, g_qg, g_kg, g_bias};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tensor_cores(is_bf16, dim, dh))
    return launch<__nv_bfloat16, true>(x, regs, bops, gops, out, S, H, W, win,
                                       nr, dim, heads, dh, st);
  if (is_bf16)
    return launch<__nv_bfloat16, false>(x, regs, bops, gops, out, S, H, W,
                                        win, nr, dim, heads, dh, st);
  return launch<float, false>(x, regs, bops, gops, out, S, H, W, win, nr,
                              dim, heads, dh, st);
}
