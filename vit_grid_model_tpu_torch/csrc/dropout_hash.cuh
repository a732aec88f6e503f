// Counter-hash attention-dropout keep value, shared by the attention
// forward (window_attention_fwd.cu) and backward (window_attention_bwd.cu)
// kernels and by the standalone mask kernel (dropout_keep_mask.cu).
//
// Replaces vit_grid_model_tpu/ops/pallas/attention.py::_hash_keep (with
// its index builders _keep_mask and _keep_mask_pair): a stateless
// lowbias32-style mix of the global element index with the seed.  Because
// the value is a pure function of (seed, window, head, row, col), the
// forward and the backward regenerate the same mask by construction, and
// no (windows, heads, n, n) mask ever reaches device memory.
//
//   idx  = ((win * heads + h) * n_pad + row) * n_pad + col     (mod 2^32)
//   x    = idx ^ (seed * 0x9E3779B9)
//   x    = (x ^ x >> 16) * 0x7FEB352D
//   x    = (x ^ x >> 15) * 0x846CA68B
//   x   ^= x >> 16
//   keep = (x >> 8) * 2^-24 >= rate ? 1 / (1 - rate) : 0
//
// n_pad is round_up(n, 8) = 56 for the 53-token windows, whatever tile the
// kernel itself pads to.  The caller passes the comparison as an integer,
// threshold = ceil(float(rate) * 2^24), and the scale f32(1) / f32(1 - rate)
// (both from ops/dropout.py::keep_constants), which is exact: (x >> 8) is a
// 24-bit integer, so (x >> 8) * 2^-24 >= float(rate) iff
// (x >> 8) >= threshold.
//
// Cost: seven integer operations per score.  The attention kernels spend
// ~2 x dim_head FMAs per score in the score and P.V products alone, so the
// hash does not bound them.

#pragma once

__device__ __forceinline__ float vgm_keep(unsigned seed, unsigned win,
                                          unsigned h, unsigned row,
                                          unsigned col, unsigned heads,
                                          unsigned n_pad, unsigned threshold,
                                          float scale) {
  unsigned x = ((win * heads + h) * n_pad + row) * n_pad + col;
  x ^= seed * 0x9E3779B9u;
  x = (x ^ (x >> 16)) * 0x7FEB352Du;
  x = (x ^ (x >> 15)) * 0x846CA68Bu;
  x ^= x >> 16;
  return (x >> 8) >= threshold ? scale : 0.f;
}

__host__ __device__ constexpr int vgm_hash_n_pad(int n) {
  return (n + 7) / 8 * 8;
}
