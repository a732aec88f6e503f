// Standalone writer of the attention-dropout keep mask, so that the card
// can hold the in-kernel hash (dropout_hash.cuh, the port of
// vit_grid_model_tpu/ops/pallas/attention.py::_hash_keep / _keep_mask)
// bit for bit against its plain version, ops/dropout.py::keep_mask.
//
// The attention kernels never call this: they evaluate vgm_keep inline.
//
// What bounds it on an H100: the 4-byte store of each element (518 MB at
// Bw 1,440 x 32 heads x 53^2, 0.155 ms at 3.35 TB/s); the hash is nine
// integer operations an element.  The first design spent more than that on
// six 64-bit divisions an element by run-time values, and wrote 4 bytes a
// thread.  This design ("chunks") keeps both off the element:
//
// * The output is the flat run of (window, head) planes of n x n values.
//   A CTA owns planes_a_cta whole planes (a multiple of 4, so every CTA's
//   run starts 16-byte aligned) and walks their 16-byte chunks, thread t
//   taking chunks t, t + 256, ...: a warp's stores are 512 contiguous bytes.
// * A chunk's first element is split into (plane, row, col) by two exact
//   multiply-high divisions (Divisor) of a 32-bit offset inside the CTA's
//   run; the three others step col with a carry into row and the plane.
//   Only the index matters to the hash: the plane p = win * heads + h
//   gives idx = (p * n_pad + row) * n_pad + col (mod 2^32), whose row part
//   is formed once a row.
// * One 16-byte streaming store a chunk (st.global.cs.v4: the mask is
//   written once and read by a later kernel); a ragged last chunk, when
//   the total is no multiple of 4, is stored element by element.  Offsets
//   into the output are 64-bit, so it may pass 2^31 elements.

#include <cuda_runtime.h>

#include <cstdint>

#include "dropout_hash.cuh"

namespace {

constexpr int kMaskThreads = 256;
// a CTA's run holds at least this many 16-byte chunks a thread
constexpr int kMaskChunksPerThread = 8;

// Exact floor(x / d) of every 32-bit x for a run-time d in [1, 2^32):
// floor(x * m / 2^64) with m = floor(2^64 / d) + 1 = m_hi 2^32 + m_lo.
// With m d = 2^64 + e, 0 < e <= d: x m / 2^64 = x / d + x e / (d 2^64),
// and x e < 2^64 keeps the excess below 1 / d, so the floor is x / d's.
// The product's top word is (x m_hi + umulhi(x, m_lo)) >> 32.  d = 1 is
// the identity (its m needs 65 bits).
struct Divisor {
  unsigned d, m_lo, m_hi;
};

Divisor make_divisor(unsigned d) {
  if (d < 2) return Divisor{d, 0u, 0u};
  // floor(2^64 / d) from floor((2^64 - 1) / d): one more when d divides 2^64
  unsigned long long m = ~0ull / d;
  if (~0ull % d == d - 1) ++m;
  ++m;
  return Divisor{d, static_cast<unsigned>(m),
                 static_cast<unsigned>(m >> 32)};
}

__device__ __forceinline__ unsigned divide(unsigned x, Divisor v) {
  if (v.d == 1) return x;
  const unsigned long long top =
      static_cast<unsigned long long>(x) * v.m_hi + __umulhi(x, v.m_lo);
  return static_cast<unsigned>(top >> 32);
}

// vgm_keep at window 0, head 0, row 0 hashes its col argument as the index
__device__ __forceinline__ float keep_at(unsigned idx, unsigned seed,
                                         unsigned threshold, float scale) {
  return vgm_keep(seed, 0u, 0u, 0u, idx, 1u, 0u, threshold, scale);
}

// The keep values of the 16-byte chunk at element e of the run of planes
// from p0.
__device__ __forceinline__ float4 chunk_keep(unsigned e, unsigned p0,
                                             unsigned n, unsigned n_pad,
                                             Divisor by_plane,
                                             Divisor by_row, unsigned seed,
                                             unsigned threshold,
                                             float scale) {
  const unsigned dp = divide(e, by_plane);
  const unsigned rem = e - dp * by_plane.d;
  unsigned row = divide(rem, by_row);
  unsigned col = rem - row * n;
  unsigned idx_row = ((p0 + dp) * n_pad + row) * n_pad;
  float v[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = keep_at(idx_row + col, seed, threshold, scale);
    if (++col == n) {
      col = 0;
      idx_row += n_pad;
      if (++row == n) {  // the next plane: (p + 1) n_pad^2
        row = 0;
        idx_row += (n_pad - n) * n_pad;
      }
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

__global__ void __launch_bounds__(kMaskThreads)
    dropout_keep_mask_kernel(float* __restrict__ out, unsigned planes,
                             unsigned planes_a_cta, unsigned n,
                             unsigned n_pad, Divisor by_plane,
                             Divisor by_row, unsigned seed,
                             unsigned threshold, float scale) {
  const unsigned p0 = blockIdx.x * planes_a_cta;
  const unsigned span = min(planes_a_cta, planes - p0) * by_plane.d;
  float* run = out + static_cast<size_t>(p0) * by_plane.d;
  const unsigned chunks = (span + 3) / 4;
  // section: walk
  for (unsigned c = threadIdx.x; c < chunks; c += kMaskThreads) {
    const unsigned e = 4 * c;
    const float4 v = chunk_keep(e, p0, n, n_pad, by_plane, by_row, seed,
                                threshold, scale);
    if (e + 4 <= span) {
      __stcs(reinterpret_cast<float4*>(run + e), v);
    } else {  // the ragged last chunk
      const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (unsigned i = 0; i < 4; ++i)
        if (e + i < span) run[e + i] = w[i];
    }
  }
  // section: end walk
}

// Planes a CTA: a multiple of 4, at least kMaskChunksPerThread chunks a
// thread.
unsigned planes_a_cta(unsigned nn) {
  const unsigned want = 4u * kMaskThreads * kMaskChunksPerThread;
  const unsigned p = (want + nn - 1) / nn;
  return (p + 3) / 4 * 4;
}

}  // namespace

// The design a launch takes: 0, the only one ("chunks").
extern "C" int vgm_dropout_keep_mask_route() { return 0; }

// out: f32 (bw, heads, n, n), contiguous, 16-byte aligned; 1 <= n <=
// 16,384 and bw * heads < 2^31.  Returns cudaGetLastError().
extern "C" int vgm_dropout_keep_mask(void* out, int bw, int heads, int n,
                                     int seed, int threshold, float scale,
                                     void* stream) {
  const long planes = static_cast<long>(bw) * heads;
  if (bw < 1 || heads < 1 || n < 1 || n > 16384 || planes > 0x7fffffffL ||
      reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned nn = static_cast<unsigned>(n) * n;
  const unsigned per_cta = planes_a_cta(nn);
  const long blocks = (planes + per_cta - 1) / per_cta;
  dropout_keep_mask_kernel<<<static_cast<unsigned>(blocks), kMaskThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(out), static_cast<unsigned>(planes), per_cta,
      static_cast<unsigned>(n), vgm_hash_n_pad(n), make_divisor(nn),
      make_divisor(static_cast<unsigned>(n)), static_cast<unsigned>(seed),
      static_cast<unsigned>(threshold), scale);
  return static_cast<int>(cudaGetLastError());
}
