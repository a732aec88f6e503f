// Native CMAQ data-plane: threaded .npy block loader + sample assembler.
//
// The reference's input pipeline issues ~100 small .npy reads per sample from
// Python worker processes (dataset.py:1138-1409, evaluation_vit.py:138).
// This C++ core does the same work GIL-free on a thread pool, with the
// per-species standardization and the channel stacking fused into the read
// pass, exposing a plain C ABI consumed via ctypes
// (vit_grid_model_tpu_torch/data/native.py).  This file is the port's own
// copy of native/cmaq_loader.cc.
//
// Fault semantics preserved exactly: missing/unreadable/wrong-rank files
// produce zero grids (dataset.py:784-789 — the np.load + rank-check path).
// Files np.load WOULD read (any endianness, C or Fortran order, npy
// v1/v2/v3, numeric dtype) load correctly here too; anything else that
// np.load would accept but this reader cannot represent fails LOUDLY
// (stderr + vg_unsupported_count) instead of silently zero-filling —
// a silent zero grid is indistinguishable from the missing-file case.
//
// Build: data/native.py compiles it at first use into
// build/native/libcmaq_loader.so (g++ -O3 -shared -fPIC -pthread -std=c++17).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <functional>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// .npy reader: v1/v2/v3 headers, little/big endian, C/Fortran order,
// float16/32/64 + (u)int8/16/32/64 + bool payloads
// ---------------------------------------------------------------------------

std::atomic<int64_t> g_unsupported(0);

// Multi-MB staging buffers are reused across calls: a fresh allocation of
// this size is a new mmap whose first-touch page faults serialize in the
// kernel, the same storm the Python output pool avoids (data/native.py).
// resize() never shrinks capacity, so a recycled vector is already
// faulted in.
std::mutex g_stage_mutex;
std::vector<std::vector<float>> g_stage_pool;

std::vector<float> acquire_stage(size_t n) {
  std::vector<float> v;
  {
    std::lock_guard<std::mutex> lk(g_stage_mutex);
    if (!g_stage_pool.empty()) {
      v = std::move(g_stage_pool.back());
      g_stage_pool.pop_back();
    }
  }
  v.resize(n);
  return v;
}

void release_stage(std::vector<float>&& v) {
  std::lock_guard<std::mutex> lk(g_stage_mutex);
  if (g_stage_pool.size() < 2) g_stage_pool.push_back(std::move(v));
}

bool parse_shape(const std::string& header, std::vector<int64_t>* shape) {
  auto pos = header.find("'shape':");
  if (pos == std::string::npos) return false;
  pos = header.find('(', pos);
  auto end = header.find(')', pos);
  if (pos == std::string::npos || end == std::string::npos) return false;
  std::string body = header.substr(pos + 1, end - pos - 1);
  shape->clear();
  char* p = const_cast<char*>(body.c_str());
  while (*p) {
    while (*p && (*p == ' ' || *p == ',')) ++p;
    if (!*p) break;
    char* q = p;
    long long v = strtoll(p, &p, 10);
    if (p == q) return false;  // non-numeric junk: malformed header (a
                               // stuck pointer here would loop forever)
    shape->push_back(v);
  }
  return true;
}

// 'descr' value, e.g. "<f4", ">i8", "|u1".
bool parse_descr(const std::string& header, std::string* descr) {
  auto pos = header.find("'descr':");
  if (pos == std::string::npos) return false;
  pos = header.find_first_of("'\"", pos + 8);
  if (pos == std::string::npos) return false;
  char quote = header[pos];
  auto end = header.find(quote, pos + 1);
  if (end == std::string::npos) return false;
  *descr = header.substr(pos + 1, end - pos - 1);
  return true;
}

inline uint16_t bswap16(uint16_t v) { return __builtin_bswap16(v); }
inline uint32_t bswap32(uint32_t v) { return __builtin_bswap32(v); }
inline uint64_t bswap64(uint64_t v) { return __builtin_bswap64(v); }

float half_to_float(uint16_t h) {
  uint32_t sign = (uint32_t)(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1f;
  uint32_t mant = h & 0x3ffu;
  uint32_t bits;
  if (exp == 0) {
    if (mant == 0) {
      bits = sign;                                    // +-0
    } else {                                          // subnormal
      exp = 127 - 15 + 1;
      while (!(mant & 0x400u)) { mant <<= 1; --exp; }
      mant &= 0x3ffu;
      bits = sign | (exp << 23) | (mant << 13);
    }
  } else if (exp == 0x1f) {
    bits = sign | 0x7f800000u | (mant << 13);         // inf / nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (mant << 13);
  }
  float out;
  memcpy(&out, &bits, sizeof(out));
  return out;
}

// Convert n raw elements of the given descr into float32.  `swap` = payload
// byte order differs from host (host assumed little-endian, as every
// deployment target here is).  Returns false for unsupported descr kinds.
bool convert_payload(const std::string& descr, const uint8_t* raw, int64_t n,
                     bool swap, float* out) {
  char kind = descr[descr.size() - 2];
  char size = descr[descr.size() - 1];
  if (kind == 'f' && size == '4') {
    for (int64_t i = 0; i < n; ++i) {
      uint32_t v; memcpy(&v, raw + 4 * i, 4);
      if (swap) v = bswap32(v);
      memcpy(out + i, &v, 4);
    }
  } else if (kind == 'f' && size == '8') {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t v; memcpy(&v, raw + 8 * i, 8);
      if (swap) v = bswap64(v);
      double d; memcpy(&d, &v, 8);
      out[i] = (float)d;
    }
  } else if (kind == 'f' && size == '2') {
    for (int64_t i = 0; i < n; ++i) {
      uint16_t v; memcpy(&v, raw + 2 * i, 2);
      if (swap) v = bswap16(v);
      out[i] = half_to_float(v);
    }
  } else if ((kind == 'i' || kind == 'u') && size == '1') {
    for (int64_t i = 0; i < n; ++i)
      out[i] = (kind == 'i') ? (float)(int8_t)raw[i] : (float)raw[i];
  } else if (kind == 'b' && size == '1') {
    for (int64_t i = 0; i < n; ++i) out[i] = raw[i] ? 1.0f : 0.0f;
  } else if ((kind == 'i' || kind == 'u') && size == '2') {
    for (int64_t i = 0; i < n; ++i) {
      uint16_t v; memcpy(&v, raw + 2 * i, 2);
      if (swap) v = bswap16(v);
      out[i] = (kind == 'i') ? (float)(int16_t)v : (float)v;
    }
  } else if ((kind == 'i' || kind == 'u') && size == '4') {
    for (int64_t i = 0; i < n; ++i) {
      uint32_t v; memcpy(&v, raw + 4 * i, 4);
      if (swap) v = bswap32(v);
      out[i] = (kind == 'i') ? (float)(int32_t)v : (float)v;
    }
  } else if ((kind == 'i' || kind == 'u') && size == '8') {
    for (int64_t i = 0; i < n; ++i) {
      uint64_t v; memcpy(&v, raw + 8 * i, 8);
      if (swap) v = bswap64(v);
      out[i] = (kind == 'i') ? (float)(int64_t)v : (float)v;
    }
  } else {
    return false;
  }
  return true;
}

enum LoadResult {
  LOAD_OK = 1,
  LOAD_ZERO = 0,         // reference-parity zero-fill (missing / non-npy /
                         // wrong rank, dataset.py:784-789)
  LOAD_UNSUPPORTED = -1, // np.load would read it, we cannot (or the shape
                         // contradicts the caller): LOUD
};

// Reads an .npy file into `out` (n_expected float32s).
LoadResult load_npy_f32(const char* path, float* out, int64_t n_expected,
                        const std::vector<int64_t>& expected_shape) {
  FILE* f = fopen(path, "rb");
  if (!f) return LOAD_ZERO;
  LoadResult res = LOAD_ZERO;
  const char* why = "truncated or non-npy file";
  std::vector<char> hdr_buf;
  do {
    unsigned char magic[8];
    if (fread(magic, 1, 8, f) != 8) break;
    if (memcmp(magic, "\x93NUMPY", 6) != 0) break;
    int major = magic[6];
    uint32_t hlen = 0;
    if (major == 1) {
      unsigned char b[2];
      if (fread(b, 1, 2, f) != 2) break;
      hlen = b[0] | (b[1] << 8);
    } else {  // v2.0 / v3.0: little-endian uint32 header length
      unsigned char b[4];
      if (fread(b, 1, 4, f) != 4) break;
      hlen = b[0] | (b[1] << 8) | (b[2] << 16) | ((uint32_t)b[3] << 24);
    }
    hdr_buf.resize(hlen + 1, 0);
    if (fread(hdr_buf.data(), 1, hlen, f) != hlen) break;
    std::string header(hdr_buf.data(), hlen);

    std::string descr;
    std::vector<int64_t> shape;
    if (!parse_descr(header, &descr) || !parse_shape(header, &shape)) break;
    // the reference treats wrong-rank files as malformed -> zeros
    // (dataset.py:788: `if len(shape) != 3: zeros`)
    if (shape.size() != expected_shape.size()) break;
    int64_t n = 1;
    for (auto s : shape) n *= s;
    // right rank, wrong element count: np.load succeeds and the
    // reference's downstream indexing crashes — never silently zero
    if (n != n_expected) { res = LOAD_UNSUPPORTED; why = "shape mismatch"; break; }

    if (descr.size() < 3) { res = LOAD_UNSUPPORTED; why = "odd descr"; break; }
    char bo = descr[0];
    bool swap;
    if (bo == '<' || bo == '|' || bo == '=') swap = false;
    else if (bo == '>') swap = true;
    else { res = LOAD_UNSUPPORTED; why = "unknown byte order"; break; }

    int64_t itemsize = descr[descr.size() - 1] - '0';
    if (itemsize < 1 || itemsize > 8) {
      res = LOAD_UNSUPPORTED; why = "unsupported itemsize"; break;
    }
    std::vector<uint8_t> raw(n * itemsize);
    if ((int64_t)fread(raw.data(), itemsize, n, f) != n) {
      res = LOAD_UNSUPPORTED; why = "payload shorter than header shape";
      break;
    }

    bool fortran =
        header.find("'fortran_order': True") != std::string::npos;
    if (!fortran) {
      if (!convert_payload(descr, raw.data(), n, swap, out)) {
        res = LOAD_UNSUPPORTED; why = "unsupported dtype"; break;
      }
    } else {
      // convert then permute column-major -> row-major
      std::vector<float> tmp(n);
      if (!convert_payload(descr, raw.data(), n, swap, tmp.data())) {
        res = LOAD_UNSUPPORTED; why = "unsupported dtype"; break;
      }
      const size_t rank = shape.size();
      std::vector<int64_t> fstride(rank), idx(rank, 0);
      int64_t acc = 1;
      for (size_t d = 0; d < rank; ++d) { fstride[d] = acc; acc *= shape[d]; }
      for (int64_t ci = 0; ci < n; ++ci) {
        int64_t fi = 0;
        for (size_t d = 0; d < rank; ++d) fi += idx[d] * fstride[d];
        out[ci] = tmp[fi];
        for (size_t d = rank; d-- > 0;) {       // C-order increment
          if (++idx[d] < shape[d]) break;
          idx[d] = 0;
        }
      }
    }
    res = LOAD_OK;
  } while (false);
  fclose(f);
  if (res == LOAD_UNSUPPORTED) {
    g_unsupported.fetch_add(1);
    fprintf(stderr, "cmaq_loader: %s: %s — zero-filling; np.load would "
                    "have read this file (or crashed downstream)\n",
            path, why);
  }
  return res;
}

void run_parallel(int64_t n_tasks, int n_threads,
                  const std::function<void(int64_t)>& fn) {
  if (n_threads <= 1 || n_tasks <= 1) {
    for (int64_t i = 0; i < n_tasks; ++i) fn(i);
    return;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> pool;
  int n = std::min<int64_t>(n_threads, n_tasks);
  for (int t = 0; t < n; ++t) {
    pool.emplace_back([&]() {
      while (true) {
        int64_t i = next.fetch_add(1);
        if (i >= n_tasks) return;
        fn(i);
      }
    });
  }
  for (auto& th : pool) th.join();
}

}  // namespace

extern "C" {

// Load `n_files` .npy cycle files of (n_species, H, W) each into
// out[(n_species)*H*W * i]; zero-fill failures.  Returns count loaded OK.
int64_t vg_load_cycle_files(const char** paths, int64_t n_files,
                            int64_t n_species, int64_t h, int64_t w,
                            float* out, int n_threads) {
  const int64_t per = n_species * h * w;
  std::vector<int64_t> shape = {n_species, h, w};
  std::atomic<int64_t> ok_count(0);
  run_parallel(n_files, n_threads, [&](int64_t i) {
    float* dst = out + i * per;
    if (load_npy_f32(paths[i], dst, per, shape) == LOAD_OK) {
      ok_count.fetch_add(1);
    } else {
      memset(dst, 0, per * sizeof(float));
    }
  });
  return ok_count.load();
}

// Assemble one sample's stacked simulation tensor, fusing the read,
// per-species standardization and channel interleave:
//   out (H, W, n_steps * (4*S + 4)); paths laid out [step][cycle];
//   leads (n_steps, 4); species `pm_index` left raw; others standardized
//   with (means[s], stds[s]).  pm25_out, when non-null, receives the
//   4-cycle PM2.5 planes (n_steps, 4, H, W) for history means.
// Exactly the batch assembler at B=1, hist=0 (identical layout), so it
// shares the staged-gather implementation below.
int64_t vg_assemble_batch(const char** paths, int64_t n_union,
                          int64_t n_samples, int64_t hist, int64_t n_steps,
                          int64_t n_species, int64_t h, int64_t w,
                          const float* means, const float* stds,
                          int64_t pm_index, const float* leads,
                          float* out, float* pm25_out, int n_threads);

int64_t vg_assemble_sample(const char** paths, int64_t n_steps,
                           int64_t n_species, int64_t h, int64_t w,
                           const float* means, const float* stds,
                           int64_t pm_index, const float* leads,
                           float* out, float* pm25_out, int n_threads) {
  return vg_assemble_batch(paths, n_steps, /*n_samples=*/1, /*hist=*/0,
                           n_steps, n_species, h, w, means, stds, pm_index,
                           leads, out, pm25_out, n_threads);
}

// Assemble a whole CONSECUTIVE batch directly into its batched,
// channels-last layout, exploiting the samples' step overlap.  The union of
// the B samples' step windows is n_union = n_samples - 1 + n_steps
// timesteps; `paths` is laid out [union_step][cycle] (n_union * 4 files).
// Sample b's window is union steps [b, b + n_steps); its output tensor
// out[b] (h, w, (n_steps - hist) * (4S + 4)) keeps steps [b + hist,
// b + n_steps) (the first `hist` feed only the PM2.5 history).
//
// Two phases, both bandwidth-shaped:
//  1. load each union file ONCE into a contiguous (n_union, 4, S, hw)
//     staging buffer, standardizing in place (sequential writes);
//  2. per (sample, row-chunk): gather each output row's full channel
//     vector from the staged planes — writes are fully sequential, and
//     consecutive rows re-read the same plane cache lines (each staged
//     line covers 16 rows), so the transpose runs at cache speed.
// The naive alternative (scatter each file's planes into every containing
// sample) writes 24 B per 2.8 KB stride — memory-latency-bound and
// superlinear in B: measured 20 s for ONE B=25 batch vs ~0.3 s here.
// pm25_out (n_union, 4, h, w) stays union-level for the history means.
int64_t vg_assemble_batch(const char** paths, int64_t n_union,
                          int64_t n_samples, int64_t hist, int64_t n_steps,
                          int64_t n_species, int64_t h, int64_t w,
                          const float* means, const float* stds,
                          int64_t pm_index, const float* leads,
                          float* out, float* pm25_out, int n_threads) {
  const int64_t hw = h * w;
  const int64_t bc = 4 * n_species + 4;      // channels per step
  const int64_t keep = n_steps - hist;       // steps kept per sample
  const int64_t row_ch = keep * bc;          // channels per sample row
  std::vector<int64_t> shape = {n_species, h, w};
  std::atomic<int64_t> ok_count(0);

  // phase 1: staged standardized planes, raw[((u*4+cyc)*S + s)*hw + i]
  std::vector<float> raw =
      acquire_stage((size_t)(n_union * 4 * n_species * hw));
  run_parallel(n_union * 4, n_threads, [&](int64_t task) {
    const int64_t u = task / 4;
    const int64_t cyc = task % 4;
    float* buf = raw.data() + task * n_species * hw;
    bool ok = load_npy_f32(paths[task], buf, n_species * hw,
                           shape) == LOAD_OK;
    if (!ok) memset(buf, 0, n_species * hw * sizeof(float));
    else ok_count.fetch_add(1);
    for (int64_t s = 0; s < n_species; ++s) {
      if (s == pm_index) continue;
      const float mu = means[s], sd = stds[s];
      float* p = buf + s * hw;
      for (int64_t i = 0; i < hw; ++i) p[i] = (p[i] - mu) / sd;
    }
    if (pm25_out) {
      memcpy(pm25_out + (u * 4 + cyc) * hw, buf + pm_index * hw,
             hw * sizeof(float));
    }
  });

  // phase 2: row-major gather.  Chunk size keeps the per-chunk working
  // set (keep*4*S staged line-segments + the output rows) L2-resident.
  const int64_t CHUNK = 512;
  const int64_t chunks_per_sample = (hw + CHUNK - 1) / CHUNK;
  run_parallel(n_samples * chunks_per_sample, n_threads, [&](int64_t task) {
    const int64_t b = task / chunks_per_sample;
    const int64_t i0 = (task % chunks_per_sample) * CHUNK;
    const int64_t i1 = std::min<int64_t>(i0 + CHUNK, hw);
    for (int64_t i = i0; i < i1; ++i) {
      float* dst = out + (b * hw + i) * row_ch;
      for (int64_t t = 0; t < keep; ++t) {
        const int64_t u = b + hist + t;
        for (int64_t cyc = 0; cyc < 4; ++cyc) {
          const float* src = raw.data() + (u * 4 + cyc) * n_species * hw + i;
          float* d = dst + t * bc + cyc * n_species;
          for (int64_t s = 0; s < n_species; ++s) d[s] = src[s * hw];
        }
        // lead channels (dataset.py:848-851), per step
        float* d = dst + t * bc + 4 * n_species;
        for (int64_t c = 0; c < 4; ++c) d[c] = leads[u * 4 + c];
      }
    }
  });
  release_stage(std::move(raw));
  return ok_count.load();
}

// Repack a batch's channels-last simulation stack into the model input
// layout, slicing off the 4 per-step lead channels:
//   src (B, H*W, T*(4S+4)) f32 contiguous ->
//   dst (B, T, 4S, H*W) f32, or bf16 (uint16) when out_bf16 != 0.
// The eval loop's reshape contract (evaluation_vit.py:248-249), done as
// the same cache-blocked gather as vg_assemble_batch phase 2: a 512-row
// source chunk (~1.4MB) stays L2-resident while every (t, c) output run
// is written sequentially.  bf16 uses round-to-nearest-even with quiet
// NaNs — bit-identical to numpy/ml_dtypes astype (tested).
static inline uint16_t f32_to_bf16(float f) {
  uint32_t x;
  memcpy(&x, &f, 4);
  // branchless (select, not branch) so the loop stays vectorizable
  const uint16_t rounded = (uint16_t)((x + 0x7fffu + ((x >> 16) & 1u)) >> 16);
  const uint16_t quiet_nan = (uint16_t)((x >> 16) | 0x0040u);
  return ((x & 0x7fffffffu) > 0x7f800000u) ? quiet_nan : rounded;
}

void vg_repack_model_input(const float* src, int64_t n_samples, int64_t hw,
                           int64_t t_steps, int64_t n_species, void* dst,
                           int out_bf16, int n_threads) {
  const int64_t bc = 4 * n_species + 4;           // source channels per step
  const int64_t nc = 4 * n_species;               // kept channels per step
  const int64_t row_ch = t_steps * bc;
  const int64_t CHUNK = 512;
  const int64_t chunks = (hw + CHUNK - 1) / CHUNK;
  // task = (sample, row chunk) with ALL (t, c) planes inside: the chunk's
  // source rows (~1.4MB) stay cache-resident across every step/channel,
  // so each source line is fetched once, not once per step
  run_parallel(n_samples * chunks, n_threads, [&](int64_t task) {
    const int64_t b = task / chunks;
    const int64_t i0 = (task % chunks) * CHUNK;
    const int64_t i1 = std::min<int64_t>(i0 + CHUNK, hw);
    const float* row0 = src + b * hw * row_ch;
    for (int64_t t = 0; t < t_steps; ++t) {
      const int64_t obase = ((b * t_steps + t) * nc) * hw;
      for (int64_t c = 0; c < nc; ++c) {
        const float* s = row0 + t * bc + c;
        if (out_bf16) {
          uint16_t* d = (uint16_t*)dst + obase + c * hw;
          for (int64_t i = i0; i < i1; ++i)
            d[i] = f32_to_bf16(s[i * row_ch]);
        } else {
          float* d = (float*)dst + obase + c * hw;
          for (int64_t i = i0; i < i1; ++i) d[i] = s[i * row_ch];
        }
      }
    }
  });
}

// Stage a channels-last simulation stack DIRECTLY into the model's
// nhwc_input device layout (MetNet3Config.nhwc_input):
//   src (B, H, W, T*(4S+4)) f32 contiguous ->
//   dst (B, Hp, Wp, T*4S) f32, or bf16 (uint16) when out_bf16 != 0,
// zero-padded (interior at rows [pad_t, pad_t+H), cols [pad_l, pad_l+W)),
// the 4 per-step lead channels dropped.  Unlike vg_repack_model_input
// there is NO axis permutation — src and dst are both channels-last —
// so each interior pixel is T sequential 4S-float runs: streaming reads,
// streaming writes.  Every output byte is written (pads zeroed), so
// pooled, non-zeroed destination buffers are safe.
void vg_repack_nhwc(const float* src, int64_t n_samples, int64_t h,
                    int64_t w, int64_t t_steps, int64_t n_species,
                    int64_t pad_l, int64_t pad_t, int64_t hp, int64_t wp,
                    void* dst, int out_bf16, int n_threads) {
  const int64_t bc = 4 * n_species + 4;           // source channels per step
  const int64_t nc = 4 * n_species;               // kept channels per step
  const int64_t src_pix = t_steps * bc;
  const int64_t dst_pix = t_steps * nc;
  const int64_t dst_row = wp * dst_pix;
  // task = one padded output row: a (b, y) pair
  run_parallel(n_samples * hp, n_threads, [&](int64_t task) {
    const int64_t b = task / hp, y = task % hp;
    const bool pad_row = (y < pad_t) || (y >= pad_t + h);
    if (out_bf16) {
      uint16_t* drow = (uint16_t*)dst + (b * hp + y) * dst_row;
      if (pad_row) { memset(drow, 0, dst_row * 2); return; }
      memset(drow, 0, pad_l * dst_pix * 2);
      memset(drow + (pad_l + w) * dst_pix, 0,
             (wp - pad_l - w) * dst_pix * 2);
      const float* srow = src + (b * h + (y - pad_t)) * w * src_pix;
      for (int64_t x = 0; x < w; ++x) {
        const float* s = srow + x * src_pix;
        uint16_t* d = drow + (pad_l + x) * dst_pix;
        for (int64_t t = 0; t < t_steps; ++t) {
          const float* st = s + t * bc;
          uint16_t* dt = d + t * nc;
          for (int64_t c = 0; c < nc; ++c) dt[c] = f32_to_bf16(st[c]);
        }
      }
    } else {
      float* drow = (float*)dst + (b * hp + y) * dst_row;
      if (pad_row) { memset(drow, 0, dst_row * 4); return; }
      memset(drow, 0, pad_l * dst_pix * 4);
      memset(drow + (pad_l + w) * dst_pix, 0,
             (wp - pad_l - w) * dst_pix * 4);
      const float* srow = src + (b * h + (y - pad_t)) * w * src_pix;
      for (int64_t x = 0; x < w; ++x) {
        const float* s = srow + x * src_pix;
        float* d = drow + (pad_l + x) * dst_pix;
        for (int64_t t = 0; t < t_steps; ++t)
          memcpy(d + t * nc, s + t * bc, nc * 4);
      }
    }
  });
}

// Count of loud load failures (files np.load would accept but this reader
// zero-filled) since start / last reset — lets callers assert the data
// plane saw nothing it silently mishandled.
int64_t vg_unsupported_count() { return g_unsupported.load(); }
void vg_reset_unsupported_count() { g_unsupported.store(0); }

int vg_abi_version() { return 5; }

}  // extern "C"
