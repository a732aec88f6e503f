"""Where K3's time goes on the card: the window-attention backward's
sections, split by clock64 stamps.

    python -m vit_grid_model_tpu_torch.repros.bwd_sections [--parent FILE]

It writes patched copies of ``csrc/window_attention_bwd.cu`` into
``build/bwd_sections/`` (never into ``csrc/``), builds each with ``nvcc``
and runs it on the flagship training case (bf16, Bw 1,440 windows of 53
tokens, dim 128, 32 heads x 32, rate 0.1, inputs from a numpy seed):

* ``plain``: the kernel as it is;
* ``stamp``: thread 0 of each CTA reads ``clock64()`` after each block
  barrier that ends a section and adds the cycles since the last stamp to
  the section's count (one ``atomicAdd`` a section at the CTA's end);
* ``noslot``, ``noslot_stamp``: the slot read-modify-writes sent to shared
  memory, so that the time they cost shows as a difference;
* ``single``: each n x n product one bf16 product (hi.hi) instead of the
  three of the hi/lo split (its gradients are wrong; only the time counts).

The plain builds run in turns beside the package's own K3 and K3 + K3-w:
first, second, ..., then reversed.  With ``--parent FILE``, FILE is the
first design's source (commit 26f159b: every n x n product on CUDA cores,
the weight gradients in the slots), patched and timed the same way.  It
prints each variant's ms a call, each section's share of the stamped
cycles and the split into four parts: LayerNorm recompute and VJP, the
projections, the n x n section (the six products, softmax, dS, the q/k
norms and their backward) and the slot adds (the cycles the noslot
variant saves, by section).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.dropout import keep_constants
from vit_grid_model_tpu_torch.repros.common import card_line, cuda_ms

BUILD = library.LIBRARY.parent.parent / "bwd_sections"
SOURCE = library.CSRC / "window_attention_bwd.cu"
BW, N, DIM, HEADS, DIM_HEAD = 1440, 53, 128, 32, 32
WINDOWS_PER_SAMPLE = 30
SEED, DROPOUT_SEED, RATE = 0, 2 ** 30 + 12345, 0.1

_PRE = r'''
__device__ unsigned long long g_sections[32];
#define STAMP(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \
  sec_acc[k] += t_ - sec_last; sec_last = t_; } } while (0)
'''
_POST = r'''
extern "C" int sections_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_sections, sizeof(g_sections));
}
extern "C" int sections_reset() {
  unsigned long long z[32] = {0};
  return (int)cudaMemcpyToSymbol(g_sections, z, sizeof(z));
}
'''
_FLUSH = ("  if (threadIdx.x == 0) for (int k = 0; k < 20; ++k) "
          "atomicAdd(&g_sections[k], (unsigned long long)sec_acc[k]);")
_NAMESPACE = "namespace {\n\nnamespace wmma = nvcuda::wmma;\n"
_HI_ONLY = r'''
__device__ __forceinline__ void mma_hi_only(float (&c)[4],
    const uint32_t (&ahi)[4], const uint32_t (&)[4],
    const uint32_t (&bhi)[2], const uint32_t (&)[2]) {
  mma_bf16_16816(c, ahi, bhi[0], bhi[1]);
}
'''

# the current kernel's sections and the four parts they fall in
SECTIONS = ["LN", "proj", "norm", "strips", "keys", "wgrad", "LNvjp"]
PARTS = {"LN": ["LN", "LNvjp"], "projections": ["proj", "wgrad"],
         "n x n": ["norm", "strips", "keys"]}
# the first design's
PARENT_SECTIONS = ["LN", "qkv", "norm", "S", "softmax", "dO", "O", "oh",
                   "dWout", "dV", "dPm", "dS", "dQn", "dKn", "dqg", "l2bwd",
                   "dWqkv", "dXf", "LNvjp"]
PARENT_PARTS = {"LN": ["LN", "LNvjp"],
                "projections": ["qkv", "dO", "oh", "dWout", "dWqkv", "dXf"],
                "n x n": ["norm", "S", "softmax", "O", "dV", "dPm", "dS",
                          "dQn", "dKn", "dqg", "l2bwd"]}


def _find(lines: List[str], text: str, start: int = 0) -> int:
    for i in range(start, len(lines)):
        if text in lines[i]:
            return i
    raise ValueError(f"{SOURCE.name} has changed: no line with {text!r}")


def _insert(lines: List[str], after: Dict[int, str]) -> str:
    out = []
    for i, line in enumerate(lines):
        out.append(line)
        if i in after:
            out.append(after[i])
    return "\n".join(out)


def _replace(text: str, pairs, count: int = 1) -> str:
    for old, new in pairs:
        if text.count(old) < count:
            raise ValueError(f"kernel source has changed: {old[:60]!r}")
        text = text.replace(old, new, count)
    return text


def _wrap(text: str) -> str:
    if text.count(_NAMESPACE) != 1:
        raise ValueError("kernel source has changed: its namespace")
    return text.replace(_NAMESPACE, _PRE + _NAMESPACE) + _POST


def current_variants(text: str) -> Dict[str, str]:
    """The five variants of the current kernel."""
    lines = text.split("\n")
    after = {
        _find(lines, "const float sqrt_dh = sqrtf"):
            "  long long sec_acc[20] = {0}; long long sec_last = clock64();",
        _find(lines, "  __syncthreads();",
              _find(lines, "o_h[e] = __float2bfloat16(0.f);")):
            "  if (tid == 0) sec_last = clock64();",
        _find(lines, "    __syncthreads();",
              _find(lines, "// ---- LayerNorm + FiLM recompute")):
            "STAMP(0);",
        _find(lines, "kRows, dh, dim, dy_h, ldx, wo, dim, dO, ldo, false);"):
            "STAMP(1);",
        _find(lines, "__syncthreads();",
              _find(lines, "ssk_s[tid] = sq_s[tid] * sk_s[tid];")):
            "STAMP(2);",
        _find(lines, "__syncthreads();",
              _find(lines, "// dQn = dS . kn = (dS . u_k) s_k")):
            "STAMP(3);",
        _find(lines, "__syncthreads();",
              _find(lines, "// dV = Pm^T . dO (warp w)")):
            "STAMP(4);",
        # the head ends in no barrier: the stamped build adds one
        _find(lines, "kRows, dim, 3 * dh, dqkv_h, ldqh, wq, 3 * dh, dxf, "
                     "ldxf, true,") + 1:
            "__syncthreads(); STAMP(5);",
    }
    vjp = _find(lines, "    __syncthreads();",
                _find(lines, "// ---- FiLM grads and the LayerNorm VJP"))
    after[vjp] = "STAMP(6);"
    after[vjp + 1] = _FLUSH
    stamped = _insert(lines, after)
    noslot = [
        ("""                bv[j][i] = j < 2 * nk && c < n && r < n ? dbias_h[r * n + c]
                                                        : 0.f;""",
         "                bv[j][i] = 0.f;"),
        ("                  if (r < n && c < n) dbias_h[r * n + c] = "
         "bv[j][i] + dp[j][i];\n", ""),
        ("          slot[(which ? lay.dkg : lay.dqg) + h * dh + d] += "
         "sqrt_dh * acc;", "          P[4096 + t] = sqrt_dh * acc;"),
    ]
    single = _replace(text, [(_NAMESPACE, _NAMESPACE + _HI_ONLY)])
    return {"plain": _wrap(text), "stamp": _wrap(stamped),
            "noslot": _wrap(_replace(text, noslot)),
            "noslot_stamp": _wrap(_replace(stamped, noslot)),
            "single": _wrap(single.replace("mma_split_16816(",
                                           "mma_hi_only("))}


def parent_variants(text: str) -> Dict[str, str]:
    """Four variants of the first design (no n x n split to undo)."""
    lines = text.split("\n")
    ends = {
        # after each call or pass that ends a section in a block barrier
        0: _find(lines, "    __syncthreads();",
                 _find(lines, "// ---- LayerNorm + FiLM recompute")),
        1: _find(lines, "false, nullptr, nullptr, stage);",
                 _find(lines, "mm<true>(kRows, 3 * dh, dim, xf")),
        2: _find(lines, "__syncthreads();", _find(lines, "ssk_s[d] = a * b;")),
        3: _find(lines, "ssk_s, nullptr, stage);"),
        4: _find(lines, "__syncthreads();",
                 _find(lines, "S2[r * kLdS + lane + 32] = p1 * k1;")),
        5: _find(lines, "nullptr, nullptr, stage);",
                 _find(lines, "mm<true>(n, dh, dim, dys")),
        6: _find(lines, "nullptr, stage);",
                 _find(lines, "mm<false>(n, dh, n, S2, kLdS, 1, v")),
        7: _find(lines, "__syncthreads();",
                 _find(lines, "o_h[(e / dh) * ldoh + e % dh] =")),
        8: _find(lines, "dh, dim, kRows, o_h, ldoh, dy_h, ldx, dwout_h"),
        9: _find(lines, "nullptr, nullptr, stage);",
                 _find(lines, "mm<false>(n, dh, n, S2, 1, kLdS, dO")),
        10: _find(lines, "nullptr, stage);",
                  _find(lines, "mm<false>(n, n, dh, dO, ldo, 1, v")),
        11: _find(lines, "__syncthreads();",
                  _find(lines, "dbias_h[r * n + lane + 32] += s1;")),
        12: _find(lines, "nullptr, sk_s, stage);"),
        13: _find(lines, "nullptr, sq_s, stage);"),
        14: _find(lines, "__syncthreads();",
                  _find(lines, "slot[(part ? lay.dkg : lay.dqg)")),
        15: _find(lines, "__syncthreads();",
                  _find(lines, "dqkv_h[(e / dh) * ldqh + 2 * dh + e % dh]")),
        16: _find(lines, "true);", _find(lines, "slot + lay.dwqkv + "
                                                "static_cast<size_t>(h)")),
        17: _find(lines, "kRows, dim, 3 * dh, dqkv_h, ldqh, wq, 3 * dh, dxf"),
    }
    after = {i: f"STAMP({k});" for k, i in ends.items()}
    after[_find(lines, "const float sqrt_dh = sqrtf")] = (
        "  long long sec_acc[20] = {0}; long long sec_last = clock64();")
    after[_find(lines, "  __syncthreads();",
                _find(lines, "o_h[e] = __float2bfloat16(0.f);"))] = (
        "  if (tid == 0) sec_last = clock64();")
    vjp = _find(lines, "    __syncthreads();",
                _find(lines, "// ---- FiLM grads and the LayerNorm VJP"))
    after[vjp] = "STAMP(18);"
    after[vjp + 1] = _FLUSH
    stamped = _insert(lines, after)
    sink = r'''
template <typename LA, typename LB>
__device__ void wmma_sink(int M, int N, int K, const __nv_bfloat16* A,
                          int lda, const __nv_bfloat16* B, int ldb,
                          float* sink) {
  const int mt = M / 16;
  for (int t = threadIdx.x >> 5; t < mt * (N / 16); t += kThreads / 32) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int k = 0; k < K; k += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> b;
      wmma::load_matrix_sync(a, A + wmma_offset<LA>((t % mt) * 16, k, lda),
                             lda);
      wmma::load_matrix_sync(b, B + wmma_offset<LB>(k, (t / mt) * 16, ldb),
                             ldb);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(sink + (threadIdx.x >> 5) * 256, acc, 16,
                            wmma::mem_row_major);
  }
  __syncthreads();
}
'''
    noslot = [
        ("""wmma_mm<wmma::col_major, wmma::row_major>(
            dh, dim, kRows, o_h, ldoh, dy_h, ldx, dwout_h, dim, true);""",
         """wmma_sink<wmma::col_major, wmma::row_major>(
            dh, dim, kRows, o_h, ldoh, dy_h, ldx, stage);"""),
        ("""wmma_mm<wmma::col_major, wmma::row_major>(
            dim, 3 * dh, kRows, xf_h, ldx, dqkv_h, ldqh,
            slot + lay.dwqkv + static_cast<size_t>(h) * dim * 3 * dh, 3 * dh,
            true);""",
         """wmma_sink<wmma::col_major, wmma::row_major>(
            dim, 3 * dh, kRows, xf_h, ldx, dqkv_h, ldqh, stage);"""),
        ("          if (lane < n) dbias_h[r * n + lane] += s0;\n"
         "          if (lane + 32 < n) dbias_h[r * n + lane + 32] += s1;\n",
         ""),
        ("slot[(part ? lay.dkg : lay.dqg) + h * dh + d] += sqrt_dh * acc;",
         "stage[t] = sqrt_dh * acc;"),
        ("template <typename T, bool kTC>\n__global__",
         sink + "template <typename T, bool kTC>\n__global__"),
    ]
    return {"plain": _wrap(text), "stamp": _wrap(stamped),
            "noslot": _wrap(_replace(text, noslot)),
            "noslot_stamp": _wrap(_replace(stamped, noslot))}


def build(sources: Dict[str, str], directory: Path = BUILD,
          extra_flags: Tuple[str, ...] = (),
          logs: Optional[Dict[str, str]] = None) -> Dict[str, Path]:
    """nvcc each source into a shared library in ``directory``, all at
    once, with ``extra_flags`` after the usual ones; each build's compiler
    output goes into ``logs`` when it is given."""
    directory.mkdir(parents=True, exist_ok=True)
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-shared", "-I", str(library.CSRC),
             *extra_flags]
    libs, procs = {}, []
    for name, text in sources.items():
        src = directory / f"{name}.cu"
        src.write_text(text)
        libs[name] = directory / f"lib{name}.so"
        procs.append(subprocess.Popen(
            [library.nvcc(), *flags, "-o", str(libs[name]), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc, name in zip(procs, sources):
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc {name} failed:\n{out}")
        if logs is not None:
            logs[name] = out
    return libs


def flagship_inputs(dev: torch.device):
    """K3's inputs at the flagship training shape, from a numpy seed."""
    rng = np.random.default_rng(SEED)

    def t(shape, scale=1.0, dtype=torch.bfloat16, low=None):
        v = (rng.uniform(low, 1.5, shape) if low is not None
             else rng.standard_normal(shape) * scale)
        return torch.from_numpy(v.astype(np.float32)).to(dev, dtype)

    samples = BW // WINDOWS_PER_SAMPLE
    k = cuda_attn.KernelInputs(
        gamma=t((samples, DIM), 0.5, torch.float32) + 1,
        beta=t((samples, DIM), 0.5, torch.float32),
        wqkv=t((HEADS, DIM, 3 * DIM_HEAD), DIM ** -0.5),
        wout=t((HEADS, DIM_HEAD, DIM), (HEADS * DIM_HEAD) ** -0.5),
        qg=t((HEADS, DIM_HEAD), dtype=torch.float32, low=0.5),
        kg=t((HEADS, DIM_HEAD), dtype=torch.float32, low=0.5),
        bias=t((HEADS, N, N), 1.0, torch.float32),
        windows_per_sample=WINDOWS_PER_SAMPLE, has_film=True)
    return t((BW, N, DIM)), k, t((BW, N, DIM))


class Variant:
    """One built variant of K3, called through its own plain-C entry."""

    def __init__(self, path: Path, x, k, dy, dev):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib = self.lib
        current = hasattr(lib, "vgm_window_attention_bwd_scratch_elems")
        lib.vgm_window_attention_bwd.argtypes = (
            [ptr] * (15 if current else 14) + [i32] * 9 + [i32, i32, f32, ptr])
        lib.vgm_window_attention_bwd.restype = ctypes.c_int
        heads, _, three_dh = k.wqkv.shape
        dh = three_dh // 3
        if current:
            for name, n_args in (("slot_floats", 5), ("grad_floats", 4),
                                 ("scratch_elems", 6)):
                fn = getattr(lib, f"vgm_window_attention_bwd_{name}")
                fn.argtypes = [i32] * n_args
                fn.restype = ctypes.c_long
            slot = lib.vgm_window_attention_bwd_slot_floats(N, DIM, heads, dh, 1)
            grad = lib.vgm_window_attention_bwd_grad_floats(N, DIM, heads, dh)
            scratch = [torch.empty(lib.vgm_window_attention_bwd_scratch_elems(
                BW, N, DIM, heads, dh, 1), dtype=torch.bfloat16, device=dev)]
        else:
            fn = lib.vgm_window_attention_bwd_slot_floats
            fn.argtypes = [i32] * 4
            fn.restype = ctypes.c_long
            slot = grad = fn(N, DIM, heads, dh)
            scratch = []
        num_slots = min(BW, torch.cuda.get_device_properties(dev)
                        .multi_processor_count)
        threshold, scale = keep_constants(RATE)
        self.keep = [torch.empty(num_slots, slot, device=dev),
                     torch.empty(grad, device=dev), torch.empty_like(x),
                     torch.empty(BW, DIM, device=dev),
                     torch.empty(BW, DIM, device=dev), *scratch]
        slots, grads, dx, dgw, dbw = self.keep[:5]
        self.args = (
            [x.data_ptr(), k.gamma.data_ptr(), k.beta.data_ptr(),
             k.wqkv.data_ptr(), k.qg.data_ptr(), k.kg.data_ptr(),
             k.wout.data_ptr(), k.bias.data_ptr(), dy.data_ptr(),
             dx.data_ptr(), dgw.data_ptr(), dbw.data_ptr(), grads.data_ptr(),
             slots.data_ptr()] + [s.data_ptr() for s in scratch]
            + [BW, N, DIM, heads, dh, WINDOWS_PER_SAMPLE, 1, 1, num_slots,
               DROPOUT_SEED, threshold, scale,
               torch.cuda.current_stream(dev).cuda_stream])

    def __call__(self):
        library.check(self.lib.vgm_window_attention_bwd(*self.args),
                      "window_attention_bwd variant")

    def sections(self) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call."""
        self.lib.sections_reset()
        self()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


def split(stamp: np.ndarray, noslot: np.ndarray, names: List[str],
          parts: Dict[str, List[str]]) -> Dict[str, float]:
    """Shares of the stamped cycles: each part without its slot traffic,
    and the slot adds (what the noslot build saves, by section)."""
    total = stamp.sum()
    saved = dict(zip(names, stamp - noslot))
    cycles = dict(zip(names, stamp))
    out = {part: sum(cycles[s] - saved[s] for s in secs) / total
           for part, secs in parts.items()}
    out["slot adds"] = sum(saved.values()) / total
    return out


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path,
                    help="the first design's window_attention_bwd.cu")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("bwd_sections runs on a CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    sources = {f"current_{k}": v for k, v in
               current_variants(SOURCE.read_text()).items()}
    if args.parent is not None:
        sources.update({f"parent_{k}": v for k, v in
                        parent_variants(args.parent.read_text()).items()})
    libs = build(sources)
    x, k, dy = flagship_inputs(dev)
    variants = {name: Variant(path, x, k, dy, dev)
                for name, path in libs.items()}
    runs: Dict[str, object] = {
        "package K3": lambda: cuda_attn.window_attention_bwd_kernel(
            x, k, dy, DROPOUT_SEED, RATE),
        "package K3 + K3-w": lambda: cuda_attn.window_attention_bwd(
            x, k, dy, DROPOUT_SEED, RATE)}
    runs.update({name: v for name, v in variants.items()
                 if name.endswith("_plain")})
    order = list(runs) + list(runs)[::-1]
    order += [name for name in variants if not name.endswith("_plain")]
    ms: Dict[str, List[float]] = {}
    for name in order:
        fn = runs.get(name) or variants[name]
        ms.setdefault(name, []).append(cuda_ms(fn, iters=10))
        print(f"{name}: {ms[name][-1]:.3f} ms", flush=True)
    report: Dict[str, object] = {"card": card, "ms": ms}
    for prefix, names, parts in (
            ("current", SECTIONS, PARTS),
            ("parent", PARENT_SECTIONS, PARENT_PARTS)):
        if f"{prefix}_stamp" not in variants:
            continue
        stamp = variants[f"{prefix}_stamp"].sections()[:len(names)]
        noslot = variants[f"{prefix}_noslot_stamp"].sections()[:len(names)]
        shares = {s: c / stamp.sum() for s, c in zip(names, stamp)}
        parts_ = split(stamp, noslot, names, parts)
        print(f"{prefix} sections: " + " ".join(
            f"{s}={100 * v:.1f}%" for s, v in shares.items()), flush=True)
        print(f"{prefix} split: " + " ".join(
            f"{p}={100 * v:.1f}%" for p, v in parts_.items()), flush=True)
        report[prefix] = {"sections": shares, "split": parts_}
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    import json

    print(json.dumps(main(sys.argv[1:])))
