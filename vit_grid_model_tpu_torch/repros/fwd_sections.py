"""Where K1's time goes on the card: the window-attention forward's
sections, split by clock64 stamps.

    python -m vit_grid_model_tpu_torch.repros.fwd_sections [--parent FILE]

It writes patched copies of ``csrc/window_attention_fwd.cu`` (and of the
per-window body it includes) into ``build/fwd_sections/`` (never into
``csrc/``), builds each with ``nvcc`` and runs them on two cases, inputs
from a numpy seed: the flagship evaluation (bf16, Bw 9,000 windows of 53
tokens, dim 128, 32 heads x 32, FiLM on) and the training call (the same
at Bw 1,440 with dropout at rate 0.1).  Variants of the source's strip
path (bf16):

* ``plain``: the kernel as it is;
* ``stamp``: thread 0 of each CTA reads ``clock64()`` after each block
  barrier that ends a section and adds the cycles since the last stamp to
  the section's count (one ``atomicAdd`` a section at the CTA's end);
* ``single``: each n x n product one bf16 product (hi.hi) instead of the
  three of the hi/lo split (its output is less accurate; only the time
  counts);
* ``one_cta``: one CTA an SM instead of two, each head's weights staged a
  whole head ahead in a second buffer.

Each ``--parent FILE`` adds an earlier design, FILE its
``window_attention_fwd.cu`` with its ``window_attention_body.cuh`` beside
it, its builds named after FILE's directory: the first design (every
head's n x n products on CUDA cores through a 64 x 64 shared score tile,
in the body; e.g. from ``git show e911722:...``) is built plain and
stamped, an earlier strip design plain only.  The plain builds run in
turns beside the package's own K1: first, second, ..., then reversed.  It
prints whether each variant's output is bit-identical to the package
K1's, each variant's ms a call, each section's share of the stamped
cycles and the split into parts: LayerNorm + FiLM, the qkv product and the
QK-RMSNorm (one section in the strip design, two in the first), the n x n
section (scores, softmax with the dropout hash, P.v), the out-projection
(the first design's with y's read-modify-write in shared memory) and the
store.
"""

from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path
from typing import Dict, List, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.dropout import keep_constants
from vit_grid_model_tpu_torch.repros.bwd_sections import (_find, _insert,
                                                          _replace, build)
from vit_grid_model_tpu_torch.repros.common import card_line, cuda_ms

BUILD = library.LIBRARY.parent.parent / "fwd_sections"
SOURCE = library.CSRC / "window_attention_fwd.cu"
BODY = "window_attention_body.cuh"
STRIPS = "window_attention_strips.cuh"
N, DIM, HEADS, DIM_HEAD = 53, 128, 32, 32
WINDOWS_PER_SAMPLE = 30
SEED, DROPOUT_SEED = 0, 2 ** 30 + 12345
# (name, windows, dropout rate)
CASES = [("eval", 9000, 0.0), ("train", 1440, 0.1)]

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
_OPEN = "  long long sec_acc[16] = {0}; long long sec_last = clock64();"
_FLUSH = ("  if (threadIdx.x == 0) for (int k = 0; k < 16; ++k) "
          "atomicAdd(&g_sections[k], (unsigned long long)sec_acc[k]);")
_HI_ONLY = r'''
__device__ __forceinline__ void mma_hi_only(float (&c)[4],
    const uint32_t (&ahi)[4], const uint32_t (&)[4],
    const uint32_t (&bhi)[2], const uint32_t (&)[2]) {
  mma_bf16_16816(c, ahi, bhi[0], bhi[1]);
}
'''

# the sections of each design, and the parts of the split they fall in
SECTIONS = ["LN", "qkv", "strips", "outproj", "store"]
SECTION_PARTS = {"LN + FiLM": ["LN"], "qkv + QK-norm": ["qkv"],
                 "n x n": ["strips"], "out-projection": ["outproj"],
                 "store": ["store"]}
FIRST_SECTIONS = ["LN", "qkv", "norm", "S", "softmax", "PV", "outproj",
                  "store"]
FIRST_PARTS = {"LN + FiLM": ["LN"], "qkv": ["qkv"], "QK-norm": ["norm"],
               "n x n": ["S", "softmax", "PV"],
               "out-projection": ["outproj"], "store": ["store"]}


def _wrap(text: str) -> str:
    """The stamp counters and their macro ahead of everything (the body
    header uses them), their readers at the end."""
    return _PRE + text + _POST


def is_strip_design(fwd: str) -> bool:
    return "window_attention_fwd_strips" in fwd


def inline_header(text: str, header: Path) -> str:
    """``text`` with its include of ``header`` replaced by the header's own
    text (its ``#pragma once`` and its include of the first design's body
    dropped: ``text`` includes that itself)."""
    body = header.read_text()
    body = body.replace("#pragma once\n", "").replace(
        f'#include "{BODY}"\n', "")
    return _replace(text, [(f'#include "{header.name}"\n', body)])


def first_variants(fwd: str, body: str) -> Dict[str, Tuple[str, str]]:
    """The plain and stamped builds of the first design: {variant: (fwd
    source, body source)}; each fwd source includes its own body copy."""
    b = body.split("\n")
    after = {
        _find(b, "  __syncthreads();", _find(b, "y[e] = 0.f;")): "STAMP(0);",
        _find(b, "gemm_rows64(xs, ldx, wq, 3 * dh, qkv, ldq, dim, 3 * dh,"):
            "STAMP(1);",
        _find(b, "    __syncthreads();",
              _find(b, "vec[d] = vec[d] * scale * gm[d];")): "STAMP(2);",
        _find(b, "    __syncthreads();", _find(b, "s[r * kRows + c] = v;")):
            "STAMP(3);",
        _find(b, "    __syncthreads();", _find(b, "sr[lane + 32] = p1;")):
            "STAMP(4);",
        _find(b, "    __syncthreads();",
              _find(b, "qkv[(4 * ty + i) * ldq + d] = round_to<T>(acc[i]);")):
            "STAMP(5);",
        _find(b, "gemm_rows64(qkv, ldq, wo, dim, y, dim, dh, dim, true,"):
            "STAMP(6);",
    }
    stamped_body = _insert(b, after)
    # attend_window takes the kernel's stamp state
    stamped_body = _replace(stamped_body, [(
        "                              unsigned keep_threshold, "
        "float keep_scale) {",
        "                              unsigned keep_threshold, "
        "float keep_scale,\n"
        "                              long long* sec_acc, "
        "long long& sec_last) {")])
    f = fwd.split("\n")
    after = {
        _find(f, "extern __shared__"): _OPEN,
        _find(f, "  __syncthreads();", _find(f, "layer_norm_rows<T, ")):
            "STAMP(0);",
        _find(f, "    ow[e] = from_f32<T>(y[e]);"):
            "  __syncthreads(); STAMP(7);\n" + _FLUSH,
    }
    stamped_fwd = _replace(_insert(f, after), [(
        "keep_scale);\n  const float* y",
        "keep_scale, sec_acc, sec_last);\n  const float* y")])
    out = {}
    for name, text, body_text in (("plain", fwd, body),
                                  ("stamp", stamped_fwd, stamped_body)):
        out[name] = (text, body_text)
    return out


def strip_variants(fwd: str) -> Dict[str, str]:
    """The plain, stamped and one-product builds of the strip design (its
    strip body inlined), and its one-CTA build.  The n x n section ends at
    the strip's named barrier; the stamped build adds a block barrier there
    (every strip is live at n = 53).  The body runs once a CTA, so its
    stamps open and flush there."""
    f = fwd.split("\n")
    body = _find(f, "__device__ __forceinline__ void attend_window_strips(")
    after = {
        _find(f, "    Epilogue epilogue) {", body): _OPEN,
        _find(f, "  __syncthreads();", _find(f, "layer_norm_rows<bf16, true>(",
                                             body)): "STAMP(0);",
        _find(f, "    __syncthreads();",
              _find(f, "cp_async_wait<0>();  // Wout_h has landed", body)):
            "STAMP(1);",
        _find(f, "strip_barrier(1 + strip);", body):
            "      __syncthreads(); STAMP(2);",
        _find(f, "    __syncthreads();", _find(f, "strip_barrier(1 + strip);",
                                             body)): "STAMP(3);",
        # the body's last line (its epilogue, the store), before its brace
        f.index("}", body) - 1: "  __syncthreads(); STAMP(4);\n" + _FLUSH,
    }
    stamped = _insert(f, after)
    anchor = "using bf16 = __nv_bfloat16;\n"
    single = _replace(fwd, [(anchor, anchor + _HI_ONLY)])
    if "mma_split_16816(" not in single:
        raise ValueError(f"{SOURCE.name} has changed: its split products")
    single = single.replace("mma_split_16816(", "mma_hi_only(")
    return {"plain": fwd, "stamp": stamped, "single": single,
            "one_cta": one_cta_variant(fwd)}


def one_cta_variant(fwd: str) -> str:
    """One CTA an SM instead of two, each head's weights staged a whole
    head ahead in a second buffer (twice the shared memory for them)."""
    return _replace(fwd, [
        ("__global__ void __launch_bounds__(kThreads, 2)\n"
         "    window_attention_fwd_strips(",
         "__global__ void __launch_bounds__(kThreads, 1)\n"
         "    window_attention_fwd_strips("),
        ("p.wq = take(static_cast<size_t>(dim) * p.ldwq * sizeof(bf16));",
         "p.wq = take(2 * static_cast<size_t>(dim) * p.ldwq * sizeof(bf16));"),
        ("p.wo = take(static_cast<size_t>(dh) * p.ldwo * sizeof(bf16));",
         "p.wo = take(2 * static_cast<size_t>(dh) * p.ldwo * sizeof(bf16));"),
        ("    const bool next = h + 1 < heads;\n",
         "    const bool next = h + 1 < heads;\n"
         "    bf16* wq_h = wq_s + (h & 1) * dim * plan.ldwq;\n"
         "    bf16* wo_h = wo_s + (h & 1) * dh * plan.ldwo;\n"
         "    if (next) {\n"
         "      copy_rows_async(wq_s + ((h + 1) & 1) * dim * plan.ldwq,\n"
         "                      plan.ldwq, wqkv + (h + 1) * wq_elems, 3 * dh,"
         " dim, 3 * dh, false);\n"
         "      copy_rows_async(wo_s + ((h + 1) & 1) * dh * plan.ldwo,\n"
         "                      plan.ldwo, wout + (h + 1) * wo_elems, "
         "out_dim, dh, out_dim);\n"
         "    }\n"),
        ("b, wq_s + (k0 + b_k) * plan.ldwq",
         "b, wq_h + (k0 + b_k) * plan.ldwq"),
        ("""    // Wqkv_{h+1} in flight until the head's last barrier
    if (next)
      copy_rows_async(wq_s, plan.ldwq, wqkv + (h + 1) * wq_elems, 3 * dh,
                      dim, 3 * dh);
""", ""),
        ("    cp_async_wait<0>();  // Wout_h has landed\n", ""),
        ("b, wo_s + (k0 + b_k) * plan.ldwo",
         "b, wo_h + (k0 + b_k) * plan.ldwo"),
        ("""    // Wout_{h+1} in flight until the next head's first barrier
    if (kOutProj && next)
      copy_rows_async(wo_s, plan.ldwo, wout + (h + 1) * wo_elems, out_dim,
                      dh, out_dim);
""", ""),
    ])


def variants(fwd_path: Path) -> Dict[str, Tuple[str, str]]:
    """{variant: (fwd source, body source)} of the design at fwd_path."""
    fwd = fwd_path.read_text()
    body = (fwd_path.parent / BODY).read_text()
    if fwd_path.resolve() == SOURCE.resolve():
        fwd = inline_header(fwd, fwd_path.parent / STRIPS)
        return {k: (v, body) for k, v in strip_variants(fwd).items()}
    if is_strip_design(fwd):  # an earlier strip design: timed as it is,
        strips = fwd_path.parent / STRIPS  # with its own strip header
        if strips.exists():
            fwd = inline_header(fwd, strips)
        return {"plain": (fwd, body)}
    return first_variants(fwd, body)


def sources(prefix: str, fwd_path: Path) -> Dict[str, str]:
    """The build's sources of one design: each variant's fwd source, its
    include of the body pointed at the variant's own body copy, which is
    written beside it."""
    out = {}
    BUILD.mkdir(parents=True, exist_ok=True)
    for name, (fwd, body) in variants(fwd_path).items():
        tag = f"{prefix}_{name}"
        (BUILD / f"{tag}_body.cuh").write_text(body)
        out[tag] = _wrap(_replace(fwd, [(f'#include "{BODY}"',
                                         f'#include "{tag}_body.cuh"')]))
    return out


def flagship_inputs(bw: int, dev: torch.device):
    """K1's inputs at the flagship shape for bw windows, from a numpy
    seed."""
    rng = np.random.default_rng(SEED)

    def t(shape, scale=1.0, dtype=torch.bfloat16, low=None):
        v = (rng.uniform(low, 1.5, shape) if low is not None
             else rng.standard_normal(shape) * scale)
        return torch.from_numpy(v.astype(np.float32)).to(dev, dtype)

    k = cuda_attn.KernelInputs(
        gamma=t((bw // WINDOWS_PER_SAMPLE, DIM), 0.5, torch.float32) + 1,
        beta=t((bw // WINDOWS_PER_SAMPLE, DIM), 0.5, torch.float32),
        wqkv=t((HEADS, DIM, 3 * DIM_HEAD), DIM ** -0.5),
        wout=t((HEADS, DIM_HEAD, DIM), (HEADS * DIM_HEAD) ** -0.5),
        qg=t((HEADS, DIM_HEAD), dtype=torch.float32, low=0.5),
        kg=t((HEADS, DIM_HEAD), dtype=torch.float32, low=0.5),
        bias=t((HEADS, N, N), 1.0, torch.float32),
        windows_per_sample=WINDOWS_PER_SAMPLE, has_film=True)
    return t((bw, N, DIM)), k


class Variant:
    """One built variant of K1, called through its own plain-C entry."""

    def __init__(self, path: Path, x, k, rate: float):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn = self.lib.vgm_window_attention_fwd
        fn.argtypes = [ptr] * 9 + [i32] * 8 + [i32, i32, f32, ptr]
        fn.restype = ctypes.c_int
        bw, n, dim = x.shape
        heads, _, three_dh = k.wqkv.shape
        threshold, scale = keep_constants(rate)
        self.out = torch.empty_like(x)
        self.args = (
            [x.data_ptr(), k.gamma.data_ptr(), k.beta.data_ptr(),
             k.wqkv.data_ptr(), k.qg.data_ptr(), k.kg.data_ptr(),
             k.wout.data_ptr(), k.bias.data_ptr(), self.out.data_ptr(),
             bw, n, dim, heads, three_dh // 3, WINDOWS_PER_SAMPLE, 1, 1,
             DROPOUT_SEED, threshold, scale,
             torch.cuda.current_stream(x.device).cuda_stream])

    def __call__(self):
        library.check(self.lib.vgm_window_attention_fwd(*self.args),
                      "window_attention_fwd variant")
        return self.out

    def sections(self) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call."""
        self.lib.sections_reset()
        self()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


def split(stamp: np.ndarray, names: List[str],
          parts: Dict[str, List[str]]) -> Dict[str, float]:
    """Each part's share of the stamped cycles."""
    cycles = dict(zip(names, stamp))
    return {part: sum(cycles[s] for s in secs) / stamp.sum()
            for part, secs in parts.items()}


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an earlier design's window_attention_fwd.cu, with "
                         f"its {BODY} beside it; its builds are named after "
                         "its directory (may be given more than once)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("fwd_sections runs on a CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    designs = {"current": SOURCE}
    designs.update({path.parent.name: path for path in args.parent})
    srcs: Dict[str, str] = {}
    for prefix, path in designs.items():
        srcs.update(sources(prefix, path))
    libs = build(srcs, BUILD)
    report: Dict[str, object] = {"card": card}
    for case, bw, rate in CASES:
        x, k = flagship_inputs(bw, dev)
        variants_ = {name: Variant(path, x, k, rate)
                     for name, path in libs.items()}
        ref = cuda_attn.window_attention_fwd(x, k, DROPOUT_SEED, rate)
        for name, v in variants_.items():
            out = v()
            err = ((out.float() - ref.float()).abs().max()
                   / ref.float().abs().max()).item()
            same = "; bit-identical" if torch.equal(out, ref) else ""
            print(f"{case}: {name} max|d| / max|package K1| = {err:.3e}"
                  f"{same}", flush=True)
        runs: Dict[str, object] = {
            "package K1": lambda: cuda_attn.window_attention_fwd(
                x, k, DROPOUT_SEED, rate)}
        runs.update({name: v for name, v in variants_.items()
                     if name.endswith("_plain")})
        order = list(runs) + list(runs)[::-1]
        order += [name for name in variants_ if not name.endswith("_plain")]
        ms: Dict[str, List[float]] = {}
        for name in order:
            fn = runs.get(name) or variants_[name]
            ms.setdefault(name, []).append(cuda_ms(fn, iters=10))
            print(f"{case} Bw={bw} rate={rate}: {name}: {ms[name][-1]:.3f} ms",
                  flush=True)
        out: Dict[str, object] = {"ms": ms}
        for prefix, path in designs.items():
            name = f"{prefix}_stamp"
            if name not in variants_:
                continue
            strips = is_strip_design(path.read_text())
            names = SECTIONS if strips else FIRST_SECTIONS
            parts = SECTION_PARTS if strips else FIRST_PARTS
            stamp = variants_[name].sections()[:len(names)]
            shares = {s: c / stamp.sum() for s, c in zip(names, stamp)}
            parts_ = split(stamp, names, parts)
            print(f"{case} {prefix} sections: " + " ".join(
                f"{s}={100 * v:.1f}%" for s, v in shares.items()), flush=True)
            print(f"{case} {prefix} split: " + " ".join(
                f"{p}={100 * v:.1f}%" for p, v in parts_.items()), flush=True)
            out[prefix] = {"sections": shares, "split": parts_}
        report[case] = out
        del x, k, variants_, ref
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    import json

    print(json.dumps(main(sys.argv[1:])))
