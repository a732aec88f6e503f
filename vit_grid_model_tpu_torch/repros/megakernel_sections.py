"""Where R7's time goes on the card: the MaxViT layer megakernel's stages
and sections, split by clock64 stamps, and its designs timed in turns.

    python -m vit_grid_model_tpu_torch.repros.megakernel_sections \
        [--parent FILE ...] [--s S ...]

It writes patched copies of ``csrc/maxvit_layer_attention.cu`` (and of
the per-window body it includes) into ``build/megakernel_sections/``
(never into ``csrc/``), builds each with ``nvcc`` and runs them on the
flagship layer of ``repros/megakernel.py`` in bf16 (42 x 35 map, dim 128,
32 heads x 32, window 7, 4 registers) at each S (default 300 and 96),
inputs from a numpy seed.  Variants of each design:

* ``plain``: the kernel as it is;
* ``stamp``: thread 0 of each CTA reads ``clock64()`` after each block
  barrier that ends a section and adds the cycles since the last stamp to
  the section's count, the block stage's sections apart from the grid
  stage's (one ``atomicAdd`` a section at the end of each window).

Each ``--parent FILE`` adds an earlier design, FILE its
``maxvit_layer_attention.cu`` with the body headers it includes beside it
(e.g. from ``git show 3767226:...`` into ``build/parent/``), its builds
named after FILE's directory.  The package's kernel, each design's plain
build and the two-K1 baseline (``repros/megakernel.py::baseline``) run in
turns: first, second, ..., then reversed.  It prints each one's ms a call,
whether each plain build's output is bit-identical to the package
kernel's, each stamped build's sections (shares of the stamped cycles) and
the split: block stage against grid stage, and within a window LN + FiLM,
qkv (with the QK-RMSNorm), the n x n section (scores, softmax, P.v), the
out-projection, the residual or gather, and the cluster barriers' waits.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.repros import megakernel as repro
from vit_grid_model_tpu_torch.repros.bwd_sections import (_find, _insert,
                                                          _replace, build)
from vit_grid_model_tpu_torch.repros.common import card_line, cuda_ms
from vit_grid_model_tpu_torch.repros.fwd_sections import inline_header

BUILD = library.LIBRARY.parent.parent / "megakernel_sections"
SOURCE = library.CSRC / "maxvit_layer_attention.cu"
FIRST_BODY = "window_attention_body.cuh"
STRIP_BODY = "window_attention_strips.cuh"
SEED = 0
CASES = [300, 96]

_PRE = r'''
__device__ unsigned long long g_sections[32];
#define STAMP(k) do { if (threadIdx.x == 0) { long long t_ = clock64(); \
  sec_acc[k] += t_ - sec_last; sec_last = t_; } } while (0)
#define FLUSH_SECTIONS() do { if (threadIdx.x == 0) \
  for (int k_ = 0; k_ < 32; ++k_) if (sec_acc[k_]) { \
    atomicAdd(&g_sections[k_], (unsigned long long)sec_acc[k_]); \
    sec_acc[k_] = 0; } } while (0)
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
_OPEN = "  long long sec_acc[32] = {0}; long long sec_last = clock64();"

# a window's sections (the block stage's at 0.., the grid stage's at
# GRID..), and the parts of the split they fall in
GRID = 16
SECTIONS = ["gather", "LN", "qkv", "norm", "S", "softmax", "PV", "outproj",
            "residual", "cluster"]
PARTS = {"LN + FiLM": ["LN"], "qkv + QK-norm": ["qkv", "norm"],
         "n x n": ["S", "softmax", "PV"], "out-projection": ["outproj"],
         "residual or gather": ["gather", "residual"],
         "cluster barrier": ["cluster"]}


def is_strip_design(text: str) -> bool:
    return STRIP_BODY in text


def first_body_stamped(body: str) -> str:
    """The first design's ``attend_window`` with a stamp at each of its
    sections' ends, offset by the caller's ``sec_off``."""
    b = body.split("\n")
    after = {
        _find(b, "  __syncthreads();", _find(b, "y[e] = 0.f;")):
            "STAMP(sec_off + 1);",
        _find(b, "gemm_rows64(xs, ldx, wq, 3 * dh, qkv, ldq, dim, 3 * dh,"):
            "STAMP(sec_off + 2);",
        _find(b, "    __syncthreads();",
              _find(b, "vec[d] = vec[d] * scale * gm[d];")):
            "STAMP(sec_off + 3);",
        _find(b, "    __syncthreads();", _find(b, "s[r * kRows + c] = v;")):
            "STAMP(sec_off + 4);",
        _find(b, "    __syncthreads();", _find(b, "sr[lane + 32] = p1;")):
            "STAMP(sec_off + 5);",
        _find(b, "    __syncthreads();",
              _find(b, "qkv[(4 * ty + i) * ldq + d] = round_to<T>(acc[i]);")):
            "STAMP(sec_off + 6);",
        _find(b, "gemm_rows64(qkv, ldq, wo, dim, y, dim, dh, dim, true,"):
            "STAMP(sec_off + 7);",
    }
    return _replace(_insert(b, after), [(
        "                              unsigned keep_threshold, "
        "float keep_scale) {",
        "                              unsigned keep_threshold, "
        "float keep_scale,\n"
        "                              long long* sec_acc, "
        "long long& sec_last, int sec_off) {")])


def first_stamped(text: str) -> str:
    """The first design's kernel (every body section stamped; the block
    windows' x gather into shared memory, the residuals and the cluster
    barriers stamped in the kernel)."""
    f = text.split("\n")
    kernel = _find(f, "    maxvit_layer_attention_kernel(")
    after = {
        _find(f, "extern __shared__", kernel): _OPEN,
        _find(f, "    __syncthreads();", _find(f, "    rw[e] =", kernel)):
            "STAMP(0);",
        _find(f, "    __syncthreads();",
              _find(f, "n, dim, blk.gamma + film, blk.beta + film, 1);",
                    kernel)): "STAMP(1);",
        _find(f, "    __syncthreads();",
              _find(f, "rw[e - nr * dim] += y[e];", kernel)):
            "STAMP(8); FLUSH_SECTIONS();",
        _find(f, "  cluster.sync();  // every CTA's pixels", kernel):
            f"STAMP(9);",
        _find(f, "    __syncthreads();",
              _find(f, "n, dim, grd.gamma + film, grd.beta + film, 1);",
                    kernel)): f"STAMP({GRID + 1});",
        _find(f, "    __syncthreads();",
              _find(f, "from_f32<T>(y[(nr + t) * dim + c] + pixel(t)[c]);",
                    kernel)): f"STAMP({GRID + 8}); FLUSH_SECTIONS();",
        _find(f, "  cluster.sync();  // no CTA leaves", kernel):
            f"STAMP({GRID + 9}); FLUSH_SECTIONS();",
    }
    return _replace(_insert(f, after), [
        ("blk.bias, n, dim, heads, dh, 0, 0u, 0u, 1.f);",
         "blk.bias, n, dim, heads, dh, 0, 0u, 0u, 1.f, "
         "sec_acc, sec_last, 0);"),
        ("grd.bias, n, dim, heads, dh, 0, 0u, 0u, 1.f);",
         f"grd.bias, n, dim, heads, dh, 0, 0u, 0u, 1.f, "
         f"sec_acc, sec_last, {GRID});")])


def strip_stamped(text: str) -> str:
    """The strip design's kernel, its strip body inlined: the body's
    sections stamped (its qkv product with the norm in its epilogue, the
    strips' n x n products up to their named barrier, which the stamped
    build makes a block barrier, the out-projection, the epilogue), offset
    by the stage; the cluster barrier stamped in the kernel."""
    f = text.split("\n")
    body = _find(f, "__device__ __forceinline__ void attend_window_strips(")
    kernel = _find(f, "    maxvit_layer_attention_strips(")
    after = {
        _find(f, "  __syncthreads();", _find(f, "layer_norm_rows<bf16, true>(",
                                             body)): "STAMP(sec_off + 1);",
        _find(f, "    __syncthreads();",
              _find(f, "cp_async_wait<0>();  // Wout_h has landed", body)):
            "STAMP(sec_off + 2);",
        _find(f, "strip_barrier(1 + strip);", body):
            "      __syncthreads(); STAMP(sec_off + 4);",
        _find(f, "    __syncthreads();", _find(f, "strip_barrier(1 + strip);",
                                             body)): "STAMP(sec_off + 7);",
        # the body's last line, before its closing brace
        f.index("}", body) - 1: "  __syncthreads(); STAMP(sec_off + 8);",
        _find(f, "extern __shared__", kernel): _OPEN,
        _find(f, "  cluster.sync();  // every pixel", kernel):
            "STAMP(9); FLUSH_SECTIONS();",
        _find(f, "  cluster_wait();", kernel):
            f"STAMP({GRID + 9}); FLUSH_SECTIONS();",
    }
    out = _insert(f, after)
    return _replace(out, [
        ("    Epilogue epilogue) {",
         "    Epilogue epilogue, long long* sec_acc, long long& sec_last,\n"
         "    int sec_off) {"),
        ("        block_store);", "        block_store, sec_acc, sec_last, 0);"
         " FLUSH_SECTIONS();"),
        ("        grid_store);", f"        grid_store, sec_acc, sec_last, "
         f"{GRID}); FLUSH_SECTIONS();")])


def variants(path: Path) -> Dict[str, str]:
    """{variant: source} of the design at ``path``: each a single source
    that includes only csrc's shared helpers (the design's body headers
    inlined, or included from a copy written beside it)."""
    text = path.read_text()
    tag = path.parent.name if path.resolve() != SOURCE.resolve() else "current"
    BUILD.mkdir(parents=True, exist_ok=True)
    out = {}
    if is_strip_design(text):
        text = inline_header(text, path.parent / STRIP_BODY)
        first = (path.parent / FIRST_BODY).read_text()
        (BUILD / f"{tag}_body.cuh").write_text(first)
        text = _replace(text, [(f'#include "{FIRST_BODY}"',
                                f'#include "{tag}_body.cuh"')])
        out[f"{tag}_plain"] = _PRE + text + _POST
        out[f"{tag}_stamp"] = _PRE + strip_stamped(text) + _POST
        return out
    first = (path.parent / FIRST_BODY).read_text()
    for name, fwd, body in (("plain", text, first),
                            ("stamp", first_stamped(text),
                             first_body_stamped(first))):
        (BUILD / f"{tag}_{name}_body.cuh").write_text(body)
        out[f"{tag}_{name}"] = _PRE + _replace(fwd, [(
            f'#include "{FIRST_BODY}"',
            f'#include "{tag}_{name}_body.cuh"')]) + _POST
    return out


class Variant:
    """One built variant of R7, called through its own plain-C entry (the
    strip design's takes a scratch map and a cluster size)."""

    def __init__(self, path: Path, strips: bool, x, regs, ops_b, ops_g):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        fn = self.lib.vgm_maxvit_layer_attention
        fn.argtypes = ([ptr] * (18 if strips else 17) + [i32] * 9
                       + ([i32] if strips else []) + [ptr])
        fn.restype = ctypes.c_int
        s, h, w, dim = x.shape
        heads, _, three_dh = ops_b.wqkv.shape
        self.out = torch.empty_like(x)
        ptrs = [x.data_ptr(), regs.data_ptr(),
                *(t.data_ptr() for t in ops_b[:7]),
                *(t.data_ptr() for t in ops_g[:7])]
        extra = []
        if strips:
            self.scratch = torch.empty(x.shape, dtype=torch.float32,
                                       device=x.device)
            ptrs.append(self.scratch.data_ptr())
            extra = [0]  # the default cluster
        self.args = (ptrs + [self.out.data_ptr(), s, h, w, repro.WIN,
                             regs.shape[0], dim, heads, three_dh // 3, 1]
                     + extra
                     + [torch.cuda.current_stream(x.device).cuda_stream])

    def __call__(self):
        library.check(self.lib.vgm_maxvit_layer_attention(*self.args),
                      "maxvit_layer_attention variant")
        return self.out

    def sections(self) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call."""
        self.lib.sections_reset()
        self()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


def split(stamp: np.ndarray) -> Dict[str, float]:
    """Each stage's and each part's share of the stamped cycles."""
    total = stamp.sum()
    out = {"block stage": stamp[:GRID].sum() / total,
           "grid stage": stamp[GRID:].sum() / total}
    for part, secs in PARTS.items():
        idx = [SECTIONS.index(s) for s in secs]
        out[part] = sum(stamp[i] + stamp[GRID + i] for i in idx) / total
    return out


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an earlier design's maxvit_layer_attention.cu, "
                         "with its body headers beside it (may be given "
                         "more than once)")
    ap.add_argument("--s", type=int, action="append", default=[],
                    help=f"sample-leads (default {CASES})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("megakernel_sections runs on a CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    designs = {"current": SOURCE}
    designs.update({p.parent.name: p for p in args.parent})
    strips = {}
    srcs: Dict[str, str] = {}
    for prefix, path in designs.items():
        v = variants(path)
        srcs.update(v)
        strips.update({name: is_strip_design(path.read_text()) for name in v})
    libs = build(srcs, BUILD)
    block_attn, grid_attn, regs = (t.to(dev) for t in repro.layer(SEED))
    report: Dict[str, object] = {"card": card}
    for s in args.s or CASES:
        x, cond = repro.inputs(s, torch.bfloat16, dev, SEED + 3)
        r, ops_b, ops_g = repro.layer_operands(block_attn, grid_attn, regs,
                                               cond, torch.bfloat16)
        built = {name: Variant(path, strips[name], x, r, ops_b, ops_g)
                 for name, path in libs.items()}
        with torch.inference_mode():
            ref = av.maxvit_layer_attention(x, r, ops_b, ops_g, repro.WIN)
            torch.cuda.synchronize()
            for name, v in built.items():
                out = v()
                torch.cuda.synchronize()
                err = ((out.float() - ref.float()).abs().max()
                       / ref.float().abs().max()).item()
                print(f"S={s}: {name} max|d| / max|package R7| = {err:.3e}"
                      f"{'; bit-identical' if torch.equal(out, ref) else ''}",
                      flush=True)
            runs: Dict[str, Callable[[], object]] = {
                "package R7": lambda: av.maxvit_layer_attention(
                    x, r, ops_b, ops_g, repro.WIN)}
            runs.update({n: v for n, v in built.items()
                         if n.endswith("_plain")})
            runs["two-K1 baseline"] = lambda: repro.baseline(
                x, block_attn, grid_attn, regs, cond)
            order = list(runs) + list(runs)[::-1]
            ms: Dict[str, List[float]] = {}
            for name in order:
                ms.setdefault(name, []).append(cuda_ms(runs[name], iters=5))
                print(f"S={s} bf16: {name}: {ms[name][-1]:.3f} ms",
                      flush=True)
            out_s: Dict[str, object] = {"ms": ms}
            for name, v in built.items():
                if not name.endswith("_stamp"):
                    continue
                stamp = v.sections()
                names = ([f"block {n}" for n in SECTIONS]
                         + [f"grid {n}" for n in SECTIONS])
                cyc = np.concatenate([stamp[:len(SECTIONS)],
                                      stamp[GRID:GRID + len(SECTIONS)]])
                shares = {k: c / stamp.sum() for k, c in zip(names, cyc)
                          if c}
                parts = split(stamp)
                print(f"S={s} {name} sections: " + " ".join(
                    f"{k}={100 * val:.1f}%" for k, val in shares.items()),
                    flush=True)
                print(f"S={s} {name} split: " + " ".join(
                    f"{k}={100 * val:.1f}%" for k, val in parts.items()),
                    flush=True)
                out_s[name] = {"sections": shares, "split": parts}
        report[f"S={s}"] = out_s
        del x, built, ref
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
