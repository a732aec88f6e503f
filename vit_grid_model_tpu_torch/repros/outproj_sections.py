"""The out-projection kernel's designs on the card: occupancy, times in
turns, agreement, and the strip design's time split by clock64 stamps.

    python -m vit_grid_model_tpu_torch.repros.outproj_sections \
        [--parent FILE ...] [--bw BW ...]

It writes a self-contained copy of ``csrc/outproj_attention.cu`` and of
each FILE (an earlier design's ``outproj_attention.cu`` with the headers it
includes beside it, e.g. from ``git show <commit>:...`` into
``build/parent_outproj/``) into ``build/outproj_sections/`` (never into
``csrc/``): every header a source includes from its own directory is
inlined, so each design builds with its own headers.  Each is built with
``nvcc`` and run at the repros' geometry in bf16 (56 tokens, dim 128, 32
heads x 32, out 128; R8's cases at 64 tokens) at each Bw (default 2,880
and 9,000), inputs from a numpy seed (``repros/weightsliced_variants.py::
inputs``).  For each design and case it prints:

* an occupancy line: the design the launch takes (0 the first, 1 the
  strip design, from the source's own ``vgm_outproj_attention_route``;
  a source without it has only the first), the kernel's registers and
  local (spill) bytes a thread, its shared memory a CTA, its CTAs an SM
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), and its CTAs a
  launch at 8, 16 and 32 windows a CTA beside the card's slots;
* its ms a call, every design in turns (first, second, ..., then
  reversed), and whether its output is within the bf16 tolerance of the
  plain version with the case's casts (and its distance from the
  package kernel's output).

The cases are R12's ``baseline`` and R13's four structures, R2's three
casts (on ``ws_2pass_pwout``) and R8's kfold 1, 2 and 4 at n 64.  For a
strip design it also builds a ``stamp`` copy, in which thread 0 of each CTA
reads ``clock64()`` after the block barrier that ends each section of the
strip body (the row fill, the qkv product with its norm, the n x n
products up to the strips' named barrier, which the stamped copy makes a
block barrier, the out-projection, the store) and adds the cycles to the
section's count, and prints each section's share at ``ws_2pass_pwout``
and ``bf16_both``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import bf16_mxu_operands as r2
from vit_grid_model_tpu_torch.repros import npad_and_kfold as r8
from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
from vit_grid_model_tpu_torch.repros.bwd_sections import (_find, _insert,
                                                          _replace, build)
from vit_grid_model_tpu_torch.repros.common import card_line, cuda_ms
from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

BUILD = library.LIBRARY.parent.parent / "outproj_sections"
SOURCE = library.CSRC / "outproj_attention.cu"
STRIP_KERNEL = "outproj_attention_strips"
SEED = 0
BWS = [2880, 9000]
WINDOWS_PER_CTA = (8, 16, 32)
TOLERANCE = r1.TOLERANCE[torch.bfloat16]

# case -> (n, R9's weight, two_pass, perhead_wout, bf16_score, bf16_agg,
# windows a CTA)
CASES = {name: (r1.N_PAD, r9, tp, pw, False, False, 8)
         for name, (r9, tp, pw) in ws.VARIANTS.items()}
CASES.update({name: (r1.N_PAD, True, True, True, s, a, 8)
              for name, (s, a) in r2.CASTS.items() if s or a})
CASES.update({f"npad64_kfold{k}": (64, True, True, True, False, False,
                                   r8.BLK * k) for k in r8.KFOLDS})
STAMPED = ("ws_2pass_pwout", "bf16_both")

# the strip body's sections, in order
SECTIONS = ["rows", "qkv", "n x n", "outproj", "store"]

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
# registers, local bytes, shared memory and CTAs an SM of a kernel, for the
# occupancy exports a section tool appends to an earlier design's source
_OCCUPANCY_OF = r'''
template <typename K>
int sections_occupancy_of(K kernel, size_t smem, int* out) {
  cudaFuncAttributes a;
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  int blocks = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                        kThreads, smem);
  if (err != cudaSuccess) return -1;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return 0;
}
'''
# the occupancy export of a source that has only the first design (the
# package's own, vgm_outproj_attention_occupancy, has the same interface)
_FIRST_OCCUPANCY = _OCCUPANCY_OF + r'''
extern "C" int vgm_outproj_attention_occupancy(
    int n, int dim, int dh, int out_dim, int group, int cat_heads,
    int bf16_score, int bf16_agg, int is_bf16, int* out) {
  (void)n; (void)bf16_score; (void)bf16_agg;
  if (is_bf16)
    return sections_occupancy_of(
        outproj_attention_kernel<__nv_bfloat16, true>,
        make_outproj_plan<__nv_bfloat16>(dim, dh, out_dim, group,
                                         cat_heads).bytes, out);
  return sections_occupancy_of(
      outproj_attention_kernel<float, false>,
      make_outproj_plan<float>(dim, dh, out_dim, group, cat_heads).bytes,
      out);
}
'''
_INCLUDE = re.compile(r'^#include "([^"]+)"\s*$', re.M)


def inline_includes(text: str, directory: Path,
                    seen: Optional[set] = None) -> str:
    """``text`` with each ``#include "h"`` of a header in ``directory``
    replaced by the header's text, recursively, each header once (its
    ``#pragma once`` dropped); other includes stay."""
    seen = set() if seen is None else seen

    def sub(m):
        path = directory / m.group(1)
        if not path.exists():
            return m.group(0)
        if m.group(1) in seen:
            return ""
        seen.add(m.group(1))
        body = path.read_text().replace("#pragma once\n", "")
        return inline_includes(body, directory, seen)

    return _INCLUDE.sub(sub, text)


def is_strip_design(text: str) -> bool:
    return STRIP_KERNEL in text


def strip_stamped(text: str, kernel_name: str = STRIP_KERNEL) -> str:
    """The strip design (its headers inlined) with a stamp after each of the
    strip body's sections; the n x n section ends at the strips' named
    barrier, after which the stamped copy adds a block barrier.  The kernel
    ``kernel_name`` (whose call of the body ends in a line ``store);``)
    opens the counts and flushes them once a CTA."""
    f = text.split("\n")
    body = _find(f, "__device__ __forceinline__ void attend_window_strips(")
    kernel = _find(f, f"    {kernel_name}(")
    after = {
        _find(f, "  __syncthreads();", _find(f, "copy_rows_async(xs, plan.ldx",
                                             body)): "STAMP(0);",
        _find(f, "    __syncthreads();",
              _find(f, "cp_async_wait<0>();  // Wout_h has landed", body)):
            "STAMP(1);",
        _find(f, "strip_barrier(1 + strip);", body):
            "      __syncthreads(); STAMP(2);",
        _find(f, "    __syncthreads();", _find(f, "strip_barrier(1 + strip);",
                                             body)): "STAMP(3);",
        # the body's last line (its epilogue, the store), before its brace
        f.index("}", body) - 1: "  __syncthreads(); STAMP(4);",
        _find(f, "extern __shared__", kernel):
            "  long long sec_acc[8] = {0}; long long sec_last = clock64();",
        # the kernel's last line, before its brace
        f.index("}", kernel) - 1:
            "  if (threadIdx.x == 0) for (int k = 0; k < 8; ++k) "
            "atomicAdd(&g_sections[k], (unsigned long long)sec_acc[k]);",
    }
    return _replace(_insert(f, after), [
        ("    Epilogue epilogue) {",
         "    Epilogue epilogue, long long* sec_acc, long long& sec_last) {"),
        ("        store);", "        store, sec_acc, sec_last);")])


def variants(path: Path) -> Dict[str, str]:
    """{variant: source} of the design at ``path``: ``plain``, and
    ``stamp`` for a strip design."""
    text = inline_includes(path.read_text(), path.parent)
    if "vgm_outproj_attention_occupancy" not in text:
        text += _FIRST_OCCUPANCY
    out = {"plain": _PRE + text + _POST}
    if is_strip_design(text):
        out["stamp"] = _PRE + strip_stamped(text) + _POST
    return out


class Design:
    """One built design, called through its own plain-C entry."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.lib.vgm_outproj_attention.argtypes = ([ptr] * 5 + [i32] * 13
                                                   + [ptr])
        self.lib.vgm_outproj_attention_smem_bytes.argtypes = [i32] * 6
        self.lib.vgm_outproj_attention_smem_bytes.restype = ctypes.c_long
        self.lib.vgm_outproj_attention_occupancy.argtypes = ([i32] * 9
                                                             + [ptr])
        self.has_route = hasattr(self.lib, "vgm_outproj_attention_route")
        if self.has_route:
            self.lib.vgm_outproj_attention_route.argtypes = [i32] * 5

    def route(self, n, dim, dh, out_dim) -> int:
        return (self.lib.vgm_outproj_attention_route(n, dim, dh, out_dim, 1)
                if self.has_route else 0)

    def plan(self, case: str, dim, dh, out_dim, heads):
        """(route, group, cat_heads) of the case's launch."""
        n, _, two_pass, perhead, _, _, _ = CASES[case]
        route = self.route(n, dim, dh, out_dim)
        if route == 1:
            return route, 0, 0
        picked = av._pick_outproj(self.lib.vgm_outproj_attention_smem_bytes,
                                  dim, dh, out_dim, heads, 1, two_pass,
                                  perhead)
        if picked is None:
            raise ValueError(f"{case}: no plan fits")
        return (route, *picked)

    def occupancy(self, case: str, dim, dh, out_dim, heads) -> List[int]:
        """[route, registers, local bytes, shared memory, CTAs an SM]."""
        n, _, _, _, score, agg, _ = CASES[case]
        route, group, cat = self.plan(case, dim, dh, out_dim, heads)
        out = (ctypes.c_int * 4)()
        if self.lib.vgm_outproj_attention_occupancy(
                n, dim, dh, out_dim, group, cat, int(score), int(agg), 1,
                out) < 0:
            raise RuntimeError(f"{case}: occupancy query failed")
        return [route] + list(out)

    def call(self, case: str, x, w_heads, bias, wout2) -> Callable:
        n, _, _, _, score, agg, wpc = CASES[case]
        bw, _, dim = x.shape
        heads = bias.shape[0]
        dh = w_heads.shape[-1] // 3
        out_dim = wout2.shape[1]
        _, group, cat = self.plan(case, dim, dh, out_dim, heads)
        out = torch.empty(bw, n, out_dim, dtype=torch.bfloat16,
                          device=x.device)
        args = ([x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(),
                 wout2.data_ptr(), out.data_ptr(), bw, n, dim, heads, dh,
                 out_dim, group, cat, int(score), int(agg), wpc, 1, 1,
                 torch.cuda.current_stream(x.device).cuda_stream])

        def run():
            library.check(self.lib.vgm_outproj_attention(*args),
                          "outproj_attention design")
            return out
        return run

    def sections(self, run: Callable) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call of ``run``
        (a call of this design)."""
        self.lib.sections_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


def case_inputs(case: str, bw: int, dev: torch.device):
    """(x, wqkv, bias, wout, per-head weights, wout as (heads dh, out))."""
    x, wqkv, bias, wout = ws.inputs(bw, torch.bfloat16, dev, SEED,
                                    n=CASES[case][0])
    heads = bias.shape[0]
    w_heads = av._per_head(wqkv, heads)
    return x, wqkv, bias, wout, w_heads, wout.reshape(-1, wout.shape[-1])


def occupancy_line(name: str, case: str, occ: List[int], bw: int,
                   sms: int) -> str:
    route, regs, local, smem, per_sm = occ
    slots = sms * per_sm
    ctas = ", ".join(f"{w} windows {-(-bw // w)}" for w in WINDOWS_PER_CTA)
    return (f"{name} {case}: route {route} ({'strip' if route else 'first'}"
            f" design), {regs} registers, {local} B local a thread, "
            f"{smem} B shared a CTA, {per_sm} CTAs an SM ({slots} slots); "
            f"CTAs a launch at Bw {bw}: {ctas}")


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="an earlier design's outproj_attention.cu, with "
                         "the headers it includes beside it; its builds are "
                         "named after its directory (may be given more than "
                         "once)")
    ap.add_argument("--bw", type=int, action="append", default=[],
                    help=f"windows a call (default {BWS})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("outproj_sections runs on a CUDA device")
    dev = torch.device("cuda:0")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    card = card_line()
    print(f"card: {card}", flush=True)
    paths = {"current": SOURCE}
    paths.update({p.parent.name: p for p in args.parent})
    srcs: Dict[str, str] = {}
    for tag, path in paths.items():
        srcs.update({f"{tag}_{k}": v for k, v in variants(path).items()})
    libs = build(srcs, BUILD)
    designs = {name: Design(path) for name, path in libs.items()}
    timed = [f"{tag}_plain" for tag in paths]
    report: Dict[str, object] = {"card": card}
    for bw in args.bw or BWS:
        for case, (n, r9, two_pass, perhead, score, agg, wpc) in \
                CASES.items():
            x, wqkv, bias, wout, w_heads, wout2 = case_inputs(case, bw, dev)
            heads, dh = bias.shape[0], w_heads.shape[-1] // 3
            label = f"Bw={bw} {case}"
            for name in timed:
                print(occupancy_line(name, label, designs[name].occupancy(
                    case, x.shape[-1], dh, wout2.shape[1], heads), bw, sms),
                    flush=True)
            with torch.inference_mode():
                ref = plain.outproj_attention(x, wqkv, bias, wout, heads, dh,
                                              bf16_score=score, bf16_agg=agg)
                w = weight4(wqkv, heads) if r9 else wqkv
                package = av.outproj_attention(
                    x, w, bias, wout, two_pass=two_pass, perhead_wout=perhead,
                    bf16_score=score, bf16_agg=agg, windows_per_cta=wpc)
                runs = {name: designs[name].call(case, x, w_heads, bias,
                                                 wout2) for name in timed}
                scale = ref.float().abs().max().item()
                for name, run in runs.items():
                    out = run()
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    d = (out.float() - package.float()).abs().max().item()
                    verdict = "within" if err <= TOLERANCE * scale else \
                        "OUTSIDE"
                    print(f"{label}: {name} max|d| / max|plain| = "
                          f"{err / scale:.3e} ({verdict} {TOLERANCE:g}); "
                          f"against the package kernel {d / scale:.3e}"
                          f"{'; bit-identical' if d == 0 else ''}",
                          flush=True)
                ms: Dict[str, List[float]] = {}
                for name in list(runs) + list(runs)[::-1]:
                    ms.setdefault(name, []).append(cuda_ms(runs[name],
                                                           iters=5))
                    print(f"{label}: {name}: {ms[name][-1]:.3f} ms",
                          flush=True)
                out_case: Dict[str, object] = {"ms": ms}
                for tag in paths:
                    stamp = designs.get(f"{tag}_stamp")
                    if stamp is None or case not in STAMPED:
                        continue
                    cyc = stamp.sections(stamp.call(case, x, w_heads, bias,
                                                    wout2))[:len(SECTIONS)]
                    shares = {s: c / cyc.sum() for s, c in zip(SECTIONS, cyc)}
                    print(f"{label}: {tag} sections: " + " ".join(
                        f"{s}={100 * v:.1f}%" for s, v in shares.items()),
                        flush=True)
                    out_case[f"{tag} sections"] = shares
            report[label] = out_case
            del x, wqkv, bias, wout, w_heads, wout2, ref, package, runs
            torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
