"""The per-head attention kernel's designs (R1, R14, R9) on the card:
ptxas's registers and spills, occupancy, times in turns beside R10's strip
kernel, agreement, and each design's time split by clock64 stamps.

    python -m vit_grid_model_tpu_torch.repros.perhead_sections \
        [--parent DIR ...] [--bw BW ...]

It writes self-contained copies of ``csrc/perhead_attention.cu`` and of the
same file in each DIR (an earlier design's, with the headers it includes
beside it, e.g. ``git archive <commit> vit_grid_model_tpu_torch/csrc | tar
-x --strip-components=2 -C build/parent18``) into
``build/perhead_sections/`` (never into ``csrc/``): every header a source
includes from its own directory is inlined
(``outproj_sections.inline_includes``), so each design builds with its own
headers.  A design's builds are named after DIR's last part ("current"
for the package's).  Each is built with ``nvcc -Xptxas -v`` and run at the
repros' geometry in bf16 (56 tokens, dim 128, 32 heads x 32) at each Bw
(default 2,880 and 9,000), inputs from a numpy seed
(``repros/baseline_perhead.inputs``).  It prints:

* for each build, what ptxas reports for each of its kernels: registers,
  spill stores and spill loads;
* for each design and windows a CTA an occupancy line: the design the
  launch takes (0 the first, 1 the wgmma design, from the source's own
  ``vgm_perhead_attention_route``; a source without one has only the
  first), the kernel's registers and local bytes a thread, its shared
  memory a CTA and its CTAs an SM
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
* its ms a call, every version in turns (first, second, ..., then
  reversed), whether its output is within the bf16 tolerance of the plain
  version, and its distance from the package kernel's output.  The
  versions are each design at 8 windows a CTA (R1, and R9, whose call is
  the same launch from R9's weight) and at 16 (R14), and, as the
  yardstick of the same function, R10's kernel through the package's
  ``stacked_softmax_attention``;
* for a wgmma design the same source at 2, 3 and 4 consumer warpgroups a
  CTA (``wgN`` builds, timed in the same turns), and a ``nocopy`` build
  that streams no x after each warpgroup's first window (the same work
  but the copies; its output is wrong and not checked): what streaming x
  costs;
* each design's split at 8 and 16 windows a CTA from a ``stamp`` copy, in
  which thread 0 of each CTA reads ``clock64()`` at the end of each
  section and adds the cycles to the section's count.  The first design's
  sections end at its block barriers: the copy waits (x and the head's
  weights), the qkv product, the norms, the scores, the softmax, and P.v
  with its store (``pv_tile`` stores each output as it sums it).  The
  wgmma design's are those of warpgroup 0 (thread 0's): the copy waits
  (x, and the head's weights and bias with the head barrier), the qkv
  product, its epilogue (norms, q's fragments, k and v to shared memory,
  up to the warpgroup's barrier), the scores, the softmax, P.v and the
  store.

The wgmma design's body (``csrc/perhead_wgmma_body.cuh``) also runs R4's
and R3's kernels (``repros/grouped_sections.py``).  With ``--parent``, the
package's wgmma design (R1's and R9's launch at 8 windows a CTA, R14's at
16) must be bit-identical to each DIR's wgmma design, where DIR has one.

Operands a design takes in its own layout (the wgmma design's weight tiles
and bias rows) are made outside the timing, as the per-head weight slices
are.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros.bwd_sections import _find, _insert, build
from vit_grid_model_tpu_torch.repros.common import card_line
from vit_grid_model_tpu_torch.repros.headpack_stacked_sections import (
    agreement, in_turns, ptxas_kernels)
from vit_grid_model_tpu_torch.repros.outproj_sections import (
    _OCCUPANCY_OF, _POST, _PRE, inline_includes)

BUILD = library.LIBRARY.parent.parent / "perhead_sections"
SOURCE = "perhead_attention.cu"
FIRST_KERNEL = "perhead_attention_kernel"
WGMMA_KERNEL = "perhead_attention_wgmma"
SEED = 0
BWS = [2880, 9000]
WINDOWS_PER_CTA = r1.WINDOWS_PER_CTA          # (8, 16): R1 (and R9), R14
FIRST_SECTIONS = ["copy wait", "qkv", "norms", "scores", "softmax",
                  "P.v + store"]
WGMMA_SECTIONS = ["copy wait", "qkv", "epilogue", "scores", "softmax",
                  "P.v", "store"]
# the wgmma design's counts sit after the first design's
WGMMA_BASE = 8
# the wgmma design's consumer warpgroups a CTA, built at each
WARPGROUPS = "constexpr int kWarpgroups = {};"
WARPGROUP_COUNTS = (2, 3, 4)
_WARPGROUPS = re.compile(r"constexpr int kWarpgroups = (\d+);")
# the wgmma design's copy of the next window's x, which ``nocopy`` drops:
# the body's since it serves a group of heads, and the first wgmma
# design's
NEXT_COPY = """        if (gh + 1 == gn && s + 1 < steps)
          copy_x(j + 1 < count ? w + kWgs : w0 + wgi);
"""
NEXT_COPIES = (NEXT_COPY, """      if (s + 1 < steps)
        copy_x(j + 1 < count ? w + kWarpgroups : w0 + wgi);
""")

# the occupancy export of a source whose first design is all it has (the
# package's own has the same interface and reports the route it takes)
_FIRST_OCCUPANCY = _OCCUPANCY_OF + r'''
extern "C" int vgm_perhead_attention_occupancy(int n, int dim, int dh,
                                               int is_bf16, int* out) {
  (void)n;
  if (is_bf16)
    return sections_occupancy_of(
        perhead_attention_kernel<__nv_bfloat16, true>,
        make_perhead_plan<__nv_bfloat16>(dim, dh).bytes, out);
  return sections_occupancy_of(perhead_attention_kernel<float, false>,
                               make_perhead_plan<float>(dim, dh).bytes, out);
}
'''

_OPEN = "  long long sec_acc[16] = {0}; long long sec_last = clock64();"
_FLUSH = ("  if (threadIdx.x == 0) for (int k = 0; k < 16; ++k) "
          "atomicAdd(&g_sections[k], (unsigned long long)sec_acc[k]);")


def _kernel_places(f: List[str], name: str) -> Dict[int, str]:
    """The counts opened after the kernel ``name``'s shared-memory
    declaration and flushed on its last line."""
    kernel = _find(f, f"    {name}(")
    return {_find(f, "extern __shared__", kernel): _OPEN,
            f.index("}", kernel) - 1: _FLUSH}


def first_places(f: List[str]) -> Dict[int, str]:
    """The first design's stamps: after each block barrier of its loop."""
    kernel = _find(f, f"    {FIRST_KERNEL}(")
    return {
        **_kernel_places(f, FIRST_KERNEL),
        _find(f, "__syncthreads();  // x and the weights are in", kernel):
            "    STAMP(0);",
        _find(f, "gemm_smem_f32(xw, ldx, ws, ldw, qkv, ldq, dim, 3 * dh);",
              kernel): "    STAMP(1);",
        _find(f, "l2_normalize_qk(qkv, ldq, n, dh);", kernel):
            "    STAMP(2);",
        _find(f, "scores_tile(qkv, ldq, dh, bias", kernel): "    STAMP(3);",
        _find(f, "softmax_rows(s, 1, n);", kernel): "    STAMP(4);",
        _find(f, "out + static_cast<size_t>(w) * n * inner + h * dh, inner);",
              kernel): "    __syncthreads(); STAMP(5);",
    }


def wgmma_places(f: List[str]) -> Dict[int, str]:
    """The wgmma design's stamps: after each section of a warpgroup's step
    (lines marked ``// section: <name>`` in the source)."""
    kernel = _find(f, f"    {WGMMA_KERNEL}(")
    places = _kernel_places(f, WGMMA_KERNEL)
    for k, name in enumerate(WGMMA_SECTIONS):
        line = _find(f, f"// section: {name}", kernel)
        places[line] = f"{' ' * (len(f[line]) - len(f[line].lstrip()))}" \
                       f"STAMP({WGMMA_BASE + k});"
    return places


def is_wgmma_design(text: str) -> bool:
    return WGMMA_KERNEL in text


def variants(directory: Path) -> Dict[str, str]:
    """{variant: source} of the design in ``directory``: ``plain`` and
    ``stamp`` (every kernel of the file stamped); for a wgmma design also
    ``wgN``, the same source at the other consumer warpgroups a CTA of
    ``WARPGROUP_COUNTS``."""
    path = directory / SOURCE
    text = inline_includes(path.read_text(), path.parent)
    if "vgm_perhead_attention_occupancy" not in text:
        text += _FIRST_OCCUPANCY
    f = text.split("\n")
    places = first_places(f)
    out = {"plain": _PRE + text + _POST}
    if is_wgmma_design(text):
        places.update(wgmma_places(f))
        m = _WARPGROUPS.search(text)
        if m is None:
            raise ValueError(f"{SOURCE} has changed: no "
                             f"{WARPGROUPS.format('N')}")
        for k in WARPGROUP_COUNTS:
            if k != int(m.group(1)):
                out[f"wg{k}"] = out["plain"].replace(m.group(0),
                                                     WARPGROUPS.format(k))
        copy = [c for c in NEXT_COPIES if c in text]
        if not copy:
            raise ValueError(f"{SOURCE} has changed: no next-window copy")
        out["nocopy"] = out["plain"].replace(copy[0], "")
    out["stamp"] = _PRE + _insert(f, places) + _POST
    return out


class Design:
    """One built design, called through its own plain-C entries."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32, lib = ctypes.c_void_p, ctypes.c_int, self.lib
        lib.vgm_perhead_attention.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.vgm_perhead_attention_occupancy.argtypes = [i32] * 4 + [ptr]
        self.has_route = hasattr(lib, "vgm_perhead_attention_route")
        if self.has_route:
            lib.vgm_perhead_attention_route.argtypes = [i32] * 4
            lib.vgm_perhead_attention_wgmma.argtypes = ([ptr] * 4
                                                        + [i32] * 6 + [ptr])

    def route(self, n, dim, dh) -> int:
        return (self.lib.vgm_perhead_attention_route(n, dim, dh, 1)
                if self.has_route else 0)

    def occupancy(self, n, dim, dh) -> List[int]:
        """[route, registers, local bytes, shared memory, CTAs an SM]."""
        out = (ctypes.c_int * 4)()
        route = self.lib.vgm_perhead_attention_occupancy(n, dim, dh, 1, out)
        if route < 0:
            raise RuntimeError("occupancy query failed")
        return [route] + list(out)

    def call(self, x, w_heads, bias, wpc: int) -> Callable:
        bw, n, dim = x.shape
        heads, dh = bias.shape[0], w_heads.shape[-1] // 3
        out = torch.empty(bw, n, heads * dh, dtype=torch.bfloat16,
                          device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if self.route(n, dim, dh) == 1:
            w_tiles, bias_rows = av._wgmma_operands(w_heads, bias)
            args = [x.data_ptr(), w_tiles.data_ptr(), bias_rows.data_ptr(),
                    out.data_ptr(), bw, n, dim, heads, dh, wpc, stream]
            entry = self.lib.vgm_perhead_attention_wgmma
        else:
            w_tiles = bias_rows = None
            args = [x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(),
                    out.data_ptr(), bw, n, dim, heads, dh, wpc, 1, stream]
            entry = self.lib.vgm_perhead_attention

        def run():
            library.check(entry(*args), "perhead_attention design")
            return out
        run.operands = (w_tiles, bias_rows)   # alive while run is
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


def occupancy_line(name: str, label: str, occ: List[int]) -> str:
    route, regs, local, smem, per_sm = occ
    return (f"{name} {label}: route {route} ({'wgmma' if route else 'first'}"
            f" design), {regs} registers, {local} B local a thread, "
            f"{smem} B shared a CTA, {per_sm} CTAs an SM")


def shares(cycles: np.ndarray, route: int) -> Dict[str, float]:
    names, base = ((WGMMA_SECTIONS, WGMMA_BASE) if route
                   else (FIRST_SECTIONS, 0))
    cyc = cycles[base:base + len(names)]
    return {s: c / cyc.sum() for s, c in zip(names, cyc)}


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help=f"a directory with an earlier design's {SOURCE} "
                         "and the headers it includes; its builds are named "
                         "after it (may be given more than once)")
    ap.add_argument("--bw", type=int, action="append", default=[],
                    help=f"windows a call (default {BWS})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("perhead_sections runs on a CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    dirs = {"current": library.CSRC}
    dirs.update({p.name: p for p in args.parent})
    srcs: Dict[str, str] = {}
    for tag, d in dirs.items():
        srcs.update({f"{tag}_{k}": v for k, v in variants(d).items()})
    logs: Dict[str, str] = {}
    libs = build(srcs, BUILD, ("-Xptxas", "-v"), logs)
    report: Dict[str, object] = {"card": card, "ptxas": {}}
    for name, log in logs.items():
        for kernel, (regs, stores, loads) in ptxas_kernels(log).items():
            if "perhead" not in kernel:
                continue
            print(f"ptxas {name}: {kernel}: {regs} registers, {stores} B "
                  f"spill stores, {loads} B spill loads", flush=True)
            report["ptxas"][f"{name}: {kernel}"] = [regs, stores, loads]
    designs = {name[:-len("_plain")] if name.endswith("_plain") else name:
               Design(path) for name, path in libs.items()
               if not name.endswith("_stamp")}
    stamps = {t: Design(libs[f"{t}_stamp"]) for t in dirs}
    heads, dh, dim = r1.HEADS, r1.DIM_HEAD, r1.DIM
    for bw in args.bw or BWS:
        x, wqkv, bias = r1.inputs(bw, torch.bfloat16, dev, SEED)
        n = x.shape[1]
        w_heads = av._per_head(wqkv, heads)
        label = f"Bw={bw}"
        with torch.inference_mode():
            ref = plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)
            package = av.perhead_attention(x, wqkv, bias, 8)
            for name, d in designs.items():
                print(occupancy_line(name, label, d.occupancy(n, dim, dh)),
                      flush=True)
            runs = {f"{name} w{wpc}": d.call(x, w_heads, bias, wpc)
                    for name, d in designs.items()
                    for wpc in WINDOWS_PER_CTA}
            agreement(label, {k: v for k, v in runs.items()
                              if "nocopy" not in k}, ref, package, {})
            runs["R10 stacked_softmax_attention"] = (
                lambda: av.stacked_softmax_attention(x, wqkv, bias))
            case: Dict[str, object] = {"ms": in_turns(label, runs)}
            for name, d in stamps.items():
                route = d.route(n, dim, dh)
                for wpc in WINDOWS_PER_CTA:
                    share = shares(d.sections(d.call(x, w_heads, bias, wpc)),
                                   route)
                    print(f"{label}: {name} w{wpc} sections: " + " ".join(
                        f"{s}={100 * v:.1f}%" for s, v in share.items()),
                        flush=True)
                    case[f"{name} w{wpc} sections"] = share
            # the wgmma design of each tree, bit-identical at 8 (R1, R9)
            # and 16 (R14) windows a CTA
            for wpc in WINDOWS_PER_CTA:
                outs = {name: runs[f"{name} w{wpc}"]().clone()
                        for name, d in designs.items()
                        if name in dirs and d.route(n, dim, dh) == 1}
                first = next(iter(outs.values()))
                same = all(torch.equal(first, o) for o in outs.values())
                print(f"{label}: wgmma design w{wpc} of {sorted(outs)} "
                      f"{'bit-identical' if same else 'DIFFER'}", flush=True)
                if not same:
                    raise AssertionError(f"w{wpc}: the trees' wgmma designs "
                                         "differ")
                case[f"w{wpc} bit-identical"] = same
                del outs, first
            report[label] = case
            del x, wqkv, bias, w_heads, ref, package
            torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
