"""R4's and R3's kernels on the per-head kernel's wgmma body, on the card:
ptxas's registers and spills, occupancy, times in turns against their
parents and R1's wgmma kernel, the heads-a-group by layout sweep, and the
time split by clock64 stamps.

    python -m vit_grid_model_tpu_torch.repros.grouped_sections \
        [--parent DIR ...] [--bw BW ...]

It writes self-contained copies of ``csrc/headmajor_attention.cu`` (R4) and
``csrc/crosshead_norm_attention.cu`` (R3), and of the same two files in
each DIR (an earlier design's, with the headers they include beside them,
e.g. ``git archive <commit> vit_grid_model_tpu_torch/csrc | tar -x
--strip-components=2 -C build/parent19``), into ``build/grouped_sections/``
(never into ``csrc/``): every header a source includes from its own
directory is inlined (``outproj_sections.inline_includes``).  Each is
built with ``nvcc -Xptxas -v`` and run at the repros' geometry in bf16 (56
tokens, dim 128, 32 heads x 32) at each Bw (default 2,880 and 9,000),
inputs from a numpy seed (``repros/baseline_perhead.inputs``).  The
package's sources are built in each layout of ``LAYOUTS`` (consumer
warpgroups and head buffers a CTA, the constants ``kGroupWarpgroups`` and
``kGroupBuffers`` replaced; "a" is the package's), a ``nocopy`` build
that streams no x after each warpgroup's first window (the same work but
the copies; its output is wrong and not checked), a ``stamp`` build, and
R3's ``hionly`` control, whose indicator product takes the squares' bf16
high parts only (the squares rounded once to bf16).
It prints:

* for each build, what ptxas reports for each of its kernels: registers,
  spill stores and spill loads;
* for each layout and heads a group an occupancy line: the design the
  launch takes (from the source's own route export), the kernel's
  registers and local bytes a thread, its shared memory a CTA and its CTAs
  an SM;
* its ms a call, every version in turns (first, second, ..., then
  reversed): each kernel in each layout at 1 and 2 heads a staged x, its
  ``nocopy`` build at 2, each DIR's build of the kernel (its first design,
  at its wrapper's group: 1 head in bf16), and R1's wgmma kernel through
  the package's ``perhead_attention`` at 8 windows a CTA.  Every R4 build's
  output must be bit-identical to R1's kernel's, every other's within the
  bf16 tolerance of the plain version.  Each R3 build is held to R1's
  kernel by ``against_r1`` (only the norm's sums differ between the two):
  within ``R3_GAP`` of max|plain| and at most ``R3_DIFFER_SHARE`` of the
  elements different, with the largest gap in bf16 steps at the element's
  own binade printed; the ``hionly`` control must exceed that share, or
  the bound could not tell the hi/lo split from squares rounded to bf16;
* each kernel's split at 1 and 2 heads a group from the ``stamp`` build, in
  which thread 0 of each CTA (warpgroup 0) reads ``clock64()`` at the end
  of each section of a step (lines marked ``// section: <name>`` in
  ``csrc/perhead_wgmma_body.cuh``): the copy wait (x, the head's weights
  and bias, the warpgroup's barrier), the qkv product, R3's indicator norm
  (0 for R4, whose shuffle norm falls in the epilogue), the epilogue (the
  norms, q's fragments, k and v to shared memory, up to the warpgroup's
  barrier), the scores, the softmax, P.v and the store.

Operands a design takes in its own layout (the weight tiles and bias rows)
are made outside the timing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import sys
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros.bwd_sections import _find, _insert, build
from vit_grid_model_tpu_torch.repros.common import card_line
from vit_grid_model_tpu_torch.repros.headpack_stacked_sections import (
    TOLERANCE, in_turns, ptxas_kernels)
from vit_grid_model_tpu_torch.repros.outproj_sections import (
    _POST, _PRE, inline_includes)
from vit_grid_model_tpu_torch.repros.perhead_sections import (
    NEXT_COPIES, _kernel_places)

BUILD = library.LIBRARY.parent.parent / "grouped_sections"
# kernel: (source, library entry)
KERNELS = {"R4": ("headmajor_attention.cu", "vgm_headmajor_attention"),
           "R3": ("crosshead_norm_attention.cu",
                  "vgm_crosshead_norm_attention")}
BODY_KERNEL = "perhead_attention_wgmma"
SEED = 0
BWS = [2880, 9000]
GROUPS = (1, 2)
SECTIONS = ["copy wait", "qkv", "indicator norm", "epilogue", "scores",
            "softmax", "P.v", "store"]
# layout: (consumer warpgroups, head buffers) a CTA; "a" is the package's
LAYOUTS = {"a": (3, 3), "b": (2, 4), "wg3buf2": (3, 2)}
WARPGROUPS = "constexpr int kGroupWarpgroups = {};"
BUFFERS = "constexpr int kGroupBuffers = {};"
# R3's distance from R1's wgmma kernel, whose output differs from R3's only
# by the norm's sums (f32 squares by quad shuffles against the hi/lo split
# squares through the indicator): at most R3_GAP of max|plain| anywhere, and
# at most R3_DIFFER_SHARE of the elements different.  A sum off by a part in
# ~2^18 flips an element's rounding to bf16 now and then: 1.1e-3 of the
# elements in the plan's CPU model at n 56, 3 heads x 16
# (tests/test_torch_port_grouped_split.py), where squares rounded once to
# bf16 flip 6.2% of them.  The share bound lies between the two
R3_GAP = 2.5e-3
R3_DIFFER_SHARE = 5e-3
# R3's indicator product: the low parts' k16 step, then the high parts'; the
# hionly control keeps the high parts' step alone (its scale-d the step's)
INDICATOR_STEPS = ("            wg::Mma<8>::rs(nrm, al[j2], d, j2);\n"
                   "            wg::Mma<8>::rs(nrm, ah[j2], d, 1);\n")
HI_ONLY_STEP = "            wg::Mma<8>::rs(nrm, ah[j2], d, j2);\n"
_WARPGROUPS = re.compile(r"constexpr int kGroupWarpgroups = (\d+);")
_BUFFERS = re.compile(r"constexpr int kGroupBuffers = (\d+);")


def against_r1(out: torch.Tensor, r1_out: torch.Tensor,
               scale: float) -> Tuple[float, float, float]:
    """(max|out - r1_out| / ``scale``, the share of elements that differ,
    the largest difference in bf16 steps at the element's own binade, that
    of the larger of the two values)."""
    a, b = out.float(), r1_out.float()
    d = (a - b).abs()
    _, e = torch.frexp(torch.maximum(a.abs(), b.abs()))
    step = torch.pow(2.0, (e - 8).float())   # 2^(binade - 7)
    return ((d.max() / scale).item(), (d > 0).float().mean().item(),
            (d / step).max().item())


def body_places(f: List[str]) -> Dict[int, str]:
    """The body's stamps: after each section of a warpgroup's step."""
    kernel = _find(f, f"    {BODY_KERNEL}(")
    places = _kernel_places(f, BODY_KERNEL)
    for k, name in enumerate(SECTIONS):
        line = _find(f, f"// section: {name}", kernel)
        places[line] = (f"{' ' * (len(f[line]) - len(f[line].lstrip()))}"
                        f"STAMP({k});")
    return places


def layout_of(text: str) -> tuple:
    """(warpgroups, head buffers) the source's constants give."""
    w, b = _WARPGROUPS.search(text), _BUFFERS.search(text)
    if w is None or b is None:
        raise ValueError("the source has changed: no "
                         f"{WARPGROUPS.format('N')} or {BUFFERS.format('N')}")
    return int(w.group(1)), int(b.group(1))


def with_layout(text: str, warpgroups: int, buffers: int) -> str:
    text = _WARPGROUPS.sub(WARPGROUPS.format(warpgroups), text)
    return _BUFFERS.sub(BUFFERS.format(buffers), text)


def variants(path: Path) -> Dict[str, str]:
    """{variant: source} of the package's R4 or R3 source at ``path``: one a
    layout of ``LAYOUTS``, ``nocopy`` and ``stamp`` (both in the package's
    layout), and R3's ``hionly`` control (the body's indicator norm)."""
    text = inline_includes(path.read_text(), path.parent)
    if layout_of(text) != LAYOUTS["a"]:
        raise ValueError(f"{path.name}: its layout is not LAYOUTS['a']")
    out = {name: _PRE + with_layout(text, *wb) + _POST
           for name, wb in LAYOUTS.items()}
    copy = [c for c in NEXT_COPIES if c in text]
    if not copy:
        raise ValueError(f"{path.name} has changed: no next-window copy")
    out["nocopy"] = out["a"].replace(copy[0], "")
    if path.name == KERNELS["R3"][0]:
        if INDICATOR_STEPS not in text:
            raise ValueError(f"{path.name} has changed: no indicator steps")
        out["hionly"] = out["a"].replace(INDICATOR_STEPS, HI_ONLY_STEP)
    out["stamp"] = _PRE + _insert(text.split("\n"),
                                  body_places(text.split("\n"))) + _POST
    return out


class Grouped:
    """One build of R4's or R3's kernel, its wgmma design called through its
    own plain-C entries."""

    def __init__(self, path: Path, entry: str):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.entry = getattr(self.lib, entry + "_wgmma")
        self.entry.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        self.occ = getattr(self.lib, entry + "_occupancy")
        self.occ.argtypes = [i32] * 5 + [ptr]

    def occupancy(self, n, dim, dh, group) -> List[int]:
        """[route, registers, local bytes, shared memory, CTAs an SM]."""
        out = (ctypes.c_int * 4)()
        route = self.occ(n, dim, dh, group, 1, out)
        if route < 0:
            raise RuntimeError("occupancy query failed")
        return [route] + list(out)

    def call(self, x, w_heads, bias, group: int) -> Callable:
        bw, n, dim = x.shape
        heads, dh = bias.shape[0], w_heads.shape[-1] // 3
        out = torch.empty(bw, n, heads * dh, dtype=torch.bfloat16,
                          device=x.device)
        w_tiles, bias_rows = av._wgmma_operands(w_heads, bias)
        args = [x.data_ptr(), w_tiles.data_ptr(), bias_rows.data_ptr(),
                out.data_ptr(), bw, n, dim, heads, dh, group,
                av.WINDOWS_PER_CTA,
                torch.cuda.current_stream(x.device).cuda_stream]

        def run():
            library.check(self.entry(*args), "grouped wgmma design")
            return out
        run.operands = (w_tiles, bias_rows)   # alive while run is
        return run

    def sections(self, run: Callable) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call of ``run``."""
        self.lib.sections_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


def parent_call(path: Path, entry: str, x, w_heads, bias) -> Callable:
    """A call of an earlier R4 or R3 kernel (``entry``, the first design's
    interface) in the library at ``path`` with its wrapper's group (up to 2
    heads of which two CTAs share an SM) and 8 windows a CTA."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = getattr(lib, entry)
    fn.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
    smem = getattr(lib, entry + "_smem_bytes")
    smem.argtypes = [i32] * 4
    smem.restype = ctypes.c_long
    bw, n, dim = x.shape
    heads, dh = bias.shape[0], w_heads.shape[-1] // 3
    group = av._pick_group(smem, dim, dh, heads, 1, 2, 2)
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(),
            out.data_ptr(), bw, n, dim, heads, dh, group, av.WINDOWS_PER_CTA,
            1, torch.cuda.current_stream(x.device).cuda_stream]

    def run():
        library.check(fn(*args), entry)
        return out
    run.lib = lib
    return run


def occupancy_line(name: str, label: str, occ: List[int]) -> str:
    route, regs, local, smem, per_sm = occ
    return (f"{name} {label}: route {route} ({'wgmma' if route else 'first'}"
            f" design), {regs} registers, {local} B local a thread, "
            f"{smem} B shared a CTA, {per_sm} CTAs an SM")


def shares(cycles: np.ndarray) -> Dict[str, float]:
    cyc = cycles[:len(SECTIONS)]
    return {s: c / cyc.sum() for s, c in zip(SECTIONS, cyc)}


def check_outputs(label: str, runs: Dict[str, Callable], ref, r1_out,
                  identical, near_r1=(), controls=()) -> None:
    """Every build within the bf16 tolerance of the plain version, those
    named in ``identical`` bit-identical to R1's wgmma kernel, those in
    ``near_r1`` within ``against_r1``'s bounds of it (``R3_GAP``,
    ``R3_DIFFER_SHARE``) and those in ``controls`` beyond its share;
    raises otherwise."""
    scale = ref.float().abs().max().item()
    for name, run in runs.items():
        out = run()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        gap, share, steps = against_r1(out, r1_out, scale)
        print(f"{label}: {name} max|d| / max|plain| = {err / scale:.3e}; "
              f"against R1's wgmma kernel {gap:.3e} of max|plain|, "
              f"{share:.3e} of the elements differ, the largest by "
              f"{steps:.1f} bf16 steps at its binade"
              f"{' (bit-identical)' if gap == 0 else ''}", flush=True)
        if err > TOLERANCE * scale:
            raise AssertionError(f"{label} {name}: outside the tolerance")
        if name in identical and gap != 0:
            raise AssertionError(f"{label} {name}: not bit-identical to R1's "
                                 "wgmma kernel")
        if name in near_r1 and not (gap <= R3_GAP
                                    and share <= R3_DIFFER_SHARE):
            raise AssertionError(f"{label} {name}: further from R1's wgmma "
                                 "kernel than the norm's sums allow")
        if name in controls and share <= R3_DIFFER_SHARE:
            raise AssertionError(f"{label} {name}: the control is within "
                                 "R3_DIFFER_SHARE, so the bound cannot tell "
                                 "the hi/lo split from bf16 squares")


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="a directory with earlier designs' "
                         f"{' and '.join(s for s, _ in KERNELS.values())} "
                         "and the headers they include; its builds are named "
                         "after it (may be given more than once)")
    ap.add_argument("--bw", type=int, action="append", default=[],
                    help=f"windows a call (default {BWS})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("grouped_sections runs on a CUDA device")
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    srcs: Dict[str, str] = {}
    for kernel, (source, _) in KERNELS.items():
        srcs.update({f"{kernel}_{k}": v for k, v in
                     variants(library.CSRC / source).items()})
        for p in args.parent:
            srcs[f"{kernel}_{p.name}"] = inline_includes(
                (p / source).read_text(), p)
    logs: Dict[str, str] = {}
    libs = build(srcs, BUILD, ("-Xptxas", "-v"), logs)
    report: Dict[str, object] = {"card": card, "ptxas": {}}
    for name, log in logs.items():
        for kern, (regs, stores, loads) in ptxas_kernels(log).items():
            if not any(k in kern for k in (BODY_KERNEL, "headmajor",
                                           "crosshead")):
                continue
            print(f"ptxas {name}: {kern}: {regs} registers, {stores} B "
                  f"spill stores, {loads} B spill loads", flush=True)
            report["ptxas"][f"{name}: {kern}"] = [regs, stores, loads]
    heads, dh, dim = r1.HEADS, r1.DIM_HEAD, r1.DIM
    for bw in args.bw or BWS:
        x, wqkv, bias = r1.inputs(bw, torch.bfloat16, dev, SEED)
        n = x.shape[1]
        w_heads = av._per_head(wqkv, heads)
        label = f"Bw={bw}"
        case: Dict[str, object] = {}
        with torch.inference_mode():
            ref = plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)
            r1_out = av.perhead_attention(x, wqkv, bias, 8).clone()
            runs: Dict[str, Callable] = {}
            builds = {}
            for kernel, (_, entry) in KERNELS.items():
                for variant in list(LAYOUTS) + ["nocopy", "stamp"]:
                    builds[kernel, variant] = Grouped(
                        libs[f"{kernel}_{variant}"], entry)
                for layout in LAYOUTS:
                    for g in GROUPS:
                        b = builds[kernel, layout]
                        print(occupancy_line(f"{kernel} {layout} G{g}",
                                             label,
                                             b.occupancy(n, dim, dh, g)),
                              flush=True)
                        runs[f"{kernel} {layout} G{g}"] = b.call(
                            x, w_heads, bias, g)
                for p in args.parent:
                    runs[f"{kernel} {p.name}"] = parent_call(
                        libs[f"{kernel}_{p.name}"], entry, x, w_heads, bias)
            control = {"R3 hionly G2": Grouped(libs["R3_hionly"],
                                               KERNELS["R3"][1]).call(
                x, w_heads, bias, 2)}
            check_outputs(label, {**runs, **control}, ref, r1_out,
                          {f"R4 {layout} G{g}" for layout in LAYOUTS
                           for g in GROUPS},
                          {f"R3 {layout} G{g}" for layout in LAYOUTS
                           for g in GROUPS}, control)
            del control
            for kernel in KERNELS:
                runs[f"{kernel} nocopy G2"] = builds[kernel, "nocopy"].call(
                    x, w_heads, bias, 2)
            runs["R1 wgmma w8"] = (
                lambda: av.perhead_attention(x, wqkv, bias, 8))
            case["ms"] = in_turns(label, runs)
            for kernel in KERNELS:
                stamp = builds[kernel, "stamp"]
                for g in GROUPS:
                    share = shares(stamp.sections(stamp.call(x, w_heads, bias,
                                                             g)))
                    print(f"{label}: {kernel} G{g} sections: " + " ".join(
                        f"{s}={100 * v:.1f}%" for s, v in share.items()),
                        flush=True)
                    case[f"{kernel} G{g} sections"] = share
            report[label] = case
            del runs, builds, x, wqkv, bias, w_heads, ref, r1_out
            torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
