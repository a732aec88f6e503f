"""The head-pack kernel's (R5, R6) and the stacked-softmax kernel's (R10)
designs on the card: ptxas's registers and spills, occupancy, times in
turns, agreement, and R10's strip design's time split by clock64 stamps.

    python -m vit_grid_model_tpu_torch.repros.headpack_stacked_sections \
        [--parent DIR ...] [--bw BW ...]

It writes self-contained copies of ``csrc/headpack_attention.cu`` and
``csrc/stacked_softmax_attention.cu``, and of the same two files in each
DIR (an earlier design's, with the headers they include beside them, e.g.
from ``git show <commit>:vit_grid_model_tpu_torch/csrc/<file>`` into
``build/parent_r10/``), into ``build/headpack_stacked_sections/`` (never
into ``csrc/``): every header a source includes from its own directory is
inlined (``outproj_sections.inline_includes``), so each design builds with
its own headers.  A design's builds are named after DIR's last part
("current" for the package's).  Each is built with ``nvcc -Xptxas -v`` and
run at the repros' geometry in bf16 (56 tokens, dim 128, 32 heads x 32,
out 128) at each Bw (default 2,880 and 9,000), inputs from a numpy seed
(``repros/weightsliced_variants.py::inputs``, ``baseline_perhead.inputs``).
It prints:

* for each build, what ptxas reports for each of its kernels: registers,
  spill stores and spill loads;
* for each design and case an occupancy line: the design the launch takes
  (0 the first, 1 the strip design, from the source's own route export; a
  source without one has only the first), the kernel's registers and
  local bytes a thread, its shared memory a CTA and its CTAs an SM
  (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``);
* its ms a call, every design in turns (first, second, ..., then
  reversed), whether its output is within the bf16 tolerance of the plain
  version, and its distance from the package kernel's output; for R5/R6
  also from the out-projection kernel's (``ws_2pass_pwout`` at the same
  windows a CTA), to which the strip route is bit-identical.

The cases are R5's and R6's seven builds (the repros' lists: K = 2, 4, 8;
two passes or one; 8 or 16 windows a CTA) and R10's kernel.  For a strip
design of R10 it also builds the same source at the other CTAs an SM (2
or 3, ``kStripCtasPerSm``: the ``ctas2`` or ``ctas3`` build, timed in the
same turns) and a ``stamp`` copy, in which thread 0 of each CTA reads
``clock64()`` after the block barrier that ends each section of the strip
body (the row fill, the qkv product with its norm, the n x n products up to
the strips' named barrier, made a block barrier in the stamped copy, the
per-head store of o_h up to the head's last barrier, and the tail after the
last head), and prints each section's share.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
from vit_grid_model_tpu_torch.repros.bwd_sections import build
from vit_grid_model_tpu_torch.repros.common import card_line, cuda_ms
from vit_grid_model_tpu_torch.repros.outproj_sections import (
    _OCCUPANCY_OF, _POST, _PRE, inline_includes, strip_stamped)
from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

BUILD = library.LIBRARY.parent.parent / "headpack_stacked_sections"
HEADPACK = "headpack_attention.cu"
STACKED = "stacked_softmax_attention.cu"
STACKED_STRIP_KERNEL = "stacked_softmax_strips"
CTAS = "constexpr int kStripCtasPerSm = {};"
SEED = 0
BWS = [2880, 9000]
TOLERANCE = r1.TOLERANCE[torch.bfloat16]

# R5's and R6's builds, the repros' lists (``headpair_lanepack.VERSIONS``,
# ``headquad_lanepack.VERSIONS``): name -> (k_pack, two_pass, windows a CTA)
HEADPACK_CASES = {
    "pair_2pass_w8": (2, True, 8), "pair_1pass_w8": (2, False, 8),
    "pair_2pass_w16": (2, True, 16), "quad_2pass_w8": (4, True, 8),
    "quad_1pass_w8": (4, False, 8), "quad_2pass_w16": (4, True, 16),
    "oct_2pass_w8": (8, True, 8)}
# the stamped strip body's sections, in order (R10: no out-projection)
SECTIONS = ["rows", "qkv", "n x n", "store", "tail"]

# occupancy exports for a source whose first design is all it has (the
# package's own have the same interfaces and report the route they take)
_FIRST_OCCUPANCY = {
    HEADPACK: _OCCUPANCY_OF + r'''
extern "C" int vgm_headpack_attention_occupancy(
    int n, int dim, int dh, int out_dim, int k_pack, int sub_pack,
    int two_pass, int is_bf16, int* out) {
  (void)n;
  if (is_bf16)
    return sections_occupancy_of(
        headpack_attention_kernel<__nv_bfloat16, true>,
        make_headpack_plan<__nv_bfloat16>(dim, dh, out_dim, k_pack,
                                          sub_pack, two_pass).bytes, out);
  return sections_occupancy_of(
      headpack_attention_kernel<float, false>,
      make_headpack_plan<float>(dim, dh, out_dim, k_pack, sub_pack,
                                two_pass).bytes, out);
}
''',
    STACKED: _OCCUPANCY_OF + r'''
extern "C" int vgm_stacked_softmax_attention_occupancy(
    int n, int dim, int dh, int group, int is_bf16, int* out) {
  (void)n;
  if (is_bf16)
    return sections_occupancy_of(
        stacked_softmax_kernel<__nv_bfloat16, true>,
        make_stacked_plan<__nv_bfloat16>(dim, dh, group).bytes, out);
  return sections_occupancy_of(
      stacked_softmax_kernel<float, false>,
      make_stacked_plan<float>(dim, dh, group).bytes, out);
}
'''}
_CTAS = re.compile(r"constexpr int kStripCtasPerSm = (\d+);")


def variants(directory: Path) -> Dict[str, str]:
    """{variant: source} of the design in ``directory``: ``headpack`` and
    ``stacked``; for a strip design of R10 also ``stacked_ctas2`` or
    ``stacked_ctas3`` (the CTAs an SM it does not take) and
    ``stacked_stamp``."""
    out = {}
    for key, name in (("headpack", HEADPACK), ("stacked", STACKED)):
        path = directory / name
        text = inline_includes(path.read_text(), path.parent)
        export = ("vgm_headpack_attention_occupancy" if key == "headpack"
                  else "vgm_stacked_softmax_attention_occupancy")
        if export not in text:
            text += _FIRST_OCCUPANCY[name]
        out[key] = _PRE + text + _POST
        if key == "stacked" and STACKED_STRIP_KERNEL in text:
            m = _CTAS.search(text)
            if m is None:
                raise ValueError(f"{name} has changed: no {CTAS.format('N')}")
            other = 5 - int(m.group(1))   # 2 <-> 3
            out[f"stacked_ctas{other}"] = out[key].replace(
                m.group(0), CTAS.format(other))
            out["stacked_stamp"] = (_PRE + strip_stamped(
                text, STACKED_STRIP_KERNEL) + _POST)
    return out


def ptxas_kernels(log: str) -> Dict[str, Tuple[int, int, int]]:
    """{kernel: (registers, spill store bytes, spill load bytes)} of each
    entry function in ``nvcc -Xptxas -v`` output, its name demangled when
    ``c++filt`` is there."""
    out: Dict[str, List[int]] = {}
    entry = props = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out.setdefault(entry, [0, 0, 0])
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            props = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and props in out:
            out[props][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and entry in out:
            out[entry][0] = int(m.group(1))
    names = list(out)
    try:
        shown = subprocess.run(["c++filt"], input="\n".join(names),
                               capture_output=True, text=True,
                               check=True).stdout.splitlines()
    except (OSError, subprocess.CalledProcessError):
        shown = names
    if len(shown) != len(names):
        shown = names
    return {s: tuple(out[n]) for s, n in zip(shown, names)}


class Built:
    """One built source, its entries declared by the caller."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))

    def occupancy_of(self, fn, *args) -> List[int]:
        out = (ctypes.c_int * 4)()
        route = fn(*args, out)
        if route < 0:
            raise RuntimeError("occupancy query failed")
        return [route] + list(out)

    def sections(self, run: Callable) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call of
        ``run``."""
        self.lib.sections_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


class Headpack(Built):
    """A head-pack design, called through its own plain-C entry."""

    def __init__(self, path: Path):
        super().__init__(path)
        ptr, i32, lib = ctypes.c_void_p, ctypes.c_int, self.lib
        lib.vgm_headpack_attention.argtypes = [ptr] * 5 + [i32] * 12 + [ptr]
        lib.vgm_headpack_attention_smem_bytes.argtypes = [i32] * 7
        lib.vgm_headpack_attention_smem_bytes.restype = ctypes.c_long
        lib.vgm_headpack_attention_occupancy.argtypes = [i32] * 8 + [ptr]
        self.has_route = hasattr(lib, "vgm_headpack_attention_route")
        if self.has_route:
            lib.vgm_headpack_attention_route.argtypes = [i32] * 5

    def plan(self, case: str, n, dim, dh, out_dim) -> Tuple[int, int]:
        """(route, heads a sub-pack) of the case's launch: the first design
        takes the wrapper's pick, the strip design none."""
        k, two_pass, _ = HEADPACK_CASES[case]
        route = (self.lib.vgm_headpack_attention_route(n, dim, dh, out_dim, 1)
                 if self.has_route else 0)
        if route == 1:
            return route, 0
        return route, av._pick_sub_pack(
            self.lib.vgm_headpack_attention_smem_bytes, dim, dh, out_dim, k,
            two_pass, 1)

    def occupancy(self, case: str, n, dim, dh, out_dim) -> List[int]:
        k, two_pass, _ = HEADPACK_CASES[case]
        _, sub = self.plan(case, n, dim, dh, out_dim)
        return self.occupancy_of(self.lib.vgm_headpack_attention_occupancy,
                                 n, dim, dh, out_dim, k, sub, int(two_pass),
                                 1)

    def call(self, case: str, x, w_heads, bias, wout2) -> Callable:
        k, two_pass, wpc = HEADPACK_CASES[case]
        bw, n, dim = x.shape
        heads, dh, out_dim = bias.shape[0], w_heads.shape[-1] // 3, \
            wout2.shape[1]
        _, sub = self.plan(case, n, dim, dh, out_dim)
        out = torch.empty(bw, n, out_dim, dtype=torch.bfloat16,
                          device=x.device)
        args = [x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(),
                wout2.data_ptr(), out.data_ptr(), bw, n, dim, heads, dh,
                out_dim, k, sub, int(two_pass), wpc, 1, 1,
                torch.cuda.current_stream(x.device).cuda_stream]

        def run():
            library.check(self.lib.vgm_headpack_attention(*args),
                          "headpack_attention design")
            return out
        return run


class Stacked(Built):
    """A stacked-softmax design, called through its own plain-C entry."""

    def __init__(self, path: Path):
        super().__init__(path)
        ptr, i32, lib = ctypes.c_void_p, ctypes.c_int, self.lib
        lib.vgm_stacked_softmax_attention.argtypes = ([ptr] * 4 + [i32] * 8
                                                      + [ptr])
        lib.vgm_stacked_softmax_attention_smem_bytes.argtypes = [i32] * 4
        lib.vgm_stacked_softmax_attention_smem_bytes.restype = ctypes.c_long
        lib.vgm_stacked_softmax_attention_occupancy.argtypes = ([i32] * 5
                                                                + [ptr])
        self.has_route = hasattr(lib, "vgm_stacked_softmax_attention_route")
        if self.has_route:
            lib.vgm_stacked_softmax_attention_route.argtypes = [i32] * 4

    def plan(self, n, dim, dh, heads) -> Tuple[int, int]:
        """(route, heads a stack): the first design takes the wrapper's
        pick, the strip design none."""
        route = (self.lib.vgm_stacked_softmax_attention_route(n, dim, dh, 1)
                 if self.has_route else 0)
        if route == 1:
            return route, 0
        return route, av._pick_group(
            self.lib.vgm_stacked_softmax_attention_smem_bytes, dim, dh,
            heads, 1, 8, 1)

    def occupancy(self, n, dim, dh, heads) -> List[int]:
        _, group = self.plan(n, dim, dh, heads)
        return self.occupancy_of(
            self.lib.vgm_stacked_softmax_attention_occupancy, n, dim, dh,
            group, 1)

    def call(self, x, w_heads, bias) -> Callable:
        bw, n, dim = x.shape
        heads, dh = bias.shape[0], w_heads.shape[-1] // 3
        _, group = self.plan(n, dim, dh, heads)
        out = torch.empty(bw, n, heads * dh, dtype=torch.bfloat16,
                          device=x.device)
        args = [x.data_ptr(), w_heads.data_ptr(), bias.data_ptr(),
                out.data_ptr(), bw, n, dim, heads, dh, group,
                av.WINDOWS_PER_CTA, 1,
                torch.cuda.current_stream(x.device).cuda_stream]

        def run():
            library.check(self.lib.vgm_stacked_softmax_attention(*args),
                          "stacked_softmax_attention design")
            return out
        return run


def occupancy_line(name: str, label: str, occ: List[int]) -> str:
    route, regs, local, smem, per_sm = occ
    return (f"{name} {label}: route {route} ({'strip' if route else 'first'}"
            f" design), {regs} registers, {local} B local a thread, "
            f"{smem} B shared a CTA, {per_sm} CTAs an SM")


def agreement(label: str, runs: Dict[str, Callable], ref, package,
              others: Dict[str, torch.Tensor]) -> None:
    """Print each design's distance from the plain version, the package
    kernel and ``others``; raises when one misses the bf16 tolerance."""
    scale = ref.float().abs().max().item()
    for name, run in runs.items():
        out = run()
        torch.cuda.synchronize()
        err = (out.float() - ref.float()).abs().max().item()
        verdict = "within" if err <= TOLERANCE * scale else "OUTSIDE"
        parts = [f"{label}: {name} max|d| / max|plain| = {err / scale:.3e} "
                 f"({verdict} {TOLERANCE:g})"]
        for what, t in {"the package kernel": package, **others}.items():
            d = (out.float() - t.float()).abs().max().item()
            parts.append(f"against {what} {d / scale:.3e}"
                         f"{' (bit-identical)' if d == 0 else ''}")
        print("; ".join(parts), flush=True)
        if err > TOLERANCE * scale:
            raise AssertionError(f"{label} {name}: outside the tolerance")


def in_turns(label: str, runs: Dict[str, Callable]) -> Dict[str, List[float]]:
    ms: Dict[str, List[float]] = {}
    for name in list(runs) + list(runs)[::-1]:
        ms.setdefault(name, []).append(cuda_ms(runs[name], iters=5))
        print(f"{label}: {name}: {ms[name][-1]:.3f} ms", flush=True)
    return ms


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, action="append", default=[],
                    help="a directory with an earlier design's "
                         f"{HEADPACK} and {STACKED} and the headers they "
                         "include; its builds are named after it (may be "
                         "given more than once)")
    ap.add_argument("--bw", type=int, action="append", default=[],
                    help=f"windows a call (default {BWS})")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("headpack_stacked_sections runs on a CUDA device")
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
            if not re.search(r"headpack|stacked|outproj_attention_strips",
                             kernel):
                continue
            print(f"ptxas {name}: {kernel}: {regs} registers, {stores} B "
                  f"spill stores, {loads} B spill loads", flush=True)
            report["ptxas"][f"{name}: {kernel}"] = [regs, stores, loads]
    packs = {f"{t}_headpack": Headpack(libs[f"{t}_headpack"]) for t in dirs}
    stacks = {name: Stacked(path) for name, path in libs.items()
              if "_stacked" in name and not name.endswith("_stamp")}
    stamps = {name: Stacked(path) for name, path in libs.items()
              if name.endswith("_stacked_stamp")}
    for bw in args.bw or BWS:
        x, wqkv, bias, wout = ws.inputs(bw, torch.bfloat16, dev, SEED)
        heads, dh, dim = r1.HEADS, r1.DIM_HEAD, r1.DIM
        n, out_dim = x.shape[1], wout.shape[-1]
        w_heads = av._per_head(wqkv, heads)
        wout2 = wout.reshape(-1, out_dim)
        w4 = weight4(wqkv, heads)
        with torch.inference_mode():
            ref = plain.outproj_attention(x, wqkv, bias, wout, heads, dh)
            for case, (k, two_pass, wpc) in HEADPACK_CASES.items():
                label = f"Bw={bw} {case}"
                for name, d in packs.items():
                    print(occupancy_line(name, label, d.occupancy(
                        case, n, dim, dh, out_dim)), flush=True)
                package = av.headpack_attention(
                    x, wqkv, bias, wout, k_pack=k, two_pass=two_pass,
                    windows_per_cta=wpc)
                family = av.outproj_attention(
                    x, w4, bias, wout, two_pass=True, perhead_wout=True,
                    windows_per_cta=wpc)
                runs = {name: d.call(case, x, w_heads, bias, wout2)
                        for name, d in packs.items()}
                agreement(label, runs, ref, package,
                          {f"ws_2pass_pwout w{wpc}": family})
                report[label] = {"ms": in_turns(label, runs)}
                del package, family, runs
            del ref, w4, wout2
            torch.cuda.empty_cache()

            x, wqkv, bias = r1.inputs(bw, torch.bfloat16, dev, SEED)
            w_heads = av._per_head(wqkv, heads)
            label = f"Bw={bw} R10"
            ref = plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)
            package = av.stacked_softmax_attention(x, wqkv, bias)
            for name, d in stacks.items():
                print(occupancy_line(name, label, d.occupancy(
                    n, dim, dh, heads)), flush=True)
            runs = {name: d.call(x, w_heads, bias)
                    for name, d in stacks.items()}
            agreement(label, runs, ref, package, {})
            out_case: Dict[str, object] = {"ms": in_turns(label, runs)}
            for name, d in stamps.items():
                cyc = d.sections(d.call(x, w_heads, bias))[:len(SECTIONS)]
                shares = {s: c / cyc.sum() for s, c in zip(SECTIONS, cyc)}
                print(f"{label}: {name} sections: " + " ".join(
                    f"{s}={100 * v:.1f}%" for s, v in shares.items()),
                    flush=True)
                out_case[f"{name} sections"] = shares
            report[label] = out_case
            del x, wqkv, bias, w_heads, ref, package, runs
            torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
