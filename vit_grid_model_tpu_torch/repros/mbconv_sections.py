"""R15's fused MBConv on the card, design by design: ptxas's registers and
spills, occupancy, times in turns against its parent, the stock folded
block and the plain version, the split by stage and by clock64 stamps, and
the check that the kernels sharing ``csrc/wgmma_common.cuh`` are unchanged.

    python -m vit_grid_model_tpu_torch.repros.mbconv_sections \
        [--parent DIR] [--bn BN ...]

It writes self-contained copies (every header a source includes from its
own directory inlined, ``outproj_sections.inline_includes``) of
``csrc/fused_mbconv.cu`` into ``build/mbconv_sections/`` (never into
``csrc/``) and builds each with ``nvcc -Xptxas -v``: the package's ("a"), a
``onebuf`` build (one we^T buffer: every chunk's copy waits for the chunk
before it), a ``wg3`` build (three warpgroups in stage (A), 168 registers
allowed, two m64 tiles for two of them), a ``nostore`` build (stage (A)
stores no h2: its output is wrong and not checked; stage (A)'s time
against the package's is what the stores cost), an ``f32h1`` build (h1's
bf16 values held in f32: twice the bytes, no unpacking) and a ``stamp``
build.
DIR holds an earlier design's sources with their headers (e.g. ``git
archive <commit> vit_grid_model_tpu_torch/csrc | tar -x
--strip-components=2 -C build/parent20``); its ``fused_mbconv.cu`` is
built too, and its ``perhead_attention.cu``, ``headmajor_attention.cu`` and
``crosshead_norm_attention.cu``, whose wgmma designs (R1 and R14 at 8 and
16 windows a CTA, R9's launch, R4 and R3 at 1 and 2 heads a staged x) must
give outputs bit-identical to the package's.  At each BN (default 384 and
300; 42 x 35, 128 -> 512, SE 128, bf16; the repro's block and inputs,
``repros/fused_mbconv.py``) it prints:

* for each build, ptxas's registers, spill stores and spill loads of each
  kernel of the source, and the occupancy of the bands design's stages
  (A) and (C) (registers, local bytes a thread, shared memory a CTA, CTAs
  an SM);
* each build's distance from the plain version (within 2e-2 of max|plain|)
  and from the package's output (``onebuf``, ``f32h1`` and the stamped
  build bit-identical; spb 4 bit-identical to spb 1);
* its ms a call, every version in turns (first, second, ..., then
  reversed): the package's at 1 and 4 samples a block, ``onebuf``,
  ``wg3``, ``nostore``, ``f32h1``, the parent's at 1 and 4, the stock
  folded block (the port's MBConv with ``fold_bn``, cuDNN: a yardstick the
  port never calls) and the plain version;
* the split by stage from torch.profiler (the prep, (A), (B), (C)) of the
  package's, each patched build's and the parent's calls;
* stage (A)'s split from the ``stamp`` build, in which thread 0 of each CTA
  (warp 0) reads ``clock64()`` at the end of each section of a chunk
  (lines marked ``// section: <name>`` in the source): the x wait, the
  weight wait, the expand (wgmma), h1 (GELU, the h1 store and the CTA's
  barrier), the depthwise conv with its GELU, sums and h2 stores, and the
  sums' reduction.
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

from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.mbconv import (fused_mbconv_reference,
                                                 mbconv_kernel_operands)
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common
from vit_grid_model_tpu_torch.repros import fused_mbconv as repro
from vit_grid_model_tpu_torch.repros.bwd_sections import _find, build
from vit_grid_model_tpu_torch.repros.grouped_sections import Grouped
from vit_grid_model_tpu_torch.repros.headpack_stacked_sections import (
    in_turns, ptxas_kernels)
from vit_grid_model_tpu_torch.repros.outproj_sections import (
    _POST, _PRE, inline_includes)
from vit_grid_model_tpu_torch.repros.perhead_sections import _kernel_places

BUILD = library.LIBRARY.parent.parent / "mbconv_sections"
SOURCE = "fused_mbconv.cu"
BANDS_KERNEL = "mbconv_bands_kernel"
SEED = 0
BNS = [384, 300]
TOLERANCE = repro.TOLERANCE[torch.bfloat16]
SECTIONS = ["x wait", "weight wait", "expand", "h1", "depthwise", "sums"]
# variant: (the package source's line, its replacement)
WEIGHT_BUFFERS = "constexpr int kWeightBuffers = 2;"
BAND_WARPGROUPS = "constexpr int kBandWarpgroups = 5;"
H1_TYPE = """using H1 = __nv_bfloat16;

__device__ __forceinline__ void store_h1(H1* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

__device__ __forceinline__ float2 load_h1(const H1* p) {
  return unpack_bf16(*reinterpret_cast<const uint32_t*>(p));
}
"""
# h1's bf16 values held in f32: read without unpacking, at twice the bytes
H1_F32 = """using H1 = float;

__device__ __forceinline__ void store_h1(H1* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(round_to<__nv_bfloat16>(a),
                                              round_to<__nv_bfloat16>(b));
}

__device__ __forceinline__ float2 load_h1(const H1* p) {
  return *reinterpret_cast<const float2*>(p);
}
"""
H2_STORE = """          *reinterpret_cast<uint32_t*>(
              h2n + (static_cast<size_t>(r0 + s - 1) * w + col) * HID) =
              pack_bf16(vx, vy);
"""
PATCHES = {
    "onebuf": (WEIGHT_BUFFERS, "constexpr int kWeightBuffers = 1;"),
    "wg3": (BAND_WARPGROUPS, "constexpr int kBandWarpgroups = 3;"),
    "nostore": (H2_STORE, ""),
    "f32h1": (H1_TYPE, H1_F32),
}
# the sources whose wgmma designs share wgmma_common.cuh
SHARED = {"perhead": "perhead_attention.cu", "R4": "headmajor_attention.cu",
          "R3": "crosshead_norm_attention.cu"}


def stamped(text: str) -> str:
    """``text`` with a stamp after each section of the bands kernel, its
    counts opened after its shared-memory declaration and flushed on its
    last line."""
    f = text.split("\n")
    kernel = _find(f, f"    {BANDS_KERNEL}(")
    places = _kernel_places(f, BANDS_KERNEL)
    for k, name in enumerate(SECTIONS):
        line = _find(f, f"// section: {name}", kernel)
        places[line] = (f"{' ' * (len(f[line]) - len(f[line].lstrip()))}"
                        f"STAMP({k});")
    out = []
    for i, line in enumerate(f):
        out.append(line)
        if i in places:
            out.append(places[i])
    return "\n".join(out)


def variants(directory: Path) -> Dict[str, str]:
    """{variant: source} of the package's ``fused_mbconv.cu`` in
    ``directory``: "a", each of ``PATCHES`` and "stamp"."""
    text = inline_includes((directory / SOURCE).read_text(), directory)
    out = {"a": _PRE + text + _POST}
    for name, (old, new) in PATCHES.items():
        if text.count(old) != 1:
            raise ValueError(f"{SOURCE} has changed: no {old.strip()!r}")
        out[name] = _PRE + text.replace(old, new) + _POST
    out["stamp"] = _PRE + stamped(text) + _POST
    return out


class Build:
    """One build of R15, called through its own plain-C entry; ``packed``
    says whether its entry takes the bands design's packed scratch (the
    parent's does not)."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.packed = hasattr(self.lib, "vgm_fused_mbconv_route")
        self.lib.vgm_fused_mbconv.argtypes = (
            [ptr] * (16 if self.packed else 15) + [i32] * 8 + [ptr])
        self.lib.vgm_fused_mbconv.restype = ctypes.c_int
        self.lib.vgm_fused_mbconv_row_tile.argtypes = [i32] * 3
        if self.packed:
            self.lib.vgm_fused_mbconv_route.argtypes = [i32] * 7
            self.lib.vgm_fused_mbconv_packed_elems.argtypes = [i32] * 2
            self.lib.vgm_fused_mbconv_occupancy.argtypes = [i32] * 4 + [ptr]

    def occupancy(self, stage: int, w: int, c: int, hid: int) -> List[int]:
        out = (ctypes.c_int * 4)()
        if self.lib.vgm_fused_mbconv_occupancy(stage, w, c, hid, out) != 0:
            raise RuntimeError("occupancy query failed")
        return list(out)

    def call(self, x, ops, spb: int) -> Callable:
        n, h, w, c = x.shape
        hid, se = ops[0].shape[1], ops[4].shape[1]
        rows = self.lib.vgm_fused_mbconv_row_tile(w, c, 1)
        out = torch.empty_like(x)
        scratch = [torch.empty(n, h, w, hid, dtype=x.dtype, device=x.device),
                   torch.empty(n, -(-h // rows), hid, device=x.device),
                   torch.empty(n, hid, device=x.device)]
        if self.packed:
            scratch.append(torch.empty(
                self.lib.vgm_fused_mbconv_packed_elems(c, hid),
                dtype=torch.bfloat16, device=x.device))
        args = [x.data_ptr(), *(t.data_ptr() for t in ops), out.data_ptr(),
                *(None if t is None else t.data_ptr() for t in scratch), n,
                h, w, c, hid, se, 1, spb,
                torch.cuda.current_stream(x.device).cuda_stream]

        def run():
            library.check(self.lib.vgm_fused_mbconv(*args), "fused_mbconv")
            return out
        run.scratch = scratch   # alive while run is
        return run

    def sections(self, run: Callable) -> np.ndarray:
        """Cycles a section, summed over the CTAs, of one call of ``run``."""
        self.lib.sections_reset()
        run()
        torch.cuda.synchronize()
        buf = (ctypes.c_ulonglong * 32)()
        self.lib.sections_read(buf)
        return np.array(list(buf), dtype=np.float64)


def perhead_call(path: Path, x, w_heads, bias, wpc: int) -> Callable:
    """R1's wgmma design in the library at ``path`` at ``wpc`` windows a
    CTA, through its ``vgm_perhead_attention_wgmma``."""
    lib = ctypes.CDLL(str(path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    fn = lib.vgm_perhead_attention_wgmma
    fn.argtypes = [ptr] * 4 + [i32] * 6 + [ptr]
    fn.restype = ctypes.c_int
    bw, n, dim = x.shape
    heads, dh = bias.shape[0], w_heads.shape[-1] // 3
    tiles, rows = av._wgmma_operands(w_heads, bias)
    out = torch.empty(bw, n, heads * dh, dtype=x.dtype, device=x.device)
    args = [x.data_ptr(), tiles.data_ptr(), rows.data_ptr(), out.data_ptr(),
            bw, n, dim, heads, dh, wpc,
            torch.cuda.current_stream(x.device).cuda_stream]

    def run():
        library.check(fn(*args), "perhead wgmma design")
        return out
    run.keep = (lib, tiles, rows)
    return run


def shared_header_identical(parent_libs: Dict[str, Path],
                            dev: torch.device) -> Dict[str, bool]:
    """Each kernel on ``wgmma_common.cuh`` (R1, R14, R9, R4, R3) against
    the parent's build at the repro's geometry (Bw 2,880, bf16): raises
    unless every output is bit-identical."""
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    x, wqkv, bias = r1.inputs(2880, torch.bfloat16, dev, SEED)
    w_heads = av._per_head(wqkv, r1.HEADS)
    out: Dict[str, bool] = {}
    with torch.inference_mode():
        ours = {"R1": av.perhead_attention(x, wqkv, bias, 8).clone(),
                "R14": av.perhead_attention(x, wqkv, bias, 16).clone(),
                "R9": av.perhead_weight_attention(
                    x, weight4(wqkv, r1.HEADS), bias).clone()}
        theirs = {"R1": perhead_call(parent_libs["perhead"], x, w_heads,
                                     bias, 8)().clone(),
                  "R14": perhead_call(parent_libs["perhead"], x, w_heads,
                                      bias, 16)().clone()}
        theirs["R9"] = theirs["R1"]
        for kernel in ("R4", "R3"):
            entry = {"R4": "vgm_headmajor_attention",
                     "R3": "vgm_crosshead_norm_attention"}[kernel]
            for g in (1, 2):
                name = f"{kernel} G{g}"
                ours[name] = Grouped(library.LIBRARY, entry).call(
                    x, w_heads, bias, g)().clone()
                theirs[name] = Grouped(parent_libs[kernel], entry).call(
                    x, w_heads, bias, g)().clone()
        torch.cuda.synchronize()
    for name in ours:
        out[name] = torch.equal(ours[name], theirs[name])
        print(f"{name}: the package's wgmma design against the parent's "
              f"build: {'bit-identical' if out[name] else 'DIFFERENT'}",
              flush=True)
    if not all(out.values()):
        raise AssertionError("a kernel on wgmma_common.cuh changed its "
                             "output")
    return out


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory with an earlier design's sources and "
                         "headers (its R15 timed, its wgmma kernels held "
                         "bit-identical)")
    ap.add_argument("--bn", type=int, action="append", default=[],
                    help=f"samples a call (default {BNS})")
    args = ap.parse_args(argv)
    dev = common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    srcs = variants(library.CSRC)
    if args.parent is not None:
        srcs["parent"] = inline_includes(
            (args.parent / SOURCE).read_text(), args.parent)
        for key, source in SHARED.items():
            srcs[f"parent_{key}"] = inline_includes(
                (args.parent / source).read_text(), args.parent)
    logs: Dict[str, str] = {}
    libs = build(srcs, BUILD, ("-Xptxas", "-v"), logs)
    report: Dict[str, object] = {"card": card, "ptxas": {}}
    for name, log in logs.items():
        if name.startswith("parent_"):
            continue
        for kern, (regs, stores, loads) in ptxas_kernels(log).items():
            if "mbconv" not in kern:
                continue
            print(f"ptxas {name}: {kern}: {regs} registers, {stores} B "
                  f"spill stores, {loads} B spill loads", flush=True)
            report["ptxas"][f"{name}: {kern}"] = [regs, stores, loads]
    if args.parent is not None:
        report["wgmma_common identical"] = shared_header_identical(
            {k: libs[f"parent_{k}"] for k in SHARED}, dev)
    builds = {name: Build(libs[name]) for name in
              ["a", *PATCHES, "stamp"] + (["parent"] if args.parent else [])}
    c, hid = repro.DIM, repro.DIM * repro.EXPANSION
    for name in ("a", *PATCHES):
        for stage, label in ((0, "A"), (1, "C")):
            regs, local, smem, per_sm = builds[name].occupancy(
                stage, repro.W, c, hid)
            print(f"{name} stage ({label}): {regs} registers, {local} B "
                  f"local a thread, {smem} B shared a CTA, {per_sm} CTAs an "
                  f"SM", flush=True)
            report[f"{name} stage {label} occupancy"] = [regs, local, smem,
                                                         per_sm]
    torch.backends.cudnn.allow_tf32 = False
    m = repro.block(seed=SEED).to(dev)
    ops = mbconv_kernel_operands(m)
    stock = m.to(torch.bfloat16)
    for n in args.bn or BNS:
        label = f"BN={n}"
        x = repro.inputs(n, repro.H, repro.W, c, SEED + 1, torch.bfloat16,
                         dev)
        x_nchw = x.permute(0, 3, 1, 2)
        case: Dict[str, object] = {}
        with torch.inference_mode():
            ref = fused_mbconv_reference(x, ops)
            scale = ref.float().abs().max().item()
            runs: Dict[str, Callable] = {
                "kernel spb=1": builds["a"].call(x, ops, 1),
                "kernel spb=4": builds["a"].call(x, ops, 4)}
            for name in PATCHES:
                runs[name] = builds[name].call(x, ops, 1)
            if args.parent is not None:
                runs["parent spb=1"] = builds["parent"].call(x, ops, 1)
                runs["parent spb=4"] = builds["parent"].call(x, ops, 4)
            package = runs["kernel spb=1"]().clone()
            stamp = builds["stamp"].call(x, ops, 1)
            for name, run in {**runs, "stamp": stamp}.items():
                out = run()
                torch.cuda.synchronize()
                err = (out.float() - ref.float()).abs().max().item() / scale
                same = torch.equal(out, package)
                print(f"{label}: {name} max|d| / max|plain| = {err:.3e}; "
                      f"{'bit-identical to' if same else 'differs from'} "
                      f"the package's spb=1", flush=True)
                if name != "nostore" and not err <= TOLERANCE:
                    raise AssertionError(f"{label} {name}: outside the "
                                         "tolerance")
                if name in ("kernel spb=4", "onebuf", "f32h1",
                            "stamp") and not same:
                    raise AssertionError(f"{label} {name}: not bit-identical"
                                         " to the package's spb=1")
            runs["stock folded (cuDNN)"] = lambda: stock(x_nchw, None, True)
            runs["plain"] = lambda: fused_mbconv_reference(x, ops)
            case["ms"] = in_turns(label, runs)
            bound, by = repro.bound_ms(n, repro.H, repro.W, c, hid, c,
                                       torch.bfloat16)
            best = min(case["ms"]["kernel spb=1"])
            print(f"{label}: bound {bound:.4f} ms ({by}); kernel spb=1 "
                  f"{best / bound:.1f}x its bound; / stock "
                  f"{best / min(case['ms']['stock folded (cuDNN)']):.3f}",
                  flush=True)
            for name in ["kernel spb=1", "kernel spb=4", *PATCHES] + (
                    ["parent spb=1"] if args.parent else []):
                split = common.kernel_ms(runs[name])
                print(f"{label}: {name} by stage (torch.profiler): " + ", "
                      .join(f"{k} {v:.4f} ms" for k, v in split.items()),
                      flush=True)
                case[f"{name} stages"] = split
            cycles = builds["stamp"].sections(stamp)[:len(SECTIONS)]
            share = {s: v / cycles.sum() for s, v in zip(SECTIONS, cycles)}
            print(f"{label}: stage (A) sections (warp 0 of each CTA): " +
                  " ".join(f"{s}={100 * v:.1f}%" for s, v in share.items()),
                  flush=True)
            case["stage A sections"] = share
        report[label] = case
        del runs, stamp, x, x_nchw, ref, package
        torch.cuda.empty_cache()
    print(f"card: {card}")
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
