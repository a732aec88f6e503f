"""K1-d's keep-mask writer and R11's staged core on the card, design by
design: ptxas's registers and spills, occupancy, times in turns against
their parent builds, the library calls and the plain versions, with each
version's achieved GB/s, and the check that no shared header the two
sources include has changed.

    python -m vit_grid_model_tpu_torch.repros.staged_core_sections \
        [--parent DIR] [--bw BW ...]

It writes self-contained copies (every header a source includes from its
own directory inlined, ``outproj_sections.inline_includes``) of
``csrc/staged_attention_core.cu`` and ``csrc/dropout_keep_mask.cu`` into
``build/staged_core_sections/`` (never into ``csrc/``) and builds each with
``nvcc -Xptxas -v``:

* R11: the package's ring design ("ring", its ``kStages`` windows in the
  ring), ``ring3``, ``ring4`` and ``ring6`` (other ring depths; outputs
  bit-identical to the package's), and three builds that split the bytes'
  floor on the card, whose outputs are wrong and not checked: ``nomath``
  (the scores, softmax and P.V taken out, zeros stored in P.V's pattern:
  the copies and the stores alone), ``nostore`` (the copies and the math,
  P.V's stores taken out: the reads) and ``noload`` (no copies: the math
  on the zeroed ring and the stores);
* K1-d: the package's writer ("chunks": 16-byte streaming stores) and
  ``bulk`` (each CTA writes its chunks into a tile in shared memory and
  stores the tile with one 1-D bulk copy a round, three tiles in turn).

DIR holds an earlier design's sources with their headers (e.g. ``git
archive <commit> vit_grid_model_tpu_torch/csrc | tar -x
--strip-components=2 -C build/parent_staged``); its two sources are built and
timed as ``parent``, and every header the package's two sources include
is compared with DIR's.  At each Bw (default 2,880 and 9,000; R11's
geometry, ``repros/staged_headmajor.py``: 56 tokens, 32 heads x 32, bf16)
and at the flagship mask (Bw 1,440 x 32 heads x 53^2, rate 0.1) it prints:

* for each build, ptxas's registers, spill stores and spill loads of each
  kernel, and the ring design's occupancy (registers, local bytes a
  thread, shared memory a CTA, CTAs an SM, windows in the ring);
* each R11 build's distance from the plain version (within 2e-2 of
  max|plain|) and whether it is bit-identical to the package's; each mask
  build bit-equal to ``keep_mask``, at the flagship shape and at a ragged
  total (Bw 3 x 3 heads x 53^2, no multiple of 4);
* ms a call of every version in turns (first, second, ..., then reversed),
  with the GB/s the bytes the function must move give at that time: R11's
  builds, the parent's, SDPA's default call and its memory-efficient
  backend (the library calls, ``repros/staged_headmajor.py``), ``stock
  addcmul`` (``torch.addcmul(qn, kn, v)``: the same three reads and one
  write, the rate the card gives that mix) and the plain version; the
  mask's builds, the parent's, ``stock fill`` (``fill_`` of a tensor of
  the mask's size: the same writes) and the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import sys
from pathlib import Path
from typing import Callable, Dict, List, Set

import torch

from vit_grid_model_tpu_torch.ops.attention_variants import (
    stage_headmajor, staged_headmajor_core)
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.dropout import keep_constants, keep_mask
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common
from vit_grid_model_tpu_torch.repros import staged_headmajor as r11
from vit_grid_model_tpu_torch.repros.bwd_sections import build
from vit_grid_model_tpu_torch.repros.headpack_stacked_sections import (
    in_turns, ptxas_kernels)
from vit_grid_model_tpu_torch.repros.outproj_sections import (
    _INCLUDE, inline_includes)

BUILD = library.LIBRARY.parent.parent / "staged_core_sections"
R11_SOURCE = "staged_attention_core.cu"
MASK_SOURCE = "dropout_keep_mask.cu"
SEED = 0
BWS = [2880, 9000]
TOLERANCE = r1.TOLERANCE[torch.bfloat16]
# the flagship training mask (chip_smoke's TRAIN_WINDOWS, DROPOUT,
# DROPOUT_SEED) and a ragged total
MASK_CASES = {"flagship": (1440, 32, 53), "ragged": (3, 3, 53)}
MASK_SEED = 2 ** 30 + 12345
MASK_RATE = 0.1
STAGES = "constexpr int kStages = 2;"
R11_PATCHES = {**{f"ring{k}": [(STAGES, f"constexpr int kStages = {k};")]
                  for k in (3, 4, 6)},
               # no copies: the math runs on the zeroed ring and the
               # stores write its output: the writes' floor
               "noload": [("  if (live) {\n    const size_t base",
                           "  if (false) {\n    const size_t base")]}
STORE = ("          // section: store\n",
         "          // section: end store\n")
# nomath's body: zeros stored in the pattern of P.V's fragments
NOMATH = r'''      __nv_bfloat16* const ob =
          out + (static_cast<size_t>(first) + j) * n * kDh;
#pragma unroll
      for (int c = 2 * t; c < kDh; c += 8) {
        if (r0 < n) *reinterpret_cast<uint32_t*>(ob + r0 * kDh + c) = 0u;
        if (r1 < n) *reinterpret_cast<uint32_t*>(ob + r1 * kDh + c) = 0u;
      }
'''
MATH = ("      // section: math\n", "      // section: end math\n")
WALK = ("  // section: walk\n", "  // section: end walk\n")
# K1-d's bulk variant of the walk: a tile of 256 chunks in shared memory a
# round, stored by one 1-D bulk copy; a tile is rewritten three rounds
# later, after thread 0 has seen its copy's reads done (wait_group.read 1
# after each commit), so one barrier a round serves both hazards
BULK_WALK = r'''  // section: walk
  __shared__ __align__(128) float4 tile[3][kMaskThreads];
  const unsigned whole = span / 4;  // chunks of four elements in the run
  const unsigned rounds = (chunks + kMaskThreads - 1) / kMaskThreads;
  for (unsigned r = 0; r < rounds; ++r) {
    float4* buf = tile[r % 3];
    const unsigned c = r * kMaskThreads + threadIdx.x;
    if (c < chunks) {
      const unsigned e = 4 * c;
      const float4 v = chunk_keep(e, p0, n, n_pad, by_plane, by_row, seed,
                                  threshold, scale);
      if (c < whole) {
        buf[threadIdx.x] = v;
      } else {
        const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (unsigned i = 0; i < 4; ++i)
          if (e + i < span) run[e + i] = w[i];
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (threadIdx.x == 0) {
      const unsigned first = r * kMaskThreads;
      const unsigned count = whole > first ? min(whole - first, 256u) : 0u;
      if (count > 0)
        asm volatile(
            "cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
            ::"l"(run + 4 * first),
            "r"(static_cast<unsigned>(__cvta_generic_to_shared(buf))),
            "r"(count * 16) : "memory");
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    }
  }
  if (threadIdx.x == 0)
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  // section: end walk
'''


def _between(text: str, marks, new: str) -> str:
    """``text`` with the lines from ``marks[0]`` to ``marks[1]`` (both
    included) replaced by ``new``."""
    if text.count(marks[0]) != 1 or text.count(marks[1]) != 1:
        raise ValueError(f"kernel source has changed: no {marks[0]!r}")
    a = text.index(marks[0])
    b = text.index(marks[1]) + len(marks[1])
    return text[:a] + new + text[b:]


def variants(directory: Path) -> Dict[str, str]:
    """{build: source} of the package's two sources in ``directory``, their
    headers inlined: "ring", each of ``R11_PATCHES``, "nomath", "chunks"
    and "bulk"."""
    r11_text = inline_includes((directory / R11_SOURCE).read_text(),
                               directory)
    mask_text = inline_includes((directory / MASK_SOURCE).read_text(),
                                directory)
    out = {"ring": r11_text}
    for name, pairs in R11_PATCHES.items():
        text = r11_text
        for old, new in pairs:
            if text.count(old) != 1:
                raise ValueError(f"{R11_SOURCE} has changed: no {old!r}")
            text = text.replace(old, new)
        out[name] = text
    out["nomath"] = _between(r11_text, MATH, NOMATH)
    # the copies and the math, no stores: the reads' floor
    out["nostore"] = _between(r11_text, STORE, "")
    out["chunks"] = mask_text
    out["bulk"] = _between(mask_text, WALK, BULK_WALK)
    return out


def included_headers(source: Path, seen: Set[str] = None) -> Set[str]:
    """The headers of ``source``'s directory it includes, recursively."""
    seen = set() if seen is None else seen
    for name in _INCLUDE.findall(source.read_text()):
        path = source.parent / name
        if path.exists() and name not in seen:
            seen.add(name)
            included_headers(path, seen)
    return seen


def headers_unchanged(parent: Path) -> Dict[str, bool]:
    """{header: unchanged} for every header the package's two sources
    include, against ``parent``'s copy.  Raises when one changed: every
    kernel built from it would then have to be held to its parent build,
    which this tool does not do."""
    names = sorted(included_headers(library.CSRC / R11_SOURCE)
                   | included_headers(library.CSRC / MASK_SOURCE))
    out = {h: (parent / h).exists() and (parent / h).read_text()
           == (library.CSRC / h).read_text() for h in names}
    for h, same in out.items():
        print(f"shared header {h}: {'unchanged' if same else 'CHANGED'} "
              f"against {parent}", flush=True)
    if not all(out.values()):
        raise AssertionError("a shared header changed: hold every kernel "
                             "that includes it to its parent build")
    return out


class CoreBuild:
    """One build of R11's core, called through its plain-C entry."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.lib.vgm_staged_attention_core.argtypes = ([ptr] * 5 + [i32] * 5
                                                       + [ptr])
        self.lib.vgm_staged_attention_core.restype = ctypes.c_int
        self.ring = hasattr(self.lib, "vgm_staged_attention_core_occupancy")
        if self.ring:
            self.lib.vgm_staged_attention_core_occupancy.argtypes = [i32, ptr]

    def occupancy(self, dh: int) -> List[int]:
        out = (ctypes.c_int * 5)()
        if self.lib.vgm_staged_attention_core_occupancy(dh, out) != 0:
            raise RuntimeError("occupancy query failed")
        return list(out)

    def call(self, qn, kn, v, bias) -> Callable:
        heads, bw, n, dh = qn.shape
        out = torch.empty_like(qn)
        args = [qn.data_ptr(), kn.data_ptr(), v.data_ptr(), bias.data_ptr(),
                out.data_ptr(), heads, bw, n, dh, 1,
                torch.cuda.current_stream(qn.device).cuda_stream]

        def run():
            library.check(self.lib.vgm_staged_attention_core(*args),
                          "staged_attention_core")
            return out
        return run


class MaskBuild:
    """One build of K1-d's writer, called through its plain-C entry."""

    def __init__(self, path: Path):
        self.lib = ctypes.CDLL(str(path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        self.lib.vgm_dropout_keep_mask.argtypes = ([ptr] + [i32] * 5
                                                   + [ctypes.c_float, ptr])
        self.lib.vgm_dropout_keep_mask.restype = ctypes.c_int

    def call(self, bw: int, heads: int, n: int, dev) -> Callable:
        threshold, scale = keep_constants(MASK_RATE)
        out = torch.empty(bw, heads, n, n, device=dev)
        args = [out.data_ptr(), bw, heads, n, MASK_SEED, threshold, scale,
                torch.cuda.current_stream(dev).cuda_stream]

        def run():
            library.check(self.lib.vgm_dropout_keep_mask(*args),
                          "dropout_keep_mask")
            return out
        return run


def rates(label: str, ms: Dict[str, List[float]],
          moved: float) -> Dict[str, float]:
    """{version: GB/s at its best time} for ``moved`` bytes, printed."""
    out = {name: moved / (min(t) * 1e-3) / 1e9 for name, t in ms.items()}
    print(f"{label}: GB/s at the best time of each (the bytes the function "
          f"must move, {moved / 1e9:.3f} GB): " + ", ".join(
              f"{k} {v:.0f}" for k, v in out.items()), flush=True)
    return out


def r11_case(bw: int, builds: Dict[str, CoreBuild],
             dev: torch.device) -> Dict[str, object]:
    """R11's core at ``bw``: every build against the plain version, then
    in turns with SDPA's two calls and the plain version."""
    label = f"R11 core Bw={bw}"
    heads, dh, n = r1.HEADS, r1.DIM_HEAD, r1.N_PAD
    x, wqkv, bias = r1.inputs(bw, torch.bfloat16, dev, SEED)
    case: Dict[str, object] = {}
    with torch.inference_mode():
        qkv = torch.matmul(x.float(), wqkv.float())
        qn, kn, v = stage_headmajor(qkv, heads, dh, torch.bfloat16)
        del qkv, x
        ref = staged_headmajor_core(qn, kn, v, bias)
        scale = ref.float().abs().max().item()
        runs = {name: b.call(qn, kn, v, bias) for name, b in builds.items()}
        package = runs["ring"]().clone()
        for name, run in runs.items():
            out = run()
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item() / scale
            same = torch.equal(out, package)
            print(f"{label}: {name} max|d| / max|plain| = {err:.3e}; "
                  f"{'bit-identical to' if same else 'differs from'} the "
                  "package's", flush=True)
            if (not name.endswith(("nomath", "nostore", "noload"))
                    and not err <= TOLERANCE):
                raise AssertionError(f"{label} {name}: outside the "
                                     "tolerance")
            if name.startswith("ring") and not same:
                raise AssertionError(f"{label} {name}: not bit-identical "
                                     "to the package's")
        mask = bias[:, None].to(torch.bfloat16)

        def sdpa():
            return torch.nn.functional.scaled_dot_product_attention(
                qn, kn, v, attn_mask=mask, scale=1.0)

        def sdpa_efficient():
            with r11.sdpa_kernel(r11.SDPBackend.EFFICIENT_ATTENTION):
                return sdpa()

        runs["sdpa"] = sdpa
        runs["sdpa efficient"] = sdpa_efficient
        # a stock elementwise call that reads three such operands and
        # writes one: what the card gives this mix of reads and writes
        runs["stock addcmul"] = lambda: torch.addcmul(qn, kn, v)
        runs["plain"] = lambda: staged_headmajor_core(qn, kn, v, bias)
        case["ms"] = in_turns(label, runs)
        bound, by = r11.core_bound_ms(bw, n, heads, dh, torch.bfloat16)
        moved = 4 * heads * bw * n * dh * 2 + heads * n * n * 4
        case["GB/s"] = rates(label, case["ms"], moved)
        best = min(case["ms"]["ring"])
        line = (f"{label}: bound {bound:.4f} ms ({by}); ring at "
                f"{100 * bound / best:.1f}% of its bound")
        if "parent" in case["ms"]:
            line += (f"; parent / ring "
                     f"{min(case['ms']['parent']) / best:.3f}")
        line += (f"; sdpa efficient / ring "
                 f"{min(case['ms']['sdpa efficient']) / best:.3f}")
        print(line, flush=True)
        del runs, ref, package, qn, kn, v, bias, mask
    torch.cuda.empty_cache()
    return case


def mask_case(name: str, builds: Dict[str, MaskBuild],
              dev: torch.device) -> Dict[str, object]:
    """K1-d at ``MASK_CASES[name]``: every build bit-equal to
    ``keep_mask``, then (at the flagship shape) in turns with the plain
    version."""
    bw, heads, n = MASK_CASES[name]
    label = f"K1-d {name} Bw={bw} x {heads} x {n}^2"
    case: Dict[str, object] = {}
    ref = keep_mask(MASK_SEED, bw, heads, n, MASK_RATE, device=dev)
    runs = {k: b.call(bw, heads, n, dev) for k, b in builds.items()}
    for k, run in runs.items():
        equal = torch.equal(run(), ref)
        print(f"{label}: {k} bit-equal to keep_mask: {equal}", flush=True)
        if not equal:
            raise AssertionError(f"{label} {k}: the masks differ")
    if name == "flagship":
        # a stock call that writes the same bytes and reads none
        fill = torch.empty(bw, heads, n, n, device=dev)
        runs["stock fill"] = lambda: fill.fill_(1.0)
        runs["plain"] = lambda: keep_mask(MASK_SEED, bw, heads, n,
                                          MASK_RATE, device=dev)
        case["ms"] = in_turns(label, runs)
        moved = bw * heads * n * n * 4
        case["GB/s"] = rates(label, case["ms"], moved)
        bound = moved / common.PEAK_BYTES * 1e3
        best = min(case["ms"]["chunks"])
        line = (f"{label}: bound {bound:.4f} ms (bytes); chunks at "
                f"{100 * bound / best:.1f}% of its bound; bulk / chunks "
                f"{min(case['ms']['bulk']) / best:.3f}")
        if "parent" in case["ms"]:
            line += (f"; parent / chunks "
                     f"{min(case['ms']['parent']) / best:.3f}")
        print(line, flush=True)
    del runs, ref
    torch.cuda.empty_cache()
    return case


def main(argv=None) -> Dict[str, object]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="a directory with an earlier design's "
                         f"{R11_SOURCE} and {MASK_SOURCE} and their headers")
    ap.add_argument("--bw", type=int, action="append", default=[],
                    help=f"R11's windows a call (default {BWS})")
    args = ap.parse_args(argv)
    dev = common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    srcs = variants(library.CSRC)
    report: Dict[str, object] = {"card": card, "ptxas": {}}
    if args.parent is not None:
        report["headers unchanged"] = headers_unchanged(args.parent)
        srcs["r11_parent"] = inline_includes(
            (args.parent / R11_SOURCE).read_text(), args.parent)
        srcs["mask_parent"] = inline_includes(
            (args.parent / MASK_SOURCE).read_text(), args.parent)
    logs: Dict[str, str] = {}
    libs = build(srcs, BUILD, ("-Xptxas", "-v"), logs)
    for name, log in logs.items():
        for kern, (regs, stores, loads) in ptxas_kernels(log).items():
            print(f"ptxas {name}: {kern}: {regs} registers, {stores} B "
                  f"spill stores, {loads} B spill loads", flush=True)
            report["ptxas"][f"{name}: {kern}"] = [regs, stores, loads]
    r11_names = ["ring", *R11_PATCHES, "nomath", "nostore"]
    cores = {name: CoreBuild(libs[name]) for name in r11_names}
    masks = {"chunks": MaskBuild(libs["chunks"]),
             "bulk": MaskBuild(libs["bulk"])}
    if args.parent is not None:
        cores["parent"] = CoreBuild(libs["r11_parent"])
        masks["parent"] = MaskBuild(libs["mask_parent"])
    for name, b in cores.items():
        if not b.ring:
            continue
        for dh in (16, 32, 48, 64):
            regs, local, smem, per_sm, stages = b.occupancy(dh)
            print(f"{name} dh={dh}: {regs} registers, {local} B local a "
                  f"thread, {smem} B shared a CTA, {per_sm} CTAs an SM, "
                  f"{stages} windows in the ring", flush=True)
            report[f"{name} dh={dh} occupancy"] = [regs, local, smem, per_sm,
                                                   stages]
    for name in MASK_CASES:
        report[f"K1-d {name}"] = mask_case(name, masks, dev)
    for bw in args.bw or BWS:
        report[f"R11 core Bw={bw}"] = r11_case(bw, cores, dev)
    print(f"card: {card}", flush=True)
    return report


if __name__ == "__main__":
    print(json.dumps(main(sys.argv[1:])))
