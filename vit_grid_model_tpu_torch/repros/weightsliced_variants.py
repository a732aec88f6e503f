"""R12 and R13 on the GPU: R1's attention with the out-projection, in the
TPU repro's five structures.

The counterpart of ``benchmarks/mosaic_repros/repro_weightsliced_variants.py``
(R12, ``baseline``: one qkv product, two passes, the concat of the head
outputs times Wout; R13: the qkv from per-head weight slices, one pass or
two, the concat or one out-product a head summed in f32).  All five run on
one kernel (``csrc/outproj_attention.cu``) with the choices at run time;
R12's one wide qkv product does not fit a window in shared memory, so
``baseline`` runs ``ws_2pass``'s structure from R1's (dim, 3hd) weight.  At
R1's geometry and inputs (``repros/baseline_perhead.py``: 56 tokens, dim
128, 32 heads x 32, bf16; Bw = 2,880 and 9,000) plus a (32, 32, 128) wout,
it times with CUDA events, each with its max error relative to the plain
version:

* ``plain``: ``ops/attention_variants.py::outproj_attention``;
* ``baseline``, ``ws_1pass``, ``ws_2pass``, ``ws_1pass_pwout`` and
  ``ws_2pass_pwout``: ``ops/cuda/attention_variants.py::outproj_attention``
  at 8 windows a CTA;
* ``unfused``: R1's kernel, then its head outputs (already in x's dtype)
  times the (1,024, 128) wout in one cuBLAS call with f32 sums
  (``torch.mm(..., out_dtype=torch.float32)``), rounded to bf16.  It is the
  yardstick of whether the fusion pays on this card, not a port.

No single PyTorch call computes the function (SDPA has no qkv product, l2
norm or out-projection), so the kernels have no library time.  ``run``
takes other versions: the R2 and R8 harnesses time theirs with it.  Needs
one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.weightsliced_variants
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops.attention_variants import outproj_attention
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common
from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

OUT_DIM = r1.DIM
ITERS = 10   # timed calls a version
LIBRARY = ("none: no single PyTorch call computes the function (SDPA has "
           "no qkv product, l2 norm or out-projection)")
# the repro's variants: name -> (R9's w4 weight, two_pass, perhead_wout)
VARIANTS = {"baseline": (False, True, False),
            "ws_1pass": (True, False, False),
            "ws_2pass": (True, True, False),
            "ws_1pass_pwout": (True, False, True),
            "ws_2pass_pwout": (True, True, True)}
# the inputs of a version: (x, wqkv, bias, wout) -> the call to time
Version = Callable[[Tensor, Tensor, Tensor, Tensor], Callable[[], Tensor]]


def inputs(bw: int, dtype: torch.dtype, device: torch.device, seed: int = 0,
           n: int = r1.N_PAD, dim: int = r1.DIM, heads: int = r1.HEADS,
           dim_head: int = r1.DIM_HEAD, out_dim: int = OUT_DIM
           ) -> Tuple[Tensor, ...]:
    """(x, wqkv, bias) of ``baseline_perhead.inputs`` and wout (heads,
    dim_head, out_dim) in ``dtype``, standard normal x 0.05 as the repro's,
    from the numpy seed ``seed + 7`` (the repro draws it from key 7)."""
    x, wqkv, bias = r1.inputs(bw, dtype, device, seed, n=n, dim=dim,
                              heads=heads, dim_head=dim_head)
    wout = (np.random.default_rng(seed + 7)
            .standard_normal((heads, dim_head, out_dim), np.float32) * 0.05)
    return x, wqkv, bias, torch.from_numpy(wout).to(device, dtype)


def bound_ms(bw: int, n: int, dim: int, heads: int, dim_head: int,
             out_dim: int, dtype: torch.dtype) -> Tuple[float, str]:
    """The least time the card could take for R1's function plus the
    out-projection: the products' operations (qkv, scores, P.v, out-
    projection) over the peak rate for the dtype against the bytes that
    must move (x, the weights and bias read once, the bf16 output written
    once) over the memory rate."""
    item = torch.finfo(dtype).bits // 8
    inner = heads * dim_head
    ops = bw * (2 * n * dim * 3 * inner + 4 * heads * n * n * dim_head
                + 2 * n * inner * out_dim)
    moved = (bw * n * dim * item + (3 * dim + out_dim) * inner * item
             + heads * n * n * 4 + bw * n * out_dim * 2)
    return common.bound_ms(ops, moved, dtype)


def kernel(two_pass: bool, perhead_wout: bool, r9_weight: bool = True,
           **kwargs) -> Version:
    """The out-projection kernel at these choices, from R9's (3, heads, dim,
    dh) weight (made once, outside the timing) or R1's (dim, 3hd) one."""
    def make(x, wqkv, bias, wout):
        w = weight4(wqkv, bias.shape[0]) if r9_weight else wqkv
        return lambda: av.outproj_attention(
            x, w, bias, wout, two_pass=two_pass, perhead_wout=perhead_wout,
            **kwargs)
    return make


def plain(**kwargs) -> Version:
    def make(x, wqkv, bias, wout):
        return lambda: outproj_attention(x, wqkv, bias, wout, bias.shape[0],
                                         wout.shape[1], **kwargs)
    return make


def unfused(x: Tensor, wqkv: Tensor, bias: Tensor,
            wout: Tensor) -> Callable[[], Tensor]:
    """R1's kernel at 8 windows a CTA, then one cuBLAS out-projection with
    f32 sums, rounded to bf16."""
    w2 = wout.reshape(-1, wout.shape[-1])

    def call():
        o = av.perhead_attention(x, wqkv, bias, 8)
        o2 = o.reshape(-1, o.shape[-1])
        y = (torch.mm(o2, w2, out_dtype=torch.float32)
             if o.dtype == torch.bfloat16 else torch.mm(o2, w2))
        return y.to(torch.bfloat16).reshape(*x.shape[:2], -1)
    return call


VERSIONS: Dict[str, Version] = {
    "plain": plain(),
    **{name: kernel(tp, pw, r9) for name, (r9, tp, pw) in VARIANTS.items()},
    "unfused": unfused,
}


def run(bw: int, versions: Dict[str, Version] = VERSIONS,
        dtype: torch.dtype = torch.bfloat16, seed: int = 0, n: int = r1.N_PAD,
        iters: int = ITERS) -> Dict[str, Tuple[float, float]]:
    """Time ``versions`` (the first is the reference) on the inputs at Bw =
    ``bw`` and ``n`` tokens: {name: (ms, max rel vs the first)}.  Raises
    when a version misses ``baseline_perhead.TOLERANCE``."""
    dev = common.require_cuda()
    ops = inputs(bw, dtype, dev, seed, n=n)
    return common.compare_and_time(
        f"Bw={bw} n={n} {str(dtype).split('.')[-1]}",
        {name: make(*ops) for name, make in versions.items()},
        r1.TOLERANCE[dtype], iters=iters)


def print_bound(bw: int, n: int = r1.N_PAD) -> None:
    bound, by = bound_ms(bw, n, r1.DIM, r1.HEADS, r1.DIM_HEAD, OUT_DIM,
                         torch.bfloat16)
    print(f"bound {bound:.4f} ms ({by}); library call {LIBRARY}", flush=True)


def main(iters: int = ITERS) -> Dict[int, Dict[str, Tuple[float, float]]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results = {}
    for label, bw in r1.CASES.items():
        print(f"=== {label}: {r1.N_PAD} tokens, dim {r1.DIM}, {r1.HEADS} "
              f"heads x {r1.DIM_HEAD}, out {OUT_DIM}, bf16 ===", flush=True)
        results[bw] = r = run(bw, iters=iters)
        print_bound(bw)
        print(f"ws_2pass_pwout / unfused "
              f"{r['ws_2pass_pwout'][0] / r['unfused'][0]:.3f}", flush=True)
    print(json.dumps({"card": card, "ms": {
        bw: {k: v[0] for k, v in r.items()} for bw, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
