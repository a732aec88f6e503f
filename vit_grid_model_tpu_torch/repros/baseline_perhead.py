"""R1 and R14 on the GPU: the per-head window attention at 8 and 16 windows
a CTA.

The counterpart of ``benchmarks/mosaic_repros/repro_baseline_perhead.py``
(R1, 8 windows a program) and ``repro_16window_tile.py`` (R14, the same
call at 16).  At the repro's geometry (56 tokens, dim 128, 32 heads x 32)
in bf16, for Bw = 2,880 (the repro's eval B = 8) and Bw = 9,000 (the
flagship evaluation, B = 25 x 12 leads x 30 windows), it times with CUDA
events, each with its max error relative to the plain version:

* ``plain``: ``ops/attention_variants.py::perhead_qkv_attention``;
* ``kernel wpc=8`` and ``kernel wpc=16``: ``ops/cuda/attention_variants.py::
  perhead_attention`` at 8 and 16 windows a CTA.

Inputs follow the repro's (standard-normal x and bias, wqkv x 0.05), drawn
from a numpy seed.  ``run`` and ``main`` take other kernels of R1's
function: the R4, R9 and R10 repros time theirs with them, beside R1's
kernel at 8 windows a CTA.  Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.baseline_perhead
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.ops.attention_variants import (
    perhead_qkv_attention)
from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    perhead_attention)
from vit_grid_model_tpu_torch.repros import common

N_PAD, DIM, HEADS, DIM_HEAD = 56, 128, 32, 32
CASES = {"repro Bw=2,880 (eval B=8)": 2880,
         "flagship eval Bw=9,000 (B=25 x 12 leads)": 9000}
WINDOWS_PER_CTA = (8, 16)         # R1, R14
# max|kernel - plain| / max|plain|
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# a kernel version: (x, wqkv, bias) -> the call to time, with any operand it
# needs of its own prepared outside the timing
Kernel = Callable[[torch.Tensor, torch.Tensor, torch.Tensor],
                  Callable[[], torch.Tensor]]


def inputs(bw: int, dtype: torch.dtype, device: torch.device, seed: int = 0,
           n: int = N_PAD, dim: int = DIM, heads: int = HEADS,
           dim_head: int = DIM_HEAD) -> Tuple[torch.Tensor, ...]:
    """(x, wqkv, bias) at the repro's scales from a numpy seed: x (bw, n,
    dim) and wqkv (dim, 3 * heads * dim_head) in ``dtype``, bias (heads, n,
    n) f32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((bw, n, dim), np.float32)
    wqkv = rng.standard_normal((dim, 3 * heads * dim_head), np.float32) * 0.05
    bias = rng.standard_normal((heads, n, n), np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(wqkv).to(device, dtype),
            torch.from_numpy(bias).to(device))


def bound_ms(bw: int, n: int, dim: int, heads: int, dim_head: int,
             dtype: torch.dtype) -> Tuple[float, str]:
    """The least time the card could take: the larger of the products'
    operations (qkv, scores, P.v) over the peak rate for the dtype and the
    bytes that must move (x, wqkv and bias read once, out written once)
    over the memory rate."""
    item = torch.finfo(dtype).bits // 8
    inner = heads * dim_head
    ops = bw * (2 * n * dim * 3 * inner + 4 * heads * n * n * dim_head)
    moved = (bw * n * (dim + inner) * item + 3 * dim * inner * item
             + heads * n * n * 4)
    return common.bound_ms(ops, moved, dtype)


def r1_kernel(windows_per_cta: int) -> Kernel:
    """R1's kernel at ``windows_per_cta`` windows a CTA, as a ``Kernel``."""
    return lambda x, wqkv, bias: (
        lambda: perhead_attention(x, wqkv, bias, windows_per_cta))


KERNELS: Dict[str, Kernel] = {f"kernel wpc={wpc}": r1_kernel(wpc)
                              for wpc in WINDOWS_PER_CTA}


def run(bw: int, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
        iters: int = 20, kernels: Dict[str, Kernel] = KERNELS
        ) -> Dict[str, Tuple[float, float]]:
    """Time the plain version and each of ``kernels`` (by default R1's at 8
    and 16 windows a CTA) at Bw = ``bw``: {name: (ms, max rel vs plain)}.
    Raises when a kernel misses ``TOLERANCE``."""
    dev = common.require_cuda()
    x, wqkv, bias = inputs(bw, dtype, dev, seed)
    versions = {"plain": lambda: perhead_qkv_attention(x, wqkv, bias, HEADS,
                                                       DIM_HEAD)}
    versions.update({name: make(x, wqkv, bias)
                     for name, make in kernels.items()})
    return common.compare_and_time(f"Bw={bw} {str(dtype).split('.')[-1]}",
                                   versions, TOLERANCE[dtype], iters=iters)


def main(kernels: Dict[str, Kernel] = KERNELS,
         ratio: Tuple[str, str] = ("kernel wpc=16", "kernel wpc=8"),
         iters: int = 20) -> Dict[int, Dict[str, Tuple[float, float]]]:
    """Run ``kernels`` at both Bw cases, ``iters`` timed calls each, and
    print each case's bound and the time ratio of the two ``ratio``
    versions; the card line first and a JSON line of the times last."""
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results = {}
    for label, bw in CASES.items():
        print(f"=== {label}: {N_PAD} tokens, dim {DIM}, {HEADS} heads x "
              f"{DIM_HEAD}, bf16 ===", flush=True)
        results[bw] = run(bw, iters=iters, kernels=kernels)
        bound, by = bound_ms(bw, N_PAD, DIM, HEADS, DIM_HEAD, torch.bfloat16)
        r = results[bw]
        print(f"bound {bound:.4f} ms ({by}); {ratio[0]} / {ratio[1]} "
              f"{r[ratio[0]][0] / r[ratio[1]][0]:.3f}", flush=True)
    print(json.dumps({"card": card, "ms": {
        bw: {k: v[0] for k, v in r.items()} for bw, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
