"""R15 on the GPU: the fused inference MBConv against cuDNN's separate passes.

The counterpart of ``benchmarks/mosaic_repros/repro_fused_mbconv.py``.  At
42 x 35, 128 -> 512 hidden, SE 128, in bf16, for BN = 384 (the repro's
B = 32 x 12 leads) and BN = 300 (the flagship evaluation, B = 25 x 12), it
times with CUDA events, each with its max error relative to the plain
version:

* ``stock``: the port's MBConv with its BatchNorms folded
  (``ops/mbconv.py``, ``fold_bn=True``; cuDNN convolutions);
* ``plain``: ``ops/mbconv.py::fused_mbconv_reference``;
* ``kernel spb=1`` and ``kernel spb=4``: ``ops/cuda/mbconv.py::fused_mbconv``
  with one and four samples per block.

The block's weights are the model's own layout: a residual MBConv of the
flagship width drawn from a numpy seed (``core/weights.py::seed_module``),
its operands from ``mbconv_kernel_operands``.  Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.fused_mbconv
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.core.weights import seed_module
from vit_grid_model_tpu_torch.ops.cuda.mbconv import fused_mbconv
from vit_grid_model_tpu_torch.ops.mbconv import (MBConvResidual,
                                                 fused_mbconv_reference,
                                                 mbconv_kernel_operands)
from vit_grid_model_tpu_torch.repros import common

H, W = 42, 35                     # the max-pooled 84 x 70 grid
DIM, EXPANSION = 128, 4           # 128 -> 512 hidden, SE 128
CASES = {"repro B=32 x 12 leads": 384, "flagship eval B=25 x 12 leads": 300}
# max|kernel - plain| / max|plain|
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def block(dim: int = DIM, seed: int = 0) -> MBConvResidual:
    """A residual MBConv of width ``dim`` (hidden 4 x dim, SE dim) with
    every weight and BatchNorm statistic drawn from a numpy seed."""
    return seed_module(MBConvResidual(dim, expansion_rate=EXPANSION), seed)


def inputs(n: int, h: int, w: int, c: int, seed: int, dtype: torch.dtype,
           device: torch.device) -> torch.Tensor:
    """Standard-normal NHWC input from a numpy seed."""
    x = np.random.default_rng(seed).standard_normal((n, h, w, c))
    return torch.from_numpy(x.astype(np.float32)).to(device, dtype)


def bound_ms(n: int, h: int, w: int, c: int, hid: int, se: int,
             dtype: torch.dtype) -> Tuple[float, str]:
    """The least time the card could take: the larger of the bytes that
    must move (x read, y written, the f32 operands read once) over the
    memory rate and the products' operations (expand, project, depthwise,
    SE) over the peak rate for the dtype."""
    item = torch.finfo(dtype).bits // 8
    weights = (2 * c * hid + 9 * hid + 2 * hid * se + 3 * hid + se + c) * 4
    moved = 2 * n * h * w * c * item + weights
    ops = n * h * w * (4 * c * hid + 18 * hid) + n * 4 * hid * se
    return common.bound_ms(ops, moved, dtype)


def run(n: int, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
        iters: int = 20) -> Dict[str, Tuple[float, float]]:
    """Time the four versions at BN = ``n``: {name: (ms, max rel vs
    plain)}.  Raises when a kernel misses ``TOLERANCE``."""
    dev = common.require_cuda()
    m = block(seed=seed).to(dev)
    ops = mbconv_kernel_operands(m)
    stock = m.to(dtype)
    x = inputs(n, H, W, DIM, seed + 1, dtype, dev)
    x_nchw = x.permute(0, 3, 1, 2)             # channels_last NCHW view
    versions = {
        "stock": lambda: stock(x_nchw, None, True).permute(0, 2, 3, 1),
        "plain": lambda: fused_mbconv_reference(x, ops),
        "kernel spb=1": lambda: fused_mbconv(x, ops, samples_per_block=1),
        "kernel spb=4": lambda: fused_mbconv(x, ops, samples_per_block=4),
    }
    out = {}
    with torch.inference_mode():
        ref = versions["plain"]()
        for name, fn in versions.items():
            out[name] = common.run_repro(
                f"BN={n} {str(dtype).split('.')[-1]} {name}", fn, ref,
                iters=iters)
        stages = common.kernel_ms(versions["kernel spb=1"])
    print(f"BN={n} kernel spb=1 by stage (torch.profiler): " + (", ".join(
        f"{k} {v:.4f} ms" for k, v in stages.items()) or "no device time"),
        flush=True)
    for name, (_, rel) in out.items():
        if name.startswith("kernel") and not rel <= TOLERANCE[dtype]:
            raise AssertionError(f"BN={n} {name}: max rel {rel} above "
                                 f"{TOLERANCE[dtype]}")
    return out


def main() -> Dict[int, Dict[str, Tuple[float, float]]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results = {}
    for label, n in CASES.items():
        print(f"=== {label}: BN={n}, {H}x{W}, {DIM} -> {DIM * EXPANSION}, "
              f"bf16 ===", flush=True)
        results[n] = run(n)
        bound, by = bound_ms(n, H, W, DIM, DIM * EXPANSION, DIM,
                             torch.bfloat16)
        print(f"bound {bound:.4f} ms ({by}); kernel spb=1 / stock "
              f"{results[n]['kernel spb=1'][0] / results[n]['stock'][0]:.3f}",
              flush=True)
    print(json.dumps({"card": card, "ms": {
        n: {k: v[0] for k, v in r.items()} for n, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
