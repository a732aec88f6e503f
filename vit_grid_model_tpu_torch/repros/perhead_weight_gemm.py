"""R9 on the GPU: per-head weight-sliced qkv products.

The counterpart of ``benchmarks/mosaic_repros/repro_perhead_weight_gemm.py``
(R9), which moves R1's head split from the qkv product's output to its
weight: (dim, 3 * heads * dh) reshaped to (3, heads, dim, dh) outside the
kernel, then one small product per (q|k|v, head).  R1's kernel on the GPU
already has that structure (``csrc/perhead_attention.cu``), so R9 runs on
it at 8 windows a CTA from R9's own weight layout.  At R1's geometry and
inputs (``repros/baseline_perhead.py``: 56 tokens, dim 128, 32 heads x 32,
bf16; Bw = 2,880 and 9,000) it times with CUDA events, each with its max
error relative to the plain version:

* ``plain``: ``ops/attention_variants.py::perhead_qkv_attention``;
* ``kernel``: ``ops/cuda/attention_variants.py::perhead_weight_attention``
  on the (3, heads, dim, dh) weight, made once outside the timing;
* ``R1 kernel wpc=8``: R1's call of the same kernel, the repro's
  yardstick.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.perhead_weight_gemm
"""

from __future__ import annotations

from torch import Tensor

from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    perhead_weight_attention)
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1

ITERS = 10   # timed calls a version


def weight4(wqkv: Tensor, heads: int = r1.HEADS) -> Tensor:
    """R9's weight: R1's (dim, 3 * heads * dh) q | k | v weight as (3,
    heads, dim, dh), as the TPU repro reshapes it (``:67``)."""
    dim = wqkv.shape[0]
    return (wqkv.reshape(dim, 3, heads, -1).permute(1, 2, 0, 3)
            .contiguous())


def _kernel(x: Tensor, wqkv: Tensor, bias: Tensor):
    w4 = weight4(wqkv)
    return lambda: perhead_weight_attention(x, w4, bias)


KERNELS = {"kernel": _kernel, "R1 kernel wpc=8": r1.r1_kernel(8)}


def main():
    return r1.main(KERNELS, ("kernel", "R1 kernel wpc=8"), iters=ITERS)


if __name__ == "__main__":
    main()
