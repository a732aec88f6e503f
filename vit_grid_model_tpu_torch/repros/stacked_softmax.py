"""R10 on the GPU: one softmax over a group of heads' stacked scores.

The counterpart of ``benchmarks/mosaic_repros/repro_stacked_softmax.py``
(R10), which asks whether one max/exp/sum pass over every head's stacked
scores beats R1's per-head softmax.  At R1's geometry and inputs
(``repros/baseline_perhead.py``: 56 tokens, dim 128, 32 heads x 32, bf16;
Bw = 2,880 and 9,000) it times with CUDA events, each with its max error
relative to the plain version:

* ``plain``: ``ops/attention_variants.py::perhead_qkv_attention``;
* ``kernel``: ``ops/cuda/attention_variants.py::stacked_softmax_attention``
  (4 heads a stack in bf16);
* ``R1 kernel wpc=8``: R1's per-head kernel, the repro's yardstick.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.stacked_softmax
"""

from __future__ import annotations

from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    stacked_softmax_attention)
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1

ITERS = 10   # timed calls a version

KERNELS = {
    "kernel": lambda x, wqkv, bias: (
        lambda: stacked_softmax_attention(x, wqkv, bias)),
    "R1 kernel wpc=8": r1.r1_kernel(8),
}


def main():
    return r1.main(KERNELS, ("kernel", "R1 kernel wpc=8"), iters=ITERS)


if __name__ == "__main__":
    main()
