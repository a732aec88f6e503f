"""R4 on the GPU: the head-major batched window attention.

The counterpart of ``benchmarks/mosaic_repros/repro_headmajor_batched.py``
(R4), which asks whether relaying R1's qkv out head-major and batching the
norm, scores, softmax and P.v over every head beats R1's per-head loop.  At
R1's geometry and inputs (``repros/baseline_perhead.py``: 56 tokens, dim
128, 32 heads x 32, bf16; Bw = 2,880 and 9,000) it times with CUDA events,
each with its max error relative to the plain version:

* ``plain``: ``ops/attention_variants.py::perhead_qkv_attention``;
* ``kernel``: ``ops/cuda/attention_variants.py::headmajor_attention`` at
  its default group (the wgmma design, 2 heads a staged x), and ``kernel
  G=1`` at 1 head a staged x (bit-identical, as both are to R1's kernel);
* ``R1 kernel wpc=8``: R1's per-head kernel (the same wgmma body, x staged
  again for every head), the repro's yardstick.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.headmajor_batched
"""

from __future__ import annotations

from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    headmajor_attention)
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1

ITERS = 10   # timed calls a version

KERNELS = {
    "kernel": lambda x, wqkv, bias: (
        lambda: headmajor_attention(x, wqkv, bias)),
    "kernel G=1": lambda x, wqkv, bias: (
        lambda: headmajor_attention(x, wqkv, bias, 1)),
    "R1 kernel wpc=8": r1.r1_kernel(8),
}


def main():
    return r1.main(KERNELS, ("kernel", "R1 kernel wpc=8"), iters=ITERS)


if __name__ == "__main__":
    main()
