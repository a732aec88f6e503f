"""R3 on the GPU: the q/k norms of a group of heads from one product with a
0/1 indicator.

The counterpart of ``benchmarks/mosaic_repros/repro_crosshead_rmsnorm_gemm.py``
(R3), which takes every head's sums of squares of q and k as one product of
the squared qkv with a block indicator.  On the GPU it runs on R4's
structure (``csrc/crosshead_norm_attention.cu``; in bf16 the per-head
kernel's wgmma body with the norm's product on the tensor cores), so R3
against R4 answers whether that product beats R4's shuffle norm.  At R1's geometry and inputs
(``repros/baseline_perhead.py``: 56 tokens, dim 128, 32 heads x 32, bf16;
Bw = 2,880 and 9,000) it times with CUDA events, each with its max error
relative to the plain version:

* ``plain``: ``ops/attention_variants.py::perhead_qkv_attention`` (R3
  computes R1's function);
* ``kernel``: ``ops/cuda/attention_variants.py::crosshead_norm_attention``
  at its default group (the wgmma design, 2 heads a staged x, as R4), and
  ``kernel G=1`` at 1 head a staged x;
* ``R4 kernel``: ``headmajor_attention`` at its default group;
* ``R1 kernel wpc=8``: R1's per-head kernel, the repro's yardstick.

No single PyTorch call computes the function (SDPA has no qkv product or
l2 norm), so the kernel has no library time.  Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.crosshead_rmsnorm_gemm
"""

from __future__ import annotations

from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    crosshead_norm_attention, headmajor_attention)
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1

ITERS = 10   # timed calls a version
LIBRARY = ("none: no single PyTorch call computes the function (SDPA has "
           "no qkv product or l2 norm)")

KERNELS = {
    "kernel": lambda x, wqkv, bias: (
        lambda: crosshead_norm_attention(x, wqkv, bias)),
    "kernel G=1": lambda x, wqkv, bias: (
        lambda: crosshead_norm_attention(x, wqkv, bias, 1)),
    "R4 kernel": lambda x, wqkv, bias: (
        lambda: headmajor_attention(x, wqkv, bias)),
    "R1 kernel wpc=8": r1.r1_kernel(8),
}


def main():
    print(f"library call {LIBRARY}", flush=True)
    return r1.main(KERNELS, ("kernel", "R4 kernel"), iters=ITERS)


if __name__ == "__main__":
    main()
