"""R5 on the GPU: R1's attention with the out-projection, two heads a pack.

The counterpart of ``benchmarks/mosaic_repros/repro_headpair_lanepack.py``
(R5), which packs two heads' score rows side by side in the TPU's lanes,
shifts each packed row by the pair's joint max, and runs one out-product a
pair summed in f32.  On the GPU it runs on the head-pack kernel
(``csrc/headpack_attention.cu``): a pack's q|k|v from one product and one
out-product a pack, each head shifted by its own row max.  At R12/R13's
geometry and inputs (``repros/weightsliced_variants.py``: 56 tokens, dim
128, 32 heads x 32, out 128, bf16; Bw = 2,880 and 9,000) it times with CUDA
events, each with its max error relative to the plain version:

* ``plain``: ``ops/attention_variants.py::outproj_attention``;
* ``pair_2pass_w8``, ``pair_1pass_w8``, ``pair_2pass_w16``: the repro's
  list, ``ops/cuda/attention_variants.py::headpack_attention`` at K = 2 in
  two passes or one, 8 or 16 windows a CTA;
* ``ws_2pass_pwout_w8`` and ``_w16``: the out-projection kernel's
  ``ws_2pass_pwout``, the repro's own baseline;
* ``unfused``: R1's kernel + one cuBLAS out-projection, the yardstick.

The kernel takes R4's per-head weight slices and the unpacked bias: a
pack's heads are consecutive in both, so the repro's packed layouts buy
nothing here.  ``main`` takes other versions: the R6 harness times its own
with it.  Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.headpair_lanepack
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

import torch

from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common
from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

ITERS = 10   # timed calls a version


def kernel(k_pack: int, two_pass: bool,
           windows_per_cta: int = 8) -> ws.Version:
    """The head-pack kernel at these choices, from R1's weight."""
    def make(x, wqkv, bias, wout):
        return lambda: av.headpack_attention(
            x, wqkv, bias, wout, k_pack=k_pack, two_pass=two_pass,
            windows_per_cta=windows_per_cta)
    return make


def bound_ms(bw: int) -> Tuple[float, str]:
    """The function's bound at the repros' shape (``weightsliced_variants.
    bound_ms``): the packing changes no product's operations."""
    return ws.bound_ms(bw, r1.N_PAD, r1.DIM, r1.HEADS, r1.DIM_HEAD,
                       ws.OUT_DIM, torch.bfloat16)


VERSIONS: Dict[str, ws.Version] = {
    "plain": ws.plain(),
    "pair_2pass_w8": kernel(2, True),
    "pair_1pass_w8": kernel(2, False),
    "pair_2pass_w16": kernel(2, True, 16),
    "ws_2pass_pwout_w8": ws.kernel(True, True),
    "ws_2pass_pwout_w16": ws.kernel(True, True, windows_per_cta=16),
    "unfused": ws.unfused,
}


def main(versions: Dict[str, ws.Version] = VERSIONS, iters: int = ITERS
         ) -> Dict[int, Dict[str, Tuple[float, float]]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results = {}
    for label, bw in r1.CASES.items():
        print(f"=== {label}: {r1.N_PAD} tokens, dim {r1.DIM}, {r1.HEADS} "
              f"heads x {r1.DIM_HEAD}, out {ws.OUT_DIM}, bf16 ===", flush=True)
        results[bw] = r = ws.run(bw, versions, iters=iters)
        bound, by = bound_ms(bw)
        print(f"bound {bound:.4f} ms ({by}); library call {ws.LIBRARY}",
              flush=True)
        base, yard = r["ws_2pass_pwout_w8"][0], r["unfused"][0]
        print("/ ws_2pass_pwout_w8, / unfused: " + ", ".join(
            f"{name} {ms / base:.3f} {ms / yard:.3f}"
            for name, (ms, _) in r.items()
            if name not in ("plain", "ws_2pass_pwout_w8", "unfused")),
            flush=True)
    print(json.dumps({"card": card, "ms": {
        bw: {k: v[0] for k, v in r.items()} for bw, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
