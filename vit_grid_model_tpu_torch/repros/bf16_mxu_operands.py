"""R2 on the GPU: bf16 operands for the score and aggregation products.

The counterpart of ``benchmarks/mosaic_repros/repro_bf16_mxu_operands.py``
(R2), which runs R13's ``ws_2pass_pwout`` structure with qn and kn cast to
x's dtype before the score product (``bf16_score``), P and v cast before
P.v (``bf16_agg``), both, or neither (``f32_dots``, ``ws_2pass_pwout``
itself).  At R12/R13's geometry and inputs (``repros/
weightsliced_variants.py``: Bw = 2,880 and 9,000 windows of 56 tokens, dim
128, 32 heads x 32, out 128, bf16) it times each cast variant with CUDA
events beside its own plain version (the casts change the function):

* ``plain <variant>``: ``ops/attention_variants.py::outproj_attention``
  with the variant's casts;
* ``kernel <variant>``: ``ops/cuda/attention_variants.py::
  outproj_attention`` with them, two passes, per-head out-projection, 8
  windows a CTA.  A cast product runs on mma.sync bf16 tiles.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.bf16_mxu_operands
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common
from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

ITERS = 10   # timed calls a version
# the repro's variants: name -> (bf16_score, bf16_agg)
CASTS = {"f32_dots": (False, False), "bf16_score": (True, False),
         "bf16_agg": (False, True), "bf16_both": (True, True)}


def run(bw: int, iters: int = ITERS) -> Dict[str, Tuple[float, float]]:
    """{"plain <variant>" / "kernel <variant>": (ms, max rel vs that
    variant's plain)} at Bw = ``bw``."""
    out = {}
    for name, (score, agg) in CASTS.items():
        casts = {"bf16_score": score, "bf16_agg": agg}
        r = ws.run(bw, {"plain": ws.plain(**casts),
                        "kernel": ws.kernel(True, True, **casts)},
                   iters=iters)
        out.update({f"{v} {name}": t for v, t in r.items()})
    return out


def main(iters: int = ITERS) -> Dict[int, Dict[str, Tuple[float, float]]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results = {}
    for label, bw in r1.CASES.items():
        print(f"=== {label}: {r1.N_PAD} tokens, dim {r1.DIM}, {r1.HEADS} "
              f"heads x {r1.DIM_HEAD}, out {ws.OUT_DIM}, bf16 ===", flush=True)
        results[bw] = r = run(bw, iters)
        ws.print_bound(bw)
        print("kernel <variant> / kernel f32_dots: " + ", ".join(
            f"{name} {r[f'kernel {name}'][0] / r['kernel f32_dots'][0]:.3f}"
            for name in CASTS), flush=True)
    print(json.dumps({"card": card, "ms": {
        bw: {k: v[0] for k, v in r.items()} for bw, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
