"""R8 on the GPU: the token padding and the windows a CTA.

The counterpart of ``benchmarks/mosaic_repros/repro_npad_and_kfold.py``
(R8), which runs R13's ``ws_2pass_pwout`` structure at n_pad 64 and 56
(inputs drawn at each n_pad, so 64 is another n, not a masked one) and
folds kfold in {1, 2, 4} chunks of 8 windows into one program.  On the GPU
kfold is the windows a CTA, 8 * kfold, on the out-projection kernel
(``csrc/outproj_attention.cu``), whose CTA runs its windows in turn.  At
R12/R13's geometry (``repros/weightsliced_variants.py``: Bw = 2,880 and
9,000, dim 128, 32 heads x 32, out 128, bf16) it times with CUDA events,
for each n_pad, each with its max error relative to the plain version:

* ``plain``: ``ops/attention_variants.py::outproj_attention``;
* ``kfold=1``, ``kfold=2``, ``kfold=4``: ``ops/cuda/attention_variants.py::
  outproj_attention`` at 8, 16 and 32 windows a CTA.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.npad_and_kfold
"""

from __future__ import annotations

import json
from typing import Dict, Tuple

from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common
from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

ITERS = 10   # timed calls a version
N_PADS = (64, 56)
KFOLDS = (1, 2, 4)
BLK = 8      # windows a chunk


def run(bw: int, n_pad: int,
        iters: int = ITERS) -> Dict[str, Tuple[float, float]]:
    return ws.run(bw, {"plain": ws.plain(), **{
        f"kfold={k}": ws.kernel(True, True, windows_per_cta=BLK * k)
        for k in KFOLDS}}, n=n_pad, iters=iters)


def main(iters: int = ITERS
         ) -> Dict[int, Dict[int, Dict[str, Tuple[float, float]]]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results: Dict[int, Dict[int, Dict[str, Tuple[float, float]]]] = {}
    for label, bw in r1.CASES.items():
        results[bw] = {}
        for n_pad in N_PADS:
            print(f"=== {label}: n_pad {n_pad}, dim {r1.DIM}, {r1.HEADS} "
                  f"heads x {r1.DIM_HEAD}, out {ws.OUT_DIM}, bf16 ===",
                  flush=True)
            results[bw][n_pad] = r = run(bw, n_pad, iters)
            ws.print_bound(bw, n_pad, r)
            print(f"kernel launches: {ws.occupancy_line(n_pad)}",
                  flush=True)
            print("kfold=k / kfold=1: " + ", ".join(
                f"{k} {r[f'kfold={k}'][0] / r['kfold=1'][0]:.3f}"
                for k in KFOLDS), flush=True)
    print(json.dumps({"card": card, "ms": {
        bw: {n: {k: v[0] for k, v in r.items()} for n, r in by_n.items()}
        for bw, by_n in results.items()}}))
    return results


if __name__ == "__main__":
    main()
