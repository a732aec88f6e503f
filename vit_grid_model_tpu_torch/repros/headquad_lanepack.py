"""R6 on the GPU: R5 with four or eight heads a pack.

The counterpart of ``benchmarks/mosaic_repros/repro_headquad_lanepack.py``
(R6), which generalizes R5's pair to K = 4 (the qkv product then spans the
canonical 128 columns) and 8 heads a pack, and whose main runs R5's pair
first.  On the GPU every K runs on the head-pack kernel
(``csrc/headpack_attention.cu``), each head shifted by its own row max.  At
R5's geometry and inputs (``repros/headpair_lanepack.py``) it times with
CUDA events, each with its max error relative to the plain version:

* ``plain``: ``ops/attention_variants.py::outproj_attention``;
* the repro's list: ``pair_2pass_w8``, ``quad_2pass_w8``,
  ``quad_1pass_w8``, ``quad_2pass_w16`` and ``oct_2pass_w8`` (K = 2, 4, 8;
  two passes or one; 8 or 16 windows a CTA), on ``ops/cuda/
  attention_variants.py::headpack_attention``;
* ``ws_2pass_pwout_w8`` and ``unfused``, as in R5's harness.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.headquad_lanepack
"""

from __future__ import annotations

from typing import Dict

from vit_grid_model_tpu_torch.repros import headpair_lanepack as r5
from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

VERSIONS: Dict[str, ws.Version] = {
    "plain": ws.plain(),
    "pair_2pass_w8": r5.kernel(2, True),
    "quad_2pass_w8": r5.kernel(4, True),
    "quad_1pass_w8": r5.kernel(4, False),
    "quad_2pass_w16": r5.kernel(4, True, 16),
    "oct_2pass_w8": r5.kernel(8, True),
    "ws_2pass_pwout_w8": ws.kernel(True, True),
    "unfused": ws.unfused,
}


def main(iters: int = r5.ITERS):
    return r5.main(VERSIONS, iters)


if __name__ == "__main__":
    main()
