"""The station-to-grid LSTM's operations by the published computation: the
plain reference (``gridbench/reference/grid.py``) run on the meta device
under ``torch.utils.flop_counter.FlopCounterMode``, which counts the
products and nothing elementwise.  The count depends on shapes only, so it
is the same whatever the program fuses or skips.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gridbench.reference import grid as G


def forward_flops(cfg: dict, batch: int) -> int:
    """Operations of one inference forward over ``batch`` samples."""
    z = G.sizes(cfg)
    H, W = cfg["grid_shape"]
    steps = cfg["input_dim"] + cfg["output_dim"]

    def meta(*shape, dtype=torch.float32):
        return torch.zeros(shape, device="meta", dtype=dtype)

    params = {name: meta(*shape)
              for name, (shape, _, _) in G.param_table(cfg).items()}
    coords = {"lats": meta(z["stations"]), "lons": meta(z["stations"]),
              "cmaq_coords": meta(H, W, 2)}
    inputs = dict(
        feats=meta(batch, cfg["input_dim"], z["stations"], cfg["feat_dim"]),
        masks=meta(batch, steps, z["stations"], dtype=torch.bool),
        raw_times=meta(batch, steps, 3),
        prev_vals=meta(batch, cfg["prev_len"], H, W),
        simulation=meta(batch, H, W, steps * z["block"]))
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            G.forward(params, cfg, coords, **inputs)
    return counter.get_total_flops()
