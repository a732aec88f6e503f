"""The model's operations by the published computation: the reference run
on the meta device under ``torch.utils.flop_counter.FlopCounterMode``,
which counts the products (convolutions, matmuls and their backward) and
nothing elementwise.  The count depends on shapes only, so it is the same
whatever the program fuses or skips.
"""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from gridbench.reference import metnet3 as M
from gridbench.reference.train import BUFFER_KINDS, focal_r


def _meta_inputs(cfg: dict, batch: int):
    T, C = cfg["window_size"], cfg["n_variables"]
    H, W = cfg["input_height"], cfg["input_width"]
    meta = torch.device("meta")
    x = torch.empty(batch, T, C, H, W, device=meta)
    ts = torch.ones(batch, T, 4, device=meta)
    return x, ts


def _meta_params(cfg: dict, grad: bool):
    out = {}
    for name, (shape, kind, _) in M.param_table(cfg).items():
        dtype = torch.int64 if kind == "count" else torch.float32
        t = torch.empty(shape, device="meta", dtype=dtype)
        out[name] = t.requires_grad_(grad and kind not in BUFFER_KINDS)
    return out


def forward_flops(cfg: dict, batch: int) -> int:
    """Operations of one inference forward over ``batch`` samples."""
    x, ts = _meta_inputs(cfg, batch)
    params = _meta_params(cfg, grad=False)
    with FlopCounterMode(display=False) as counter:
        with torch.no_grad():
            M.forward(params, cfg, x, ts)
    return counter.get_total_flops()


def train_step_flops(cfg: dict, batch: int) -> int:
    """Operations of one training step's forward and backward over
    ``batch`` samples (dropout on, gradients of every parameter)."""
    x, ts = _meta_inputs(cfg, batch)
    params = _meta_params(cfg, grad=True)
    layers = len(M.layer_dims(cfg["n_start_channels"], M._depth(cfg)))
    targets = torch.empty(batch, cfg["end_lead_time"], cfg["input_height"],
                          cfg["input_width"], device="meta")
    leaves = [p for p in params.values() if p.requires_grad]
    with FlopCounterMode(display=False) as counter:
        preds = M.forward(params, cfg, x, ts, seeds=[1] * (2 * layers),
                          stats={})
        loss = focal_r(preds, targets, 0.2, 1.0)
        torch.autograd.grad(loss, leaves)
    return counter.get_total_flops()
