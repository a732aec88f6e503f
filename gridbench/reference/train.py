"""The plain reference of the training step: Focal-R over the reference
forward in training mode, gradients by autograd in float32, clipping by
global norm, AdamW at the warm-up-cosine rate, and the BatchNorm running
statistics written after the update.

* Focal-R (canonical, L1 base): each cell's |e| weighted by
  tanh(0.5 |beta e|) ** gamma, the mean over the cells whose target is
  finite;
* clipping: every gradient times max_norm / norm where the global norm is
  at least max_norm;
* AdamW (b1 0.9, b2 0.999, eps 1e-8): the parameter first decays by
  lr * weight_decay, then moves by lr / (1 - b1^t) * m / (sqrt(v / (1 -
  b2^t)) + eps);
* the rate: 0 -> lr linearly over the warm-up steps, then a cosine decay
  to 0 at max(total, warmup + 1), taken at the step count before the
  update;
* the dropout seeds: two per MaxViT layer and step, drawn as
  ``torch.randint(0, 2**31 - 1, (2 * layers,))`` from a CPU generator
  seeded with the training seed.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import torch
from torch import Tensor

from gridbench.reference import metnet3 as M

BUFFER_KINDS = ("running_mean", "running_var", "count", "boundaries")


def focal_r(preds: Tensor, targets: Tensor, beta: float, gamma: float
            ) -> Tensor:
    finite = torch.isfinite(targets)
    err = preds - torch.where(finite, targets, torch.zeros_like(targets))
    core = torch.tanh(0.5 * (beta * err).abs()) ** gamma * err.abs()
    m = finite.float()
    return (core * m).sum() / m.sum().clamp(min=1.0)


def learning_rate(tc: dict, step: int) -> float:
    peak, warmup = tc["learning_rate"], tc["warmup_steps"]
    if step < warmup:
        return peak * step / warmup
    decay = max(tc["total_steps"], warmup + 1) - warmup
    t = min(step - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def split(table, state: Dict[str, Tensor]):
    """(parameters, buffers) of a state dict by the reference's table."""
    params, buffers = {}, {}
    for k, v in state.items():
        (buffers if table[k][1] in BUFFER_KINDS else params)[k] = v
    return params, buffers


def run_steps(cfg: dict, tc: dict, state: Dict[str, Tensor],
              batches: Sequence[dict], seed: int,
              prec: M.Precision = M.Precision()) -> dict:
    """Train a float32 copy of ``state`` over ``batches`` (dicts of 'x'
    (B, T, C, H, W), 'timestamps', 'targets').  Returns per step the
    'loss', the step metrics 'rmse' and 'pred_mean', the predictions
    'preds' (on the CPU), the gradient of the first step before the clip
    'grad1' {name: tensor}, and 'state' after the last step (parameters
    and running statistics)."""
    table = M.param_table(cfg)
    params, buffers = split(table, {k: v.detach().float().clone()
                                    for k, v in state.items()})
    names = list(params)
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    gen = torch.Generator().manual_seed(seed)
    layers = len(M.layer_dims(cfg["n_start_channels"], M._depth(cfg)))
    b1, b2, eps = 0.9, 0.999, 1e-8
    out: dict = {"loss": [], "rmse": [], "pred_mean": [], "preds": []}
    for step, batch in enumerate(batches):
        seeds = torch.randint(0, 2 ** 31 - 1, (2 * layers,),
                              generator=gen).tolist()
        leaves = {k: p.requires_grad_(True) for k, p in params.items()}
        stats: Dict[str, Tensor] = {}
        preds = M.forward({**leaves, **buffers}, cfg, batch["x"],
                          batch["timestamps"], seeds=seeds, stats=stats,
                          prec=prec)
        targets = batch["targets"].float()
        loss = focal_r(preds, targets, tc["focal_beta"], tc["focal_gamma"])
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        with torch.no_grad():
            if step == 0:
                out["grad1"] = {k: g.clone() for k, g in zip(names, grads)}
            norm = torch.sqrt(sum(g.square().sum() for g in grads))
            if float(norm) >= tc["grad_clip_norm"]:
                grads = [g / norm * tc["grad_clip_norm"] for g in grads]
            lr = learning_rate(tc, step)
            t = step + 1
            for k, g in zip(names, grads):
                p = params[k].detach()
                p = p * (1.0 - lr * tc["weight_decay"])
                m[k] = b1 * m[k] + (1 - b1) * g
                v2[k] = b2 * v2[k] + (1 - b2) * g * g
                denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)) + eps
                params[k] = p - (lr / (1 - b1 ** t)) * m[k] / denom
            buffers.update(stats)
            out["loss"].append(float(loss))
            out["rmse"].append(float(torch.sqrt(torch.mean(
                (preds - torch.nan_to_num(targets)).square()))))
            out["pred_mean"].append(float(preds.mean()))
            out["preds"].append(preds.detach().float().cpu())
        del preds, loss, grads, leaves
    out["state"] = {**params, **buffers}
    return out

