"""Training objectives, the counterpart of
``vit_grid_model_tpu/train/losses.py``: Focal-R (canonical and sigmoid
focusing, L1 and L2 base), MSE, MAE and Huber, each NaN-aware (NaN targets
drop out of the mean) with an optional boolean mask.

Canonical Focal-R scales each cell's error by ``tanh(0.5 * |beta * e|) **
gamma`` (= ``(2 * sigmoid(beta |e|) - 1) ** gamma``: 0 at e = 0, -> 1 for
large errors); ``focusing="sigmoid"`` is the legacy ``sigmoid(|beta e|) **
gamma``.  The class-head cross-entropy waits for the class head.

Data parallel: given a process ``group``, each loss takes this rank's rows
and returns this rank's share of the global masked mean, its own sum over
the count of valid cells in the whole global batch, so that the shares sum
over the ranks to the loss of the global batch, and their gradients to its
gradient.  (An average of per-rank means is another loss whenever the ranks
hold different numbers of valid targets.)
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.core import distributed


def _masked_mean(values: Tensor, mask: Optional[Tensor],
                 group=None) -> Tensor:
    if mask is None:
        if group is None:
            return values.mean()
        mask = torch.ones_like(values)
    mask = mask.to(values.dtype)
    count = mask.sum()
    if group is not None:
        count = distributed.all_reduce_sum(count, group)
    return (values * mask).sum() / count.clamp(min=1.0)


def _nan_mask(targets: Tensor, mask: Optional[Tensor]) -> Tuple[Tensor,
                                                                 Tensor]:
    finite = torch.isfinite(targets)
    targets = torch.where(finite, targets, torch.zeros_like(targets))
    m = finite if mask is None else (finite & mask.bool())
    return targets, m


def focal_r_weight(err: Tensor, *, beta: float = 0.2, gamma: float = 1.0,
                   focusing: str = "canonical") -> Tensor:
    ae = (beta * err).abs()
    if focusing == "canonical":
        w = torch.tanh(0.5 * ae)
    elif focusing == "sigmoid":
        w = torch.sigmoid(ae)
    else:
        raise ValueError(f"unknown focal focusing form: {focusing!r}")
    return w ** gamma


def focal_r_loss(preds: Tensor, targets: Tensor, *,
                 mask: Optional[Tensor] = None, beta: float = 0.2,
                 gamma: float = 1.0, base: str = "l1",
                 focusing: str = "canonical", group=None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    err = preds - targets
    weight = focal_r_weight(err, beta=beta, gamma=gamma, focusing=focusing)
    core = err.abs() if base == "l1" else err.square()
    return _masked_mean(weight * core, m, group)


def mse_loss(preds: Tensor, targets: Tensor,
             mask: Optional[Tensor] = None, group=None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    return _masked_mean((preds - targets).square(), m, group)


def mae_loss(preds: Tensor, targets: Tensor,
             mask: Optional[Tensor] = None, group=None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    return _masked_mean((preds - targets).abs(), m, group)


def huber_loss(preds: Tensor, targets: Tensor, *, delta: float = 10.0,
               mask: Optional[Tensor] = None, group=None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    err = (preds - targets).abs()
    quad = err.clamp(max=delta)
    return _masked_mean(0.5 * quad ** 2 + delta * (err - quad), m, group)


def make_loss(name: str, **kw) -> Callable[..., Tensor]:
    """``loss(preds, targets, mask=None, group=None)``."""
    table = {
        "focal_r": lambda p, t, m=None, group=None: focal_r_loss(
            p, t, mask=m, group=group, **kw),
        "mse": lambda p, t, m=None, group=None: mse_loss(p, t, m, group),
        "mae": lambda p, t, m=None, group=None: mae_loss(p, t, m, group),
        "huber": lambda p, t, m=None, group=None: huber_loss(
            p, t, mask=m, group=group, **kw),
    }
    return table[name]
