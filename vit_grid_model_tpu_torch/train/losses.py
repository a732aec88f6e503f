"""Training objectives, the counterpart of
``vit_grid_model_tpu/train/losses.py``: Focal-R (canonical and sigmoid
focusing, L1 and L2 base), MSE, MAE and Huber, each NaN-aware (NaN targets
drop out of the mean) with an optional boolean mask.

Canonical Focal-R scales each cell's error by ``tanh(0.5 * |beta * e|) **
gamma`` (= ``(2 * sigmoid(beta |e|) - 1) ** gamma``: 0 at e = 0, -> 1 for
large errors); ``focusing="sigmoid"`` is the legacy ``sigmoid(|beta e|) **
gamma``.  The class-head cross-entropy waits for the class head.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import Tensor


def _masked_mean(values: Tensor, mask: Optional[Tensor]) -> Tensor:
    if mask is None:
        return values.mean()
    mask = mask.to(values.dtype)
    return (values * mask).sum() / mask.sum().clamp(min=1.0)


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
                 focusing: str = "canonical") -> Tensor:
    targets, m = _nan_mask(targets, mask)
    err = preds - targets
    weight = focal_r_weight(err, beta=beta, gamma=gamma, focusing=focusing)
    core = err.abs() if base == "l1" else err.square()
    return _masked_mean(weight * core, m)


def mse_loss(preds: Tensor, targets: Tensor,
             mask: Optional[Tensor] = None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    return _masked_mean((preds - targets).square(), m)


def mae_loss(preds: Tensor, targets: Tensor,
             mask: Optional[Tensor] = None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    return _masked_mean((preds - targets).abs(), m)


def huber_loss(preds: Tensor, targets: Tensor, *, delta: float = 10.0,
               mask: Optional[Tensor] = None) -> Tensor:
    targets, m = _nan_mask(targets, mask)
    err = (preds - targets).abs()
    quad = err.clamp(max=delta)
    return _masked_mean(0.5 * quad ** 2 + delta * (err - quad), m)


def make_loss(name: str, **kw) -> Callable[..., Tensor]:
    table = {
        "focal_r": lambda p, t, m=None: focal_r_loss(p, t, mask=m, **kw),
        "mse": lambda p, t, m=None: mse_loss(p, t, m),
        "mae": lambda p, t, m=None: mae_loss(p, t, m),
        "huber": lambda p, t, m=None: huber_loss(p, t, mask=m, **kw),
    }
    return table[name]
