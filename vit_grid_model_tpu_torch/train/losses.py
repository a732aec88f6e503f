"""Training objectives, the counterpart of
``vit_grid_model_tpu/train/losses.py``: Focal-R (canonical and sigmoid
focusing, L1 and L2 base), MSE, MAE and Huber, each NaN-aware (NaN targets
drop out of the mean) with an optional boolean mask.

Canonical Focal-R scales each cell's error by ``tanh(0.5 * |beta * e|) **
gamma`` (= ``(2 * sigmoid(beta |e|) - 1) ** gamma``: 0 at e = 0, -> 1 for
large errors); ``focusing="sigmoid"`` is the legacy ``sigmoid(|beta e|) **
gamma``.  The class heads' losses are the bucketized cross-entropy
``pm_class_cross_entropy`` and the regional ``regional_mse_loss``; their
logits keep PyTorch's class axis, (N, C, ...), where JAX's are channel-last.

Data parallel: given a process ``group``, each loss takes this rank's rows
and returns this rank's share of the global masked mean, its own sum over
the count of valid cells in the whole global batch, so that the shares sum
over the ranks to the loss of the global batch, and their gradients to its
gradient.  (An average of per-rank means is another loss whenever the ranks
hold different numbers of valid targets.)
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

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


def pm_class_cross_entropy(logits: Tensor, targets: Tensor,
                           boundaries: Sequence[float]) -> Tensor:
    """The class head's loss: continuous PM targets (N, ...) bucketized by
    the class boundaries (class = the number of boundaries below the
    target), cross-entropy of the logits (N, C, ...) over the class axis,
    NaN targets left out of the mean."""
    b = torch.as_tensor(boundaries, dtype=targets.dtype,
                        device=targets.device)
    valid = torch.isfinite(targets)
    labels = torch.bucketize(targets, b, right=False)
    labels = torch.where(valid, labels, torch.zeros_like(labels))
    logp = torch.log_softmax(logits, dim=1)
    nll = -logp.gather(1, labels.unsqueeze(1)).squeeze(1)
    return _masked_mean(nll, valid)


def regional_mse_loss(region_preds: Tensor, region_targets: Tensor) -> Tensor:
    """The regional regression heads' loss: MSE over non-NaN targets."""
    return mse_loss(region_preds, region_targets)


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
