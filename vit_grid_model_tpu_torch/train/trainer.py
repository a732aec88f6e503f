"""Training step and loop: Focal-R supervised MetNet3, on one device or
data parallel over the ranks of a process group.

Counterpart of ``vit_grid_model_tpu/train/trainer.py``.  One step is, in
the JAX order:

    forward (training mode) -> loss -> grads -> clip by global norm ->
    AdamW at the warmup-cosine learning rate -> BN running statistics
    written back -> EMA

* The model keeps f32 master weights.  A bf16 ``compute_dtype`` casts the
  parameters inside the forward (``model_forward``: ``functional_call``
  with cast parameters), so gradients reach the f32 masters through the
  cast, as ``metnet3_apply`` casts its pytree.  The buffers are not cast:
  the BN statistics computed in bf16 land in the f32 buffers.
* The learning rate is optax's ``warmup_cosine_decay_schedule(0, lr,
  warmup, max(total, warmup + 1))`` at the step count before the update,
  so step 0's rate is 0.
* ``torch.optim.AdamW`` is optax ``adamw`` (b1 0.9, b2 0.999, eps 1e-8,
  decay decoupled and scaled by the learning rate) over every parameter;
  the BN statistics are buffers, so one parameter group leaves them out of
  the decay, as the JAX decay mask does.
* The EMA covers the parameters and the BN running statistics.
* ``remat`` is ``torch.utils.checkpoint`` over the backbone; the dropout
  seeds are drawn outside it, so its recompute makes the same masks.
* Data parallel (``build_train_step(..., group=...)``): every rank gets its
  own rows of the global batch (``parallel/mesh.py::shard_rows``, taken
  before the host assembly) and the global timestamps, which the time
  conditioning reads.  The
  batch-norm statistics span the global batch, each rank's loss is its sum
  over the global count of valid cells, and the gradients are all-reduced
  as a sum: the global batch's loss and gradient, as GSPMD computes them
  on the JAX mesh.  Clipping, AdamW, the BN write-back and the EMA then run
  identically on every rank, so the replicas stay equal; the metrics are
  the global batch's.
* Spans (``utils/profiling.py::annotate``): ``train.step`` holds
  ``train.cast`` (the parameters to the compute dtype), ``train.forward``,
  ``train.loss``, ``train.backward`` (the gradients, with remat's
  recompute, and their all-reduce) and ``train.update`` (global norm,
  clip, AdamW, the BN and EMA copies, the returned metrics);
  ``train_loop``'s logging readback is ``train.log``.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import Tensor
from torch.func import functional_call

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import MetNet3Config, TrainConfig
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.train import losses as L
from vit_grid_model_tpu_torch.utils.hbm import oom_guard
from vit_grid_model_tpu_torch.utils.profiling import annotate


@dataclasses.dataclass
class TrainState:
    model: MetNet3                  # f32 master weights, BN statistics
    optimizer: torch.optim.AdamW
    generator: torch.Generator      # the attention-dropout seeds
    step: int = 0
    # EMA of the parameters and BN statistics (``ema_names``), or None
    ema: Optional[Dict[str, Tensor]] = None


def learning_rate(cfg: TrainConfig, step: int) -> float:
    """optax ``warmup_cosine_decay_schedule(init_value=0, peak_value=lr,
    warmup_steps, decay_steps=max(total, warmup + 1))`` at ``step``."""
    peak, warmup = cfg.learning_rate, cfg.warmup_steps
    if step < warmup:
        return peak * step / warmup
    decay = max(cfg.total_steps, warmup + 1) - warmup
    t = min(step - warmup, decay)
    return peak * 0.5 * (1.0 + math.cos(math.pi * t / decay))


def ema_names(model: MetNet3) -> List[str]:
    """The state_dict entries the EMA covers: every parameter and every BN
    running statistic (the JAX parameter pytree's leaves)."""
    names = [k for k, _ in model.named_parameters()]
    names += [k for k, _ in model.named_buffers()
              if k.endswith(("running_mean", "running_var"))]
    return names


def init_train_state(model: MetNet3, cfg: TrainConfig) -> TrainState:
    """Training mode, AdamW and a dropout generator seeded with
    ``cfg.seed``; the model stays on its device."""
    model.train()
    opt = torch.optim.AdamW(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=cfg.weight_decay)
    ema = None
    if cfg.ema_decay > 0:
        sd = model.state_dict()
        ema = {k: sd[k].detach().clone() for k in ema_names(model)}
    return TrainState(model, opt, torch.Generator().manual_seed(cfg.seed),
                      0, ema)


def model_forward(model: MetNet3, x: Tensor, timestamps: Tensor,
                  dtype: torch.dtype, **kw) -> Tensor:
    """``model(x, timestamps, **kw)`` with its parameters cast to
    ``dtype`` inside the call; the f32 masters receive the gradients."""
    with annotate("train.cast"):
        params = ({} if dtype == torch.float32 else
                  {k: p.to(dtype) for k, p in model.named_parameters()})
    with annotate("train.forward"):
        if not params:
            return model(x, timestamps, **kw)
        return functional_call(model, params, (x, timestamps), kw)


def _to_device(a, device, dtype=None) -> Tensor:
    t = torch.as_tensor(np.asarray(a)) if not torch.is_tensor(a) else a
    return t.to(device=device, dtype=dtype)


def build_train_step(model_cfg: MetNet3Config, train_cfg: TrainConfig,
                     group=None
                     ) -> Callable[[TrainState, dict], Dict[str, Tensor]]:
    """``step(state, batch) -> metrics``, updating ``state`` in place.

    batch: 'x' (B,T,C,H,W) or the NHWC input, 'timestamps' (B,T,4),
    'targets' (B,L,H,W), optional 'mask' (B,L,H,W) bool; numpy arrays or
    tensors.  Metrics are 0-d tensors on the device.  With a process
    ``group``, 'x', 'targets' and 'mask' hold this rank's rows of a global
    batch that divides over the ranks (``parallel/mesh.py::shard_rows``),
    and 'timestamps' the global batch's."""
    loss_kw = {}
    if train_cfg.loss == "focal_r":
        loss_kw = dict(beta=train_cfg.focal_beta, gamma=train_cfg.focal_gamma,
                       focusing=train_cfg.focal_focusing)
    elif train_cfg.loss == "huber":
        loss_kw = dict(delta=10.0)
    loss_fn = L.make_loss(train_cfg.loss, **loss_kw)
    dtype = getattr(torch, model_cfg.compute_dtype)
    max_norm = train_cfg.grad_clip_norm

    def step(state: TrainState, batch) -> Dict[str, Tensor]:
        with annotate("train.step"):
            return _step(state, batch)

    def _step(state: TrainState, batch) -> Dict[str, Tensor]:
        model = state.model
        device = model.up.weight.device
        x = _to_device(batch["x"], device, torch.float32)
        ts = _to_device(batch["timestamps"], device, torch.float32)
        targets = _to_device(batch["targets"], device, torch.float32)
        mask = batch.get("mask")
        if mask is not None:
            mask = _to_device(mask, device, torch.bool)

        bn_stats: list = []
        preds = model_forward(model, x, ts, dtype, generator=state.generator,
                              bn_stats=bn_stats, remat=train_cfg.remat,
                              group=group)
        with annotate("train.loss"):
            loss = loss_fn(preds, targets, mask, group=group)
        with annotate("train.backward"):
            params = list(model.parameters())
            grads = torch.autograd.grad(loss, params, allow_unused=True)
            # an unused parameter gets a zero gradient, as in optax (AdamW
            # then still decays it)
            grads = [torch.zeros_like(p) if g is None else g
                     for p, g in zip(params, grads)]
            if group is not None:
                # one all-reduce of every gradient, flattened: the sum of
                # the ranks' shares is the global batch's gradient
                flat = distributed.all_reduce_sum(
                    torch.cat([g.reshape(-1) for g in grads]), group)
                grads = [f.view_as(g) for f, g in zip(
                    flat.split([g.numel() for g in grads]), grads)]
                loss = distributed.all_reduce_sum(loss.detach(), group)
        with annotate("train.update"):
            preds = preds.detach()
            gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
            # optax clip_by_global_norm: t / norm * max_norm where norm >= max
            clip = gnorm >= max_norm
            for p, g in zip(params, grads):
                p.grad = torch.where(clip, g / gnorm * max_norm, g)
            for param_group in state.optimizer.param_groups:
                param_group["lr"] = learning_rate(train_cfg, state.step)
            state.optimizer.step()
            state.optimizer.zero_grad(set_to_none=True)
            with torch.no_grad():
                for bn, mean, var in bn_stats:
                    bn.running_mean.copy_(mean)
                    bn.running_var.copy_(var)
                if state.ema is not None:
                    d = train_cfg.ema_decay
                    sd = model.state_dict()
                    for k, e in state.ema.items():
                        e.copy_(e * d + sd[k] * (1.0 - d))
            state.step += 1
            if group is None:
                pred_mean = preds.mean()
                mse = torch.mean(torch.square(
                    preds - torch.nan_to_num(targets)))
            else:
                n = preds.numel() * distributed.world_size(group)
                sums = distributed.all_reduce_sum(torch.stack([
                    preds.sum(),
                    torch.square(preds - torch.nan_to_num(targets)).sum()]),
                    group)
                pred_mean, mse = sums[0] / n, sums[1] / n
            return {
                "loss": loss.detach(), "grad_norm": gnorm.detach(),
                "pred_mean": pred_mean, "rmse": torch.sqrt(mse),
            }

    return step


def train_loop(state: TrainState, batches: Iterable, step_fn: Callable, *,
               log_every: int = 10, max_steps: Optional[int] = None,
               log: Callable[[str], None] = print,
               step_seconds: Optional[List[float]] = None) -> TrainState:
    """Drive the step over an iterable of host batches, logging every
    ``log_every`` steps.  With ``step_seconds`` a list, each step waits for
    its loss and appends the host-clock seconds since the previous step
    ended, the wait for its batch included."""
    t0 = time.time()
    roll = [0, t0]       # [step count, timestamp] at the last log line
    last_end = time.perf_counter()
    for i, batch in enumerate(batches):
        if max_steps is not None and i >= max_steps:
            break
        with oom_guard("train step",
                       batch["x"].shape[0]
                       if isinstance(batch, dict) and "x" in batch
                       else None):
            # exhaustion surfaces at the call or at the readbacks below
            metrics = step_fn(state, batch)
            if step_seconds is not None:
                float(metrics["loss"])           # waits for the step
                now = time.perf_counter()
                step_seconds.append(now - last_end)
                last_end = now
            if i % log_every == 0:
                with annotate("train.log"):
                    m = {k: float(v) for k, v in metrics.items()}
                    now = time.time()
                    rate = (i + 1) / (now - t0)
                    # rolling window = the steady state, free of warmup
                    last = ((i + 1 - roll[0]) / max(now - roll[1], 1e-9)
                            if i else 0.0)
                    roll[:] = [i + 1, now]
                    log(f"step {state.step}: loss={m['loss']:.4f} "
                        f"rmse={m['rmse']:.3f} gnorm={m['grad_norm']:.3f} "
                        f"({rate:.2f} steps/s cum, {last:.2f} "
                        f"last-{log_every})")
    return state
