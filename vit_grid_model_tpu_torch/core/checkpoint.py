"""Checkpoints of the port's training: the full train state for an exact
resume, and plain ``state_dict`` files.

The counterpart of ``vit_grid_model_tpu/core/checkpoint.py``'s
``save_train_state`` / ``restore_train_state`` / ``save_params``.  A train
state file holds the model's state_dict, the AdamW moments and step counts,
the schedule step, the dropout generator's state and the EMA.  A ``.pkt``
is a plain state_dict with the keys of ``core/torch_export.py``, which the
port loads with ``core/weights.py::load_reference_checkpoint`` and the JAX
evaluation CLI through ``core/torch_import``.  A quantized model's
``.pkt`` also holds its int8 sidecars (``*.proj_q.*``, ``ops/quantize.py``),
which ``load_reference_checkpoint`` gives the model it builds at the same
sites before its strict load.

Data parallel (a process ``group``): only rank 0 writes, and every rank
waits at a barrier until the file is there; a restore loads the file on
every rank and checks that the replicas then agree.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.distributed as dist
from torch import Tensor

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.train.trainer import TrainState


def _cpu(sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def _save(obj, path: str, group) -> str:
    """``torch.save`` on rank 0, then a barrier for every rank."""
    if distributed.is_primary(group):
        torch.save(obj, path)
    if group is not None:
        dist.barrier(group=group)
    return path


def save_state_dict(path: str, model: MetNet3,
                    override: Dict[str, Tensor] = None, group=None) -> str:
    """The model's state_dict (entries of ``override`` replacing its own,
    e.g. an EMA) as a ``.pkt``."""
    sd = dict(model.state_dict())
    sd.update(override or {})
    return _save(_cpu(sd), path, group)


def save_train_state(path: str, state: TrainState, group=None) -> str:
    return _save({
        "model": _cpu(state.model.state_dict()),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "generator": state.generator.get_state(),
        "ema": None if state.ema is None else _cpu(state.ema),
    }, path, group)


def restore_train_state(path: str, state: TrainState,
                        group=None) -> TrainState:
    """Load a saved train state into ``state`` (built by
    ``init_train_state`` for the same model and config) in place; with a
    process ``group``, on every rank, raising unless the replicas agree."""
    saved = torch.load(path, map_location="cpu", weights_only=True)
    state.model.load_state_dict(saved["model"], strict=True)
    state.optimizer.load_state_dict(saved["optimizer"])
    state.step = int(saved["step"])
    state.generator.set_state(saved["generator"])
    if (saved["ema"] is None) != (state.ema is None):
        raise ValueError(f"{path}: EMA presence differs from the config")
    if state.ema is not None:
        for k, e in state.ema.items():
            e.copy_(saved["ema"][k])
    if group is not None:
        distributed.assert_replicas_equal(state.model, group)
    return state
