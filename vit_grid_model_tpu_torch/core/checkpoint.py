"""Checkpoints of the port's training: the full train state for an exact
resume, and plain ``state_dict`` files.

The counterpart of ``vit_grid_model_tpu/core/checkpoint.py``'s
``save_train_state`` / ``restore_train_state`` / ``save_params``.  A train
state file holds the model's state_dict, the AdamW moments and step counts,
the schedule step, the dropout generator's state and the EMA.  A ``.pkt``
is a plain state_dict with the keys of ``core/torch_export.py``, which the
port loads with ``core/weights.py::load_reference_checkpoint`` and the JAX
evaluation CLI through ``core/torch_import``.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.train.trainer import TrainState


def _cpu(sd: Dict[str, Tensor]) -> Dict[str, Tensor]:
    return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}


def save_state_dict(path: str, model: MetNet3,
                    override: Dict[str, Tensor] = None) -> str:
    """The model's state_dict (entries of ``override`` replacing its own,
    e.g. an EMA) as a ``.pkt``."""
    sd = dict(model.state_dict())
    sd.update(override or {})
    torch.save(_cpu(sd), path)
    return path


def save_train_state(path: str, state: TrainState) -> str:
    torch.save({
        "model": _cpu(state.model.state_dict()),
        "optimizer": state.optimizer.state_dict(),
        "step": state.step,
        "generator": state.generator.get_state(),
        "ema": None if state.ema is None else _cpu(state.ema),
    }, path)
    return path


def restore_train_state(path: str, state: TrainState) -> TrainState:
    """Load a saved train state into ``state`` (built by
    ``init_train_state`` for the same model and config) in place."""
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
    return state
