"""Faults planted in the program under test, to show that the comparison
catches them: ``gridbench/calibrate.py`` reads them on the card, the tests
on the CPU.  Each is a context manager that patches the program while
inside.

* ``altered``: an answer altered where it is produced: the forward's
  field of sample 0 at lead 1 replaced by its field at lead 2;
* ``half_batch``: half of the batch left out, the mean taken over the
  rest: the forward computes the first half of the rows and repeats it
  (inference), or the loss averages over the first half only (training);
* ``frozen``: a train step that returns its state unchanged.

The benchmark's runs never import this module.
"""

from __future__ import annotations

import contextlib

import torch

from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.train import losses, trainer

NAMES = ("altered", "half_batch", "frozen")


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def _altered_forward(forward):
    def patched(self, x, timestamps, **kw):
        out = forward(self, x, timestamps, **kw)
        if out.dim() == 4 and out.shape[1] > 1:
            out = out.clone()
            out[0, 0] = out[0, 1]
        return out
    return patched


def _half_forward(forward):
    def patched(self, x, timestamps, **kw):
        if self.training:
            return forward(self, x, timestamps, **kw)
        half = (x.shape[0] + 1) // 2
        out = forward(self, x[:half], timestamps[:half], **kw)
        return torch.cat([out, out])[:x.shape[0]]
    return patched


def _half_loss(make_loss):
    def patched(name, **kw):
        loss = make_loss(name, **kw)

        def half(preds, targets, mask=None, group=None):
            h = (preds.shape[0] + 1) // 2
            return loss(preds[:h], targets[:h],
                        None if mask is None else mask[:h], group)
        return half
    return patched


def _frozen_step(build):
    def patched(*args, **kw):
        step = build(*args, **kw)

        def frozen(state, batch):
            saved = {k: v.clone() for k, v in state.model.state_dict().items()}
            metrics = step(state, batch)
            state.model.load_state_dict(saved)
            state.optimizer.state.clear()
            return metrics
        return frozen
    return patched


@contextlib.contextmanager
def planted(name: str):
    if name == "altered":
        with _patched(MetNet3, "forward", _altered_forward(MetNet3.forward)):
            yield
    elif name == "half_batch":
        with _patched(MetNet3, "forward", _half_forward(MetNet3.forward)), \
                _patched(losses, "make_loss", _half_loss(losses.make_loss)):
            yield
    elif name == "frozen":
        with _patched(trainer, "build_train_step",
                      _frozen_step(trainer.build_train_step)):
            yield
    else:
        raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
