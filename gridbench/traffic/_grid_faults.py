"""Faults planted in the station-to-grid LSTM, to show that the comparison
catches them: ``gridbench/calibrate_grid.py`` reads them on the card, the
tests on the CPU.  Each is a context manager that patches the program
while inside.

* ``no_stations``: the joint attention over the grid tokens alone, the
  station tokens dropped from its keys;
* ``input_block``: the output window's grid steps read the CMAQ block of
  step ``i``, the input window's, where they read ``i + input_dim``.

The benchmark's runs never import this module.
"""

from __future__ import annotations

import contextlib

import torch

from vit_grid_model_tpu_torch.models.legacy import grid
from vit_grid_model_tpu_torch.ops.recurrent import mha_self_attention

NAMES = ("no_stations", "input_block")


def _grid_only(mha, grid_h, stn_h, stn_valid):
    return torch.cat([grid_h + mha_self_attention(mha, grid_h), stn_h],
                     dim=1)


def _input_block(step_input):
    def patched(self, simulation, step, *args, **kw):
        if step >= self.spec.input_dim:
            step -= self.spec.input_dim
        return step_input(self, simulation, step, *args, **kw)
    return patched


@contextlib.contextmanager
def _patched(owner, name, value):
    saved = getattr(owner, name)
    setattr(owner, name, value)
    try:
        yield
    finally:
        setattr(owner, name, saved)


def planted(name: str):
    if name == "no_stations":
        return _patched(grid, "joint_attention", _grid_only)
    if name == "input_block":
        return _patched(grid.GridModel, "_grid_step_input",
                        _input_block(grid.GridModel._grid_step_input))
    raise ValueError(f"unknown fault {name!r}; one of {NAMES}")
