"""The comparison that decides ``correct`` fails what it must: a whole run
on the CPU at a tiny size (the harness's look for a card skipped) with
the program broken underneath comes out not correct, once for each fault
a cell can have; the same run unbroken comes out correct.  And the
control, the reference one step below the configuration's precision in
the program's place, reads above the cell's limits."""

from __future__ import annotations

import pytest
import torch

from gridbench.traffic import _faults as faults
from gridbench.calibrate import FAULTS
from gridbench.common import compare, spec
from gridbench.tests.conftest import CELLS, run_tiny

CASES = [(cell, name) for cell in CELLS
         for name in FAULTS[spec.workload(cell)["traffic"]]]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(tiny, cell):
    result = run_tiny(tiny, cell)
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(tiny, cell, fault):
    with faults.planted(fault):
        result = run_tiny(tiny, cell)
    assert not result["correct"], result["checks"]
    assert result["failed"] == result["attempted"]


def _needs_card(cell):
    """TF32, the f32 control, exists only on the card."""
    conf = spec.config(spec.workload(cell)["config"])
    return conf["compute_dtype"] == "float32"


@pytest.mark.parametrize("cell", [
    pytest.param(c, marks=pytest.mark.cuda) if _needs_card(c) else c
    for c in CELLS])
def test_control_fails(tiny, cell):
    work = spec.workload(cell, tiny)
    # the control is the reference alone, at the configuration's precision
    conf = spec.config(spec.workload(cell)["config"], tiny)
    if _needs_card(cell) and not torch.cuda.is_available():
        pytest.skip("TF32, the f32 control, exists only on the card")
    device = "cuda:0" if torch.cuda.is_available() else "cpu"
    traffic = spec.traffic(work["traffic"])
    numbers = traffic.control(traffic.setup(work, conf, 2 ** 31 + 9, device))
    ok, checks = compare.verdict(numbers, work["limits"])
    assert not ok, checks
