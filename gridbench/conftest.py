"""Lets the benchmark's shared tests (``gridbench/tests``), which reach every
cell of ``BENCHMARK.json``, reach the station-to-grid LSTM cell too: a
second model family, with a traffic kind (``grid_infer``), faults and a
size table of its own that ``calibrate.py``, ``traffic/_faults.py`` and
``tests/conftest.py`` predate.

* ``calibrate.FAULTS`` gains ``grid_infer``'s faults, and
  ``traffic/_faults.py::planted`` plants them through
  ``traffic/_grid_faults.py``;
* the ``tiny`` copy cuts that family's configurations to ``GRID_SMALL``,
  since MetNet3's ``TINY`` keys are no field of the grid model.

Once those three files take a second family themselves, this file goes.
"""

from __future__ import annotations

import json
from pathlib import Path

import pytest

from gridbench import calibrate
from gridbench.common import spec
from gridbench.traffic import _faults, _grid_faults

#: the grid model's fields cut so that a forward takes milliseconds
GRID_SMALL = dict(input_dim=4, output_dim=3, prev_len=4, hidden_dim=32,
                  korea_stn_num=6, china_stn_num=3, grid_shape=[6, 5])
GRID_TRAFFIC = "grid_infer"

calibrate.FAULTS.setdefault(GRID_TRAFFIC, _grid_faults.NAMES)
_metnet3_planted = _faults.planted


def _planted(name: str):
    if name in _grid_faults.NAMES:
        return _grid_faults.planted(name)
    return _metnet3_planted(name)


_faults.planted = _planted


def grid_tiny(here: Path, **model) -> Path:
    """The grid family's configurations under ``here`` rewritten from their
    own files, cut to ``GRID_SMALL`` and then to ``model``."""
    for cell in spec.benchmark()["workloads"]:
        if cell["traffic"] == GRID_TRAFFIC:
            conf = spec.config(cell["config"])
            conf["model"].update(GRID_SMALL, **model)
            (here / "configs" / f"{cell['config']}.json").write_text(
                json.dumps(conf))
    return here


@pytest.hookimpl(hookwrapper=True)
def pytest_fixture_setup(fixturedef, request):
    outcome = yield
    if fixturedef.argname == "tiny" and outcome.excinfo is None:
        here = outcome.get_result()
        if isinstance(here, Path):
            grid_tiny(here)
