"""Shared fixtures of the benchmark's own tests, which run on the CPU at a
tiny size (``python -m pytest gridbench/tests``; the card's tests are
marked ``cuda`` and skip without one)."""

from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from gridbench.common import spec  # noqa: E402

#: the model's fields shrunk so that a forward takes milliseconds
TINY = dict(window_size=3, input_height=14, input_width=13,
            n_start_channels=16, end_lead_time=2, n_heads=2, dim_head=8)
CELLS = [c["name"] for c in spec.benchmark()["workloads"]]


def tiny_copy(dest: Path) -> Path:
    """The benchmark's configurations, workloads and readers under
    ``dest``, every model cut to ``TINY`` and every batch to 2.

    A training cell computes in float32 there: the limits are set on the
    card at the cell's own widths, and a tiny model's leaves of 16 to 32
    elements round in bfloat16 by more than a full-width model's (its
    first gradient's worst leaf reads 0.14-0.21 on sound runs), so only
    float32 shows the faults against those limits and nothing else."""
    for sub in ("configs", "workloads"):
        (dest / sub).mkdir(parents=True, exist_ok=True)
    for path in (spec.HERE / "configs").glob("*.json"):
        data = json.loads(path.read_text())
        data["model"].update(TINY)
        (dest / "configs" / path.name).write_text(json.dumps(data))
        data["compute_dtype"] = "float32"
        (dest / "configs" / f"{path.stem}.f32.json").write_text(
            json.dumps(data))
    for path in (spec.HERE / "workloads").glob("*.json"):
        data = json.loads(path.read_text())
        data["batch"] = 2
        if data["traffic"] == "train":
            data["config"] += ".f32"
        (dest / "workloads" / path.name).write_text(json.dumps(data))
    shutil.copytree(spec.HERE / "metrics", dest / "metrics")
    return dest


@pytest.fixture
def tiny(tmp_path):
    return tiny_copy(tmp_path / "tiny")


def run_tiny(here: Path, cell: str, seed: int = 2 ** 31 + 7,
             seconds: float = 0.5, trace: bool = False) -> dict:
    from gridbench.run import run_cell

    return run_cell(cell, seed, seconds, trace, "cpu", time.perf_counter(),
                    here=here)
