"""Everything the harness finds by name.

* ``BENCHMARK.json`` at the root of the checkout: the metrics and cells;
* ``gridbench/workloads/<cell>.json``: one cell (its configuration, traffic
  kind, batch, queue depth, the entry point's flags, the traced window's
  length and its correctness limits);
* ``gridbench/configs/<config>.json``: one configuration (the model's
  fields, its compute dtype and the peak its MFU divides by);
* ``gridbench/traffic/<kind>.py``: the window driver of a traffic kind;
* ``gridbench/metrics/<metric>.py``: the reader of a per-layer metric.

A later cell, configuration, traffic kind or metric is a new file here and
an entry in ``BENCHMARK.json``; no existing file changes.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import List, Optional

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Optional[Path] = None) -> dict:
    return _json((root or ROOT) / "BENCHMARK.json")


def workload(name: str, here: Optional[Path] = None) -> dict:
    return _json((here or HERE) / "workloads" / f"{name}.json")


def config(name: str, here: Optional[Path] = None) -> dict:
    return _json((here or HERE) / "configs" / f"{name}.json")


def cell_of(bench: dict, name: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == name:
            return cell
    raise KeyError(f"no cell {name!r} in BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def end_to_end(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"] if _reports(m, cell)]


def per_layer(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if cell in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def traffic(kind: str) -> ModuleType:
    return importlib.import_module(f"gridbench.traffic.{kind}")


def reader(name: str, here: Optional[Path] = None) -> ModuleType:
    path = (here or HERE) / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"gridbench_metric_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
