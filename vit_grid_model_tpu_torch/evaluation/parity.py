"""One-command checkpoint-parity gate (``--parity_report``).

The port's own copy of ``vit_grid_model_tpu/evaluation/parity.py``.  The
target (BASELINE.json / BASELINE.md) is: evaluate the shipped
``simulation_vit_model_12hr.pkt`` on the 2023-Q1 reference workload and
match the golden log's test RMSE within 1e-3 (the golden numbers live in
``reference/logs/test_simulation_vit_model_12hr.log:2-37``).  Until the
``.pkt`` and the data are in the repository, the gate runs on synthetic
data against a golden the same CLI wrote with ``--parity_save``.

Baseline file format (JSON)::

    {"rmse_tol": 1e-3,
     "metrics": {"model": {"RMSE": 10.6697, "MAE": 7.1740, ...},
                 "persist": {...}, "sim_21h": {...}, "sim_avg": {...}}}

Only ``metrics.model.RMSE`` gates pass/fail (within ``rmse_tol``); every
other recorded metric is reported informationally with its delta.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Tuple

# Golden-log values of the shipped 12hr checkpoint on the 2023-Q1 workload
# (reference logs/test_simulation_vit_model_12hr.log; table transcribed in
# BASELINE.md).  Predictor keys follow metrics.MetricsEngine.PREDICTORS.
REFERENCE_12HR_BASELINE = {
    "rmse_tol": 1e-3,
    "metrics": {
        "model": {"ACC": 0.7065, "POD": 0.7181, "FAR": 0.3674,
                  "F1": 0.6727, "MAE": 7.1740, "RMSE": 10.6697,
                  "NMB": 8.6624, "NME": 34.8947, "R": 0.8083},
        "persist": {"ACC": 0.7148, "F1": 0.6533, "MAE": 7.3992,
                    "RMSE": 12.8093, "R": 0.7379},
        "sim_21h": {"ACC": 0.6961, "F1": 0.6425, "MAE": 8.1814,
                    "RMSE": 12.8139, "R": 0.7847},
        "sim_avg": {"ACC": 0.7025, "F1": 0.6537, "MAE": 7.7727,
                    "RMSE": 11.9509, "R": 0.8012},
    },
}


def load_baseline(path: str) -> Dict:
    """'reference' -> the built-in golden-log table; else a JSON file."""
    if path == "reference":
        return REFERENCE_12HR_BASELINE
    if not os.path.exists(path):
        raise FileNotFoundError(f"parity baseline not found: {path}")
    with open(path) as f:
        return json.load(f)


def save_baseline(path: str, summary: Dict[str, Dict[str, float]],
                  rmse_tol: float = 1e-3) -> str:
    """Write a run's summary as a baseline file (how the synthetic golden
    for the end-to-end test is produced)."""
    payload = {"rmse_tol": rmse_tol,
               "metrics": {name: {k: round(float(v), 6)
                                  for k, v in vals.items()}
                           for name, vals in summary.items()}}
    with open(path, "w") as f:
        json.dump(payload, f, indent=1)
    return path


def parity_report(summary: Dict[str, Dict[str, float]],
                  baseline: Dict) -> Tuple[List[str], bool]:
    """Compare an evaluation summary against a baseline table.

    Returns (report_lines, passed).  Pass/fail is decided ONLY by the
    model-RMSE gate (|ours - baseline| <= rmse_tol, the BASELINE.json
    contract); all other overlapping metrics are listed with deltas so a
    drift outside the gate is still visible.
    """
    tol = float(baseline.get("rmse_tol", 1e-3))
    base_metrics = baseline["metrics"]
    lines = ["PARITY REPORT (gate: |model RMSE - baseline| <= %g)" % tol]
    gate_delta = None
    for name, base_vals in base_metrics.items():
        ours_vals = summary.get(name)
        if ours_vals is None:
            lines.append(f"  {name}: MISSING from this run")
            continue
        for metric, base_v in base_vals.items():
            if metric not in ours_vals:
                continue
            ours_v = float(ours_vals[metric])
            delta = ours_v - float(base_v)
            mark = ""
            if name == "model" and metric == "RMSE":
                gate_delta = delta
                mark = "  <- GATE " + ("PASS" if abs(delta) <= tol
                                       else "FAIL")
            lines.append(f"  {name:8s} {metric:5s}: ours {ours_v:10.4f}  "
                         f"baseline {float(base_v):10.4f}  "
                         f"delta {delta:+.6f}{mark}")
    if gate_delta is None:
        lines.append("  model RMSE missing from baseline or run -> FAIL")
        return lines, False
    passed = abs(gate_delta) <= tol
    lines.append(f"PARITY {'PASS' if passed else 'FAIL'}: "
                 f"|model RMSE delta| = {abs(gate_delta):.6f} "
                 f"{'<=' if passed else '>'} {tol:g}")
    return lines, passed
