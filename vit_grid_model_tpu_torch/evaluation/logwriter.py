"""Byte-compatible evaluation log writer.

The port's own copy of ``vit_grid_model_tpu/evaluation/logwriter.py``.  It
reproduces the reference's append-mode text log format exactly — the same
'{:.4f}' scalar lines and the same pandas ``to_string`` tables with '1H'..
row names and '> 15'/'> 35'/'> 75' columns (``evaluation_vit.py:203-206,
577-692``) — so diff-based workflows over ``logs/test_{model}.log`` keep
working.
"""

from __future__ import annotations

import os
from typing import TextIO

import numpy as np

from vit_grid_model_tpu_torch.evaluation.metrics import EvaluationMetrics

# (log prefix, metrics-engine predictor key) in the reference's print order
_SCALAR_ORDER = (
    ("persist", "persist"),
    ("model", "model"),
    ("sim 21h", "sim_21h"),
    ("sim avg", "sim_avg"),
)

# (log table title, predictor key); 'MultiAir' is the reference's legacy
# label for the model under evaluation (``evaluation_vit.py:679``)
_TABLE_ORDER = (
    ("persistance model", "persist"),
    ("MultiAir", "model"),
    ("simulation 21h", "sim_21h"),
    ("simulation avg", "sim_avg"),
)


def _table_str(values: np.ndarray, output_dim: int,
               hour_index: bool = True) -> str:
    import pandas as pd

    L = output_dim
    frame = pd.DataFrame({
        "> 15": values[:L],
        "> 35": values[L:2 * L],
        "> 75": values[2 * L:],
    })
    if hour_index:
        frame.index = [f"{i}H" for i in range(1, L + 1)]
    with pd.option_context("display.float_format", "{:.4f}".format):
        return frame.to_string()


def write_log(f: TextIO, metrics: EvaluationMetrics, args_repr: str = "") -> None:
    if args_repr:
        f.write(args_repr)
        f.write("\n")
        f.flush()
    summary = metrics.summary()
    for prefix, key in _SCALAR_ORDER:
        s = summary[key]
        f.write(f"{prefix} total ACC: {s['ACC']:.4f}\n")
        f.write(f"{prefix} total POD: {s['POD']:.4f}\n")
        f.write(f"{prefix} total FAR: {s['FAR']:.4f}\n")
        f.write(f"{prefix} total F1 score: {s['F1']:.4f}\n")
        f.write(f"{prefix} MAE: {s['MAE']:.4f}\n")
        f.write(f"{prefix} RMSE: {s['RMSE']:.4f}\n")
        f.write(f"{prefix} NMB: {s['NMB']:.4f}\n")
        f.write(f"{prefix} NME: {s['NME']:.4f}\n")
        f.write(f"{prefix} R: {s['R']:.4f}\n")
    for title, key in _TABLE_ORDER:
        tables = metrics.lead_tables(key)
        # reference quirk: the sim-avg RMSE/MAE frames never get the
        # 'NH' row index assigned (``evaluation_vit.py:607-613`` covers
        # every other table) and print with a 0..L-1 integer index.
        hour_idx_rmse = key != "sim_avg"
        f.write(f"{title} CSI:\n" + _table_str(tables["CSI"],
                                               metrics.output_dim) + "\n")
        f.write(f"{title} F1:\n" + _table_str(tables["F1"],
                                              metrics.output_dim) + "\n")
        f.write(f"{title} RMSE:\n" + _table_str(
            tables["RMSE"], metrics.output_dim, hour_idx_rmse) + "\n")
        f.write(f"{title} MAE:\n" + _table_str(
            tables["MAE"], metrics.output_dim, hour_idx_rmse) + "\n")
    f.flush()


def open_log(model_name: str, log_dir: str = "logs") -> TextIO:
    """Append-mode log file, reference naming (``evaluation_vit.py:203``)."""
    os.makedirs(log_dir, exist_ok=True)
    return open(os.path.join(log_dir, f"test_{model_name}.log"), "a")
