"""Vectorized evaluation-metric engine.

The port's own copy of ``vit_grid_model_tpu/evaluation/metrics.py``.  The
reference accumulates its metrics through ~64 scalar boolean reductions
per batch and stores every predicted value in Python lists for the final
Pearson-R (``evaluation_vit.py:140-575``).  Here the same quantities come
from vectorized confusion matrices and streaming moment sums, so memory is
O(1) in dataset size and each batch update is a handful of numpy reductions
(or can run on-device).  Outputs are numerically identical at the log's 4
decimal places.

Semantics preserved exactly:

* "labels" = predictor's class field, "preds" = ground-truth (reanalysis)
  class field — the reference's confusingly swapped names
  (``evaluation_vit.py:260-263``);
* 4-way confusion per predictor vs truth; ACC = trace / total;
  POD = P(pred >= 2 | truth >= 2); FAR = P(truth < 2 | pred >= 2);
  F1 = 2 POD (1-FAR) / (POD + (1-FAR))  (``evaluation_vit.py:560-570``);
* per-(threshold i, lead j): TP = pred>=i & truth>=i, TN/FP guarded by
  truth > -1 (NaN class), CSI = TP/(TP+FN+FP), F1 = 2TP/(2TP+FN+FP)
  (``evaluation_vit.py:435-453``);
* per-lead RMSE/MAE conditioned on truth class >= i
  (``evaluation_vit.py:455-463``);
* MAE/RMSE over all grid-hours; NMB/NME normalized by sum of truth;
  Pearson-R over all values (streaming moments == the reference's
  centered-list formula) (``evaluation_vit.py:291-324,490-575``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np

N_CLASSES = 4
HIGH = 2          # classes {2, 3} are the POD/FAR "event"


class PearsonMoments:
    """Streaming sufficient statistics for Pearson correlation."""

    def __init__(self):
        self.n = 0
        self.sx = self.sy = self.sxx = self.syy = self.sxy = 0.0

    def update(self, x: np.ndarray, y: np.ndarray) -> None:
        self.n += x.size
        self.sx += x.sum()
        self.sy += y.sum()
        self.sxx += np.square(x).sum()
        self.syy += np.square(y).sum()
        self.sxy += (x * y).sum()

    def r(self, guard: float = 0.0) -> float:
        """``guard`` > 0 clamps the variance product (the station
        evaluation's degenerate samples give ~0 instead of NaN); the grid
        evaluation keeps 0 for reference parity."""
        cov = self.sxy - self.sx * self.sy / self.n
        vx = self.sxx - self.sx ** 2 / self.n
        vy = self.syy - self.sy ** 2 / self.n
        denom = np.sqrt(max(vx * vy, guard) if guard else vx * vy)
        return float(cov / denom)


def assign_class_eval(arr: np.ndarray) -> np.ndarray:
    """The eval driver's local class mapping: default 0 (not -1)
    (``evaluation_vit.py:31-32``)."""
    conds = [(arr > lo) & (arr <= hi)
             for lo, hi in ((-1, 15), (15, 35), (35, 75), (75, np.inf))]
    return np.select(conds, [0, 1, 2, 3], default=0)


@dataclasses.dataclass
class PredictorStats:
    """Streaming accumulators for one predictor vs the shared truth."""

    output_dim: int

    def __post_init__(self):
        L = self.output_dim
        self.confusion = np.zeros((N_CLASSES, N_CLASSES), dtype=np.float64)
        self.lead_tp = np.zeros(3 * L)
        self.lead_tn = np.zeros(3 * L)
        self.lead_fp = np.zeros(3 * L)
        self.lead_fn = np.zeros(3 * L)
        self.lead_sq = np.zeros(3 * L)
        self.lead_abs = np.zeros(3 * L)
        self.abs_sum = 0.0           # sum|pred - truth| (MAE and NME)
        self.sq_sum = 0.0
        self.bias_sum = 0.0          # sum(pred - truth) for NMB
        self.moments = PearsonMoments()   # over every value

    def update(self, pred_vals: np.ndarray, pred_cls: np.ndarray,
               truth_vals: np.ndarray, truth_cls: np.ndarray) -> None:
        """pred/truth vals: (B, L, cells) float; cls: same-shape ints."""
        p = pred_vals.astype(np.float64)
        t = truth_vals.astype(np.float64)
        pc = pred_cls
        tc = truth_cls

        # 4x4 confusion (rows: predictor class, cols: truth class);
        # truth -1 (NaN) rows fall outside and are dropped, matching the
        # boolean-pair sums of the reference.
        valid = (tc >= 0) & (pc >= 0)
        idx = (pc[valid] * N_CLASSES + tc[valid]).ravel()
        self.confusion += np.bincount(
            idx, minlength=N_CLASSES * N_CLASSES
        ).reshape(N_CLASSES, N_CLASSES)

        diffs = p - t
        self.abs_sum += np.abs(diffs).sum()
        self.sq_sum += np.square(diffs).sum()
        self.bias_sum += diffs.sum()
        self.moments.update(p, t)

        L = self.output_dim
        for i in range(1, 4):
            pc_hi = pc >= i
            tc_hi = tc >= i
            tc_ok = tc > -1
            base = (i - 1) * L
            # per-lead sums; axis 0 batch, axis 2 cells
            self.lead_tp[base:base + L] += (pc_hi & tc_hi).sum(axis=(0, 2))
            self.lead_tn[base:base + L] += ((~pc_hi) & (~tc_hi) & tc_ok
                                            ).sum(axis=(0, 2))
            self.lead_fp[base:base + L] += (pc_hi & (~tc_hi) & tc_ok
                                            ).sum(axis=(0, 2))
            self.lead_fn[base:base + L] += ((~pc_hi) & tc_hi).sum(axis=(0, 2))
            sel = tc_hi
            self.lead_sq[base:base + L] += np.where(sel, np.square(diffs), 0.0
                                                    ).sum(axis=(0, 2))
            self.lead_abs[base:base + L] += np.where(sel, np.abs(diffs), 0.0
                                                     ).sum(axis=(0, 2))

    # ---- summary quantities -------------------------------------------

    # With eps=0 (model/persistence parity path) an event-free test window
    # yields the reference's own 0/0 = NaN (``evaluation_vit.py:560-570``);
    # errstate marks that as intended rather than warning spam.

    def acc(self) -> float:
        with np.errstate(invalid="ignore"):
            return float(np.trace(self.confusion) / self.confusion.sum())

    def pod(self, eps: float = 0.0) -> float:
        num = self.confusion[HIGH:, HIGH:].sum()
        den = self.confusion[:, HIGH:].sum() + eps
        with np.errstate(invalid="ignore"):
            return float(num / den)

    def far(self, eps: float = 0.0) -> float:
        num = self.confusion[HIGH:, :HIGH].sum()
        den = self.confusion[HIGH:, :].sum() + eps
        with np.errstate(invalid="ignore"):
            return float(num / den)

    def f1(self, eps: float = 0.0) -> float:
        # numpy scalars, not Python floats: 0/0 must be the reference's
        # quiet NaN (Python float division would raise ZeroDivisionError)
        pod = np.float64(self.pod(eps))
        far = np.float64(self.far(eps))
        with np.errstate(invalid="ignore", divide="ignore"):
            return float(2 * (pod * (1 - far)) / (pod + (1 - far)))

    def mae(self) -> float:
        return float(self.abs_sum / self.moments.n)

    def rmse(self) -> float:
        return float((self.sq_sum / self.moments.n) ** 0.5)

    def nmb(self) -> float:
        return float(self.bias_sum / self.moments.sy * 100.0)

    def nme(self) -> float:
        return float(self.abs_sum / self.moments.sy * 100.0)

    def pearson_r(self) -> float:
        return self.moments.r()

    # The per-(threshold, lead) tables deliberately produce NaN for empty
    # buckets — exactly the reference's 0/0 arithmetic
    # (``evaluation_vit.py:435-463``); errstate silences only the expected
    # warnings so real numeric bugs still warn elsewhere.

    def lead_csi(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.lead_tp / (self.lead_tp + self.lead_fn + self.lead_fp)

    def lead_f1(self) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return 2 * self.lead_tp / (2 * self.lead_tp + self.lead_fn
                                       + self.lead_fp)

    def lead_rmse(self, valid_count: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return np.sqrt(self.lead_sq / valid_count)

    def lead_mae(self, valid_count: np.ndarray) -> np.ndarray:
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.lead_abs / valid_count


class EvaluationMetrics:
    """The four-predictor accumulator of the reference eval loop: model,
    persistence, CMAQ 21h-cycle, CMAQ 4-cycle average, all scored against
    the reanalysis truth (``evaluation_vit.py:239-463``)."""

    PREDICTORS = ("model", "persist", "sim_21h", "sim_avg")

    def __init__(self, output_dim: int):
        self.output_dim = output_dim
        self.stats: Dict[str, PredictorStats] = {
            name: PredictorStats(output_dim) for name in self.PREDICTORS}
        self.valid_count = np.zeros(3 * output_dim)
        self.loss_sum = 0.0
        self.step_cnt = 0
        # quirk #19 bookkeeping (``evaluation_vit.py:285-289``): per-batch
        # encoded YYYYMMDDHH ints of samples with last input hour == 6;
        # filled by the driver only under ``collect_valid_times``
        self.valid_times: list = []

    def update(self, *, model: np.ndarray, persist: np.ndarray,
               sim_21h: np.ndarray, sim_avg: np.ndarray,
               truth: np.ndarray, truth_cls: np.ndarray) -> None:
        """All value arrays (B, L, cells); truth_cls int (B, L, cells)."""
        preds = {"model": model, "persist": persist, "sim_21h": sim_21h,
                 "sim_avg": sim_avg}
        classes = {k: assign_class_eval(v) for k, v in preds.items()}
        for name in self.PREDICTORS:
            self.stats[name].update(preds[name], classes[name], truth,
                                    truth_cls)
        L = self.output_dim
        for i in range(1, 4):
            base = (i - 1) * L
            self.valid_count[base:base + L] += (truth_cls >= i).sum(axis=(0, 2))
        self.loss_sum += float(np.mean((model.astype(np.float64)
                                        - truth.astype(np.float64)) ** 2))
        self.step_cnt += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name in self.PREDICTORS:
            s = self.stats[name]
            eps = 1e-9 if name in ("sim_21h", "sim_avg") else 0.0
            out[name] = {
                "ACC": s.acc(), "POD": s.pod(eps), "FAR": s.far(eps),
                "F1": s.f1(eps), "MAE": s.mae(), "RMSE": s.rmse(),
                "NMB": s.nmb(), "NME": s.nme(), "R": s.pearson_r(),
            }
        return out

    def lead_tables(self, name: str) -> Dict[str, np.ndarray]:
        s = self.stats[name]
        return {
            "CSI": s.lead_csi(),
            "F1": s.lead_f1(),
            "RMSE": s.lead_rmse(self.valid_count),
            "MAE": s.lead_mae(self.valid_count),
        }
