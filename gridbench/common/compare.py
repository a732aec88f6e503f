"""The numbers that decide ``correct``, each held to a limit of its
workload file.

Fields (inference): ``rms_gap``, the root mean square of (program -
reference) over the reference's standard deviation, and ``max_gap``, the
largest |program - reference| over the same, each the worst over the
compared batches.

Training: ``pred_rms_gap`` and ``pred_max_gap``, the fields' numbers over
the predictions of every compared step; a leaf's gap, |norm(program) -
norm(reference)| over the larger of the reference leaf's norm and the
median leaf's; ``grad1_gap``, the worst leaf's gap of the first step's
gradient as autograd hands it to each parameter of more than one element,
before the clip; ``change_gap``, the worst leaf's gap of the parameters'
change over the compared steps; ``bn_gap``, the worst leaf's gap of the
BatchNorm running statistics' change. A parameter whose reference gradient
norm is under a thousandth of the median leaf's (a bias ahead of a
BatchNorm) has a gradient of round-off alone, which Adam scales up to a
full step, so it is left out of the gradients' and the changes' numbers.
The relative gaps of each step's loss and rmse (``loss_gap``,
``rmse_gap``) are read for the record: a mean over a whole batch, they
average the rounding of the predictions away and separate neither the
control nor a fault from sound runs. So are the first gradient's
``grad1_scalar_gap``, its one-element leaf, a single sum of terms of both
signs, which the rounding of the predictions moves by up to a half on
sound runs (the clip's global norm would carry that into every leaf, so
``grad1_gap`` is taken before the clip); ``gnorm_gap``, its global norm
(|norm(program) - norm(reference)| over the reference's), which half the
batch leaves as it is; and ``grad1_norm``, the reference's global norm.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, List, Optional, Tuple

from torch import Tensor


def field_gaps(pairs: Iterable[Tuple[Tensor, Tensor]]) -> Dict[str, float]:
    rms = mx = 0.0
    for out, ref in pairs:
        out, ref = out.float(), ref.float()
        scale = float(ref.std())
        diff = (out - ref).nan_to_num(nan=float("inf"))
        rms = max(rms, float(diff.square().mean().sqrt()) / scale)
        mx = max(mx, float(diff.abs().max()) / scale)
    return {"rms_gap": rms, "max_gap": mx}


def step_gap(prog: List[float], ref: List[float]) -> float:
    if len(prog) != len(ref):
        return float("inf")
    gaps = [abs(p - r) / abs(r) if r else abs(p) for p, r in zip(prog, ref)]
    return max(gaps) if all(g == g for g in gaps) else float("inf")


def leaf_gaps(prog: Dict[str, Tensor], ref: Dict[str, Tensor],
              keep: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """{leaf: gap} of two dicts of tensors by their norms."""
    names = list(ref if keep is None else keep)
    ref_n = {k: float(ref[k].float().norm()) for k in names}
    median = statistics.median(ref_n.values()) if names else 0.0
    gaps = {}
    for k in names:
        p = float(prog[k].float().norm()) if k in prog else 0.0
        g = abs(p - ref_n[k]) / max(ref_n[k], median, 1e-30)
        gaps[k] = g if g == g else float("inf")
    return gaps


def global_gap(prog: Dict[str, Tensor], ref: Dict[str, Tensor],
               keep: Iterable[str]) -> float:
    """|global norm(program) - global norm(reference)| over the latter,
    the norms over the leaves ``keep``."""
    names = list(keep)
    r = sum(float(ref[k].float().square().sum()) for k in names) ** 0.5
    p = sum(float(prog[k].float().square().sum()) for k in names
            if k in prog) ** 0.5
    gap = abs(p - r) / max(r, 1e-30)
    return gap if gap == gap else float("inf")


def worst(gaps: Dict[str, float]) -> Tuple[float, str]:
    """(the largest gap, its leaf)."""
    if not gaps:
        return 0.0, ""
    k = max(gaps, key=gaps.get)
    return gaps[k], k


def moved(grads: Dict[str, Tensor]) -> List[str]:
    """The leaves whose gradient norm is at least a thousandth of the
    median leaf's."""
    norms = {k: float(g.float().norm()) for k, g in grads.items()}
    median = statistics.median(norms.values())
    return [k for k, n in norms.items() if n >= 1e-3 * median]


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, dict]]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name, float("inf"))
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value <= limit
    return ok, checks
