"""Numerics guards and debug helpers.

Counterpart of ``vit_grid_model_tpu/utils/debug.py``:

* ``check_numerics(x, name)``: raises ``NumericsError`` on NaN/Inf with the
  count and the finite range, for a numpy array or a tensor on any device;
* ``debug_nans()``: autograd's anomaly mode with its NaN check over the
  scope;
* ``tree_stats``: per-leaf min/max/mean/NaN count of a nested dict (or a
  state dict), keyed by the path of keys joined with ``/``, as the JAX
  package keys a pytree's paths.
"""

from __future__ import annotations

import contextlib
from typing import Any, Dict

import numpy as np
import torch


class NumericsError(FloatingPointError):
    pass


def _numpy(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.is_floating_point() else x).numpy()
    return np.asarray(x)


def check_numerics(x, name: str = "array") -> None:
    arr = _numpy(x)
    n_nan = int(np.isnan(arr).sum())
    n_inf = int(np.isinf(arr).sum())
    if n_nan or n_inf:
        raise NumericsError(
            f"{name}: {n_nan} NaN / {n_inf} Inf values "
            f"(shape {arr.shape}, finite range "
            f"[{np.nanmin(arr):.4g}, {np.nanmax(arr):.4g}])")


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """Autograd's anomaly mode with its NaN check: a backward pass that
    produces a NaN raises, naming the forward op.  It checks backward
    passes only, where the JAX package's ``jax_debug_nans`` checks every
    op."""
    with torch.autograd.set_detect_anomaly(enable, check_nan=True):
        yield


def _leaves(tree: Any, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    elif tree is not None:
        yield "/".join(path), tree


def tree_stats(tree: Any) -> Dict[str, Dict[str, float]]:
    out = {}
    for key, leaf in _leaves(tree):
        arr = _numpy(leaf)
        out[key] = {
            "shape": tuple(arr.shape),
            "min": float(np.nanmin(arr)) if arr.size else float("nan"),
            "max": float(np.nanmax(arr)) if arr.size else float("nan"),
            "mean": float(np.nanmean(arr)) if arr.size else float("nan"),
            "nan": int(np.isnan(arr).sum()),
        }
    return out
