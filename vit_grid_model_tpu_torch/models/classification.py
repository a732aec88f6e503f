"""Class <-> value mapping of the class heads.

Counterpart of ``vit_grid_model_tpu/models/classification.py``.
"""

from __future__ import annotations

import torch
from torch import Tensor


def categorical_to_continuous(categorical: Tensor,
                              class_boundaries) -> Tensor:
    """Boundary-midpoint decoding of categorical PM classes: class 0 ->
    half the first boundary, interior classes -> the midpoint of their
    boundaries, the last class -> the last boundary value.  Class ids are
    clipped to the table."""
    b = torch.as_tensor(class_boundaries, dtype=torch.float32,
                        device=categorical.device)
    table = torch.cat([b[:1] / 2.0, (b[:-1] + b[1:]) / 2.0, b[-1:]])
    return table[categorical.clamp(0, table.shape[0] - 1)]
