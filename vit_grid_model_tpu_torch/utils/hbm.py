"""Device-memory exhaustion guard: turn a CUDA out-of-memory error into an
actionable one.

Counterpart of ``vit_grid_model_tpu/utils/hbm.py``.  When a workload does
not fit in the card's memory, PyTorch raises ``torch.cuda.OutOfMemoryError``
with the allocator's state; ``oom_guard`` re-raises it as a one-paragraph
RuntimeError naming the workload, the batch and the card's memory, chained
to the original.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


def is_oom_error(e: BaseException) -> bool:
    """True only for ``torch.cuda.OutOfMemoryError``: an unrelated error
    that merely mentions "out of memory" (a loader's IOError, say) is not
    the card's memory running out."""
    return isinstance(e, torch.cuda.OutOfMemoryError)


@contextlib.contextmanager
def oom_guard(what: str, batch_size: Optional[int] = None,
              device: Optional[torch.device] = None):
    """Wrap a region that allocates on ``device`` (the current CUDA device
    by default); on its memory running out raise a concise RuntimeError
    chained to the original."""
    try:
        yield
    except torch.cuda.OutOfMemoryError as e:
        props = torch.cuda.get_device_properties(device)
        b = f" at batch_size={batch_size}" if batch_size is not None else ""
        raise RuntimeError(
            f"{what}{b} does not fit in the memory of this card "
            f"({props.name}, {props.total_memory / 2 ** 30:.1f} GiB). "
            f"Reduce the batch size or run data parallel over more cards "
            f"(--data_parallel). Original error type: {type(e).__name__}."
        ) from e
