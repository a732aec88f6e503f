"""Refcount-probing pool for large host-side staging buffers.

The port's own copy of ``vit_grid_model_tpu/data/bufferpool.py``.  A fresh
multi-hundred-MB ``np.empty`` is a new anonymous mmap whose first-touch
page faults serialize in the kernel; the loader and the staging path would
pay that on every batch.  ``get`` returns a pooled array only when the pool
holds the ONLY reference to it (refcount probe), so a batch still queued,
staged or viewed is never handed out again.  When every pooled buffer is
busy the call allocates fresh (correct, just slower).

``get_tensor`` pools torch tensors the same way (the bf16 host cast of
``data/assembly.py::host_stage_dtype``, in pinned memory when a card is
present).  A view of a pooled tensor holds its base, as a numpy view does;
an asynchronous copy out of it holds nothing, so whoever starts such a copy
keeps the tensor until the copy has completed.
"""

from __future__ import annotations

import sys
import threading
from typing import Dict

import numpy as np
import torch


class BufferPool:
    #: retained buffers per key: prefetch queue + consumer + the batch
    #: being written, plus the reservoir's pinned source batches under
    #: shuffle="buffer"
    MAX_PER_KEY = 16

    def __init__(self):
        self._lock = threading.Lock()
        self._bufs: Dict[tuple, list] = {}
        self._max_overrides: Dict[tuple, int] = {}

    @staticmethod
    def key(shape, dtype=np.float32) -> tuple:
        """The pool key for a (shape, dtype) — the unit retention caps
        apply to."""
        return (tuple(int(s) for s in shape), str(np.dtype(dtype)))

    def ensure_retention(self, n: int, key: tuple) -> None:
        """Raise (never lower) the retention cap of one pool ``key`` to
        ``n``: a cap below a consumer's working set would drop released
        buffers and re-allocate them on every refill."""
        with self._lock:
            self._max_overrides[key] = max(self._max_overrides.get(key, 0), n)

    def get(self, shape, dtype=np.float32) -> np.ndarray:
        """An idle (already-faulted) array of ``shape``/``dtype``, else a
        fresh allocation.  Contents are UNINITIALIZED."""
        key = self.key(shape, dtype)
        return self._get(key, lambda: np.empty(key[0], np.dtype(dtype)))

    def get_tensor(self, shape, dtype: torch.dtype,
                   pin_memory: bool = False) -> torch.Tensor:
        """An idle pooled CPU tensor of ``shape``/``dtype`` (page-locked
        when ``pin_memory``), else a fresh one.  Contents are
        UNINITIALIZED."""
        key = (tuple(int(s) for s in shape), str(dtype), bool(pin_memory))
        return self._get(key, lambda: torch.empty(
            key[0], dtype=dtype, pin_memory=pin_memory))

    def _get(self, key: tuple, alloc):
        with self._lock:
            bufs = self._bufs.setdefault(key, [])
            for buf in bufs:
                # refs while probing: the pool slot, the loop variable,
                # and getrefcount's argument == 3
                if sys.getrefcount(buf) == 3:
                    return buf
            buf = alloc()
            cap = max(self.MAX_PER_KEY, self._max_overrides.get(key, 0))
            if len(bufs) < cap:
                bufs.append(buf)
            return buf


#: process-wide pool shared by the native assembler outputs and the host
#: staging paths
POOL = BufferPool()
