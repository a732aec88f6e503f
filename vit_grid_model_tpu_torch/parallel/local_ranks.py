"""Run a function on several ranks of this host without torchrun.

``run_local_ranks(fn, world_size, args)`` spawns ``world_size`` processes,
joins them in one process group through a ``file://`` store (no TCP port,
so that several such runs can share a host), calls ``fn(*args)`` on every
rank and returns the ranks' results in rank order.  Each process sees the
environment torchrun would give it (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``), so the CLIs run in it as under torchrun.  The CPU tests
run the data-parallel paths on it over gloo, and ``chip_smoke.py`` runs two
ranks on one card with it.

``fn`` must be importable by name (a module-level function), and its
arguments and result picklable.  A rank that raises makes the whole run
raise, after the other ranks are stopped.
"""

from __future__ import annotations

import os
import pickle
import tempfile
from typing import Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from vit_grid_model_tpu_torch.core import distributed


def _entry(rank: int, fn: Callable, world_size: int, device: str,
           store: str, out_dir: str, args: Sequence) -> None:
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world_size))
    # gloo: NCCL runs no two ranks on one card, and not on the CPU
    distributed.initialize(torch.device(device), "gloo",
                           init_method=f"file://{store}")
    try:
        result = fn(*args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


def run_local_ranks(fn: Callable, world_size: int, args: Sequence = (), *,
                    device: str = "cpu", root: Optional[str] = None) -> List:
    """``[fn(*args) on rank 0, ..., on rank world_size - 1]``, each rank
    in its own process, in a gloo process group whose ranks all use
    ``device``.  The store and the results live in a fresh directory
    under ``root`` (the system's temporary directory by default)."""
    with tempfile.TemporaryDirectory(prefix="ranks_", dir=root) as tmp:
        mp.start_processes(
            _entry, args=(fn, world_size, device, os.path.join(tmp, "store"),
                          tmp, tuple(args)),
            nprocs=world_size, join=True, start_method="spawn")
        results = []
        for r in range(world_size):
            # written by the ranks above, from this program's own objects
            with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
    return results
