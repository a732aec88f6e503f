"""Data parallelism over ranks: the CLIs' ``--data_parallel`` contract, a
batch's rows split over the ranks and gathered back, and fixed-size batch
padding.

The port's counterpart of ``vit_grid_model_tpu/parallel/mesh.py``.  There
a device mesh shards each batch on its 'data' axis and GSPMD inserts the
collectives; here each rank is a process (``core/distributed.py``), holds
rows ``rank * b .. (rank + 1) * b - 1`` of every global batch of ``world *
b`` rows, and the collectives are written out.  Parameters are replicated:
the mesh's 'model' (tensor-parallel) axis is not ported, and no entry
point offers it.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
from torch import Tensor

from vit_grid_model_tpu_torch.core import distributed


def data_parallel_for_cli(requested: int, batch_size: Optional[int],
                          device: torch.device, *, module: str):
    """The CLIs' ``--data_parallel`` contract, the counterpart of
    ``mesh_for_cli``.  Under torchrun, ``-1`` is the world size and
    ``k > 0`` must equal it; the process group is then joined (NCCL on
    CUDA, gloo on the CPU).  Without torchrun, ``-1`` is every visible
    device of ``device``'s kind (the CPU counts as one) and ``k`` is k
    devices: either raises when it is more than one, with the torchrun line
    that runs the CLI ``module``, so that no run quietly uses one card of
    several.
    ``batch_size``, when given, must divide over the ranks.

    Returns the process group for the library functions' ``group``
    argument: the default group under torchrun (world size 1 included),
    else None."""
    if requested == 0 or requested < -1:
        raise ValueError(f"--data_parallel {requested}: -1 (all devices) "
                         "or a device count")
    if distributed.launched():
        world = int(os.environ["WORLD_SIZE"])
        if requested not in (-1, world):
            raise ValueError(f"--data_parallel {requested} does not match "
                             f"torchrun's world size {world}")
    else:
        world = requested
        if requested == -1:
            world = (torch.cuda.device_count() if device.type == "cuda"
                     else 1)
        if world > 1:
            raise ValueError(
                f"--data_parallel {requested} resolves to {world} devices: "
                f"launch one process a device, `torchrun --nproc_per_node "
                f"{world} -m {module} --data_parallel {world} ...`")
    if batch_size is not None and batch_size % world != 0:
        raise ValueError(f"batch_size {batch_size} must divide over the "
                         f"{world} data-parallel ranks")
    if not distributed.launched():
        return None
    distributed.initialize(device)
    return distributed.group()


def shard_rows(x, group):
    """This rank's rows of a global batch (an array or tensor whose leading
    axis divides over the ranks); the whole batch when ``group`` is None."""
    if group is None:
        return x
    return x[distributed.local_batch_slice(x.shape[0], group)]


def gather_rows(x: Tensor, group) -> Optional[Tensor]:
    """Every rank's ``x`` (equal shapes), concatenated in rank order along
    the leading axis; on rank 0, and None on the others.  Each rank writes
    its rows into a zero buffer of the global shape and one all-reduce sums
    the buffers, which is exact (x + 0 = x) and runs on NCCL and on gloo
    alike (gloo gathers no CUDA tensor)."""
    if group is None:
        return x
    n, r = distributed.world_size(group), distributed.rank(group)
    b = x.shape[0]
    buf = x.new_zeros((n * b,) + tuple(x.shape[1:]))
    buf[r * b:(r + 1) * b] = x
    torch.distributed.all_reduce(buf, group=group)
    return buf if r == 0 else None


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _first_leaf(tree):
    """The first leaf in JAX's order: dicts by sorted key."""
    while isinstance(tree, (dict, tuple, list)):
        tree = tree[min(tree)] if isinstance(tree, dict) else tree[0]
    return tree


def pad_to_multiple(batch, multiple: int):
    """Pad the leading axis of every array in ``batch`` (a tuple, list or
    dict of arrays, nested or not) to a multiple of ``multiple`` by
    repeating the last sample.  Returns (padded_batch, real_count).

    What fills the pad matters beyond the shape: the model's time
    conditioning mixes embeddings across the rows of a batch (reference
    quirk #11), so the real samples' outputs depend on the padded ones."""
    def pad(x):
        b = x.shape[0]
        rem = (-b) % multiple
        if rem == 0:
            return x
        return np.concatenate([x, np.repeat(x[-1:], rem, axis=0)], axis=0)

    return _tree_map(pad, batch), _first_leaf(batch).shape[0]
