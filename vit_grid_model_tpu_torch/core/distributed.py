"""Data-parallel processes: one process a device, over ``torch.distributed``.

The port's counterpart of ``vit_grid_model_tpu/core/distributed.py``.  JAX
runs one controller over a device mesh; PyTorch's idiom is one process per
GPU, launched by ``torchrun`` (``python -m torch.distributed.run``), which
sets ``RANK``, ``LOCAL_RANK`` and ``WORLD_SIZE`` in each process's
environment:

    torchrun --nproc_per_node 8 -m vit_grid_model_tpu_torch.cli.train_vit \\
        --data_parallel -1 ...

``initialize`` joins the process group: NCCL when the rank's device is CUDA,
gloo on the CPU.  Parameters are replicated: rank 0's are broadcast at the
start (``broadcast_module``), and the replicas stay equal because every
rank applies the same all-reduced gradients.  ``group()`` is what the
library functions take as their ``group`` argument: the default group once
it is initialized, else None, which means one process.

Every collective runs on the rank's device, where its tensors lie: the
GPU under NCCL; the CPU, or a GPU, under gloo (whose all-reduce and
broadcast take CUDA tensors).
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch import Tensor, nn


def launched() -> bool:
    """True in a process that ``torchrun`` started (``WORLD_SIZE`` set)."""
    return "WORLD_SIZE" in os.environ


def local_rank() -> int:
    return int(os.environ.get("LOCAL_RANK", "0"))


def initialize(device: torch.device, backend: Optional[str] = None,
               init_method: Optional[str] = None) -> None:
    """Join the default process group from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, and ``MASTER_ADDR``/``MASTER_PORT`` unless
    ``init_method`` names another rendezvous, e.g. a ``file://`` store).
    ``backend`` defaults to NCCL when ``device`` is CUDA and gloo on the
    CPU.  Does nothing when the group is already up.

    A failed initialization raises: a rank never carries on as a process of
    its own, which would run the whole dataset once on every device."""
    if dist.is_initialized():
        return
    device = torch.device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method or "env://",
        rank=int(os.environ["RANK"]),
        world_size=int(os.environ["WORLD_SIZE"]))


def group():
    """The default process group once it is initialized, else None."""
    return dist.group.WORLD if dist.is_initialized() else None


def rank(group=None) -> int:
    return dist.get_rank(group) if group is not None else 0


def world_size(group=None) -> int:
    return dist.get_world_size(group) if group is not None else 1


def is_primary(group=None) -> bool:
    """True on the rank that prints, writes logs and writes checkpoints."""
    return rank(group) == 0


def local_batch_slice(global_batch: int, group=None) -> slice:
    """This rank's rows of a global batch that divides over the ranks: rank
    r holds rows r * b .. (r + 1) * b - 1, b = global_batch / world."""
    per, rest = divmod(global_batch, world_size(group))
    if rest:
        raise ValueError(f"a batch of {global_batch} rows does not divide "
                         f"over the {world_size(group)} ranks")
    start = per * rank(group)
    return slice(start, start + per)


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank.  The global loss is the sum
    of the ranks' losses, each of which reads y, so the gradient of x is
    the sum over ranks of y's gradient: an all-reduce again."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(x: Tensor, group) -> Tensor:
    """The sum of ``x`` over the ranks, a new tensor, differentiable."""
    return _AllReduceSum.apply(x, group)


def broadcast_module(model: nn.Module, group, src: int = 0) -> None:
    """Overwrite every parameter and buffer with rank ``src``'s, in place."""
    with torch.no_grad():
        for t in model.state_dict().values():
            dist.broadcast(t, src, group=group)


def assert_replicas_equal(model: nn.Module, group) -> None:
    """Raise on every rank unless every rank holds rank 0's parameters and
    buffers, compared through one f64 sum and one f64 sum of squares a
    tensor."""
    with torch.no_grad():
        fp = torch.stack([torch.stack([t.double().sum(),
                                       t.double().square().sum()])
                          for t in model.state_dict().values()])
        ref = fp.clone()
        dist.broadcast(ref, 0, group=group)
        bad = all_reduce_sum(
            torch.tensor([float(not torch.equal(ref, fp))], device=fp.device),
            group)
    if bad.item():
        raise RuntimeError(f"the replicas disagree on {int(bad.item())} of "
                           f"{world_size(group)} ranks")
