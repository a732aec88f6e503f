"""What the window drivers take from the program under test: its model
configuration, its constructor, its kernel library and the entry point's
precision switches.
Only the drivers import this module, and only this module and the drivers
import the program.
"""

from __future__ import annotations

import collections
import time
from typing import Dict

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.core.config import MetNet3Config
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3


def model_config(conf: dict, flags: dict) -> MetNet3Config:
    """The configuration file's model fields with the entry point's flags
    (``fuse_lead_stem``, ``nhwc_input``) as the CLI sets them."""
    fields = dict(conf["model"])
    fields["compute_dtype"] = conf["compute_dtype"]
    for key in ("fuse_lead_stem", "nhwc_input"):
        fields[key] = bool(flags.get(key, False))
    for key in ("vit_block_depth", "pm25_boundaries", "pm10_boundaries",
                "pm25_channel_indices"):
        if key in fields:
            fields[key] = tuple(fields[key])
    return MetNet3Config(**fields)


def build_model(mcfg: MetNet3Config, state: Dict[str, Tensor],
                device) -> MetNet3:
    """``MetNet3(cfg)`` on ``device`` with the benchmark's weights, f32."""
    with torch.device(device):
        model = MetNet3(mcfg)
    model.load_state_dict(state)
    return model


def kernel_library(device) -> float:
    """Build the program's CUDA kernel library when it is out of date, and
    load it; the seconds the build took (0.0 when it was current, and on
    the CPU, where the program runs no kernel of its own)."""
    if torch.device(device).type != "cuda":
        return 0.0
    from vit_grid_model_tpu_torch.ops.cuda import library

    built = library.build()
    library.load()
    return built


class Phases:
    """Seconds of each part of a set-up, in order: ``mark(name)`` closes
    the part that began at the previous mark."""

    def __init__(self, device):
        self.device = device
        self.parts: list = []
        self.at = time.perf_counter()

    def mark(self, name: str) -> None:
        sync(self.device)
        now = time.perf_counter()
        self.parts.append((name, now - self.at))
        self.at = now


def set_tf32(flags: dict) -> None:
    """The entry point's TF32 switches: ``tf32`` true or false sets both
    as the evaluation CLI's ``--precision`` does; absent, PyTorch's
    defaults stay, as the training CLI leaves them."""
    if "tf32" in flags:
        torch.backends.cuda.matmul.allow_tf32 = bool(flags["tf32"])
        torch.backends.cudnn.allow_tf32 = bool(flags["tf32"])


def dtype_of(name: str) -> torch.dtype:
    return getattr(torch, name)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class InFlight:
    """At most ``depth`` units of queued device work: after each unit is
    queued, wait for the oldest while more than ``depth - 1`` are
    pending."""

    def __init__(self, depth: int, device):
        self.depth = depth
        self.cuda = torch.device(device).type == "cuda"
        self.pending: collections.deque = collections.deque()

    def queued(self) -> None:
        if not self.cuda:
            return
        ev = torch.cuda.Event()
        ev.record()
        self.pending.append(ev)
        while len(self.pending) >= self.depth:
            self.pending.popleft().synchronize()

