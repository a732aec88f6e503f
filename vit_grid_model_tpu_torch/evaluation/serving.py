"""Persistent serving entry: the lowest-latency single-forecast path.

The PyTorch counterpart of ``vit_grid_model_tpu/evaluation/serving.py``.
The eval driver is throughput-shaped: big batches, staging overlapped with
the forward, metrics.  Serving wants the opposite, one (or a few) samples
and the least wall-clock to a forecast.  ``Forecaster`` holds everything
hot, so that ``predict`` does only: the host cast (bf16 halves the
host->device bytes) -> a copy to the device -> the forward -> readback.

What takes the place of the JAX package's levers:

* the model goes to the device in the compute dtype once, at construction
  (the JAX package pre-casts its parameter tree on the device);
* the warm-up forwards run at construction, so that the first request does
  not pay the kernel library's build and load, the cuBLAS and cuDNN
  handles and their first-call plan choice (the JAX package compiles
  there);
* there is no input donation: the bf16 input is cast into a pooled,
  page-locked host buffer (``data/assembly.py::host_stage_dtype``), which
  spares each request a fresh allocation's page faults and makes its copy
  to the device a direct DMA, and the device input is freed to the caching
  allocator as the forward returns;
* fast mode (bf16, the fused lead stem, and on CUDA the hand-written window
  attention) by default on the card.

A quantized model (``ops/quantize.py``) keeps its int8 sidecars, int8
weights with f32 scales and bias, through the copy and the bf16 cast.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from vit_grid_model_tpu_torch.data.bufferpool import POOL
from vit_grid_model_tpu_torch.evaluation.driver import (resolve_device,
                                                        stage_input)
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3, pad_values
from vit_grid_model_tpu_torch.ops import quantize


class Forecaster:
    """Hold a warmed-up model on the device for serving.

    >>> f = Forecaster(model)                # on cuda; warms up
    >>> fields = f.predict(x, timestamps)    # (B, L, H, W) float32 numpy

    ``model``: the port's ``MetNet3`` (any device and dtype; it is not
    changed: a copy of its weights goes to ``device``).  ``device``:
    ``"cuda"`` by default, which raises when CUDA is absent; the CPU runs
    only when asked for (``device="cpu"``).  ``fast=None`` means fast on
    CUDA and plain on the CPU: fast is bf16 with the fused lead stem, and
    on CUDA every window attention runs the hand-written kernel.
    """

    def __init__(self, model: MetNet3, *, batch_size: int = 1,
                 fast: Optional[bool] = None, warmup: int = 2,
                 device="cuda"):
        self.device = resolve_device(device)
        cfg = model.cfg
        if fast is None:
            fast = self.device.type != "cpu"
        if fast:
            cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                      fuse_lead_stem=True)
        self.cfg = cfg
        self.batch_size = batch_size
        state = model.state_dict()
        hot = quantize.add_sidecars_of(MetNet3(cfg), state)
        hot.load_state_dict(state, strict=True)
        self.model = hot.to(device=self.device,
                            dtype=getattr(torch, cfg.compute_dtype)).eval()

        T = cfg.window_size
        if cfg.nhwc_input:
            l, r, t, b = pad_values(cfg.input_height, cfg.input_width,
                                    cfg.pad_multiple)
            shape = (batch_size, cfg.input_height + t + b,
                     cfg.input_width + l + r, T * cfg.n_variables)
        else:
            shape = (batch_size, T, cfg.n_variables, cfg.input_height,
                     cfg.input_width)
        zx = np.zeros(shape, np.float32)
        zt = np.zeros((batch_size, max(T, 7), 4), np.float32)
        for _ in range(max(1, warmup)):
            self.predict(zx, zt)

    def predict(self, x, timestamps) -> np.ndarray:
        """x: (B, T, C, H, W) host array ((B, Hp, Wp, T*C) when the config
        takes NHWC input); timestamps: (B, T', 4).  Returns (B, L, H, W)
        float32 PM2.5 fields."""
        x = np.asarray(x)
        if self.cfg.compute_dtype == "float32" and x.dtype != np.float32:
            # pooled cast: a fresh allocation per request pays its
            # first-touch page faults
            out = POOL.get(x.shape, np.float32)
            np.copyto(out, x, casting="same_kind")
            x = out
        # ``_host`` stays referenced until the readback below has waited
        # for the copy
        xd, td, _host = stage_input(x, timestamps, self.cfg.compute_dtype,
                                    self.device)
        with torch.inference_mode():
            out = self.model(xd, td)
        return out.float().cpu().numpy()
