"""Weights for the port's ``MetNet3``: from a JAX parameter pytree, from a
reference ``.pkt`` checkpoint, or from a numpy seed.

The module tree uses exactly the state_dict keys of
``vit_grid_model_tpu/core/torch_export.py::export_metnet3_state_dict``, so
each source loads with ``load_state_dict(strict=True)`` and no converter.
"""

from __future__ import annotations

import numpy as np
import torch

from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.core.torch_export import export_metnet3_state_dict
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3


def _load(cfg: MetNet3Config, state_dict) -> MetNet3:
    model = MetNet3(cfg)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def params_from_jax(params, cfg: MetNet3Config) -> MetNet3:
    """A ``metnet3_init``-shaped pytree (arrays of any kind numpy can read)
    -> the port's model in f32 on the CPU, in eval mode."""
    sd = export_metnet3_state_dict(params, cfg)
    return _load(cfg, {k: torch.from_numpy(np.ascontiguousarray(v))
                       for k, v in sd.items()})


def load_reference_checkpoint(path: str, cfg: MetNet3Config) -> MetNet3:
    """A reference ``.pkt`` state_dict (with or without the DataParallel
    ``module.`` prefix) -> the port's model on the CPU, in eval mode."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    return _load(cfg, sd)


def seeded_model(cfg: MetNet3Config, seed: int) -> MetNet3:
    """The model with every parameter and BatchNorm statistic drawn from
    ``np.random.default_rng(seed)``: torch-default fan-in uniform weights,
    standard-normal embeddings and registers, norm gains near 1, and
    running variances in [0.5, 1.5]."""
    rng = np.random.default_rng(seed)
    model = MetNet3(cfg)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if name == "pm25_boundaries" or leaf == "num_batches_tracked":
            continue
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf == "running_mean" or leaf == "b" or (
                leaf == "bias" and ".norm" in name):
            v = 0.1 * rng.standard_normal(shape)
        elif leaf in ("g", "gamma") or (leaf == "weight" and (
                ".norm" in name or len(shape) == 1)):
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif "register_tokens" in name or name.endswith(
                ("condition_lead_time.weight", "rel_pos_bias.weight")) or (
                "condition_model_time" in name):
            v = rng.standard_normal(shape)
        elif len(shape) >= 2:
            bound = 1.0 / np.sqrt(np.prod(shape[1:]))
            v = rng.uniform(-bound, bound, shape)
        else:
            v = rng.uniform(-0.1, 0.1, shape)
        sd[name] = torch.from_numpy(v.astype(np.float32))
    model.load_state_dict(sd, strict=False)
    return model.eval()
