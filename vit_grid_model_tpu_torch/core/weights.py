"""Weights for the port's ``MetNet3``: from a JAX parameter pytree, from a
reference ``.pkt`` checkpoint, or from a numpy seed; and for the legacy
station and grid models and SimVP, from a JAX pytree or a numpy seed.

The module tree uses the state_dict keys of
``core/export.py::export_metnet3_state_dict`` (the port's copy of the JAX
package's exporter, which also emits the class heads ``classifier_pm25``
with ``len(boundaries) + 1`` outputs, ``classifier_pm10`` and both
boundary buffers), so each source loads with
``load_state_dict(strict=True)`` and no converter.  The exporter leaves
out two things, which ``state_dict_from_jax`` adds here:

* the regional heads ``regr_regional_{pm25,pm10}``, an ``nn.Sequential``
  of Conv1x1 (``.0``), Flatten and Linear(H * W, 19) (``.2``);
* the int8 sidecars ``*.proj_q.{wq, sw, sx, b}`` of a quantized pytree
  (``ops/quantize.py``): ``wq`` OIHW int8, the rest f32.

A state_dict with sidecars loads into a model given empty sidecars at the
same sites first (``_load``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from vit_grid_model_tpu_torch.core.config import MetNet3Config
from vit_grid_model_tpu_torch.core.export import (export_grid_model,
                                                  export_metnet3_state_dict,
                                                  export_simvp,
                                                  export_station_model)
from vit_grid_model_tpu_torch.models.legacy.grid import (GridModel,
                                                         GridModelSpec)
from vit_grid_model_tpu_torch.models.legacy.station import (StationModel,
                                                            StationModelSpec)
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.models.simvp import SimVP, SimVPSpec
from vit_grid_model_tpu_torch.ops import quantize


def _load(cfg: MetNet3Config, state_dict) -> MetNet3:
    model = quantize.add_sidecars_of(MetNet3(cfg), state_dict)
    model.load_state_dict(state_dict, strict=True)
    return model.eval()


def _hwio_to_oihw(w, dtype=np.float32) -> np.ndarray:
    return np.transpose(np.asarray(w), (3, 2, 0, 1)).astype(dtype)


def state_dict_from_jax(params, cfg: MetNet3Config):
    """A ``metnet3_init``-shaped pytree, quantized or not -> the port's
    state_dict as numpy arrays: the exporter's entries, the regional
    heads and the int8 sidecars."""
    sd = export_metnet3_state_dict(params, cfg)
    for suffix in ("pm25", "pm10"):
        head = params.get(f"regr_regional_{suffix}")
        if head is not None:
            prefix = f"regr_regional_{suffix}"
            sd[f"{prefix}.0.weight"] = _hwio_to_oihw(head["conv"]["w"])
            sd[f"{prefix}.0.bias"] = np.array(head["conv"]["b"], np.float32)
            sd[f"{prefix}.2.weight"] = np.ascontiguousarray(
                np.asarray(head["fc"]["w"], np.float32).T)
            sd[f"{prefix}.2.bias"] = np.array(head["fc"]["b"], np.float32)
    for stage in ("resnet1", "resnet2"):
        for i, blk in enumerate(params[stage]["blocks"]):
            for name in ("block1", "block2"):
                q = blk[name].get("proj_q")
                if q is None:
                    continue
                prefix = f"{stage}.blocks.{i}.{name}.proj_q"
                sd[f"{prefix}.wq"] = _hwio_to_oihw(q["wq"], np.int8)
                for leaf in ("sw", "sx", "b"):
                    sd[f"{prefix}.{leaf}"] = np.array(q[leaf], np.float32)
    return sd


def params_from_jax(params, cfg: MetNet3Config) -> MetNet3:
    """A ``metnet3_init``-shaped pytree (arrays of any kind numpy can read),
    with or without int8 sidecars -> the port's model in f32 on the CPU,
    in eval mode."""
    sd = state_dict_from_jax(params, cfg)
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
    """The model with every parameter and BatchNorm statistic drawn by
    ``seed_module``."""
    return seed_module(MetNet3(cfg), seed)


def seed_module(model: nn.Module, seed: int) -> nn.Module:
    """``model`` with every parameter and BatchNorm statistic drawn from
    ``np.random.default_rng(seed)``, in state_dict order: torch-default
    fan-in uniform weights, standard-normal embeddings and registers, norm
    gains (RevIN's affine weight among them) near 1, and running variances
    in [0.5, 1.5].  The class boundaries and any int8 sidecars are left as
    they are: quantize after seeding.  In eval mode."""
    rng = np.random.default_rng(seed)
    sd = {}
    for name, t in model.state_dict().items():
        shape = tuple(t.shape)
        leaf = name.rsplit(".", 1)[-1]
        if (name.endswith("_boundaries") or leaf == "num_batches_tracked"
                or ".proj_q." in name):
            continue
        if leaf == "running_var":
            v = rng.uniform(0.5, 1.5, shape)
        elif leaf in ("running_mean", "b", "affine_bias") or (
                leaf == "bias" and ".norm" in name):
            v = 0.1 * rng.standard_normal(shape)
        elif leaf in ("g", "gamma", "affine_weight") or (
                leaf == "weight" and (".norm" in name or len(shape) == 1)):
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


# ---------------------------------------------------------------------------
# the legacy station and grid models, and SimVP
# ---------------------------------------------------------------------------


def _load_numpy(model: nn.Module, state_dict) -> nn.Module:
    model.load_state_dict({k: torch.from_numpy(np.ascontiguousarray(v))
                           for k, v in state_dict.items()}, strict=True)
    return model.eval()


def station_model_from_jax(params, spec: StationModelSpec) -> StationModel:
    """A ``station_model_init``-shaped pytree -> the port's model in f32 on
    the CPU, in eval mode; the coordinates from ``params``."""
    return _load_numpy(StationModel(spec, params["lats"], params["lons"]),
                       export_station_model(params, spec.variant))


def grid_model_from_jax(params, spec: GridModelSpec) -> GridModel:
    """A ``grid_model_init``-shaped pytree -> the port's model in f32 on the
    CPU, in eval mode; the coordinates from ``params``."""
    return _load_numpy(GridModel(spec, params["lats"], params["lons"],
                                 params["cmaq_coords"]),
                       export_grid_model(params, spec.version))


def simvp_from_jax(params, spec: SimVPSpec) -> SimVP:
    """A ``simvp_init``-shaped pytree -> the port's model in f32 on the CPU,
    in eval mode."""
    return _load_numpy(SimVP(spec), export_simvp(params, spec.n_s, spec.n_t))


def _station_coords(rng, n: int):
    """Station latitudes in [33, 38) and longitudes in [125, 130)."""
    return rng.random(n) * 5 + 33, rng.random(n) * 5 + 125


def seeded_station_model(spec: StationModelSpec, seed: int) -> StationModel:
    """The station model with its coordinates and every parameter drawn
    from ``seed`` (``seed_module``)."""
    rng = np.random.default_rng(seed)
    return seed_module(StationModel(spec, *_station_coords(
        rng, spec.total_stn_num)), seed)


def seeded_grid_model(spec: GridModelSpec, seed: int) -> GridModel:
    """The grid model with its coordinates (grid cells' in [30, 40)) and
    every parameter drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    lats, lons = _station_coords(rng, spec.total_stn_num)
    coords = rng.random(spec.grid_shape + (2,)) * 10 + 30
    return seed_module(GridModel(spec, lats, lons, coords), seed)


def seeded_simvp(spec: SimVPSpec, seed: int) -> SimVP:
    """SimVP with every parameter drawn from ``seed``."""
    return seed_module(SimVP(spec), seed)
