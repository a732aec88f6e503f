"""Serving head to head: the port's ``Forecaster`` against the JAX package's
on the CPU, with the same weights (``params_from_jax``) and the same seeded
numpy inputs, at a small size (window 7, as the time conditioning reads
timestamp row 6; hidden 16, 4 heads x 4, 2 leads).

Tolerances: f32 max|port - jax| <= 1e-4 x max|jax| (the two frameworks sum
in other orders); a second request is bit-identical to the first.  The
fast (bf16, fused lead stem) configurations round at other points in the
two frameworks, so that case is held to 5e-2 x max|jax|, as
``tests/test_torch_port_eval.py`` holds the ``--fast`` logs."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config as JaxConfig
from vit_grid_model_tpu.evaluation.serving import Forecaster as JaxForecaster
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu_torch.core.config import MetNet3Config
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.evaluation.serving import Forecaster

SMALL = dict(window_size=7, n_variables=24, n_start_channels=16,
             end_lead_time=2, n_heads=4, dim_head=4, pm25_mean=22.5,
             pm25_std=15.5)


def _inputs(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    x = (rng.random((batch, cfg.window_size, cfg.n_variables,
                     cfg.input_height, cfg.input_width)) * 50
         ).astype(np.float32)
    ts = np.stack([np.full((batch, 7), 2023.0),
                   rng.integers(1, 13, (batch, 7)),
                   rng.integers(1, 29, (batch, 7)),
                   rng.integers(0, 24, (batch, 7))], axis=-1
                  ).astype(np.float32)
    return x, ts


def _twins(**overrides):
    cfg = JaxConfig(**SMALL, **overrides)
    params = metnet3_init(jax.random.PRNGKey(3), cfg)
    return cfg, params, params_from_jax(
        params, MetNet3Config(**dataclasses.asdict(cfg)))


@pytest.mark.parametrize("batch", [1, 2])
def test_forecaster_matches_jax_f32(batch):
    cfg, params, model = _twins()
    x, ts = _inputs(cfg, batch, seed=batch)
    ref = JaxForecaster(params, cfg, batch_size=batch, fast=False,
                        warmup=1).predict(x, ts)
    f = Forecaster(model, batch_size=batch, fast=False, warmup=1,
                   device="cpu")
    first = f.predict(x, ts)
    second = f.predict(x, ts)
    assert first.dtype == np.float32 and first.shape == ref.shape
    assert np.array_equal(first, second)
    err = np.abs(first - ref).max()
    assert err <= 1e-4 * np.abs(ref).max(), err


def test_forecaster_fast_matches_jax_bf16():
    """fast=True on the CPU: bf16 parameters, the fused lead stem and the
    pooled host bf16 cast, against the JAX package's fast forecaster on a
    28 x 28 grid (2 x 2 attention windows)."""
    cfg, params, model = _twins(input_height=28, input_width=28)
    x, ts = _inputs(cfg, 1, seed=7)
    ref = JaxForecaster(params, cfg, fast=True, warmup=1).predict(x, ts)
    f = Forecaster(model, fast=True, warmup=1, device="cpu")
    assert f.cfg.compute_dtype == "bfloat16" and f.cfg.fuse_lead_stem
    assert f.model.up.weight.dtype == torch.bfloat16
    # the caller's model is not changed
    assert model.up.weight.dtype == torch.float32
    assert not model.cfg.fuse_lead_stem
    out = f.predict(x, ts)
    assert out.dtype == np.float32 and np.isfinite(out).all()
    assert np.array_equal(out, f.predict(x, ts))
    err = np.abs(out - ref).max()
    assert err <= 5e-2 * np.abs(ref).max(), err


def test_forecaster_defaults_to_plain_on_the_cpu():
    _, _, model = _twins(input_height=28, input_width=28)
    f = Forecaster(model, warmup=1, device="cpu")
    assert f.device.type == "cpu"
    assert f.cfg == model.cfg and f.model.up.weight.dtype == torch.float32


def test_forecaster_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    _, _, model = _twins(input_height=28, input_width=28)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Forecaster(model)
