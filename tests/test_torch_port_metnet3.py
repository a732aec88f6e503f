"""Whole-forward parity of the port's MetNet3 with ``metnet3_apply``: the
same JAX weights (through ``core/weights.py::params_from_jax``) and the same
numpy inputs, at a reduced geometry.  f32: max|port - jax| <= 1e-4 *
max|jax| on the standard, fused-stem and NHWC-input paths.  bf16 (the
``--fast`` dtype): the port's bf16 output within 5e-2 * max of the f32
reference."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.core.torch_export import export_metnet3_state_dict
from vit_grid_model_tpu.data.assembly import (sim_stack_to_model_input,
                                              sim_stack_to_nhwc_input)
from vit_grid_model_tpu.models.metnet3 import metnet3_apply, metnet3_init
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3

B, T, C_, H, W = 2, 3, 24, 18, 17
REL = 1e-4


def _cfg(hidden, heads, **kw):
    return MetNet3Config(window_size=T, n_variables=C_, n_start_channels=hidden,
                         end_lead_time=3, input_height=H, input_width=W,
                         pm25_mean=22.5, pm25_std=15.5, n_heads=heads,
                         dim_head=8, **kw)


def _inputs(seed=0):
    """An assembled channels-last CMAQ stack (4 lead channels per step) and
    raw timestamps with distinct month/day/hour per sample."""
    rng = np.random.default_rng(seed)
    stack = (rng.random((B, H, W, T * (C_ + 4))) * 50).astype(np.float32)
    ts = np.stack([np.full((B, 7), 2023.0), rng.integers(1, 13, (B, 7)),
                   rng.integers(1, 29, (B, 7)), rng.integers(0, 24, (B, 7))],
                  axis=-1).astype(np.float32)
    return stack, ts


def _stage(stack, cfg):
    if cfg.nhwc_input:
        return np.array(sim_stack_to_nhwc_input(stack, T, cfg.pad_multiple,
                                                np.float32))
    return np.array(sim_stack_to_model_input(stack, T, out_dtype=np.float32))


def _jax_forward(params, cfg, x, ts):
    return np.asarray(jax.jit(lambda p, a, b: metnet3_apply(p, a, b, cfg))(
        params, jnp.asarray(x), jnp.asarray(ts)))


def _port_forward(model, x, ts, dtype=torch.float32):
    with torch.inference_mode():
        return model.to(dtype)(torch.from_numpy(x),
                               torch.from_numpy(ts)).numpy()


def _rel(ours, ref):
    return np.abs(ours - ref).max() / np.abs(ref).max()


def test_state_dict_keys_match_the_exporter():
    cfg = _cfg(16, 4)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    sd = export_metnet3_state_dict(params, cfg)
    ours = MetNet3(cfg).state_dict()
    assert set(ours) == set(sd)
    for k, v in sd.items():
        assert tuple(ours[k].shape) == v.shape, k


@pytest.mark.parametrize("path", ["standard", "fused_stem", "nhwc_input"])
@pytest.mark.parametrize("hidden,heads", [(16, 4), (24, 3)])
def test_forward_matches_jax_f32(path, hidden, heads):
    extra = {"standard": {}, "fused_stem": {"fuse_lead_stem": True},
             "nhwc_input": {"fuse_lead_stem": True, "nhwc_input": True}}[path]
    cfg = _cfg(hidden, heads, **extra)
    params = metnet3_init(jax.random.PRNGKey(1), cfg)
    stack, ts = _inputs()
    x = _stage(stack, cfg)
    ref = _jax_forward(params, cfg, x, ts)
    ours = _port_forward(params_from_jax(params, cfg), x, ts)
    assert ours.shape == (B, 3, H, W)
    assert _rel(ours, ref) <= REL


def test_bf16_delta():
    """The --fast configuration in bf16 against the f32 reference."""
    cfg = _cfg(16, 4)
    fast = dataclasses.replace(cfg, fuse_lead_stem=True, nhwc_input=True,
                               compute_dtype="bfloat16")
    params = metnet3_init(jax.random.PRNGKey(2), cfg)
    stack, ts = _inputs(1)
    ref = _jax_forward(params, cfg, _stage(stack, cfg), ts)
    x = _stage(stack, fast)
    jax_bf16 = _jax_forward(params, fast, x, ts)
    ours = _port_forward(params_from_jax(params, fast), x, ts, torch.bfloat16)
    assert ours.dtype == np.float32 and np.isfinite(ours).all()
    d_port, d_jax = _rel(ours, ref), _rel(jax_bf16, ref)
    print(f"bf16 delta vs f32 reference: port {d_port:.3e}, jax {d_jax:.3e}")
    assert d_port <= 5e-2


def test_condition_time_mixes_rows_across_the_batch():
    """The dim-0 concat of the month/day/hour embeddings: with distinct
    timestamps per sample, sample 0's output depends on sample 1's
    timestamps, as in the JAX package."""
    cfg = _cfg(16, 4)
    model = params_from_jax(metnet3_init(jax.random.PRNGKey(3), cfg), cfg)
    stack, ts = _inputs(2)
    x = _stage(stack, cfg)
    ts2 = ts.copy()
    ts2[1, 6, 1:] = (ts[1, 6, 1:] % 11) + 1
    a = _port_forward(model, x, ts)
    b = _port_forward(model, x, ts2)
    assert np.abs(a[0] - b[0]).max() > 0


def test_empty_pm_channel_list_is_a_no_op_on_the_nhwc_path():
    """With no PM channels the port's NHWC standardization changes nothing,
    as the standard path does; the JAX NHWC path raises IndexError there
    (it reads ``idx[0]``)."""
    from vit_grid_model_tpu.models.metnet3 import (
        standardize_pm_channels_nhwc as jax_standardize)
    from vit_grid_model_tpu_torch.models.metnet3 import (
        pad_values, standardize_pm_channels_nhwc)

    cfg = _cfg(16, 4, pm25_channel_indices=(), nhwc_input=True)
    stack, _ = _inputs()
    x = _stage(stack, cfg)
    pv = pad_values(H, W, cfg.pad_multiple)
    out = standardize_pm_channels_nhwc(torch.from_numpy(x), cfg, pv)
    np.testing.assert_array_equal(out.numpy(), x)
    with pytest.raises(IndexError):
        jax_standardize(jnp.asarray(x), cfg, pv)


def test_short_timestamp_window_reads_the_last_row():
    """With 5 timestamp rows the time conditioning reads row 4, as JAX's
    clamped gather of row 6 does; before the repair the port raised
    IndexError here."""
    cfg = _cfg(16, 4)
    params = metnet3_init(jax.random.PRNGKey(4), cfg)
    model = params_from_jax(params, cfg)
    stack, ts = _inputs(3)
    x = _stage(stack, cfg)
    short = np.ascontiguousarray(ts[:, :5])
    ours = _port_forward(model, x, short)
    assert _rel(ours, _jax_forward(params, cfg, x, short)) <= REL
    clamped = ts.copy()
    clamped[:, 6] = ts[:, 4]
    np.testing.assert_array_equal(ours, _port_forward(model, x, clamped))
