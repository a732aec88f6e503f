"""The port's class head against ``metnet3_class_outputs`` on the same JAX
weights (through ``core/weights.py::params_from_jax``) and numpy inputs,
in f32 at a reduced geometry (the 82x67 grid, 16 channels, window 3, 4
heads x 4, 2 leads; JAX under 'highest' precision):

* the class outputs, with NaN labels and regional targets, with
  ``ignore_backbone`` off and on and with ``pm25=False``: logits within
  1e-5 of max|logits|, each loss within 1e-5 relative, ``predicted_*``
  equal wherever JAX's top-two logit margin exceeds 1e-4, region
  predictions within 1e-5 of their max, and the gradients of ``loss`` for
  every parameter within 1e-4 of the largest of that parameter's JAX
  gradient; under ``ignore_backbone`` the regional losses give the
  backbone exactly zero gradient;
* the losses and ``categorical_to_continuous`` (incl. all-NaN targets and
  out-of-range class ids), ``get_ignore_keys_for_eval`` for each config;
* the regression forward of a class-head model returns class 0's logit,
  de-standardized, as JAX's does; the class outputs refuse bf16, which the
  JAX function cannot run either;
* ``stop_after``: each stage within 1e-5 of max of JAX's, permuted to NHWC;
* the regional head flattens (H, W) row-major, as JAX's NHWC reshape."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.models import classification as JCL
from vit_grid_model_tpu.models import metnet3 as JM
from vit_grid_model_tpu.ops import nn as jnn
from vit_grid_model_tpu.train import losses as JL
from vit_grid_model_tpu_torch.core.weights import (params_from_jax,
                                                   state_dict_from_jax)
from vit_grid_model_tpu_torch.models import classification as TCL
from vit_grid_model_tpu_torch.models import metnet3 as TM
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.train import losses as TL

B, T, H, W = 1, 3, 82, 67
BL = B * 2
REL = 1e-5
GRAD_REL = 1e-4
MARGIN = 1e-4


def _cfg(**kw):
    base = dict(window_size=T, n_variables=24, n_start_channels=16,
                end_lead_time=2, pm25_mean=22.5, pm25_std=15.5, n_heads=4,
                dim_head=4, pm25_class_head=True, pm10=True,
                direct_regional=True)
    base.update(kw)
    return MetNet3Config(**base)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.random((B, T, 24, H, W)) * 50).astype(np.float32)
    ts = np.stack([np.full((B, 7), 2023.0), rng.integers(1, 13, (B, 7)),
                   rng.integers(1, 29, (B, 7)), rng.integers(0, 24, (B, 7))],
                  axis=-1).astype(np.float32)
    labels = (rng.random((BL, H, W)) * 90).astype(np.float32)
    labels[0, 0, :7] = np.nan
    labels[1, 40:45, 3] = np.nan
    regions = (rng.random((BL, 19)) * 40).astype(np.float32)
    regions[1, 3] = np.nan
    return x, ts, labels, regions


def _targets(labels, regions, cfg, wrap):
    kw = {}
    for suffix, on in (("pm25", cfg.pm25 and cfg.pm25_class_head),
                       ("pm10", cfg.pm10)):
        if on:
            kw[f"labels_{suffix}"] = wrap(labels)
            kw[f"region_targets_{suffix}"] = wrap(regions)
    return kw


def _jax_outputs(params, cfg, x, ts, labels, regions):
    def f(p):
        out = JM.metnet3_class_outputs(
            p, jnp.asarray(x), jnp.asarray(ts), cfg,
            **_targets(labels, regions, cfg, jnp.asarray))
        return out["loss"], out

    (_, out), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(params)
    return {k: np.asarray(v) for k, v in out.items()}, grads


def _port_outputs(model, cfg, x, ts, labels, regions):
    out = model.class_outputs(torch.from_numpy(x), torch.from_numpy(ts),
                              **_targets(labels, regions, cfg,
                                         torch.from_numpy))
    out["loss"].backward()
    return out


def _close(ours, ref, rel, what):
    err = np.abs(ours - ref).max()
    assert err <= rel * np.abs(ref).max(), (what, err, np.abs(ref).max())


def _backbone(name):
    return not name.startswith(("classifier_", "regr_regional_"))


@pytest.mark.parametrize("over", [
    {}, {"ignore_backbone": True}, {"pm25": False}],
    ids=["heads", "ignore_backbone", "pm10_only"])
def test_class_outputs_and_grads_match_jax(over):
    cfg = _cfg(**over)
    params = JM.metnet3_init(jax.random.PRNGKey(0), cfg)
    x, ts, labels, regions = _inputs()
    ref, grads = _jax_outputs(params, cfg, x, ts, labels, regions)
    model = params_from_jax(params, cfg)
    ours = _port_outputs(model, cfg, x, ts, labels, regions)

    assert set(ours) == set(ref)
    suffixes = [s for s, on in (("pm25", cfg.pm25), ("pm10", cfg.pm10))
                if on]
    for s in suffixes:
        logits = ours[f"logits_{s}"].detach().permute(0, 2, 3, 1).numpy()
        _close(logits, ref[f"logits_{s}"], REL, f"logits_{s}")
        top2 = np.sort(ref[f"logits_{s}"], axis=-1)[..., -2:]
        decided = (top2[..., 1] - top2[..., 0]) > MARGIN
        assert decided.mean() > 0.99
        np.testing.assert_array_equal(
            ours[f"predicted_{s}"].numpy()[decided],
            ref[f"predicted_{s}"][decided])
        _close(ours[f"region_preds_{s}"].detach().numpy(),
               ref[f"region_preds_{s}"], REL, f"region_preds_{s}")
    for k in [k for k in ref if "loss" in k]:
        np.testing.assert_allclose(float(ours[k].detach()), float(ref[k]),
                                   rtol=REL, err_msg=k)

    jax_grads = state_dict_from_jax(grads, cfg)
    for name, p in model.named_parameters():
        g = jax_grads[name]
        scale = max(np.abs(g).max(), 1e-30)
        err = np.abs(p.grad.numpy() - g).max()
        assert err <= GRAD_REL * scale, (name, err, scale)

    if cfg.ignore_backbone:
        out = model.class_outputs(torch.from_numpy(x), torch.from_numpy(ts),
                                  **_targets(labels, regions, cfg,
                                             torch.from_numpy))
        regr = out["regr_loss_pm25"] + out["regr_loss_pm10"]
        backbone = [p for n, p in model.named_parameters() if _backbone(n)]
        assert not regr.requires_grad or all(
            g is None or not g.any() for g in torch.autograd.grad(
                regr, backbone, allow_unused=True))
        head = model.regr_regional_pm25[2].weight
        assert torch.autograd.grad(out["regr_loss_pm25"],
                                   head)[0].abs().max() > 0


def test_losses_match_jax():
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 5, 6, 4)).astype(np.float32) * 3
    bounds = (15.0, 35.0, 75.0)
    targets = (rng.random((2, 5, 6)) * 100).astype(np.float32)
    targets[0, 1, :] = np.nan
    targets[1, 2, 2] = np.inf
    targets[1, 0, 0] = 35.0              # on a boundary: the lower class
    all_nan = np.full_like(targets, np.nan)
    for t in (targets, all_nan):
        ref = float(JL.pm_class_cross_entropy(jnp.asarray(logits),
                                              jnp.asarray(t), bounds))
        ours = float(TL.pm_class_cross_entropy(
            torch.from_numpy(logits).permute(0, 3, 1, 2),
            torch.from_numpy(t), bounds))
        np.testing.assert_allclose(ours, ref, rtol=1e-6)
    assert float(TL.pm_class_cross_entropy(
        torch.from_numpy(logits).permute(0, 3, 1, 2),
        torch.from_numpy(all_nan), bounds)) == 0.0

    preds = rng.standard_normal((4, 19)).astype(np.float32) * 10
    regions = rng.standard_normal((4, 19)).astype(np.float32) * 10
    regions[2, :4] = np.nan
    for r in (regions, np.full_like(regions, np.nan)):
        np.testing.assert_allclose(
            float(TL.regional_mse_loss(torch.from_numpy(preds),
                                       torch.from_numpy(r))),
            float(JL.regional_mse_loss(jnp.asarray(preds), jnp.asarray(r))),
            rtol=1e-6)

    ids = np.array([[-3, 0, 1], [2, 3, 9]])
    for b in (bounds, (10.0, 20.0), (50.0,)):
        np.testing.assert_array_equal(
            TCL.categorical_to_continuous(torch.from_numpy(ids), b).numpy(),
            np.asarray(JCL.categorical_to_continuous(jnp.asarray(ids), b)))


@pytest.mark.parametrize("pm25,pm10,regional", [
    (p25, p10, reg) for p25 in (True, False) for p10 in (True, False)
    for reg in (True, False)])
def test_ignore_keys_for_eval_match_jax(pm25, pm10, regional):
    cfg = _cfg(pm25=pm25, pm10=pm10, direct_regional=regional)
    assert TM.get_ignore_keys_for_eval(cfg) == JM.get_ignore_keys_for_eval(cfg)


def test_state_dict_keys_and_builds():
    """Every head config builds; the keys are the exporter's plus the
    regional heads', and ``params_from_jax`` fills all of them."""
    for over in ({}, {"pm25": False}, {"pm25_class_head": False},
                 {"direct_regional": False}, {"int8_convs": True}):
        cfg = _cfg(**over)
        params = JM.metnet3_init(jax.random.PRNGKey(1), cfg)
        sd = state_dict_from_jax(params, cfg)
        ours = MetNet3(cfg).state_dict()
        assert set(ours) == set(sd), over
        for k, v in sd.items():
            assert tuple(ours[k].shape) == v.shape, k
    model = MetNet3(_cfg(pm25=False))
    assert not hasattr(model, "classifier_pm25")
    assert "pm25_boundaries" not in model.state_dict()


def test_regression_forward_of_a_class_head_is_class0():
    """``metnet3_apply`` with ``pm25_class_head`` reads channel 0 of the
    four-logit head and de-standardizes it; the port does the same, and
    a pm25=False model refuses the regression forward."""
    cfg = _cfg(pm10=False, direct_regional=False)
    params = JM.metnet3_init(jax.random.PRNGKey(2), cfg)
    x, ts, _, _ = _inputs(1)
    ref = np.asarray(jax.jit(lambda p, a, b: JM.metnet3_apply(p, a, b, cfg))(
        params, jnp.asarray(x), jnp.asarray(ts)))
    model = params_from_jax(params, cfg)
    with torch.no_grad():
        ours = model(torch.from_numpy(x), torch.from_numpy(ts)).numpy()
        logits = model.class_outputs(torch.from_numpy(x),
                                     torch.from_numpy(ts))["logits_pm25"]
    assert ours.shape == (B, 2, H, W)
    _close(ours, ref, REL, "class-0 field")
    class0 = (logits[:, 0] * cfg.pm25_std + cfg.pm25_mean).reshape(B, 2, H, W)
    _close(ours, class0.numpy(), REL, "class-0 logit")

    no_pm25 = MetNet3(_cfg(pm25=False)).eval()
    with pytest.raises(ValueError, match="pm25"):
        no_pm25(torch.from_numpy(x), torch.from_numpy(ts))
    with torch.no_grad():
        feats = no_pm25(torch.from_numpy(x), torch.from_numpy(ts),
                        return_features=True)
    assert feats.shape == (BL, 16, H, W)


def test_class_outputs_refuse_bf16():
    """JAX's class outputs raise in bf16 (its heads read the uncast f32
    weights); the port's raise a ValueError, for a bf16 config and for a
    bf16 model."""
    small = dict(input_height=18, input_width=17)
    cfg = _cfg(compute_dtype="bfloat16", **small)
    params = JM.metnet3_init(jax.random.PRNGKey(0), cfg)
    x, ts, _, _ = _inputs()
    x = x[..., :18, :17].copy()
    with pytest.raises(TypeError):
        jax.jit(lambda p, a, b: JM.metnet3_class_outputs(p, a, b, cfg))(
            params, jnp.asarray(x), jnp.asarray(ts))
    with pytest.raises(ValueError, match="float32"):
        MetNet3(cfg).eval().class_outputs(torch.from_numpy(x),
                                          torch.from_numpy(ts))
    bf16 = MetNet3(_cfg(**small)).eval().to(torch.bfloat16)
    with pytest.raises(ValueError, match="float32"):
        bf16.class_outputs(torch.from_numpy(x), torch.from_numpy(ts))


STAGES = ("input", "stem", "vit_mbconv", "vit_block", "vit", "resnet2")


@pytest.mark.parametrize("fuse,stages", [(False, STAGES), (True, ("stem",))],
                         ids=["standard", "fused"])
def test_stop_after_matches_jax(fuse, stages):
    """Every stage on the standard stem; the fused stem changes only the
    stem's output."""
    cfg = _cfg(pm10=False, direct_regional=False, fuse_lead_stem=fuse)
    params = JM.metnet3_init(jax.random.PRNGKey(4), cfg)
    x, ts, _, _ = _inputs(2)
    model = params_from_jax(params, cfg)
    for stage in stages:
        ref = np.asarray(jax.jit(lambda p, a, b: JM.metnet3_apply(
            p, a, b, cfg, stop_after=stage))(params, jnp.asarray(x),
                                             jnp.asarray(ts)))
        with torch.no_grad():
            ours = model(torch.from_numpy(x), torch.from_numpy(ts),
                         stop_after=stage).permute(0, 2, 3, 1).numpy()
        assert ours.shape == ref.shape, stage
        _close(ours, ref, REL, stage)


def test_regional_head_flattens_row_major():
    """One hot feature pixel at (h, w) reaches fc column h * W + w, as the
    JAX head's reshape of (BL, H, W, 1) reads it."""
    cfg = _cfg()
    params = JM.metnet3_init(jax.random.PRNGKey(5), cfg)
    model = params_from_jax(params, cfg)
    head = model.regr_regional_pm25
    feats = torch.zeros(1, 16, H, W)
    feats[0, :, 7, 11] = 1.0
    with torch.no_grad():
        ours = head[2](head[0](feats).reshape(1, -1))
    jf = jnp.asarray(feats.permute(0, 2, 3, 1).numpy())
    p = params["regr_regional_pm25"]
    r = jnn.conv2d(p["conv"], jf, padding="VALID")
    ref = np.asarray(jnn.linear(p["fc"], r.reshape(1, -1)))
    _close(ours.numpy(), ref, REL, "regional head")
    col = 7 * W + 11
    expect = (head[0].bias + head[0].weight.sum()) * head[2].weight[:, col]
    expect = expect + head[0].bias * (head[2].weight.sum(1)
                                      - head[2].weight[:, col]) + head[2].bias
    torch.testing.assert_close(ours[0], expect.detach(), rtol=1e-5, atol=1e-5)
