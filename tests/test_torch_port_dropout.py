"""The port's attention dropout against the JAX package, on the CPU in f32.

* ``ops/dropout.py::keep_mask`` is bit-equal to the mask the Pallas forward
  kernel samples in TPU interpret mode (its ``emit_mask`` hook), for the
  head-pair layout (heads 4) and the per-head layout (heads 3).
* The port's ``window_attention`` with a seed and a rate (the plain version,
  which runs for CPU tensors) against ``window_attention_pallas_fused``:
  the forward and the gradients of a sum-of-squares loss, so the port is
  held against the TPU's fused backward kernel itself.  Bounds: output
  2e-5 of max, grads rtol 5e-4 / atol 1e-5, those of
  ``tests/test_pallas_attention.py``.  The unconditioned layer, whose LN
  affine keeps the attention input at O(1) (FiLM keeps it small), has
  gradients up to ~25; there atol is 1e-5 of each gradient's max|jax|,
  since f32 rounding grows with the magnitude.
* ``window_attention_bwd_reference``, the plain version of the backward
  kernel, against ``jax.vjp`` of ``ops.attention.attention`` with the same
  mask, every output of its tuple carried to the layer's parameters."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from tests.test_torch_port_attention import WPS, _bias_idx, _case, _port
from vit_grid_model_tpu.core import torch_export
from vit_grid_model_tpu.ops import attention as jattn
from vit_grid_model_tpu.ops.window import relative_position_indices
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.dropout import hash_keep, keep_mask

RATE = 0.25


def _pallas_mask(heads, seed):
    from jax.experimental.pallas import tpu as pltpu

    from vit_grid_model_tpu.ops.pallas.attention import (
        _window_attention_fwd_impl)

    p, x, cond = _case(heads, 8, 32, True)
    with pltpu.force_tpu_interpret_mode():
        _, mask = _window_attention_fwd_impl(
            p, jnp.asarray(x), jnp.asarray(cond), relative_position_indices(
                7, 4), None, heads, WPS, 8, jnp.asarray([seed], jnp.int32),
            RATE, True)
    return np.asarray(mask)


@pytest.mark.parametrize("seed", [1234, 2 ** 31 - 2])
@pytest.mark.parametrize("heads", [4, 3])
def test_keep_mask_bit_equal_to_pallas(heads, seed):
    ref = _pallas_mask(heads, seed)
    ours = keep_mask(seed, ref.shape[0], heads, 53, RATE).numpy()
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    dropped = (ours == 0).mean(axis=(0, 2, 3))
    assert np.all(np.abs(dropped - RATE) < 0.05), dropped


def test_hash_matches_uint32_arithmetic():
    """The int64-with-masks hash against the same formula in numpy uint32,
    on indices and seeds that reach the top bits."""
    rng = np.random.default_rng(0)
    idx = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64).astype(np.uint32)
    for seed in (0, 1, 2 ** 31 - 2):
        x = idx ^ np.uint32((seed * 0x9E3779B9) & 0xFFFFFFFF)
        x = (x ^ (x >> np.uint32(16))) * np.uint32(0x7FEB352D)
        x = (x ^ (x >> np.uint32(15))) * np.uint32(0x846CA68B)
        x = x ^ (x >> np.uint32(16))
        u = (x >> np.uint32(8)).astype(np.float32) * np.float32(2.0 ** -24)
        ref = (u >= np.float32(RATE)).astype(np.float32) / np.float32(1 - RATE)
        ours = hash_keep(torch.from_numpy(idx.astype(np.int64)), seed, RATE)
        np.testing.assert_array_equal(ours.numpy(), ref)


def _jax_grads_as_state_dict(dp):
    sd = {}
    torch_export._emit_attention(sd, "a", dp)
    return {k[2:]: v for k, v in sd.items()}


def _close(ours, ref, conditioned=True):
    atol = 1e-5 if conditioned else 1e-5 * max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(ours, ref, rtol=5e-4, atol=atol)


@pytest.mark.parametrize("heads,conditioned", [(4, True), (3, True),
                                               (3, False)])
def test_window_attention_dropout_matches_fused_pallas(heads, conditioned):
    from jax.experimental.pallas import tpu as pltpu

    from vit_grid_model_tpu.ops.pallas.attention import (
        window_attention_pallas_fused)

    seed = 1234
    p, x, cond = _case(heads, 8, 32, conditioned)
    jcond = None if cond is None else jnp.asarray(cond)

    def loss(pp, xx):
        return jnp.sum(window_attention_pallas_fused(
            pp, xx, jcond, relative_position_indices(7, 4), None,
            jnp.asarray([seed], jnp.int32), heads, WPS, 8, RATE) ** 2)

    with pltpu.force_tpu_interpret_mode():
        ref, (dp, dx) = jax.value_and_grad(loss, argnums=(0, 1))(
            p, jnp.asarray(x))
        ref_out = np.asarray(window_attention_pallas_fused(
            p, jnp.asarray(x), jcond, relative_position_indices(7, 4), None,
            jnp.asarray([seed], jnp.int32), heads, WPS, 8, RATE))

    m = _port(p, heads, 8, 32, conditioned)
    xt = torch.from_numpy(x).requires_grad_()
    ct = None if cond is None else torch.from_numpy(cond)
    out = cuda_attn.window_attention(m, xt, ct, _bias_idx(),
                                     windows_per_sample=WPS, seed=seed,
                                     dropout_rate=RATE)
    (out ** 2).sum().backward()
    out = out.detach().numpy()
    assert np.abs(out - ref_out).max() <= 2e-5 * np.abs(ref_out).max()
    np.testing.assert_allclose(float((out ** 2).sum()), float(ref),
                               rtol=1e-5)
    _close(xt.grad.numpy(), np.asarray(dx), conditioned)
    want = _jax_grads_as_state_dict(dp)
    got = {n: q.grad for n, q in m.named_parameters() if q.grad is not None}
    assert set(got) == set(want)
    for name, g in got.items():
        _close(g.numpy(), np.asarray(want[name]), conditioned)


@pytest.mark.parametrize("heads,conditioned,wps", [(4, True, 1),
                                                   (3, True, 3),
                                                   (3, False, 3)])
def test_bwd_reference_matches_jax_vjp(heads, conditioned, wps):
    """Each output of ``window_attention_bwd_reference`` goes to the
    layer's parameters through the differentiable ``kernel_inputs``
    (relayouts, bias gather, per-sample sum of dgamma_w/dbeta_w, FiLM),
    and dx stays as it is; both are held against ``jax.vjp`` of the JAX
    attention with the same mask.  With one window per sample the FiLM
    gradient pins each window's dgamma_w/dbeta_w."""
    seed = 2 ** 31 - 2
    p, x, cond = _case(heads, 8, 32, conditioned)
    if conditioned and wps == 1:
        cond = np.random.default_rng(5).standard_normal(
            (x.shape[0], 2)).astype(np.float32)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    mask = keep_mask(seed, x.shape[0], heads, 53, RATE)
    jcond = None if cond is None else jnp.asarray(cond)

    _, vjp = jax.vjp(lambda pp, xx, cc: jattn.attention(
        pp, xx, cc, relative_position_indices(7, 4), heads=heads,
        windows_per_sample=wps, dropout_mask=jnp.asarray(mask.numpy())),
        p, jnp.asarray(x), jcond)
    dp, dx, dcond = vjp(jnp.asarray(dy))

    m = _port(p, heads, 8, 32, conditioned)
    ct = None if cond is None else torch.from_numpy(cond).requires_grad_()
    xt = torch.from_numpy(x)
    k = cuda_attn.kernel_inputs(m, xt, ct, _bias_idx(), wps)
    grads = cuda_attn.window_attention_bwd_reference(
        xt, k, torch.from_numpy(dy), seed, RATE)
    assert [tuple(g.shape) for g in grads] == [
        tuple(xt.shape), (x.shape[0], 32), (x.shape[0], 32),
        tuple(k.wqkv.shape), tuple(k.wout.shape), tuple(k.qg.shape),
        tuple(k.kg.shape), tuple(k.bias.shape)]
    dx_ref, dgw, dbw, *weights = grads
    _close(dx_ref.numpy(), np.asarray(dx), conditioned)

    def per_row(t, rows):
        return t.reshape(rows, -1, t.shape[-1]).sum(1)

    outputs = [k.wqkv, k.wout, k.qg, k.kg, k.bias]
    cotangents = list(weights)
    if k.has_film:
        outputs += [k.gamma, k.beta]
        cotangents += [per_row(dgw, k.gamma.shape[0]),
                       per_row(dbw, k.beta.shape[0])]
    params = dict(m.named_parameters())
    leaves = list(params.values()) + ([ct] if ct is not None else [])
    found = torch.autograd.grad(outputs, leaves, cotangents,
                                allow_unused=True)
    want = _jax_grads_as_state_dict(dp)
    for (name, _), g in zip(params.items(), found):
        if g is None:
            assert name.startswith("film") and not conditioned, name
            continue
        _close(g.numpy(), np.asarray(want[name]), conditioned)
    if ct is not None:
        _close(found[-1].numpy(), np.asarray(dcond))
