"""The PyTorch port's primitives, window ops and MBConv against the JAX
package on the same numpy inputs (f32; JAX under the conftest's highest
matmul precision).  Tolerance: max|port - jax| <= 1e-5 * max|jax|, sums
taken in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core import torch_export
from vit_grid_model_tpu.ops import mbconv as jmb
from vit_grid_model_tpu.ops import nn as jnn
from vit_grid_model_tpu.ops import window as jwin
from vit_grid_model_tpu_torch.ops import mbconv as tmb
from vit_grid_model_tpu_torch.ops import nn as tnn
from vit_grid_model_tpu_torch.ops import window as twin

REL = 1e-5


def _close(ours, ref, rel=REL):
    ours = ours.detach().numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err <= rel, err


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _nchw(a):
    return _t(a).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1)


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _bn_params(c, seed):
    rng = np.random.default_rng(seed)
    return {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
            "bias": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
            "mean": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}


def _load_bn(bn: torch.nn.BatchNorm2d, p):
    bn.weight.data = _t(p["scale"])
    bn.bias.data = _t(p["bias"])
    bn.running_mean.data = _t(p["mean"])
    bn.running_var.data = _t(p["var"])


KEY = jax.random.PRNGKey(0)


def test_linear_and_embedding():
    p = jnn.linear_init(KEY, 16, 24)
    x = _rand(5, 7, 16)
    _close(tnn.linear(_t(x), _t(p["w"]).T, _t(p["b"])),
           jnn.linear(p, jnp.asarray(x)))
    e = jnn.embedding_init(KEY, 13, 4)
    idx = np.array([[0, 3, 12], [7, 7, 1]])
    _close(tnn.embedding(_t(e["table"]), torch.from_numpy(idx)),
           jnn.embedding(e, jnp.asarray(idx)))


@pytest.mark.parametrize("k,groups,c_in", [(3, 1, 6), (1, 1, 6), (3, 6, 6)])
def test_conv2d(k, groups, c_in):
    c_out = 6 if groups > 1 else 10
    p = jnn.conv_init(KEY, k, k, c_in, c_out, groups=groups)
    x = _rand(2, 9, 11, c_in)
    ref = jnn.conv2d(p, jnp.asarray(x), padding=k // 2, groups=groups)
    w = _t(torch_export._conv(p["w"]))
    ours = tnn.conv2d(_nchw(x), w, _t(p["b"]), padding=k // 2, groups=groups)
    _close(_nhwc(ours), ref)


def test_conv2d_transpose_through_exporter():
    """The exporter's un-flipped (in, out, kh, kw) taps make a plain
    nn.ConvTranspose2d(c, c, 2, stride=2) reproduce the JAX transposed
    conv."""
    c = 8
    p = jnn.conv_init(KEY, 2, 2, c, c)
    x = _rand(2, 5, 4, c)
    ref = jnn.conv2d_transpose(p, jnp.asarray(x), stride=2)
    up = torch.nn.ConvTranspose2d(c, c, 2, stride=2)
    up.weight.data = _t(torch_export._conv_transpose(p["w"]))
    up.bias.data = _t(p["b"])
    _close(_nhwc(tnn.conv2d_transpose(_nchw(x), up.weight, up.bias)), ref)
    _close(_nhwc(up(_nchw(x))), ref)


def test_batch_norm_eval():
    p = _bn_params(6, 1)
    x = _rand(2, 5, 4, 6, seed=2)
    bn = torch.nn.BatchNorm2d(6).eval()
    _load_bn(bn, p)
    _close(_nhwc(tnn.batch_norm(_nchw(x), bn)),
           jnn.batch_norm(p, jnp.asarray(x)))


def test_chan_layer_norm_clamps_variance():
    """rsqrt(max(var, eps)): half the pixels have variance far below eps."""
    rng = np.random.default_rng(3)
    x = _rand(2, 4, 5, 8, seed=4)
    x[:, :2] = 1.0 + 1e-4 * x[:, :2]
    p = {"g": jnp.asarray(rng.uniform(0.5, 1.5, 8), jnp.float32),
         "b": jnp.asarray(rng.normal(0, 0.1, 8), jnp.float32)}
    ours = tnn.chan_layer_norm(_nchw(x), _t(p["g"]).reshape(1, -1, 1, 1),
                               _t(p["b"]).reshape(1, -1, 1, 1))
    _close(_nhwc(ours), jnn.chan_layer_norm(p, jnp.asarray(x)))


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm(affine):
    x = _rand(3, 7, 16, seed=5, scale=3.0)
    p = jnn.layer_norm_init(16, affine=affine)
    if affine:
        p = {"g": p["g"] * 1.3, "b": p["b"] + 0.2}
        ours = tnn.layer_norm(_t(x), _t(p["g"]), _t(p["b"]))
    else:
        ours = tnn.layer_norm(_t(x))
    _close(ours, jnn.layer_norm(p, jnp.asarray(x)))


def test_qk_rms_norm_with_zero_vector():
    x = _rand(2, 3, 5, 8, seed=6)
    x[0, 1, 2] = 0.0                      # takes the 1e-12 clamp
    gamma = _rand(3, 1, 8, seed=7)
    _close(tnn.qk_rms_norm(_t(x), _t(gamma)),
           jnn.qk_rms_norm({"gamma": jnp.asarray(gamma)}, jnp.asarray(x)))


@pytest.mark.parametrize("name", ["gelu", "silu"])
def test_activations(name):
    x = _rand(4, 33, seed=8, scale=4.0)
    _close(getattr(tnn, name)(_t(x)), getattr(jnn, name)(jnp.asarray(x)))


def test_max_pool_2x():
    x = _rand(2, 8, 6, 3, seed=9)
    _close(_nhwc(tnn.max_pool_2x(_nchw(x))), jnn.max_pool_2x(jnp.asarray(x)))


def test_squeeze_excite():
    p = jnn.squeeze_excite_init(KEY, 16)
    x = _rand(2, 5, 4, 16, seed=10)
    se = tnn.SqueezeExcite(16)
    se.gate[1].weight.data = _t(p["fc1"]["w"]).T
    se.gate[3].weight.data = _t(p["fc2"]["w"]).T
    _close(_nhwc(se(_nchw(x))), jnn.squeeze_excite(p, jnp.asarray(x)))


def test_film():
    p = jnn.film_init(KEY, 2, 8)
    cond = _rand(5, 2, seed=11)
    film = tnn.FiLM(2, 8)
    for i, name in ((0, "fc1"), (2, "fc2")):
        film[i].weight.data = _t(p[name]["w"]).T
        film[i].bias.data = _t(p[name]["b"])
    for ours, ref in zip(film(_t(cond)), jnn.film(p, jnp.asarray(cond))):
        _close(ours, ref)


@pytest.mark.parametrize("kind", ["block", "grid"])
def test_window_partition_and_reverse(kind):
    x = _rand(2, 14, 21, 3, seed=12)
    part, rev = (getattr(jwin, f"{kind}_partition"),
                 getattr(jwin, f"{kind}_reverse"))
    tpart, trev = (getattr(twin, f"{kind}_partition"),
                   getattr(twin, f"{kind}_reverse"))
    ref, dims = part(jnp.asarray(x), 7)
    ours, tdims = tpart(_t(x), 7)
    assert tdims == dims
    np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(trev(ours, 7, tdims).numpy(), x)


@pytest.mark.parametrize("w,nr", [(7, 4), (3, 0), (4, 2)])
def test_relative_position_indices(w, nr):
    np.testing.assert_array_equal(
        twin.relative_position_indices(w, nr).numpy(),
        np.asarray(jwin.relative_position_indices(w, nr)))


@pytest.mark.parametrize("dim_in,dim_out,downsample", [
    (16, 16, True),          # first layer of a stage: no residual
    (16, 16, False),         # residual
    (8, 16, True),           # widening
])
def test_mbconv(dim_in, dim_out, downsample):
    p = jmb.mbconv_init(KEY, dim_in, dim_out, downsample=downsample)
    for i, name in enumerate(("bn1", "bn2", "bn3")):
        p[name] = _bn_params(p[name]["scale"].shape[0], 20 + i)
    x = _rand(2, 7, 6, dim_in, seed=13)
    ref = jmb.mbconv(p, jnp.asarray(x), dim_in=dim_in, dim_out=dim_out,
                     downsample=downsample)

    block = tmb.mbconv(dim_in, dim_out, downsample=downsample).eval()
    residual = dim_in == dim_out and not downsample
    sd = {}
    torch_export._emit_mbconv(sd, "m", p, residual=residual)
    block.load_state_dict({k[2:]: _t(v) if v.dtype != np.int64
                           else torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    _close(_nhwc(block(_nchw(x))), ref)


@pytest.mark.parametrize("shape", [(2, 5, 4, 6), (1, 3, 3, 4)])
def test_batch_norm_train(shape):
    """Training BatchNorm: output with the biased batch variance and the
    running-stat update (momentum 0.1, unbiased variance) against
    ``ops/nn.py::batch_norm(training=True)``."""
    c = shape[-1]
    p = _bn_params(c, 3)
    x = _rand(*shape, seed=4, scale=2.0) + 0.5
    ref, stats = jnn.batch_norm(p, jnp.asarray(x), training=True)
    bn = torch.nn.BatchNorm2d(c)
    _load_bn(bn, p)
    y, mean, var = tnn.batch_norm_train(_nchw(x), bn)
    _close(_nhwc(y), ref)
    _close(mean, stats["mean"])
    _close(var, stats["var"])
    assert not mean.requires_grad and not var.requires_grad


@pytest.mark.parametrize("dim_in,dim_out,downsample", [
    (16, 16, True), (16, 16, False), (8, 16, True)])
def test_mbconv_train(dim_in, dim_out, downsample):
    """MBConv in training mode (``mbconv_train``): output and the three
    BatchNorms' updated running statistics, in order."""
    p = jmb.mbconv_init(KEY, dim_in, dim_out, downsample=downsample)
    for i, name in enumerate(("bn1", "bn2", "bn3")):
        p[name] = _bn_params(p[name]["scale"].shape[0], 30 + i)
    x = _rand(2, 7, 6, dim_in, seed=14)
    ref, ref_stats = jmb.mbconv_train(p, jnp.asarray(x), dim_in=dim_in,
                                      dim_out=dim_out, downsample=downsample)
    block = tmb.mbconv(dim_in, dim_out, downsample=downsample)
    residual = dim_in == dim_out and not downsample
    sd = {}
    torch_export._emit_mbconv(sd, "m", p, residual=residual)
    block.load_state_dict({k[2:]: _t(v) if v.dtype != np.int64
                           else torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
    stats = []
    _close(_nhwc(block(_nchw(x), stats)), ref)
    assert len(stats) == 3
    for (_, mean, var), name in zip(stats, ("bn1", "bn2", "bn3")):
        _close(mean, ref_stats[name]["mean"])
        _close(var, ref_stats[name]["var"])
