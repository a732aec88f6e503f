"""The PyTorch port's legacy building blocks against the JAX package on the
same numpy inputs (f32; JAX under the conftest's highest matmul precision):
``ops/recurrent.py``, ``models/normalizers.py`` and ``ops/convblocks.py``.
Parameters come from the JAX initialisers (perturbed where they start as
constants) through the port's exporter helpers.  Tolerance: max|port - jax|
<= 1e-5 * max|jax|, sums taken in another order."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.models import normalizers as JN
from vit_grid_model_tpu.ops import convblocks as JCB
from vit_grid_model_tpu.ops import recurrent as JR
from vit_grid_model_tpu_torch.core import export as E
from vit_grid_model_tpu_torch.models import normalizers as TN
from vit_grid_model_tpu_torch.ops import convblocks as TCB
from vit_grid_model_tpu_torch.ops import recurrent as TR

REL = 1e-5


def _close(ours, ref, rel=REL):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err <= rel, err


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _load(module, emit, p, **kw):
    """Load JAX params ``p`` into ``module`` through the port's exporter
    helper ``emit``, strictly."""
    out = {}
    emit(out, "m", p, **kw)
    module.load_state_dict({k[2:]: torch.from_numpy(v)
                            for k, v in out.items()}, strict=True)
    return module


def test_lstm_cell():
    p = JR.lstm_cell_init(jax.random.PRNGKey(0), 10, 16)
    x, h, c = _rand(4, 10, seed=1), _rand(4, 16, seed=2), _rand(4, 16, seed=3)
    h_j, c_j = JR.lstm_cell(p, jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    cell = _load(torch.nn.LSTMCell(10, 16), E._emit_lstm, p)
    h_t, c_t = TR.lstm_cell(cell, _t(x), _t(h), _t(c))
    _close(h_t, h_j)
    _close(c_t, c_j)


def _mha(e, seed):
    """JAX's MHA params with non-zero biases, and the port's module."""
    p = JR.mha_init(jax.random.PRNGKey(seed), e)
    p["in_proj_b"] = jnp.asarray(_rand(3 * e, seed=seed + 1, scale=0.1))
    p["out_proj"]["b"] = jnp.asarray(_rand(e, seed=seed + 2, scale=0.1))
    return p, _load(torch.nn.MultiheadAttention(e, 1), E._emit_mha, p)


def _valid(b, n, seed):
    valid = np.random.default_rng(seed).random((b, n)) > 0.3
    valid[0] = False                   # a row with no valid key
    valid[1, 0] = True
    return valid


def test_mha_self_attention_masked_row_gives_zeros():
    p, mha = _mha(16, 4)
    x, valid = _rand(3, 7, 16, seed=5), _valid(3, 7, 6)
    y_j = JR.mha_self_attention(p, jnp.asarray(x),
                                key_padding_mask=jnp.asarray(~valid))
    with torch.no_grad():
        y_t = TR.mha_self_attention(mha, _t(x),
                                    key_padding_mask=torch.from_numpy(~valid))
    _close(y_t, y_j)
    # the fully masked row attends to nothing: its output is the out
    # projection's bias alone, finite
    assert torch.equal(y_t[0], mha.out_proj.bias.detach().expand(7, 16))


def test_residual_masked_attention():
    p, mha = _mha(16, 7)
    x, valid = _rand(3, 5, 16, seed=8), _valid(3, 5, 9)
    y_j = JR.residual_masked_attention(p, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        y_t = TR.residual_masked_attention(mha, _t(x),
                                           torch.from_numpy(valid))
    _close(y_t, y_j)
    assert torch.equal(y_t[0], _t(x)[0])   # no valid station: unchanged


def test_time_encode():
    p = JN.time_encode_init(4)
    t = np.random.default_rng(10).random((5, 6)).astype(np.float32) * 30
    te = _load(TN.TimeEncode(4), E._emit_time_encode, p)
    _close(te(_t(t)), JN.time_encode(p, jnp.asarray(t)))
    # the port's own initialisation is JAX's
    fresh = TN.TimeEncode(4)
    np.testing.assert_array_equal(fresh.w.weight.detach().numpy(),
                                  np.asarray(p["w"]))


@pytest.mark.parametrize("eps", [1e-5, 0.0])
def test_revin_nan_and_zero_std_slices(eps):
    x = _rand(3, 8, 6, seed=11, scale=10.0) + 20.0
    x[0, 2, 1] = np.nan                # one NaN: slice (0, :, 1) defaults
    x[1, :, 3] = np.nan                # an all-NaN slice
    x[2, :, 2] = 7.0                   # zero variance: defaults when eps 0
    y = _rand(3, 5, 6, seed=12, scale=10.0)
    p = {"affine_weight": jnp.asarray(1.0 + _rand(6, seed=13, scale=0.2)),
         "affine_bias": jnp.asarray(_rand(6, seed=14, scale=0.2))}
    stats_j = JN.revin_statistics(jnp.asarray(x), default_mean=20.0,
                                  default_std=10.0, eps=eps)
    stats_t = TN.revin_statistics(_t(x), default_mean=20.0,
                                  default_std=10.0, eps=eps)
    _close(stats_t.mean, stats_j.mean)
    _close(stats_t.stdev, stats_j.stdev)
    assert stats_t.mean[0, 0, 1] == 20.0 and stats_t.stdev[1, 0, 3] == 10.0
    assert (stats_t.stdev[2, 0, 2] == 10.0) == (eps == 0.0)
    rv = _load(TN.RevIN(6), E._emit_revin, p)
    n_j = JN.revin_norm(p, stats_j, jnp.asarray(y))
    n_t = rv.norm(stats_t, _t(y))
    _close(n_t, n_j)
    _close(rv.denorm(stats_t, n_t), JN.revin_denorm(p, stats_j, n_j))
    _close(rv.denorm2(stats_t, n_t[:, :, :4]),
           JN.revin_denorm2(p, stats_j, n_j[:, :, :4]))


def test_revin_without_affine():
    x, y = _rand(2, 6, 5, seed=15), _rand(2, 4, 5, seed=16)
    stats_j = JN.revin_statistics(jnp.asarray(x), default_mean=0.0,
                                  default_std=1.0)
    stats_t = TN.revin_statistics(_t(x), default_mean=0.0, default_std=1.0)
    rv = TN.RevIN(5, affine=False)
    assert not rv.state_dict()         # the exporter emits nothing either
    n_t = rv.norm(stats_t, _t(y))
    _close(n_t, JN.revin_norm({}, stats_j, jnp.asarray(y)))
    _close(rv.denorm(stats_t, n_t),
           JN.revin_denorm({}, stats_j, jnp.asarray(n_t.numpy())))


def test_dishts():
    p = JN.dishts_init(6, 5)
    p = {"reduce_mlayer": p["reduce_mlayer"]
         + jnp.asarray(_rand(6, 5, 2, seed=17, scale=0.1)),
         "gamma": jnp.asarray(1.0 + _rand(6, seed=18, scale=0.2)),
         "beta": jnp.asarray(_rand(6, seed=19, scale=0.2))}
    x = _rand(3, 5, 6, seed=20, scale=10.0) + 15.0
    z = _rand(3, 1, 6, seed=21)
    n_j, stats_j = JN.dishts_norm(p, jnp.asarray(x))
    dt = _load(TN.DishTS(6, 5), E._emit_dishts, p)
    n_t, stats_t = dt.norm(_t(x))
    _close(n_t, n_j)
    for a, b in zip(stats_t, stats_j):
        _close(a, b)
    # denorm reuses the last norm call's statistics
    _close(dt.denorm(stats_t, _t(z)), JN.dishts_denorm(p, stats_j,
                                                       jnp.asarray(z)))
    # the port's own initialisation is JAX's
    for k, v in TN.DishTS(6, 5).state_dict().items():
        np.testing.assert_array_equal(v.numpy(),
                                      np.asarray(JN.dishts_init(6, 5)[k]))


def _perturb_norm(p, seed):
    p["norm"] = {"g": jnp.asarray(1.0 + _rand(*p["norm"]["g"].shape,
                                              seed=seed, scale=0.2)),
                 "b": jnp.asarray(_rand(*p["norm"]["b"].shape,
                                        seed=seed + 1, scale=0.2))}
    return p


@pytest.mark.parametrize("stride,transpose,hw", [
    (1, False, (9, 10)), (2, False, (9, 10)), (2, True, (5, 6)),
    (1, True, (9, 10))])
def test_conv_sc(stride, transpose, hw):
    p = _perturb_norm(JCB.conv_sc_init(jax.random.PRNGKey(22), 6, 8), 23)
    x = _rand(2, *hw, 6, seed=24)
    y_j = JCB.conv_sc(p, jnp.asarray(x), stride=stride, transpose=transpose)
    m = TCB.ConvSC(6, 8, stride=stride, transpose=transpose)
    # stride 1 forces a plain conv, as in the reference
    assert isinstance(m.conv.conv, torch.nn.ConvTranspose2d) == (
        transpose and stride == 2)
    _load(m.conv, E._emit_basic_conv, p,
          transpose=transpose and stride == 2)
    with torch.no_grad():
        y_t = m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(y_t, y_j)


@pytest.mark.parametrize("c_in,groups", [(8, 4), (6, 4)])
def test_group_conv2d(c_in, groups):
    p = _perturb_norm(JCB.group_conv2d_init(jax.random.PRNGKey(25), c_in, 8,
                                            3, groups), 26)
    x = _rand(2, 7, 6, c_in, seed=27)
    y_j = JCB.group_conv2d(p, jnp.asarray(x), kernel=3, groups=groups)
    m = TCB.GroupConv2d(c_in, 8, 3, groups)
    g = TCB.effective_groups(c_in, groups)
    assert g == (groups if c_in % groups == 0 else 1)
    assert m.conv.groups == m.norm.num_groups == g
    _load(m, E._emit_basic_conv, p, transpose=False)
    with torch.no_grad():
        y_t = m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(y_t, y_j)


def test_inception_sums_its_branches():
    p = JCB.inception_init(jax.random.PRNGKey(28), 6, 4, 8, (3, 5), 2)
    x = _rand(2, 7, 6, 6, seed=29)
    y_j = JCB.inception(p, jnp.asarray(x), incep_ker=(3, 5), groups=2)
    m = TCB.Inception(6, 4, 8, (3, 5), 2)
    out = {}
    E._emit_conv(out, "conv1", p["conv1"])
    for j, br in enumerate(p["layers"]):
        E._emit_basic_conv(out, f"layers.{j}", br, transpose=False)
    m.load_state_dict({k: torch.from_numpy(v) for k, v in out.items()},
                      strict=True)
    with torch.no_grad():
        y_t = m(_t(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    _close(y_t, y_j)
