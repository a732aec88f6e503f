"""The port's int8 PTQ (``ops/quantize.py`` and the int8 route of
``MetNet3``) against the JAX package's ``ops/quantize.py``, on the CPU at
``tests/test_int8.py``'s geometry (the 82x67 grid, 16 channels, window 4,
4 heads x 8, 2 leads, batch 2), f32, JAX under 'highest' precision:

* ``quantize_conv``'s ``wq``, ``sw`` and ``sx`` and ``conv2d_int8``'s
  output bit-equal to JAX's on the same weights, amax and input, in f32
  and bf16; the im2col route that CUDA tensors take (``torch._int_mm``)
  bit-equal to the plain float64 conv, incl. ragged shapes and chunks;
* the calibration forward records JAX's sites, each amax within 1e-5
  relative, for the standard and the fused stem; the default skip leaves
  the seven convs of ``resnet_block_depth=2``;
* the int8 forward, on JAX's sidecars carried by ``params_from_jax``,
  within 1e-4 of max|y| of JAX's int8 forward when each int8 conv is fed
  the integer activations JAX's forward quantized (a conv's integer input
  is a rounding of float activations that differ from JAX's by float
  noise, so running free a few levels flip where that noise crosses a
  .5: 2 to 334 of 376,320 at the seven sites here, which moves the
  fields by up to 1.6% of their max); free-running, on the port's own
  calibration too, its RMSE from JAX's int8 forward under a quarter of
  the int8 forward's own RMSE from the float forward (measured 0.08 and
  0.02 of it); against the port's own float forward JAX's gates (RMSE <
  0.5, max < 5 ug/m3); sidecars with the flag off, and the flag on without
  sidecars, bit-equal to the float forward;
* after ``model.to(torch.bfloat16)`` the sidecars are still int8 weights
  with f32 scales and bias; a quantized state_dict round-trips through a
  ``.pkt``; the NHWC-input int8 forward matches JAX's."""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.models.metnet3 import (metnet3_apply, metnet3_init,
                                               pad_values)
from vit_grid_model_tpu.ops import nn as jnn
from vit_grid_model_tpu.ops import quantize as JQ
from vit_grid_model_tpu_torch.core import checkpoint as ckpt
from vit_grid_model_tpu_torch.core.weights import (load_reference_checkpoint,
                                                   params_from_jax)
from vit_grid_model_tpu_torch.ops import quantize as Q

REL = 1e-4
NOISE_SHARE = 0.25
AMAX_REL = 1e-5
SEVEN = {"resnet1.0.block2", "resnet1.1.block1", "resnet1.1.block2",
         "resnet2.0.block1", "resnet2.0.block2", "resnet2.1.block1",
         "resnet2.1.block2"}


def _cfg(**over):
    base = dict(window_size=4, n_variables=6, n_start_channels=16,
                end_lead_time=2, pm25_mean=20.0, pm25_std=10.0, n_heads=4,
                dim_head=8, pm25_channel_indices=(1, 2, 3, 4))
    base.update(over)
    return MetNet3Config(**base)


def _inputs(seed=1):
    rng = np.random.default_rng(seed)
    x = (rng.random((2, 4, 6, 82, 67)) * 50).astype(np.float32)
    ts = np.tile(np.asarray([2023.0, 1.0, 15.0, 6.0], np.float32), (2, 4, 1))
    return x, ts


def _jax_apply(params, cfg, x, ts, **kw):
    return jax.jit(lambda p, a, b: metnet3_apply(p, a, b, cfg, **kw))(
        params, jnp.asarray(x), jnp.asarray(ts))


def _port(model, x, ts, **kw):
    with torch.no_grad():
        return model(torch.from_numpy(x), torch.from_numpy(ts), **kw)


def _jax_int8(qparams, cfg, x, ts):
    """JAX's int8 forward and the int8 input of each of its int8 convs, in
    the order the forward runs them (NHWC)."""
    def run(p, a, b):
        seen = []
        conv = JQ.conv2d_int8

        def spy(qp, xx, **kw):
            seen.append(jnp.clip(jnp.round(xx.astype(jnp.float32)
                                           * (1.0 / qp["sx"])),
                                 -127, 127).astype(jnp.int8))
            return conv(qp, xx, **kw)

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(JQ, "conv2d_int8", spy)
            y = metnet3_apply(p, a, b, cfg)
        return y, seen

    y, seen = jax.jit(run)(qparams, jnp.asarray(x), jnp.asarray(ts))
    return np.asarray(y), [np.asarray(a) for a in seen]


def _port_on(model, x, ts, activations):
    """The port's forward with each int8 conv fed the given NHWC integer
    activations in turn instead of its own quantized input."""
    feed = iter(activations)

    def forced(xx, sx):
        return torch.from_numpy(np.array(next(feed))).permute(0, 3, 1, 2)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(Q, "quantize_input", forced)
        y = _port(model, x, ts).numpy()
    assert next(feed, None) is None
    return y


def _rmse(a):
    return float(np.sqrt(np.mean(np.square(a, dtype=np.float64))))


@functools.lru_cache(maxsize=None)
def _case(fuse):
    """JAX's float forward, calibration and int8 forward for one stem."""
    cfg = _cfg(fuse_lead_stem=fuse)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    x, ts = _inputs()
    amax = jax.jit(lambda p, a, b: _collect(p, a, b, cfg))(
        params, jnp.asarray(x), jnp.asarray(ts))
    qparams = JQ.attach_int8_sidecars(
        params, {k: float(v) for k, v in amax.items()
                 if k not in JQ.DEFAULT_SKIP})
    cfg_q = dataclasses.replace(cfg, int8_convs=True)
    y_int8, activations = _jax_int8(qparams, cfg_q, x, ts)
    return dict(cfg=cfg, cfg_q=cfg_q, params=params, qparams=qparams, x=x,
                ts=ts, amax={k: float(v) for k, v in amax.items()},
                y0=np.asarray(_jax_apply(params, cfg, x, ts)),
                y_int8=y_int8, activations=activations)


@pytest.fixture(params=[False, True], ids=["standard", "fused"])
def case(request):
    return _case(request.param)


@pytest.fixture
def fused_case():
    """For what the stem does not change: the ``--fast`` stem's case."""
    return _case(True)


def _collect(p, a, b, cfg):
    col = {}
    metnet3_apply(p, a, b, cfg, collect_amax=col)
    return col


@pytest.mark.parametrize("channels,dtype", [
    (32, jnp.float32), (128, jnp.float32), (16, jnp.bfloat16)])
def test_quantize_conv_and_conv2d_int8_bit_equal(channels, dtype):
    p = jnn.conv_init(jax.random.PRNGKey(0), 3, 3, channels, channels)
    x = (np.random.default_rng(1).standard_normal((2, 12, 11, channels))
         * 3).astype(np.float32)
    amax = float(np.abs(x).max()) * 0.7          # some inputs clip
    ref = JQ.quantize_conv(p, amax)
    # exact halves of a level, where the rounding rule decides
    sx = np.float32(ref["sx"])
    x[0, 0, :8, 0] = (np.arange(-4, 4) + 0.5).astype(np.float32) * sx
    w = torch.from_numpy(np.transpose(np.asarray(p["w"]), (3, 2, 0, 1)).copy())
    q = Q.quantize_conv(w, torch.from_numpy(np.array(p["b"])), amax)
    np.testing.assert_array_equal(
        q.wq.numpy(), np.transpose(np.asarray(ref["wq"]), (3, 2, 0, 1)))
    np.testing.assert_array_equal(q.sw.numpy(), np.asarray(ref["sw"]))
    assert q.sx.numpy() == np.asarray(ref["sx"])
    assert q.wq.dtype == torch.int8 and q.sw.dtype == q.sx.dtype == \
        q.b.dtype == torch.float32

    y_ref = np.asarray(JQ.conv2d_int8(ref, jnp.asarray(x, dtype), padding=1)
                       .astype(jnp.float32))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(
        torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    y = Q.conv2d_int8(q, xt)
    assert y.dtype == xt.dtype
    np.testing.assert_array_equal(y.float().permute(0, 2, 3, 1).numpy(), y_ref)

    xq = Q.quantize_input(xt, q.sx)
    before = Q.launches
    np.testing.assert_array_equal(
        Q.int8_conv_accumulate_im2col(xq, q.wq).numpy(),
        Q.int8_conv_accumulate_plain(xq, q.wq).numpy())
    assert Q.launches == before + 1


@pytest.mark.parametrize("n,c,h,w,o,chunk", [
    (3, 16, 9, 7, 16, 2), (2, 5, 6, 5, 3, 1), (1, 3, 2, 3, 8, 1),
    (4, 128, 14, 10, 128, 4)])
def test_im2col_route_matches_plain(n, c, h, w, o, chunk, monkeypatch):
    """Ragged K and O (padded to multiples of 8), M <= 16 (padded to 17),
    chunks of ``chunk`` samples; values at the int8 extremes."""
    g = torch.Generator().manual_seed(n * c + o)
    xq = torch.randint(-127, 128, (n, c, h, w), generator=g).to(torch.int8)
    wq = torch.randint(-127, 128, (o, c, 3, 3), generator=g).to(torch.int8)
    xq[0, :, 0, 0] = 127
    wq[0] = -127
    monkeypatch.setattr(Q, "IM2COL_BYTES", 9 * c * h * w * chunk)
    before = Q.launches
    got = Q.int8_conv_accumulate_im2col(
        xq.contiguous(memory_format=torch.channels_last), wq)
    assert Q.launches == before + 1
    assert got.dtype == torch.int32 and got.shape == (n, o, h, w)
    torch.testing.assert_close(got, Q.int8_conv_accumulate_plain(xq, wq),
                               rtol=0, atol=0)
    with pytest.raises(TypeError):
        Q.int8_conv_accumulate(xq.float(), wq)


def test_integer_conv_is_exact_above_2_to_24():
    """|sum| reaches 9 * 128 * 127**2 = 18,580,608 > 2**24: an f32 (or
    TF32) conv over the quantized values rounds an odd sum there, the
    plain float64 conv and the im2col route do not."""
    xq = torch.full((1, 128, 3, 3), 127, dtype=torch.int8)
    wq = torch.full((2, 128, 3, 3), 127, dtype=torch.int8)
    wq[0, 0, 1, 1] = 126
    expect = 9 * 128 * 127 ** 2 - 127                     # odd, > 2**24
    assert expect > 2 ** 24 and expect % 2 == 1
    for acc in (Q.int8_conv_accumulate_plain(xq, wq),
                Q.int8_conv_accumulate_im2col(xq, wq)):
        assert int(acc[0, 0, 1, 1]) == expect
        assert int(acc[0, 1, 1, 1]) == expect + 127


def test_calibration_records_jax_sites(case):
    model = params_from_jax(case["params"], case["cfg"])
    got = {}
    _port(model, case["x"], case["ts"], collect_amax=got)
    assert set(got) == set(case["amax"])
    expect = SEVEN | ({"resnet1.0.block1"} if not case["cfg"].fuse_lead_stem
                      else set())
    assert set(got) == expect
    for site, v in got.items():
        ref = case["amax"][site]
        assert abs(float(v) - ref) <= AMAX_REL * ref, (site, float(v), ref)
        assert v.dtype == torch.float32
    Q.quantize_metnet3_int8(model, [(torch.from_numpy(case["x"]),
                                     torch.from_numpy(case["ts"]))])
    sites = {f"{stage}.{i}.{name}"
             for stage in ("resnet1", "resnet2")
             for i, blk in enumerate(getattr(model, stage).blocks)
             for name in ("block1", "block2")
             if getattr(blk, name).proj_q is not None}
    assert sites == SEVEN


def test_int8_forward_matches_jax_and_meets_its_gates(case):
    x, ts = case["x"], case["ts"]
    y0 = _port(params_from_jax(case["params"], case["cfg"]), x, ts).numpy()

    model = params_from_jax(case["params"], case["cfg_q"])
    # the flag alone, without sidecars: the float path, bitwise
    np.testing.assert_array_equal(_port(model, x, ts).numpy(), y0)
    Q.quantize_metnet3_int8(model, [(torch.from_numpy(x),
                                     torch.from_numpy(ts))])
    y1 = _port(model, x, ts).numpy()
    ref = case["y_int8"]
    noise = _rmse(ref - case["y0"])
    assert _rmse(y1 - ref) < NOISE_SHARE * noise
    # JAX's own sidecars, carried across by params_from_jax: free-running,
    # and on JAX's integer activations
    jq = params_from_jax(case["qparams"], case["cfg_q"])
    assert _rmse(_port(jq, x, ts).numpy() - ref) < NOISE_SHARE * noise
    assert len(case["activations"]) == len(SEVEN)
    y_on = _port_on(jq, x, ts, case["activations"])
    assert np.abs(y_on - ref).max() <= REL * np.abs(ref).max()

    # tests/test_int8.py's gates, against the port's own float forward
    rmse = float(np.sqrt(np.mean((y1 - y0) ** 2)))
    assert rmse < 0.5, rmse
    assert np.abs(y1 - y0).max() < 5.0
    # sidecars under int8_convs=False: the float path, bitwise
    off = params_from_jax(case["qparams"], case["cfg"])
    assert off.resnet2.blocks[0].block1.proj_q is not None
    np.testing.assert_array_equal(_port(off, x, ts).numpy(), y0)


def test_params_from_jax_carries_the_sidecars(fused_case):
    model = params_from_jax(fused_case["qparams"], fused_case["cfg_q"])
    for stage in ("resnet1", "resnet2"):
        for i, blk in enumerate(fused_case["qparams"][stage]["blocks"]):
            for name in ("block1", "block2"):
                ours = getattr(getattr(model, stage).blocks[i], name).proj_q
                if "proj_q" not in blk[name]:
                    assert ours is None
                    continue
                ref = blk[name]["proj_q"]
                np.testing.assert_array_equal(
                    ours.wq.numpy(),
                    np.transpose(np.asarray(ref["wq"]), (3, 2, 0, 1)))
                for leaf in ("sw", "sx", "b"):
                    np.testing.assert_array_equal(
                        getattr(ours, leaf).numpy(), np.asarray(ref[leaf]))


def test_sidecars_keep_their_dtypes_under_a_cast(fused_case):
    """``nn.Module.to`` casts every float buffer; the sidecars' must not
    be rounded to bf16 (nor widened), while a device move reaches them."""
    model = params_from_jax(fused_case["qparams"], fused_case["cfg_q"])
    q = model.resnet2.blocks[1].block2.proj_q
    sw = q.sw.clone()
    for dtype in (torch.bfloat16, torch.float64, torch.float32):
        model.to(dtype)
        assert model.up.weight.dtype == dtype
        assert q.wq.dtype == torch.int8
        assert q.sw.dtype == q.sx.dtype == q.b.dtype == torch.float32
    assert torch.equal(q.sw, sw)
    model.to(device="cpu", dtype=torch.bfloat16)
    assert q.sw.dtype == torch.float32 and q.sw.device.type == "cpu"
    y = _port(model, fused_case["x"], fused_case["ts"])
    assert y.dtype == torch.float32 and np.isfinite(y.numpy()).all()
    state = model.state_dict()
    assert state["resnet2.blocks.1.block2.proj_q.sx"].dtype == torch.float32


def test_quantized_state_dict_round_trips(fused_case, tmp_path):
    model = params_from_jax(fused_case["params"], fused_case["cfg_q"])
    Q.quantize_metnet3_int8(model, [(torch.from_numpy(fused_case["x"]),
                                     torch.from_numpy(fused_case["ts"]))])
    path = ckpt.save_state_dict(str(tmp_path / "q.pkt"), model)
    back = load_reference_checkpoint(path, fused_case["cfg_q"])
    ours, theirs = model.state_dict(), back.state_dict()
    assert set(ours) == set(theirs)
    assert sum(k.endswith("proj_q.wq") for k in ours) == len(SEVEN)
    for k, v in ours.items():
        assert theirs[k].dtype == v.dtype and torch.equal(theirs[k], v), k
    np.testing.assert_array_equal(
        _port(back, fused_case["x"], fused_case["ts"]).numpy(),
        _port(model, fused_case["x"], fused_case["ts"]).numpy())


def test_nhwc_input_int8_matches_jax():
    """The host-prepared (B, Hp, Wp, T*C) input with the fused stem, the
    ``--fast`` layout, in f32: JAX's quantized pytree through both."""
    cfg = _cfg(fuse_lead_stem=True, nhwc_input=True, int8_convs=True)
    params = metnet3_init(jax.random.PRNGKey(3), cfg)
    x, ts = _inputs(2)
    le, ri, to, bo = pad_values(82, 67, cfg.pad_multiple)
    xp = np.zeros((2, 82 + to + bo, 67 + le + ri, 24), np.float32)
    xp[:, to:to + 82, le:le + 67] = x.reshape(2, 24, 82, 67).transpose(
        0, 2, 3, 1)
    qparams = JQ.quantize_metnet3_int8(params, cfg, [(jnp.asarray(xp),
                                                      jnp.asarray(ts))])
    ref, activations = _jax_int8(qparams, cfg, xp, ts)
    y0 = np.asarray(_jax_apply(params, dataclasses.replace(
        cfg, int8_convs=False), xp, ts))
    model = params_from_jax(params, cfg)
    Q.quantize_metnet3_int8(model, [(torch.from_numpy(xp),
                                     torch.from_numpy(ts))])
    assert model.resnet1.blocks[0].block2.proj_q is not None
    y = _port(model, xp, ts).numpy()
    assert _rmse(y - ref) < NOISE_SHARE * _rmse(ref - y0)
    y_on = _port_on(params_from_jax(qparams, cfg), xp, ts, activations)
    assert np.abs(y_on - ref).max() <= REL * np.abs(ref).max()


def test_bf16_calibration_casts_like_metnet3_apply(fused_case):
    """A bf16 config calibrates on bf16 activations (the amax a bf16 copy
    of the model records) and quantizes the f32 master weights."""
    cfg = dataclasses.replace(fused_case["cfg_q"], compute_dtype="bfloat16")
    model = params_from_jax(fused_case["params"], cfg)
    x = torch.from_numpy(fused_case["x"])
    ts = torch.from_numpy(fused_case["ts"])
    got = {}
    with torch.no_grad():
        params_from_jax(fused_case["params"], cfg).to(torch.bfloat16)(
            x, ts, collect_amax=got)
    Q.quantize_metnet3_int8(model, [(x, ts)])
    for site in SEVEN:
        block = Q._block(model, site)
        assert block.proj.weight.dtype == torch.float32
        ref = Q.quantize_conv(block.proj.weight, block.proj.bias,
                              float(got[site]))
        for leaf in ("wq", "sw", "sx", "b"):
            assert torch.equal(getattr(block.proj_q, leaf),
                               getattr(ref, leaf)), (site, leaf)


def test_forecaster_serves_a_quantized_model(fused_case):
    """``Forecaster`` copies the sidecars with the weights and keeps their
    dtypes; on the CPU in f32 its fields are the model's own forward."""
    from vit_grid_model_tpu_torch.evaluation.serving import Forecaster

    model = params_from_jax(fused_case["qparams"], fused_case["cfg_q"])
    f = Forecaster(model, batch_size=2, fast=False, warmup=0, device="cpu")
    q = f.model.resnet2.blocks[0].block1.proj_q
    assert q.wq.dtype == torch.int8 and q.sx.dtype == torch.float32
    x, ts = fused_case["x"], fused_case["ts"]
    np.testing.assert_array_equal(f.predict(x, ts),
                                  _port(model, x, ts).numpy())
