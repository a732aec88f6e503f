"""The resnet ``Block`` epilogue kernel (``csrc/chan_norm_act.cu``, wrapper
``ops/cuda/norm_act.py``) on the GPU.  Skips without a CUDA device.  This
file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_norm_act_cuda.py

* The kernel against its plain version (the eager epilogue in f32, rounded
  once) in f32 and bf16, channels_last and NCHW, C 32 and 128, at the
  benchmark's map (288 rows x 84 x 70) and at serving's (12 rows), with and
  without FiLM and the residual: f32 within 2e-5 of max|plain| (the channel
  sums run in another order), bf16 within one bf16 step of each element
  plus that; a second launch bit-identical.
* The two layouts give bit-identical outputs; a residual in the other
  layout is copied into x's (counted) and gives the same output; an NCHW
  map whose channels' runs of pixels are no multiple of 16 bytes runs the
  eager ops (counted), its channels_last copy the kernel.
* An inference ``MetNet3`` forward launches the kernel once for each of its
  eight full-resolution ``Block``s and runs no eager epilogue; a training
  step launches it never.
"""

import dataclasses

import numpy as np
import pytest
import torch

import chip_smoke
from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
from vit_grid_model_tpu_torch.core.weights import seeded_model
from vit_grid_model_tpu_torch.models import metnet3
from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.cuda import norm_act as cuda_norm_act

pytestmark = pytest.mark.cuda

# the benchmark's forward (B 24 x 12 leads) and serving's (B 1), 84 x 70
CELL_ROWS, SERVING_ROWS, HP, WP = 288, 12, 84, 70
F32_TOL = 2e-5
BLOCKS = 8   # two ResnetBlocks of two Blocks, in the stem and in resnet2


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _operands(rows, c, h, w, dtype, form, film, res, seed=0):
    return chip_smoke.norm_act_operands((rows, c, h, w), dtype, form, film,
                                        res, seed)


def _run(x, g, b, ss, r):
    """Two launches, counted; returns the first output."""
    before = (cuda_norm_act.launches,
              cuda_norm_act.launches_by_route[cuda_norm_act.layout(x)])
    with torch.inference_mode():
        out = cuda_norm_act.chan_norm_act(x, g, b, ss, r)
        again = cuda_norm_act.chan_norm_act(x, g, b, ss, r)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert (cuda_norm_act.launches,
            cuda_norm_act.launches_by_route[cuda_norm_act.layout(x)]) == (
                before[0] + 2, before[1] + 2)
    return out


FILM_RES = [(False, False), (True, False), (False, True), (True, True)]


@pytest.mark.parametrize("film,res", FILM_RES)
@pytest.mark.parametrize("rows", [CELL_ROWS, SERVING_ROWS])
@pytest.mark.parametrize("c", [32, 128])
@pytest.mark.parametrize("form", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain(dtype, form, c, rows, film, res):
    _need_cuda()
    x, g, b, ss, r = _operands(rows, c, HP, WP, dtype, form, film, res)
    assert cuda_norm_act.route(x, g, b, ss, r) == form
    out = _run(x, g, b, ss, r)
    assert out.dtype == dtype and out.shape == x.shape
    assert cuda_norm_act.layout(out) == form
    ref = cuda_norm_act.chan_norm_act_reference(x, g, b, ss, r)
    scale = ref.float().abs().max().item()
    diff = (out.float() - ref.float()).abs()
    if dtype == torch.float32:
        assert diff.max().item() <= F32_TOL * scale, diff.max().item()
    else:
        # one bf16 step of the element where the f32 values round apart
        bound = 2 ** -7 * ref.float().abs() + F32_TOL * scale
        assert bool((diff <= bound).all()), diff.max().item()
    assert torch.isfinite(out).all()


# (rows, C, H, W): serving's map, and the widest C the kernel takes over
# 14 x 16 (a channel's 224 pixels a whole number of 16 bytes; a row's
# last tile part full)
LAYOUT_SHAPES = [(SERVING_ROWS, 128, HP, WP),
                 (3, cuda_norm_act.MAX_CHANNELS, 14, 16)]


@pytest.mark.parametrize("film,res", FILM_RES)
@pytest.mark.parametrize("shape", LAYOUT_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_layouts_give_bit_identical_outputs(dtype, shape, film, res):
    _need_cuda()
    x, g, b, ss, r = _operands(*shape, dtype, "nhwc", film, res, seed=1)
    nhwc = _run(x, g, b, ss, r)
    nchw = _run(x.contiguous(), g, b, ss,
                None if r is None else r.contiguous())
    assert torch.equal(nhwc.contiguous(), nchw)
    ref = cuda_norm_act.chan_norm_act_reference(x, g, b, ss, r).float()
    err = (nchw.float() - ref).abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else 2 ** -7
    assert err <= tol * ref.abs().max().item(), err


def _norm(g, b):
    norm = vnn.ChanLayerNorm(g.shape[1]).to(g.device, g.dtype)
    with torch.no_grad():
        norm.g.copy_(g)
        norm.b.copy_(b)
    return norm


@pytest.mark.parametrize("form", ["nhwc", "nchw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_residual_in_the_other_layout_is_relaid(dtype, form):
    """``_norm_act`` with the residual in the other layout than x: one
    launch in x's layout, one residual relaid, the output bit-identical to
    that of the residual in x's layout."""
    _need_cuda()
    x, g, b, ss, r = _operands(SERVING_ROWS, 128, HP, WP, dtype, form,
                               False, True, seed=3)
    other = (r.contiguous() if form == "nhwc"
             else r.contiguous(memory_format=torch.channels_last))
    norm = _norm(g, b)
    cuda_norm_act.reset_launches()
    with torch.inference_mode():
        out = metnet3._norm_act(norm, x, None, other)
        same = metnet3._norm_act(norm, x, None, r)
    torch.cuda.synchronize()
    assert (cuda_norm_act.launches, dict(cuda_norm_act.launches_by_route),
            cuda_norm_act.relaid_residuals,
            cuda_norm_act.eager_epilogues) == (2, {form: 2}, 1, 0)
    assert cuda_norm_act.layout(out) == form
    assert torch.equal(out, same)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_an_nchw_map_of_odd_runs_takes_the_eager_ops(dtype):
    """At 13 x 11 a channel's 143 pixels are no whole number of 16 bytes:
    the NCHW map runs the eager ops (one eager epilogue counted), its
    channels_last copy the kernel, and the two agree as the kernel agrees
    with its plain version."""
    _need_cuda()
    x, g, b, ss, r = _operands(5, 40, 13, 11, dtype, "nhwc", True, True,
                               seed=4)
    norm = _norm(g, b)
    flat, flat_r = x.contiguous(), r.contiguous()
    assert "16 bytes" in cuda_norm_act.refusal(flat, g, b, ss, flat_r)
    cuda_norm_act.reset_launches()
    with torch.inference_mode():
        eager = metnet3._norm_act(norm, flat, ss, flat_r)
        ours = metnet3._norm_act(norm, x, ss, r)
    torch.cuda.synchronize()
    assert (cuda_norm_act.launches, cuda_norm_act.eager_epilogues) == (1, 1)
    ref = cuda_norm_act.chan_norm_act_reference(x, g, b, ss, r).float()
    scale = ref.abs().max().item()
    tol = F32_TOL if dtype == torch.float32 else 2 ** -7
    assert (ours.float() - ref).abs().max().item() <= tol * scale
    # the eager bf16 ops round at every step: a few bf16 steps
    eager_tol = F32_TOL if dtype == torch.float32 else 4 * 2 ** -8
    assert (eager.float() - ref).abs().max().item() <= eager_tol * scale


def _shipped(fast):
    cfg = shipped_12hr_model_config(pm25_mean=17.5, pm25_std=12.3)
    if fast:
        cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                  fuse_lead_stem=True, nhwc_input=True)
    return cfg


def _inputs(cfg, batch, seed=0):
    rng = np.random.default_rng(seed)
    shape = ((batch, HP, WP, cfg.window_size * cfg.n_variables)
             if cfg.nhwc_input else
             (batch, cfg.window_size, cfg.n_variables, 82, 67))
    x = torch.from_numpy((rng.random(shape) * 50).astype(np.float32))
    ts = torch.from_numpy(np.stack(
        [np.full(25, 2023.0), np.full(25, 1.0), np.full(25, 15.0),
         np.arange(25) % 24], axis=-1)[None].repeat(batch, 0)
        .astype(np.float32))
    return x, ts


@pytest.mark.parametrize("fast", [False, True])
def test_inference_forward_launches_the_kernel_for_every_block(fast):
    """The shipped 12-hour model at B = 1: f32 (standard stem, held to the
    CPU forward within 1e-3 of max|out|, TF32 off) and ``--fast`` (bf16,
    fused stem, NHWC input): 8 launches a forward, no eager epilogue."""
    _need_cuda()
    dev = torch.device("cuda")
    cfg = _shipped(fast)
    x, ts = _inputs(cfg, 1)
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        model = seeded_model(cfg, 0).to(dev)
        if fast:
            model = model.to(torch.bfloat16)
        cuda_norm_act.reset_launches()
        with torch.inference_mode():
            out = model(x.to(dev), ts.to(dev))
        torch.cuda.synchronize()
        assert cuda_norm_act.launches == BLOCKS
        assert sum(cuda_norm_act.launches_by_route.values()) == BLOCKS
        assert cuda_norm_act.eager_epilogues == 0
        assert torch.isfinite(out).all()
        if not fast:
            with torch.inference_mode():
                cpu = seeded_model(cfg, 0)(x, ts)
            rel = ((out.cpu() - cpu).abs().max()
                   / cpu.abs().max()).item()
            assert rel <= 1e-3, rel
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32


def test_training_step_launches_no_kernel():
    """A training forward and backward of the shipped model at B = 1 on the
    card: every epilogue runs the eager ops (8 of them), none the kernel."""
    _need_cuda()
    dev = torch.device("cuda")
    cfg = dataclasses.replace(_shipped(False), dropout=0.0)
    x, ts = _inputs(cfg, 1, seed=2)
    model = seeded_model(cfg, 0).to(dev).train()
    cuda_norm_act.reset_launches()
    out = model(x.to(dev), ts.to(dev), bn_stats=[])
    out.float().mean().backward()
    torch.cuda.synchronize()
    assert cuda_norm_act.launches == 0
    assert cuda_norm_act.eager_epilogues == BLOCKS
    grads = [p.grad for p in model.resnet1.parameters()]
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
