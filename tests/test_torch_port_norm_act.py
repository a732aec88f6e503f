"""The resnet ``Block`` epilogue's plain version and routing on the CPU
(``ops/cuda/norm_act.py``; the kernel itself runs only on the card, see
``tests/test_torch_port_norm_act_cuda.py``).

The plain version ``chan_norm_act_reference`` is the eager epilogue of
``models/metnet3.py::_norm_act`` plus the residual, computed in f32 and
rounded once: bit-equal to it in f32, and in bf16 bit-equal to the f32 eager
epilogue of the same bf16 operands, rounded; within one bf16 step of the
eager bf16 epilogue.  Both layouts, with and without FiLM and the residual.
``refusal`` names why the kernel would not take an operand set (a residual
in the other dense layout it takes); on the CPU, or under autograd,
``_norm_act`` runs the eager ops and leaves the counters as they were."""

import numpy as np
import pytest
import torch

import chip_smoke
from vit_grid_model_tpu_torch.core.config import MetNet3Config
from vit_grid_model_tpu_torch.core.weights import seeded_model
from vit_grid_model_tpu_torch.models import metnet3
from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.cuda import norm_act as cuda_norm_act

N, C, H, W = 3, 16, 5, 7


def _operands(dtype, form, film, res, seed=0, c=C, hw=(H, W)):
    """``chip_smoke``'s operands on the CPU, with g and b in a
    ChanLayerNorm."""
    x, g, b, scale_shift, r = chip_smoke.norm_act_operands(
        (N, c, *hw), dtype, form, film, res, seed, device="cpu")
    norm = vnn.ChanLayerNorm(c).to(dtype)
    with torch.no_grad():
        norm.g.copy_(g)
        norm.b.copy_(b)
    return x, norm, scale_shift, r


def _eager(norm, x, scale_shift, r):
    y = metnet3._norm_act(norm, x, scale_shift)
    return y if r is None else y + r


@pytest.mark.parametrize("res", [False, True])
@pytest.mark.parametrize("film", [False, True])
@pytest.mark.parametrize("form", ["nchw", "nhwc"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_reference_is_the_eager_epilogue(dtype, form, film, res):
    x, norm, ss, r = _operands(dtype, form, film, res)
    ref = cuda_norm_act.chan_norm_act_reference(x, norm.g, norm.b, ss, r)
    assert ref.dtype == dtype and ref.shape == x.shape
    with torch.no_grad():
        if dtype == torch.float32:
            assert torch.equal(ref, _eager(norm, x, ss, r))
            return
        f32 = None if ss is None else tuple(t.float() for t in ss)
        wide = _eager(norm.float(), x.float(), f32,
                      None if r is None else r.float())
        assert torch.equal(ref, wide.to(dtype))
        eager = _eager(norm.to(dtype), x, ss, r).float()
    # the eager bf16 ops round at every step: within a few bf16 steps
    err = (ref.float() - eager).abs().max().item()
    assert err <= 4 * 2 ** -8 * eager.abs().max().item(), err


def test_cpu_wrapper_runs_the_reference_in_either_layout():
    x, norm, ss, r = _operands(torch.float32, "nhwc", True, True)
    before = (cuda_norm_act.launches, cuda_norm_act.eager_epilogues)
    out = cuda_norm_act.chan_norm_act(x, norm.g, norm.b, ss, r)
    assert torch.equal(out, cuda_norm_act.chan_norm_act_reference(
        x, norm.g, norm.b, ss, r))
    # the same values in the other layout: the CPU's channel sums run in
    # another order there, so the output agrees to f32 rounding
    flat = cuda_norm_act.chan_norm_act(x.contiguous(), norm.g, norm.b, ss,
                                       r.contiguous())
    assert flat.is_contiguous() and out.is_contiguous(
        memory_format=torch.channels_last)
    err = (out - flat).abs().max().item()
    assert err <= 1e-6 * out.abs().max().item(), err
    assert (cuda_norm_act.launches, cuda_norm_act.eager_epilogues) == before


def test_layout_reads_the_strides():
    x = torch.zeros(N, C, H, W)
    assert cuda_norm_act.layout(x) == "nchw"
    assert cuda_norm_act.layout(
        x.contiguous(memory_format=torch.channels_last)) == "nhwc"
    assert cuda_norm_act.layout(x[..., 1:]) is None
    assert cuda_norm_act.layout(x.permute(0, 1, 3, 2)) is None
    assert cuda_norm_act.layout(x[0]) is None


def _misaligned(dtype):
    """A contiguous x whose data starts one element past an aligned one, at
    4 x 8 (a channel's run of pixels 16-byte whole)."""
    return torch.zeros(N * C * 32 + 1, dtype=dtype)[1:].view(N, C, 4, 8)


REFUSALS = {
    "grad": "requires grad",
    "float16": "dtype",
    "channels12": "12 channels",
    "channels1024": "1024 channels",
    "strided": "neither contiguous nor channels_last",
    "residual_layout": "another shape than x, or is not dense",
    "odd_run": "no multiple of 16 bytes",
    "scale_shape": "(N, C, 1, 1)",
    "dtype_mix": "another dtype",
    "misaligned": "16-byte aligned",
    "cpu": "no kernel for cpu",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_refusal_names_what_the_kernel_does_not_take(case):
    """``refusal`` on CPU tensors: each case's reason; ``route`` is None in
    every case (a CPU tensor is never routed)."""
    dtype = torch.bfloat16
    c = {"channels12": 12, "channels1024": 1024}.get(case, C)
    x, norm, ss, r = _operands(dtype, "nhwc", True, True, c=c)
    g, b = norm.g, norm.b
    if case == "grad":
        x = x.detach().requires_grad_()
    elif case == "float16":
        x, g, b = x.half(), g.half(), b.half()
        ss, r = tuple(t.half() for t in ss), r.half()
    elif case == "strided":
        x, r = x[..., 1:], r[..., 1:]
    elif case == "residual_layout":
        r = r.transpose(2, 3).contiguous().transpose(2, 3)
    elif case == "odd_run":
        # NCHW at 5 x 7: a channel's 35 pixels are 70 bytes
        x, r = x.contiguous(), r.contiguous()
    elif case == "scale_shape":
        ss = tuple(t[:1] for t in ss)
    elif case == "dtype_mix":
        r = r.float()
    elif case == "misaligned":
        x, r = _misaligned(dtype), None
    with torch.enable_grad():
        why = cuda_norm_act.refusal(x, g.detach(), b.detach(), ss, r)
        assert cuda_norm_act.route(x, g.detach(), b.detach(), ss, r) is None
    assert why is not None and REFUSALS[case] in why, why


@pytest.mark.parametrize("form", ["nchw", "nhwc"])
def test_a_residual_in_the_other_layout_is_taken(form):
    """x in one dense layout and the residual in the other: only the device
    refuses them here (the kernel copies the residual into x's layout);
    the CPU wrapper gives the plain version of the same values."""
    # 4 x 8: an NCHW channel's run of 32 pixels is 128 bytes
    x, norm, ss, r = _operands(torch.float32, form, True, True, hw=(4, 8))
    r = (r.contiguous(memory_format=torch.channels_last) if form == "nchw"
         else r.contiguous())
    assert cuda_norm_act.layout(x) == form != cuda_norm_act.layout(r)
    with torch.no_grad():
        assert cuda_norm_act.refusal(x, norm.g, norm.b, ss, r) == (
            "no kernel for cpu")
        out = cuda_norm_act.chan_norm_act(x, norm.g, norm.b, ss, r)
        same = cuda_norm_act.chan_norm_act_reference(
            x, norm.g, norm.b, ss,
            r.contiguous(memory_format=torch.channels_last if form == "nhwc"
                         else torch.contiguous_format))
    err = (out - same).abs().max().item()
    assert err <= 1e-6 * same.abs().max().item(), err


def test_parameters_that_require_grad_are_taken_without_grad_mode():
    """Under no_grad (and inference_mode) only the device refuses a CPU
    forward's operands, though the norm's parameters require grad."""
    x, norm, ss, r = _operands(torch.bfloat16, "nhwc", True, True)
    assert norm.g.requires_grad
    with torch.no_grad():
        assert cuda_norm_act.refusal(x, norm.g, norm.b, ss, r) == (
            "no kernel for cpu")
    assert "requires grad" in cuda_norm_act.refusal(x, norm.g, norm.b, ss, r)


@pytest.mark.parametrize("grad", [False, True])
def test_norm_act_on_the_cpu_runs_the_eager_ops_and_counts_nothing(grad):
    x, norm, ss, r = _operands(torch.float32, "nhwc", True, True)
    before = (cuda_norm_act.launches, dict(cuda_norm_act.launches_by_route),
              cuda_norm_act.eager_epilogues)
    if grad:
        x.requires_grad_()
    with torch.set_grad_enabled(grad):
        y = metnet3._norm_act(norm, x, ss, r)
        h = norm(x) * (ss[0] + 1.0) + ss[1]
        want = torch.relu(h) + r
    assert torch.equal(y, want)
    if grad:
        y.sum().backward()
        assert x.grad is not None and torch.isfinite(x.grad).all()
    assert (cuda_norm_act.launches, dict(cuda_norm_act.launches_by_route),
            cuda_norm_act.eager_epilogues) == before


@pytest.mark.parametrize("fused", [False, True])
def test_cpu_forward_leaves_the_counters_unchanged(fused):
    """A tiny MetNet3 forward on the CPU, standard and fused stem: the
    eager epilogues, no count."""
    cfg = MetNet3Config(window_size=2, n_variables=24, n_start_channels=16,
                        end_lead_time=2, input_height=14, input_width=14,
                        pm25_mean=10.0, pm25_std=5.0, n_heads=2, dim_head=8,
                        fuse_lead_stem=fused)
    model = seeded_model(cfg, 0)
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.random((1, 2, 24, 14, 14)).astype(np.float32))
    ts = torch.tensor([[[2023.0, 1.0, 15.0, 6.0]] * 7])
    before = (cuda_norm_act.launches, cuda_norm_act.eager_epilogues)
    with torch.inference_mode():
        out = model(x, ts)
    assert out.shape == (1, 2, 14, 14) and torch.isfinite(out).all()
    assert (cuda_norm_act.launches, cuda_norm_act.eager_epilogues) == before
