"""The FLOP counter over the reference against an analytic count of the
published computation's products, and the frozen bound arithmetic against
the figures the kernel table records."""

from __future__ import annotations

import pytest
import torch

from gridbench.common import peaks, spec
from gridbench.common.flops import forward_flops, train_step_flops
from gridbench.reference import metnet3 as M
from gridbench.tests.conftest import TINY


def analytic_forward(cfg: dict, batch: int) -> int:
    """2 x multiply-adds of every convolution and product of one forward."""
    left, right, top, bottom = M.pad_values(
        cfg["input_height"], cfg["input_width"], cfg["pad_multiple"])
    hp = cfg["input_height"] + top + bottom
    wp = cfg["input_width"] + left + right
    full, half = hp * wp, (hp // 2) * (wp // 2)
    ch, lead = cfg["n_start_channels"], cfg["lead_time_emb_dim"]
    n_in = (cfg["window_size"] * cfg["n_variables"] + lead
            + 3 * cfg["model_time_emb_dim"])

    def resnet(cin):
        f = 0
        for i in range(cfg["resnet_block_depth"]):
            d = cin if i == 0 else ch
            f += 2 * d * 9 * ch * full + 2 * ch * 9 * ch * full
            f += 2 * lead * 2 * ch
            if d != ch:
                f += 2 * d * ch * full
        return f

    hid = cfg["mbconv_expansion_rate"] * ch
    se = int(hid * cfg["mbconv_shrinkage_rate"])
    mbconv = (2 * ch * hid * half + 2 * 9 * hid * half + 2 * hid * se * 2
              + 2 * hid * ch * half)
    heads, dh, w = cfg["n_heads"], cfg["dim_head"], cfg["vit_window_size"]
    n = w * w + cfg["num_register_tokens"]
    inner = heads * dh
    nwin = (hp // 2 // w) * ((wp // 2) // w)
    attn = (2 * lead * 2 * ch + 2 * 2 * ch * 2 * ch
            + nwin * (2 * n * ch * 3 * inner + 4 * heads * n * n * dh
                      + 2 * n * inner * ch))
    up = 2 * ch * ch * 4 * half
    head = 2 * ch * cfg["input_height"] * cfg["input_width"]
    per_lead = resnet(n_in) + mbconv + 2 * attn + up + resnet(ch) + head
    return batch * cfg["end_lead_time"] * per_lead


@pytest.mark.parametrize("tiny", [True, False])
def test_forward_flops_match_the_analytic_count(tiny):
    cfg = spec.config("metnet3_12hr_bf16")["model"]
    if tiny:
        cfg.update(TINY)
    assert forward_flops(cfg, 2) == analytic_forward(cfg, 2)


def test_shipped_model_flops():
    cfg = spec.config("metnet3_12hr_bf16")["model"]
    per_field = forward_flops(cfg, 1) / cfg["end_lead_time"]
    assert per_field == pytest.approx(25.86e9, rel=1e-3)


def test_train_step_counts_forward_and_backward():
    cfg = dict(spec.config("metnet3_12hr_bf16")["model"], **TINY)
    fwd, step = forward_flops(cfg, 2), train_step_flops(cfg, 2)
    # every product's backward is at least the two products of its size
    # (the stem's input needs its gradient too: the time planes
    # concatenated to it come from trained embeddings)
    assert 3.0 * fwd <= step < 3.5 * fwd


def test_bounds_match_the_recorded_figures():
    ms, what = peaks.attention_bound_ms(9000, 53, 128, 32, 32, 2)
    assert (round(ms, 3), what) == (0.610, "operations")
    ms, what = peaks.wgrad_bound_ms(1440 * 53, 128, 32, 32)
    assert (round(ms, 3), what) == (0.199, "bytes")
    ms, _ = peaks.attention_bound_ms(8640, 53, 128, 32, 32, 4, torch.float32)
    assert ms == pytest.approx(8640 * 67.07e6 / 67e12 * 1e3, rel=1e-3)


def test_backward_bound_counts_no_recompute():
    fwd = peaks.attention_fwd_flops(53, 128, 32, 32)
    bwd = peaks.attention_bwd_flops(53, 128, 32, 32)
    # two products a forward product, less the forward's own
    assert bwd == 2 * fwd
