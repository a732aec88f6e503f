"""The numeric plan of the backward kernel's tensor-core path, on the CPU.

``csrc/window_attention_bwd.cu`` runs the six n x n products of a head (S,
O, dV, dPm, dQn, dKn) on bf16 tensor cores, although the TPU kernel feeds
them f32 operands (qn, kn, Pm, v, dO, dS are never cast,
``vit_grid_model_tpu/ops/pallas/attention.py:633-690``).  Each f32 operand
is split into a bf16 high part and the bf16 rounding of its remainder, and
each product is taken three times, hi.hi + hi.lo + lo.hi, with f32 sums.
Here that plan is emulated in plain PyTorch on the products' own operands
(a small layer at window 7 and 5, 53 and 29 tokens, padded to the kernel's
64-row tile with its conventions) and held against the f64 product:

* each element within 2^-14 = 4 * 2^-16 of sum_k |a_ik| |b_kj|: the split
  leaves ~2^-16 of each operand and the omitted lo.lo term ~2^-16 of each
  product; the f32 sums add at most 64 * 2^-24;
* one bf16 product (hi.hi) misses that bound by far (~2^-9), so the split
  is what keeps the f32 operands' accuracy;
* the padded rows n..63 of P are not zero (a zero query row gives a uniform
  softmax), yet the row-summed products take nothing from them, since dO
  and dS are zero there; the kernel zeroes Pm's padded rows all the same.

The tensor-core path also leaves the weight gradients to a kernel of their
own (K3-w): K3 writes the T-rounded operands xf, dQ|dK|dV and O of every
window, and K3-w sums dWqkv = xf^T [dQ|dK|dV] and dWout = O^T dY over all
rows.  The plain version of that split backward is held against the plain
backward (``window_attention_bwd_reference``) at 1e-5 of max|grad| and,
carried to the layer's parameters, against ``jax.vjp`` with the bounds of
``tests/test_torch_port_dropout.py``.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from chip_smoke import attention_case
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_attention import _bias_idx, _case, _port
from tests.test_torch_port_dropout import (RATE, _close,
                                           _jax_grads_as_state_dict)
from vit_grid_model_tpu.ops import attention as jattn
from vit_grid_model_tpu.ops.window import (
    relative_position_indices as jax_indices)
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.cuda.attention import kernel_inputs
from vit_grid_model_tpu_torch.ops.dropout import keep_mask
from vit_grid_model_tpu_torch.ops.window import relative_position_indices

ROWS = 64                 # the kernel's row tile
BOUND = 2.0 ** -14        # of sum_k |a| |b|, per element
WPS = 30
HEADS, DIM_HEAD, DIM = 3, 16, 48


def split(x: torch.Tensor):
    """An f32 tensor as its bf16 high part and the bf16 rounding of the
    remainder, both back in f32."""
    hi = x.bfloat16().float()
    return hi, (x - hi).bfloat16().float()


def split_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b as the kernel takes it: three bf16 products, f32 sums."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    return al @ bh + ah @ bl + ah @ bh


def pad_rows(t: torch.Tensor) -> torch.Tensor:
    return F.pad(t, (0, 0, 0, ROWS - t.shape[-2]))


def head_operands(window: int, rate: float = 0.25, seed: int = 2 ** 31 - 2):
    """One layer's per-head operands of the six products, in f64: (bw,
    heads, n, .) tensors keyed by name."""
    m, x, cond = attention_case(HEADS, DIM_HEAD, DIM, True, WPS, 0.0, seed=3,
                                window=window)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    with torch.no_grad():
        k = kernel_inputs(m, xt, ct, relative_position_indices(window, 4),
                          WPS)
    bw, n, _ = xt.shape
    dh = DIM_HEAD
    gamma = k.gamma.double().repeat_interleave(WPS, 0)[:, None]
    beta = k.beta.double().repeat_interleave(WPS, 0)[:, None]
    xf = F.layer_norm(xt.double(), (DIM,), eps=1e-5) * gamma + beta
    qkv = torch.einsum("wnc,hce->whne", xf, k.wqkv.double())
    q, kk, v = qkv.split(dh, dim=-1)
    u_q = q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    u_k = kk / kk.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    s_q = math.sqrt(dh) * k.qg.double()[None, :, None]
    s_k = math.sqrt(dh) * k.kg.double()[None, :, None]
    p = torch.softmax((u_q * s_q * s_k) @ u_k.transpose(-1, -2)
                      + k.bias.double(), dim=-1)
    keep = keep_mask(seed, bw, HEADS, n, rate).double()
    dy = torch.from_numpy(np.random.default_rng(4).standard_normal(
        xt.shape)).double()
    d_o = torch.einsum("wnc,hec->whne", dy, k.wout.double())
    dp = (d_o @ v.transpose(-1, -2)) * keep
    ds = p * (dp - (dp * p).sum(-1, keepdim=True))
    return dict(u_q=u_q, u_k=u_k, ssk=s_q * s_k, v=v, pm=p * keep, d_o=d_o,
                ds=ds, p=p, n=n)


# each product as (A, B) of the padded tiles: A (64, K) and B (K, N)
PRODUCTS = {
    "S": lambda o: (pad_rows(o["u_q"] * o["ssk"]),
                    pad_rows(o["u_k"]).transpose(-1, -2)),
    "O": lambda o: (pad_cols(pad_rows(o["pm"])), pad_rows(o["v"])),
    "dV": lambda o: (pad_cols(pad_rows(o["pm"])).transpose(-1, -2),
                     pad_rows(o["d_o"])),
    "dPm": lambda o: (pad_rows(o["d_o"]),
                      pad_rows(o["v"]).transpose(-1, -2)),
    "dQn": lambda o: (pad_cols(pad_rows(o["ds"])), pad_rows(o["u_k"])),
    "dKn": lambda o: (pad_cols(pad_rows(o["ds"])).transpose(-1, -2),
                      pad_rows(o["u_q"])),
}


def pad_cols(t: torch.Tensor) -> torch.Tensor:
    return F.pad(t, (0, ROWS - t.shape[-1]))


def relative_errors(a64, b64, product):
    """Each element's |product(a, b) - a.b| over sum_k |a| |b|, from the
    f32 operands, against the f64 product."""
    a32, b32 = a64.float(), b64.float()
    exact = a32.double() @ b32.double()
    scale = a32.double().abs() @ b32.double().abs()
    err = (product(a32, b32).double() - exact).abs()
    return err / scale.clamp_min(1e-300), scale


@pytest.mark.parametrize("window", [7, 5])
@pytest.mark.parametrize("name", list(PRODUCTS))
def test_split_product_within_bound(name, window):
    a, b = PRODUCTS[name](head_operands(window))
    rel, scale = relative_errors(a, b, split_product)
    assert bool((scale > 0).any())
    worst = rel[scale > 0].max().item()
    assert worst <= BOUND, (name, window, worst)


@pytest.mark.parametrize("window", [7, 5])
def test_one_bf16_product_misses_the_bound(window):
    ops = head_operands(window)
    worst = 0.0
    for name, make in PRODUCTS.items():
        a, b = make(ops)
        rel, scale = relative_errors(
            a, b, lambda x, y: x.bfloat16().float() @ y.bfloat16().float())
        worst = max(worst, rel[scale > 0].max().item())
    assert worst > 16 * BOUND, worst


@pytest.mark.parametrize("window", [7, 5])
def test_padded_rows_give_nothing_to_the_row_sums(window):
    """Padded query rows: P is uniform over the n keys there, but dO and dS
    are zero, so dV = P^T dO and dKn = dS^T qn (sums over rows) are the
    same with Pm's padded rows zeroed or left as the softmax gives them."""
    ops = head_operands(window)
    n = ops["n"]
    assert n == window * window + 4
    # a zero q row: u_q = 0, scores 0, a uniform softmax over the n keys
    uniform = torch.softmax(torch.zeros(ROWS - n, n, dtype=torch.float64),
                            -1)
    p_pad = torch.cat([ops["pm"], uniform.expand(
        *ops["pm"].shape[:2], ROWS - n, n)], dim=-2)
    assert bool((p_pad[..., n:, :] > 0).all())
    d_o, ds = pad_rows(ops["d_o"]), pad_rows(ops["ds"])
    assert bool((d_o[..., n:, :] == 0).all() and (ds[..., n:, :] == 0).all())
    zeroed = pad_rows(ops["pm"])
    torch.testing.assert_close(p_pad.transpose(-1, -2) @ d_o,
                               zeroed.transpose(-1, -2) @ d_o, rtol=0,
                               atol=0)
    # padded key columns: P (and so dS) is zero there
    assert bool((pad_cols(ops["pm"])[..., n:] == 0).all())


# the split backward of the tensor-core path: the per-window operands K3
# writes, then the weight-gradient reduction of K3-w, both plain, against
# the plain backward and against jax.vjp, on the cases of
# tests/test_torch_port_dropout.py::test_bwd_reference_matches_jax_vjp
@pytest.mark.parametrize("heads,conditioned,wps", [(4, True, 1),
                                                   (3, True, 3),
                                                   (3, False, 3)])
def test_split_backward_matches_reference_and_jax(heads, conditioned, wps):
    seed = 2 ** 31 - 2
    p, x, cond = _case(heads, 8, 32, conditioned)
    if conditioned and wps == 1:
        cond = np.random.default_rng(5).standard_normal(
            (x.shape[0], 2)).astype(np.float32)
    dy = np.random.default_rng(6).standard_normal(x.shape).astype(np.float32)
    bw, n, dim = x.shape
    m = _port(p, heads, 8, 32, conditioned)
    xt = torch.from_numpy(x)
    ct = None if cond is None else torch.from_numpy(cond)
    k = cuda_attn.kernel_inputs(m, xt, ct, _bias_idx(), wps)
    dyt = torch.from_numpy(dy)

    ops = cuda_attn.window_attention_bwd_operands_reference(xt, k, dyt, seed,
                                                            RATE)
    assert [tuple(t.shape) for t in ops] == [
        (bw * n, dim), (bw * n, 3 * heads * 8), (bw * n, heads * 8)]
    dwqkv, dwout = cuda_attn.window_attention_wgrad(
        ops, dyt.reshape(bw * n, dim), heads)
    ref = cuda_attn.window_attention_bwd_reference(xt, k, dyt, seed, RATE)
    for ours, want in ((dwqkv, ref[3]), (dwout, ref[4])):
        assert ours.shape == want.shape
        err = (ours - want).abs().max().item()
        assert err <= 1e-5 * want.abs().max().item(), err

    # the same weight gradients carried to the layer's parameters, against
    # jax.vjp of the JAX attention with the same mask
    mask = keep_mask(seed, bw, heads, n, RATE)
    _, vjp = jax.vjp(lambda pp: jattn.attention(
        pp, jnp.asarray(x), None if cond is None else jnp.asarray(cond),
        jax_indices(7, 4), heads=heads, windows_per_sample=wps,
        dropout_mask=jnp.asarray(mask.numpy())), p)
    want = _jax_grads_as_state_dict(vjp(jnp.asarray(dy))[0])
    k = cuda_attn.kernel_inputs(m, xt, ct, _bias_idx(), wps)
    params = dict(m.named_parameters())
    names = ["to_qkv.weight", "to_out.0.weight"]
    found = torch.autograd.grad([k.wqkv, k.wout], [params[q] for q in names],
                                [dwqkv, dwout])
    for name, g in zip(names, found):
        _close(g.numpy(), np.asarray(want[name]), conditioned)


def test_bwd_sections_patches_every_section():
    """``repros/bwd_sections.py``, which measures where K3's time goes on
    the card, finds its places in K3's source: a stamp after each of the
    seven sections, the slot traffic gone from the noslot build, each of
    the five split-product calls one bf16 product in the single build."""
    from vit_grid_model_tpu_torch.repros import bwd_sections

    v = bwd_sections.current_variants(bwd_sections.SOURCE.read_text())
    assert set(v) == {"plain", "stamp", "noslot", "noslot_stamp", "single"}
    stamps = len(bwd_sections.SECTIONS)
    for name, text in v.items():
        assert "extern \"C\" int sections_read" in text
        assert text.count("STAMP(") == 1 + (stamps if "stamp" in name
                                            else 0)
        assert ("dbias_h[r * n + c] = " in text) == ("noslot" not in name)
    assert v["single"].count("mma_hi_only(") == 6
    assert "mma_split_16816(" not in v["single"]
