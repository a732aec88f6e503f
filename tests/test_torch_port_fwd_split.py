"""The numeric plan of the forward kernel's strip path, on the CPU.

``csrc/window_attention_fwd.cu`` runs a head's two n x n products, S =
qn kn^T and O = P v, on bf16 tensor cores, although the TPU kernel feeds
them f32 operands (``vit_grid_model_tpu/ops/pallas/attention.py:277``,
``:310``).  Each f32 operand is split into a bf16 high part and the bf16
rounding of its remainder, and each product is taken three times, hi.hi +
hi.lo + lo.hi, with f32 sums.  Here that plan is emulated in plain PyTorch
on the kernel's 64-row tile, with its conventions: q, k, v of the padded
rows zero, each head's scores shifted by their own row max, the padded key
columns at -1e30 (so a padded query row gets a uniform softmax), the
dropout keep value of ``ops/dropout.py::keep_mask`` on the real (row, col)
scores.  At windows of 7 and 5 (53 and 29 tokens; window 5 leaves two of
the four 16-row strips wholly padding) with 3 heads x 16:

* each split product within 2^-14 of sum_k |a_ik| |b_kj| of the f64
  product, where one bf16 product (hi.hi) misses that bound by far (the
  bound's reasoning is ``tests/test_torch_port_bwd_split.py``'s);
* the emulated forward against the port's plain ``attention``, with and
  without dropout: at 1e-5 of max|out| with exact f32 n x n products, at
  2e-5 with the split ones (their error on the scores, below);
* the emulated forward against the JAX ``window_attention_pallas`` in
  interpret mode at 2e-5 of max|out|, the bound
  ``tests/test_torch_port_attention.py`` holds the plain version to.

``repros/fwd_sections.py``, which splits K1's time on the card, is checked
to find every place it patches in the committed source.
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
from tests.test_torch_port_bwd_split import (BOUND, ROWS, pad_rows, split,
                                             split_product)
from vit_grid_model_tpu.core import torch_export
from vit_grid_model_tpu.ops import attention as jattn
from vit_grid_model_tpu.ops.window import (
    relative_position_indices as jax_indices)
from vit_grid_model_tpu_torch.ops import attention as tattn
from vit_grid_model_tpu_torch.ops.cuda.attention import kernel_inputs
from vit_grid_model_tpu_torch.ops.dropout import keep_mask
from vit_grid_model_tpu_torch.ops.window import relative_position_indices

WPS = 3
HEADS, DIM_HEAD, DIM = 3, 16, 48
SEED, RATE = 2 ** 31 - 2, 0.25
REL = 2e-5                # tests/test_torch_port_attention.py's bound


def one_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a . b as one bf16 product with f32 sums."""
    return split(a.float())[0] @ split(b.float())[0]


def strip_forward(x: torch.Tensor, k, keep=None, product=split_product,
                  operands=None) -> torch.Tensor:
    """K1's strip path in plain PyTorch on f32 inputs: x (bw, n, dim), k
    the kernel's inputs, keep an optional pre-scaled keep mask (bw, heads,
    n, n).  The two n x n products go through ``product`` on the 64-row
    tile; everything else is f32 as in the kernel.  With ``operands`` (a
    dict) it records each head's (A, B) of both products."""
    bw, n, dim = x.shape
    heads, _, three_dh = k.wqkv.shape
    dh = three_dh // 3
    xn = F.layer_norm(x, (dim,), eps=1e-5)
    if k.has_film:
        rows = torch.arange(bw) // k.windows_per_sample
        xn = xn * k.gamma[rows][:, None] + k.beta[rows][:, None]
    xn = pad_rows(xn)                                      # (bw, 64, dim)
    y = torch.zeros(bw, ROWS, dim)
    for h in range(heads):
        q, kk, v = (xn @ k.wqkv[h]).split(dh, dim=-1)
        u_q = q * torch.rsqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-24))
        u_k = kk * torch.rsqrt((kk * kk).sum(-1, keepdim=True)
                               .clamp_min(1e-24))
        a_s = u_q * (math.sqrt(dh) * k.qg[h])                  # qn
        b_s = (u_k * (math.sqrt(dh) * k.kg[h])).transpose(-1, -2)  # kn^T
        bias = torch.zeros(ROWS, ROWS)
        bias[:n, :n] = k.bias[h]
        s = bias + product(a_s, b_s)
        s[..., n:] = -1e30
        p = torch.softmax(s, dim=-1)   # each head's own row max
        if keep is not None:
            p[:, :n, :n] = p[:, :n, :n] * keep[:, h]
        if operands is not None:
            operands.setdefault("S", []).append((a_s, b_s))
            operands.setdefault("O", []).append((p, v))
        y = y + product(p, v) @ k.wout[h]
    return y[:, :n]


def layer(window: int):
    """A conditioned layer at the given window, its f32 inputs and the
    kernel's inputs, from numpy seeds (chip_smoke.attention_case)."""
    m, x, cond = attention_case(HEADS, DIM_HEAD, DIM, True, 30, 0.0, seed=3,
                                window=window)
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    bias_idx = relative_position_indices(window, 4)
    with torch.no_grad():
        k = kernel_inputs(m, xt, ct, bias_idx, 30)
    return m, xt, ct, bias_idx, k


def relative_errors(a64, b64, product):
    """Each element's |product(a, b) - a.b| over sum_k |a| |b|, from the
    f32 operands, against the f64 product."""
    a32, b32 = a64.float(), b64.float()
    exact = a32.double() @ b32.double()
    scale = a32.double().abs() @ b32.double().abs()
    err = (product(a32, b32).double() - exact).abs()
    return err / scale.clamp_min(1e-300), scale


def head_operands(window: int):
    _, xt, _, _, k = layer(window)
    keep = keep_mask(SEED, xt.shape[0], HEADS, xt.shape[1], RATE)
    ops = {}
    with torch.no_grad():
        strip_forward(xt, k, keep, operands=ops)
    return ops


@pytest.mark.parametrize("window", [7, 5])
@pytest.mark.parametrize("name", ["S", "O"])
def test_split_product_within_bound(name, window):
    for a, b in head_operands(window)[name]:
        rel, scale = relative_errors(a, b, split_product)
        assert bool((scale > 0).any())
        worst = rel[scale > 0].max().item()
        assert worst <= BOUND, (name, window, worst)


@pytest.mark.parametrize("window", [7, 5])
def test_one_bf16_product_misses_the_bound(window):
    worst = 0.0
    for pairs in head_operands(window).values():
        for a, b in pairs:
            rel, scale = relative_errors(a, b, one_product)
            worst = max(worst, rel[scale > 0].max().item())
    assert worst > 16 * BOUND, worst


@pytest.mark.parametrize("window", [7, 5])
def test_padded_rows_and_columns(window):
    """On the tile, P is zero on the padded key columns and uniform over
    the n keys on the padded query rows (zero q), which reach only rows of
    y that are never stored."""
    ops = head_operands(window)
    n = window * window + 4
    for p, v in ops["O"]:
        assert bool((p[..., n:] == 0).all())
        torch.testing.assert_close(p[:, n:, :n],
                                   torch.full_like(p[:, n:, :n], 1.0 / n))
        assert bool((v[:, n:] == 0).all())


# the emulated forward against the plain version, relative to max|out|:
# with exact f32 n x n products (the plan's tile, padding, per-head max and
# dropout) at 1e-5; with the split products at 2e-5, since the split's
# ~2^-16 relative error of S carries into P at the scale of the scores
# (sqrt(dh) gq sqrt(dh) gk qn.kn reaches ~36 here)
PLAIN_BOUNDS = {"f32": (torch.matmul, 1e-5), "split": (split_product, REL)}


@pytest.mark.parametrize("products", list(PLAIN_BOUNDS))
@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("window", [7, 5])
def test_strip_forward_matches_plain(window, rate, products):
    product, bound = PLAIN_BOUNDS[products]
    m, xt, ct, bias_idx, k = layer(window)
    keep = (keep_mask(SEED, xt.shape[0], HEADS, xt.shape[1], rate)
            if rate else None)
    with torch.no_grad():
        ours = strip_forward(xt, k, keep, product)
        ref = tattn.attention(m, xt, ct, bias_idx, windows_per_sample=30,
                              dropout_mask=keep)
    err = (ours - ref).abs().max().item()
    assert err <= bound * ref.abs().max().item(), err


def _jax_layer(window: int):
    """The same widths as a JAX layer and its port, at the given window."""
    p = jattn.attention_init(jax.random.PRNGKey(5), DIM, cond_dim=2,
                             heads=HEADS, dim_head=DIM_HEAD,
                             window_size=window, num_registers=4)
    rng = np.random.default_rng(5)
    p["q_norm"]["gamma"] = jnp.asarray(
        rng.uniform(0.5, 1.5, (HEADS, 1, DIM_HEAD)), jnp.float32)
    n = window * window + 4
    x = rng.standard_normal((6, n, DIM)).astype(np.float32)
    cond = rng.standard_normal((6 // WPS, 2)).astype(np.float32)
    m = tattn.Attention(DIM, cond_dim=2, heads=HEADS, dim_head=DIM_HEAD,
                        window_size=window)
    sd = {}
    torch_export._emit_attention(sd, "a", p)
    m.load_state_dict({key[2:]: torch.from_numpy(v) for key, v in sd.items()},
                      strict=True)
    return p, m.eval(), x, cond


@pytest.mark.parametrize("rate", [0.0, RATE])
@pytest.mark.parametrize("window", [7, 5])
def test_strip_forward_matches_pallas_interpret(window, rate):
    from jax.experimental.pallas import tpu as pltpu

    from vit_grid_model_tpu.ops.pallas.attention import (
        window_attention_pallas)

    p, m, x, cond = _jax_layer(window)
    bw, n, _ = x.shape
    keep = keep_mask(SEED, bw, HEADS, n, rate) if rate else None
    xt, ct = torch.from_numpy(x), torch.from_numpy(cond)
    with torch.no_grad():
        k = kernel_inputs(m, xt, ct, relative_position_indices(window, 4),
                          WPS)
        ours = strip_forward(xt, k, keep).numpy()
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(window_attention_pallas(
            p, jnp.asarray(x), jnp.asarray(cond), jax_indices(window, 4),
            None if keep is None else jnp.asarray(keep.numpy()), HEADS,
            WPS))
    assert np.abs(ours - ref).max() <= REL * np.abs(ref).max()


def test_fwd_sections_patches_every_section():
    """``repros/fwd_sections.py`` finds its places in the committed source:
    a stamp after each of the strip path's five sections, its three split
    products (S, and O's two tiles) made one bf16 product each in the
    single build, the one-CTA build's launch bound, doubled weight buffers
    and whole-head prefetch with no wait before the first barrier;
    and the first design's eight stamps, which it finds in the first
    design's kernel that the committed source keeps for the f32 path.  The
    strip path's body lives in its own header, which the tool inlines."""
    from vit_grid_model_tpu_torch.repros import fwd_sections

    fwd = fwd_sections.SOURCE.read_text()
    body = (fwd_sections.SOURCE.parent / fwd_sections.BODY).read_text()
    assert fwd_sections.is_strip_design(fwd)
    v = fwd_sections.strip_variants(fwd_sections.inline_header(
        fwd, fwd_sections.SOURCE.parent / fwd_sections.STRIPS))
    assert set(v) == {"plain", "stamp", "single", "one_cta"}
    assert v["stamp"].count("STAMP(") == len(fwd_sections.SECTIONS)
    assert v["single"].count("mma_hi_only(") == 4   # its definition, 3 calls
    assert "mma_split_16816(" not in v["single"]
    one = v["one_cta"]
    assert "__launch_bounds__(kThreads, 1)\n    window_attention_fwd_strips(" \
        in one
    assert one.count("take(2 * static_cast<size_t>") == 2
    assert "b, wq_h + (k0 + b_k)" in one and "b, wo_h + (k0 + b_k)" in one
    assert "// Wout_h has landed" not in one
    first = fwd_sections.first_variants(fwd, body)
    assert set(first) == {"plain", "stamp"}
    stamped_fwd, stamped_body = first["stamp"]
    # LN's stamp twice: after the LayerNorm, and after the body zeroes y
    assert (stamped_fwd.count("STAMP(") + stamped_body.count("STAMP(")
            == len(fwd_sections.FIRST_SECTIONS) + 1)
