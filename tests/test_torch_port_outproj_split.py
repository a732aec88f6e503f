"""The numeric plan of the out-projection kernel's strip design, on the CPU.

``csrc/outproj_attention.cu`` runs R12, R13, R2 and R8 in bf16 on K1's
strip body (``csrc/window_attention_strips.cuh``): x's bf16 rows copied
into a 64-row tile whose padded rows are zero, per head q|k|v with f32
sums, qn and kn l2-normalized (no sqrt(dh), no gain), S = qn kn^T and O =
P v on bf16 tensor cores, the padded key columns at -1e30, each head
shifted by its own row max, o_h rounded to bf16 before the out-projection,
y summed over the heads in f32.  Without R2's casts each n x n product
takes its f32 operands split into a bf16 high part and the bf16 rounding of
the remainder (hi.hi + hi.lo + lo.hi, f32 sums); with ``bf16_score``
(``bf16_agg``) S (O) takes the high parts alone, one bf16 product.  Here
that plan is emulated in plain PyTorch at 3 heads x 16, dim 48, out 48 and
n 56, 64 and 9 (n 9 leaves three of the tile's four 16-row strips wholly
padding):

* the high part is the repro's cast: for every element it equals JAX's
  ``astype(bfloat16)`` of the value (the repros' cast) and torch's;
* against the port's plain ``outproj_attention``: with split products and
  o_h kept in f32 (f32 inputs holding bf16 values, where the plain version
  rounds nothing) at 2e-5 of max|out|, as
  ``tests/test_torch_port_fwd_split.py`` holds K1's plan; with bf16 inputs,
  the casts and o_h rounded, within one bf16 step (2^-8) of max|out|: both
  round o_h (and the cast operands) to bf16, and an f32 sum in another
  order can round an element the other way; and, since that bound cannot
  tell one cast from another, with o_h in f32 against an f64 version with
  the same casts at a mean error of 1e-5 of max|out|, and above 4e-5 from
  the versions with the other casts;
* against the TPU repros run in Pallas TPU interpret mode (R2's four casts
  at n 56, R8's n_pad 64 at kfold 1 and 2), their geometry shrunk to these
  widths through monkeypatch (nothing in ``benchmarks/`` changes), the
  emulation's output rounded to bf16 as the repros' is: within two bf16
  steps (2^-7) of max|reference|, one for each output's rounding and one
  for a flip of an o_h or cast operand's rounding.

``repros/outproj_sections.py``, which times the kernel's designs in turns
and splits the strip design's time on the card, is checked to find every
place it patches in the committed source.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_bf16_mxu_operands as R2
from benchmarks.mosaic_repros import repro_npad_and_kfold as R8
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_bwd_split import ROWS, pad_rows, split, \
    split_product
from tests.test_torch_port_fwd_split import REL, one_product
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.repros import bf16_mxu_operands as rp2
from vit_grid_model_tpu_torch.repros import weightsliced_variants as rpw

HEADS, DIM_HEAD, DIM = 3, 16, 48
BW = 16                    # two 8-window programs of the shrunk repros
NS = [56, 64, 9]
BF16_STEP = 2.0 ** -8


def inputs(n: int, dtype=torch.bfloat16, seed: int = 4):
    """(x, wqkv, bias, wout) at these widths, from a numpy seed
    (``repros/weightsliced_variants.inputs``); x, wqkv and wout hold bf16
    values in ``dtype``, the bias is f32."""
    x, wqkv, bias, wout = rpw.inputs(BW, torch.bfloat16, torch.device("cpu"),
                                     seed, n=n, dim=DIM, heads=HEADS,
                                     dim_head=DIM_HEAD, out_dim=DIM)
    return x.to(dtype), wqkv.to(dtype), bias, wout.to(dtype)


def strip_outproj(x, wqkv, bias, wout, *, bf16_score=False, bf16_agg=False,
                  round_o=True) -> torch.Tensor:
    """The strip design in plain PyTorch, in f32 on the 64-row tile: x (bw,
    n, dim), wqkv R1's (dim, 3 heads dh), bias (heads, n, n), wout (heads,
    dh, out).  Each n x n product split (three bf16 products) or, with its
    cast, one product of the high parts; o_h rounded to bf16 when
    ``round_o``.  Returns y (bw, n, out) in f32."""
    bw, n, dim = x.shape
    heads, dh = bias.shape[0], wqkv.shape[1] // (3 * bias.shape[0])
    xp = pad_rows(x.float())                       # rows n..63 zero
    w = wqkv.float().reshape(dim, 3, heads, dh)
    wo = wout.float().reshape(heads, dh, -1)
    y = torch.zeros(bw, ROWS, wo.shape[-1])
    for h in range(heads):
        q, k, v = (xp @ w[:, i, h] for i in range(3))
        qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-24))
        kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True).clamp_min(1e-24))
        s = torch.zeros(ROWS, ROWS)
        s[:n, :n] = bias[h]
        s = s + (one_product if bf16_score else split_product)(
            qn, kn.transpose(-1, -2))
        s[..., n:] = -1e30                         # the padded keys
        p = torch.softmax(s, dim=-1)               # this head's own max
        o = (one_product if bf16_agg else split_product)(p, v)
        if round_o:
            o = o.bfloat16().float()
        y = y + o @ wo[h]                          # f32 over the heads
    return y[:, :n]


def reference64(x, wqkv, bias, wout, *, bf16_score=False,
                bf16_agg=False) -> torch.Tensor:
    """The function in f64 on the n real rows, R2's casts where the repros
    put them (qn and kn, or P and v, rounded to bf16), o_h not rounded."""
    def cast(t, flag):
        return t.to(torch.bfloat16).double() if flag else t

    bw, n, dim = x.shape
    heads, dh = bias.shape[0], wqkv.shape[1] // (3 * bias.shape[0])
    w = wqkv.double().reshape(dim, 3, heads, dh)
    y = 0
    for h in range(heads):
        q, k, v = (x.double() @ w[:, i, h] for i in range(3))
        qn = q / (q * q).sum(-1, keepdim=True).clamp_min(1e-24).sqrt()
        kn = k / (k * k).sum(-1, keepdim=True).clamp_min(1e-24).sqrt()
        s = cast(qn, bf16_score) @ cast(kn, bf16_score).transpose(-1, -2)
        p = torch.softmax(s + bias[h].double(), dim=-1)
        y = y + (cast(p, bf16_agg) @ cast(v, bf16_agg)) @ wout[h].double()
    return y


def _rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def test_high_part_is_the_repro_cast():
    """The high part of every operand of the n x n products (qn, kn, P, v
    of each head, at each n) is the round-to-nearest bf16 of the value:
    JAX's ``astype(bfloat16)``, the repros' cast, and torch's."""
    for n in NS:
        x, wqkv, bias, wout = inputs(n)
        xp = pad_rows(x.float())
        w = wqkv.float().reshape(DIM, 3, HEADS, DIM_HEAD)
        for h in range(HEADS):
            q, k, v = (xp @ w[:, i, h] for i in range(3))
            qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True)
                                 .clamp_min(1e-24))
            p = torch.softmax(qn @ qn.transpose(-1, -2), dim=-1)
            for t in (qn, p, v):
                hi = split(t)[0]
                assert torch.equal(hi, t.to(torch.bfloat16).float())
                np.testing.assert_array_equal(
                    hi.numpy(), np.asarray(jnp.asarray(t.numpy()).astype(
                        jnp.bfloat16), np.float32))


@pytest.mark.parametrize("cast", list(rp2.CASTS))
@pytest.mark.parametrize("n", NS)
def test_strip_plan_matches_plain(n, cast):
    score, agg = rp2.CASTS[cast]
    if not (score or agg):
        # split products, o_h in f32: the plain version in f32 rounds
        # nothing
        x, wqkv, bias, wout = inputs(n, torch.float32)
        ours = strip_outproj(x, wqkv, bias, wout, round_o=False)
        ref = plain.outproj_attention(x, wqkv, bias, wout, HEADS, DIM_HEAD,
                                      out_dtype=torch.float32)
        assert _rel(ours, ref) <= REL
    x, wqkv, bias, wout = inputs(n)
    ours = strip_outproj(x, wqkv, bias, wout, bf16_score=score,
                         bf16_agg=agg)
    ref = plain.outproj_attention(x, wqkv, bias, wout, HEADS, DIM_HEAD,
                                  bf16_score=score, bf16_agg=agg,
                                  out_dtype=torch.float32)
    assert _rel(ours, ref) <= BF16_STEP


@pytest.mark.parametrize("cast", list(rp2.CASTS))
@pytest.mark.parametrize("n", NS)
def test_strip_plan_casts_where_the_repros_cast(n, cast):
    """With o_h kept in f32, the emulation's mean error against an f64
    version of the function with the same casts is at most 1e-5 of
    max|out|, and against the versions with the other casts above 4e-5 (a
    cast moves every output by up to ~2^-8 of max|out|).  The mean, since a
    cast operand computed in f32 and in f64 can round to bf16 the other way
    in a few elements, which moves a few outputs by up to ~2^-9 of
    max|out|."""
    x, wqkv, bias, wout = inputs(n, torch.float32)
    score, agg = rp2.CASTS[cast]
    ours = strip_outproj(x, wqkv, bias, wout, bf16_score=score,
                         bf16_agg=agg, round_o=False).double()
    for s2, a2 in rp2.CASTS.values():
        ref = reference64(x, wqkv, bias, wout, bf16_score=s2, bf16_agg=a2)
        mean = ((ours - ref).abs().mean() / ref.abs().max()).item()
        if (s2, a2) == (score, agg):
            assert mean <= REL / 2, mean
        else:
            assert mean > 2 * REL, (s2, a2, mean)


def _shrink(monkeypatch, n_pad: int):
    for name, value in (("BW", BW), ("N_PAD", n_pad), ("DIM", DIM),
                        ("HEADS", HEADS), ("DIM_HEAD", DIM_HEAD)):
        monkeypatch.setattr(RC, name, value)
    monkeypatch.setattr(R2, "OUT_DIM", DIM)
    monkeypatch.setattr(R8, "OUT_DIM", DIM)


def _repro(fn, x, wqkv, bias, wout):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(*(jnp.asarray(t.float().numpy(), jnp.bfloat16)
                               for t in (x, wqkv)), jnp.asarray(bias.numpy()),
                             jnp.asarray(wout.float().numpy(),
                                         jnp.bfloat16)), np.float32)


# (name, repro build at the shrunk geometry, n, bf16_score, bf16_agg)
REPRO_CASES = (
    [(f"R2 {cast}", lambda s=s, a=a: R2.build(s, a), RC.N_PAD, s, a)
     for cast, (s, a) in rp2.CASTS.items()]
    + [(f"R8 n_pad 64 kfold {k}", lambda k=k: R8.build(64, k), 64, False,
        False) for k in (1, 2)])


@pytest.mark.parametrize("name,build,n,score,agg", REPRO_CASES,
                         ids=[c[0] for c in REPRO_CASES])
def test_strip_plan_matches_repro_interpret(monkeypatch, name, build, n,
                                            score, agg):
    _shrink(monkeypatch, n)
    x, wqkv, bias, wout = inputs(n)
    ref = _repro(build(), x, wqkv, bias, wout)
    assert ref.shape == (BW, n, DIM)
    ours = strip_outproj(x, wqkv, bias, wout, bf16_score=score,
                         bf16_agg=agg).bfloat16().float()
    assert _rel(ours.numpy(), ref) <= 2 * BF16_STEP


def test_outproj_sections_patches_every_section():
    """``repros/outproj_sections.py`` finds its places in the committed
    source (its headers inlined): a stamp after each of the strip body's
    five sections, the counts opened and flushed in the strip kernel, the
    body's signature and its call taking the counts; the source carries its
    own route and occupancy exports."""
    from vit_grid_model_tpu_torch.repros import outproj_sections as tool

    v = tool.variants(tool.SOURCE)
    assert set(v) == {"plain", "stamp"}
    assert '#include "' not in v["plain"]
    assert v["stamp"].count("STAMP(") == len(tool.SECTIONS) + 1  # + macro
    assert "long long* sec_acc, long long& sec_last) {" in v["stamp"]
    assert "store, sec_acc, sec_last);" in v["stamp"]
    assert "atomicAdd(&g_sections[k]" in v["stamp"]
    for name in ("vgm_outproj_attention_route",
                 "vgm_outproj_attention_occupancy"):
        assert name in v["plain"]
    assert tool._FIRST_OCCUPANCY not in v["plain"]
