"""The numeric plans of R10's and R5/R6's strip designs, on the CPU.

In bf16 at K1's strip widths ``csrc/stacked_softmax_attention.cu`` (R10)
runs K1's strip body (``csrc/window_attention_strips.cuh``) without its
out-projection: x's bf16 rows copied into a 64-row tile whose padded rows
are zero, per head q|k|v with f32 sums, qn and kn l2-normalized (no
sqrt(dh), no gain), S = qn kn^T and O = P v from f32 operands split into a
bf16 high part and the bf16 rounding of the remainder (hi.hi + hi.lo +
lo.hi, f32 sums), the padded key columns at -1e30, each head shifted by its
own row max, and o_h rounded once to bf16 into columns h dh of the output.
``csrc/headpack_attention.cu`` (R5, R6) launches the out-projection
family's strip kernel there, whose plan ``tests/test_torch_port_outproj_
split.py::strip_outproj`` emulates.  Here R10's plan is emulated in plain
PyTorch at 3 heads x 16, dim 48 and n 56, 64 and 9 (n 9 leaves three of the
tile's four 16-row strips wholly padding):

* against the port's plain ``perhead_qkv_attention``: with o_h kept in f32
  (f32 inputs holding bf16 values, where the plain version rounds nothing)
  within 2e-5 of max|out|, as ``tests/test_torch_port_fwd_split.py`` holds
  K1's plan; with bf16 inputs and o_h rounded, within one bf16 step (2^-8)
  of max|out|: both round o_h once, and an f32 sum in another order can
  round an element the other way;
* against ``benchmarks/mosaic_repros/repro_stacked_softmax.py`` run in
  Pallas TPU interpret mode, its geometry shrunk to these widths through
  monkeypatch (nothing in ``benchmarks/`` changes): within two bf16 steps
  (2^-7) of max|reference|, one for each side's rounding of o_h;
* the out-projection plan against R5's and R6's repros in interpret mode at
  K = 2 and 4, one pass and two, at 4 heads x 16 (K divides the heads),
  dim and out 48, n 56, on the seeded inputs, whose head rows do not
  diverge (there the repros' joint max is exact): within 2^-7 of
  max|reference|.

``repros/headpack_stacked_sections.py``, which times both kernels' designs
in turns on the card, is checked to find every place it patches in the
committed sources, and to read ptxas's report.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_headpair_lanepack as R5
from benchmarks.mosaic_repros import repro_headquad_lanepack as R6
from benchmarks.mosaic_repros import repro_stacked_softmax as R10
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_bwd_split import ROWS, pad_rows, split_product
from tests.test_torch_port_fwd_split import REL
from tests.test_torch_port_outproj_split import strip_outproj
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as rp1
from vit_grid_model_tpu_torch.repros import headpair_lanepack as rp5
from vit_grid_model_tpu_torch.repros import headquad_lanepack as rp6
from vit_grid_model_tpu_torch.repros import weightsliced_variants as rpw

HEADS, DIM_HEAD, DIM = 3, 16, 48
PACK_HEADS = 4             # R5/R6's cases: K = 2 and 4 divide the heads
BW = 16                    # two 8-window programs of the shrunk repros
NS = [56, 64, 9]
BF16_STEP = 2.0 ** -8


def inputs(n: int, dtype=torch.bfloat16, seed: int = 4):
    """(x, wqkv, bias) at these widths, from a numpy seed
    (``repros/baseline_perhead.inputs``); x and wqkv hold bf16 values in
    ``dtype``, the bias is f32."""
    x, wqkv, bias = rp1.inputs(BW, torch.bfloat16, torch.device("cpu"), seed,
                               n=n, dim=DIM, heads=HEADS, dim_head=DIM_HEAD)
    return x.to(dtype), wqkv.to(dtype), bias


def strip_stacked(x, wqkv, bias, *, round_o=True) -> torch.Tensor:
    """R10's strip design in plain PyTorch, in f32 on the 64-row tile: x
    (bw, n, dim), wqkv R1's (dim, 3 heads dh), bias (heads, n, n).  Each n x
    n product split (three bf16 products); o_h rounded to bf16 when
    ``round_o``, then stored at columns h dh of rows < n.  Returns (bw, n,
    heads dh) in f32."""
    bw, n, dim = x.shape
    heads, dh = bias.shape[0], wqkv.shape[1] // (3 * bias.shape[0])
    xp = pad_rows(x.float())                       # rows n..63 zero
    w = wqkv.float().reshape(dim, 3, heads, dh)
    out = []
    for h in range(heads):
        q, k, v = (xp @ w[:, i, h] for i in range(3))
        qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-24))
        kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True).clamp_min(1e-24))
        s = torch.zeros(ROWS, ROWS)
        s[:n, :n] = bias[h]
        s = s + split_product(qn, kn.transpose(-1, -2))
        s[..., n:] = -1e30                         # the padded keys
        o = split_product(torch.softmax(s, dim=-1), v)  # its own max
        if round_o:
            o = o.bfloat16().float()
        out.append(o[:, :n])                       # rows < n are stored
    return torch.cat(out, dim=-1)


def _rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("n", NS)
def test_strip_plan_matches_plain(n):
    # split products, o_h in f32: the plain version in f32 rounds nothing
    x, wqkv, bias = inputs(n, torch.float32)
    ours = strip_stacked(x, wqkv, bias, round_o=False)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    assert ours.shape == ref.shape == (BW, n, HEADS * DIM_HEAD)
    assert _rel(ours, ref) <= REL
    # bf16: both round each head's output once
    x, wqkv, bias = inputs(n)
    ours = strip_stacked(x, wqkv, bias)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    assert ref.dtype == torch.bfloat16
    assert _rel(ours, ref.float()) <= BF16_STEP


def _shrink(monkeypatch, n: int, heads: int = HEADS):
    for name, value in (("BW", BW), ("N_PAD", n), ("DIM", DIM),
                        ("HEADS", heads), ("DIM_HEAD", DIM_HEAD)):
        monkeypatch.setattr(RC, name, value)
    monkeypatch.setattr(R5, "OUT_DIM", DIM)
    monkeypatch.setattr(R6, "OUT_DIM", DIM)


def _jax(t, dtype=jnp.bfloat16):
    return jnp.asarray(t.float().numpy(), dtype)


@pytest.mark.parametrize("n", NS)
def test_strip_plan_matches_repro_interpret(monkeypatch, n):
    _shrink(monkeypatch, n)
    x, wqkv, bias = inputs(n)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(R10.build()(_jax(x), _jax(wqkv),
                                     _jax(bias, jnp.float32)), np.float32)
    assert ref.shape == (BW, n, HEADS * DIM_HEAD)
    ours = strip_stacked(x, wqkv, bias)
    assert _rel(ours.numpy(), ref) <= 2 * BF16_STEP


@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("k_pack", [2, 4])
def test_outproj_plan_matches_headpack_repro_interpret(monkeypatch, k_pack,
                                                       two_pass):
    n = rp1.N_PAD
    _shrink(monkeypatch, n, PACK_HEADS)
    x, wqkv, bias, wout = rpw.inputs(BW, torch.bfloat16, torch.device("cpu"),
                                     4, n=n, dim=DIM, heads=PACK_HEADS,
                                     dim_head=DIM_HEAD, out_dim=DIM)
    fn = R5.build(two_pass) if k_pack == 2 else R6.build(k_pack, two_pass)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fn(_jax(x), _jax(wqkv), _jax(bias, jnp.float32),
                            _jax(wout)), np.float32)
    assert ref.shape == (BW, n, DIM) and np.isfinite(ref).all()
    ours = strip_outproj(x, wqkv, bias, wout).bfloat16().float()
    assert _rel(ours.numpy(), ref) <= 2 * BF16_STEP


def test_wrappers_on_cpu_count_no_route():
    """On CPU tensors R10's and R5/R6's wrappers run the plain version and
    count no launch on either design."""
    x, wqkv, bias = inputs(9)
    before = (dict(cuda_av.stacked_route_launches),
              dict(cuda_av.headpack_route_launches))
    torch.testing.assert_close(
        cuda_av.stacked_softmax_attention(x, wqkv, bias),
        plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD),
        rtol=0, atol=0)
    xt, wt, bt, wo = rpw.inputs(3, torch.bfloat16, torch.device("cpu"), 4,
                                n=9, dim=DIM, heads=PACK_HEADS,
                                dim_head=DIM_HEAD, out_dim=DIM)
    torch.testing.assert_close(
        cuda_av.headpack_attention(xt, wt, bt, wo, k_pack=2, two_pass=True),
        plain.outproj_attention(xt, wt, bt, wo, PACK_HEADS, DIM_HEAD),
        rtol=0, atol=0)
    assert (dict(cuda_av.stacked_route_launches),
            dict(cuda_av.headpack_route_launches)) == before
    assert library._lib is None


def test_headpack_stacked_sections_patches_every_place():
    """``repros/headpack_stacked_sections.py`` finds its places in the
    committed sources (their headers inlined): R10's strip kernel at the
    other CTAs an SM, a stamp after each of the strip body's five sections,
    the counts opened and flushed in R10's strip kernel, the body's
    signature and its call taking the counts; both sources carry their own
    route and occupancy exports; its cases are the repros' lists."""
    from vit_grid_model_tpu_torch.repros import headpack_stacked_sections \
        as tool

    v = tool.variants(library.CSRC)
    assert set(v) == {"headpack", "stacked", "stacked_ctas2",
                      "stacked_stamp"}
    for text in v.values():
        assert '#include "' not in text
    assert tool.CTAS.format(3) in v["stacked"]
    assert tool.CTAS.format(2) in v["stacked_ctas2"]
    assert tool.CTAS.format(3) not in v["stacked_ctas2"]
    stamp = v["stacked_stamp"]
    assert stamp.count("STAMP(") == len(tool.SECTIONS) + 1  # + the macro
    assert "long long* sec_acc, long long& sec_last) {" in stamp
    assert "store, sec_acc, sec_last);" in stamp
    assert "atomicAdd(&g_sections[k]" in stamp
    for key, prefix in (("headpack", "vgm_headpack_attention"),
                        ("stacked", "vgm_stacked_softmax_attention")):
        for export in ("_route", "_occupancy"):
            assert prefix + export in v[key]
        assert "sections_occupancy_of" not in v[key]
    assert "outproj_attention_strips<true, true>" in v["headpack"]
    versions = list(rp5.VERSIONS) + list(rp6.VERSIONS)
    assert set(tool.HEADPACK_CASES) == {
        name for name in versions if name[:4] in ("pair", "quad", "oct_")}


def test_ptxas_report_is_read():
    from vit_grid_model_tpu_torch.repros import headpack_stacked_sections \
        as tool

    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1kv",
        "    8 bytes stack frame, 12 bytes spill stores, 16 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers, 8 bytes "
        "cumulative stack size, 400 bytes cmem[0]",
        "ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1jv",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 80 registers, used 1 barriers"])
    got = tool.ptxas_kernels(log)
    assert sorted(got.values()) == [(80, 0, 0), (128, 12, 16)]
