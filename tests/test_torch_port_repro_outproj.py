"""R12, R13, R2 and R8 (R1's attention plus the out-projection) on the CPU:
the port's one plain version (``ops/attention_variants.py::
outproj_attention``) and the wrapper of ``ops/cuda/attention_variants.py``
on CPU tensors against the TPU repros run in Pallas TPU interpret mode,
with ``benchmarks.mosaic_repros.common.BW`` shrunk through monkeypatch
(nothing in ``benchmarks/`` changes); the bound the repros print.

Every one of these repros writes a bf16 output, whatever x's dtype
(``out_shape`` is fixed to bf16), so the f32 cases (R12 and R13) are held
to one bf16 step, 2^-8 of max|reference| (an f32 sum in another order can
round an output element the other way), and not to 1e-5.  The bf16 cases
are held to 2e-2 of max|reference| (bf16 rounding at other points).
The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_bf16_mxu_operands as R2
from benchmarks.mosaic_repros import repro_npad_and_kfold as R8
from benchmarks.mosaic_repros import repro_weightsliced_variants as R13
from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.repros import bf16_mxu_operands as rp2
from vit_grid_model_tpu_torch.repros import npad_and_kfold as rp8
from vit_grid_model_tpu_torch.repros import weightsliced_variants as rpw
from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

BW = 32        # windows of the shrunk repros (four 8-window programs)
BF16_TOL = 2e-2
F32_TOL = 2.0 ** -8   # one bf16 step: the repros write bf16


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _inputs(dtype, n=RC.N_PAD):
    """(numpy x, wqkv, bias, wout; the same as torch tensors in ``dtype``)
    from ``repros/weightsliced_variants.inputs``."""
    arrays = [t.numpy() for t in rpw.inputs(BW, torch.float32,
                                            torch.device("cpu"), 0, n=n)]
    tdt = getattr(torch, dtype)
    tensors = [torch.from_numpy(a).to(tdt) for a in arrays]
    tensors[2] = torch.from_numpy(arrays[2])       # the bias stays f32
    return arrays, tensors


def _repro(fn, dtype, x, wqkv, bias, wout):
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x, jdt), jnp.asarray(wqkv, jdt),
                             jnp.asarray(bias), jnp.asarray(wout, jdt)),
                          np.float32)


def _check(ref, tensors, dtype, tol, **kw):
    """The plain version (bf16 output) and the wrapper on CPU tensors (from
    R9's weight and from R1's) against ``ref`` within ``tol`` of
    max|ref|."""
    xt, wt, bt, wo = tensors
    ours = plain.outproj_attention(xt, wt, bt, wo, RC.HEADS, RC.DIM_HEAD,
                                   **{k: v for k, v in kw.items()
                                      if k.startswith("bf16")})
    assert ours.dtype == torch.bfloat16
    assert tuple(ours.shape) == (BW, xt.shape[1], RC.DIM)
    for w in (weight4(wt), wt):
        torch.testing.assert_close(cuda_av.outproj_attention(
            xt, w, bt, wo, **kw), ours, rtol=0, atol=0)
    assert _rel(ours.float().numpy(), ref) <= tol


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", list(rpw.VARIANTS))
def test_weightsliced_variant_matches_repro(monkeypatch, variant, dtype):
    """R12 (``baseline``) and R13's four variants: one function."""
    monkeypatch.setattr(RC, "BW", BW)
    arrays, tensors = _inputs(dtype)
    ref = _repro(R13.build(variant), dtype, *arrays)
    _, two_pass, perhead = rpw.VARIANTS[variant]
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _check(ref, tensors, dtype, tol, two_pass=two_pass,
           perhead_wout=perhead)


@pytest.mark.parametrize("cast", list(rp2.CASTS))
def test_r2_casts_match_repro(monkeypatch, cast):
    """R2's four cast variants in bf16, each against its own plain
    version with the same casts."""
    monkeypatch.setattr(RC, "BW", BW)
    arrays, tensors = _inputs("bfloat16")
    score, agg = rp2.CASTS[cast]
    ref = _repro(R2.build(score, agg), "bfloat16", *arrays)
    _check(ref, tensors, "bfloat16", BF16_TOL, two_pass=True,
           perhead_wout=True, bf16_score=score, bf16_agg=agg)


def test_r2_casts_are_r13_in_f32(monkeypatch):
    """In f32 the casts are no-ops: R2's four variants and R13's
    ``ws_2pass_pwout`` give the same output, in the repros and in the plain
    version."""
    monkeypatch.setattr(RC, "BW", BW)
    arrays, tensors = _inputs("float32")
    ref = _repro(R13.build("ws_2pass_pwout"), "float32", *arrays)
    xt, wt, bt, wo = tensors
    ours = plain.outproj_attention(xt, wt, bt, wo, RC.HEADS, RC.DIM_HEAD)
    for score, agg in rp2.CASTS.values():
        np.testing.assert_array_equal(
            _repro(R2.build(score, agg), "float32", *arrays), ref)
        torch.testing.assert_close(plain.outproj_attention(
            xt, wt, bt, wo, RC.HEADS, RC.DIM_HEAD, bf16_score=score,
            bf16_agg=agg), ours, rtol=0, atol=0)


@pytest.mark.parametrize("kfold", rp8.KFOLDS)
@pytest.mark.parametrize("n_pad", rp8.N_PADS)
def test_npad_kfold_matches_repro(monkeypatch, n_pad, kfold):
    """R8's six (n_pad, kfold) cases in bf16 on inputs drawn at n_pad; kfold
    is 8 * kfold windows a CTA on the card."""
    monkeypatch.setattr(RC, "BW", BW)
    arrays, tensors = _inputs("bfloat16", n=n_pad)
    ref = _repro(R8.build(n_pad, kfold), "bfloat16", *arrays)
    _check(ref, tensors, "bfloat16", BF16_TOL, two_pass=True,
           perhead_wout=True, windows_per_cta=rp8.BLK * kfold)


def test_wrapper_weight_and_wout_layouts_agree():
    """The plain version takes wout as (heads * dh, out) or (heads, dh,
    out), and the wrapper R1's or R9's weight, for the same result."""
    xt, wt, bt, wo = rpw.inputs(3, torch.float32, torch.device("cpu"), 2,
                                n=9, dim=32, heads=3, dim_head=16,
                                out_dim=48)
    ref = plain.outproj_attention(xt, wt, bt, wo, 3, 16,
                                  out_dtype=torch.float32)
    assert ref.dtype == torch.float32 and tuple(ref.shape) == (3, 9, 48)
    torch.testing.assert_close(plain.outproj_attention(
        xt, wt, bt, wo.reshape(48, 48), 3, 16, out_dtype=torch.float32),
        ref, rtol=0, atol=0)
    torch.testing.assert_close(cuda_av.outproj_attention(
        xt, weight4(wt, 3), bt, wo, two_pass=False, perhead_wout=False,
        out_dtype=torch.float32), ref, rtol=0, atol=0)


def test_plain_sums_the_heads_out_projections():
    """The out-projection of the rounded head outputs equals the sum over
    heads of each head's (dh, out) product, in f32 to rounding: the concat
    and the per-head structures compute one function."""
    xt, wt, bt, wo = rpw.inputs(4, torch.float32, torch.device("cpu"), 5,
                                n=9, dim=32, heads=3, dim_head=16,
                                out_dim=32)
    y = plain.outproj_attention(xt, wt, bt, wo, 3, 16,
                                out_dtype=torch.float32)
    o = plain.perhead_qkv_attention(xt, wt, bt, 3, 16).reshape(4, 9, 3, 16)
    parts = sum(o[:, :, h] @ wo[h] for h in range(3))
    assert _rel(y.numpy(), parts.numpy()) <= 1e-6


def test_outproj_wrappers_run_plain_on_cpu_and_count_nothing():
    xt, wt, bt, wo = rpw.inputs(5, torch.float32, torch.device("cpu"), 1,
                                n=9, dim=32, heads=3, dim_head=16,
                                out_dim=32)
    before = (cuda_av.crosshead_launches, dict(cuda_av.outproj_launches))
    torch.testing.assert_close(
        cuda_av.crosshead_norm_attention(xt, wt, bt),
        plain.perhead_qkv_attention(xt, wt, bt, 3, 16), rtol=0, atol=0)
    for tp in (False, True):
        for pw in (False, True):
            torch.testing.assert_close(
                cuda_av.outproj_attention(xt, wt, bt, wo, two_pass=tp,
                                          perhead_wout=pw,
                                          windows_per_cta=16),
                plain.outproj_attention(xt, wt, bt, wo, 3, 16), rtol=0,
                atol=0)
    assert (cuda_av.crosshead_launches,
            dict(cuda_av.outproj_launches)) == before


@pytest.mark.parametrize("bw,n,ms", [(2880, 56, 0.208), (9000, 56, 0.651),
                                     (2880, 64, 0.244), (9000, 64, 0.763)])
def test_outproj_bound(bw, n, ms):
    """71.57 MFLOP a window at n 56 (R1's 56.89 plus the out-projection's
    14.68) and 83.89 at n 64, at the bf16 peak; 84 MB move at Bw 2,880."""
    bound, by = rpw.bound_ms(bw, n, 128, 32, 32, 128, torch.bfloat16)
    assert by == "operations" and abs(bound - ms) < 0.001
