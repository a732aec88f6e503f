"""R1/R14 (the per-head attention repro) and R7 (the MaxViT layer
megakernel) on the CPU: the port's plain versions
(``ops/attention_variants.py``) against the TPU repros run in Pallas TPU
interpret mode, with the repros' module constants shrunk through
monkeypatch (nothing in ``benchmarks/`` changes); the kernel operands of
``repros/megakernel.py::layer_operands`` against the JAX parameters they
come from; the wrappers on CPU tensors; the bounds the repros print.

Tolerances, of max|reference|: f32 1e-5 for R1 (JAX under the conftest's
highest matmul precision; sums in another order), f32 1e-4 for R7 (two
attentions and a mean in another order), bf16 2e-2 (bf16 rounding at
other points: the plain R7 keeps the normalized x and P.v in f32).  The
kernels themselves run only on the card (``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_baseline_perhead as R1
from benchmarks.mosaic_repros import repro_megakernel as R7
from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.ops import nn as jnn
from vit_grid_model_tpu.ops.attention import attention_init
from vit_grid_model_tpu_torch.core.export import _emit_attention
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.attention import Attention
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.repros import baseline_perhead as rp1
from vit_grid_model_tpu_torch.repros import megakernel as rp7

BW = 32        # windows of the shrunk R1 (two 16-window programs)
S = 2          # sample-leads of the shrunk R7


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _r1_inputs():
    x, wqkv, bias = rp1.inputs(BW, torch.float32, torch.device("cpu"), 0)
    return x.numpy(), wqkv.numpy(), bias.numpy()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("blk", [8, 16])
def test_perhead_plain_matches_r1(monkeypatch, blk, dtype, tol):
    """R1 at 8 windows a program, and R14 (R1's call at 16)."""
    monkeypatch.setattr(RC, "BW", BW)
    x, wqkv, bias = _r1_inputs()
    with pltpu.force_tpu_interpret_mode():
        ref = R1.build(blk)(jnp.asarray(x, dtype), jnp.asarray(wqkv, dtype),
                            jnp.asarray(bias))
    tdt = getattr(torch, dtype)
    ours = plain.perhead_qkv_attention(
        torch.from_numpy(x).to(tdt), torch.from_numpy(wqkv).to(tdt),
        torch.from_numpy(bias), RC.HEADS, RC.DIM_HEAD)
    assert ours.dtype == tdt and tuple(ours.shape) == (BW, 56, 1024)
    assert _rel(ours.float().numpy(), ref) <= tol


@pytest.fixture(scope="module")
def layer():
    """R7's flagship layer at S = 2: JAX params as the repro draws them
    (non-trivial q/k gains), the registers, cond and bf16-scale maps, all
    as numpy, and the port's modules holding the same weights."""
    ks = jax.random.split(jax.random.PRNGKey(0), 2)
    rng = np.random.default_rng(0)
    params = []
    for k in ks:
        p = attention_init(k, R7.DIM, cond_dim=R7.COND, heads=R7.HEADS,
                           dim_head=R7.DIM_HEAD, window_size=R7.WIN,
                           num_registers=R7.NR)
        for name in ("q_norm", "k_norm"):
            p[name]["gamma"] = jnp.asarray(
                rng.uniform(0.5, 1.5, (R7.HEADS, 1, R7.DIM_HEAD)), jnp.float32)
        params.append(p)
    regs = rng.standard_normal((R7.NR, R7.DIM)).astype(np.float32)
    cond = rng.standard_normal((S, R7.COND)).astype(np.float32)
    x = (0.5 * rng.standard_normal((S, R7.H, R7.Wd, R7.DIM))
         ).astype(np.float32)
    modules = []
    for p in params:
        sd = {}
        _emit_attention(sd, "a", p)
        m = Attention(R7.DIM, cond_dim=R7.COND, heads=R7.HEADS,
                      dim_head=R7.DIM_HEAD, window_size=R7.WIN)
        m.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()},
                          strict=True)
        modules.append(m.eval())
    return params, modules, regs, cond, x


def _plain_layer(layer, dtype):
    _, (mb, mg), regs, cond, x = layer
    tdt = getattr(torch, dtype)
    r, ob, og = rp7.layer_operands(mb, mg, torch.from_numpy(regs),
                                   torch.from_numpy(cond), tdt)
    with torch.no_grad():
        out = plain.maxvit_layer_attention(torch.from_numpy(x).to(tdt), r,
                                           ob, og, R7.WIN)
    assert out.dtype == tdt and tuple(out.shape) == x.shape
    return out.float().numpy()


def test_layer_plain_matches_r7_megakernel_bf16(monkeypatch, layer):
    monkeypatch.setattr(R7, "S", S)
    (pb, pg), _, regs, cond, x = layer
    with pltpu.force_tpu_interpret_mode():
        ref = R7.build(pb, pg, jnp.asarray(regs), jnp.asarray(cond))(
            jnp.asarray(x, jnp.bfloat16))
    assert _rel(_plain_layer(layer, "bfloat16"), ref) <= 2e-2


def test_layer_plain_matches_r7_baseline_f32(monkeypatch, layer):
    monkeypatch.setattr(R7, "S", S)
    (pb, pg), _, regs, cond, x = layer
    with pltpu.force_tpu_interpret_mode():
        ref = R7.build_baseline(pb, pg, jnp.asarray(regs),
                                jnp.asarray(cond))(jnp.asarray(x))
    assert _rel(_plain_layer(layer, "float32"), ref) <= 1e-4


def test_layer_plain_matches_two_call_baseline(layer):
    """In f32 the plain layer equals the repro's two-launch baseline, which
    on the CPU runs the plain window attention."""
    _, (mb, mg), regs, cond, x = layer
    with torch.no_grad():
        ref = rp7.baseline(torch.from_numpy(x), mb, mg,
                           torch.from_numpy(regs), torch.from_numpy(cond))
    assert _rel(_plain_layer(layer, "float32"), ref.numpy()) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_operands_carry_jax_params(layer, dtype):
    """Each operand against what the TPU repro's ``build`` hands its
    kernel: FiLM gamma/beta rounded to the map's dtype, wqkv re-laid per
    head, wout per head, q/k gains, the bias gathered for the 53 real
    tokens (the repro's 64-padded bias cut to them)."""
    params, (mb, mg), regs, cond, _ = layer
    tdt = getattr(torch, dtype)
    jdt = getattr(jnp, dtype)
    r, *ops = rp7.layer_operands(mb, mg, torch.from_numpy(regs),
                                 torch.from_numpy(cond), tdt)
    assert r.dtype == tdt
    np.testing.assert_array_equal(r.float().numpy(), np.asarray(
        jnp.asarray(regs, jdt), np.float32))
    heads, dh, dim, n = R7.HEADS, R7.DIM_HEAD, R7.DIM, R7.N
    idx = R7.W.relative_position_indices(R7.WIN, R7.NR)
    for p, k in zip(params, ops):
        g, b = jnn.film(p["film"], jnp.asarray(cond))
        for ours, ref in ((k.gamma, g), (k.beta, b)):
            assert ours.dtype == torch.float32
            np.testing.assert_allclose(
                ours.numpy(), np.asarray(ref.astype(jdt), np.float32),
                rtol=1e-2 if dtype == "bfloat16" else 1e-5, atol=1e-6)
        w = np.asarray(p["to_qkv"]["w"].astype(jdt), np.float32)
        w = w.reshape(dim, 3, heads, dh).transpose(2, 0, 1, 3).reshape(
            heads, dim, 3 * dh)
        np.testing.assert_array_equal(k.wqkv.float().numpy(), w)
        np.testing.assert_array_equal(
            k.wout.float().numpy(), np.asarray(p["to_out"]["w"].astype(jdt),
                                               np.float32).reshape(heads, dh,
                                                                   dim))
        np.testing.assert_array_equal(k.qg.numpy(),
                                      np.asarray(p["q_norm"]["gamma"])[:, 0])
        np.testing.assert_array_equal(k.kg.numpy(),
                                      np.asarray(p["k_norm"]["gamma"])[:, 0])
        padded = np.asarray(R7._prep_bias(p, idx, n, R7.N_PAD))
        np.testing.assert_array_equal(k.bias.numpy(), padded[:, :n, :n])


def test_wrappers_run_plain_on_cpu(layer):
    """CPU tensors take the plain versions; the launch counts stay."""
    _, (mb, mg), regs, cond, x = layer
    xr, wqkv, bias = rp1.inputs(5, torch.float32, torch.device("cpu"), 1,
                                n=9, dim=32, heads=3, dim_head=16)
    r, ob, og = rp7.layer_operands(mb, mg, torch.from_numpy(regs),
                                   torch.from_numpy(cond), torch.float32)
    xt = torch.from_numpy(x)
    before = (dict(cuda_av.perhead_launches), cuda_av.layer_launches)
    with torch.no_grad():
        torch.testing.assert_close(
            cuda_av.perhead_attention(xr, wqkv, bias, 16),
            plain.perhead_qkv_attention(xr, wqkv, bias, 3, 16),
            rtol=0, atol=0)
        torch.testing.assert_close(
            cuda_av.maxvit_layer_attention(xt, r, ob, og, R7.WIN),
            plain.maxvit_layer_attention(xt, r, ob, og, R7.WIN),
            rtol=0, atol=0)
    assert (dict(cuda_av.perhead_launches), cuda_av.layer_launches) == before


@pytest.mark.parametrize("bw,ms", [(2880, 0.166), (9000, 0.518)])
def test_perhead_bound(bw, ms):
    """56.89 MFLOP a window: 163.8 GFLOP at Bw 2,880 and 512.0 at 9,000 on
    the bf16 peak, above the 372 MB / 1.16 GB moved."""
    bound, by = rp1.bound_ms(bw, 56, 128, 32, 32, torch.bfloat16)
    assert by == "operations" and abs(bound - ms) < 0.001


@pytest.mark.parametrize("s,ms", [(96, 0.391), (300, 1.221)])
def test_megakernel_bound(s, ms):
    """Two K1 calls: 67.08 MFLOP a window x 60 windows a sample-lead."""
    bound, by = rp7.bound_ms(s, torch.bfloat16)
    assert by == "operations" and abs(bound - ms) < 0.001
