"""R4, R10, R9, R11 and R3 (variants of R1's per-head attention) on the CPU:
the port's plain versions (``ops/attention_variants.py``) and the wrappers of
``ops/cuda/attention_variants.py`` on CPU tensors against the TPU repros
run in Pallas TPU interpret mode, with ``benchmarks.mosaic_repros.common.BW``
shrunk through monkeypatch (nothing in ``benchmarks/`` changes); R11's core
alone against the repro's ``core_kernel``; the bounds the repros print.

Tolerances, of max|reference|: f32 1e-5 (JAX under the conftest's highest
matmul precision; sums in another order), bf16 2e-2 (bf16 rounding at other
points).  The kernels themselves run only on the card
(``tests/test_torch_port_cuda.py``).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_crosshead_rmsnorm_gemm as R3
from benchmarks.mosaic_repros import repro_headmajor_batched as R4
from benchmarks.mosaic_repros import repro_perhead_weight_gemm as R9
from benchmarks.mosaic_repros import repro_stacked_softmax as R10
from benchmarks.mosaic_repros import repro_staged_headmajor as R11
from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.repros import baseline_perhead as rp1
from vit_grid_model_tpu_torch.repros import perhead_weight_gemm as rp9
from vit_grid_model_tpu_torch.repros import staged_headmajor as rp11

BW = 32        # windows of the shrunk repros (four 8-window programs)
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _inputs(dtype):
    """(numpy inputs, the same as torch tensors in ``dtype``) from R1's
    repro inputs."""
    x, wqkv, bias = (t.numpy() for t in rp1.inputs(
        BW, torch.float32, torch.device("cpu"), 0))
    tdt = getattr(torch, dtype)
    return ((x, wqkv, bias),
            (torch.from_numpy(x).to(tdt), torch.from_numpy(wqkv).to(tdt),
             torch.from_numpy(bias)))


def _repro(module, dtype, x, wqkv, bias):
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(module.build()(
            jnp.asarray(x, jdt), jnp.asarray(wqkv, jdt), jnp.asarray(bias)),
            np.float32)


def _r9_wrapper(x, wqkv, bias):
    return cuda_av.perhead_weight_attention(x, rp9.weight4(wqkv), bias)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("module,wrapper", [
    (R4, cuda_av.headmajor_attention),
    (R10, cuda_av.stacked_softmax_attention),
    (R9, _r9_wrapper),
    (R3, cuda_av.crosshead_norm_attention)], ids=["R4", "R10", "R9", "R3"])
def test_variant_matches_repro(monkeypatch, module, wrapper, dtype):
    """R4, R10, R9 and R3 compute R1's function: the plain version and
    the wrapper on CPU tensors against the repro's own kernel (R3's norms
    through its block-indicator products)."""
    monkeypatch.setattr(RC, "BW", BW)
    (x, wqkv, bias), (xt, wt, bt) = _inputs(dtype)
    ref = _repro(module, dtype, x, wqkv, bias)
    ours = plain.perhead_qkv_attention(xt, wt, bt, RC.HEADS, RC.DIM_HEAD)
    wrapped = wrapper(xt, wt, bt)
    assert ours.dtype == getattr(torch, dtype)
    assert tuple(ours.shape) == (BW, RC.N_PAD, RC.HEADS * RC.DIM_HEAD)
    torch.testing.assert_close(wrapped, ours, rtol=0, atol=0)
    assert _rel(ours.float().numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_matches_r11(monkeypatch, dtype):
    """R11 whole: staging, core and layout back."""
    monkeypatch.setattr(RC, "BW", BW)
    (x, wqkv, bias), (xt, wt, bt) = _inputs(dtype)
    ref = _repro(R11, dtype, x, wqkv, bias)
    ours = plain.staged_headmajor_attention(xt, wt, bt, RC.HEADS,
                                            RC.DIM_HEAD)
    assert ours.dtype == getattr(torch, dtype)
    torch.testing.assert_close(cuda_av.staged_attention(xt, wt, bt), ours,
                               rtol=0, atol=0)
    assert _rel(ours.float().numpy(), ref) <= TOL[dtype]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_core_matches_r11_core_kernel(monkeypatch, dtype):
    """R11's core alone, on the same staged operands, against the repro's
    ``core_kernel`` under the repro's own pallas_call specs."""
    monkeypatch.setattr(RC, "BW", BW)
    (x, wqkv, bias), _ = _inputs("float32")
    tdt = getattr(torch, dtype)
    qkv = torch.from_numpy(x) @ torch.from_numpy(wqkv)
    qn, kn, v = plain.stage_headmajor(qkv, RC.HEADS, RC.DIM_HEAD, tdt)
    spec = pl.BlockSpec((RC.HEADS, RC.BLK, RC.N_PAD, RC.DIM_HEAD),
                        lambda i: (0, i, 0, 0), memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(R11.core_kernel, heads=RC.HEADS, blk=RC.BLK),
            grid=(BW // RC.BLK,),
            in_specs=[spec, spec, spec,
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(tuple(qn.shape),
                                           getattr(jnp, dtype)))
        ref = np.asarray(call(*(jnp.asarray(t.float().numpy(),
                                            getattr(jnp, dtype))
                                for t in (qn, kn, v)), jnp.asarray(bias)),
                         np.float32)
    bt = torch.from_numpy(bias)
    ours = plain.staged_headmajor_core(qn, kn, v, bt)
    assert ours.dtype == tdt and tuple(ours.shape) == tuple(qn.shape)
    torch.testing.assert_close(cuda_av.staged_attention_core(qn, kn, v, bt),
                               ours, rtol=0, atol=0)
    assert _rel(ours.float().numpy(), ref) <= TOL[dtype]


def test_staged_equals_perhead_in_f32():
    """In f32 nothing is rounded between R11's stages, so R11 is R1's
    function: the two plain versions agree to f32 rounding."""
    xt, wt, bt = rp1.inputs(7, torch.float32, torch.device("cpu"), 3, n=9,
                            dim=32, heads=3, dim_head=16)
    ours = plain.staged_headmajor_attention(xt, wt, bt, 3, 16)
    ref = plain.perhead_qkv_attention(xt, wt, bt, 3, 16)
    assert _rel(ours.numpy(), ref.numpy()) <= 1e-6


def test_r9_weight_is_the_repro_reshape():
    """``repros/perhead_weight_gemm.py::weight4`` is R9's (3, heads, dim,
    dh) weight as the TPU repro makes it (``:67``)."""
    _, wqkv, _ = rp1.inputs(1, torch.float32, torch.device("cpu"), 0)
    ref = np.asarray(jnp.asarray(wqkv.numpy()).reshape(
        RC.DIM, 3, RC.HEADS, RC.DIM_HEAD).transpose(1, 2, 0, 3))
    np.testing.assert_array_equal(rp9.weight4(wqkv).numpy(), ref)


def test_wrappers_run_plain_on_cpu_and_count_nothing():
    xt, wt, bt = rp1.inputs(5, torch.float32, torch.device("cpu"), 1, n=9,
                            dim=32, heads=3, dim_head=16)
    qn, kn, v = plain.stage_headmajor(xt @ wt, 3, 16, torch.float32)
    before = (cuda_av.headmajor_launches, cuda_av.stacked_launches,
              cuda_av.perhead_weight_launches, cuda_av.staged_core_launches,
              cuda_av.crosshead_launches)
    ref = plain.perhead_qkv_attention(xt, wt, bt, 3, 16)
    for out in (cuda_av.headmajor_attention(xt, wt, bt),
                cuda_av.crosshead_norm_attention(xt, wt, bt, 2),
                cuda_av.stacked_softmax_attention(xt, wt, bt),
                cuda_av.perhead_weight_attention(xt, rp9.weight4(wt, 3), bt),
                cuda_av.staged_attention(xt, wt, bt)):
        assert _rel(out.numpy(), ref.numpy()) <= 1e-6
    torch.testing.assert_close(cuda_av.staged_attention_core(qn, kn, v, bt),
                               plain.staged_headmajor_core(qn, kn, v, bt),
                               rtol=0, atol=0)
    assert (cuda_av.headmajor_launches, cuda_av.stacked_launches,
            cuda_av.perhead_weight_launches, cuda_av.staged_core_launches,
            cuda_av.crosshead_launches) == before


@pytest.mark.parametrize("bw,ms", [(2880, 0.394), (9000, 1.233)])
def test_staged_core_bound(bw, ms):
    """q, k, v and out in bf16 plus the f32 bias: 1.32 GB at Bw 2,880 and
    4.13 GB at 9,000, above the 37.0 / 115.6 GFLOP of the two products."""
    bound, by = rp11.core_bound_ms(bw, 56, 32, 32, torch.bfloat16)
    assert by == "bytes" and abs(bound - ms) < 0.001


def test_staged_whole_bound():
    """R11 whole at Bw 2,880: x, weights and bias, the f32 qkv written and
    read (3.96 GB), q, k, v staged (1.98 GB), the head-major output written
    and read and the output written (0.99 GB): 6.98 GB."""
    bound, by = rp11.staged_bound_ms(2880, 56, 128, 32, 32, torch.bfloat16)
    assert by == "bytes" and abs(bound - 2.083) < 0.001


def test_r3_indicator_norm_is_the_per_head_norm():
    """R3's block indicator (``:63-66``) turns the squared qkv's product
    into each head's sum of squares: the indicator-normalized q and k equal
    the per-head l2-normalized ones of ``stage_headmajor``."""
    xt, wt, _ = rp1.inputs(2, torch.float32, torch.device("cpu"), 4, n=9,
                           dim=32, heads=3, dim_head=16)
    qkv = (xt @ wt).reshape(-1, 3 * 3 * 16)
    ind = torch.zeros(3 * 3 * 16, 3 * 3)
    for g in range(3 * 3):
        ind[g * 16:(g + 1) * 16, g] = 1.0
    inv = torch.rsqrt(torch.clamp(qkv.square() @ ind, min=1e-24))
    normed = (qkv * (inv @ ind.T)).reshape(2, 9, 3, 3, 16)
    qn, kn, _ = plain.stage_headmajor((xt @ wt), 3, 16, torch.float32)
    torch.testing.assert_close(normed[:, :, 0].permute(2, 0, 1, 3), qn,
                               rtol=1e-6, atol=1e-7)
    torch.testing.assert_close(normed[:, :, 1].permute(2, 0, 1, 3), kn,
                               rtol=1e-6, atol=1e-7)
