"""R15, the fused inference MBConv, on the CPU: its plain version
(``ops/mbconv.py::fused_mbconv_reference``) against the TPU repro's own XLA
reference (``repro_fused_mbconv.py::xla_reference``) at 2 x 42 x 35,
128 -> 512; the port's folded MBConv against JAX ``mbconv(fold_bn=True)``;
the kernel operands of a block against the block; and the whole model with
``fold_bn_eval`` against ``metnet3_apply``.  Inputs come from numpy seeds.

Tolerances, of max|reference|: f32 1e-5 (JAX under the conftest's highest
matmul precision; sums in another order), bf16 2e-2 (both round the same
values at the same points, but the f32 sums before each rounding differ
in order), whole forward 1e-4.  The kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from benchmarks.mosaic_repros import repro_fused_mbconv as R15
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_metnet3 import (_cfg, _inputs, _jax_forward,
                                           _port_forward, _rel, _stage)
from vit_grid_model_tpu.core import torch_export
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu.ops import mbconv as jmb
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.ops import mbconv as tmb
from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

KEY = jax.random.PRNGKey(0)


def _operands(seed, c=R15.DIN, hid=R15.HID, se=R15.SHR):
    """The repro's operand shapes and scales (``make_inputs``), f32 numpy."""
    rng = np.random.default_rng(seed)

    def sc(shape, f=0.05):
        return (rng.standard_normal(shape) * f).astype(np.float32)

    return (sc((c, hid)), sc((hid,)), sc((3, 3, hid), 0.2), sc((hid,)),
            sc((hid, se)), sc((se,)), sc((se, hid)), sc((hid,)),
            sc((hid, c)), sc((c,)))


def _rel_np(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_reference_matches_xla_reference(dtype, tol):
    ops = _operands(0)
    x = np.random.default_rng(1).standard_normal(
        (2, R15.H, R15.W, R15.DIN)).astype(np.float32)
    ref = R15.xla_reference(jnp.asarray(x, getattr(jnp, dtype)),
                            *map(jnp.asarray, ops))
    ours = tmb.fused_mbconv_reference(
        torch.from_numpy(x).to(getattr(torch, dtype)),
        tuple(map(torch.from_numpy, ops)))
    assert ours.dtype == getattr(torch, dtype)
    assert _rel_np(ours.float().numpy(), np.asarray(ref, np.float32)) <= tol


def test_wrapper_runs_plain_on_cpu():
    """A CPU tensor takes the plain version; the launch count stays."""
    ops = tuple(map(torch.from_numpy, _operands(2, 32, 128, 32)))
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (3, 9, 7, 32)).astype(np.float32))
    before = cuda_mbconv.launches
    torch.testing.assert_close(cuda_mbconv.fused_mbconv(x, ops),
                               tmb.fused_mbconv_reference(x, ops),
                               rtol=0, atol=0)
    assert cuda_mbconv.launches == before


def _bn_params(c, seed):
    rng = np.random.default_rng(seed)
    return {"scale": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32),
            "bias": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
            "mean": jnp.asarray(rng.normal(0, 0.1, c), jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 1.5, c), jnp.float32)}


def _twin_blocks(dim_in, dim_out, downsample, seed):
    """JAX MBConv params with non-trivial BN statistics and the port block
    holding the same weights."""
    p = jmb.mbconv_init(jax.random.PRNGKey(seed), dim_in, dim_out,
                        downsample=downsample)
    for i, name in enumerate(("bn1", "bn2", "bn3")):
        p[name] = _bn_params(p[name]["scale"].shape[0], seed + 10 + i)
    block = tmb.mbconv(dim_in, dim_out, downsample=downsample).eval()
    sd = {}
    torch_export._emit_mbconv(sd, "m", p, residual=dim_in == dim_out
                              and not downsample)
    block.load_state_dict({k[2:]: torch.from_numpy(np.array(v))
                           for k, v in sd.items()}, strict=True)
    return p, block


@pytest.mark.parametrize("dim_in,dim_out,downsample", [
    (16, 16, True), (16, 16, False), (8, 16, True)])
def test_folded_mbconv_matches_jax(dim_in, dim_out, downsample):
    p, block = _twin_blocks(dim_in, dim_out, downsample, 5)
    x = np.random.default_rng(6).standard_normal(
        (2, 7, 6, dim_in)).astype(np.float32)
    ref = jmb.mbconv(p, jnp.asarray(x), dim_in=dim_in, dim_out=dim_out,
                     downsample=downsample, fold_bn=True)
    with torch.no_grad():
        ours = block(torch.from_numpy(x).permute(0, 3, 1, 2), None, True)
    assert _rel_np(ours.permute(0, 2, 3, 1).numpy(), ref) <= 1e-5


@pytest.mark.parametrize("residual", [True, False])
def test_kernel_operands_reproduce_the_folded_block(residual):
    """The fused MBConv on ``mbconv_kernel_operands`` equals the folded
    block, plus x where the block has no residual of its own."""
    _, block = _twin_blocks(16, 16, not residual, 7)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (2, 9, 7, 16)).astype(np.float32))
    with torch.no_grad():
        ref = block(x.permute(0, 3, 1, 2), None, True).permute(0, 2, 3, 1)
    if not residual:
        ref = ref + x
    ours = tmb.fused_mbconv_reference(x, tmb.mbconv_kernel_operands(block))
    assert _rel_np(ours.numpy(), ref.numpy()) <= 1e-5


def test_repro_block_operands_have_the_kernel_widths():
    """The harness's block is the flagship width with zero SE biases."""
    ops = tmb.mbconv_kernel_operands(repro.block(dim=32))
    assert tuple(ops[0].shape) == (32, 128) and tuple(ops[4].shape) == (128,
                                                                        32)
    assert not ops[5].any() and not ops[7].any()
    assert (32, 128, 32) in cuda_mbconv.WIDTHS


@pytest.mark.parametrize("hidden,heads", [(16, 4), (24, 3)])
def test_whole_model_fold_bn_eval_matches_jax(hidden, heads):
    cfg = dataclasses.replace(_cfg(hidden, heads), fold_bn_eval=True)
    params = metnet3_init(jax.random.PRNGKey(9), cfg)
    # non-trivial BN statistics, so that the fold changes the weights
    conv = params["vit"]["layers"][0]["conv"]
    for i, name in enumerate(("bn1", "bn2", "bn3")):
        conv[name] = _bn_params(conv[name]["scale"].shape[0], 40 + i)
    stack, ts = _inputs(4)
    x = _stage(stack, cfg)
    ref = _jax_forward(params, cfg, x, ts)
    ours = _port_forward(params_from_jax(params, cfg), x, ts)
    assert _rel(ours, ref) <= 1e-4
    unfolded = _port_forward(params_from_jax(
        params, dataclasses.replace(cfg, fold_bn_eval=False)), x, ts)
    assert not np.array_equal(ours, unfolded)


def test_bound_matches_the_worked_figures():
    """BN = 384 at 42 x 35, 128 -> 512 in bf16: ~153 GFLOP, bound by the
    operations at ~0.155 ms."""
    ms, by = repro.bound_ms(384, 42, 35, 128, 512, 128, torch.bfloat16)
    assert by == "operations" and abs(ms - 0.155) < 0.001
