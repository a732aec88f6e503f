"""R5 and R6 (R1's attention plus the out-projection, K heads a pack) on the
CPU: the port's plain version (``ops/attention_variants.py::
outproj_attention``) and the wrapper of ``ops/cuda/attention_variants.py``
on CPU tensors against the TPU repros run in Pallas TPU interpret mode,
with ``benchmarks.mosaic_repros.common.BW`` shrunk through monkeypatch
(nothing in ``benchmarks/`` changes); the repros' joint-max NaN; how many
of a pack's heads the wrapper puts in shared memory at once; the bound.

The repros write a bf16 output whatever x's dtype, so the f32 cases are held
to one bf16 step, 2^-8 of max|reference|, and the bf16 cases to 2e-2 (bf16
rounding at other points).  The kernel itself runs only on the card
(``tests/test_torch_port_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_headpair_lanepack as R5
from benchmarks.mosaic_repros import repro_headquad_lanepack as R6
from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.repros import headpair_lanepack as rp5
from vit_grid_model_tpu_torch.repros import headquad_lanepack as rp6
from vit_grid_model_tpu_torch.repros import weightsliced_variants as rpw
from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

BW = 32        # windows of the shrunk repros (four 8-window programs)
BF16_TOL = 2e-2
F32_TOL = 2.0 ** -8   # one bf16 step: the repros write bf16

# (k_pack, two_pass, windows a program) of R5's three builds and R6's four
BUILDS = [(2, True, 8), (2, False, 8), (2, True, 16),
          (4, True, 8), (4, False, 8), (4, True, 16), (8, True, 8)]


def _rel(ours, ref):
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _inputs(dtype):
    """(numpy x, wqkv, bias, wout; the same as torch tensors in ``dtype``,
    the bias f32) from ``repros/weightsliced_variants.inputs``."""
    arrays = [t.numpy() for t in rpw.inputs(BW, torch.float32,
                                            torch.device("cpu"), 0)]
    tensors = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]
    tensors[2] = torch.from_numpy(arrays[2])
    return arrays, tensors


def _build(k_pack, two_pass, blk):
    if k_pack == 2:
        return R5.build(two_pass, blk=blk)
    return R6.build(k_pack, two_pass, blk=blk)


def _repro(fn, dtype, x, wqkv, bias, wout):
    jdt = getattr(jnp, dtype)
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(fn(jnp.asarray(x, jdt), jnp.asarray(wqkv, jdt),
                             jnp.asarray(bias), jnp.asarray(wout, jdt)),
                          np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_pack,two_pass,blk", BUILDS)
def test_headpack_matches_repro(monkeypatch, k_pack, two_pass, blk, dtype):
    """R5's builds (K = 2) and R6's (K = 4, 8): the plain version (bf16
    output) within tolerance of the repro, and the wrapper on CPU tensors,
    from R1's weight and R9's, equal to it."""
    monkeypatch.setattr(RC, "BW", BW)
    arrays, (xt, wt, bt, wo) = _inputs(dtype)
    ref = _repro(_build(k_pack, two_pass, blk), dtype, *arrays)
    ours = plain.outproj_attention(xt, wt, bt, wo, RC.HEADS, RC.DIM_HEAD)
    assert ours.dtype == torch.bfloat16
    assert tuple(ours.shape) == (BW, RC.N_PAD, RC.DIM)
    assert _rel(ours.float().numpy(), ref) <= (
        F32_TOL if dtype == "float32" else BF16_TOL)
    for w in (wt, weight4(wt)):
        torch.testing.assert_close(cuda_av.headpack_attention(
            xt, w, bt, wo, k_pack=k_pack, two_pass=two_pass,
            windows_per_cta=blk), ours, rtol=0, atol=0)


def test_joint_max_nan_is_routed_around(monkeypatch):
    """With every odd head's bias 200 below, R5's joint pair max underflows:
    its output is NaN everywhere.  The plain version (a per-head max) stays
    finite, within 2e-2 of the repro's own per-head ``xla_reference``, and
    the CPU wrapper equals it."""
    monkeypatch.setattr(RC, "BW", BW)
    arrays, (xt, wt, bt, wo) = _inputs("bfloat16")
    arrays[2][1::2] -= 200.0
    bt = torch.from_numpy(arrays[2])
    x, wqkv, bias, wout = (jnp.asarray(arrays[0], jnp.bfloat16),
                           jnp.asarray(arrays[1], jnp.bfloat16),
                           jnp.asarray(arrays[2]),
                           jnp.asarray(arrays[3], jnp.bfloat16))
    with pltpu.force_tpu_interpret_mode():
        packed = np.asarray(R5.build(True)(x, wqkv, bias, wout), np.float32)
    assert np.isnan(packed).all()
    ref = np.asarray(R5.xla_reference(x, wqkv, bias, wout), np.float32)
    assert np.isfinite(ref).all()
    ours = plain.outproj_attention(xt, wt, bt, wo, RC.HEADS, RC.DIM_HEAD)
    assert bool(torch.isfinite(ours.float()).all())
    assert _rel(ours.float().numpy(), ref) <= BF16_TOL
    torch.testing.assert_close(cuda_av.headpack_attention(
        xt, wt, bt, wo, k_pack=2, two_pass=True), ours, rtol=0, atol=0)


def test_headpack_wrapper_runs_plain_on_cpu_and_counts_nothing():
    """Any K that divides the heads, in either pass structure and wout
    layout, runs the plain version on the CPU and launches nothing."""
    xt, wt, bt, wo = rpw.inputs(3, torch.float32, torch.device("cpu"), 4,
                                n=9, dim=32, heads=6, dim_head=16,
                                out_dim=48)
    ref = plain.outproj_attention(xt, wt, bt, wo, 6, 16,
                                  out_dtype=torch.float32)
    before = dict(cuda_av.headpack_launches)
    for k_pack in (1, 2, 3, 6):
        for two_pass in (False, True):
            for w_out in (wo, wo.reshape(96, 48)):
                torch.testing.assert_close(cuda_av.headpack_attention(
                    xt, wt, bt, w_out, k_pack=k_pack, two_pass=two_pass,
                    windows_per_cta=16, out_dtype=torch.float32), ref,
                    rtol=0, atol=0)
    assert dict(cuda_av.headpack_launches) == before


def _fake_smem_bytes(room_heads):
    """A stand-in for the kernel's shared-memory reckoning in which x, y and
    o_pack take MAX_SMEM - room_heads * 30,000 bytes and each head of a
    sub-pack 30,000."""
    def smem_bytes(dim, dh, out_dim, k_pack, sub_pack, two_pass, is_bf16):
        return cuda_av.MAX_SMEM + (sub_pack - room_heads) * 30000
    return smem_bytes


@pytest.mark.parametrize("k_pack,room_heads,want", [
    (2, 2, 2), (4, 4, 4), (8, 4, 4), (8, 3, 2), (6, 5, 3), (4, 0, 0)])
def test_pick_sub_pack_is_the_largest_divisor_that_fits(k_pack, room_heads,
                                                        want):
    """The wrapper puts the most heads of a pack in shared memory at once
    that divide the pack and fit (R6's K = 8 at 4 in bf16), and none when
    not even one head fits, which it then refuses."""
    assert cuda_av._pick_sub_pack(_fake_smem_bytes(room_heads), 128, 32,
                                  128, k_pack, True, 1) == want


def test_harness_versions_are_the_repros_lists():
    """R5's harness times the repro's three builds beside the out-
    projection kernel's baseline and the unfused yardstick; R6's the
    repro's five (R5's pair first)."""
    assert list(rp5.VERSIONS) == [
        "plain", "pair_2pass_w8", "pair_1pass_w8", "pair_2pass_w16",
        "ws_2pass_pwout_w8", "ws_2pass_pwout_w16", "unfused"]
    assert list(rp6.VERSIONS)[1:6] == [
        "pair_2pass_w8", "quad_2pass_w8", "quad_1pass_w8", "quad_2pass_w16",
        "oct_2pass_w8"]


@pytest.mark.parametrize("bw,ms", [(2880, 0.208), (9000, 0.651)])
def test_headpack_bound(bw, ms):
    """71.57 MFLOP a window, at the bf16 peak: the function's, not the
    TPU's block-diagonal zero blocks."""
    bound, by = rp5.bound_ms(bw)
    assert by == "operations" and abs(bound - ms) < 0.001
