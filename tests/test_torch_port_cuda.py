"""The hand-written CUDA kernels against their plain PyTorch versions on the
GPU: the window-attention forward (with and without dropout), its backward
(K3, and K3-w, the weight gradients of its tensor-core path), the dropout
keep mask, the fused MBConv, the per-head attention of R1/R14
(and R9's route through it), the MaxViT layer megakernel of R7, the
kernels of R4 (head-major batched), R10 (stacked softmax), R11 (staged
core, and R11 whole) and R3 (cross-head indicator norm), the
out-projection kernel of R12, R13, R2 and R8, and the head-pack kernel of
R5 and R6, and the int8 conv's card route.  R4's and R3's wgmma designs
are asserted by route, R4's bit-identical to R1's wgmma kernel at 1 and 2
heads a staged x, R3's within 2.5e-3 of max|plain| of it with at most
``grouped_sections.R3_DIFFER_SHARE`` of the elements different (n 9-64, dh
16 and 32, 3 and 32 heads, a ragged Bw, diverging scores).  R10's and R5/R6's
strip designs are asserted by route (R10's at n 9, 56 and 64, ragged Bw and
diverging scores; R5/R6's bit-identical to the out-projection kernel's
strip design), with the kernels' route exports.  Skips without a CUDA
device.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances, relative to max|plain|: forward f32 1e-4 (sums in another
order), bf16 2e-2 (bf16 rounding at other points); backward, each gradient,
f32 1e-4 and bf16 6e-2 (``chip_smoke.BWD_TOLERANCE``), K3-w alone 1e-4
(f32 sums in another order) and bit-identical on a second launch; the fused
MBConv as the forward, as are R1/R14, R7, R4, R9, R10, R11, R3, the out-projection
kernel and the head-pack kernel (whose f32 cases take an f32 output), whose
second launches are bit-identical; the out-projection kernel's launches
also took the design its route names (the strip design in bf16 at
dim_head <= 32, the first in f32 and at dim_head 64), and its strip
design's output does not depend on the windows a CTA.
The fused MBConv's bf16 launches take its bands design (asserted by route, spb 1
and 4 and a second launch bit-identical, BN 384 and 300, 9 x 7 and the
model's layer-0 block; the prep's packed operands bit-equal to their plain
version), f32 its first design.  The keep mask is bit-equal, every launch
on its chunks design (ragged totals, n 1-64, seeds 1234 and 2**31 - 2), a
second launch bit-identical.  R11's core in bf16 runs its ring design at n
17-64, dim_head 16-64, Bw 1, 7 and 2,881, with head 0's scores ~200 below
and head 2's spread 25 times (2e-2 of max|plain|, second launch
bit-identical), f32 its first design.  Layers and inputs come from
``chip_smoke.attention_case`` and the repros under ``repros/`` (numpy
seeds).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import attention_case
from vit_grid_model_tpu_torch.ops import attention as tattn
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.dropout import keep_mask
from vit_grid_model_tpu_torch.ops.window import relative_position_indices

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


CASES = [
    (32, 32, 128, True, 0.0),       # the flagship layer
    (3, 16, 48, False, 0.0),        # odd head count, LN affine
    (2, 16, 32, True, -200.0),      # head 0 scores ~200 below head 1
    (3, 8, 40, True, 0.0),          # widths off the 16-multiples of wmma
]


# CASES at window 7 (53 tokens), and the flagship widths at window 5, whose
# 29 tokens leave another padding (rows 29..63 of the 64-row tile; two of
# its four 16-row strips wholly padding)
WINDOW_CASES = [case + (7,) for case in CASES] + [(4, 32, 128, True, 0.0, 5)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset,window",
                         WINDOW_CASES)
def test_kernel_matches_plain(dtype, heads, dim_head, dim, conditioned,
                              offset, window):
    """The forward kernel against the plain version; a second launch is
    bit-identical."""
    _need_cuda()
    m, x, cond = attention_case(heads, dim_head, dim, conditioned, 60,
                                offset, seed=0, window=window)
    dev = torch.device("cuda")
    m = m.to(dev, dtype)
    bias_idx = relative_position_indices(window, 4, device=dev)
    xt = torch.from_numpy(x).to(dev, dtype)
    ct = None if cond is None else torch.from_numpy(cond).to(dev, dtype)
    before = cuda_attn.launches
    with torch.inference_mode():
        ref = tattn.attention(m, xt, ct, bias_idx, windows_per_sample=30)
        ours = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                          windows_per_sample=30)
        again = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                           windows_per_sample=30)
    torch.cuda.synchronize()
    assert cuda_attn.launches == before + 2
    assert torch.equal(ours, again)
    assert ours.dtype == dtype and ours.shape == xt.shape
    ref, ours = ref.float(), ours.float()
    assert torch.isfinite(ours).all()
    err = (ours - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


def test_kernel_wide_bf16_within_plain_rounding():
    """K1 in bf16 off the strip path (``chip_smoke.WIDE_CASE``: dim 256,
    8 heads x 64, window 7, FiLM on) against the f32 plain version on the
    same bf16-rounded layer and inputs, within ``chip_smoke.WIDE_BOUND`` (2)
    x the plain bf16 version's own error against that f32 version; a
    second launch is bit-identical (both checked inside)."""
    _need_cuda()
    before = cuda_attn.launches
    err, plain_err, scale = chip_smoke.wide_bf16_vs_f32(torch.device("cuda"))
    assert cuda_attn.launches == before + 2
    assert 0 < plain_err < scale
    assert err <= chip_smoke.WIDE_BOUND * plain_err, (err, plain_err)


def test_kernel_rejects_shapes_out_of_range():
    _need_cuda()
    m, _, cond = attention_case(2, 16, 32, True, 30, 0.0, seed=0)
    m = m.cuda()
    too_long = torch.zeros(30, 65, 32, device="cuda")
    with pytest.raises(ValueError):
        cuda_attn.window_attention(
            m, too_long, torch.from_numpy(cond).cuda(),
            torch.zeros(65, 65, dtype=torch.long, device="cuda"),
            windows_per_sample=30)


@pytest.mark.parametrize("seed", [1234, 2 ** 31 - 2])
@pytest.mark.parametrize("heads", [4, 3])
def test_keep_mask_bit_equal(heads, seed):
    _need_cuda()
    before = cuda_attn.mask_launches
    ours = cuda_attn.dropout_keep_mask(seed, 60, heads, 53, 0.1,
                                       torch.device("cuda"))
    assert cuda_attn.mask_launches == before + 1
    assert torch.equal(ours, keep_mask(seed, 60, heads, 53, 0.1,
                                       device=torch.device("cuda")))
    assert torch.equal(ours.cpu(), keep_mask(seed, 60, heads, 53, 0.1))


# (Bw, heads, n) of the keep mask's chunks design: totals that are no
# multiple of 4 (3 x 3 x 53^2 = 25,281; 5 x 3 x 7^2; 7 x 2 x 3^2), n = 1,
# and full 64-token windows
MASK_CASES = [(3, 3, 53), (60, 4, 53), (5, 3, 7), (4, 3, 64), (1, 1, 1),
              (7, 2, 3)]


@pytest.mark.parametrize("seed", [1234, 2 ** 31 - 2])
@pytest.mark.parametrize("bw,heads,n", MASK_CASES)
def test_keep_mask_chunks_design_bit_equal(bw, heads, n, seed):
    _need_cuda()
    dev = torch.device("cuda")
    before = dict(cuda_attn.mask_route_launches)
    ours = cuda_attn.dropout_keep_mask(seed, bw, heads, n, 0.1, dev)
    again = cuda_attn.dropout_keep_mask(seed, bw, heads, n, 0.1, dev)
    torch.cuda.synchronize()
    took = {d: c - before.get(d, 0) for d, c in
            cuda_attn.mask_route_launches.items() if c > before.get(d, 0)}
    assert took == {"chunks": 2}
    assert torch.equal(ours, again)
    assert torch.equal(ours, keep_mask(seed, bw, heads, n, 0.1, device=dev))


def test_keep_mask_rejects_shapes_out_of_range():
    _need_cuda()
    for n in (0, 16385):
        with pytest.raises(ValueError):
            cuda_attn.dropout_keep_mask(1, 2, 2, n, 0.1,
                                        torch.device("cuda"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset,window",
                         WINDOW_CASES)
def test_kernel_with_dropout_matches_plain(dtype, heads, dim_head, dim,
                                           conditioned, offset, window):
    """The same with dropout, against the plain version given the keep
    mask; a second launch is bit-identical."""
    _need_cuda()
    dev = torch.device("cuda")
    m, xt, ct, _, _ = chip_smoke.kernel_case(heads, dim_head, dim,
                                             conditioned, 60, offset, dev,
                                             dtype, window)
    n = xt.shape[1]
    bias_idx = relative_position_indices(window, 4, device=dev)
    with torch.inference_mode():
        ref = tattn.attention(m, xt, ct, bias_idx, windows_per_sample=30,
                              dropout_mask=keep_mask(77, 60, heads, n, 0.25,
                                                     device=dev))
        ours = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                          windows_per_sample=30, seed=77,
                                          dropout_rate=0.25)
        again = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                           windows_per_sample=30, seed=77,
                                           dropout_rate=0.25)
    assert torch.equal(ours, again)
    ref, ours = ref.float(), ours.float()
    assert torch.isfinite(ours).all()
    err = (ours - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset,window",
                         WINDOW_CASES)
def test_backward_matches_plain(rate, dtype, heads, dim_head, dim,
                                conditioned, offset, window):
    """Every output of the backward kernel against autograd through the
    plain forward with the same mask; a second launch is bit-identical."""
    _need_cuda()
    _, xt, _, k, dy = chip_smoke.kernel_case(
        heads, dim_head, dim, conditioned, 60, offset, torch.device("cuda"),
        dtype, window)
    before = cuda_attn.bwd_launches
    errs = chip_smoke.bwd_errors(xt, k, dy, 2 ** 31 - 2, rate)
    assert cuda_attn.bwd_launches == before + 2
    tol = chip_smoke.BWD_TOLERANCE[str(dtype).split(".")[-1]]
    bad = {g: (e, s) for g, (e, s) in errs.items() if not e <= tol * s}
    assert not bad, bad


@pytest.mark.parametrize("rows,dim,heads,dim_head", [
    (60 * 53, 128, 4, 32),     # one row chunk, its last 32-row stage ragged
    (9000, 128, 32, 32),       # three chunks, the flagship's 24 + 8 tiles
    (60 * 29, 48, 3, 16),      # tiles past M and N (48 x 144, 48 x 48)
])
def test_wgrad_matches_plain(rows, dim, heads, dim_head):
    """K3-w, the weight gradients of K3's tensor-core path, against its
    plain version on random bf16 operands: f32 sums in another order (the
    bf16 products are exact in f32), 1e-4 of max|plain|; a second launch
    is bit-identical."""
    _need_cuda()
    rng = np.random.default_rng(rows)

    def operand(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to("cuda", torch.bfloat16)

    ops = cuda_attn.WgradOperands(operand(rows, dim),
                                  operand(rows, 3 * heads * dim_head),
                                  operand(rows, heads * dim_head))
    dy = operand(rows, dim)
    before = cuda_attn.wgrad_launches
    ours = cuda_attn.window_attention_wgrad(ops, dy, heads)
    again = cuda_attn.window_attention_wgrad(ops, dy, heads)
    ref = cuda_attn.window_attention_wgrad_reference(ops, dy, heads)
    torch.cuda.synchronize()
    assert cuda_attn.wgrad_launches == before + 2
    for a, a2, b in zip(ours, again, ref):
        assert a.shape == b.shape and a.dtype == torch.float32
        assert torch.equal(a, a2)
        err = (a - b).abs().max().item()
        assert err <= 1e-4 * b.abs().max().item(), err


@pytest.mark.parametrize("conditioned", [True, False])
def test_autograd_reaches_module_parameters(conditioned):
    """``window_attention`` on CUDA tensors (forward and backward kernels)
    gives the module's parameters, the condition and x the gradients that
    autograd through the plain version gives, in f32."""
    _need_cuda()
    dev = torch.device("cuda")
    m, x, cond = attention_case(3, 16, 48, conditioned, 60, 0.0, seed=1)
    m = m.to(dev).train()
    bias_idx = relative_position_indices(7, 4, device=dev)

    def grads(fn):
        m.zero_grad()
        xt = torch.from_numpy(x).to(dev).requires_grad_()
        ct = (None if cond is None
              else torch.from_numpy(cond).to(dev).requires_grad_())
        out = fn(xt, ct)
        (out.float() ** 2).sum().backward()
        got = {n: p.grad.clone() for n, p in m.named_parameters()
               if p.grad is not None}
        got["x"] = xt.grad
        if ct is not None:
            got["cond"] = ct.grad
        return got

    ref = grads(lambda xt, ct: tattn.attention(
        m, xt, ct, bias_idx, windows_per_sample=30,
        dropout_mask=keep_mask(5, 60, 3, 53, 0.1, device=dev)))
    before = (cuda_attn.launches, cuda_attn.bwd_launches)
    ours = grads(lambda xt, ct: cuda_attn.window_attention(
        m, xt, ct, bias_idx, windows_per_sample=30, seed=5,
        dropout_rate=0.1))
    torch.cuda.synchronize()
    assert (cuda_attn.launches, cuda_attn.bwd_launches) == (
        before[0] + 1, before[1] + 1)
    assert ours.keys() == ref.keys()
    for name, g in ref.items():
        err = (ours[name] - g).abs().max().item()
        assert err <= 1e-4 * g.abs().max().item(), (name, err)


def test_backward_rejects_width_out_of_range():
    _need_cuda()
    m, x, cond = attention_case(2, 16, 256, True, 30, 0.0, seed=0)
    m = m.cuda()
    xt = torch.from_numpy(x).cuda().requires_grad_()
    with pytest.raises(ValueError):
        cuda_attn.window_attention(
            m, xt, torch.from_numpy(cond).cuda(),
            relative_position_indices(7, 4, device=torch.device("cuda")),
            windows_per_sample=30)


# the fused MBConv (R15): (samples, H, W, C); C = 128 is the flagship block,
# C = 32 the small instantiation; 9 x 7 and 5 samples are odd in every
# tiled axis; rows of 56 pixels take bands of 6 rows in bf16
MBCONV_CASES = [(3, 42, 35, 128), (5, 9, 7, 32), (2, 3, 5, 32),
                (2, 9, 56, 128)]


@pytest.mark.parametrize("spb", [1, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c", MBCONV_CASES)
def test_fused_mbconv_matches_plain(n, h, w, c, dtype, spb):
    """The kernel against ``fused_mbconv_reference`` on the repro block's
    operands; a second launch is bit-identical."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    dev = torch.device("cuda")
    ops = tuple(t.to(dev) for t in mbconv_kernel_operands(repro.block(c)))
    x = repro.inputs(n, h, w, c, 1, dtype, dev)
    before = cuda_mbconv.launches
    err, scale = chip_smoke.mbconv_errors(x, ops, spb)
    assert cuda_mbconv.launches == before + 2
    assert err <= TOL[dtype] * scale, err


def test_fused_mbconv_rejects_other_widths():
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    dev = torch.device("cuda")
    ops = tuple(t.to(dev) for t in mbconv_kernel_operands(repro.block(16)))
    with pytest.raises(ValueError):
        cuda_mbconv.fused_mbconv(torch.zeros(1, 4, 4, 16, device=dev), ops)


# the fused MBConv's bands design (bf16): (samples, H, W, C, block, band
# rows); BN 384 and 300 are the repro's and the flagship evaluation's, 9 x
# 7 has a band of 7 rows and one of 2 in one m64 tile, "model" is the
# 12-hour model's own layer-0 MBConv, 9 x 56 bands of 6 rows and 3 in
# seven m64 tiles (more than the kernel's five warpgroups)
BANDS_CASES = [(384, 42, 35, 128, "repro", 7), (300, 42, 35, 128, "repro", 7),
               (5, 9, 7, 32, "repro", 7), (8, 42, 35, 128, "model", 7),
               (2, 9, 56, 128, "repro", 6)]


def _mbconv_block(c, source):
    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    if source == "model":
        return seeded_model(shipped_12hr_model_config(22.5, 15.5),
                            chip_smoke.SEED).vit.layers[0][0]
    return repro.block(c)


@pytest.mark.parametrize("n,h,w,c,source,rows", BANDS_CASES)
def test_fused_mbconv_bands_design_matches_plain(n, h, w, c, source, rows):
    """bf16 takes the bands design on bands of ``rows`` rows: within 2e-2
    of max|plain|, every launch counted on the "bands" route, a second
    launch and one at 4 samples a block bit-identical to the first."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    dev = torch.device("cuda")
    ops = tuple(t.to(dev) for t in mbconv_kernel_operands(
        _mbconv_block(c, source)))
    x = repro.inputs(n, h, w, c, 1, torch.bfloat16, dev)
    assert cuda_mbconv.route(n, h, w, c, 4 * c, c, x.dtype) == "bands"
    assert cuda_mbconv.rows(w, c, x.dtype) == rows
    before = dict(cuda_mbconv.launches_by_route)
    err, scale = chip_smoke.mbconv_errors(x, ops, 1)
    with torch.inference_mode():
        one = cuda_mbconv.fused_mbconv(x, ops, samples_per_block=1)
        four = cuda_mbconv.fused_mbconv(x, ops, samples_per_block=4)
    assert torch.equal(one, four)
    after = dict(cuda_mbconv.launches_by_route)
    assert after.get("bands", 0) == before.get("bands", 0) + 4
    assert after.get("first", 0) == before.get("first", 0)
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("n,h,w,c", [(3, 42, 35, 128), (5, 9, 7, 32)])
def test_fused_mbconv_f32_keeps_the_first_design(n, h, w, c):
    """f32 runs the first design (CUDA-core products), within 1e-4."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    dev = torch.device("cuda")
    ops = tuple(t.to(dev) for t in mbconv_kernel_operands(repro.block(c)))
    x = repro.inputs(n, h, w, c, 1, torch.float32, dev)
    assert cuda_mbconv.route(n, h, w, c, 4 * c, c, x.dtype) == "first"
    before = dict(cuda_mbconv.launches_by_route)
    err, scale = chip_smoke.mbconv_errors(x, ops, 4)
    after = dict(cuda_mbconv.launches_by_route)
    assert after.get("first", 0) == before.get("first", 0) + 2
    assert after.get("bands", 0) == before.get("bands", 0)
    assert err <= TOL[torch.float32] * scale, err


def test_fused_mbconv_routes_are_named_by_the_kernels_export():
    """The route export: bf16 the bands design at both widths (bands of 7
    rows up to rows of 49 pixels at C 128, fewer beyond, none past 149),
    f32 the first design, none at other widths; the prep kernel's packed
    operands bit-equal to ``packed_reference``."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    bf16, f32 = torch.bfloat16, torch.float32
    assert cuda_mbconv.route(384, 42, 35, 128, 512, 128, bf16) == "bands"
    assert cuda_mbconv.route(5, 9, 7, 32, 128, 32, bf16) == "bands"
    assert cuda_mbconv.route(1, 4, 49, 128, 512, 128, bf16) == "bands"
    assert cuda_mbconv.route(1, 4, 50, 128, 512, 128, bf16) == "bands"
    assert cuda_mbconv.route(1, 4, 149, 128, 512, 128, bf16) == "bands"
    assert cuda_mbconv.route(8, 42, 35, 128, 512, 128, f32) == "first"
    assert [cuda_mbconv.rows(w, 128, bf16) for w in (49, 50, 56, 149)] == [
        7, 6, 6, 1]
    for args in ((1, 4, 4, 16, 64, 16, bf16), (1, 4, 150, 128, 512, 128,
                                                bf16)):
        with pytest.raises(ValueError):
            cuda_mbconv.route(*args)
    dev = torch.device("cuda")
    for c in (128, 32):
        ops = tuple(t.to(dev) for t in mbconv_kernel_operands(
            repro.block(c)))
        assert torch.equal(cuda_mbconv.pack(ops),
                           cuda_mbconv.packed_reference(ops))


@pytest.mark.parametrize("wpc", [8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head", [
    (40, 56, 128, 32, 32),      # the repro's widths, whole tiles at 8
    (37, 56, 48, 3, 16),        # a ragged last tile, off the flagship widths
    (5, 9, 32, 2, 64)])         # fewer windows than a tile, dim_head 64
def test_perhead_attention_matches_plain(bw, n, dim, heads, dim_head, dtype,
                                         wpc):
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(bw, dtype, torch.device("cuda"), 0, n=n,
                                 dim=dim, heads=heads, dim_head=dim_head)
    before = av.perhead_launches[wpc]
    with torch.inference_mode():
        ref = perhead_qkv_attention(x, wqkv, bias, heads, dim_head)
        ours = av.perhead_attention(x, wqkv, bias, wpc)
        again = av.perhead_attention(x, wqkv, bias, wpc)
    torch.cuda.synchronize()
    assert av.perhead_launches[wpc] == before + 2
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "perhead")
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("wpc", [8, 16, 3])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset", [
    (37, 64, 128, 32, 32, 0.0),      # the whole 64-row tile
    (37, 49, 128, 32, 32, 0.0),      # a ragged last row group
    (37, 9, 48, 3, 16, 0.0),         # mostly padding, m64n48k16's qkv
    (40, 56, 128, 32, 32, -200.0),   # head 0's scores ~200 below head 1's
    (1, 56, 176, 2, 32, 0.0)])       # the widest dim at dim_head 32
def test_perhead_wgmma_design_matches_plain(bw, n, dim, heads, dim_head,
                                            offset, wpc):
    """The wgmma design (bf16) at every launch, against the plain version
    within 2e-2 of max|plain|; a second launch bit-identical."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    dtype = torch.bfloat16
    x, wqkv, bias = repro.inputs(bw, dtype, torch.device("cuda"), 0, n=n,
                                 dim=dim, heads=heads, dim_head=dim_head)
    bias[0] += offset
    assert av.perhead_route(n, dim, dim_head, dtype) == "wgmma"
    before = dict(av.perhead_route_launches)
    with torch.inference_mode():
        ref = perhead_qkv_attention(x, wqkv, bias, heads, dim_head)
        ours = av.perhead_attention(x, wqkv, bias, wpc)
        again = av.perhead_attention(x, wqkv, bias, wpc)
    torch.cuda.synchronize()
    chip_smoke.launched_design(av, before, "wgmma", 2, "perhead")
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "perhead")
    assert err <= TOL[dtype] * scale, err


def test_perhead_route_is_named_by_the_kernels_export():
    """``perhead_route`` (the kernel's own export) agrees with
    ``chip_smoke.perhead_design`` at and beyond the widths it documents."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av

    for n, dim, dh in ((56, 128, 32), (64, 176, 32), (64, 192, 32),
                       (64, 288, 16), (64, 304, 16), (9, 48, 16),
                       (56, 128, 64), (56, 40, 16), (1, 16, 16)):
        for dtype in (torch.bfloat16, torch.float32):
            want = chip_smoke.perhead_design(n, dim, dh,
                                             str(dtype).split(".")[-1])
            assert av.perhead_route(n, dim, dh, dtype) == want, (n, dim, dh)


def test_perhead_attention_rejects_shapes_out_of_range():
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(4, torch.float32, torch.device("cuda"), 0,
                                 n=9, dim=32, heads=2, dim_head=8)
    with pytest.raises(ValueError):
        av.perhead_attention(x, wqkv, bias, 8)
    with pytest.raises(ValueError):
        av.perhead_attention(x.to(torch.float16), wqkv, bias, 8)


# R7's cases: (dtype, head-0 bias offset, S, cluster).  S = 3 in both
# types, offset -200 putting head 0's scores ~200 below head 1's in both
# attentions; in bf16 (the strip design) S = 1, S = 37 (no multiple of the
# clusters the card holds at once) and each cluster size of the repro's
# sweep, and 1
LAYER_TEST_CASES = (
    [(dtype, offset, 3, None) for dtype in (torch.float32, torch.bfloat16)
     for offset in (0.0, -200.0)]
    + [(torch.bfloat16, 0.0, 1, None), (torch.bfloat16, 0.0, 37, None)]
    + [(torch.bfloat16, 0.0, 5, c) for c in (1, 2, 3, 5, 6)])


@pytest.mark.parametrize("dtype,offset,s,cluster", LAYER_TEST_CASES)
def test_maxvit_layer_attention_matches_plain(dtype, offset, s, cluster):
    """R7 against its plain version; a second launch is bit-identical."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        maxvit_layer_attention as plain_layer)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import megakernel as repro

    dev = torch.device("cuda")
    block_attn, grid_attn, regs = repro.layer(0)
    for m in (block_attn, grid_attn):
        with torch.no_grad():
            m.rel_pos_bias.weight[:, 0] += offset
    x, cond = repro.inputs(s, dtype, dev, 1)
    r, ob, og = repro.layer_operands(block_attn.to(dev), grid_attn.to(dev),
                                     regs.to(dev), cond, dtype)
    before = av.layer_launches
    with torch.inference_mode():
        ref = plain_layer(x, r, ob, og, repro.WIN)
        ours = av.maxvit_layer_attention(x, r, ob, og, repro.WIN,
                                         cluster=cluster)
        again = av.maxvit_layer_attention(x, r, ob, og, repro.WIN,
                                          cluster=cluster)
    torch.cuda.synchronize()
    assert av.layer_launches == before + 2
    assert ours.shape == x.shape and ours.dtype == dtype
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "layer")
    assert err <= TOL[dtype] * scale, err


def test_maxvit_layer_attention_rejects_clusters_it_does_not_take():
    """A cluster size that does not divide the 30 windows, one above 8, and
    any cluster size off the strip design (f32) raise before a launch."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import megakernel as repro

    dev = torch.device("cuda")
    block_attn, grid_attn, regs = (t.to(dev) for t in repro.layer(0))
    for dtype, cluster in ((torch.bfloat16, 4), (torch.bfloat16, 10),
                           (torch.float32, 5)):
        x, cond = repro.inputs(1, dtype, dev, 1)
        r, ob, og = repro.layer_operands(block_attn, grid_attn, regs, cond,
                                         dtype)
        before = av.layer_launches
        with pytest.raises(ValueError):
            av.maxvit_layer_attention(x, r, ob, og, repro.WIN,
                                      cluster=cluster)
        assert av.layer_launches == before


@pytest.mark.parametrize("bw,rate", [(9000, 0.0), (1440, 0.1)])
def test_kernel_strip_path_matches_plain_at_main_path_windows(bw, rate):
    """K1's strip path (bf16, the flagship layer: dim 128, 32 heads x 32,
    window 7, FiLM on) at the evaluation's Bw 9,000 and the training's Bw
    1,440 with dropout, against the plain version given the same keep
    mask; a second launch is bit-identical."""
    _need_cuda()
    dev = torch.device("cuda")
    m, xt, ct, _, _ = chip_smoke.kernel_case(32, 32, 128, True, bw, 0.0, dev,
                                             torch.bfloat16, 7)
    bias_idx = relative_position_indices(7, 4, device=dev)
    mask = (keep_mask(77, bw, 32, 53, rate, device=dev) if rate else None)
    before = cuda_attn.launches
    with torch.inference_mode():
        ref = tattn.attention(m, xt, ct, bias_idx, windows_per_sample=30,
                              dropout_mask=mask)
        ours = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                          windows_per_sample=30, seed=77,
                                          dropout_rate=rate)
        again = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                           windows_per_sample=30, seed=77,
                                           dropout_rate=rate)
    torch.cuda.synchronize()
    assert cuda_attn.launches == before + 2
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "K1")
    assert err <= TOL[torch.bfloat16] * scale, err


def test_maxvit_layer_attention_rejects_maps_the_windows_do_not_tile():
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import megakernel as repro

    dev = torch.device("cuda")
    block_attn, grid_attn, regs = (t.to(dev) for t in repro.layer(0))
    x, cond = repro.inputs(1, torch.float32, dev, 1)
    r, ob, og = repro.layer_operands(block_attn, grid_attn, regs, cond,
                                     torch.float32)
    with pytest.raises(ValueError):
        av.maxvit_layer_attention(x[:, :40].contiguous(), r, ob, og,
                                  repro.WIN)


VARIANT_ROUTES = ["headmajor_attention", "stacked_softmax_attention",
                  "perhead_weight_attention", "staged_attention_core",
                  "staged_attention"]


@pytest.mark.parametrize("route", VARIANT_ROUTES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset", [
    (40, 56, 128, 32, 32, 0.0),     # the repro's widths
    (37, 56, 48, 3, 16, 0.0),       # a ragged last tile and head group
    (5, 9, 32, 2, 64, 0.0),         # fewer windows than a tile, dim_head 64
    (16, 56, 128, 32, 32, -200.0)])  # head 0 scores ~200 below head 1
def test_variant_matches_plain(bw, n, dim, heads, dim_head, offset, dtype,
                               route):
    """R4, R10, R9's route, R11's core and R11 whole against their plain
    versions (the routes of ``chip_smoke.variant_routes``)."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(bw, dtype, torch.device("cuda"), 0, n=n,
                                 dim=dim, heads=heads, dim_head=dim_head)
    bias[0] += offset
    with torch.inference_mode():
        kernel, plain = chip_smoke.variant_routes(x, wqkv, bias, heads,
                                                  dim_head)[route]
        ref = plain()
        av.reset_launches()
        ours = kernel()
        again = kernel()
    torch.cuda.synchronize()
    counts = {"headmajor_attention": av.headmajor_launches,
              "stacked_softmax_attention": av.stacked_launches,
              "perhead_weight_attention": av.perhead_weight_launches,
              "staged_attention_core": av.staged_core_launches,
              "staged_attention": av.staged_core_launches}
    assert counts[route] == 2
    err, scale = chip_smoke.kernel_errors(ours, again, ref, route)
    assert err <= TOL[dtype] * scale, err


def _staged_operands(bw, n, dim_head, dtype, seed, heads=3):
    """R11's staged operands from a numpy seed: l2-normalized qn, kn and v
    (heads, bw, n, dim_head) in ``dtype``, bias (heads, n, n) f32 with head
    0's scores ~200 below the others and the last head's spread 25 times."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((heads, bw, n, dim_head))
               for _ in range(3))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    bias = rng.standard_normal((heads, n, n))
    bias[0] -= 200.0
    bias[-1] *= 25.0
    dev = torch.device("cuda")
    return (*(torch.from_numpy(a.astype(np.float32)).to(dev, dtype)
              for a in (q, k, v)),
            torch.from_numpy(bias.astype(np.float32)).to(dev))


def _staged_launch(qn, kn, v, bias, want):
    """R11's core twice; asserts both launches took the design ``want``
    and gave the same bits.  Returns (output, plain output)."""
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        staged_headmajor_core)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av

    before = dict(av.staged_core_route_launches)
    with torch.inference_mode():
        ref = staged_headmajor_core(qn, kn, v, bias)
        ours = av.staged_attention_core(qn, kn, v, bias)
        again = av.staged_attention_core(qn, kn, v, bias)
    torch.cuda.synchronize()
    took = {d: c - before.get(d, 0) for d, c in
            av.staged_core_route_launches.items() if c > before.get(d, 0)}
    assert took == {want: 2}
    assert torch.equal(ours, again)
    return ours, ref


@pytest.mark.parametrize("bw", [1, 7, 2881])
@pytest.mark.parametrize("dim_head", [16, 32, 48, 64])
@pytest.mark.parametrize("n", [17, 49, 53, 56, 64])
def test_staged_core_ring_design_matches_plain(n, dim_head, bw):
    """R11's core in bf16 on its ring design at every width the entry
    takes, a window or a few and more pairs than the grid has CTAs."""
    _need_cuda()
    ours, ref = _staged_launch(
        *_staged_operands(bw, n, dim_head, torch.bfloat16, n + dim_head),
        "ring")
    assert bool(torch.isfinite(ours.float()).all())
    scale = ref.float().abs().max().item()
    err = (ours.float() - ref.float()).abs().max().item()
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("bw,n,dim_head", [(7, 56, 32), (5, 17, 64)])
def test_staged_core_f32_keeps_the_first_design(bw, n, dim_head):
    _need_cuda()
    ours, ref = _staged_launch(
        *_staged_operands(bw, n, dim_head, torch.float32, 5), "first")
    scale = ref.abs().max().item()
    assert (ours - ref).abs().max().item() <= TOL[torch.float32] * scale


def test_staged_core_route_and_plan_are_the_kernels():
    """The route the wrapper counts is the kernel's export; the ring's
    shared memory is ``chip_smoke.staged_ring_bytes`` at every dim_head,
    one CTA or more an SM."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av

    for dh in (16, 32, 48, 64):
        assert av.staged_core_route(56, dh, torch.bfloat16) == "ring"
        assert av.staged_core_route(56, dh, torch.float32) == "first"
        regs, local, smem, per_sm, stages = av.staged_core_occupancy(dh)
        assert smem == chip_smoke.staged_ring_bytes(dh, stages)
        assert per_sm >= 1 and local == 0


@pytest.mark.parametrize("heads_per_group", [1, 2, 3])
def test_headmajor_attention_at_every_group(heads_per_group):
    """R4's kernel at groups that do and do not divide 3 heads."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(11, torch.bfloat16, torch.device("cuda"), 2,
                                 n=56, dim=48, heads=3, dim_head=16)
    with torch.inference_mode():
        ref = perhead_qkv_attention(x, wqkv, bias, 3, 16)
        ours = av.headmajor_attention(x, wqkv, bias, heads_per_group)
        again = av.headmajor_attention(x, wqkv, bias, heads_per_group)
    torch.cuda.synchronize()
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "headmajor")
    assert err <= TOL[torch.bfloat16] * scale, err


def test_variants_reject_shapes_out_of_range():
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        stage_headmajor)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    dev = torch.device("cuda")
    x, wqkv, bias = repro.inputs(4, torch.float32, dev, 0, n=9, dim=32,
                                 heads=2, dim_head=8)
    for call in (lambda: av.headmajor_attention(x, wqkv, bias),
                 lambda: av.stacked_softmax_attention(x, wqkv, bias),
                 lambda: av.perhead_weight_attention(x, weight4(wqkv, 2),
                                                     bias),
                 lambda: av.headmajor_attention(x.half(), wqkv, bias),
                 lambda: av.headmajor_attention(x, wqkv, bias, 3)):
        with pytest.raises(ValueError):
            call()
    x, wqkv, bias = repro.inputs(4, torch.float32, dev, 0, n=72, dim=32,
                                 heads=2, dim_head=16)
    qn, kn, v = stage_headmajor(x @ wqkv, 2, 16, torch.float32)
    for call in (lambda: av.staged_attention_core(qn, kn, v, bias),
                 lambda: av.staged_attention_core(qn, kn.half(), v, bias),
                 lambda: av.headmajor_attention(x, wqkv, bias)):
        with pytest.raises(ValueError):
            call()


# (Bw, n, dim, heads, dim_head, head-0 bias offset) of R3's and the
# out-projection kernel's cases
GROUP_CASES = [
    (40, 56, 128, 32, 32, 0.0),     # the repro's widths
    (37, 56, 48, 3, 16, 0.0),       # a ragged last tile and head group
    (5, 9, 32, 2, 64, 0.0),         # fewer windows than a tile, dim_head 64
    (16, 56, 128, 32, 32, -200.0)]  # head 0 scores ~200 below head 1


@pytest.mark.parametrize("heads_per_group", [None, 2])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset", GROUP_CASES)
def test_crosshead_norm_attention_matches_plain(bw, n, dim, heads, dim_head,
                                                offset, dtype,
                                                heads_per_group):
    """R3's kernel against R1's plain version, at its default group and at
    2 heads a group."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(bw, dtype, torch.device("cuda"), 0, n=n,
                                 dim=dim, heads=heads, dim_head=dim_head)
    bias[0] += offset
    before = av.crosshead_launches
    with torch.inference_mode():
        ref = perhead_qkv_attention(x, wqkv, bias, heads, dim_head)
        ours = av.crosshead_norm_attention(x, wqkv, bias, heads_per_group)
        again = av.crosshead_norm_attention(x, wqkv, bias, heads_per_group)
    torch.cuda.synchronize()
    assert av.crosshead_launches == before + 2
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "crosshead")
    assert err <= TOL[dtype] * scale, err


# R4's and R3's wgmma design: (Bw, n, dim, heads, dim_head, head-0 bias
# offset); Bw 37 leaves a ragged last tile, 3 heads a ragged last group of
# G 2, n 64, 49 and 9 fill the 64-row tile wholly, ragged and mostly with
# padding
GROUPED_WGMMA_CASES = [
    (37, 56, 128, 32, 32, 0.0),      # the repros' widths
    (37, 64, 128, 32, 32, 0.0),
    (37, 49, 128, 32, 32, 0.0),
    (37, 9, 128, 32, 32, 0.0),
    (37, 56, 128, 3, 32, 0.0),       # 3 heads at dh 32
    (37, 9, 48, 3, 16, 0.0),         # dh 16, m64n48k16's qkv
    (11, 64, 48, 3, 16, 0.0),
    (40, 56, 128, 32, 32, -200.0)]   # head 0's scores ~200 below head 1's


def _grouped_case(bw, n, dim, heads, dim_head, offset):
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(bw, torch.bfloat16, torch.device("cuda"), 0,
                                 n=n, dim=dim, heads=heads,
                                 dim_head=dim_head)
    bias[0] += offset
    with torch.inference_mode():
        ref = perhead_qkv_attention(x, wqkv, bias, heads, dim_head)
        r1 = av.perhead_attention(x, wqkv, bias, 8)
    return x, wqkv, bias, ref, r1


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset",
                         GROUPED_WGMMA_CASES)
def test_headmajor_wgmma_design_is_perhead_wgmma_design(
        bw, n, dim, heads, dim_head, offset, group):
    """R4's wgmma design at 1 and 2 heads a staged x is bit-identical to
    the per-head kernel's wgmma design (R1's launch); a second launch too,
    and both launches take the wgmma design."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av

    x, wqkv, bias, ref, r1 = _grouped_case(bw, n, dim, heads, dim_head,
                                           offset)
    assert av.headmajor_route(n, dim, dim_head, torch.bfloat16,
                              group) == "wgmma"
    before = dict(av.headmajor_route_launches)
    with torch.inference_mode():
        ours = av.headmajor_attention(x, wqkv, bias, group)
        again = av.headmajor_attention(x, wqkv, bias, group)
    torch.cuda.synchronize()
    chip_smoke.launched_design(av, before, "wgmma", 2, "headmajor",
                               av.headmajor_route_launches)
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "headmajor")
    assert err <= TOL[torch.bfloat16] * scale, err
    assert torch.equal(ours, r1)


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset",
                         GROUPED_WGMMA_CASES)
def test_crosshead_wgmma_design_matches_plain(bw, n, dim, heads, dim_head,
                                              offset, group):
    """R3's wgmma design (the indicator norm on the tensor cores) within
    2e-2 of max|plain|, as R1's, and within ``against_r1``'s bounds of R1's
    kernel's output, from which only the norm's sums differ: 2.5e-3 of
    max|plain| and ``R3_DIFFER_SHARE`` of the elements different, which
    squares rounded once to bf16 exceed; a second launch bit-identical,
    both on the wgmma design."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import grouped_sections as tool

    x, wqkv, bias, ref, r1 = _grouped_case(bw, n, dim, heads, dim_head,
                                           offset)
    assert av.crosshead_route(n, dim, dim_head, torch.bfloat16,
                              group) == "wgmma"
    before = dict(av.crosshead_route_launches)
    with torch.inference_mode():
        ours = av.crosshead_norm_attention(x, wqkv, bias, group)
        again = av.crosshead_norm_attention(x, wqkv, bias, group)
    torch.cuda.synchronize()
    chip_smoke.launched_design(av, before, "wgmma", 2, "crosshead",
                               av.crosshead_route_launches)
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "crosshead")
    assert err <= TOL[torch.bfloat16] * scale, err
    gap, share, steps = tool.against_r1(ours, r1, scale)
    print(f"R3 against R1's kernel: {gap:.3e} of max|plain|, {share:.3e} of "
          f"the elements differ, the largest by {steps:.1f} bf16 steps")
    assert gap <= tool.R3_GAP and share <= tool.R3_DIFFER_SHARE, (
        gap, share, steps)


def test_grouped_routes_are_named_by_the_kernels_exports():
    """``headmajor_route`` and ``crosshead_route`` (the kernels' own
    exports) agree with ``chip_smoke.grouped_design`` at and beyond the
    widths they document; the wgmma design's occupancy exports report it at
    one CTA an SM, no local memory, within 168 registers."""
    _need_cuda()
    import ctypes

    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.ops.cuda import library

    for n, dim, dh in ((56, 128, 32), (64, 128, 32), (64, 144, 32),
                       (9, 176, 32), (64, 224, 16), (64, 240, 16),
                       (9, 48, 16), (56, 128, 64), (56, 40, 16),
                       (65, 128, 32)):
        for dtype in (torch.bfloat16, torch.float32):
            name = str(dtype).split(".")[-1]
            for group in (1, 2, 3):
                assert av.headmajor_route(n, dim, dh, dtype, group) == \
                    chip_smoke.grouped_design(n, dim, dh, name, group), (
                        n, dim, dh, group)
                assert av.crosshead_route(n, dim, dh, dtype, group) == \
                    chip_smoke.grouped_design(n, dim, dh, name, group,
                                              True), (n, dim, dh, group)
    lib = library.load()
    out = (ctypes.c_int * 4)()
    for fn, smem in ((lib.vgm_headmajor_attention_occupancy, 220544),
                     (lib.vgm_crosshead_norm_attention_occupancy, 221568)):
        for group in (1, 2):
            assert fn(56, 128, 32, group, 1, out) == 1
            assert out[0] <= 168 and out[1] == 0
            assert out[2] == smem and out[3] == 1
        assert fn(56, 128, 32, 2, 0, out) == 0


# the out-projection kernel's structures: name -> (R9's weight, two_pass,
# perhead_wout, bf16_score, bf16_agg)
OUTPROJ_ROUTES = {
    "baseline": (False, True, False, False, False),
    "ws_1pass": (True, False, False, False, False),
    "ws_2pass": (True, True, False, False, False),
    "ws_1pass_pwout": (True, False, True, False, False),
    "ws_2pass_pwout": (True, True, True, False, False),
    "bf16_score": (True, True, True, True, False),
    "bf16_agg": (True, True, True, False, True),
    "bf16_both": (True, True, True, True, True)}


def _outproj_design(dtype, dim_head):
    """The design the out-projection kernel takes at these tests' widths
    (dim and out_dim <= 128, multiples of 16): K1's strip design in bf16 at
    dim_head <= 32, the first design in f32 and at dim_head 64."""
    return ("strip" if dtype == torch.bfloat16 and dim_head <= 32
            else "first")


def _outproj_case(bw, n, dim, heads, dim_head, offset, dtype, route,
                  windows_per_cta=8):
    """The out-projection kernel (two launches) against its plain version
    with the route's casts; the output in x's dtype.  Both launches took
    the design ``_outproj_design`` names, as the wrapper counts it."""
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        outproj_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    x, wqkv, bias, wout = ws.inputs(bw, dtype, torch.device("cuda"), 0, n=n,
                                    dim=dim, heads=heads, dim_head=dim_head,
                                    out_dim=dim)
    bias[0] += offset
    r9, two_pass, perhead, score, agg = OUTPROJ_ROUTES[route]
    w = weight4(wqkv, heads) if r9 else wqkv
    key = (two_pass, perhead, score, agg, windows_per_cta)
    before = av.outproj_launches[key]
    design = _outproj_design(dtype, dim_head)
    by_design = av.outproj_route_launches[design]
    with torch.inference_mode():
        ref = outproj_attention(x, wqkv, bias, wout, heads, dim_head,
                                bf16_score=score, bf16_agg=agg,
                                out_dtype=dtype)
        ours, again = (av.outproj_attention(
            x, w, bias, wout, two_pass=two_pass, perhead_wout=perhead,
            bf16_score=score, bf16_agg=agg, windows_per_cta=windows_per_cta,
            out_dtype=dtype) for _ in range(2))
    torch.cuda.synchronize()
    assert av.outproj_launches[key] == before + 2
    assert av.outproj_route_launches[design] == by_design + 2, design
    assert av.outproj_route(n, dim, dim_head, dim, dtype) == design
    assert ours.dtype == dtype and tuple(ours.shape) == (bw, n, dim)
    err, scale = chip_smoke.kernel_errors(ours, again, ref, route)
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("route", list(OUTPROJ_ROUTES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset",
                         GROUP_CASES + [(16, 64, 128, 32, 32, 0.0)])
def test_outproj_attention_matches_plain(bw, n, dim, heads, dim_head, offset,
                                         dtype, route):
    """R12, R13's variants and R2's casts against the plain version, n 64
    (R8's n_pad) among the cases; bf16 on the strip design (dim_head 64
    and f32 on the first)."""
    _need_cuda()
    _outproj_case(bw, n, dim, heads, dim_head, offset, dtype, route)


@pytest.mark.parametrize("n", [56, 64])
@pytest.mark.parametrize("windows_per_cta", [8, 16, 32])
def test_outproj_attention_at_r8_windows_per_cta(windows_per_cta, n):
    """R8's kfold 1, 2, 4 as 8, 16, 32 windows a CTA; Bw 37 leaves a
    ragged last CTA at each (the strip design)."""
    _need_cuda()
    _outproj_case(37, n, 128, 32, 32, 0.0, torch.bfloat16, "ws_2pass_pwout",
                  windows_per_cta)


@pytest.mark.parametrize("cast", ["ws_2pass_pwout", "bf16_score",
                                  "bf16_agg", "bf16_both"])
def test_outproj_strip_output_does_not_depend_on_windows_per_cta(cast):
    """The strip design runs each window alone through the body, so at Bw
    37 (a ragged last CTA at each setting) its output at 1, 2, 4, 8, 16 and
    32 windows a CTA is bit-identical, and each setting's second launch
    too."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    x, wqkv, bias, wout = ws.inputs(37, torch.bfloat16, torch.device("cuda"),
                                    1)
    _, two_pass, perhead, score, agg = OUTPROJ_ROUTES[cast]
    w4 = weight4(wqkv, 32)

    def call(wpc):
        return av.outproj_attention(x, w4, bias, wout, two_pass=two_pass,
                                    perhead_wout=perhead, bf16_score=score,
                                    bf16_agg=agg, windows_per_cta=wpc)

    before = av.outproj_route_launches["strip"]
    with torch.inference_mode():
        first = call(1)
        for wpc in (1, 2, 4, 8, 16, 32):
            assert torch.equal(call(wpc), first), wpc
            assert torch.equal(call(wpc), first), wpc
    torch.cuda.synchronize()
    assert av.outproj_route_launches["strip"] == before + 13
    assert bool(torch.isfinite(first.float()).all())


def test_crosshead_and_outproj_reject_shapes_out_of_range():
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

    dev = torch.device("cuda")

    def outproj(x, wqkv, bias, wout, **kw):
        return av.outproj_attention(x, wqkv, bias, wout, two_pass=True,
                                    perhead_wout=True, **kw)

    x, wqkv, bias, wout = ws.inputs(4, torch.float32, dev, 0, n=9, dim=32,
                                    heads=2, dim_head=16, out_dim=32)
    for call in (lambda: av.crosshead_norm_attention(x.half(), wqkv, bias),
                 lambda: av.crosshead_norm_attention(x, wqkv, bias, 3),
                 lambda: av.crosshead_norm_attention(x, wqkv, bias, 9),
                 lambda: outproj(x.half(), wqkv, bias, wout),
                 lambda: outproj(x, wqkv, bias, wout[..., :24].contiguous()),
                 lambda: outproj(x, wqkv, bias, wout,
                                 out_dtype=torch.float16),
                 lambda: outproj(x, wqkv, bias, wout, windows_per_cta=0)):
        with pytest.raises(ValueError):
            call()
    for n, dh in ((72, 16), (9, 8)):
        x, wqkv, bias, wout = ws.inputs(4, torch.float32, dev, 0, n=n,
                                        dim=32, heads=2, dim_head=dh,
                                        out_dim=32)
        for call in (lambda: av.crosshead_norm_attention(x, wqkv, bias),
                     lambda: outproj(x, wqkv, bias, wout)):
            with pytest.raises(ValueError):
                call()


# (Bw, n, dim, heads, dim_head, odd heads' bias offset) of R5's and R6's
# kernel cases
HEADPACK_CASES = [
    (40, 56, 128, 32, 32, 0.0),     # the repros' widths
    (5, 9, 32, 8, 64, 0.0),         # fewer windows than a tile, dim_head 64
    (16, 56, 128, 32, 32, -200.0)]  # odd heads' scores ~200 below even's


def _headpack_case(bw, n, dim, heads, dim_head, offset, dtype, k_pack,
                   two_pass, windows_per_cta=8, r9_weight=False):
    """R5/R6's kernel (two launches) against the plain version; the output
    in x's dtype."""
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        outproj_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    x, wqkv, bias, wout = ws.inputs(bw, dtype, torch.device("cuda"), 0, n=n,
                                    dim=dim, heads=heads, dim_head=dim_head,
                                    out_dim=dim)
    bias[1::2] += offset
    w = weight4(wqkv, heads) if r9_weight else wqkv
    key = (k_pack, two_pass, windows_per_cta)
    before = av.headpack_launches[key]
    with torch.inference_mode():
        ref = outproj_attention(x, wqkv, bias, wout, heads, dim_head,
                                out_dtype=dtype)
        ours, again = (av.headpack_attention(
            x, w, bias, wout, k_pack=k_pack, two_pass=two_pass,
            windows_per_cta=windows_per_cta, out_dtype=dtype)
            for _ in range(2))
    torch.cuda.synchronize()
    assert av.headpack_launches[key] == before + 2
    assert ours.dtype == dtype and tuple(ours.shape) == (bw, n, dim)
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "headpack")
    assert err <= TOL[dtype] * scale, err


@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("k_pack", [2, 4, 8])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("bw,n,dim,heads,dim_head,offset", HEADPACK_CASES)
def test_headpack_attention_matches_plain(bw, n, dim, heads, dim_head,
                                          offset, dtype, k_pack, two_pass):
    """K = 2 (R5), 4 and 8 (R6) in one pass and two, against the plain
    version, a per-head row max on the diverging case."""
    _need_cuda()
    _headpack_case(bw, n, dim, heads, dim_head, offset, dtype, k_pack,
                   two_pass)


@pytest.mark.parametrize("windows_per_cta", [8, 16])
@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_headpack_attention_odd_number_of_packs(dtype, two_pass,
                                                windows_per_cta):
    """6 heads in 3 packs of 2, from R9's weight; Bw 37 leaves a ragged last
    CTA at 8 and at 16 windows a CTA."""
    _need_cuda()
    _headpack_case(37, 56, 48, 6, 16, 0.0, dtype, 2, two_pass,
                   windows_per_cta, r9_weight=True)


def test_headpack_attention_rejects_what_it_cannot_run():
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

    x, wqkv, bias, wout = ws.inputs(4, torch.bfloat16, torch.device("cuda"),
                                    0)

    def headpack(x, wout, k_pack=4, **kw):
        return av.headpack_attention(x, wqkv, bias, wout, k_pack=k_pack,
                                     two_pass=True, **kw)

    for call in (lambda: headpack(x, wout, 3),
                 lambda: headpack(x, wout, 16),
                 lambda: headpack(x.half(), wout),
                 lambda: headpack(x, wout[..., :24].contiguous()),
                 lambda: headpack(x, wout.float()),
                 lambda: headpack(x, wout.cpu()),
                 lambda: headpack(x, wout, windows_per_cta=0)):
        with pytest.raises(ValueError):
            call()


# R10's strip design: (Bw, n, head-0 bias offset); Bw 37 leaves a ragged
# last CTA of 8 windows, n 9 three of the tile's four 16-row strips wholly
# padding, and -200 puts head 0's scores ~200 below head 1's
STACKED_STRIP_CASES = [
    (37, 56, 0.0), (37, 64, 0.0), (37, 9, 0.0), (37, 56, -200.0),
    (37, 9, -200.0), (2880, 56, 0.0), (2880, 64, -200.0), (2880, 9, 0.0)]


@pytest.mark.parametrize("bw,n,offset", STACKED_STRIP_CASES)
def test_stacked_softmax_strip_route_matches_plain(bw, n, offset):
    """R10 in bf16 at the repro's widths takes the strip design (K1's strip
    body without the out-projection), within 2e-2 of the plain version,
    its second launch bit-identical."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    x, wqkv, bias = repro.inputs(bw, torch.bfloat16, torch.device("cuda"), 3,
                                 n=n)
    bias[0] += offset
    assert av.stacked_route(n, 128, 32, torch.bfloat16) == "strip"
    before = av.stacked_route_launches["strip"]
    with torch.inference_mode():
        ref = perhead_qkv_attention(x, wqkv, bias, 32, 32)
        ours = av.stacked_softmax_attention(x, wqkv, bias)
        again = av.stacked_softmax_attention(x, wqkv, bias)
    torch.cuda.synchronize()
    assert av.stacked_route_launches["strip"] == before + 2
    assert ours.dtype == torch.bfloat16 and ours.shape == ref.shape
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "stacked")
    assert err <= TOL[torch.bfloat16] * scale, err


@pytest.mark.parametrize("windows_per_cta", [8, 16])
@pytest.mark.parametrize("two_pass", [True, False])
@pytest.mark.parametrize("k_pack", [2, 4, 8])
def test_headpack_strip_route_is_outproj_strip_route(k_pack, two_pass,
                                                     windows_per_cta):
    """R5/R6 in bf16 at the repros' widths take the out-projection
    kernel's strip kernel: the output is bit-identical to
    ``outproj_attention``'s at the same windows a CTA, whatever the pack
    and passes, with every odd head's scores ~200 below (Bw 37: a ragged
    last CTA)."""
    _need_cuda()
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    x, wqkv, bias, wout = ws.inputs(37, torch.bfloat16, torch.device("cuda"),
                                    5)
    bias[1::2] -= 200.0
    assert av.headpack_route(56, 128, 32, 128, torch.bfloat16) == "strip"
    before = av.headpack_route_launches["strip"]
    with torch.inference_mode():
        ours = av.headpack_attention(x, wqkv, bias, wout, k_pack=k_pack,
                                     two_pass=two_pass,
                                     windows_per_cta=windows_per_cta)
        family = av.outproj_attention(x, weight4(wqkv, 32), bias, wout,
                                      two_pass=True, perhead_wout=True,
                                      windows_per_cta=windows_per_cta)
    torch.cuda.synchronize()
    assert av.headpack_route_launches["strip"] == before + 1
    assert bool(torch.isfinite(ours.float()).all())
    assert torch.equal(ours, family)


def test_routes_are_named_by_the_kernels_exports():
    """``headpack_route`` and ``stacked_route`` ask the kernels' own route
    exports: the strip design in bf16 at K1's strip widths (n <= 64, dim
    and dim_head multiples of 16, dim <= 128, dim_head <= 32, out_dim <=
    128), the first design elsewhere; the head-pack kernel's route is the
    out-projection kernel's; each strip design's occupancy export reports
    it, at two CTAs an SM or more."""
    _need_cuda()
    import ctypes

    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.ops.cuda import library

    bf, f32 = torch.bfloat16, torch.float32
    for n, dim, dh, dtype, want in (
            (56, 128, 32, bf, "strip"), (9, 48, 16, bf, "strip"),
            (64, 128, 32, bf, "strip"), (56, 128, 32, f32, "first"),
            (56, 128, 64, bf, "first"), (56, 256, 32, bf, "first"),
            (56, 40, 16, bf, "first"), (65, 128, 32, bf, "first")):
        assert av.stacked_route(n, dim, dh, dtype) == want
        assert av.headpack_route(n, dim, dh, dim, dtype) == want
        assert av.outproj_route(n, dim, dh, dim, dtype) == want
    assert av.headpack_route(56, 128, 32, 256, bf) == "first"
    lib = library.load()
    out = (ctypes.c_int * 4)()
    assert lib.vgm_headpack_attention_occupancy(56, 128, 32, 128, 2, 0, 1, 1,
                                                out) == 1
    assert out[0] <= 128 and out[3] >= 2
    assert lib.vgm_stacked_softmax_attention_occupancy(56, 128, 32, 0, 1,
                                                       out) == 1
    assert out[2] == 75776 and out[3] >= 2
    assert lib.vgm_stacked_softmax_attention_occupancy(56, 128, 32, 2, 0,
                                                       out) == 0


@pytest.mark.parametrize("n,c,h,w,o", [
    (300, 128, 84, 70, 128), (3, 5, 6, 5, 3), (1, 16, 2, 3, 8)])
def test_int8_conv_matches_plain(n, c, h, w, o):
    """The int8 conv's card route (im2col + ``torch._int_mm``) against the
    plain float64 conv: the int32 accumulator and the dequantized output
    bit-equal; one count a conv."""
    from vit_grid_model_tpu_torch.ops import quantize as Q

    _need_cuda()
    g = torch.Generator(device="cuda").manual_seed(n + c)
    x = torch.randn(n, c, h, w, device="cuda", generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    weight = torch.randn(o, c, 3, 3, device="cuda", generator=g)
    q = Q.quantize_conv(weight, torch.randn(o, device="cuda", generator=g),
                        0.8 * x.abs().max().item())
    xq = Q.quantize_input(x, q.sx)
    before = Q.launches
    acc = Q.int8_conv_accumulate(xq, q.wq)
    assert Q.launches == before + 1
    plain = Q.int8_conv_accumulate_plain(xq, q.wq)
    assert acc.dtype == torch.int32 and torch.equal(acc, plain)
    assert torch.equal(Q.conv2d_int8(q, x), Q.dequantize(plain, q, x.dtype))


def test_k1_route_is_named_by_the_kernels_export():
    """``fwd_route`` asks K1's own route export: the strip path in bf16 at
    dim and dim_head multiples of 16, dim <= 128, dim_head <= 32, the first
    design elsewhere; each launch counts under the design it took."""
    _need_cuda()
    bf, f32 = torch.bfloat16, torch.float32
    for dim, dh, dtype, want in (
            (128, 32, bf, "strip"), (48, 16, bf, "strip"),
            (128, 32, f32, "first"), (128, 64, bf, "first"),
            (256, 32, bf, "first"), (40, 8, bf, "first")):
        assert cuda_attn.fwd_route(dim, dh, dtype) == want
    dev = torch.device("cuda")
    m, x, cond = attention_case(3, 16, 48, True, 60, 0.0, seed=1)
    bias_idx = relative_position_indices(7, 4, device=dev)
    for dtype, want in ((bf, "strip"), (f32, "first")):
        cuda_attn.reset_launches()
        with torch.inference_mode():
            cuda_attn.window_attention(
                m.to(dev, dtype), torch.from_numpy(x).to(dev, dtype),
                torch.from_numpy(cond).to(dev, dtype), bias_idx,
                windows_per_sample=30)
        assert dict(cuda_attn.fwd_route_launches) == {want: 1}
