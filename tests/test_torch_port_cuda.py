"""The hand-written CUDA kernels against their plain PyTorch versions on the
GPU: the window-attention forward (with and without dropout), its backward,
the dropout keep mask, the fused MBConv, the per-head attention of R1/R14
(and R9's route through it), the MaxViT layer megakernel of R7, the
kernels of R4 (head-major batched), R10 (stacked softmax), R11 (staged
core, and R11 whole) and R3 (cross-head indicator norm), the
out-projection kernel of R12, R13, R2 and R8, and the head-pack kernel of
R5 and R6.  Skips without a CUDA device.
This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances, relative to max|plain|: forward f32 1e-4 (sums in another
order), bf16 2e-2 (bf16 rounding at other points); backward, each gradient,
f32 1e-4 and bf16 6e-2 (``chip_smoke.BWD_TOLERANCE``); the fused MBConv as
the forward, as are R1/R14, R7, R4, R9, R10, R11, R3, the out-projection
kernel and the head-pack kernel (whose f32 cases take an f32 output), whose
second launches are bit-identical.
The keep mask is bit-equal.  Layers and inputs come from
``chip_smoke.attention_case`` and the repros under ``repros/`` (numpy
seeds).
"""

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


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset", CASES)
def test_kernel_matches_plain(dtype, heads, dim_head, dim, conditioned,
                              offset):
    _need_cuda()
    m, x, cond = attention_case(heads, dim_head, dim, conditioned, 60,
                                offset, seed=0)
    dev = torch.device("cuda")
    m = m.to(dev, dtype)
    bias_idx = relative_position_indices(7, 4, device=dev)
    xt = torch.from_numpy(x).to(dev, dtype)
    ct = None if cond is None else torch.from_numpy(cond).to(dev, dtype)
    before = cuda_attn.launches
    with torch.inference_mode():
        ref = tattn.attention(m, xt, ct, bias_idx, windows_per_sample=30)
        ours = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                          windows_per_sample=30)
    torch.cuda.synchronize()
    assert cuda_attn.launches == before + 1
    assert ours.dtype == dtype and ours.shape == xt.shape
    ref, ours = ref.float(), ours.float()
    assert torch.isfinite(ours).all()
    err = (ours - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset", CASES)
def test_kernel_with_dropout_matches_plain(dtype, heads, dim_head, dim,
                                           conditioned, offset):
    _need_cuda()
    dev = torch.device("cuda")
    m, xt, ct, _, _ = chip_smoke.kernel_case(heads, dim_head, dim,
                                             conditioned, 60, offset, dev,
                                             dtype)
    bias_idx = relative_position_indices(7, 4, device=dev)
    with torch.inference_mode():
        ref = tattn.attention(m, xt, ct, bias_idx, windows_per_sample=30,
                              dropout_mask=keep_mask(77, 60, heads, 53, 0.25,
                                                     device=dev))
        ours = cuda_attn.window_attention(m, xt, ct, bias_idx,
                                          windows_per_sample=30, seed=77,
                                          dropout_rate=0.25)
    ref, ours = ref.float(), ours.float()
    assert torch.isfinite(ours).all()
    err = (ours - ref).abs().max().item()
    assert err <= TOL[dtype] * ref.abs().max().item(), err


@pytest.mark.parametrize("rate", [0.0, 0.25])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset", CASES)
def test_backward_matches_plain(rate, dtype, heads, dim_head, dim,
                                conditioned, offset):
    """Every output of the backward kernel against autograd through the
    plain forward with the same mask; a second launch is bit-identical."""
    _need_cuda()
    _, xt, _, k, dy = chip_smoke.kernel_case(
        heads, dim_head, dim, conditioned, 60, offset, torch.device("cuda"),
        dtype)
    before = cuda_attn.bwd_launches
    errs = chip_smoke.bwd_errors(xt, k, dy, 2 ** 31 - 2, rate)
    assert cuda_attn.bwd_launches == before + 2
    tol = chip_smoke.BWD_TOLERANCE[str(dtype).split(".")[-1]]
    bad = {g: (e, s) for g, (e, s) in errs.items() if not e <= tol * s}
    assert not bad, bad


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
# tiled axis
MBCONV_CASES = [(3, 42, 35, 128), (5, 9, 7, 32), (2, 3, 5, 32)]


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("offset", [0.0, -200.0])
def test_maxvit_layer_attention_matches_plain(dtype, offset):
    """S = 3 sample-leads; offset -200 puts head 0's scores ~200 below
    head 1's in both attentions."""
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
    x, cond = repro.inputs(3, dtype, dev, 1)
    r, ob, og = repro.layer_operands(block_attn.to(dev), grid_attn.to(dev),
                                     regs.to(dev), cond, dtype)
    before = av.layer_launches
    with torch.inference_mode():
        ref = plain_layer(x, r, ob, og, repro.WIN)
        ours = av.maxvit_layer_attention(x, r, ob, og, repro.WIN)
        again = av.maxvit_layer_attention(x, r, ob, og, repro.WIN)
    torch.cuda.synchronize()
    assert av.layer_launches == before + 2
    err, scale = chip_smoke.kernel_errors(ours, again, ref, "layer")
    assert err <= TOL[dtype] * scale, err


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


def _outproj_case(bw, n, dim, heads, dim_head, offset, dtype, route,
                  windows_per_cta=8):
    """The out-projection kernel (two launches) against its plain version
    with the route's casts; the output in x's dtype."""
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
    (R8's n_pad) among the cases."""
    _need_cuda()
    _outproj_case(bw, n, dim, heads, dim_head, offset, dtype, route)


@pytest.mark.parametrize("n", [56, 64])
@pytest.mark.parametrize("windows_per_cta", [8, 16, 32])
def test_outproj_attention_at_r8_windows_per_cta(windows_per_cta, n):
    """R8's kfold 1, 2, 4 as 8, 16, 32 windows a CTA; Bw 37 leaves a
    ragged last CTA at each."""
    _need_cuda()
    _outproj_case(37, n, 128, 32, 32, 0.0, torch.bfloat16, "ws_2pass_pwout",
                  windows_per_cta)


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
