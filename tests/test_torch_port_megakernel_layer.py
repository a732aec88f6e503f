"""R7's function is the main path's MaxViT layer, on the CPU.

The plain version of the layer megakernel
(``ops/attention_variants.py::maxvit_layer_attention``), given
``repros/megakernel.py::layer_operands`` of a port ``MaxViT`` layer's two
attentions and that layer's MBConv output, must give what ``MaxViT.forward``
gives: the block attention with its residual, the register mean over a
sample's windows, and the grid attention with its residual.

f32 only: the model rounds its residual to the activation type (bf16 on the
``--fast`` path) between the two attentions, where R7 keeps it in f32, so in
bf16 the two differ by design.  Tolerance 1e-5 of max|out| (the same sums,
taken in another order).
"""

import numpy as np
import pytest
import torch

from vit_grid_model_tpu_torch.core.weights import seed_module
from vit_grid_model_tpu_torch.models.maxvit import MaxViT
from vit_grid_model_tpu_torch.ops.attention_variants import (
    maxvit_layer_attention)
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.repros.megakernel import layer_operands

DIM, HEADS, DIM_HEAD, COND, WINDOW, REGISTERS, SIDE = 32, 4, 8, 8, 7, 2, 14


def _model() -> MaxViT:
    return seed_module(MaxViT(DIM, depth=(1,), cond_dim=COND, heads=HEADS,
                              dim_head=DIM_HEAD, window_size=WINDOW,
                              mbconv_expansion_rate=4,
                              mbconv_shrinkage_rate=0.25,
                              num_register_tokens=REGISTERS), 11)


def _inputs(s: int):
    rng = np.random.default_rng(s)
    x = rng.standard_normal((s, DIM, SIDE, SIDE)).astype(np.float32)
    cond = rng.standard_normal((s, COND)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(cond)


@pytest.mark.parametrize("s", [1, 3])
def test_layer_attention_is_the_maxvit_layer(s):
    model = _model()
    x, cond = _inputs(s)
    _, block_attn, grid_attn = model.layers[0]
    with torch.no_grad():
        want = model(x, cond).permute(0, 2, 3, 1)
        mb = model(x, cond, stop_after="mbconv").permute(0, 2, 3, 1)
        regs, ops_b, ops_g = layer_operands(
            block_attn, grid_attn, model.register_tokens[0].detach(), cond,
            torch.float32)
        got = maxvit_layer_attention(mb.contiguous(), regs, ops_b, ops_g,
                                     WINDOW)
        # the wrapper takes the plain version for CPU tensors
        wrapped = cuda_av.maxvit_layer_attention(mb.contiguous(), regs, ops_b,
                                                 ops_g, WINDOW)
    assert got.shape == want.shape == (s, SIDE, SIDE, DIM)
    assert torch.isfinite(got).all()
    err = (got - want).abs().max().item()
    assert err <= 1e-5 * want.abs().max().item(), err
    assert torch.equal(wrapped, got)
    # the layer's attentions do change the map: the test is not vacuous
    assert (want - mb).abs().max().item() > 0.1 * want.abs().max().item()


def test_megakernel_sections_patches_every_section():
    """``repros/megakernel_sections.py`` finds its places in the committed
    source: the strip design's five body stamps (LN + FiLM, qkv, the n x n
    section, the out-projection, the epilogue) and its two cluster-barrier
    stamps, with the body inlined; and the first design's seven kernel and
    seven body stamps, in the first design's kernel that the committed
    source keeps for f32."""
    from vit_grid_model_tpu_torch.repros import megakernel_sections as ms

    text = ms.SOURCE.read_text()
    assert ms.is_strip_design(text)
    inlined = ms.inline_header(text, ms.SOURCE.parent / ms.STRIP_BODY)
    assert '#include "window_attention_strips.cuh"' not in inlined
    stamped = ms.strip_stamped(inlined)
    assert stamped.count("STAMP(") == 7
    assert stamped.count("FLUSH_SECTIONS();") == 4
    body = (ms.SOURCE.parent / ms.FIRST_BODY).read_text()
    assert ms.first_stamped(text).count("STAMP(") == 7
    assert ms.first_body_stamped(body).count("STAMP(") == 7
