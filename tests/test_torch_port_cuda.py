"""The hand-written CUDA window-attention kernel against its plain PyTorch
version on the GPU.  Skips without a CUDA device.  This file imports no JAX,
so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_cuda.py

Tolerances, relative to max|plain|: f32 1e-4 (sums in another order), bf16
2e-2 (bf16 rounding at other points).  Layers and inputs come from
``chip_smoke.attention_case`` (numpy seed 0)."""

import pytest
import torch

from chip_smoke import attention_case
from vit_grid_model_tpu_torch.ops import attention as tattn
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.window import relative_position_indices

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads,dim_head,dim,conditioned,offset", [
    (32, 32, 128, True, 0.0),       # the flagship layer
    (3, 16, 48, False, 0.0),        # odd head count, LN affine
    (2, 16, 32, True, -200.0),      # head 0 scores ~200 below head 1
    (3, 8, 40, True, 0.0),          # widths off the 16-multiples of wmma
])
def test_kernel_matches_plain(dtype, heads, dim_head, dim, conditioned,
                              offset):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
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
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m, _, cond = attention_case(2, 16, 32, True, 30, 0.0, seed=0)
    m = m.cuda()
    too_long = torch.zeros(30, 65, 32, device="cuda")
    with pytest.raises(ValueError):
        cuda_attn.window_attention(
            m, too_long, torch.from_numpy(cond).cuda(),
            torch.zeros(65, 65, dtype=torch.long, device="cuda"),
            windows_per_sample=30)
