"""The joint attention's routing and the plain core on the CPU
(``ops/recurrent.py::mha_self_attention`` and ``attention_core``,
``ops/cuda/joint_attention.py``; the kernel itself runs only on the card,
see ``tests/test_torch_port_joint_attention_cuda.py``).

* ``refusal`` names why the kernel would not take a call: grad, another
  dtype, an uninstantiated width, a mask of another shape or dtype, the
  CPU.  ``route`` gives "eager" for each, and ``mha_self_attention``
  counts such a call under "eager", never as a launch.
* ``attention_calls`` and ``score_elements`` count the same on either
  route, and the streaming branch hands the kernel the in-projection's
  output and the mask as the caller gave them.
* The eager route is the former eager forward, bit for bit; a fully masked
  row's core is exact zeros, its output the out-projection's bias, and
  ``residual_masked_attention`` leaves its batch row unchanged; the
  checked entry ``joint_attention`` refuses a CPU tensor.
* A grid model v3 forward counts one eager call a decode step here.
"""

import math

import pytest
import torch
import torch.nn.functional as F

from vit_grid_model_tpu_torch.models.legacy.grid import (GridModel,
                                                         GridModelSpec)
from vit_grid_model_tpu_torch.ops import recurrent
from vit_grid_model_tpu_torch.ops.cuda import joint_attention as cuda_joint

E = 128


def _mha(e=E, seed=0):
    torch.manual_seed(seed)
    mha = torch.nn.MultiheadAttention(e, 1)
    with torch.no_grad():
        mha.in_proj_bias.normal_(0, 0.1)
        mha.out_proj.bias.normal_(0, 0.1)
    return mha


def _inputs(b, n, e=E, seed=1, dead_rows=1):
    """x (b, n, e) and a key mask with ~30% of keys masked and the first
    ``dead_rows`` batch rows masked whole."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(b, n, e, generator=g)
    mask = torch.rand(b, n, generator=g) < 0.3
    mask[:dead_rows] = True
    return x, mask


def _former(mha, x, key_padding_mask):
    """The eager forward as it was before the kernel."""
    e = x.shape[-1]
    q, k, v = F.linear(x, mha.in_proj_weight, mha.in_proj_bias).chunk(3, -1)
    sim = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(e)
    sim = sim.masked_fill(key_padding_mask[:, None, :], -math.inf)
    m = sim.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(sim - m)
    denom = ex.sum(dim=-1, keepdim=True)
    attn = torch.where(denom > 0, ex / denom.clamp_min(1e-30),
                       torch.zeros_like(ex))
    return F.linear(torch.matmul(attn, v), mha.out_proj.weight,
                    mha.out_proj.bias)


def _params(mha):
    return (mha.in_proj_weight, mha.in_proj_bias, mha.out_proj.weight,
            mha.out_proj.bias)


@pytest.mark.parametrize("case,why", [
    ("grad", "requires grad"), ("float64", "dtype"), ("width", "width 64"),
    ("mask dtype", "key mask"), ("mask shape", "key mask"),
    ("cpu", "no kernel for cpu")])
def test_each_refusal_takes_the_eager_route(case, why):
    mha = _mha(64 if case == "width" else E)
    x, mask = _inputs(2, 7, 64 if case == "width" else E)
    if case == "float64":
        x = x.double()
    if case == "mask dtype":
        mask = mask.float()
    if case == "mask shape":
        mask = mask[:, :5]
    with torch.set_grad_enabled(case == "grad"):
        reason = cuda_joint.refusal(x, _params(mha), mask)
        assert reason is not None and why in reason, reason
        assert cuda_joint.route(x, _params(mha), mask) == "eager"
    cuda_joint.reset_launches()
    if case in ("mask dtype", "mask shape", "float64"):
        return   # the eager core, too, takes only a (B, n) bool mask
    with torch.set_grad_enabled(case == "grad"):
        recurrent.mha_self_attention(mha, x, mask)
    assert dict(cuda_joint.launches_by_route) == {"eager": 1}
    assert cuda_joint.launches == 0


def test_grad_off_or_no_operand_needing_it_is_no_refusal():
    """Grad enabled refuses only where an operand requires grad; on the
    CPU the one reason left is the device."""
    mha = _mha()
    x, mask = _inputs(2, 7)
    for p in mha.parameters():
        p.requires_grad_(False)
    assert cuda_joint.refusal(x, _params(mha), mask) == "no kernel for cpu"
    with torch.inference_mode():
        assert cuda_joint.refusal(x, _params(_mha()),
                                  mask) == "no kernel for cpu"
    assert cuda_joint.refusal(x, (), None) == "no kernel for cpu"


def test_counters_count_the_same_on_either_route(monkeypatch):
    mha = _mha()
    x, mask = _inputs(3, 11)
    seen = []

    def stand_in(qkv, key_padding_mask=None):
        """The kernel's place on the CPU: the plain core, counted as a
        launch."""
        seen.append((qkv.shape, key_padding_mask))
        cuda_joint.launches += 1
        cuda_joint.launches_by_route["streaming"] += 1
        return recurrent.attention_core(qkv, key_padding_mask)

    counts, outs = {}, {}
    for name in ("eager", "streaming"):
        recurrent.reset_counts()
        cuda_joint.reset_launches()
        if name == "streaming":
            monkeypatch.setattr(cuda_joint, "route",
                                lambda *a, **k: "streaming")
            monkeypatch.setattr(cuda_joint, "launch", stand_in)
        with torch.no_grad():
            outs[name] = recurrent.mha_self_attention(mha, x, mask)
            recurrent.mha_self_attention(mha, x)
        counts[name] = (recurrent.attention_calls, recurrent.score_elements)
        assert dict(cuda_joint.launches_by_route) == {name: 2}
        assert cuda_joint.launches == (2 if name == "streaming" else 0)
    assert counts["eager"] == counts["streaming"] == (2, 2 * 3 * 11 * 11)
    assert torch.equal(outs["eager"], outs["streaming"])
    assert [s for s, _ in seen] == [torch.Size([3, 11, 3 * E])] * 2
    assert seen[0][1] is mask and seen[1][1] is None


@pytest.mark.parametrize("grad", [False, True])
def test_eager_route_is_the_former_forward(grad):
    mha = _mha(seed=3)
    x, mask = _inputs(4, 9, seed=4)
    with torch.set_grad_enabled(grad):
        ours = recurrent.mha_self_attention(mha, x, mask)
        assert torch.equal(ours, _former(mha, x, mask))


def test_fully_masked_row_is_zero_on_the_plain_path():
    mha = _mha(seed=5)
    x, mask = _inputs(3, 13, seed=6, dead_rows=2)
    with torch.no_grad():
        qkv = F.linear(x, mha.in_proj_weight, mha.in_proj_bias)
        core = recurrent.attention_core(qkv, mask)
        with pytest.raises(ValueError, match="no kernel for cpu"):
            cuda_joint.joint_attention(qkv, mask)
        y = recurrent.mha_self_attention(mha, x, mask)
        res = recurrent.residual_masked_attention(mha, x, ~mask)
    assert torch.equal(core[:2], torch.zeros(2, 13, E))
    assert torch.isfinite(core).all() and core[2].abs().sum() > 0
    assert torch.equal(y[:2], mha.out_proj.bias.detach().expand(2, 13, E))
    assert torch.equal(res[:2], x[:2])


def test_grid_forward_counts_one_eager_call_a_decode_step():
    spec = GridModelSpec(version=3, input_dim=3, output_dim=2, prev_len=3,
                         feat_dim=12, hidden_dim=32, korea_stn_num=4,
                         china_stn_num=2, grid_shape=(4, 3),
                         normalization_method="RevIN")
    g = torch.Generator().manual_seed(7)
    coords = dict(lats=torch.rand(6, generator=g).numpy() + 35,
                  lons=torch.rand(6, generator=g).numpy() + 127,
                  cmaq_coords=torch.rand(4, 3, 2, generator=g).numpy() + 35)
    model = GridModel(spec, coords["lats"], coords["lons"],
                      coords["cmaq_coords"]).eval()
    b, steps = 2, 5
    masks = torch.rand(b, steps, 6, generator=g) > 0.3
    raw_times = torch.stack([torch.randint(1, 13, (b, steps), generator=g),
                             torch.randint(1, 29, (b, steps), generator=g),
                             torch.randint(0, 24, (b, steps), generator=g)],
                            -1).float()
    inputs = (torch.rand(b, 3, 6, 12, generator=g) * 30, masks, raw_times,
              torch.rand(b, 3, 4, 3, generator=g) * 30,
              torch.rand(b, 4, 3, steps * spec.block_channels,
                         generator=g) * 25)
    recurrent.reset_counts()
    cuda_joint.reset_launches()
    with torch.inference_mode():
        out = model(*inputs)
    assert out.shape == (b, 12, 2) and torch.isfinite(out).all()
    assert recurrent.attention_calls == 2
    assert recurrent.score_elements == 2 * b * 18 * 18
    assert dict(cuda_joint.launches_by_route) == {"eager": 2}
    assert cuda_joint.launches == 0
