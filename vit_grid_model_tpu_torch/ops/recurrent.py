"""Recurrent and masked-attention primitives of the legacy station models.

Counterpart of ``vit_grid_model_tpu/ops/recurrent.py``.  The parameters
live in ``nn.LSTMCell`` and ``nn.MultiheadAttention(E, 1)`` (keys
``weight_ih``, ``weight_hh``, ``bias_ih``, ``bias_hh`` and
``in_proj_weight``, ``in_proj_bias``, ``out_proj.weight``,
``out_proj.bias``), but the forwards are the JAX package's own:

* ``lstm_cell`` is one step in torch's gate order i, f, g, o;
* ``mha_self_attention`` softmaxes safely: a row whose keys are all masked
  gives zeros, where ``nn.MultiheadAttention.forward`` gives NaN;
* ``residual_masked_attention`` attends for every batch row and then keeps
  the update only for rows with a valid station, where the reference drops
  the other rows before attending (``model.py:352-355``).

``mha_self_attention`` runs the core between its two projections, q k^T,
the scale, the key mask, the safe softmax and P v, as one streaming kernel
(``ops/cuda/joint_attention.py``) where that takes the call: a CUDA f32
input that autograd does not need, at a width the kernel has.  Elsewhere
it runs ``attention_core``, the plain eager version; the wrapper counts
the calls by route.

``attention_calls`` and ``score_elements`` count the calls of
``mha_self_attention`` and the score elements (B * n * n) they attend
over, on either route, since ``reset_counts``.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor, nn

from vit_grid_model_tpu_torch.ops.cuda import joint_attention as cuda_joint

attention_calls = 0
score_elements = 0


def reset_counts() -> None:
    global attention_calls, score_elements
    attention_calls = 0
    score_elements = 0


def lstm_cell(cell: nn.LSTMCell, x: Tensor, h: Tensor,
              c: Tensor) -> Tuple[Tensor, Tensor]:
    """One step: x (N, in), h and c (N, H) -> (h', c')."""
    gates = (x @ cell.weight_ih.T + cell.bias_ih
             + h @ cell.weight_hh.T + cell.bias_hh)
    i, f, g, o = gates.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def mha_self_attention(mha: nn.MultiheadAttention, x: Tensor,
                       key_padding_mask: Optional[Tensor] = None) -> Tensor:
    """Single-head self-attention, batch first: x (B, N, E);
    ``key_padding_mask`` (B, N) bool, True excluding that key."""
    global attention_calls, score_elements
    b, n, _ = x.shape
    attention_calls += 1
    score_elements += b * n * n
    qkv = F.linear(x, mha.in_proj_weight, mha.in_proj_bias)
    params = (mha.in_proj_weight, mha.in_proj_bias, mha.out_proj.weight,
              mha.out_proj.bias)
    if cuda_joint.route(x, params, key_padding_mask) == "streaming":
        out = cuda_joint.launch(qkv, key_padding_mask)
    else:
        cuda_joint.count_eager()
        out = attention_core(qkv, key_padding_mask)
    return F.linear(out, mha.out_proj.weight, mha.out_proj.bias)


def attention_core(qkv: Tensor,
                   key_padding_mask: Optional[Tensor] = None) -> Tensor:
    """The plain core of ``mha_self_attention``: the (B, N, 3E)
    in-projection output -> softmax(q k^T / sqrt(E)) v, (B, N, E), the
    masked keys at -inf and a row with no valid key giving zeros."""
    q, k, v = qkv.chunk(3, -1)
    sim = torch.matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    if key_padding_mask is not None:
        sim = sim.masked_fill(key_padding_mask[:, None, :], -math.inf)
    m = sim.amax(dim=-1, keepdim=True)
    m = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    ex = torch.exp(sim - m)
    denom = ex.sum(dim=-1, keepdim=True)
    attn = torch.where(denom > 0, ex / denom.clamp_min(1e-30),
                       torch.zeros_like(ex))
    return torch.matmul(attn, v)


def residual_masked_attention(mha: nn.MultiheadAttention, hidden: Tensor,
                              valid: Tensor) -> Tensor:
    """``hidden + attention(hidden)`` with invalid stations masked as keys,
    for batch rows that have a valid station; other rows unchanged."""
    row_has_valid = valid.sum(dim=1) > 0
    updated = hidden + mha_self_attention(mha, hidden,
                                          key_padding_mask=~valid)
    return torch.where(row_has_valid[:, None, None], updated, hidden)
