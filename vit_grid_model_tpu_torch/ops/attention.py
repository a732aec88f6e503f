"""Windowed multi-head attention with QK-RMSNorm, relative-position bias,
register tokens and FiLM lead-time conditioning: the plain PyTorch version.

Counterpart of ``vit_grid_model_tpu/ops/attention.py`` (eval mode).  It is
the reference that the hand-written CUDA kernel
(``ops/cuda/attention.py``) is held against, and what that wrapper runs for
tensors on the CPU.  The pinned details:

* the pre-norm LayerNorm has no affine when conditioned;
* FiLM ``x * gamma + beta`` broadcasts each sample's gamma/beta over its
  windows (sample-major);
* queries/keys go through QK-RMSNorm scaled by sqrt(dim_head), and no
  ``dim_head ** -0.5`` is applied;
* the bias table has (2w-1)^2 + 1 rows; register rows/cols read the last.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import Tensor, nn

from vit_grid_model_tpu_torch.ops import nn as vnn


class Attention(nn.Module):
    """Parameters of one window-attention layer; the state_dict keys are
    those of ``core/torch_export.py::_emit_attention``."""

    def __init__(self, dim: int, *, cond_dim: Optional[int], heads: int,
                 dim_head: int, window_size: int):
        super().__init__()
        self.heads = heads
        self.dim_head = dim_head
        inner = heads * dim_head
        self.norm = nn.LayerNorm(dim, elementwise_affine=cond_dim is None)
        self.film = vnn.FiLM(cond_dim, dim) if cond_dim is not None else None
        self.to_qkv = nn.Linear(dim, inner * 3, bias=False)
        self.q_norm = vnn.QKRMSNorm(heads, dim_head)
        self.k_norm = vnn.QKRMSNorm(heads, dim_head)
        self.to_out = nn.Sequential(nn.Linear(inner, dim, bias=False))
        self.rel_pos_bias = nn.Embedding((2 * window_size - 1) ** 2 + 1, heads)


def attention(p: Attention, x: Tensor, cond: Optional[Tensor],
              bias_indices: Tensor, *, windows_per_sample: int) -> Tensor:
    """x: (Bw, n, dim) with Bw = B_cond * windows_per_sample (sample-major);
    cond: (B_cond, cond_dim) or None; bias_indices: (n, n).  Returns
    (Bw, n, dim) in x's dtype.  Scores and P.v accumulate in f32."""
    bw, n, _ = x.shape
    heads = p.heads

    x = vnn.layer_norm(x, p.norm.weight, p.norm.bias)
    if p.film is not None and cond is not None:
        gamma, beta = p.film(cond)                       # (B_cond, dim) each
        gamma = gamma.repeat_interleave(windows_per_sample, dim=0)[:, None]
        beta = beta.repeat_interleave(windows_per_sample, dim=0)[:, None]
        x = x * gamma + beta

    qkv = vnn.linear(x, p.to_qkv.weight)                 # (Bw, n, 3*h*d)
    q, k, v = qkv.chunk(3, dim=-1)

    def split_heads(t):
        return t.reshape(bw, n, heads, -1).transpose(1, 2)

    q, k, v = split_heads(q), split_heads(k), split_heads(v)
    q = p.q_norm(q)
    k = p.k_norm(k)

    sim = torch.matmul(q.float(), k.float().transpose(-1, -2))
    bias = vnn.embedding(p.rel_pos_bias.weight, bias_indices)   # (n, n, h)
    sim = sim + bias.permute(2, 0, 1)[None]

    attn = sim.softmax(dim=-1).to(v.dtype)
    out = torch.matmul(attn.float(), v.float()).to(v.dtype)
    out = out.transpose(1, 2).reshape(bw, n, -1)
    return vnn.linear(out, p.to_out[0].weight)
