"""R7 on the GPU: one MaxViT layer's block and grid attention in one launch,
against the port's two-launch path.

The counterpart of ``benchmarks/mosaic_repros/repro_megakernel.py``.  On
the flagship layer (42 x 35 map, dim 128, 32 heads x 32, window 7, 4
registers, FiLM from a 32-wide cond) in bf16, for S = 96 sample-leads (the
repro's B = 8 x 12 leads) and S = 300 (the flagship evaluation, B = 25 x
12), it times with CUDA events, each with its max error relative to the
plain version:

* ``plain``: ``ops/attention_variants.py::maxvit_layer_attention``;
* ``baseline``: the port's shipping path, two K1 launches
  (``ops/cuda/attention.py::window_attention``) with ``ops/window.py``'s
  partitions, the residuals and the register mean between them, as
  ``repro_megakernel.py::build_baseline`` does;
* ``kernel``: ``ops/cuda/attention_variants.py::maxvit_layer_attention``
  at its default cluster size, and ``kernel C=c`` at each size of the
  sweep (``SWEEP``), each beside its occupancy line: the cluster size,
  the clusters the card holds at once and the CTAs they make, against the
  CTA slots of the card's SMs.

The two attentions are the port's ``Attention`` modules with weights drawn
from a numpy seed (``core/weights.py::seed_module``); ``layer_operands``
turns them into the kernel's operands.  Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.megakernel
"""

from __future__ import annotations

import json
import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import Tensor

from vit_grid_model_tpu_torch.core.weights import seed_module
from vit_grid_model_tpu_torch.ops import window as W
from vit_grid_model_tpu_torch.ops.attention import Attention
from vit_grid_model_tpu_torch.ops.attention_variants import (
    maxvit_layer_attention as plain_layer)
from vit_grid_model_tpu_torch.ops.cuda.attention import (KernelInputs,
                                                         kernel_inputs,
                                                         window_attention)
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    maxvit_layer_attention)
from vit_grid_model_tpu_torch.repros import common

H, WD, WIN, NR = 42, 35, 7, 4
DIM, HEADS, DIM_HEAD, COND = 128, 32, 32, 32
CASES = {"repro S=96 (B=8 x 12 leads)": 96,
         "flagship eval S=300 (B=25 x 12 leads)": 300}
SWEEP = (2, 3, 5, 6)   # cluster sizes timed beside the default
# max|kernel - plain| / max|plain|
TOLERANCE = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def layer(seed: int = 0) -> Tuple[Attention, Attention, Tensor]:
    """The block and grid attentions of one flagship layer and its register
    tokens (f32, on the CPU), every value from a numpy seed."""
    def attn(s):
        return seed_module(Attention(DIM, cond_dim=COND, heads=HEADS,
                                     dim_head=DIM_HEAD, window_size=WIN), s)

    regs = np.random.default_rng(seed + 2).standard_normal((NR, DIM))
    return attn(seed), attn(seed + 1), torch.from_numpy(
        regs.astype(np.float32))


def inputs(s: int, dtype: torch.dtype, device: torch.device,
           seed: int = 0) -> Tuple[Tensor, Tensor]:
    """(x maps (s, H, WD, DIM) in ``dtype``, cond (s, COND) f32), the
    repro's scales (0.5 x standard normal, standard normal) from a numpy
    seed."""
    rng = np.random.default_rng(seed)
    x = 0.5 * rng.standard_normal((s, H, WD, DIM), np.float32)
    cond = rng.standard_normal((s, COND), np.float32)
    return (torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(cond).to(device))


def layer_operands(block_attn: Attention, grid_attn: Attention, regs: Tensor,
                   cond: Tensor, dtype: torch.dtype
                   ) -> Tuple[Tensor, KernelInputs, KernelInputs]:
    """(regs, block operands, grid operands) of the kernel for maps in
    ``dtype``: the registers in ``dtype``; per attention the FiLM gamma/beta
    of every sample-lead's cond rounded to ``dtype``, the per-head wqkv and
    wout in ``dtype``, qg/kg and the bias gathered for the registers ++
    window tokens, in f32 (``ops/cuda/attention.py::kernel_inputs``).  The
    kernel has no backward, so none of them carries a gradient."""
    nr = regs.shape[0]
    win = (math.isqrt(block_attn.rel_pos_bias.num_embeddings - 1) + 1) // 2
    n = nr + win * win
    dev = regs.device
    idx = W.relative_position_indices(win, nr, device=dev)
    # kernel_inputs reads only the shape, dtype and device of its x: one
    # row of operands per sample-lead
    like = torch.zeros((), dtype=dtype, device=dev).expand(
        cond.shape[0], n, regs.shape[1])
    ops = [kernel_inputs(p, like, cond.to(p.to_qkv.weight.dtype), idx, 1)
           for p in (block_attn, grid_attn)]
    ops = [k._replace(**{f: getattr(k, f).detach() for f in k._fields[:7]})
           for k in ops]
    return regs.to(dtype), ops[0], ops[1]


def baseline(x: Tensor, block_attn: Attention, grid_attn: Attention,
             regs: Tensor, cond: Tensor) -> Tensor:
    """The shipping path: two K1 launches with the partitions, the
    residuals and the register mean between them in x's dtype
    (``repro_megakernel.py::build_baseline``)."""
    s, _, _, c = x.shape
    idx = W.relative_position_indices(WIN, NR, device=x.device)
    xw, dims = W.block_partition(x, WIN)
    nwin = dims[1] * dims[2]
    tokens = torch.cat([regs.to(x.dtype).expand(xw.shape[0], NR, c), xw], 1)
    tokens = tokens + window_attention(block_attn, tokens, cond, idx,
                                       windows_per_sample=nwin)
    x2 = W.block_reverse(tokens[:, NR:], WIN, dims)
    r2 = tokens[:, :NR].reshape(s, nwin, NR, c).mean(dim=1)
    xg, dims = W.grid_partition(x2, WIN)
    tokens = torch.cat([r2.repeat_interleave(nwin, dim=0), xg], 1)
    tokens = tokens + window_attention(grid_attn, tokens, cond, idx,
                                       windows_per_sample=nwin)
    return W.grid_reverse(tokens[:, NR:], WIN, dims)


def bound_ms(s: int, dtype: torch.dtype) -> Tuple[float, str]:
    """The least time the card could take for one layer at S = ``s``: the
    larger of two K1 calls' operations (qkv, scores, P.v, out-projection on
    the 53 real tokens of 60 windows a sample-lead) over the peak rate for
    the dtype and the map read and written once over the memory rate."""
    item = torch.finfo(dtype).bits // 8
    n, inner = NR + WIN * WIN, HEADS * DIM_HEAD
    per_window = (2 * n * DIM * 3 * inner + 4 * HEADS * n * n * DIM_HEAD
                  + 2 * n * inner * DIM)
    windows = 2 * (H // WIN) * (WD // WIN)
    ops = s * windows * per_window
    moved = 2 * s * H * WD * DIM * item
    return common.bound_ms(ops, moved, dtype)


def occupancy(dtype: torch.dtype, cluster: int = 0) -> str:
    """The kernel's cluster shape at the flagship layer with ``cluster``
    asked for (0: the default), how many of its clusters the card holds
    at once (CUDA's occupancy query) and the CTA slots of its SMs."""
    lib = library.load()
    shape = (H, WD, WIN, NR, DIM, DIM_HEAD, int(dtype == torch.bfloat16),
             cluster)
    size = lib.vgm_maxvit_layer_attention_cluster(*shape)
    active = lib.vgm_maxvit_layer_attention_occupancy(*shape, 0)
    per_sm = lib.vgm_maxvit_layer_attention_occupancy(*shape, 1)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return (f"clusters of {size} CTAs (one sample-lead each), {active} "
            f"resident at once: {active * size} CTAs of the {per_sm * sms} "
            f"slots of {sms} SMs at {per_sm} CTAs an SM")


def run(s: int, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
        iters: int = 10, sweep=()) -> Dict[str, Tuple[float, float]]:
    """Time the plain version, the two-K1 baseline and the kernel (at its
    default cluster, then at each cluster size in ``sweep``) at S = ``s``:
    {name: (ms, max rel vs plain)}.  Raises when a kernel misses
    ``TOLERANCE``."""
    dev = common.require_cuda()
    block_attn, grid_attn, regs = (t.to(dev) for t in layer(seed))
    x, cond = inputs(s, dtype, dev, seed + 3)
    r, ops_b, ops_g = layer_operands(block_attn, grid_attn, regs, cond, dtype)
    versions = {
        "plain": lambda: plain_layer(x, r, ops_b, ops_g, WIN),
        "baseline": lambda: baseline(x, block_attn, grid_attn, regs, cond),
        "kernel": lambda: maxvit_layer_attention(x, r, ops_b, ops_g, WIN),
    }
    for c in sweep:
        versions[f"kernel C={c}"] = (
            lambda c=c: maxvit_layer_attention(x, r, ops_b, ops_g, WIN,
                                               cluster=c))
    out = {}
    with torch.inference_mode():
        ref = versions["plain"]()
        for name, fn in versions.items():
            if name.startswith("kernel C="):
                print(f"  {occupancy(dtype, int(name[9:]))}", flush=True)
            out[name] = common.run_repro(
                f"S={s} {str(dtype).split('.')[-1]} {name}", fn, ref,
                iters=iters, warmup=2)
    del ref
    torch.cuda.empty_cache()
    for name, (_, rel) in out.items():
        if name.startswith("kernel") and not rel <= TOLERANCE[dtype]:
            raise AssertionError(f"S={s} {name}: max rel {rel} above "
                                 f"{TOLERANCE[dtype]}")
    return out


def main() -> Dict[int, Dict[str, Tuple[float, float]]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    print(f"kernel: {occupancy(torch.bfloat16)}", flush=True)
    results = {}
    for label, s in CASES.items():
        print(f"=== {label}: {H}x{WD} map, dim {DIM}, {HEADS} heads x "
              f"{DIM_HEAD}, window {WIN}, {NR} registers, bf16 ===",
              flush=True)
        results[s] = run(s, sweep=SWEEP)
        bound, by = bound_ms(s, torch.bfloat16)
        r = results[s]
        print(f"bound {bound:.4f} ms ({by}); kernel / baseline "
              f"{r['kernel'][0] / r['baseline'][0]:.3f}; kernel / bound "
              f"{r['kernel'][0] / bound:.1f}", flush=True)
    print(json.dumps({"card": card, "ms": {
        s: {k: v[0] for k, v in r.items()} for s, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
