"""R11 on the GPU: staged head-major attention.

The counterpart of ``benchmarks/mosaic_repros/repro_staged_headmajor.py``
(R11), which stages R1's qkv product, l2 norm and a head-major layout
outside the kernel and runs only the scores, softmax and P.v in it.  At
R1's geometry and inputs (``repros/baseline_perhead.py``: 56 tokens, dim
128, 32 heads x 32, bf16; Bw = 2,880 and 9,000) it times with CUDA events,
each with its max error relative to its plain version:

* the whole path: ``plain`` (``ops/attention_variants.py::
  staged_headmajor_attention``), ``kernel`` (``ops/cuda/
  attention_variants.py::staged_attention``: the staging in stock PyTorch,
  then the core kernel) and ``R1 kernel wpc=8``, the repro's yardstick;
* the core alone on the staged (heads, Bw, n, dh) operands: ``plain``
  (``staged_headmajor_core``), ``kernel`` (``staged_attention_core``) and
  ``sdpa``, the library call ``torch.nn.functional.
  scaled_dot_product_attention`` with the bias as its additive mask, held
  to the same tolerance, and ``sdpa efficient``, the same call forced onto
  its memory-efficient backend.  The mask is given in q's dtype: with an
  f32 mask, PyTorch's default route on an H100 (cuDNN) returns NaN for
  these inputs, and the memory-efficient backend refuses the mask.  The
  backend the default call runs is named by ``sdpa_backend``.

Needs one CUDA device:

    python -m vit_grid_model_tpu_torch.repros.staged_headmajor
"""

from __future__ import annotations

import json
from typing import Callable, Dict, Tuple

import torch
from torch import Tensor
from torch.nn.attention import SDPBackend, sdpa_kernel

from vit_grid_model_tpu_torch.ops.attention_variants import (
    stage_headmajor, staged_headmajor_attention, staged_headmajor_core)
from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
    perhead_attention, staged_attention, staged_attention_core)
from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
from vit_grid_model_tpu_torch.repros import common

ITERS = 10   # timed calls a version


def core_bound_ms(bw: int, n: int, heads: int, dim_head: int,
                  dtype: torch.dtype) -> Tuple[float, str]:
    """The core's least time: its two products' operations against q, k, v
    read once and the output written once in ``dtype``, and the f32 bias."""
    item = torch.finfo(dtype).bits // 8
    ops = 4 * heads * bw * n * n * dim_head
    moved = 4 * heads * bw * n * dim_head * item + heads * n * n * 4
    return common.bound_ms(ops, moved, dtype)


def staged_bound_ms(bw: int, n: int, dim: int, heads: int, dim_head: int,
                    dtype: torch.dtype) -> Tuple[float, str]:
    """The whole staged path's least time, for the bytes its code must move:
    x, wqkv and bias read; the f32 qkv written and read; q, k and v staged
    in ``dtype`` written and read; the head-major output written and read;
    the output written.  Its operations are R1's."""
    item = torch.finfo(dtype).bits // 8
    inner = heads * dim_head
    act = bw * n * inner                 # one of q, k, v or out
    ops = bw * (2 * n * dim * 3 * inner + 4 * heads * n * n * dim_head)
    moved = (bw * n * dim * item + 3 * dim * inner * item + heads * n * n * 4
             + 2 * 3 * act * 4           # the f32 qkv
             + 2 * 3 * act * item        # q, k, v staged
             + 2 * act * item            # the head-major output
             + act * item)               # the output
    return common.bound_ms(ops, moved, dtype)


BACKENDS = (SDPBackend.CUDNN_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
            SDPBackend.MATH)


def sdpa_backend(fn: Callable[[], Tensor]) -> str:
    """The SDPA backend ``fn`` runs by default: the first of ``BACKENDS``
    whose forced output is bit-identical to the default call's."""
    out = fn()
    for backend in BACKENDS:
        try:
            with sdpa_kernel(backend):
                if torch.equal(fn(), out):
                    return backend.name
        except RuntimeError:   # the backend does not take these inputs
            continue
    return "none of " + ", ".join(b.name for b in BACKENDS)


def run(bw: int, dtype: torch.dtype = torch.bfloat16, seed: int = 0,
        iters: int = ITERS) -> Dict[str, object]:
    """{"whole": {name: (ms, rel)}, "core": {name: (ms, rel)}, "sdpa
    backend": the default call's backend} at Bw = ``bw``.  Raises when a
    kernel or SDPA misses ``TOLERANCE``."""
    dev = common.require_cuda()
    x, wqkv, bias = r1.inputs(bw, dtype, dev, seed)
    heads, dh = r1.HEADS, r1.DIM_HEAD
    tag = f"Bw={bw} {str(dtype).split('.')[-1]}"
    tol = r1.TOLERANCE[dtype]
    whole = common.compare_and_time(f"{tag} whole", {
        "plain": lambda: staged_headmajor_attention(x, wqkv, bias, heads, dh),
        "kernel": lambda: staged_attention(x, wqkv, bias),
        "R1 kernel wpc=8": lambda: perhead_attention(x, wqkv, bias, 8),
    }, tol, iters=iters)
    with torch.inference_mode():
        qkv = torch.matmul(x.float(), wqkv.float())
        qn, kn, v = stage_headmajor(qkv, heads, dh, dtype)
        del qkv, x
        mask = bias[:, None].to(dtype)

        def sdpa() -> Tensor:
            return torch.nn.functional.scaled_dot_product_attention(
                qn, kn, v, attn_mask=mask, scale=1.0)

        def sdpa_efficient() -> Tensor:
            with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
                return sdpa()

        backend = sdpa_backend(sdpa)
    print(f"{tag} core: SDPA's default call runs {backend}", flush=True)
    core = common.compare_and_time(f"{tag} core", {
        "plain": lambda: staged_headmajor_core(qn, kn, v, bias),
        "kernel": lambda: staged_attention_core(qn, kn, v, bias),
        "sdpa": sdpa,
        "sdpa efficient": sdpa_efficient,
    }, tol, iters=iters)
    return {"whole": whole, "core": core, "sdpa backend": backend}


def main() -> Dict[int, Dict[str, object]]:
    common.require_cuda()
    card = common.card_line()
    print(f"card: {card}", flush=True)
    results = {}
    for label, bw in r1.CASES.items():
        print(f"=== {label}: {r1.N_PAD} tokens, dim {r1.DIM}, {r1.HEADS} "
              f"heads x {r1.DIM_HEAD}, bf16 ===", flush=True)
        results[bw] = r = run(bw)
        core, by = core_bound_ms(bw, r1.N_PAD, r1.HEADS, r1.DIM_HEAD,
                                 torch.bfloat16)
        whole, wby = staged_bound_ms(bw, r1.N_PAD, r1.DIM, r1.HEADS,
                                     r1.DIM_HEAD, torch.bfloat16)
        w, c = r["whole"], r["core"]
        print(f"bound: core {core:.4f} ms ({by}), whole {whole:.4f} ms "
              f"({wby}); whole kernel / R1 kernel wpc=8 "
              f"{w['kernel'][0] / w['R1 kernel wpc=8'][0]:.3f}; core kernel "
              f"/ sdpa {c['kernel'][0] / c['sdpa'][0]:.3f}", flush=True)
    print(json.dumps({"card": card, "ms": {
        bw: {part: {k: v[0] for k, v in r[part].items()}
             for part in ("whole", "core")} for bw, r in results.items()}}))
    return results


if __name__ == "__main__":
    main()
