"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's hand-written kernels
from ``vit_grid_model_tpu_torch/csrc`` and its C++ data loader, holds each
kernel against its plain PyTorch version on the card, runs the shipped
12-hour MetNet3 (random weights from a numpy seed) on the GPU and on the
CPU, drives the ``--fast`` evaluation CLI over a synthetic data tree at
batch 25, drives the ``--fast`` training CLI for 12 steps at batch 4, and
drives the R15 repro (the fused MBConv against cuDNN's passes), the R1/R14
repro (per-head attention at 8 and 16 windows a CTA), the R7 repro (one
MaxViT layer's block and grid attention in one launch), the repros of R1's
variants R4, R10, R9, R11 and R3, the repros of the out-projection
family R12-R13, R2 and R8, and the head-pack repros R5 and R6.  Phases:

0. device: CUDA present, versions, the card's name and power limit;
1. build: compile the kernel library and the data loader;
2. forward kernel vs plain: flagship, 3-head and diverging-score cases in
   f32 and bf16; kernel and plain times at the flagship shape;
2b. dropout keep mask: the CUDA hash bit-equal to its plain version;
2c. forward kernel with dropout vs plain with the same mask;
2d. backward kernel vs autograd through the plain forward, at rates 0 and
    0.1 in f32 and bf16; bit-identical on a second launch; times;
3. whole model: one sample forward in f32 on the GPU against the CPU;
4. main path: the evaluation CLI; every window attention must have gone
   through the forward kernel;
5. whole-model gradients: one training loss and backward in f32 on the GPU
   (forward and backward kernels) against the CPU (plain version) in f64;
6. training main path: the training CLI; every window attention and its
   gradient must have gone through the kernels;
7. R15: the fused MBConv kernel vs its plain version (bf16 at BN 384 with
   1 and 4 samples per block and at BN 300, f32 at BN 8, a small odd
   shape in both types, the 12-hour model's own MBConv), bit-identical on
   a second launch; then the repro's entry point, which must go through
   the kernel, with kernel, plain and stock-folded times; and the stock
   MBConv's share of the B=25 ``--fast`` forward's kernel time;
8. R1/R14: the per-head attention kernel vs its plain version at 8 and 16
   windows a CTA (bf16 at Bw 2,880, f32, a ragged Bw, 3 heads x 16),
   bit-identical on a second launch; then the repro's entry point, which
   must launch the kernel at both settings, with kernel and plain times;
9. R7: the MaxViT layer megakernel vs its plain version (bf16 at S 96 and
   300, f32 at S 2, a diverging-score case in both types), bit-identical on
   a second launch; then the repro's entry point, which must launch it,
   with kernel, plain and two-K1 baseline times;
10. R4, R10, R9 and R11: the head-major batched kernel, the stacked-softmax
   kernel, R9's route through the per-head kernel, R11's core kernel and
   R11 whole vs their plain versions (bf16 at Bw 2,880, f32, a ragged Bw,
   3 heads x 16, a diverging-score case in both types), bit-identical on a
   second launch; then the four repros' entry points, each of which must
   launch its kernel, with kernel, plain and R1-kernel times (R11 also the
   core against SDPA);
11. R3 and the out-projection family: R3's cross-head indicator-norm
   kernel on phase 10's cases; the out-projection kernel's shipping
   structure (ws_2pass_pwout) on the same cases, the other R12/R13
   structures at Bw 2,880 in bf16 and Bw 40 in f32 (f32 output, held to
   1e-4), R2's casts at Bw 2,880 and in the diverging cases, R8's six
   (n_pad, kfold) cases at Bw 2,880, each bit-identical on a second launch;
   then the four repros' entry points, each of which must launch its
   kernel, with kernel, plain, R4-, R1- and unfused (R1's kernel + cuBLAS)
   times;
12. R5 and R6: the head-pack kernel at K = 2, 4 and 8 heads a pack, one
   pass and two, 8 and 16 windows a CTA, vs plain (bf16 at Bw 2,880, f32
   with an f32 output, a ragged Bw, every odd head's scores 200 below in
   both types), bit-identical on a second launch; then the two repros'
   entry points, each of which must launch the kernel at every K it runs,
   with kernel, plain, out-projection-kernel and unfused times.

Any failure raises and the exit code is not 0.  The last two lines are the
kernel report and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX and nothing of the JAX package.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
FLAGSHIP_BATCH = 25
WINDOWS_PER_SAMPLE = 30           # 84x70 max-pooled to 42x35: 6x5 windows
# (name, heads, dim_head, dim, conditioned, windows, head-0 score offset)
ATTENTION_CASES = [
    ("flagship", 32, 32, 128, True, FLAGSHIP_BATCH * 12 * WINDOWS_PER_SAMPLE,
     0.0),
    ("heads3_uncond", 3, 16, 48, False, 600, 0.0),
    ("diverging", 32, 32, 128, True, 600, -200.0),
]
# max|kernel - plain| / max|plain|: f32 sums run in another order; bf16
# rounds at other points (the kernel keeps LayerNorm and softmax in f32)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}

TRAIN_BATCH = 4
TRAIN_WINDOWS = TRAIN_BATCH * 12 * WINDOWS_PER_SAMPLE      # 1,440
TRAIN_STEPS = 12
DROPOUT = 0.1
DROPOUT_SEED = 2 ** 30 + 12345                 # above 2**30, as seeds reach
# the training cases: (name, heads, dim_head, dim, conditioned, windows,
# head-0 score offset)
TRAIN_CASES = [
    ("flagship", 32, 32, 128, True, TRAIN_WINDOWS, 0.0),
    ("heads3_uncond", 3, 16, 48, False, 600, 0.0),
    ("diverging", 32, 32, 128, True, 600, -200.0),
]
# each gradient's max|kernel - plain| / max|plain|: f32 sums run in another
# order; bf16 is the bound tests/test_pallas_attention.py holds the TPU's
# fused backward to against the plain bf16 gradients
BWD_TOLERANCE = {"float32": 1e-4, "bfloat16": 6e-2}
GRAD_NAMES = ("dx", "dgamma_w", "dbeta_w", "dwqkv", "dwout", "dqg", "dkg",
              "dbias")


_START = time.perf_counter()


def phase(n, title):
    print(f"\n== phase {n}: {title} (at {time.perf_counter() - _START:.0f} s)",
          flush=True)


def attention_case(heads, dim_head, dim, conditioned, bw, offset, seed):
    """A window-attention layer and its inputs, all from a numpy seed."""
    import torch

    from vit_grid_model_tpu_torch.ops.attention import Attention

    rng = np.random.default_rng(seed)
    m = Attention(dim, cond_dim=2 if conditioned else None, heads=heads,
                  dim_head=dim_head, window_size=7)
    sd = {}
    for name, t in m.state_dict().items():
        if name.startswith("rel_pos_bias"):
            v = rng.standard_normal(t.shape)
            v[:, 0] += offset
        elif name.startswith(("norm", "q_norm", "k_norm")):
            v = rng.uniform(0.5, 1.5, t.shape)
        else:
            v = rng.uniform(-1, 1, t.shape) / np.sqrt(t.shape[-1])
        sd[name] = torch.from_numpy(v.astype(np.float32))
    m.load_state_dict(sd, strict=True)
    x = rng.standard_normal((bw, 53, dim)).astype(np.float32)
    cond = (rng.standard_normal((bw // WINDOWS_PER_SAMPLE, 2))
            .astype(np.float32) if conditioned else None)
    return m.eval(), x, cond


def kernel_vs_plain(dev):
    """Phase 2.  Returns the flagship bf16 case's error and both times."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    bias_idx = relative_position_indices(7, 4, device=dev)
    report = {}
    for name, heads, dh, dim, conditioned, bw, offset in ATTENTION_CASES:
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            m, x, cond = attention_case(heads, dh, dim, conditioned, bw,
                                        offset, SEED)
            m = m.to(dev, dtype)
            xt = torch.from_numpy(x).to(dev, dtype)
            ct = (None if cond is None
                  else torch.from_numpy(cond).to(dev, dtype))

            def run_kernel():
                return cuda_attn.window_attention(
                    m, xt, ct, bias_idx,
                    windows_per_sample=WINDOWS_PER_SAMPLE)

            def run_plain():
                return plain.attention(m, xt, ct, bias_idx,
                                       windows_per_sample=WINDOWS_PER_SAMPLE)

            with torch.inference_mode():
                ours = run_kernel()
                torch.cuda.synchronize()
                ref = run_plain()
                torch.cuda.synchronize()
                ours, ref = ours.float(), ref.float()
                if not bool(torch.isfinite(ours).all()):
                    raise AssertionError(f"{name} {dtype_name}: kernel "
                                         "output is not finite")
                err = (ours - ref).abs().max().item()
                scale = ref.abs().max().item()
                line = (f"{name:14s} {dtype_name:8s} Bw={bw:5d} "
                        f"max|d|={err:.3e} max|plain|={scale:.3e} "
                        f"rel={err / scale:.3e} (tol {tol:g})")
                if name == "flagship":
                    k_ms = cuda_ms(run_kernel)
                    p_ms = cuda_ms(run_plain)
                    line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
                    report[dtype_name] = (err, k_ms, p_ms)
                print(line, flush=True)
                if not err <= tol * scale:
                    raise AssertionError(f"{name} {dtype_name}: kernel "
                                         f"differs from plain by {err}")
            del m, xt, ct, ours, ref
            torch.cuda.empty_cache()
    return report


def whole_model(dev):
    """Phase 3: the shipped 12-hour model, one sample, f32, GPU vs CPU."""
    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.data.synthetic import DEFAULT_FEAT_INFOS
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    mean, std = DEFAULT_FEAT_INFOS["PM2.5"]
    cfg = shipped_12hr_model_config(pm25_mean=mean, pm25_std=std)
    model = seeded_model(cfg, SEED)
    rng = np.random.default_rng(SEED + 1)
    x = torch.from_numpy((rng.random((1, 25, 24, 82, 67)) * 50)
                         .astype(np.float32))
    ts = torch.from_numpy(np.stack(
        [np.full(25, 2023.0), np.full(25, 1.0), np.full(25, 15.0),
         np.arange(25) % 24], axis=-1)[None].astype(np.float32))
    with torch.inference_mode():
        t0 = time.perf_counter()
        cpu_out = model(x, ts)
        cpu_s = time.perf_counter() - t0
        gpu_model = seeded_model(cfg, SEED).to(dev)
        before = cuda_attn.launches
        gpu_out = gpu_model(x.to(dev), ts.to(dev))
        torch.cuda.synchronize()
        launched = cuda_attn.launches - before
    gpu_out = gpu_out.cpu()
    if tuple(gpu_out.shape) != (1, 12, 82, 67):
        raise AssertionError(f"output shape {tuple(gpu_out.shape)}")
    if not bool(torch.isfinite(gpu_out).all()):
        raise AssertionError("GPU forward is not finite")
    if launched != 2 * sum(cfg.depth_tuple):
        raise AssertionError(f"{launched} kernel launches in one forward")
    rel = ((gpu_out - cpu_out).abs().max() / cpu_out.abs().max()).item()
    print(f"MetNet3 12hr f32, 1 sample: max|gpu - cpu| / max|cpu| = "
          f"{rel:.3e} (tol 1e-3); max|out| = {cpu_out.abs().max().item():.3f}"
          f"; CPU forward {cpu_s:.1f} s; kernel launches {launched}",
          flush=True)
    if not rel <= 1e-3:
        raise AssertionError(f"GPU and CPU forwards differ: {rel}")


def main_path(card: str):
    """Phase 4: the --fast evaluation CLI over a synthetic tree."""
    from datetime import datetime

    import torch

    from vit_grid_model_tpu_torch.data import readers, synthetic
    from vit_grid_model_tpu_torch.cli import evaluation_vit as cli
    from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    # 100 hourly samples: four full batches of 25
    start, end = datetime(2023, 1, 10, 0), datetime(2023, 1, 14, 3)
    with tempfile.TemporaryDirectory(prefix="vgm_smoke_") as root:
        t0 = time.perf_counter()
        paths = synthetic.generate_tree(os.path.join(root, "tree"), start,
                                        end, prev_len=13, output_dim=12)
        readers.clear_caches()
        print(f"synthetic tree: {time.perf_counter() - t0:.1f} s", flush=True)
        log_dir = os.path.join(root, "logs")
        argv = ["--fast", "--batch_size", str(FLAGSHIP_BATCH),
                "--input_dim", "13", "--output_dim", "12", "--prev_len", "13",
                "--hidden_dim", "128", "--gpus", "0",
                "--data_path", paths["data_path"],
                "--sim_data_path", paths["sim_data_path"],
                "--analysis_data_path", paths["analysis_data_path"],
                "--model_name", "smoke", "--seed", str(SEED),
                "--test_start", start.strftime("%Y-%m-%dT%H"),
                "--test_end", end.strftime("%Y-%m-%dT%H"),
                "--log_dir", log_dir]
        timing = BatchTiming()
        cuda_attn.reset_launches()
        metrics = cli.main(argv, timing=timing)
        torch.cuda.synchronize()
        launches = cuda_attn.launches
        if cuda_attn.bwd_launches or cuda_attn.hash_launches:
            raise AssertionError("the evaluation ran a backward or dropout")
        with open(os.path.join(log_dir, "test_smoke.log")) as f:
            log = f.read()
    batches = len(timing.samples)
    layers = 1                                   # MaxViT depth (1,)
    print(f"batches {timing.samples}; kernel launches {launches} "
          f"(expected 2 x {layers} x {batches})", flush=True)
    if launches != 2 * layers * batches:
        raise AssertionError("the main path did not run every window "
                             "attention through the kernel")
    if timing.samples != [FLAGSHIP_BATCH] * 4:
        raise AssertionError(f"expected 4 full batches: {timing.samples}")
    summary = metrics.summary()
    for name in ("model", "persist", "sim_21h", "sim_avg"):
        for key in ("RMSE", "MAE", "R"):
            if not np.isfinite(summary[name][key]):
                raise AssertionError(f"{name} {key} = {summary[name][key]}")
    if "model RMSE:" not in log or "MultiAir CSI:" not in log:
        raise AssertionError("the evaluation log is incomplete")
    steady = sum(timing.samples[1:]) / sum(timing.seconds[1:])
    print(f"steady state (batches 2..{batches}): {steady:.2f} samples/s, "
          f"{steady * 12:.2f} fields/s; first batch "
          f"{timing.seconds[0]:.2f} s; card: {card}", flush=True)
    print("host seconds per batch, batches 2..: " + ", ".join(
        f"{k} {np.mean(v[1:]):.3f}" for k, v in timing.phases.items()),
        flush=True)
    return launches


def kernel_case(heads, dim_head, dim, conditioned, bw, offset, dev, dtype):
    """A layer from ``attention_case`` on the card: (module, x, cond, the
    kernels' inputs, a cotangent dy), all from numpy seeds."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices

    m, x, cond = attention_case(heads, dim_head, dim, conditioned, bw,
                                offset, SEED)
    m = m.to(dev, dtype)
    xt = torch.from_numpy(x).to(dev, dtype)
    ct = None if cond is None else torch.from_numpy(cond).to(dev, dtype)
    bias_idx = relative_position_indices(7, 4, device=dev)
    with torch.no_grad():
        k = cuda_attn.kernel_inputs(m, xt, ct, bias_idx, WINDOWS_PER_SAMPLE)
    dy = (np.random.default_rng(SEED + 7).standard_normal(x.shape)
          .astype(np.float32))
    return m, xt, ct, k, torch.from_numpy(dy).to(dev, dtype)


def bwd_errors(xt, k, dy, seed, rate):
    """The backward kernel against ``window_attention_bwd_reference``:
    {grad name: (max|kernel - plain|, max|plain|)}.  Raises on a value
    that is not finite and on a second launch that is not bit-identical."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    ours = cuda_attn.window_attention_bwd(xt, k, dy, seed, rate)
    again = cuda_attn.window_attention_bwd(xt, k, dy, seed, rate)
    ref = cuda_attn.window_attention_bwd_reference(xt, k, dy, seed, rate)
    torch.cuda.synchronize()
    errs = {}
    for name, a, a2, b in zip(GRAD_NAMES, ours, again, ref):
        if not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: the kernel's value is not finite")
        if not torch.equal(a, a2):
            raise AssertionError(f"{name}: two launches differ")
        a, b = a.float(), b.float()
        errs[name] = ((a - b).abs().max().item(), b.abs().max().item())
    return errs


def dropout_mask_check(dev):
    """Phase 2b: the CUDA keep mask against ``ops/dropout.py::keep_mask``.
    Returns (max|diff|, kernel ms, plain ms) at the flagship shape."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.dropout import keep_mask
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    report = None
    for heads in (32, 3):
        ours = cuda_attn.dropout_keep_mask(DROPOUT_SEED, TRAIN_WINDOWS, heads,
                                           53, DROPOUT, dev)
        ref = keep_mask(DROPOUT_SEED, TRAIN_WINDOWS, heads, 53, DROPOUT,
                        device=dev)
        torch.cuda.synchronize()
        equal = torch.equal(ours, ref)
        dropped = (ours == 0).float().mean(dim=(0, 2, 3))
        worst = (dropped - DROPOUT).abs().max().item()
        err = (ours - ref).abs().max().item()
        line = (f"keep mask heads={heads:2d} Bw={TRAIN_WINDOWS} seed="
                f"{DROPOUT_SEED}: bit-equal {equal}; dropped share per head "
                f"{dropped.min().item():.4f}..{dropped.max().item():.4f} "
                f"(rate {DROPOUT})")
        if heads == 32:
            k_ms = cuda_ms(lambda: cuda_attn.dropout_keep_mask(
                DROPOUT_SEED, TRAIN_WINDOWS, heads, 53, DROPOUT, dev))
            p_ms = cuda_ms(lambda: keep_mask(
                DROPOUT_SEED, TRAIN_WINDOWS, heads, 53, DROPOUT, device=dev))
            line += f"  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
            report = (err, k_ms, p_ms)
        print(line, flush=True)
        if not equal:
            raise AssertionError(f"heads {heads}: the masks differ by {err}")
        if not worst <= 0.01:
            raise AssertionError(f"heads {heads}: dropped share off the rate "
                                 f"by {worst}")
        del ours, ref
    torch.cuda.empty_cache()
    return report


def dropout_forward(dev):
    """Phase 2c: the forward kernel at rate 0.1 against the plain version
    given the same keep mask."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.dropout import keep_mask
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices

    bias_idx = relative_position_indices(7, 4, device=dev)
    for name, heads, dh, dim, conditioned, bw, offset in TRAIN_CASES[:2]:
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            m, xt, ct, _, _ = kernel_case(heads, dh, dim, conditioned, bw,
                                          offset, dev, dtype)
            with torch.inference_mode():
                ours = cuda_attn.window_attention(
                    m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE,
                    seed=DROPOUT_SEED, dropout_rate=DROPOUT).float()
                mask = keep_mask(DROPOUT_SEED, bw, heads, 53, DROPOUT,
                                 device=dev)
                ref = plain.attention(
                    m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE,
                    dropout_mask=mask).float()
                torch.cuda.synchronize()
            if not bool(torch.isfinite(ours).all()):
                raise AssertionError(f"{name} {dtype_name}: not finite")
            err = (ours - ref).abs().max().item()
            scale = ref.abs().max().item()
            print(f"{name:14s} {dtype_name:8s} Bw={bw:5d} rate {DROPOUT}: "
                  f"max|d|={err:.3e} rel={err / scale:.3e} (tol {tol:g})",
                  flush=True)
            if not err <= tol * scale:
                raise AssertionError(f"{name} {dtype_name}: the kernel with "
                                     f"dropout differs from plain by {err}")
            del m, xt, ct, ours, ref, mask
            torch.cuda.empty_cache()


def backward_vs_plain(dev):
    """Phase 2d: the backward kernel against autograd through the plain
    forward.  Returns {dtype: (max abs err over the grads, kernel ms, plain
    ms, fwd+bwd kernel ms, fwd+bwd plain ms)} at the flagship shape, rate
    0.1."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    report = {}
    for name, heads, dh, dim, conditioned, bw, offset in TRAIN_CASES:
        for dtype_name, tol in BWD_TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            _, xt, _, k, dy = kernel_case(heads, dh, dim, conditioned, bw,
                                          offset, dev, dtype)
            for rate in (0.0, DROPOUT):
                errs = bwd_errors(xt, k, dy, DROPOUT_SEED, rate)
                worst = max(e / s if s else e for e, s in errs.values())
                line = (f"{name:14s} {dtype_name:8s} Bw={bw:5d} rate {rate}: "
                        f"worst rel {worst:.3e} (tol {tol:g}); " + " ".join(
                            f"{g}={e / s if s else e:.1e}"
                            for g, (e, s) in errs.items()))
                if name == "flagship" and rate == DROPOUT:
                    args = (xt, k, dy, DROPOUT_SEED, rate)
                    bwd = cuda_attn.window_attention_bwd
                    ref = cuda_attn.window_attention_bwd_reference
                    b_ms = cuda_ms(lambda: bwd(*args), iters=5)
                    r_ms = cuda_ms(lambda: ref(*args), iters=5)
                    both_ms = cuda_ms(lambda: (
                        cuda_attn.window_attention_fwd(xt, k, DROPOUT_SEED,
                                                       rate),
                        bwd(*args)), iters=5)
                    line += (f"\n  backward: kernel {b_ms:.3f} ms  plain "
                             f"{r_ms:.3f} ms (autograd through the plain "
                             f"forward); forward + backward: kernel "
                             f"{both_ms:.3f} ms  plain {r_ms:.3f} ms")
                    report[dtype_name] = (max(e for e, _ in errs.values()),
                                          b_ms, r_ms, both_ms)
                print(line, flush=True)
                bad = [g for g, (e, s) in errs.items() if not e <= tol * s]
                if bad:
                    raise AssertionError(f"{name} {dtype_name} rate {rate}: "
                                         f"{bad} differ from plain: {errs}")
            del xt, k, dy
            torch.cuda.empty_cache()
    return report


def whole_model_grads(dev):
    """Phase 5: the 12-hour model at full width, B=1, dropout 0, in
    training mode: one Focal-R loss and its parameter gradients in f32 on
    the GPU (forward and backward kernels) against the CPU (plain version)
    in f64.

    The gradients of the resnet stem are ill-conditioned in f32: the CPU's
    own f32 gradients differ from its f64 ones by up to ~5e-3 of a
    parameter's max|grad| (measured on this configuration, and printed
    below).  So the reference is the CPU in f64, and each parameter's
    gradient is held to 1e-2 of its max|grad|; the loss and the global
    gradient norm to 1e-4."""
    import dataclasses
    import re

    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.data.synthetic import DEFAULT_FEAT_INFOS
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.train.losses import focal_r_loss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mean, std = DEFAULT_FEAT_INFOS["PM2.5"]
    cfg = dataclasses.replace(
        shipped_12hr_model_config(pm25_mean=mean, pm25_std=std), dropout=0.0)
    rng = np.random.default_rng(SEED + 2)
    x = torch.from_numpy((rng.random((1, 25, 24, 82, 67)) * 50)
                         .astype(np.float32))
    ts = torch.from_numpy(np.stack(
        [np.full(25, 2023.0), np.full(25, 1.0), np.full(25, 15.0),
         np.arange(25) % 24], axis=-1)[None].astype(np.float32))
    targets = torch.from_numpy((rng.random((1, 12, 82, 67)) * 60)
                               .astype(np.float32))

    def run(device, dtype=torch.float32):
        model = seeded_model(cfg, SEED).to(device, dtype).train()
        params = list(model.parameters())
        preds = model(x.to(device, dtype), ts.to(device), bn_stats=[])
        loss = focal_r_loss(preds, targets.to(device))
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        names = [n for n, _ in model.named_parameters()]
        return loss.item(), {n: None if g is None else g.detach().cpu()
                             .double() for n, g in zip(names, grads)}

    def compare(grads, ref):
        """(worst relative error and its parameter, the parameters whose
        reference gradient is zero up to rounding)."""
        # a conv bias that feeds a batch-statistics BatchNorm has a
        # gradient of zero (the BN removes the batch mean): below 1e-6 of
        # the norm in the reference, it must stay below 1e-5 of it
        zero = 1e-6 * norm(ref)
        worst, zeros = (0.0, None), []
        for name, r in ref.items():
            g = grads[name]
            if (r is None) != (g is None):
                raise AssertionError(f"{name}: gradient in one run only")
            if r is None:
                continue
            if not bool(torch.isfinite(g).all()):
                raise AssertionError(f"{name}: gradient is not finite")
            scale = r.abs().max().item()
            if scale < zero:
                zeros.append(name)
                if not g.abs().max().item() < 10 * zero:
                    raise AssertionError(f"{name}: not zero in this run")
                continue
            worst = max(worst, ((g - r).abs().max().item() / scale, name))
        return worst, zeros

    def norm(grads):
        return torch.sqrt(sum(t.square().sum() for t in grads.values()
                              if t is not None)).item()

    t0 = time.perf_counter()
    ref_loss, ref_grads = run(torch.device("cpu"), torch.float64)
    cpu_s = time.perf_counter() - t0
    _, cpu32_grads = run(torch.device("cpu"))
    cuda_attn.reset_launches()
    gpu_loss, gpu_grads = run(dev)
    torch.cuda.synchronize()
    counts = (cuda_attn.launches, cuda_attn.bwd_launches)
    layers = sum(cfg.depth_tuple)
    if counts != (2 * layers, 2 * layers):
        raise AssertionError(f"kernel launches (fwd, bwd) {counts}, expected "
                             f"{2 * layers} each")
    loss_rel = abs(gpu_loss - ref_loss) / abs(ref_loss)
    norm_rel = abs(norm(gpu_grads) - norm(ref_grads)) / norm(ref_grads)
    (worst, worst_name), zeros = compare(gpu_grads, ref_grads)
    (floor, floor_name), _ = compare(cpu32_grads, ref_grads)
    attn = {n: g for n, g in ref_grads.items()
            if re.match(r"vit\.layers\.\d+\.[12]\.", n)}
    (attn_worst, attn_name), _ = compare(gpu_grads, attn)
    print(f"MetNet3 12hr, B=1, training mode, dropout 0, GPU f32 vs CPU f64:"
          f" loss {gpu_loss:.6f} vs {ref_loss:.6f} (rel {loss_rel:.2e}, tol "
          f"1e-4); global grad norm rel {norm_rel:.2e} (tol 1e-4); worst "
          f"parameter grad rel {worst:.2e} ({worst_name}, tol 1e-2); in the "
          f"window-attention layers {attn_worst:.2e} ({attn_name}); the CPU "
          f"in f32 vs f64: {floor:.2e} ({floor_name}); zero up to rounding in"
          f" both: {zeros}; kernel launches fwd {counts[0]} bwd {counts[1]};"
          f" CPU f64 forward + backward {cpu_s:.1f} s", flush=True)
    if not (loss_rel <= 1e-4 and norm_rel <= 1e-4 and worst <= 1e-2):
        raise AssertionError("GPU and CPU gradients differ")


def train_path(card: str):
    """Phase 6: the --fast training CLI over a synthetic tree, 12 steps at
    batch 4 with dropout 0.1.  Returns the kernels' launch counts."""
    import re

    import torch

    from vit_grid_model_tpu_torch.cli import train_vit as cli
    from vit_grid_model_tpu_torch.core.weights import (
        load_reference_checkpoint, seeded_model)
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    with tempfile.TemporaryDirectory(prefix="vgm_train_") as root:
        ckpt_dir = os.path.join(root, "check_points")
        argv = ["--fast", "--synthetic", "--batch_size", str(TRAIN_BATCH),
                "--steps", str(TRAIN_STEPS), "--checkpoint_every",
                str(TRAIN_STEPS), "--log_every", "1", "--gpus", "0",
                "--dropout", str(DROPOUT), "--seed", str(SEED),
                "--train_start", "2023-01-10T00",
                "--train_end", "2023-01-12T23",
                "--synthetic_root", os.path.join(root, "tree"),
                "--checkpoint_dir", ckpt_dir, "--model_name", "smoke"]
        lines, seconds = [], []

        def log(line):
            print(line, flush=True)
            lines.append(line)

        cuda_attn.reset_launches()
        state = cli.main(argv, step_seconds=seconds, log=log)
        torch.cuda.synchronize()
        counts = {"window_attention_fwd": cuda_attn.launches,
                  "window_attention_bwd": cuda_attn.bwd_launches,
                  "dropout_keep_mask": cuda_attn.hash_launches}
        cfg = state.model.cfg
        eval_model = load_reference_checkpoint(
            os.path.join(ckpt_dir, "smoke.pkt"), cfg)
        trained = {k: v.detach().cpu() for k, v in
                   state.model.state_dict().items()}
    layers = sum(cfg.depth_tuple)
    want = 2 * layers * TRAIN_STEPS
    print(f"kernel launches {counts} (expected fwd = bwd = 2 x {layers} x "
          f"{TRAIN_STEPS} = {want}, dropout hash in both: {2 * want})",
          flush=True)
    if (counts["window_attention_fwd"], counts["window_attention_bwd"],
            counts["dropout_keep_mask"]) != (want, want, 2 * want):
        raise AssertionError("the training path did not run every window "
                             "attention through the kernels")
    losses = [float(v) for v in re.findall(r"loss=(\S+)", "\n".join(lines))]
    if len(losses) != TRAIN_STEPS or not np.all(np.isfinite(losses)):
        raise AssertionError(f"logged losses: {losses}")
    init = seeded_model(cfg, SEED).state_dict()
    moved = [k for k, _ in state.model.named_parameters()
             if not torch.equal(trained[k], init[k])]
    if len(moved) == 0:
        raise AssertionError("no parameter changed")
    for k, v in eval_model.state_dict().items():
        if not torch.equal(v, trained[k].to(v.dtype)):
            raise AssertionError(f"{k}: the .pkt does not hold the trained "
                                 "state")
    steady = float(np.mean(seconds[2:]))
    print(f"steady state (steps 3..{TRAIN_STEPS}): {steady * 1e3:.1f} ms/step"
          f", {TRAIN_BATCH / steady:.2f} samples/s at batch {TRAIN_BATCH} "
          f"(host clock, batch wait included); first step {seconds[0]:.2f} s"
          f"; {len(moved)} of {len(list(state.model.parameters()))} "
          f"parameters moved; the .pkt loads into the eval model; card: "
          f"{card}", flush=True)
    return counts


# R15 comparison cases: (name, samples, H, W, C, dtype, samples per block);
# C = 128 is the flagship block (hidden 512, SE 128), C = 32 the small
# instantiation (hidden 128, SE 32); 9 x 7 and 5 samples are odd in every
# tiled axis
MBCONV_CASES = [
    ("repro BN=384", 384, 42, 35, 128, "bfloat16", 1),
    ("repro BN=384", 384, 42, 35, 128, "bfloat16", 4),
    ("flagship eval BN=300", 300, 42, 35, 128, "bfloat16", 1),
    ("f32 BN=8", 8, 42, 35, 128, "float32", 1),
    ("f32 BN=8", 8, 42, 35, 128, "float32", 4),
    ("small odd 9x7", 5, 9, 7, 32, "float32", 1),
    ("small odd 9x7", 5, 9, 7, 32, "float32", 4),
    ("small odd 9x7", 5, 9, 7, 32, "bfloat16", 1),
    ("small odd 9x7", 5, 9, 7, 32, "bfloat16", 4),
]


def kernel_errors(ours, again, ref, what):
    """(max|ours - ref|, max|ref|) in f32 of a kernel's output against its
    plain version's.  Raises on a value that is not finite and on a second
    launch (``again``) that is not bit-identical."""
    import torch

    if not bool(torch.isfinite(ours.float()).all()):
        raise AssertionError(f"{what}: the kernel's value is not finite")
    if not torch.equal(ours, again):
        raise AssertionError(f"{what}: two launches differ")
    ours, ref = ours.float(), ref.float()
    return (ours - ref).abs().max().item(), ref.abs().max().item()


def mbconv_errors(x, ops, spb):
    """The fused MBConv kernel against its plain version: see
    ``kernel_errors``."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda.mbconv import fused_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import fused_mbconv_reference

    with torch.inference_mode():
        ours = fused_mbconv(x, ops, samples_per_block=spb)
        again = fused_mbconv(x, ops, samples_per_block=spb)
        ref = fused_mbconv_reference(x, ops)
        torch.cuda.synchronize()
    return kernel_errors(ours, again, ref, "fused MBConv")


def mbconv_vs_plain(dev):
    """Phase 7a: the R15 kernel against its plain version on the card, on
    the repro harness's block and on the 12-hour model's own layer-0 MBConv
    (which has no residual: the fused form computes block(x) + x).
    Returns max|kernel - plain| at BN 384, bf16, one sample per block."""
    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    report = None
    model_block = seeded_model(shipped_12hr_model_config(22.5, 15.5),
                               SEED).vit.layers[0][0]
    cases = [c + ("repro",) for c in MBCONV_CASES] + [
        ("12hr model layer 0", 8, 42, 35, 128, "bfloat16", 1, "model")]
    for name, n, h, w, c, dtype_name, spb, source in cases:
        dtype = getattr(torch, dtype_name)
        block = model_block if source == "model" else repro.block(dim=c,
                                                                  seed=SEED)
        ops = tuple(t.to(dev) for t in mbconv_kernel_operands(block))
        x = repro.inputs(n, h, w, c, SEED + 1, dtype, dev)
        err, scale = mbconv_errors(x, ops, spb)
        tol = TOLERANCE[dtype_name]
        print(f"{name:22s} {dtype_name:8s} {n:3d}x{h}x{w}x{c} spb={spb}: "
              f"max|d|={err:.3e} max|plain|={scale:.3e} rel={err / scale:.3e}"
              f" (tol {tol:g}); second launch bit-identical", flush=True)
        if not err <= tol * scale:
            raise AssertionError(f"{name} {dtype_name} spb={spb}: the fused "
                                 f"MBConv differs from plain by {err}")
        if (n, dtype_name, spb, source) == (384, "bfloat16", 1, "repro"):
            report = err
        del x, ops
        torch.cuda.empty_cache()
    return report


def mbconv_share(dev, card):
    """Phase 7c: the stock MBConv's share of the B=25 --fast forward's
    kernel time: the 12-hour model in bf16 with the fused stem and NHWC
    input, and its MBConv alone on the input it sees there."""
    import dataclasses

    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.repros import common

    cfg = dataclasses.replace(shipped_12hr_model_config(22.5, 15.5),
                              compute_dtype="bfloat16", fuse_lead_stem=True,
                              nhwc_input=True)
    model = seeded_model(cfg, SEED).to(dev, torch.bfloat16)
    rng = np.random.default_rng(SEED + 3)
    x = torch.from_numpy((rng.random((FLAGSHIP_BATCH, 84, 70, 600)) * 50)
                         .astype(np.float32)).to(dev)
    ts = torch.from_numpy(np.stack(
        [np.full((FLAGSHIP_BATCH, 25), 2023.0), np.ones((FLAGSHIP_BATCH, 25)),
         np.full((FLAGSHIP_BATCH, 25), 15.0),
         np.tile(np.arange(25) % 24, (FLAGSHIP_BATCH, 1))],
        axis=-1).astype(np.float32)).to(dev)
    block = model.vit.layers[0][0]
    seen = []
    hook = block.register_forward_pre_hook(
        lambda mod, args: seen.append(args[0]))
    with torch.inference_mode():
        model(x, ts)
        hook.remove()
        whole = sum(common.kernel_ms(lambda: model(x, ts)).values())
        part = sum(common.kernel_ms(lambda: block(seen[0])).values())
    if not part > 0:
        raise AssertionError("torch.profiler recorded no kernel time")
    print(f"stock MBConv ({tuple(seen[0].shape)}, bf16): {part:.3f} ms of "
          f"the B={FLAGSHIP_BATCH} --fast forward's {whole:.3f} ms of kernel "
          f"time = {part / whole:.1%} (torch.profiler); card: {card}",
          flush=True)


# R1/R14 comparison cases: (name, Bw, n, dim, heads, dim_head, dtype); Bw 37
# leaves a ragged last tile at 8 and at 16 windows a CTA
PERHEAD_CASES = [
    ("repro Bw=2,880", 2880, 56, 128, 32, 32, "bfloat16"),
    ("f32 Bw=40", 40, 56, 128, 32, 32, "float32"),
    ("ragged Bw=37", 37, 56, 128, 32, 32, "bfloat16"),
    ("3 heads x 16", 37, 56, 48, 3, 16, "float32"),
    ("3 heads x 16", 37, 56, 48, 3, 16, "bfloat16"),
]


def perhead_vs_plain(dev):
    """Phase 8a: the R1/R14 kernel against its plain version at 8 and 16
    windows a CTA.  Returns {windows a CTA: max|kernel - plain|} at Bw
    2,880 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops.attention_variants import (
        perhead_qkv_attention)
    from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
        perhead_attention)
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    report = {}
    for name, bw, n, dim, heads, dh, dtype_name in PERHEAD_CASES:
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias = repro.inputs(bw, dtype, dev, SEED, n=n, dim=dim,
                                     heads=heads, dim_head=dh)
        with torch.inference_mode():
            ref = perhead_qkv_attention(x, wqkv, bias, heads, dh)
            for wpc in repro.WINDOWS_PER_CTA:
                ours = perhead_attention(x, wqkv, bias, wpc)
                again = perhead_attention(x, wqkv, bias, wpc)
                torch.cuda.synchronize()
                err, scale = kernel_errors(ours, again, ref,
                                             f"{name} wpc={wpc}")
                tol = TOLERANCE[dtype_name]
                print(f"{name:16s} {dtype_name:8s} Bw={bw:4d} wpc={wpc:2d}: "
                      f"max|d|={err:.3e} max|plain|={scale:.3e} "
                      f"rel={err / scale:.3e} (tol {tol:g}); second launch "
                      "bit-identical", flush=True)
                if not err <= tol * scale:
                    raise AssertionError(f"{name} {dtype_name} wpc={wpc}: "
                                         f"kernel differs from plain by {err}")
                if bw == 2880:
                    report[wpc] = err
        del x, wqkv, bias, ref, ours, again
        torch.cuda.empty_cache()
    return report


def repro_path(module, wrappers, counts):
    """Phases 7b-12b: a repro's entry point, the launch counts of
    its kernels' wrapper modules set to 0 just before it.  Returns (the
    counts ``counts()`` reads just after, the repro's results); raises when
    one of them is 0."""
    import torch

    for wrapper in wrappers:
        wrapper.reset_launches()
    results = module.main()
    torch.cuda.synchronize()
    launched = counts()
    print(f"{module.__name__} launched its kernel: {launched}", flush=True)
    if not all(launched.values()):
        raise AssertionError(f"{module.__name__} did not launch every "
                             f"kernel setting: {launched}")
    return launched, results


# R7 comparison cases: (name, S, dtype, head-0 bias offset); the offset
# puts head 0's scores ~200 below head 1's in both attentions
LAYER_CASES = [
    ("repro S=96", 96, "bfloat16", 0.0),
    ("flagship S=300", 300, "bfloat16", 0.0),
    ("f32 S=2", 2, "float32", 0.0),
    ("diverging S=4", 4, "bfloat16", -200.0),
    ("diverging S=4", 4, "float32", -200.0),
]


def layer_vs_plain(dev):
    """Phase 9a: the R7 megakernel against its plain version.  Returns
    max|kernel - plain| at S = 300 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops.attention_variants import (
        maxvit_layer_attention as plain_layer)
    from vit_grid_model_tpu_torch.ops.cuda.attention_variants import (
        maxvit_layer_attention)
    from vit_grid_model_tpu_torch.repros import megakernel as repro

    report = None
    for name, s, dtype_name, offset in LAYER_CASES:
        dtype = getattr(torch, dtype_name)
        block_attn, grid_attn, regs = repro.layer(SEED)
        for m in (block_attn, grid_attn):
            with torch.no_grad():
                m.rel_pos_bias.weight[:, 0] += offset
        x, cond = repro.inputs(s, dtype, dev, SEED + 3)
        r, ops_b, ops_g = repro.layer_operands(
            block_attn.to(dev), grid_attn.to(dev), regs.to(dev), cond, dtype)
        with torch.inference_mode():
            ref = plain_layer(x, r, ops_b, ops_g, repro.WIN)
            ours = maxvit_layer_attention(x, r, ops_b, ops_g, repro.WIN)
            again = maxvit_layer_attention(x, r, ops_b, ops_g, repro.WIN)
            torch.cuda.synchronize()
        err, scale = kernel_errors(ours, again, ref, name)
        tol = TOLERANCE[dtype_name]
        print(f"{name:16s} {dtype_name:8s}: max|d|={err:.3e} max|plain|="
              f"{scale:.3e} rel={err / scale:.3e} (tol {tol:g}); second "
              "launch bit-identical", flush=True)
        if not err <= tol * scale:
            raise AssertionError(f"{name} {dtype_name}: the megakernel "
                                 f"differs from plain by {err}")
        if (s, dtype_name) == (300, "bfloat16"):
            report = err
        del x, ref, ours, again, ops_b, ops_g
        torch.cuda.empty_cache()
    return report


# R4, R10, R9 and R11 comparison cases: (name, Bw, n, dim, heads, dim_head,
# dtype, head-0 bias offset); Bw 37 leaves a ragged last tile of 8 windows,
# and -200 puts head 0's scores ~200 below head 1's
VARIANT_CASES = [
    ("repro Bw=2,880", 2880, 56, 128, 32, 32, "bfloat16", 0.0),
    ("f32 Bw=40", 40, 56, 128, 32, 32, "float32", 0.0),
    ("ragged Bw=37", 37, 56, 128, 32, 32, "bfloat16", 0.0),
    ("3 heads x 16", 37, 56, 48, 3, 16, "float32", 0.0),
    ("3 heads x 16", 37, 56, 48, 3, 16, "bfloat16", 0.0),
    ("diverging", 40, 56, 128, 32, 32, "bfloat16", -200.0),
    ("diverging", 40, 56, 128, 32, 32, "float32", -200.0),
]


def variant_routes(x, wqkv, bias, heads, dh):
    """Phase 10a's routes on one input: {name: (kernel call, plain call)}.
    R11's core runs on the staged operands of its plain version."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    qkv = torch.matmul(x.float(), wqkv.float())
    qn, kn, v = plain.stage_headmajor(qkv, heads, dh, x.dtype)
    w4 = weight4(wqkv, heads)

    def r1():
        return plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)

    return {
        "headmajor_attention": (
            lambda: av.headmajor_attention(x, wqkv, bias), r1),
        "stacked_softmax_attention": (
            lambda: av.stacked_softmax_attention(x, wqkv, bias), r1),
        "perhead_weight_attention": (
            lambda: av.perhead_weight_attention(x, w4, bias), r1),
        "staged_attention_core": (
            lambda: av.staged_attention_core(qn, kn, v, bias),
            lambda: plain.staged_headmajor_core(qn, kn, v, bias)),
        "staged_attention": (
            lambda: av.staged_attention(x, wqkv, bias),
            lambda: plain.staged_headmajor_attention(x, wqkv, bias, heads,
                                                     dh)),
    }


def variants_vs_plain(dev):
    """Phase 10a: R4's, R10's and R11's kernels, R11 whole and R9's route
    against their plain versions.  Returns {route: max|kernel - plain|} at
    Bw 2,880 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    report = {}
    for name, bw, n, dim, heads, dh, dtype_name, offset in VARIANT_CASES:
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias = repro.inputs(bw, dtype, dev, SEED, n=n, dim=dim,
                                     heads=heads, dim_head=dh)
        bias[0] += offset
        tol = TOLERANCE[dtype_name]
        with torch.inference_mode():
            for route, (kernel, plain) in variant_routes(x, wqkv, bias, heads,
                                                         dh).items():
                ref = plain()
                ours = kernel()
                again = kernel()
                torch.cuda.synchronize()
                err, scale = kernel_errors(ours, again, ref, f"{name} {route}")
                print(f"{name:15s} {dtype_name:8s} Bw={bw:4d} {route:26s}: "
                      f"max|d|={err:.3e} max|plain|={scale:.3e} "
                      f"rel={err / scale:.3e} (tol {tol:g}); second launch "
                      "bit-identical", flush=True)
                if not err <= tol * scale:
                    raise AssertionError(f"{name} {dtype_name} {route}: "
                                         f"kernel differs from plain by {err}")
                if bw == 2880:
                    report[route] = err
                del ref, ours, again
        del x, wqkv, bias
        torch.cuda.empty_cache()
    return report


def outproj_routes(x, wqkv, bias, wout, heads, dh, dtype_name, bw,
                   diverging):
    """Phase 11a's routes of the out-projection kernel on one input:
    {name: (kernel call, plain call)}.  ``ws_2pass_pwout`` runs on every
    case; the other R12/R13 variants on the repro's Bw 2,880 in bf16 and Bw
    40 in f32; R2's casts on Bw 2,880 and the diverging cases.  f32 inputs
    give an f32 output (held to 1e-4), bf16 the repros' bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import bf16_mxu_operands as r2
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    out_dtype = getattr(torch, dtype_name)
    w4 = weight4(wqkv, heads)
    routes = {}

    def add(name, w, two_pass, perhead, score=False, agg=False):
        routes[name] = (
            lambda: av.outproj_attention(
                x, w, bias, wout, two_pass=two_pass, perhead_wout=perhead,
                bf16_score=score, bf16_agg=agg, out_dtype=out_dtype),
            lambda: plain.outproj_attention(
                x, wqkv, bias, wout, heads, dh, bf16_score=score,
                bf16_agg=agg, out_dtype=out_dtype))

    add("ws_2pass_pwout", w4, True, True)
    if (bw, dtype_name) in (VARIANT_CASES[0][1:2] + ("bfloat16",),
                            (40, "float32")):
        for name, (r9, two_pass, perhead) in ws.VARIANTS.items():
            if name != "ws_2pass_pwout":
                add(name, w4 if r9 else wqkv, two_pass, perhead)
    if bw == VARIANT_CASES[0][1] or diverging:
        for name, (score, agg) in r2.CASTS.items():
            if score or agg:
                add(name, w4, True, True, score, agg)
    return routes


def crosshead_outproj_vs_plain(dev):
    """Phase 11a: R3's kernel and the out-projection kernel (R12, R13, R2's
    casts, R8's n_pad and windows a CTA) against their plain versions.
    Returns {route: max|kernel - plain|} at Bw 2,880 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
    from vit_grid_model_tpu_torch.repros import npad_and_kfold as r8
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    report = {}
    repro_bw = VARIANT_CASES[0][1]   # the repro's Bw 2,880

    def check(label, route, kernel, ref_call, tol, bw):
        ref = ref_call()
        ours = kernel()
        again = kernel()
        torch.cuda.synchronize()
        err, scale = kernel_errors(ours, again, ref, f"{label} {route}")
        print(f"{label} {route:30s}: max|d|={err:.3e} max|plain|={scale:.3e} "
              f"rel={err / scale:.3e} (tol {tol:g}); second launch "
              "bit-identical", flush=True)
        if not err <= tol * scale:
            raise AssertionError(f"{label} {route}: kernel differs from "
                                 f"plain by {err}")
        if bw == repro_bw:
            report[route] = err

    for name, bw, n, dim, heads, dh, dtype_name, offset in VARIANT_CASES:
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias, wout = ws.inputs(bw, dtype, dev, SEED, n=n, dim=dim,
                                        heads=heads, dim_head=dh,
                                        out_dim=dim)
        bias[0] += offset
        label = f"{name:15s} {dtype_name:8s} Bw={bw:4d}"
        tol = TOLERANCE[dtype_name]
        with torch.inference_mode():
            check(label, "crosshead_norm_attention",
                  lambda: av.crosshead_norm_attention(x, wqkv, bias),
                  lambda: plain.perhead_qkv_attention(x, wqkv, bias, heads,
                                                      dh), tol, bw)
            for route, (kernel, ref_call) in outproj_routes(
                    x, wqkv, bias, wout, heads, dh, dtype_name, bw,
                    offset != 0).items():
                check(label, route, kernel, ref_call, tol, bw)
        del x, wqkv, bias, wout
        torch.cuda.empty_cache()
    for n_pad in r8.N_PADS:
        x, wqkv, bias, wout = ws.inputs(repro_bw, torch.bfloat16, dev, SEED,
                                        n=n_pad)
        w4 = weight4(wqkv)
        with torch.inference_mode():
            for k in r8.KFOLDS:
                check(f"R8 n_pad={n_pad} bfloat16 Bw={repro_bw}",
                      f"npad{n_pad}_kfold{k}",
                      lambda: av.outproj_attention(
                          x, w4, bias, wout, two_pass=True, perhead_wout=True,
                          windows_per_cta=r8.BLK * k),
                      lambda: plain.outproj_attention(
                          x, wqkv, bias, wout, r1.HEADS, r1.DIM_HEAD),
                      TOLERANCE["bfloat16"], repro_bw)
        del x, wqkv, bias, wout, w4
        torch.cuda.empty_cache()
    return report


# R5 and R6 comparison cases: (name, Bw, dtype, odd heads' bias offset); Bw
# 37 leaves a ragged last tile at 8 and at 16 windows a CTA, and -200 puts
# every odd head's scores ~200 below its even partner's, where the repros'
# joint max gives NaN
HEADPACK_CASES = [
    ("repro Bw=2,880", 2880, "bfloat16", 0.0),
    ("f32 Bw=40", 40, "float32", 0.0),
    ("ragged Bw=37", 37, "bfloat16", 0.0),
    ("diverging", 40, "bfloat16", -200.0),
    ("diverging", 40, "float32", -200.0),
]
HEADPACK_K = (2, 4, 8)   # R5's pair, R6's quad and oct


def headpack_vs_plain(dev):
    """Phase 12a: R5/R6's head-pack kernel against the plain version at K =
    2, 4 and 8 heads a pack, in one pass and two, at 8 and 16 windows a CTA;
    f32 inputs give an f32 output (held to 1e-4), bf16 the repros' bf16.
    Returns {K: max|kernel - plain|} at Bw 2,880 in bf16, two passes, 8
    windows a CTA (the repros' main build)."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws

    report = {}
    for name, bw, dtype_name, offset in HEADPACK_CASES:
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias, wout = ws.inputs(bw, dtype, dev, SEED)
        bias[1::2] += offset
        tol = TOLERANCE[dtype_name]
        with torch.inference_mode():
            ref = plain.outproj_attention(x, wqkv, bias, wout, r1.HEADS,
                                          r1.DIM_HEAD, out_dtype=dtype)
            for k in HEADPACK_K:
                for two_pass in (True, False):
                    for wpc in (8, 16):
                        def call():
                            return av.headpack_attention(
                                x, wqkv, bias, wout, k_pack=k,
                                two_pass=two_pass, windows_per_cta=wpc,
                                out_dtype=dtype)

                        ours, again = call(), call()
                        torch.cuda.synchronize()
                        what = (f"{name:15s} {dtype_name:8s} Bw={bw:4d} K={k} "
                                f"{'2' if two_pass else '1'}pass wpc={wpc:2d}")
                        err, scale = kernel_errors(ours, again, ref, what)
                        print(f"{what}: max|d|={err:.3e} max|plain|="
                              f"{scale:.3e} rel={err / scale:.3e} (tol "
                              f"{tol:g}); second launch bit-identical",
                              flush=True)
                        if not err <= tol * scale:
                            raise AssertionError(f"{what}: kernel differs "
                                                 f"from plain by {err}")
                        if (bw, two_pass, wpc) == (2880, True, 8):
                            report[k] = err
                        del ours, again
        del x, wqkv, bias, wout, ref
        torch.cuda.empty_cache()
    return report


def attention_bound_ms(bw, n, dim, heads, dh, item, backward=False):
    """(least ms, what bounds it) of the window attention at this shape: its
    products' operations (qkv, scores, P.v, out-projection; the backward
    recomputes the forward and runs eight more) at the bf16 tensor-core
    peak, against x and y (and dy, dx) moved once."""
    import torch

    from vit_grid_model_tpu_torch.repros.common import bound_ms

    fwd = 2 * n * dim * 3 * heads * dh + 4 * heads * n * n * dh \
        + 2 * n * heads * dh * dim
    bwd = 2 * 2 * n * dim * heads * dh + 4 * 2 * heads * n * n * dh \
        + 2 * 2 * n * dim * 3 * heads * dh
    ops = bw * (fwd + (bwd if backward else 0))
    moved = bw * n * dim * item * (4 if backward else 2)
    return bound_ms(ops, moved, torch.bfloat16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase(0, "device")
    from vit_grid_model_tpu_torch.data import native
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants, library
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.repros import (
        baseline_perhead as repro_perhead, fused_mbconv as repro,
        headmajor_batched as repro_r4, megakernel as repro_mega,
        perhead_weight_gemm as repro_r9, stacked_softmax as repro_r10,
        staged_headmajor as repro_r11, crosshead_rmsnorm_gemm as repro_r3,
        weightsliced_variants as repro_ws, bf16_mxu_operands as repro_r2,
        npad_and_kfold as repro_r8, headpair_lanepack as repro_r5,
        headquad_lanepack as repro_r6)
    from vit_grid_model_tpu_torch.repros.common import bound_ms, card_line

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "build")
    print(f"built {library.LIBRARY} in {library.build(force=True):.1f} s",
          flush=True)
    native.build()
    if not native.available():
        raise AssertionError(f"{native.LIBRARY} does not load")
    print(f"built {native.LIBRARY}", flush=True)

    phase(2, "forward kernel vs plain on the card")
    report = kernel_vs_plain(dev)

    phase("2b", "dropout keep mask vs plain on the card")
    mask_report = dropout_mask_check(dev)

    phase("2c", "forward kernel with dropout vs plain")
    dropout_forward(dev)

    phase("2d", "backward kernel vs plain on the card")
    bwd_report = backward_vs_plain(dev)

    phase(3, "whole model, GPU vs CPU")
    whole_model(dev)

    phase(4, "main path: --fast evaluation")
    eval_launches = main_path(card)

    phase(5, "whole-model gradients, GPU vs CPU")
    whole_model_grads(dev)

    phase(6, "main path: --fast training")
    train_counts = train_path(card)

    phase("7a", "R15 fused MBConv kernel vs plain on the card")
    mb_err = mbconv_vs_plain(dev)

    phase("7b", "R15 path: the fused MBConv repro")
    mb_launches, mb_results = repro_path(
        repro, [cuda_mbconv], lambda: {"fused_mbconv": cuda_mbconv.launches})

    phase("7c", "the stock MBConv's share of the --fast forward")
    mbconv_share(dev, card)

    phase("8a", "R1/R14 per-head attention kernel vs plain on the card")
    ph_err = perhead_vs_plain(dev)

    phase("8b", "R1/R14 path: the per-head attention repro")
    ph_launches, ph_results = repro_path(
        repro_perhead, [attention_variants], lambda: {
            wpc: attention_variants.perhead_launches[wpc]
            for wpc in repro_perhead.WINDOWS_PER_CTA})

    phase("9a", "R7 MaxViT layer megakernel vs plain on the card")
    layer_err = layer_vs_plain(dev)

    phase("9b", "R7 path: the megakernel repro")
    layer_launches, layer_results = repro_path(
        repro_mega, [attention_variants],
        lambda: {"maxvit_layer_attention": attention_variants.layer_launches})

    phase("10a", "R4, R10, R9 and R11 kernels vs plain on the card")
    variant_err = variants_vs_plain(dev)

    phase("10b", "R4, R10, R9 and R11 paths: their repros")
    av = attention_variants
    variant_runs = {}
    for module, route, count in (
            (repro_r4, "headmajor_attention", lambda: av.headmajor_launches),
            (repro_r10, "stacked_softmax_attention",
             lambda: av.stacked_launches),
            (repro_r9, "perhead_weight_attention",
             lambda: av.perhead_weight_launches),
            (repro_r11, "staged_attention_core",
             lambda: av.staged_core_launches)):
        variant_runs[route] = repro_path(module, [av],
                                         lambda: {route: count()})

    phase("11a", "R3 and the out-projection kernel (R12, R13, R2, R8) vs "
          "plain on the card")
    outproj_err = crosshead_outproj_vs_plain(dev)

    phase("11b", "R3, R12-R13, R2 and R8 paths: their repros")

    def outproj_count(two_pass, perhead, score=False, agg=False, wpc=8):
        return av.outproj_launches[(two_pass, perhead, score, agg, wpc)]

    r3_launches, r3_results = repro_path(
        repro_r3, [av],
        lambda: {"crosshead_norm_attention": av.crosshead_launches})
    ws_launches, ws_results = repro_path(repro_ws, [av], lambda: {
        name: outproj_count(tp, pw)
        for name, (_, tp, pw) in repro_ws.VARIANTS.items()})
    r2_launches, r2_results = repro_path(repro_r2, [av], lambda: {
        name: outproj_count(True, True, score, agg)
        for name, (score, agg) in repro_r2.CASTS.items()})
    r8_launches, r8_results = repro_path(repro_r8, [av], lambda: {
        f"kfold={k}": outproj_count(True, True, wpc=repro_r8.BLK * k)
        for k in repro_r8.KFOLDS})

    phase("12a", "R5/R6 head-pack kernel vs plain on the card")
    headpack_err = headpack_vs_plain(dev)

    phase("12b", "R5 and R6 paths: their repros")

    def headpack_count(k):
        return sum(v for (kk, _, _), v in av.headpack_launches.items()
                   if kk == k)

    r5_launches, r5_results = repro_path(
        repro_r5, [av], lambda: {"K=2": headpack_count(2)})
    r6_launches, r6_results = repro_path(
        repro_r6, [av], lambda: {f"K={k}": headpack_count(k)
                                 for k in HEADPACK_K})

    err, k_ms, p_ms = report["bfloat16"]
    b_err, b_ms, r_ms, _ = bwd_report["bfloat16"]
    m_err, m_ms, mp_ms = mask_report
    mb = mb_results[384]
    src = "vit_grid_model_tpu_torch/csrc/"
    tpu = "vit_grid_model_tpu/ops/pallas/attention.py"
    fwd_bound = attention_bound_ms(
        FLAGSHIP_BATCH * 12 * WINDOWS_PER_SAMPLE, 53, 128, 32, 32, 2)
    bwd_bound = attention_bound_ms(TRAIN_WINDOWS, 53, 128, 32, 32, 2,
                                   backward=True)
    # the standalone mask kernel writes an f32 mask and does no products
    mask_bound = bound_ms(0, TRAIN_WINDOWS * 32 * 53 * 53 * 4, torch.float32)
    mb_bound = repro.bound_ms(384, repro.H, repro.W, repro.DIM,
                              repro.DIM * repro.EXPANSION, repro.DIM,
                              torch.bfloat16)
    print(f"evaluation path: window_attention_fwd launched {eval_launches} "
          "times", flush=True)
    kernels = [
        ("window_attention_fwd", "window_attention_fwd.cu", f"{tpu}:139",
         train_counts["window_attention_fwd"], err, k_ms, p_ms, fwd_bound,
         None),
        ("window_attention_bwd", "window_attention_bwd.cu", f"{tpu}:534",
         train_counts["window_attention_bwd"], b_err, b_ms, r_ms, bwd_bound,
         None),
        ("dropout_keep_mask", "dropout_hash.cuh", f"{tpu}:68",
         train_counts["dropout_keep_mask"], m_err, m_ms, mp_ms, mask_bound,
         None),
        ("fused_mbconv", "fused_mbconv.cu",
         "benchmarks/mosaic_repros/repro_fused_mbconv.py:101",
         mb_launches["fused_mbconv"],
         mb_err, mb["kernel spb=1"][0], mb["plain"][0], mb_bound, None)]
    # R1 and R14 at the repro's Bw = 2,880, R7 at the flagship S = 300
    ph = ph_results[2880]
    ph_bound = repro_perhead.bound_ms(
        2880, repro_perhead.N_PAD, repro_perhead.DIM, repro_perhead.HEADS,
        repro_perhead.DIM_HEAD, torch.bfloat16)
    for wpc, replaces in ((8, "repro_baseline_perhead.py:60"),
                          (16, "repro_16window_tile.py:20")):
        kernels.append((f"perhead_attention_w{wpc}", "perhead_attention.cu",
                        f"benchmarks/mosaic_repros/{replaces}",
                        ph_launches[wpc], ph_err[wpc],
                        ph[f"kernel wpc={wpc}"][0], ph["plain"][0], ph_bound,
                        None))
    ly = layer_results[300]
    kernels.append((
        "maxvit_layer_attention", "maxvit_layer_attention.cu",
        "benchmarks/mosaic_repros/repro_megakernel.py:283",
        layer_launches["maxvit_layer_attention"], layer_err,
        ly["kernel"][0], ly["plain"][0],
        repro_mega.bound_ms(300, torch.bfloat16), None))
    # R4, R10 and R9 at the repro's Bw = 2,880, with R1's bound; R11's core
    # on the staged operands, against SDPA, the one PyTorch call that
    # computes its function (none computes the others': SDPA covers neither
    # a projection, the l2 norm nor the repartition)
    mosaic = "benchmarks/mosaic_repros/"
    for route, source, replaces in (
            ("headmajor_attention", "headmajor_attention.cu",
             "repro_headmajor_batched.py:63"),
            ("stacked_softmax_attention", "stacked_softmax_attention.cu",
             "repro_stacked_softmax.py:64"),
            ("perhead_weight_attention", "perhead_attention.cu",
             "repro_perhead_weight_gemm.py:68")):
        launches, results = variant_runs[route]
        r = results[2880]
        kernels.append((route, source, mosaic + replaces, launches[route],
                        variant_err[route], r["kernel"][0], r["plain"][0],
                        ph_bound, None))
    launches, results = variant_runs["staged_attention_core"]
    core = results[2880]["core"]
    kernels.append((
        "staged_attention_core", "staged_attention_core.cu",
        mosaic + "repro_staged_headmajor.py:68",
        launches["staged_attention_core"],
        variant_err["staged_attention_core"], core["kernel"][0],
        core["plain"][0],
        repro_r11.core_bound_ms(2880, repro_perhead.N_PAD,
                                repro_perhead.HEADS, repro_perhead.DIM_HEAD,
                                torch.bfloat16), core["sdpa"][0]))
    # R3 and the out-projection family at the repro's Bw = 2,880; no single
    # PyTorch call computes their functions (SDPA has no qkv product, l2
    # norm or out-projection), so none has a library time
    r3 = r3_results[2880]
    kernels.append((
        "crosshead_norm_attention", "crosshead_norm_attention.cu",
        mosaic + "repro_crosshead_rmsnorm_gemm.py:69",
        r3_launches["crosshead_norm_attention"],
        outproj_err["crosshead_norm_attention"], r3["kernel"][0],
        r3["plain"][0], ph_bound, None))

    def family_bound(n):
        return repro_ws.bound_ms(2880, n, repro_perhead.DIM,
                                 repro_perhead.HEADS, repro_perhead.DIM_HEAD,
                                 repro_ws.OUT_DIM, torch.bfloat16)

    ws_r, r2_r, r8_r = ws_results[2880], r2_results[2880], r8_results[2880]
    for name, replaces, launches, err, ms, plain_ms, n in (
            ("outproj_attention_baseline",
             "repro_weightsliced_variants.py:140", ws_launches["baseline"],
             outproj_err["baseline"], ws_r["baseline"][0],
             ws_r["plain"][0], repro_perhead.N_PAD),
            ("outproj_attention_ws_2pass_pwout",
             "repro_weightsliced_variants.py:155",
             ws_launches["ws_2pass_pwout"], outproj_err["ws_2pass_pwout"],
             ws_r["ws_2pass_pwout"][0], ws_r["plain"][0],
             repro_perhead.N_PAD),
            ("outproj_attention_bf16_both", "repro_bf16_mxu_operands.py:94",
             r2_launches["bf16_both"], outproj_err["bf16_both"],
             r2_r["kernel bf16_both"][0], r2_r["plain bf16_both"][0],
             repro_perhead.N_PAD),
            ("outproj_attention_npad64_kfold2",
             "repro_npad_and_kfold.py:88", r8_launches["kfold=2"],
             outproj_err["npad64_kfold2"], r8_r[64]["kfold=2"][0],
             r8_r[64]["plain"][0], 64)):
        kernels.append((name, "outproj_attention.cu", mosaic + replaces,
                        launches, err, ms, plain_ms, family_bound(n), None))
    # R5 and R6 at the repro's Bw = 2,880, two passes, 8 windows a CTA; the
    # out-projection family's bound and (no) library call
    r5_r, r6_r = r5_results[2880], r6_results[2880]
    for k, replaces, launches, r, version in (
            (2, "repro_headpair_lanepack.py:139", r5_launches["K=2"], r5_r,
             "pair_2pass_w8"),
            (4, "repro_headquad_lanepack.py:129", r6_launches["K=4"], r6_r,
             "quad_2pass_w8"),
            (8, "repro_headquad_lanepack.py:129", r6_launches["K=8"], r6_r,
             "oct_2pass_w8")):
        kernels.append((f"headpack_attention_k{k}", "headpack_attention.cu",
                        mosaic + replaces, launches, headpack_err[k],
                        r[version][0], r["plain"][0],
                        repro_r5.bound_ms(2880), None))
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": replaces, "launches": launches, "max_abs_err": e,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
         "bound_by": bound[1], "library_ms": library}
        for name, source, replaces, launches, e, ms, plain_ms, bound, library
        in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
