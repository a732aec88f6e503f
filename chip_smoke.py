"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's hand-written kernels
from ``vit_grid_model_tpu_torch/csrc``, holds each against its plain
PyTorch version on the card, runs the shipped 12-hour MetNet3 (random
weights from a numpy seed) on the GPU and on the CPU, drives the ``--fast``
evaluation CLI over a synthetic data tree at batch 25, and drives the
``--fast`` training CLI for 12 steps at batch 4.  Phases:

0. device: CUDA present, versions, the card's name and power limit;
1. build: compile the kernel library;
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
   gradient must have gone through the kernels.

Any failure raises and the exit code is not 0.  The last two lines are the
kernel report and ``{"ok": true, "device": {...}}``.  Imports nothing of
JAX.
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


def phase(n, title):
    print(f"\n== phase {n}: {title}", flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


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


def cuda_ms(fn, iters=10, warmup=2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_vs_plain(dev):
    """Phase 2.  Returns the flagship bf16 case's error and both times."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices

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

    from vit_grid_model_tpu.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu.data.synthetic import DEFAULT_FEAT_INFOS
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

    from vit_grid_model_tpu.data import readers, synthetic
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

    from vit_grid_model_tpu.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu.data.synthetic import DEFAULT_FEAT_INFOS
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


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    phase(0, "device")
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    dev = torch.device("cuda:0")
    card = card_line()
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    phase(1, "build")
    print(f"built {cuda_attn.LIBRARY} in {cuda_attn.build(force=True):.1f} s",
          flush=True)

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

    err, k_ms, p_ms = report["bfloat16"]
    b_err, b_ms, r_ms, _ = bwd_report["bfloat16"]
    m_err, m_ms, mp_ms = mask_report
    src = "vit_grid_model_tpu_torch/csrc/"
    tpu = "vit_grid_model_tpu/ops/pallas/attention.py"
    print(f"evaluation path: window_attention_fwd launched {eval_launches} "
          "times", flush=True)
    print(json.dumps({"kernels": [
        {"name": "window_attention_fwd", "route": "cuda",
         "source": src + "window_attention_fwd.cu", "replaces": f"{tpu}:139",
         "launches": train_counts["window_attention_fwd"],
         "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms},
        {"name": "window_attention_bwd", "route": "cuda",
         "source": src + "window_attention_bwd.cu", "replaces": f"{tpu}:534",
         "launches": train_counts["window_attention_bwd"],
         "max_abs_err": b_err, "ms": b_ms, "plain_ms": r_ms},
        {"name": "dropout_keep_mask", "route": "cuda",
         "source": src + "dropout_hash.cuh", "replaces": f"{tpu}:68",
         "launches": train_counts["dropout_keep_mask"],
         "max_abs_err": m_err, "ms": m_ms, "plain_ms": mp_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
