"""Smoke run of the PyTorch port on one CUDA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  It builds the port's hand-written kernel
from ``vit_grid_model_tpu_torch/csrc``, holds it against its plain PyTorch
version on the card, runs the shipped 12-hour MetNet3 (random weights from a
numpy seed) on the GPU and on the CPU, and drives the ``--fast`` evaluation
CLI over a synthetic data tree at batch 25.  Phases:

0. device: CUDA present, versions, the card's name and power limit;
1. build: compile the kernel library;
2. kernel vs plain: flagship, 3-head and diverging-score cases in f32 and
   bf16; kernel and plain times at the flagship shape;
3. whole model: one sample forward in f32 on the GPU against the CPU;
4. main path: the evaluation CLI; every window attention must have gone
   through the kernel.

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
        cuda_attn.launches = 0
        metrics = cli.main(argv, timing=timing)
        torch.cuda.synchronize()
        launches = cuda_attn.launches
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

    phase(2, "kernel vs plain on the card")
    report = kernel_vs_plain(dev)

    phase(3, "whole model, GPU vs CPU")
    whole_model(dev)

    phase(4, "main path: --fast evaluation")
    launches = main_path(card)

    err, k_ms, p_ms = report["bfloat16"]
    print(json.dumps({"kernels": [{
        "name": "window_attention_fwd", "route": "cuda",
        "source": "vit_grid_model_tpu_torch/csrc/window_attention_fwd.cu",
        "replaces": "vit_grid_model_tpu/ops/pallas/attention.py:139",
        "launches": launches, "max_abs_err": err, "ms": k_ms,
        "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
