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
family R12-R13, R2 and R8, and the head-pack repros R5 and R6, then the
inference entry points (serving, re-analysis generation and station
evaluation) at the shipped configuration, data parallelism, the class head
and int8 PTQ of the resnet convs, the legacy station and grid models, SimVP
and the utilities, and last the eight legacy datasets and the
station-image variant of the 12-hour model.  Phases:

0. device: CUDA present, versions, the card's name and power limit;
1. build: compile the kernel library and the data loader;
2. forward kernel vs plain: flagship, 3-head, diverging-score and window-5
   (29 tokens) cases in f32 and bf16, bit-identical on a second launch;
   kernel and plain times at the flagship shape beside the bound; and K1
   in bf16 off the strip path (dim 256, 8 heads x 64), held to the f32
   plain version within 2 x the plain bf16 version's own error;
2b. dropout keep mask: the CUDA hash bit-equal to its plain version, at
    32 and 3 heads, each launch on the writer's chunks design;
2c. forward kernel with dropout vs plain with the same mask, in the
   training cases (windows of 7 and 5), bit-identical on a second launch;
   kernel and plain times at Bw 1,440;
2d. backward kernels vs autograd through the plain forward, at rates 0 and
    0.1 in f32 and bf16, windows of 7 and 5 (53 and 29 tokens): K3, and on
    its bf16 tensor-core path K3-w, the weight gradients from the operands
    K3 writes, also alone against its plain version; bit-identical on a
    second launch; K3's, K3-w's and the plain times;
3. whole model: one sample forward in f32 on the GPU against the CPU;
4. main path: the evaluation CLI with --collect_valid_times; every window
   attention must have gone through the forward kernel, and every
   collected time has hour 06;
5. whole-model gradients: one training loss and backward in f32 on the GPU
   (forward and backward kernels) against the CPU (plain version) in f64;
6. training main path: the training CLI; every window attention and its
   gradient must have gone through the kernels (K1, K3 and K3-w);
7. R15: the fused MBConv kernel vs its plain version (bf16 at BN 384 with
   1 and 4 samples per block and at BN 300, f32 at BN 8, a small odd
   shape in both types, rows of 56 pixels on bands of 6 rows, the 12-hour
   model's own MBConv), bit-identical on
   a second launch, every bf16 launch on the bands design (its outputs at
   1 and 4 samples a block bit-identical) and every f32 one on the first;
   then the repro's entry point, which must go through the kernel, only
   on the bands design, with kernel, plain and stock-folded times; and
   the stock MBConv's share of the B=25 ``--fast`` forward's kernel time;
8. R1/R14: the per-head attention kernel vs its plain version at 8 and 16
   windows a CTA (bf16 at Bw 2,880, f32, a ragged Bw, 3 heads x 16),
   bit-identical on a second launch; then the repro's entry point, which
   must launch the kernel at both settings, with kernel and plain times;
9. R7: the MaxViT layer megakernel vs its plain version (bf16, the strip
   design with its scratch map, at S 96, 300, 1 and 37; f32 at S 2; a
   diverging-score case in both types), bit-identical on a second launch;
   then the repro's entry point, which must launch it, with kernel, plain
   and two-K1 baseline times and the cluster sweep, each cluster size
   beside its occupancy line, and a line with the default cluster's
   occupancy, the kernel, the baseline and their ratio at S 300;
10. R4, R10, R9 and R11: the head-major batched kernel, the stacked-softmax
   kernel, R9's route through the per-head kernel, R11's core kernel and
   R11 whole vs their plain versions (bf16 at Bw 2,880, f32, a ragged Bw,
   3 heads x 16, a diverging-score case in both types; R10 also at n 64
   and 9, Bw 2,880 and 37), bit-identical on a second launch, R10's lines
   with the design its launches took (bf16 at the repro's widths the strip
   design, K1's strip body without the out-projection; f32 the first), as
   R11's lines (bf16 the ring design, f32 the first);
   then the four repros' entry points, each of which must launch its
   kernel (R10 only through the strip design, R11's core only through the
   ring design), with kernel, plain and R1-kernel times (R11 also the core
   against SDPA);
11. R3 and the out-projection family: R3's cross-head indicator-norm
   kernel on phase 10's cases; the out-projection kernel's shipping
   structure (ws_2pass_pwout) on the same cases, the other R12/R13
   structures at Bw 2,880 in bf16 and Bw 40 in f32 (f32 output, held to
   1e-4), R2's casts at Bw 2,880 and in the diverging cases, R8's six
   (n_pad, kfold) cases at Bw 2,880, each bit-identical on a second launch,
   each line with the design the kernel's launches took (bf16 at the
   repros' widths the strip design on K1's strip body, f32 and dim_head 64
   the first design); then the four repros' entry points, each of which
   must launch its kernel (the out-projection repros only through the
   strip design), with kernel, plain, R4-, R1- and unfused (R1's kernel +
   cuBLAS) times, each time over the bound, the design's occupancy line,
   and a sweep of 1, 2, 4, 8, 16 and 32 windows a CTA at Bw 2,880 and
   9,000;
12. R5 and R6: the head-pack kernel at K = 2, 4 and 8 heads a pack, one
   pass and two, 8 and 16 windows a CTA, vs plain (bf16 at Bw 2,880, f32
   with an f32 output, a ragged Bw, every odd head's scores 200 below in
   both types), bit-identical on a second launch, each build's design
   asserted (bf16 the out-projection kernel's strip kernel, its output
   bit-identical to ``outproj_attention``'s at the same windows a CTA; f32
   the first design); then the two repros' entry points, each of which
   must launch the kernel at every K it runs (only through the strip
   design), with kernel, plain, out-projection-kernel and unfused times;
13. the inference entry points, on phase 4's tree, at the shipped 12-hour
   configuration in bf16: (a) ``Forecaster(device="cuda")`` at B = 1, 2
   warm-ups and 20 requests (p50/p90 latency; one request against a
   direct forward of the same model), then K1 alone at its Bw 360; (b)
   the generation CLI at its batch of 8 over 44 samples (a ragged last
   batch): one finite field a sample and lead, fields/s; (c) the station
   evaluation CLI with --fast at batch 25: its log block, n_obs > 0,
   samples/s.  Each must have run every window attention through K1;
14. data parallel: (a) each of the four CLIs under ``torchrun
   --nproc_per_node 1`` with ``--data_parallel -1`` (the process group on
   NCCL) at the shipped 12-hour configuration with --fast, against the same
   CLI without torchrun on the same batches (phases 4, 13b and 13c's
   outputs; training against an in-process run of 3 steps), logs, fields,
   losses and weights within 1e-5 relative; (b) two processes on cuda:0
   over gloo call the library functions with a process group: the
   evaluation at batch 24 over 51 samples (24, 24 and a ragged 3 that rank
   0 runs whole) and one train step at batch 4 with dropout 0.1, against
   one process on the same card: the log and the loss within 1e-3
   relative, the two ranks' trained states bit-equal, each rank's K1, K3,
   K3-w and dropout-hash launches as expected.  Each sub-phase prints its
   seconds;
15. the class head and int8, at the shipped 12-hour configuration: (a)
   with the class, PM10 and regional heads in f32, one sample's class
   outputs on the GPU against the CPU (logits and regional predictions
   within 1e-3 of their max, losses within 1e-4 relative), one training
   loss and backward at batch 2 with dropout 0.1 (K1, K3 and the hash;
   a finite loss, a non-zero regional gradient; its ms), and with
   ``ignore_backbone`` no backbone gradient from the regional losses; (b)
   the ``--fast`` configuration (bf16, fused stem, NHWC input) with
   ``int8_convs`` at batch 25: calibrated on one synthetic batch, the
   sidecars still int8 and f32 after the bf16 cast, each of the seven
   int8 convs bit-equal to its plain version (int32 accumulator and
   output), the int8 forward through K1 and seven int8 convs, its fields'
   RMSE and max|d| from the bf16 forward (and both from the f32 one), both
   forwards' ms, and one int8 conv at (300, 128, 84, 70) against cuDNN's
   bf16 conv beside both bounds.  The int8 conv is a stock route
   (im2col + ``torch._int_mm``), so it is reported on a line of its own,
   not in the kernel report;
16. the legacy station and grid models, SimVP and the utilities, in f32
   with TF32 off (restored after), each model seeded and held on the card
   to the same module on the CPU within 1e-4 of max|out|, its output shape
   and finiteness, its forward's median ms of 10 after 2 warm-ups, the
   profiler's kernel time a forward, the median again after the profile
   and a ``StepTimer``'s host p50 through ``host_sync``: (a) the station
   models at B = 8, 400 + 150 stations, hidden 128, 7 + 6 hours (MultiAir
   under RevIN, DishTS and Standard; simulation, simulation_avg and wo),
   one batch row's stations all masked at one step; (b) the grid models v1,
   v2 and v3 (v3 under Standard, RevIN and DishTS) at B = 1 over the 82 x
   67 grid, 6,044 joint-attention tokens; (c) SimVP at its spec's widths,
   B = 4, (7, 12, 80, 64); (d) a ``trace`` with an ``annotate`` region
   writes its trace file, the region owns every kernel launched in it
   (``kernels_by_span``), and ``oom_guard`` rewraps a real CUDA
   out-of-memory error.  No hand-written kernel launches in it (K1, K3,
   K3-w and the hash counters stay at 0).  Each sub-phase prints its
   seconds;
17. the eight legacy datasets and the station-image model: (a) on phase
   4's tree with ``write_station_images`` over its first 25 samples'
   window, at the shipped geometry (13 input, 12 output, 13 history
   hours, 6 species: 28 channels a step), one ``BatchLoader`` batch of 25
   from each class in its tuple's shapes and dtypes, the six in-memory
   classes on seeded arrays at 400 + 150 stations; the output-window-only
   V2 and the station-image class once with the native plane and once
   without, byte-equal; ``native.unsupported_count()`` 0; each class's
   samples/s; (b) the station-image 12-hour model (25 channels, the
   station image at 24, hidden 128, 32 heads x 32, seeded) in f32, one
   sample on the GPU against the CPU within 1e-3 of max|out|, K1 launched
   twice, both on its first design; (c) the same model in the --fast
   configuration (bf16, fused stem, NHWC input) at B = 25, its input
   staged by ``model_input_to_nhwc`` and ``host_stage_dtype``, against
   the standard path of that configuration on the (B, T, C, H, W) input
   within 1e-6 of max|out| (the same launches on the same operands:
   bit-equal by construction), K1 launched twice a forward, both on its
   strip path; the forward's median ms.  Each sub-phase prints its
   seconds.

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
from datetime import datetime

import numpy as np

SEED = 0
FLAGSHIP_BATCH = 25
WINDOWS_PER_SAMPLE = 30           # 84x70 max-pooled to 42x35: 6x5 windows
# (name, heads, dim_head, dim, conditioned, windows, head-0 score offset,
# window size); window 5 has 29 tokens, which leave rows 29..63 of the
# 64-row tile as padding (two of its four 16-row strips wholly so)
ATTENTION_CASES = [
    ("flagship", 32, 32, 128, True, FLAGSHIP_BATCH * 12 * WINDOWS_PER_SAMPLE,
     0.0, 7),
    ("heads3_uncond", 3, 16, 48, False, 600, 0.0, 7),
    ("diverging", 32, 32, 128, True, 600, -200.0, 7),
    ("window5", 4, 32, 128, True, 600, 0.0, 5),
]
# max|kernel - plain| / max|plain|: f32 sums run in another order; bf16
# rounds at other points (the kernel keeps LayerNorm and softmax in f32)
TOLERANCE = {"float32": 1e-4, "bfloat16": 2e-2}
# bf16 off the strip path (dim > 128, dh > 32): (heads, dim_head, dim,
# conditioned, windows, head-0 score offset, window size).  It is held to
# the f32 plain version on the same bf16-rounded inputs, within
# WIDE_BOUND x the plain bf16 version's own error against that f32 version,
# a bound that grows with dh as the plain rounding does
WIDE_CASE = (8, 64, 256, True, 300, 0.0, 7)
WIDE_BOUND = 2.0

# phase 4's window, 100 hourly samples (four batches of 25); its tree
# also feeds phase 13
EVAL_WINDOW = (datetime(2023, 1, 10, 0), datetime(2023, 1, 14, 3))
# phase 13: serving at B = 1 (Bw 360 a K1 call), generation at the CLI's
# batch of 8 over 44 samples (five batches and a ragged one of 4),
# station evaluation at batch 25 over 75 samples (three batches)
SERVING_WARMUP, SERVING_REQUESTS = 2, 20
SERVING_REL_TOL = 1e-6
GENERATION_WINDOW = (datetime(2023, 1, 10, 0), datetime(2023, 1, 11, 19))
GENERATION_BATCH = 8
STATION_WINDOW = (datetime(2023, 1, 10, 0), datetime(2023, 1, 13, 2))

# the CLIs' arguments: the --fast evaluation CLIs (phases 4, 13c, 14) at
# the shipped 12-hour configuration, the generation CLI (13b, 14) at its
# defaults, which are that configuration, and the --fast training CLI
# (6, 14)
FLAGSHIP_ARGV = ["--fast", "--batch_size", str(FLAGSHIP_BATCH),
                 "--input_dim", "13", "--output_dim", "12", "--prev_len",
                 "13", "--hidden_dim", "128", "--gpus", "0", "--model_name",
                 "smoke", "--seed", str(SEED)]
GENERATION_ARGV = ["--gpus", "0"]

# phase 14: 14a runs each CLI under torchrun at world size 1 (NCCL) and
# holds it to the same CLI without torchrun; 14b runs two ranks on cuda:0
# over gloo, the evaluation at batch 24 over 51 samples (24, 24 and a
# ragged 3 on rank 0) and one train step, against one process
ROOT = os.path.dirname(os.path.abspath(__file__))
DP_TORCHRUN_TIMEOUT = 300
DP_TORCHRUN_REL = 1e-5
DP_TRAIN_STEPS = 3
DP_EVAL_BATCH = 24
DP_EVAL_WINDOW = (datetime(2023, 1, 10, 0), datetime(2023, 1, 12, 2))
DP_RANKS_REL = 1e-3
# the logs print 4 decimals: one unit of the last, and float noise
LOG_UNIT = 1.0001e-4
DP_DEVICE = "cuda:0"

TRAIN_BATCH = 4
TRAIN_WINDOWS = TRAIN_BATCH * 12 * WINDOWS_PER_SAMPLE      # 1,440
TRAIN_STEPS = 12
DROPOUT = 0.1
TRAIN_ARGV = ["--fast", "--synthetic", "--batch_size", str(TRAIN_BATCH),
              "--gpus", "0", "--dropout", str(DROPOUT), "--seed", str(SEED),
              "--train_start", "2023-01-10T00", "--train_end",
              "2023-01-12T23", "--model_name", "smoke"]
DROPOUT_SEED = 2 ** 30 + 12345                 # above 2**30, as seeds reach
# the training cases: (name, heads, dim_head, dim, conditioned, windows,
# head-0 score offset, window size); window 5 has 29 tokens, which leave
# rows 29..63 of the 64-row tile as padding (window 7: 53..63)
TRAIN_CASES = [
    ("flagship", 32, 32, 128, True, TRAIN_WINDOWS, 0.0, 7),
    ("heads3_uncond", 3, 16, 48, False, 600, 0.0, 7),
    ("diverging", 32, 32, 128, True, 600, -200.0, 7),
    ("window5", 4, 32, 128, True, 600, 0.0, 5),
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


def tree_argv(paths):
    return ["--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"]]


def eval_argv(paths, window, log_dir: str):
    """The --fast evaluation CLIs' arguments over ``window``."""
    start, end = window
    return FLAGSHIP_ARGV + tree_argv(paths) + [
        "--test_start", start.strftime("%Y-%m-%dT%H"),
        "--test_end", end.strftime("%Y-%m-%dT%H"), "--log_dir", log_dir]


def generation_argv(paths, out_dir: str):
    start, end = GENERATION_WINDOW
    return GENERATION_ARGV + tree_argv(paths) + [
        "--start", start.strftime("%Y-%m-%dT%H"),
        "--end", end.strftime("%Y-%m-%dT%H"), "--out_dir", out_dir]


def train_argv(steps: int, root: str):
    """The --fast training CLI's arguments for ``steps`` steps, with its
    tree and checkpoints under ``root``."""
    return TRAIN_ARGV + [
        "--steps", str(steps), "--checkpoint_every", str(steps),
        "--log_every", "1", "--synthetic_root", os.path.join(root, "tree"),
        "--checkpoint_dir", os.path.join(root, "check_points")]


def attention_case(heads, dim_head, dim, conditioned, bw, offset, seed,
                   window=7):
    """A window-attention layer and its inputs, all from a numpy seed: Bw
    windows of window^2 + 4 tokens (53 at the flagship window of 7)."""
    import torch

    from vit_grid_model_tpu_torch.ops.attention import Attention

    rng = np.random.default_rng(seed)
    m = Attention(dim, cond_dim=2 if conditioned else None, heads=heads,
                  dim_head=dim_head, window_size=window)
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
    x = rng.standard_normal((bw, window * window + 4, dim)).astype(np.float32)
    cond = (rng.standard_normal((bw // WINDOWS_PER_SAMPLE, 2))
            .astype(np.float32) if conditioned else None)
    return m.eval(), x, cond


def kernel_vs_plain(dev):
    """Phase 2.  Returns the flagship bf16 case's error and both times.
    Raises on a second launch that is not bit-identical."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    report = {}
    for (name, heads, dh, dim, conditioned, bw, offset,
         window) in ATTENTION_CASES:
        bias_idx = relative_position_indices(window, 4, device=dev)
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            m, x, cond = attention_case(heads, dh, dim, conditioned, bw,
                                        offset, SEED, window)
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
                again = run_kernel()
                torch.cuda.synchronize()
                if not torch.equal(ours, again):
                    raise AssertionError(f"{name} {dtype_name}: two "
                                         "launches differ")
                ref = run_plain()
                torch.cuda.synchronize()
                ours, ref = ours.float(), ref.float()
                if not bool(torch.isfinite(ours).all()):
                    raise AssertionError(f"{name} {dtype_name}: kernel "
                                         "output is not finite")
                err = (ours - ref).abs().max().item()
                scale = ref.abs().max().item()
                line = (f"{name:14s} {dtype_name:8s} Bw={bw:5d} "
                        f"n={x.shape[1]} "
                        f"max|d|={err:.3e} max|plain|={scale:.3e} "
                        f"rel={err / scale:.3e} (tol {tol:g}); bit-identical "
                        "rerun")
                if name == "flagship":
                    k_ms = cuda_ms(run_kernel)
                    p_ms = cuda_ms(run_plain)
                    bound = attention_bound_ms(bw, x.shape[1], dim, heads,
                                               dh, 2)
                    line += (f"\n  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
                             f"  bound {bound[0]:.3f} ms ({bound[1]})")
                    report[dtype_name] = (err, k_ms, p_ms)
                print(line, flush=True)
                if not err <= tol * scale:
                    raise AssertionError(f"{name} {dtype_name}: kernel "
                                         f"differs from plain by {err}")
            del m, xt, ct, ours, again, ref
            torch.cuda.empty_cache()
    return report


def wide_bf16_vs_f32(dev):
    """K1 in bf16 on ``WIDE_CASE``, off the strip path.  Returns
    (max|kernel - f32 plain|, max|plain bf16 - f32 plain|, max|f32 plain|)
    on the same bf16-rounded layer and inputs; raises when the kernel
    misses WIDE_BOUND x the plain bf16 error, is not finite, or a second
    launch is not bit-identical."""
    import copy

    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices

    heads, dh, dim, conditioned, bw, offset, window = WIDE_CASE
    m, x, cond = attention_case(heads, dh, dim, conditioned, bw, offset,
                                SEED, window)
    m = m.to(dev, torch.bfloat16)
    xt = torch.from_numpy(x).to(dev, torch.bfloat16)
    ct = torch.from_numpy(cond).to(dev, torch.bfloat16)
    m32 = copy.deepcopy(m).float()
    bias_idx = relative_position_indices(window, 4, device=dev)
    with torch.inference_mode():
        ours = cuda_attn.window_attention(
            m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE)
        again = cuda_attn.window_attention(
            m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE)
        ref_bf16 = plain.attention(m, xt, ct, bias_idx,
                                   windows_per_sample=WINDOWS_PER_SAMPLE)
        ref = plain.attention(m32, xt.float(), ct.float(), bias_idx,
                              windows_per_sample=WINDOWS_PER_SAMPLE)
        torch.cuda.synchronize()
    if not torch.equal(ours, again):
        raise AssertionError("wide bf16: two launches differ")
    ours = ours.float()
    if not bool(torch.isfinite(ours).all()):
        raise AssertionError("wide bf16: kernel output is not finite")
    err = (ours - ref).abs().max().item()
    plain_err = (ref_bf16.float() - ref).abs().max().item()
    scale = ref.abs().max().item()
    print(f"wide bf16 heads={heads} dh={dh} dim={dim} Bw={bw}: "
          f"max|kernel - f32 plain|={err:.3e}, max|plain bf16 - f32 plain|="
          f"{plain_err:.3e}, max|f32 plain|={scale:.3e} (bound "
          f"{WIDE_BOUND:g} x the plain bf16 error)", flush=True)
    if not err <= WIDE_BOUND * plain_err:
        raise AssertionError(f"wide bf16: kernel error {err} above "
                             f"{WIDE_BOUND} x {plain_err}")
    return err, plain_err, scale


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


# K1's launches on each path that runs it, by the design each launch took
# (the wrapper's fwd_route_launches, read where the path reads its count)
K1_DESIGNS_BY_PATH: dict = {}


def note_k1_designs(path: str) -> None:
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    K1_DESIGNS_BY_PATH[path] = dict(cuda_attn.fwd_route_launches)


def main_path(card: str, root: str):
    """Phase 4: the --fast evaluation CLI over a synthetic tree, written
    under ``root`` and kept for phase 13.  Returns (K1 launches, the tree's
    three paths)."""
    import torch

    from vit_grid_model_tpu_torch.data import readers, synthetic
    from vit_grid_model_tpu_torch.cli import evaluation_vit as cli
    from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    # 100 hourly samples: four full batches of 25
    start, end = EVAL_WINDOW
    t0 = time.perf_counter()
    paths = synthetic.generate_tree(os.path.join(root, "tree"), start, end,
                                    prev_len=13, output_dim=12)
    readers.clear_caches()
    print(f"synthetic tree: {time.perf_counter() - t0:.1f} s", flush=True)
    log_dir = os.path.join(root, "logs")
    argv = eval_argv(paths, EVAL_WINDOW, log_dir) + ["--collect_valid_times"]
    timing = BatchTiming()
    cuda_attn.reset_launches()
    metrics = cli.main(argv, timing=timing)
    torch.cuda.synchronize()
    launches = cuda_attn.launches
    note_k1_designs("evaluation")
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
    # --collect_valid_times: one entry a batch, each time's hour 06
    valid = np.concatenate(metrics.valid_times)
    print(f"--collect_valid_times: {valid.tolist()}", flush=True)
    if len(metrics.valid_times) != batches or valid.size != 4 or not (
            valid % 100 == 6).all():
        raise AssertionError(f"collected valid times {valid.tolist()}")
    steady = sum(timing.samples[1:]) / sum(timing.seconds[1:])
    print(f"steady state (batches 2..{batches}): {steady:.2f} samples/s, "
          f"{steady * 12:.2f} fields/s; first batch "
          f"{timing.seconds[0]:.2f} s; card: {card}", flush=True)
    print("host seconds per batch, batches 2..: " + ", ".join(
        f"{k} {np.mean(v[1:]):.3f}" for k, v in timing.phases.items()),
        flush=True)
    return launches, paths


def serving_path(dev, card: str):
    """Phase 13a: ``Forecaster`` on the card at B = 1 (fast: bf16, the
    fused lead stem, K1 at Bw 360), SERVING_WARMUP warm-ups and
    SERVING_REQUESTS requests.  Returns (K1 launches, p50 ms, p90 ms)."""
    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.data.synthetic import DEFAULT_FEAT_INFOS
    from vit_grid_model_tpu_torch.evaluation.serving import Forecaster
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    mean, std = DEFAULT_FEAT_INFOS["PM2.5"]
    cfg = shipped_12hr_model_config(pm25_mean=mean, pm25_std=std)
    rng = np.random.default_rng(SEED + 13)
    x = (rng.random((1, 25, 24, 82, 67)) * 50).astype(np.float32)
    ts = np.stack([np.full(25, 2023.0), np.full(25, 1.0), np.full(25, 15.0),
                   np.arange(25) % 24], axis=-1)[None].astype(np.float32)
    cuda_attn.reset_launches()
    t0 = time.perf_counter()
    f = Forecaster(seeded_model(cfg, SEED), device="cuda",
                   warmup=SERVING_WARMUP)
    built = time.perf_counter() - t0
    latencies = []
    for _ in range(SERVING_REQUESTS):
        t0 = time.perf_counter()
        out = f.predict(x, ts)
        latencies.append(1e3 * (time.perf_counter() - t0))
    launches = cuda_attn.launches
    note_k1_designs("serving")
    expect = 2 * sum(cfg.depth_tuple) * (SERVING_WARMUP + SERVING_REQUESTS)
    print(f"Forecaster(device='cuda'): {f.cfg.compute_dtype}, fused stem "
          f"{f.cfg.fuse_lead_stem}; construction with {SERVING_WARMUP} "
          f"warm-ups {built:.2f} s; K1 launches {launches} (expected "
          f"{expect})", flush=True)
    if launches != expect:
        raise AssertionError("serving did not run every window attention "
                             "through the kernel")
    if out.shape != (1, 12, 82, 67) or not np.isfinite(out).all():
        raise AssertionError(f"serving output {out.shape} is not finite")
    # the same bf16 model on the same card, called directly on the same
    # input (the device's cast rounds as the host's does)
    with torch.inference_mode():
        direct = f.model(torch.from_numpy(x).to(dev, torch.bfloat16),
                         torch.from_numpy(ts).to(dev)).float().cpu().numpy()
    err = float(np.abs(out - direct).max())
    scale = float(np.abs(direct).max())
    print(f"request vs direct model(x, ts): max|d| = {err:.3e}, max|out| = "
          f"{scale:.3f} (tol {SERVING_REL_TOL:g} x max|out|)", flush=True)
    if not err <= SERVING_REL_TOL * scale:
        raise AssertionError(f"a request differs from the direct forward "
                             f"by {err}")
    p50, p90 = np.percentile(latencies, [50, 90])
    print(f"serving latency, B=1, {SERVING_REQUESTS} requests: p50 "
          f"{p50:.3f} ms, p90 {p90:.3f} ms (min {min(latencies):.3f}, max "
          f"{max(latencies):.3f}); card: {card}", flush=True)
    return launches, p50, p90


def k1_at_serving_shape(dev, card: str):
    """Phase 13a: K1 alone at serving's Bw 360 (B = 1, 12 leads, 30
    windows) in bf16, against its plain version.  Returns (error, kernel
    ms, plain ms, bound)."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    bw = 12 * WINDOWS_PER_SAMPLE
    m, xt, ct, _, _ = kernel_case(32, 32, 128, True, bw, 0.0, dev,
                                  torch.bfloat16)
    bias_idx = relative_position_indices(7, 4, device=dev)

    def run_kernel():
        return cuda_attn.window_attention(
            m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE)

    def run_plain():
        return plain.attention(m, xt, ct, bias_idx,
                               windows_per_sample=WINDOWS_PER_SAMPLE)

    with torch.inference_mode():
        ours, ref = run_kernel().float(), run_plain().float()
        err = (ours - ref).abs().max().item()
        scale = ref.abs().max().item()
        k_ms, p_ms = cuda_ms(run_kernel), cuda_ms(run_plain)
    bound = attention_bound_ms(bw, 53, 128, 32, 32, 2)
    print(f"K1 at Bw {bw} bf16: kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms, "
          f"bound {bound[0]:.4f} ms ({bound[1]}); max|d| / max|plain| = "
          f"{err / scale:.3e} (tol {TOLERANCE['bfloat16']:g}); card: {card}",
          flush=True)
    if not err <= TOLERANCE["bfloat16"] * scale:
        raise AssertionError(f"K1 at Bw {bw} differs from plain by {err}")
    return err, k_ms, p_ms, bound


def generation_path(paths, root: str, card: str):
    """Phase 13b: the generation CLI on the card at its default batch of 8
    (bf16, NHWC staging, Bw 2,880 a K1 call) over GENERATION_WINDOW, whose
    44 samples end in a ragged batch.  Returns K1's launches."""
    import torch

    from vit_grid_model_tpu_torch.cli import generate_reanalysis as cli
    from vit_grid_model_tpu_torch.data import readers
    from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    start, end = GENERATION_WINDOW
    samples = int((end - start).total_seconds() // 3600) + 1
    batches = -(-samples // GENERATION_BATCH)
    if samples % GENERATION_BATCH == 0:
        raise AssertionError("the generation window must end ragged")
    out_dir = os.path.join(root, "fields")
    argv = generation_argv(paths, out_dir)
    readers.clear_caches()
    timing = BatchTiming()
    cuda_attn.reset_launches()
    written = cli.main(argv, timing=timing)
    torch.cuda.synchronize()
    launches = cuda_attn.launches
    note_k1_designs("generation")
    files = sorted(os.listdir(out_dir))
    print(f"generation: {samples} samples, batches {timing.samples}; "
          f"{len(files)} field files; K1 launches {launches} (expected 2 x "
          f"{batches})", flush=True)
    if written != len(files) or len(files) != samples * 12:
        raise AssertionError(f"{len(files)} field files, {written} written; "
                             f"expected {samples} x 12")
    if launches != 2 * batches or len(timing.samples) != batches:
        raise AssertionError("generation did not run every window "
                             "attention through the kernel")
    for name in files:
        field = np.load(os.path.join(out_dir, name))
        if field.shape != (82, 67) or not np.isfinite(field).all():
            raise AssertionError(f"{name}: {field.shape}, not finite")
    steady = 12 * sum(timing.samples[1:]) / sum(timing.seconds[1:])
    print(f"generation steady state (batches 2..{batches}): {steady:.2f} "
          f"fields/s; first batch {timing.seconds[0]:.2f} s; card: {card}",
          flush=True)
    return launches


def station_path(paths, root: str, card: str):
    """Phase 13c: the station evaluation CLI on the card with --fast at
    batch 25 (Bw 9,000 a K1 call) over STATION_WINDOW, three batches.
    Returns K1's launches."""
    import torch

    from vit_grid_model_tpu_torch.cli import station_eval as cli
    from vit_grid_model_tpu_torch.data import readers
    from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    log_dir = os.path.join(root, "station_logs")
    argv = eval_argv(paths, STATION_WINDOW, log_dir)
    readers.clear_caches()
    timing = BatchTiming()
    cuda_attn.reset_launches()
    metrics = cli.main(argv, timing=timing)
    torch.cuda.synchronize()
    launches = cuda_attn.launches
    note_k1_designs("station evaluation")
    batches = len(timing.samples)
    summary = metrics.summary()
    with open(os.path.join(log_dir, "test_smoke_by_stn.log")) as f:
        log = f.read()
    print(f"station evaluation: batches {timing.samples}; K1 launches "
          f"{launches} (expected 2 x {batches}); n_obs {summary['n_obs']}",
          flush=True)
    if timing.samples != [FLAGSHIP_BATCH] * 3:
        raise AssertionError(f"expected 3 full batches: {timing.samples}")
    if launches != 2 * batches:
        raise AssertionError("station evaluation did not run every window "
                             "attention through the kernel")
    if not summary["n_obs"] > 0 or f"n_obs: {summary['n_obs']}" not in log:
        raise AssertionError("the station log block is missing or empty")
    for key in ("RMSE", "MAE", "R", "ACC"):
        if not np.isfinite(summary[key]):
            raise AssertionError(f"station {key} = {summary[key]}")
    steady = sum(timing.samples[1:]) / sum(timing.seconds[1:])
    print(f"station evaluation steady state (batches 2..{batches}): "
          f"{steady:.2f} samples/s; first batch {timing.seconds[0]:.2f} s; "
          f"card: {card}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 14: data parallel
# ---------------------------------------------------------------------------


def _kill_group(proc) -> None:
    """Stop a process started in its own session, and its children."""
    import signal

    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def torchrun(module: str, argv, timeout: float = DP_TORCHRUN_TIMEOUT) -> str:
    """``torchrun --standalone --nproc_per_node 1 -m module argv`` from the
    checkout's root; returns its standard output, raises when it fails.  It
    runs in a session of its own, which is stopped whole on a timeout."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node", "1", "-m", module, *argv]
    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        _kill_group(proc)
        raise AssertionError(f"torchrun {module}: no end in {timeout} s")
    if proc.returncode != 0:
        print(err[-4000:], file=sys.stderr, flush=True)
        raise AssertionError(f"torchrun {module} exited {proc.returncode}")
    print(f"torchrun --nproc_per_node 1 -m {module}: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return out


def logs_close(ours: str, ref: str, rel: float, what: str):
    """Two metric logs: the same lines, the argument line aside, each
    number within ``rel`` of the reference's plus one unit of the log's
    fourth decimal (two values a hair apart can round one unit apart).
    Returns the count of numbers compared and the largest |difference|."""
    a, b = ours.splitlines()[1:], ref.splitlines()[1:]
    if len(a) != len(b) or not a:
        raise AssertionError(f"{what}: {len(a)} lines against {len(b)}")
    n, worst = 0, 0.0
    for la, lb in zip(a, b):
        ta, tb = la.split(), lb.split()
        if len(ta) != len(tb):
            raise AssertionError(f"{what}: {la!r} against {lb!r}")
        for x, y in zip(ta, tb):
            try:
                fx, fy = float(x), float(y)
            except ValueError:
                if x != y:
                    raise AssertionError(f"{what}: {la!r} against {lb!r}")
                continue
            n += 1
            if np.isfinite(fx) and np.isfinite(fy):
                worst = max(worst, abs(fx - fy))
            if not (abs(fx - fy) <= rel * abs(fy) + LOG_UNIT
                    or (np.isnan(fx) and np.isnan(fy))):
                raise AssertionError(f"{what}: {la!r} against {lb!r}")
    return n, worst


def read_log(path: str) -> str:
    with open(path) as f:
        return f.read()


def torchrun_clis(paths, root: str):
    """Phase 14a: each of the four CLIs under torchrun at world size 1 with
    ``--data_parallel -1`` (the process group on NCCL), against the same
    CLI without torchrun on the same batches: the evaluation and the
    station evaluation against phases 4 and 13c's logs, the generation
    against phase 13b's fields, and training against an in-process run of
    the same DP_TRAIN_STEPS steps (its losses and its .pkt)."""
    import re

    import torch

    from vit_grid_model_tpu_torch.cli import train_vit

    pkg = "vit_grid_model_tpu_torch.cli."
    dp = ["--data_parallel", "-1"]
    t0 = time.perf_counter()
    log_dir = os.path.join(root, "logs14")
    torchrun(pkg + "evaluation_vit", eval_argv(paths, EVAL_WINDOW, log_dir)
             + ["--collect_valid_times"] + dp)
    n, worst = logs_close(
        read_log(os.path.join(log_dir, "test_smoke.log")),
        read_log(os.path.join(root, "logs", "test_smoke.log")),
        DP_TORCHRUN_REL, "evaluation under torchrun")
    print(f"evaluation: {n} numbers of the log within {DP_TORCHRUN_REL:g} "
          f"of phase 4's (max|d| {worst:.4g}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    torchrun(pkg + "station_eval",
             eval_argv(paths, STATION_WINDOW, log_dir) + dp)
    n, worst = logs_close(
        read_log(os.path.join(log_dir, "test_smoke_by_stn.log")),
        read_log(os.path.join(root, "station_logs", "test_smoke_by_stn.log")),
        DP_TORCHRUN_REL, "station evaluation under torchrun")
    print(f"station evaluation: {n} numbers of the log within "
          f"{DP_TORCHRUN_REL:g} of phase 13c's (max|d| {worst:.4g}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    out_dir = os.path.join(root, "fields14")
    # as @FILE: torchrun's parser takes --start for an ambiguous
    # abbreviation of --start-method/--start_method on some versions
    args_file = os.path.join(root, "generation14.args")
    with open(args_file, "w") as f:
        f.write("\n".join(generation_argv(paths, out_dir) + dp) + "\n")
    torchrun(pkg + "generate_reanalysis", ["@" + args_file])
    names = sorted(os.listdir(out_dir))
    if names != sorted(os.listdir(os.path.join(root, "fields"))):
        raise AssertionError("generation under torchrun wrote other files")
    worst = 0.0
    for name in names:
        ours = np.load(os.path.join(out_dir, name))
        ref = np.load(os.path.join(root, "fields", name))
        worst = max(worst, float(np.abs(ours - ref).max()
                                 / np.abs(ref).max()))
    if not worst <= DP_TORCHRUN_REL:
        raise AssertionError(f"generation under torchrun: a field differs "
                             f"by {worst:.3e} of its max")
    print(f"generation: {len(names)} fields, max|d| / max|field| = "
          f"{worst:.3e} against phase 13b's; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    t0 = time.perf_counter()
    # the in-process run takes a fresh process's float32 switches, as the
    # torchrun one does (the --fast evaluation CLIs turned TF32 on)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    runs = {}
    for name in ("in-process", "torchrun"):
        run_root = os.path.join(root, f"train14_{name}")
        argv = train_argv(DP_TRAIN_STEPS, run_root)
        if name == "torchrun":
            text = torchrun(pkg + "train_vit", argv + dp)
        else:
            lines = []
            train_vit.main(argv, log=lines.append)
            text = "\n".join(lines)
        losses = [float(v) for v in re.findall(r"loss=(\S+)", text)]
        sd = torch.load(os.path.join(run_root, "check_points", "smoke.pkt"),
                        weights_only=True)
        runs[name] = (losses, sd)
    (l1, sd1), (l2, sd2) = runs["in-process"], runs["torchrun"]
    if len(l1) != DP_TRAIN_STEPS or len(l2) != len(l1) or not all(
            abs(a - b) <= DP_TORCHRUN_REL * abs(b) + LOG_UNIT
            for a, b in zip(l2, l1)):
        raise AssertionError(f"training under torchrun: losses {l2} "
                             f"against {l1}")
    worst = max(float((sd2[k].float() - v.float()).abs().max()
                      / max(v.float().abs().max(), 1e-30))
                for k, v in sd1.items() if v.is_floating_point())
    if not worst <= DP_TORCHRUN_REL:
        raise AssertionError(f"training under torchrun: a weight differs "
                             f"by {worst:.3e} of its max")
    print(f"training, {DP_TRAIN_STEPS} steps: losses {l2} against {l1}; "
          f".pkt max|d| / max|w| = {worst:.3e}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)


def dp_eval_configs(paths):
    """The --fast evaluation CLI's configs for phase 14b's window."""
    from vit_grid_model_tpu_torch.cli import evaluation_vit as ev

    args = ev.build_parser().parse_args(eval_argv(paths, DP_EVAL_WINDOW,
                                                  "unused"))
    return ev.build_configs(args)


def dp_train_batch(cfg, group):
    """Phase 14b's train batch: TRAIN_BATCH samples of ``cfg``'s input,
    from SEED; this rank's rows of them with a process ``group``, and the
    global timestamps."""
    from vit_grid_model_tpu_torch.parallel.mesh import shard_rows

    rng = np.random.default_rng(SEED + 14)
    b, t, hw = TRAIN_BATCH, cfg.window_size, (cfg.input_height,
                                              cfg.input_width)
    ts = np.stack([np.full((b, t), 2023.0), rng.integers(1, 13, (b, t)),
                   rng.integers(1, 29, (b, t)),
                   rng.integers(0, 24, (b, t))], -1).astype(np.float32)
    x = rng.random((b, t, cfg.n_variables) + hw) * 50
    targets = rng.random((b, cfg.end_lead_time) + hw) * 60
    return {"x": shard_rows(x.astype(np.float32), group), "timestamps": ts,
            "targets": shard_rows(targets.astype(np.float32), group)}


def dp_run(paths, log_dir: str, group):
    """Phase 14b's work on one rank (``group``) or in one process (None):
    the --fast evaluation over DP_EVAL_WINDOW at batch DP_EVAL_BATCH, then
    one --fast train step at dropout DROPOUT.  Returns the evaluation's log
    (None off rank 0), the step's loss, a digest of the trained state and
    the kernels' launches in each part."""
    import dataclasses
    import hashlib

    import torch

    from vit_grid_model_tpu_torch.core import distributed
    from vit_grid_model_tpu_torch.core.config import TrainConfig
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.evaluation import driver
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.train.trainer import (build_train_step,
                                                        init_train_state)

    dev = torch.device(DP_DEVICE)
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    data_cfg, cfg, start, end = dp_eval_configs(paths)
    model = seeded_model(cfg, SEED).to(dev)
    if group is not None:
        distributed.broadcast_module(model, group)
    model = model.to(torch.bfloat16)
    cuda_attn.reset_launches()
    t0 = time.perf_counter()
    metrics = driver.evaluate(
        model, data_cfg, model_name="dp", test_start=start, test_end=end,
        batch_size=DP_EVAL_BATCH, num_workers=2, log_dir=log_dir,
        progress=False, group=group)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    eval_launches = cuda_attn.launches
    eval_designs = dict(cuda_attn.fwd_route_launches)
    log = (read_log(os.path.join(log_dir, "test_dp.log"))
           if metrics is not None else None)

    tcfg = dataclasses.replace(cfg, nhwc_input=False, dropout=DROPOUT)
    state = init_train_state(seeded_model(tcfg, SEED).to(dev),
                             TrainConfig(batch_size=TRAIN_BATCH,
                                         seed=SEED))
    if group is not None:
        distributed.broadcast_module(state.model, group)
    step = build_train_step(tcfg, TrainConfig(batch_size=TRAIN_BATCH,
                                              seed=SEED), group)
    batch = dp_train_batch(tcfg, group)
    cuda_attn.reset_launches()
    t0 = time.perf_counter()
    loss = float(step(state, batch)["loss"])
    torch.cuda.synchronize()
    step_s = time.perf_counter() - t0
    counts = (cuda_attn.launches, cuda_attn.bwd_launches,
              cuda_attn.wgrad_launches, cuda_attn.hash_launches)
    train_designs = dict(cuda_attn.fwd_route_launches)
    digest = hashlib.sha256()
    for k, v in state.model.state_dict().items():
        digest.update(k.encode())
        digest.update(v.detach().cpu().contiguous().view(-1)
                      .view(torch.uint8).numpy().tobytes())
    return dict(log=log, eval_launches=eval_launches, eval_s=eval_s,
                loss=loss, train_counts=counts, step_s=step_s,
                digest=digest.hexdigest(), eval_designs=eval_designs,
                train_designs=train_designs)


def dp_rank(paths, root: str):
    """Phase 14b on one of two ranks on cuda:0."""
    from vit_grid_model_tpu_torch.core import distributed

    group = distributed.group()
    return dp_run(paths, os.path.join(root, "logs14b"), group)


def ranks_on_one_card(paths, root: str, card: str):
    """Phase 14b: two processes on cuda:0 over gloo (a CLI would map rank 1
    to cuda:1) run the library functions with a process group, against one
    process on the same card: the evaluation log within DP_RANKS_REL, the
    step's loss within DP_RANKS_REL, the two ranks' trained states
    bit-equal, and each rank's kernel launches."""
    from vit_grid_model_tpu_torch.parallel.local_ranks import run_local_ranks

    t0 = time.perf_counter()
    ranks = run_local_ranks(dp_rank, 2, (paths, root), device=DP_DEVICE,
                            root=root)
    spawn_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = dp_run(paths, os.path.join(root, "logs14b_one"), None)
    one_s = time.perf_counter() - t0
    r0, r1 = ranks
    layers = 1                                   # MaxViT depth (1,)
    start, end = DP_EVAL_WINDOW
    samples = int((end - start).total_seconds() // 3600) + 1
    full, tail = divmod(samples, DP_EVAL_BATCH)
    if not tail % 2:
        raise AssertionError("phase 14b's window must end in a ragged batch")
    want_eval = (2 * layers * (full + 1), 2 * layers * full)
    got_eval = (r0["eval_launches"], r1["eval_launches"])
    want_train = (2 * layers,) * 3 + (4 * layers,)
    print(f"two ranks on cuda:0 over gloo: K1 launches in the evaluation "
          f"{got_eval} (expected {want_eval}: rank 0 also runs the ragged "
          f"{tail}); in the train step (K1, K3, K3-w, dropout hash) "
          f"{r0['train_counts']} and {r1['train_counts']} (expected "
          f"{want_train} each); one process: evaluation "
          f"{one['eval_launches']}, step {one['train_counts']}", flush=True)
    if r1["log"] is not None:
        raise AssertionError("rank 1 wrote the evaluation log")
    n, worst = logs_close(r0["log"], one["log"], DP_RANKS_REL,
                          "two ranks against one process")
    rel = abs(r0["loss"] - one["loss"]) / abs(one["loss"])
    print(f"evaluation: {n} numbers of rank 0's log within {DP_RANKS_REL:g} "
          f"of one process's (max|d| {worst:.4g}); step loss {r0['loss']:.6f} and "
          f"{r1['loss']:.6f} on the ranks, {one['loss']:.6f} in one process "
          f"(rel {rel:.2e}); trained states {r0['digest'][:16]} and "
          f"{r1['digest'][:16]}", flush=True)
    if r0["loss"] != r1["loss"] or not rel <= DP_RANKS_REL:
        raise AssertionError("the ranks' loss is not the one-process loss")
    if r0["digest"] != r1["digest"]:
        raise AssertionError("the ranks' trained states differ")
    if got_eval != want_eval:
        raise AssertionError("the ranks did not run their rows (and rank 0 "
                             "the ragged batch) through K1")
    if r0["train_counts"] != want_train or r1["train_counts"] != want_train:
        raise AssertionError("a rank's train step did not run every window "
                             "attention through K1, K3 and K3-w")
    print(f"seconds: two ranks (spawn, build, evaluation and step) "
          f"{spawn_s:.1f}, of which rank 0's evaluation {r0['eval_s']:.1f} "
          f"and step {r0['step_s']:.2f}; one process {one_s:.1f}, of which "
          f"evaluation {one['eval_s']:.1f} and step {one['step_s']:.2f}; "
          f"card: {card}", flush=True)
    K1_DESIGNS_BY_PATH["data parallel evaluation, rank 0"] = r0[
        "eval_designs"]
    K1_DESIGNS_BY_PATH["data parallel train step, rank 0"] = r0[
        "train_designs"]
    return r0["eval_launches"], r0["train_counts"]


def kernel_case(heads, dim_head, dim, conditioned, bw, offset, dev, dtype,
                window=7):
    """A layer from ``attention_case`` on the card: (module, x, cond, the
    kernels' inputs, a cotangent dy), all from numpy seeds."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices

    m, x, cond = attention_case(heads, dim_head, dim, conditioned, bw,
                                offset, SEED, window)
    m = m.to(dev, dtype)
    xt = torch.from_numpy(x).to(dev, dtype)
    ct = None if cond is None else torch.from_numpy(cond).to(dev, dtype)
    bias_idx = relative_position_indices(window, 4, device=dev)
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
    """Phase 2b: the CUDA keep mask against ``ops/dropout.py::keep_mask``,
    each launch on the kernel's chunks design.  Returns (max|diff|, kernel
    ms, plain ms) at the flagship shape."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.dropout import keep_mask
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    report = None
    for heads in (32, 3):
        before = dict(cuda_attn.mask_route_launches)
        ours = cuda_attn.dropout_keep_mask(DROPOUT_SEED, TRAIN_WINDOWS, heads,
                                           53, DROPOUT, dev)
        launched_design(cuda_attn, before, "chunks", 1,
                        f"keep mask heads={heads}",
                        cuda_attn.mask_route_launches)
        ref = keep_mask(DROPOUT_SEED, TRAIN_WINDOWS, heads, 53, DROPOUT,
                        device=dev)
        torch.cuda.synchronize()
        equal = torch.equal(ours, ref)
        dropped = (ours == 0).float().mean(dim=(0, 2, 3))
        worst = (dropped - DROPOUT).abs().max().item()
        err = (ours - ref).abs().max().item()
        line = (f"keep mask heads={heads:2d} Bw={TRAIN_WINDOWS} seed="
                f"{DROPOUT_SEED}: chunks design; bit-equal {equal}; dropped "
                "share per head "
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
    given the same keep mask, in every training case (windows of 7 and 5);
    a second launch bit-identical.  Returns {dtype: (max abs err, kernel
    ms, plain ms)} of the flagship case at Bw 1,440, the plain time with
    its keep mask drawn."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.ops.dropout import keep_mask
    from vit_grid_model_tpu_torch.ops.window import relative_position_indices
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    report = {}
    for name, heads, dh, dim, conditioned, bw, offset, window in TRAIN_CASES:
        bias_idx = relative_position_indices(window, 4, device=dev)
        n = window * window + 4
        for dtype_name, tol in TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            m, xt, ct, _, _ = kernel_case(heads, dh, dim, conditioned, bw,
                                          offset, dev, dtype, window)

            def run_kernel():
                return cuda_attn.window_attention(
                    m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE,
                    seed=DROPOUT_SEED, dropout_rate=DROPOUT)

            def run_plain():
                mask = keep_mask(DROPOUT_SEED, bw, heads, n, DROPOUT,
                                 device=dev)
                return plain.attention(
                    m, xt, ct, bias_idx, windows_per_sample=WINDOWS_PER_SAMPLE,
                    dropout_mask=mask)

            with torch.inference_mode():
                ours = run_kernel()
                again = run_kernel()
                ref = run_plain()
                torch.cuda.synchronize()
                if not torch.equal(ours, again):
                    raise AssertionError(f"{name} {dtype_name}: two "
                                         "launches with dropout differ")
                ours, ref = ours.float(), ref.float()
                if not bool(torch.isfinite(ours).all()):
                    raise AssertionError(f"{name} {dtype_name}: not finite")
                err = (ours - ref).abs().max().item()
                scale = ref.abs().max().item()
                line = (f"{name:14s} {dtype_name:8s} Bw={bw:5d} n={n} rate "
                        f"{DROPOUT}: max|d|={err:.3e} rel={err / scale:.3e} "
                        f"(tol {tol:g}); bit-identical rerun")
                if name == "flagship":
                    k_ms = cuda_ms(run_kernel)
                    p_ms = cuda_ms(run_plain)
                    bound = attention_bound_ms(bw, n, dim, heads, dh, 2)
                    line += (f"\n  kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms"
                             f" (with its mask)  bound {bound[0]:.3f} ms "
                             f"({bound[1]})")
                    report[dtype_name] = (err, k_ms, p_ms)
            print(line, flush=True)
            if not err <= tol * scale:
                raise AssertionError(f"{name} {dtype_name}: the kernel with "
                                     f"dropout differs from plain by {err}")
            del m, xt, ct, ours, again, ref
            torch.cuda.empty_cache()
    return report


def wgrad_vs_plain(xt, k, dy, rate, card):
    """K3-w, the weight gradients of K3's tensor-core path, against its
    plain version on the operands K3 writes for the bf16 flagship case:
    (max abs err, kernel ms, plain ms, (bound ms, bound by)).  Raises on a
    second launch that is not bit-identical or an error above 1e-4 of
    max|plain| (f32 sums in another order; the bf16 products are exact)."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    _, ops = cuda_attn.window_attention_bwd_kernel(xt, k, dy, DROPOUT_SEED,
                                                   rate)
    rows, dim = ops.xf.shape
    heads, _, three_dh = k.wqkv.shape
    dy2 = dy.view(rows, dim)
    ours = cuda_attn.window_attention_wgrad(ops, dy2, heads)
    again = cuda_attn.window_attention_wgrad(ops, dy2, heads)
    ref = cuda_attn.window_attention_wgrad_reference(ops, dy2, heads)
    torch.cuda.synchronize()
    err = 0.0
    for name, a, a2, b in zip(("dwqkv", "dwout"), ours, again, ref):
        if not torch.equal(a, a2):
            raise AssertionError(f"K3-w {name}: two launches differ")
        e = (a - b).abs().max().item()
        if not e <= 1e-4 * b.abs().max().item():
            raise AssertionError(f"K3-w {name} differs from plain by {e}")
        err = max(err, e)
    w_ms = cuda_ms(lambda: cuda_attn.window_attention_wgrad(ops, dy2, heads))
    p_ms = cuda_ms(lambda: cuda_attn.window_attention_wgrad_reference(
        ops, dy2, heads))
    bound = wgrad_bound_ms(rows, dim, heads, three_dh // 3)
    print(f"  K3-w (weight gradients, {rows} rows): kernel {w_ms:.3f} ms  "
          f"plain {p_ms:.3f} ms  bound {bound[0]:.3f} ms ({bound[1]}); "
          f"max|d| {err:.3e}; bit-identical rerun; card: {card}", flush=True)
    return err, w_ms, p_ms, bound


def backward_vs_plain(dev, card):
    """Phase 2d: the backward kernel against autograd through the plain
    forward.  Returns {dtype: (max abs err over the grads, K3 ms, plain
    ms, fwd+bwd kernel ms, K3-w's report or None)} at the flagship shape,
    rate 0.1."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    report = {}
    for name, heads, dh, dim, conditioned, bw, offset, window in TRAIN_CASES:
        for dtype_name, tol in BWD_TOLERANCE.items():
            dtype = getattr(torch, dtype_name)
            _, xt, _, k, dy = kernel_case(heads, dh, dim, conditioned, bw,
                                          offset, dev, dtype, window)
            for rate in (0.0, DROPOUT):
                errs = bwd_errors(xt, k, dy, DROPOUT_SEED, rate)
                worst = max(e / s if s else e for e, s in errs.values())
                line = (f"{name:14s} {dtype_name:8s} Bw={bw:5d} rate {rate}: "
                        f"worst rel {worst:.3e} (tol {tol:g}); " + " ".join(
                            f"{g}={e / s if s else e:.1e}"
                            for g, (e, s) in errs.items()))
                wgrad = None
                if name == "flagship" and rate == DROPOUT:
                    args = (xt, k, dy, DROPOUT_SEED, rate)
                    bwd = cuda_attn.window_attention_bwd
                    ref = cuda_attn.window_attention_bwd_reference
                    k3_ms = cuda_ms(lambda: cuda_attn.
                                    window_attention_bwd_kernel(*args),
                                    iters=5)
                    b_ms = cuda_ms(lambda: bwd(*args), iters=5)
                    r_ms = cuda_ms(lambda: ref(*args), iters=5)
                    both_ms = cuda_ms(lambda: (
                        cuda_attn.window_attention_fwd(xt, k, DROPOUT_SEED,
                                                       rate),
                        bwd(*args)), iters=5)
                    line += (f"\n  backward: K3 {k3_ms:.3f} ms, K3 + K3-w "
                             f"{b_ms:.3f} ms  plain {r_ms:.3f} ms (autograd "
                             f"through the plain forward); forward + "
                             f"backward: kernels {both_ms:.3f} ms; card: "
                             f"{card}")
                    print(line, flush=True)
                    line = None
                    if dtype_name == "bfloat16":
                        wgrad = wgrad_vs_plain(xt, k, dy, rate, card)
                    report[dtype_name] = (max(e for e, _ in errs.values()),
                                          k3_ms, r_ms, both_ms, wgrad)
                if line is not None:
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
        argv = train_argv(TRAIN_STEPS, root)
        lines, seconds = [], []

        def log(line):
            print(line, flush=True)
            lines.append(line)

        cuda_attn.reset_launches()
        state = cli.main(argv, step_seconds=seconds, log=log)
        torch.cuda.synchronize()
        note_k1_designs("training")
        counts = {"window_attention_fwd": cuda_attn.launches,
                  "window_attention_bwd": cuda_attn.bwd_launches,
                  "window_attention_wgrad": cuda_attn.wgrad_launches,
                  "dropout_keep_mask": cuda_attn.hash_launches}
        cfg = state.model.cfg
        eval_model = load_reference_checkpoint(
            os.path.join(ckpt_dir, "smoke.pkt"), cfg)
        trained = {k: v.detach().cpu() for k, v in
                   state.model.state_dict().items()}
    layers = sum(cfg.depth_tuple)
    want = 2 * layers * TRAIN_STEPS
    print(f"kernel launches {counts} (expected fwd = bwd = wgrad = 2 x "
          f"{layers} x {TRAIN_STEPS} = {want}, dropout hash in fwd and bwd: "
          f"{2 * want})", flush=True)
    if (counts["window_attention_fwd"], counts["window_attention_bwd"],
            counts["window_attention_wgrad"],
            counts["dropout_keep_mask"]) != (want, want, want, 2 * want):
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
# tiled axis; rows of 56 pixels take bands of 6 rows in seven m64 tiles
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
    ("wide rows 9x56", 2, 9, 56, 128, "bfloat16", 1),
    ("wide rows 9x56", 2, 9, 56, 128, "bfloat16", 4),
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


def mbconv_errors(x, ops, spb, outputs=None):
    """The fused MBConv kernel against its plain version: see
    ``kernel_errors``; the kernel's output is appended to ``outputs`` when
    it is given."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda.mbconv import fused_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import fused_mbconv_reference

    with torch.inference_mode():
        ours = fused_mbconv(x, ops, samples_per_block=spb)
        again = fused_mbconv(x, ops, samples_per_block=spb)
        ref = fused_mbconv_reference(x, ops)
        torch.cuda.synchronize()
    if outputs is not None:
        outputs.append(ours)
    return kernel_errors(ours, again, ref, "fused MBConv")


def mbconv_design(before):
    """The design the fused MBConv's launches since the route counts were
    ``before`` took; raises when they took more than one."""
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv

    took = {k for k, v in cuda_mbconv.launches_by_route.items()
            if v > before.get(k, 0)}
    if len(took) != 1:
        raise AssertionError(f"fused MBConv launches took designs {took}")
    return took.pop()


def mbconv_vs_plain(dev):
    """Phase 7a: the R15 kernel against its plain version on the card, on
    the repro harness's block and on the 12-hour model's own layer-0 MBConv
    (which has no residual: the fused form computes block(x) + x).  Every
    launch must take the design the route names, and that is the bands
    design for every bf16 one (the first for f32); a bf16 case's outputs at 1 and 4 samples a block must be
    bit-identical.  Returns max|kernel - plain| at BN 384, bf16, one
    sample per block."""
    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
    from vit_grid_model_tpu_torch.ops.mbconv import mbconv_kernel_operands
    from vit_grid_model_tpu_torch.repros import fused_mbconv as repro

    report = None
    by_spb = {}
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
        before = dict(cuda_mbconv.launches_by_route)
        outs = []
        err, scale = mbconv_errors(x, ops, spb, outs)
        design = mbconv_design(before)
        tol = TOLERANCE[dtype_name]
        rows = cuda_mbconv.rows(w, c, dtype)
        print(f"{name:22s} {dtype_name:8s} {n:3d}x{h}x{w}x{c} spb={spb}: "
              f"max|d|={err:.3e} max|plain|={scale:.3e} rel={err / scale:.3e}"
              f" (tol {tol:g}); second launch bit-identical; {design} "
              f"design, {rows} rows a band or tile", flush=True)
        expected = cuda_mbconv.route(n, h, w, c, 4 * c, c, dtype)
        if dtype_name == "bfloat16" and expected != "bands":
            raise AssertionError(f"{name}: the route names the {expected} "
                                 "design for bf16")
        if design != expected:
            raise AssertionError(f"{name} {dtype_name} spb={spb}: the fused "
                                 f"MBConv took the {design} design, not "
                                 f"the {expected}")
        if not err <= tol * scale:
            raise AssertionError(f"{name} {dtype_name} spb={spb}: the fused "
                                 f"MBConv differs from plain by {err}")
        key = (name, dtype_name, source)
        if design == "bands" and key in by_spb:
            if not torch.equal(by_spb[key], outs[0]):
                raise AssertionError(f"{name}: the bands design's output "
                                     "depends on the samples a block")
            print(f"{name:22s} {dtype_name:8s}: spb=1 and spb={spb} "
                  "bit-identical", flush=True)
        by_spb.setdefault(key, outs[0])
        if (n, dtype_name, spb, source) == (384, "bfloat16", 1, "repro"):
            report = err
        del x, ops, outs
        torch.cuda.empty_cache()
    del by_spb
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


# R1/R14 comparison cases: (name, Bw, n, dim, heads, dim_head, dtype,
# head-0 bias offset); Bw 37 leaves a ragged last tile at 8 and at 16
# windows a CTA, n 64, 49 and 9 fill the 64-row tile wholly, ragged and
# mostly with padding, and -200 puts head 0's scores ~200 below head 1's
PERHEAD_CASES = [
    ("repro Bw=2,880", 2880, 56, 128, 32, 32, "bfloat16", 0.0),
    ("f32 Bw=40", 40, 56, 128, 32, 32, "float32", 0.0),
    ("ragged Bw=37", 37, 56, 128, 32, 32, "bfloat16", 0.0),
    ("3 heads x 16", 37, 56, 48, 3, 16, "float32", 0.0),
    ("3 heads x 16", 37, 56, 48, 3, 16, "bfloat16", 0.0),
    ("n=64", 37, 64, 128, 32, 32, "bfloat16", 0.0),
    ("n=49", 37, 49, 128, 32, 32, "bfloat16", 0.0),
    ("n=9", 37, 9, 128, 32, 32, "bfloat16", 0.0),
    ("n=9 3 x 16", 37, 9, 48, 3, 16, "bfloat16", 0.0),
    ("diverging", 40, 56, 128, 32, 32, "bfloat16", -200.0),
    ("diverging", 40, 56, 128, 32, 32, "float32", -200.0),
]


def perhead_design(n, dim, dh, dtype_name):
    """The design the per-head kernel (R1, R14, R9) takes at these widths:
    the wgmma design in bf16 at dim_head 16 or 32, dim a multiple of 16 up
    to 176 (dim_head 32) or 288 (16), n <= 64; else the first design."""
    widest = 176 if dh == 32 else 288
    return ("wgmma" if dtype_name == "bfloat16" and dh in (16, 32)
            and dim % 16 == 0 and dim <= widest and n <= 64 else "first")


def wgmma_plan_bytes(n, dim, dh, buffers=3, warpgroups=3,
                     indicator_norm=False):
    """Shared memory a CTA of the per-head kernel's wgmma body takes (its
    ``make_wgmma_plan``): ``buffers`` head buffers of Wqkv_h^T tiles and
    bias rows (72 floats a row), each warpgroup's x and four 64 x dh
    operand planes, R3's indicator, an mbarrier and a counter a buffer,
    each part 128-byte aligned.  R4's and R3's layout is the default."""
    def a128(b):
        return (b + 127) // 128 * 128

    off = buffers * (a128(6 * dh * dim) + a128(288 * n))
    off += warpgroups * a128(128 * dim + 512 * dh)
    off += a128(32 * dh) if indicator_norm else 0
    return a128(off + buffers * 12)


def staged_ring_bytes(dh, stages=2):
    """Shared memory a CTA of R11's ring design takes: ``stages`` slots of
    q, k and v, 64 bf16 rows each at a stride of dim_head + 8."""
    return stages * 3 * 64 * (dh + 8) * 2


def staged_design(dtype_name):
    """The design R11's core takes: the ring design in bf16 (every width
    the entry takes), the first design in f32."""
    return "ring" if dtype_name == "bfloat16" else "first"


def grouped_design(n, dim, dh, dtype_name, group=2, indicator_norm=False):
    """The design R4's (and, with ``indicator_norm``, R3's) kernel takes at
    these widths and heads a staged x: the wgmma design in bf16 at dim_head
    16 or 32, dim a multiple of 16, n <= 64, group 1 or 2, while its plan
    (three head buffers and three warpgroups, R3's indicator) fits a CTA's
    232,448 B: dim up to 128 at dim_head 32 and 224 at 16 at every n;
    else the first design."""
    return ("wgmma" if dtype_name == "bfloat16" and dh in (16, 32)
            and dim % 16 == 0 and 1 <= n <= 64 and group in (1, 2)
            and wgmma_plan_bytes(n, dim, dh, indicator_norm=indicator_norm)
            <= 232448 else "first")


def launched_design(av, before, want, launches, what, counter=None):
    """Raises unless a kernel's launches since ``before`` (a copy of
    ``counter``, by default ``perhead_route_launches``) are ``launches`` on
    ``want``."""
    counter = av.perhead_route_launches if counter is None else counter
    took = {d: c - before.get(d, 0) for d, c in counter.items()
            if c > before.get(d, 0)}
    if took != {want: launches}:
        raise AssertionError(f"{what}: launches {took}, not {launches} on "
                             f"the {want} design")


def perhead_vs_plain(dev):
    """Phase 8a: the R1/R14 kernel against its plain version at 8 and 16
    windows a CTA, each launch on the design ``perhead_design`` names.
    Returns {windows a CTA: max|kernel - plain|} at Bw 2,880 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    report = {}
    for name, bw, n, dim, heads, dh, dtype_name, offset in PERHEAD_CASES:
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias = repro.inputs(bw, dtype, dev, SEED, n=n, dim=dim,
                                     heads=heads, dim_head=dh)
        bias[0] += offset
        want = perhead_design(n, dim, dh, dtype_name)
        if av.perhead_route(n, dim, dh, dtype) != want:
            raise AssertionError(f"{name} {dtype_name}: the kernel routes to "
                                 f"{av.perhead_route(n, dim, dh, dtype)}, "
                                 f"not {want}")
        with torch.inference_mode():
            ref = plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)
            for wpc in repro.WINDOWS_PER_CTA:
                before = dict(av.perhead_route_launches)
                ours = av.perhead_attention(x, wqkv, bias, wpc)
                again = av.perhead_attention(x, wqkv, bias, wpc)
                torch.cuda.synchronize()
                launched_design(av, before, want, 2,
                                f"{name} {dtype_name} wpc={wpc}")
                err, scale = kernel_errors(ours, again, ref,
                                             f"{name} wpc={wpc}")
                tol = TOLERANCE[dtype_name]
                print(f"{name:16s} {dtype_name:8s} Bw={bw:4d} n={n:2d} "
                      f"wpc={wpc:2d}: max|d|={err:.3e} max|plain|="
                      f"{scale:.3e} rel={err / scale:.3e} (tol {tol:g}); "
                      f"second launch bit-identical; {want} design",
                      flush=True)
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
# puts head 0's scores ~200 below head 1's in both attentions.  bf16 runs
# the strip design (its scratch map), f32 the first design; S = 37 is no
# multiple of the clusters the card holds at once
LAYER_CASES = [
    ("repro S=96", 96, "bfloat16", 0.0),
    ("flagship S=300", 300, "bfloat16", 0.0),
    ("f32 S=2", 2, "float32", 0.0),
    ("diverging S=4", 4, "bfloat16", -200.0),
    ("diverging S=4", 4, "float32", -200.0),
    ("single S=1", 1, "bfloat16", 0.0),
    ("ragged S=37", 37, "bfloat16", 0.0),
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
# R4's and R3's bf16 cases off the wgmma design's widths, each on the first
# design: dim_head 64, dim 144 at dim_head 32 (the three-buffer plan does
# not fit; R1's wgmma design still takes it) and 3 heads a group;
# (label, Bw, n, dim, heads, dim_head, heads a group or None: the
# wrapper's)
GROUPED_FIRST_CASES = [
    ("dim_head 64", 37, 56, 64, 2, 64, None),
    ("dim 144", 37, 56, 144, 4, 32, None),
    ("3 heads a group", 11, 56, 48, 3, 16, 3)]
# R10's strip design and R9's wgmma design at n 64, 49 and 9 (three of the
# tile's four 16-row strips wholly padding), at the repro's Bw and a ragged
# one; the same fields
STACKED_CASES = [
    ("n=64", 2880, 64, 128, 32, 32, "bfloat16", 0.0),
    ("n=64 ragged", 37, 64, 128, 32, 32, "bfloat16", 0.0),
    ("n=49 ragged", 37, 49, 128, 32, 32, "bfloat16", 0.0),
    ("n=9", 2880, 9, 128, 32, 32, "bfloat16", 0.0),
    ("n=9 diverging", 37, 9, 128, 32, 32, "bfloat16", -200.0),
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


def stacked_design(n, dim, dh, dtype_name):
    """The design R10's kernel takes at these widths: K1's strip body
    without the out-projection in bf16 at dim and dim_head multiples of 16,
    dim <= 128, dim_head <= 32; else the first design."""
    return ("strip" if dtype_name == "bfloat16" and dim % 16 == 0
            and dh % 16 == 0 and dim <= 128 and dh <= 32 else "first")


def variants_vs_plain(dev):
    """Phase 10a: R4's, R10's and R11's kernels, R11 whole and R9's route
    against their plain versions, R10 and R9 also at n 64, 49 and 9, each
    of R4's, R10's, R9's and R11's launches on the design
    ``grouped_design``, ``stacked_design``, ``perhead_design`` or
    ``staged_design`` names (R4's wgmma design
    bit-identical to R1's, its first design in bf16 on
    ``GROUPED_FIRST_CASES``).  Returns {route: max|kernel - plain|} at Bw
    2,880 and n 56 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    report = {}
    stacked = "stacked_softmax_attention"
    r9 = "perhead_weight_attention"
    for name, bw, n, dim, heads, dh, dtype_name, offset in (VARIANT_CASES
                                                            + STACKED_CASES):
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias = repro.inputs(bw, dtype, dev, SEED, n=n, dim=dim,
                                     heads=heads, dim_head=dh)
        bias[0] += offset
        tol = TOLERANCE[dtype_name]
        with torch.inference_mode():
            routes = variant_routes(x, wqkv, bias, heads, dh)
            if n != repro.N_PAD:
                routes = {stacked: routes[stacked], r9: routes[r9]}
            for route, (kernel, plain) in routes.items():
                ref = plain()
                before = dict(av.stacked_route_launches)
                before_r9 = dict(av.perhead_route_launches)
                before_r4 = dict(av.headmajor_route_launches)
                before_r11 = dict(av.staged_core_route_launches)
                ours = kernel()
                again = kernel()
                torch.cuda.synchronize()
                err, scale = kernel_errors(ours, again, ref, f"{name} {route}")
                design = ""
                if route == "headmajor_attention":
                    want = grouped_design(n, dim, dh, dtype_name,
                                          min(av.WGMMA_GROUP, heads))
                    launched_design(av, before_r4, want, 2,
                                    f"{name} {dtype_name} {route}",
                                    av.headmajor_route_launches)
                    design = f"; {want} design"
                    if want == "wgmma":
                        # bit-identical to R1's kernel on the same body
                        r1_out = av.perhead_attention(x, wqkv, bias, 8)
                        if not torch.equal(ours, r1_out):
                            raise AssertionError(f"{name} {route}: not "
                                                 "bit-identical to R1's "
                                                 "wgmma kernel")
                        design += ", bit-identical to R1's kernel"
                        del r1_out
                if route in ("staged_attention_core", "staged_attention"):
                    want = staged_design(dtype_name)
                    launched_design(av, before_r11, want, 2,
                                    f"{name} {dtype_name} {route}",
                                    av.staged_core_route_launches)
                    design = f"; {want} design"
                if route == r9:
                    want = perhead_design(n, dim, dh, dtype_name)
                    launched_design(av, before_r9, want, 2,
                                    f"{name} {dtype_name} {route}")
                    design = f"; {want} design"
                if route == stacked:
                    want = stacked_design(n, dim, dh, dtype_name)
                    took = {d: c - before.get(d, 0) for d, c in
                            av.stacked_route_launches.items()
                            if c > before.get(d, 0)}
                    if (took != {want: 2}
                            or av.stacked_route(n, dim, dh, dtype) != want):
                        raise AssertionError(f"{name} {dtype_name} {route}: "
                                             f"launches {took}, not two on "
                                             f"the {want} design")
                    design = f"; {want} design"
                print(f"{name:15s} {dtype_name:8s} Bw={bw:4d} n={n:2d} "
                      f"{route:26s}: max|d|={err:.3e} max|plain|={scale:.3e} "
                      f"rel={err / scale:.3e} (tol {tol:g}); second launch "
                      f"bit-identical{design}", flush=True)
                if not err <= tol * scale:
                    raise AssertionError(f"{name} {dtype_name} {route}: "
                                         f"kernel differs from plain by {err}")
                if bw == 2880 and n == repro.N_PAD:
                    report[route] = err
                del ref, ours, again
        del x, wqkv, bias, routes
        torch.cuda.empty_cache()
    grouped_first_vs_plain(dev, "headmajor_attention")
    return report


def grouped_first_vs_plain(dev, route):
    """R4's (``route`` "headmajor_attention") or R3's
    ("crosshead_norm_attention") kernel on ``GROUPED_FIRST_CASES``: each
    launch on the first design, as ``grouped_design`` says, within the bf16
    tolerance of the plain version, a second launch bit-identical."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as repro

    kernel = getattr(av, route)
    counter = (av.headmajor_route_launches if route == "headmajor_attention"
               else av.crosshead_route_launches)
    tol = TOLERANCE["bfloat16"]
    for name, bw, n, dim, heads, dh, group in GROUPED_FIRST_CASES:
        x, wqkv, bias = repro.inputs(bw, torch.bfloat16, dev, SEED, n=n,
                                     dim=dim, heads=heads, dim_head=dh)
        want = grouped_design(n, dim, dh, "bfloat16",
                              group or min(av.WGMMA_GROUP, heads),
                              route == "crosshead_norm_attention")
        if want != "first":
            raise AssertionError(f"{name}: {want}, not off the wgmma widths")
        with torch.inference_mode():
            ref = plain.perhead_qkv_attention(x, wqkv, bias, heads, dh)
            before = dict(counter)
            ours = kernel(x, wqkv, bias, group)
            again = kernel(x, wqkv, bias, group)
            torch.cuda.synchronize()
        launched_design(av, before, want, 2, f"{name} bfloat16 {route}",
                        counter)
        err, scale = kernel_errors(ours, again, ref, f"{name} {route}")
        print(f"{name:15s} bfloat16 Bw={bw:4d} n={n:2d} {route:26s}: "
              f"max|d|={err:.3e} max|plain|={scale:.3e} "
              f"rel={err / scale:.3e} (tol {tol:g}); second launch "
              f"bit-identical; first design", flush=True)
        if not err <= tol * scale:
            raise AssertionError(f"{name} bfloat16 {route}: kernel differs "
                                 f"from plain by {err}")
        del x, wqkv, bias, ref, ours, again


# the out-projection kernel's bf16 case off the strip design's widths
# (dim_head 64: the first design), fewer windows than a CTA takes
OUTPROJ_FIRST_CASES = [("dim_head 64", 5, 9, 32, 2, 64, "bfloat16", 0.0)]


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
    casts, R8's n_pad and windows a CTA) against their plain versions,
    each of R3's launches on the design ``grouped_design`` names (its wgmma
    design within ``against_r1``'s bounds of R1's wgmma kernel, its first
    design in bf16 on ``GROUPED_FIRST_CASES``).  Returns {route:
    max|kernel - plain|} at Bw 2,880 in bf16."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
    from vit_grid_model_tpu_torch.repros import npad_and_kfold as r8
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.grouped_sections import (
        R3_DIFFER_SHARE, R3_GAP, against_r1)
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    report = {}
    repro_bw = VARIANT_CASES[0][1]   # the repro's Bw 2,880

    def check(label, route, kernel, ref_call, tol, bw, want=None,
              r1_call=None):
        ref = ref_call()
        before = dict(av.outproj_route_launches)
        before_r3 = dict(av.crosshead_route_launches)
        ours = kernel()
        again = kernel()
        torch.cuda.synchronize()
        err, scale = kernel_errors(ours, again, ref, f"{label} {route}")
        # the out-projection kernel's design, as its wrapper counted it
        took = [d for d, c in av.outproj_route_launches.items()
                if c > before.get(d, 0)]
        design = f"; {took[0]} design" if took else ""
        if want is not None:   # R3's, as its wrapper counted it
            launched_design(av, before_r3, want, 2, f"{label} {route}",
                            av.crosshead_route_launches)
            design = f"; {want} design"
        if want == "wgmma":
            # only the norm's sums differ from R1's wgmma kernel
            gap, share, steps = against_r1(ours, r1_call(), scale)
            design += (f"; against R1's kernel {gap:.3e} of max|plain|, "
                       f"{share:.3e} of the elements differ (the largest by "
                       f"{steps:.1f} bf16 steps)")
            if not (gap <= R3_GAP and share <= R3_DIFFER_SHARE):
                raise AssertionError(f"{label} {route}: further from R1's "
                                     "wgmma kernel than the norm's sums "
                                     "allow")
        print(f"{label} {route:30s}: max|d|={err:.3e} max|plain|={scale:.3e} "
              f"rel={err / scale:.3e} (tol {tol:g}); second launch "
              f"bit-identical{design}", flush=True)
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
                                                      dh), tol, bw,
                  grouped_design(n, dim, dh, dtype_name,
                                 min(av.WGMMA_GROUP, heads), True),
                  lambda: av.perhead_attention(x, wqkv, bias, 8))
            for route, (kernel, ref_call) in outproj_routes(
                    x, wqkv, bias, wout, heads, dh, dtype_name, bw,
                    offset != 0).items():
                check(label, route, kernel, ref_call, tol, bw)
        del x, wqkv, bias, wout
        torch.cuda.empty_cache()
    grouped_first_vs_plain(dev, "crosshead_norm_attention")
    # bf16 off the strip design's widths: the first design
    for name, bw, n, dim, heads, dh, dtype_name, offset in OUTPROJ_FIRST_CASES:
        x, wqkv, bias, wout = ws.inputs(bw, getattr(torch, dtype_name), dev,
                                        SEED, n=n, dim=dim, heads=heads,
                                        dim_head=dh, out_dim=dim)
        label = f"{name:15s} {dtype_name:8s} Bw={bw:4d}"
        with torch.inference_mode():
            for route, (kernel, ref_call) in outproj_routes(
                    x, wqkv, bias, wout, heads, dh, dtype_name, bw,
                    False).items():
                check(label, route, kernel, ref_call,
                      TOLERANCE[dtype_name], bw)
        del x, wqkv, bias, wout
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
    f32 inputs give an f32 output (held to 1e-4) on the first design, bf16
    the repros' bf16 on the out-projection kernel's strip kernel, each
    build's output bit-identical to ``outproj_attention``'s at the same
    windows a CTA.  Returns {K: max|kernel - plain|} at Bw 2,880 in bf16,
    two passes, 8 windows a CTA (the repros' main build)."""
    import torch

    from vit_grid_model_tpu_torch.ops import attention_variants as plain
    from vit_grid_model_tpu_torch.ops.cuda import attention_variants as av
    from vit_grid_model_tpu_torch.repros import baseline_perhead as r1
    from vit_grid_model_tpu_torch.repros import weightsliced_variants as ws
    from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

    report = {}
    for name, bw, dtype_name, offset in HEADPACK_CASES:
        dtype = getattr(torch, dtype_name)
        x, wqkv, bias, wout = ws.inputs(bw, dtype, dev, SEED)
        bias[1::2] += offset
        tol = TOLERANCE[dtype_name]
        want = "strip" if dtype_name == "bfloat16" else "first"
        if av.headpack_route(x.shape[1], x.shape[2], r1.DIM_HEAD,
                             wout.shape[-1], dtype) != want:
            raise AssertionError(f"{name} {dtype_name}: the head-pack "
                                 f"kernel's route is not the {want} design")
        with torch.inference_mode():
            ref = plain.outproj_attention(x, wqkv, bias, wout, r1.HEADS,
                                          r1.DIM_HEAD, out_dtype=dtype)
            family = {wpc: av.outproj_attention(
                x, weight4(wqkv, r1.HEADS), bias, wout, two_pass=True,
                perhead_wout=True, windows_per_cta=wpc, out_dtype=dtype)
                for wpc in (8, 16)} if want == "strip" else {}
            for k in HEADPACK_K:
                for two_pass in (True, False):
                    for wpc in (8, 16):
                        def call():
                            return av.headpack_attention(
                                x, wqkv, bias, wout, k_pack=k,
                                two_pass=two_pass, windows_per_cta=wpc,
                                out_dtype=dtype)

                        before = av.headpack_route_launches[want]
                        ours, again = call(), call()
                        torch.cuda.synchronize()
                        what = (f"{name:15s} {dtype_name:8s} Bw={bw:4d} K={k} "
                                f"{'2' if two_pass else '1'}pass wpc={wpc:2d}")
                        err, scale = kernel_errors(ours, again, ref, what)
                        if av.headpack_route_launches[want] != before + 2:
                            raise AssertionError(f"{what}: its launches did "
                                                 f"not take the {want} "
                                                 "design")
                        same = ""
                        if want == "strip":
                            if not torch.equal(ours, family[wpc]):
                                raise AssertionError(
                                    f"{what}: differs from outproj_"
                                    "attention's strip design")
                            same = ("; = outproj_attention's at this wpc, "
                                    "bit for bit")
                        print(f"{what}: max|d|={err:.3e} max|plain|="
                              f"{scale:.3e} rel={err / scale:.3e} (tol "
                              f"{tol:g}); second launch bit-identical; "
                              f"{want} design{same}", flush=True)
                        if not err <= tol * scale:
                            raise AssertionError(f"{what}: kernel differs "
                                                 f"from plain by {err}")
                        if (bw, two_pass, wpc) == (2880, True, 8):
                            report[k] = err
                        del ours, again
        del x, wqkv, bias, wout, ref, family
        torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# phase 15: the class head and int8 PTQ
# ---------------------------------------------------------------------------


def class_head_config(**over):
    """The shipped 12-hour configuration with the class head, the PM10
    head and the regional heads."""
    import dataclasses

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.data.synthetic import DEFAULT_FEAT_INFOS

    mean, std = DEFAULT_FEAT_INFOS["PM2.5"]
    return dataclasses.replace(
        shipped_12hr_model_config(pm25_mean=mean, pm25_std=std),
        pm25_class_head=True, pm10=True, direct_regional=True, **over)


def class_head_batch(batch: int, seed: int):
    """x, timestamps, class labels (with NaN cells) and regional targets
    (with a NaN) for ``batch`` samples, as CPU tensors."""
    import torch

    rng = np.random.default_rng(seed)
    x = (rng.random((batch, 25, 24, 82, 67)) * 50).astype(np.float32)
    ts = np.stack([np.full((batch, 25), 2023.0), np.ones((batch, 25)),
                   np.full((batch, 25), 15.0),
                   np.tile(np.arange(25) % 24, (batch, 1))],
                  axis=-1).astype(np.float32)
    labels = (rng.random((batch * 12, 82, 67)) * 90).astype(np.float32)
    labels[0, :3] = np.nan
    regions = (rng.random((batch * 12, 19)) * 40).astype(np.float32)
    regions[0, 5] = np.nan
    return tuple(torch.from_numpy(a) for a in (x, ts, labels, regions))


def class_targets(labels, regions):
    return dict(labels_pm25=labels, region_targets_pm25=regions,
                labels_pm10=labels, region_targets_pm10=regions)


def class_head_path(dev, card: str):
    """Phase 15a: the class outputs of the 12-hour model with the class,
    PM10 and regional heads in f32, one sample on the GPU against the CPU;
    then one training-mode loss and backward at batch 2 with dropout 0.1
    (K1, K3 and the dropout hash, f32), and with ``ignore_backbone`` the
    regional losses' gradient on the backbone.  Returns the step's launch
    counts."""
    import torch

    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.repros.common import cuda_ms

    # f32 products in f32: the --fast CLIs of earlier phases turn TF32 on
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = class_head_config()
    layers = sum(cfg.depth_tuple)
    x, ts, labels, regions = class_head_batch(1, SEED + 5)
    with torch.inference_mode():
        ref = seeded_model(cfg, SEED).class_outputs(
            x, ts, **class_targets(labels, regions))
        model = seeded_model(cfg, SEED).to(dev)
        cuda_attn.reset_launches()
        out = model.class_outputs(x.to(dev), ts.to(dev), **class_targets(
            labels.to(dev), regions.to(dev)))
        torch.cuda.synchronize()
        launched = cuda_attn.launches
    if launched != 2 * layers:
        raise AssertionError(f"{launched} K1 launches in one class forward")
    if set(out) != set(ref):
        raise AssertionError(f"keys {sorted(out)} vs {sorted(ref)}")
    worst = {}
    for k in ("logits_pm25", "logits_pm10", "region_preds_pm25",
              "region_preds_pm10"):
        r, o = ref[k], out[k].cpu()
        worst[k] = ((o - r).abs().max() / r.abs().max()).item()
    loss_rel = {k: abs(float(out[k]) - float(ref[k])) / abs(float(ref[k]))
                for k in ref if "loss" in k}
    print(f"class outputs, 12hr f32, 1 sample, GPU vs CPU: max|d|/max "
          f"{ {k: f'{v:.2e}' for k, v in worst.items()} } (tol 1e-3); "
          f"losses rel {max(loss_rel.values()):.2e} (tol 1e-4); loss "
          f"{float(out['loss']):.4f}; K1 launches {launched}", flush=True)
    if not (max(worst.values()) <= 1e-3 and max(loss_rel.values()) <= 1e-4):
        raise AssertionError("GPU and CPU class outputs differ")

    # training mode: batch 2, dropout 0.1, f32
    x, ts, labels, regions = (t.to(dev) for t in class_head_batch(
        2, SEED + 6))
    model = seeded_model(class_head_config(dropout=DROPOUT), SEED).to(dev)
    model.train()
    gen = torch.Generator().manual_seed(SEED)

    def step():
        model.zero_grad(set_to_none=True)
        loss = model.class_outputs(x, ts, generator=gen, bn_stats=[],
                                   **class_targets(labels, regions))["loss"]
        loss.backward()
        return loss

    cuda_attn.reset_launches()
    loss = step()
    torch.cuda.synchronize()
    note_k1_designs("class-head step")
    counts = {"window_attention_fwd": cuda_attn.launches,
              "window_attention_bwd": cuda_attn.bwd_launches,
              "window_attention_wgrad": cuda_attn.wgrad_launches,
              "dropout_keep_mask": cuda_attn.hash_launches}
    want = (2 * layers, 2 * layers, 0, 4 * layers)
    if tuple(counts.values()) != want:
        raise AssertionError(f"class-head step launches {counts}, expected "
                             f"{want}")
    fc = model.regr_regional_pm25[2].weight.grad
    if not (torch.isfinite(loss).item() and fc.abs().max().item() > 0):
        raise AssertionError(f"loss {loss.item()}, regional fc grad "
                             f"{fc.abs().max().item()}")
    ms = cuda_ms(step, iters=3, warmup=1)
    print(f"class-head training step, batch 2, dropout {DROPOUT}, f32: loss "
          f"{loss.item():.4f}; launches {counts}; {ms:.1f} ms a step (CUDA "
          f"events, warm); card: {card}", flush=True)

    # ignore_backbone: the regional losses leave the backbone alone
    model = seeded_model(class_head_config(dropout=DROPOUT,
                                           ignore_backbone=True),
                         SEED).to(dev).train()
    out = model.class_outputs(x, ts, generator=gen, bn_stats=[],
                              **class_targets(labels, regions))
    backbone = [p for n, p in model.named_parameters()
                if not n.startswith(("classifier_", "regr_regional_"))]
    regr = out["regr_loss_pm25"] + out["regr_loss_pm10"]
    grads = torch.autograd.grad(regr, backbone, allow_unused=True)
    if any(g is not None and g.any().item() for g in grads):
        raise AssertionError("ignore_backbone: the regional losses reach "
                             "the backbone")
    print("ignore_backbone: the regional losses give the backbone no "
          "gradient", flush=True)
    return counts


def int8_path(dev, card: str):
    """Phase 15b: int8 PTQ of the --fast configuration (bf16, fused stem,
    NHWC input) at batch 25: calibrate on one synthetic batch, each of the
    seven int8 convs against its plain version, the int8 forward against
    the bf16 forward, both forwards' times, one int8 conv against cuDNN's
    bf16 conv at (300, 128, 84, 70).  Returns the int8 forward's K1 and
    int8-conv launches."""
    import dataclasses

    import torch

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.ops import quantize as Q
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
    from vit_grid_model_tpu_torch.repros.common import bound_ms, cuda_ms

    torch.backends.cuda.matmul.allow_tf32 = False     # the f32 yardstick
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(shipped_12hr_model_config(22.5, 15.5),
                              compute_dtype="bfloat16", fuse_lead_stem=True,
                              nhwc_input=True, int8_convs=True)
    layers = sum(cfg.depth_tuple)
    rng = np.random.default_rng(SEED + 7)
    xp = np.zeros((FLAGSHIP_BATCH, 84, 70, 600), np.float32)
    xp[:, 1:83, 1:68] = rng.random((FLAGSHIP_BATCH, 82, 67, 600)) * 50
    x = torch.from_numpy(xp).to(dev, torch.bfloat16)
    ts = torch.from_numpy(np.stack(
        [np.full((FLAGSHIP_BATCH, 25), 2023.0), np.ones((FLAGSHIP_BATCH, 25)),
         np.full((FLAGSHIP_BATCH, 25), 15.0),
         np.tile(np.arange(25) % 24, (FLAGSHIP_BATCH, 1))],
        axis=-1).astype(np.float32)).to(dev)

    model = seeded_model(cfg, SEED).to(dev)
    t0 = time.perf_counter()
    Q.quantize_metnet3_int8(model, [(x, ts)])
    calib_s = time.perf_counter() - t0
    model.to(torch.bfloat16)
    blocks = {f"{stage}.{i}.{name}": getattr(blk, name)
              for stage in ("resnet1", "resnet2")
              for i, blk in enumerate(getattr(model, stage).blocks)
              for name in ("block1", "block2")
              if getattr(blk, name).proj_q is not None}
    if len(blocks) != 7:
        raise AssertionError(f"quantized sites {sorted(blocks)}")
    for site, block in blocks.items():
        q = block.proj_q
        if (q.wq.dtype, q.sw.dtype, q.sx.dtype, q.b.dtype) != (
                torch.int8, torch.float32, torch.float32, torch.float32):
            raise AssertionError(f"{site}: the bf16 cast reached the sidecar")
    float_cfg = dataclasses.replace(cfg, int8_convs=False)
    float_model = seeded_model(float_cfg, SEED).to(dev, torch.bfloat16)

    inputs = {}
    hooks = [b.register_forward_pre_hook(
        lambda mod, args, site=site: inputs.setdefault(site, args[0]))
        for site, b in blocks.items()]
    with torch.inference_mode():
        Q.reset_launches()
        cuda_attn.reset_launches()
        y_int8 = model(x, ts)
        torch.cuda.synchronize()
        launches = (cuda_attn.launches, Q.launches)
        note_k1_designs("int8 forward")
        for h in hooks:
            h.remove()
        y_bf16 = float_model(x, ts)
        # the yardstick: the same weights in f32 on the same input
        y_f32 = seeded_model(float_cfg, SEED).to(dev)(x.float(), ts)
        if launches != (2 * layers, 7):
            raise AssertionError(f"int8 forward launches (K1, int8 conv) "
                                 f"{launches}, expected ({2 * layers}, 7)")
        if set(inputs) != set(blocks):
            raise AssertionError(f"int8 conv inputs seen at {sorted(inputs)}")
        for site, block in blocks.items():
            q, xin = block.proj_q, inputs[site]
            xq = Q.quantize_input(xin, q.sx)
            acc = Q.int8_conv_accumulate(xq, q.wq)
            plain = Q.int8_conv_accumulate_plain(xq, q.wq)
            out = Q.conv2d_int8(q, xin)
            if not (torch.equal(acc, plain) and torch.equal(
                    out, Q.dequantize(plain, q, xin.dtype))):
                raise AssertionError(f"{site}: the int8 conv differs from "
                                     "its plain version")
        shape = tuple(next(iter(inputs.values())).shape)
        print(f"the seven int8 convs {shape} on the card: "
              f"int32 accumulator and output bit-equal to the plain version "
              f"(float64 conv); calibration {calib_s:.1f} s", flush=True)
        d = (y_int8.double() - y_bf16.double())
        rmse = d.square().mean().sqrt().item()
        worst = d.abs().max().item()
        f32_rmse = {k: (y.double() - y_f32.double()).square().mean().sqrt()
                    .item() for k, y in (("int8", y_int8), ("bf16", y_bf16))}
        if not (torch.isfinite(y_int8).all().item()
                and tuple(y_int8.shape) == (FLAGSHIP_BATCH, 12, 82, 67)):
            raise AssertionError("the int8 forward is not finite or of the "
                                 "expected shape")
        ms_int8 = cuda_ms(lambda: model(x, ts), iters=5)
        ms_bf16 = cuda_ms(lambda: float_model(x, ts), iters=5)
        ms_int8_again = cuda_ms(lambda: model(x, ts), iters=5)
    print(f"int8 vs bf16 forward, B={FLAGSHIP_BATCH}: int8_rmse_delta "
          f"{rmse:.4f} ug/m3, max|d| {worst:.3f} (RMSE from the f32 "
          f"forward: int8 {f32_rmse['int8']:.4f}, bf16 "
          f"{f32_rmse['bf16']:.4f}); forward {ms_int8:.1f} / "
          f"{ms_int8_again:.1f} ms int8, {ms_bf16:.1f} ms bf16 (CUDA events,"
          f" warm); K1 launches {launches[0]}, int8 convs {launches[1]}; "
          f"card: {card}", flush=True)

    # one conv at the flagship resnet shape: int8 (stock route) vs cuDNN bf16
    n, c, h, w = FLAGSHIP_BATCH * 12, 128, 84, 70
    g = torch.Generator(device=dev).manual_seed(SEED)
    xc = torch.randn(n, c, h, w, device=dev, generator=g).to(
        torch.bfloat16).contiguous(memory_format=torch.channels_last)
    torch.manual_seed(SEED)
    conv = torch.nn.Conv2d(c, c, 3, padding=1).to(dev)
    q = Q.quantize_conv(conv.weight, conv.bias, xc.abs().max().item())
    wb, bb = conv.weight.to(torch.bfloat16), conv.bias.to(torch.bfloat16)
    with torch.inference_mode():
        xq = Q.quantize_input(xc, q.sx)
        t = {"int8": cuda_ms(lambda: Q.conv2d_int8(q, xc), iters=5),
             "int8 accumulate": cuda_ms(
                 lambda: Q.int8_conv_accumulate(xq, q.wq), iters=5),
             "cudnn bf16": cuda_ms(lambda: torch.nn.functional.conv2d(
                 xc, wb, bb, padding=1), iters=5),
             "plain": cuda_ms(lambda: Q.int8_conv_accumulate_plain(
                 xq, q.wq), iters=2, warmup=1)}
        t["int8 again"] = cuda_ms(lambda: Q.conv2d_int8(q, xc), iters=5)
    ops = 2.0 * n * h * w * c * c * 9
    moved = 2.0 * n * h * w * c * 2
    b_bf16 = bound_ms(ops, moved, torch.bfloat16)
    b_int8 = bound_ms(ops, moved, torch.int8)
    print(f"one 3x3 conv {(n, c, h, w)}: int8 (quantize, im2col + "
          f"torch._int_mm, dequantize) {t['int8']:.3f} / "
          f"{t['int8 again']:.3f} ms (its int32 accumulate alone "
          f"{t['int8 accumulate']:.3f}), bound {b_int8[0]:.3f} ms "
          f"({b_int8[1]}); cuDNN bf16 {t['cudnn bf16']:.3f} ms, bound "
          f"{b_bf16[0]:.3f} ms ({b_bf16[1]}); the plain float64 conv "
          f"{t['plain']:.1f} ms; {ops / 1e9:.1f} GFLOP, {moved / 1e6:.0f} MB "
          f"of bf16 in and out; card: {card}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# phase 16: the legacy station and grid models, SimVP and the utilities
# ---------------------------------------------------------------------------

# the legacy models at the production station count (400 Korean, 150
# Chinese) and width (hidden 128, MetNet3's), 7 input and 6 output hours;
# the grid models over the 82 x 67 grid (5,494 + 550 joint-attention
# tokens); SimVP at its spec's own widths over 80 x 64, as its decoder
# cannot take 82 x 67
LEGACY_SPEC = dict(input_dim=7, feat_dim=12, hidden_dim=128, pm25_mean=20.0,
                   pm25_std=10.0, output_dim=6, prev_len=7,
                   korea_stn_num=400, china_stn_num=150)
LEGACY_GRID = (82, 67)
STATION_CASES = [("multiair", "RevIN"), ("multiair", "DishTS"),
                 ("multiair", "Standard"), ("simulation", "RevIN"),
                 ("simulation_avg", "RevIN"), ("wo", "RevIN")]
GRID_CASES = [(1, "Standard"), (2, "Standard"), (3, "Standard"),
              (3, "RevIN"), (3, "DishTS")]
STATION_BATCH, GRID_BATCH, SIMVP_BATCH = 8, 1, 4
SIMVP_SHAPE_IN = (7, 12, 80, 64)
# max|card - CPU| / max|CPU|: f32 on both sides with TF32 off, sums taken
# in another order through 13 recurrent steps
LEGACY_REL = 1e-4
LEGACY_ITERS, LEGACY_WARMUP = 10, 2


def median_ms(fn, iters: int = LEGACY_ITERS,
              warmup: int = LEGACY_WARMUP) -> float:
    """The median of ``iters`` calls' milliseconds on the card (CUDA
    events around each call), after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def legacy_station_io(spec, batch: int, seed: int, grid=None):
    """The station inputs of ``benchmarks/legacy_models.py`` drawn from a
    numpy seed, with batch row 0's stations all masked at step 0: feats,
    masks, raw_times, and the grid history (``grid`` (H, W)) or the
    station history.  Returns (rng, {name: CPU tensor})."""
    import torch

    rng = np.random.default_rng(seed)
    stn, t = spec.total_stn_num, spec.input_dim + spec.output_dim
    masks = rng.random((batch, t, stn)) > 0.2
    masks[0, 0] = False
    io = dict(
        feats=rng.random((batch, spec.input_dim, stn, spec.feat_dim)) * 30,
        masks=masks,
        raw_times=np.stack([rng.integers(1, 13, (batch, t)),
                            rng.integers(1, 29, (batch, t)),
                            rng.integers(0, 24, (batch, t))], axis=-1),
        prev_vals=rng.random((batch, spec.prev_len) + (grid or (stn,))) * 30)
    return rng, {k: torch.from_numpy(v if v.dtype == bool
                                     else v.astype(np.float32))
                 for k, v in io.items()}


def legacy_vs_cpu(name: str, model, inputs, shape, dev, card: str):
    """``model``'s forward on the CPU, then the same module moved to the
    card on the same inputs: the relative error (tolerance LEGACY_REL), the
    shape and finiteness, the card's median forward ms, and the profiler's
    device time by kernel (its sum against the forward's ms is the card's
    busy share); then the median again, and the host clock's p50 over the
    same count of forwards through a ``StepTimer`` (``host_sync`` ends
    each).  Returns (error, ms, the model on the card, the inputs on the
    card)."""
    import torch

    from vit_grid_model_tpu_torch.repros.common import kernel_ms
    from vit_grid_model_tpu_torch.utils.profiling import StepTimer

    t0 = time.perf_counter()
    with torch.inference_mode():
        ref = model(**inputs)
        model = model.to(dev)
        x = {k: v.to(dev) for k, v in inputs.items()}
        out = model(**x)
        torch.cuda.synchronize()
        scale = ref.abs().max().item()
        err = (out.cpu() - ref).abs().max().item() / scale
        ms = median_ms(lambda: model(**x))
        kernels = kernel_ms(lambda: model(**x))
        ms_again = median_ms(lambda: model(**x))
        timer = StepTimer(warmup=LEGACY_WARMUP)
        for _ in range(LEGACY_WARMUP + LEGACY_ITERS):
            with timer.step() as step:
                step["result"] = model(**x)
    busy = sum(kernels.values())
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:3]
    ok = (tuple(out.shape) == shape and torch.isfinite(out).all().item()
          and scale > 0 and err <= LEGACY_REL)
    print(f"{name}: out {tuple(out.shape)}, max|card - CPU|/max {err:.3e} "
          f"(tol {LEGACY_REL:g}), max|out| {scale:.4g}; forward "
          f"{ms:.3f} ms (median of {LEGACY_ITERS} after {LEGACY_WARMUP}, "
          f"CUDA events); {time.perf_counter() - t0:.1f} s; card: {card}",
          flush=True)
    print(f"  profiler: {busy:.3f} ms of kernels a forward ("
          f"{100 * busy / ms:.0f}% of it busy); top: "
          + ", ".join(f"{k} {v:.3f}" for k, v in top), flush=True)
    print(f"  after the profile: median {ms_again:.3f} ms (CUDA events); "
          f"StepTimer (host clock, host_sync) p50 {timer.p50() * 1e3:.3f} "
          f"ms over {len(timer.times)} forwards", flush=True)
    if not ok:
        raise AssertionError(f"{name}: the card's forward is not the CPU's, "
                             f"or is not finite of shape {shape}")
    return err, ms, model, x


def legacy_station_path(dev, card: str):
    """Phase 16a: each station variant at B = 8 and production width, the
    card against the CPU.  Returns {case: (error, ms)} and the last
    model with its inputs, for phase 16d."""
    import torch

    from vit_grid_model_tpu_torch.core.weights import seeded_station_model
    from vit_grid_model_tpu_torch.models.legacy.station import (
        StationModelSpec)

    results = {}
    for i, (variant, method) in enumerate(STATION_CASES):
        spec = StationModelSpec(**LEGACY_SPEC, variant=variant,
                                normalization_method=method)
        rng, io = legacy_station_io(spec, STATION_BATCH, SEED + 16 + i)
        stn, korea = spec.total_stn_num, spec.korea_stn_num
        t_out = spec.output_dim
        if variant == "multiair":
            sat_in = rng.random((STATION_BATCH, stn, 13))
            sat_in[sat_in < 0.1] = -1         # the missing-value sentinel
            io["sat_outputs"] = torch.from_numpy(
                (rng.random((STATION_BATCH, stn, t_out)) * 25).astype(
                    np.float32))
            io["sat_inputs"] = torch.from_numpy(sat_in.astype(np.float32))
        elif variant != "wo":
            s4 = (spec.feat_dim // 2) * (4 if variant == "simulation" else 1)
            io["simulation"] = torch.from_numpy(
                (rng.random((STATION_BATCH, korea, t_out * s4 + 4))
                 * 25).astype(np.float32))
        name = f"station {variant} {method}"
        err, ms, model, x = legacy_vs_cpu(
            name, seeded_station_model(spec, SEED), io,
            (STATION_BATCH, korea, t_out), dev, card)
        results[name] = (err, ms)
    return results, (model, x)


def legacy_grid_path(dev, card: str):
    """Phase 16b: grid versions 1-3 (v3 under Standard, RevIN and DishTS)
    at B = 1 over the 82 x 67 grid, the card against the CPU.  Returns
    {case: (error, ms)}."""
    import torch

    from vit_grid_model_tpu_torch.core.weights import seeded_grid_model
    from vit_grid_model_tpu_torch.models.legacy.grid import GridModelSpec

    results = {}
    for i, (version, method) in enumerate(GRID_CASES):
        spec = GridModelSpec(**LEGACY_SPEC, grid_shape=LEGACY_GRID,
                             normalization_method=method, version=version)
        rng, io = legacy_station_io(spec, GRID_BATCH, SEED + 32 + i,
                                    grid=LEGACY_GRID)
        steps = spec.input_dim + spec.output_dim
        io["simulation"] = torch.from_numpy(
            (rng.random((GRID_BATCH,) + LEGACY_GRID
                        + (steps * spec.block_channels,)) * 25).astype(
                np.float32))
        name = f"grid v{version} {method}"
        err, ms, _, _ = legacy_vs_cpu(
            name, seeded_grid_model(spec, SEED), io,
            (GRID_BATCH, spec.cells, spec.output_dim), dev, card)
        results[name] = (err, ms)
    return results


def simvp_path(dev, card: str):
    """Phase 16c: SimVP at its spec's widths, B = 4 over 80 x 64, the card
    against the CPU.  Returns (error, ms)."""
    import torch

    from vit_grid_model_tpu_torch.core.weights import seeded_simvp
    from vit_grid_model_tpu_torch.models.simvp import SimVPSpec

    spec = SimVPSpec(shape_in=SIMVP_SHAPE_IN)
    x = np.random.default_rng(SEED + 48).standard_normal(
        (SIMVP_BATCH,) + SIMVP_SHAPE_IN).astype(np.float32)
    err, ms, _, _ = legacy_vs_cpu(
        f"SimVP hid_s {spec.hid_s}, hid_t {spec.hid_t}, n_s {spec.n_s}, "
        f"n_t {spec.n_t}, groups {spec.groups}",
        seeded_simvp(spec, SEED), {"x": torch.from_numpy(x)},
        (SIMVP_BATCH,) + SIMVP_SHAPE_IN, dev, card)
    return err, ms


def utilities_on_the_card(model, inputs, dev, card: str, root: str):
    """Phase 16d: a ``trace`` with an ``annotate`` region around a station
    forward writes its trace file, and the region owns every kernel the
    forward launched; ``oom_guard`` rewraps a real CUDA
    out-of-memory error, raised by asking for twice the card's memory.
    Returns the trace's count of device kernel events."""
    import glob

    import torch

    from vit_grid_model_tpu_torch.utils.hbm import oom_guard
    from vit_grid_model_tpu_torch.utils.profiling import (annotate,
                                                          kernels_by_span,
                                                          trace)

    log_dir = tempfile.mkdtemp(prefix="trace_", dir=root)
    with torch.inference_mode(), trace(log_dir) as recorded:
        with annotate("phase16_station_forward"):
            model(**inputs)
        torch.cuda.synchronize()
    owners = kernels_by_span(recorded)
    if set(owners) != {"phase16_station_forward"}:
        raise AssertionError(f"kernels owned by {sorted(owners)}")
    files = glob.glob(os.path.join(log_dir, "*.pt.trace.json"))
    if len(files) != 1:
        raise AssertionError(f"trace files {files}")
    with open(files[0]) as f:
        events = json.load(f).get("traceEvents", [])
    if not any(e.get("name") == "phase16_station_forward" for e in events):
        raise AssertionError("the annotation is not in the trace")
    kernels = sum(e.get("cat") == "kernel" for e in events)
    print(f"trace: {os.path.basename(files[0])}, "
          f"{os.path.getsize(files[0])} bytes, the annotation and "
          f"{kernels} device kernel events; the annotation owns "
          f"{owners['phase16_station_forward'][1]} launches, "
          f"{owners['phase16_station_forward'][0] * 1e3:.3f} ms", flush=True)

    total = torch.cuda.get_device_properties(dev).total_memory
    try:
        with oom_guard("phase 16d allocation", 1, dev):
            torch.empty(2 * total, dtype=torch.uint8, device=dev)
    except RuntimeError as e:
        if not (isinstance(e.__cause__, torch.cuda.OutOfMemoryError)
                and "batch_size=1" in str(e)
                and torch.cuda.get_device_name(dev) in str(e)):
            raise
        print(f"oom_guard: {e}", flush=True)
    else:
        raise AssertionError(f"{2 * total} bytes were allocated")
    torch.cuda.empty_cache()
    return kernels


def legacy_path(dev, card: str, root: str):
    """Phase 16, in f32 with TF32 off (restored after): 16a-16d.  No
    hand-written kernel may launch in it."""
    import torch

    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cuda_attn.reset_launches()
    try:
        phase("16a", "the legacy station models at production width")
        t = time.perf_counter()
        station, (model, x) = legacy_station_path(dev, card)
        print(f"phase 16a: {time.perf_counter() - t:.1f} s", flush=True)

        phase("16b", "the legacy grid models over the 82 x 67 grid")
        t = time.perf_counter()
        grid = legacy_grid_path(dev, card)
        print(f"phase 16b: {time.perf_counter() - t:.1f} s", flush=True)

        phase("16c", "SimVP at its spec's widths")
        t = time.perf_counter()
        simvp = simvp_path(dev, card)
        print(f"phase 16c: {time.perf_counter() - t:.1f} s", flush=True)

        phase("16d", "the utilities on the card")
        t = time.perf_counter()
        utilities_on_the_card(model, x, dev, card, root)
        print(f"phase 16d: {time.perf_counter() - t:.1f} s", flush=True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = tf32
    counts = (cuda_attn.launches, cuda_attn.bwd_launches,
              cuda_attn.wgrad_launches, cuda_attn.hash_launches)
    if counts != (0, 0, 0, 0):
        raise AssertionError(f"phase 16 launched hand-written kernels (K1, "
                             f"K3, K3-w, hash) {counts}")
    print(json.dumps({"phase16": {
        "card": card, **{k: {"max_rel_err": e, "forward_ms": ms}
                         for k, (e, ms) in {**station, **grid,
                                            "simvp": simvp}.items()}}}),
          flush=True)


# ---------------------------------------------------------------------------
# phase 17: the eight legacy datasets and the station-image MetNet3
# ---------------------------------------------------------------------------

# (a) each dataset over the first 25 samples of phase 4's tree at the
# shipped geometry: 13 input, 12 output and 13 history hours, 6 species
# (28 channels a step); the station arrays at phase 16a's 400 + 150
# stations, the in-memory simulation tensors shaped as phase 16a's
# simulation (4 cycles) and simulation_avg inputs
DATASET_DIMS = dict(input_dim=13, output_dim=12, prev_len=13,
                    korea_stn_num=400, china_stn_num=150)
DATASET_BATCH = FLAGSHIP_BATCH
DATASET_FEAT_DIM = 12
IN_MEMORY_DATASETS = ("AirWithFixedSatDataset", "AirWithSimulationDataset",
                      "AirOnlyDataset", "AirWithSimulationDatasetV2",
                      "AirSimulationReanalysisDataset",
                      "AirSimulationReanalysisDatasetWithCurr")
LAZY_DATASETS = ("AirSimulationReanalysisDatasetV2",
                 "AirSimulationReanalysisDatasetWithStationImgs")
# (b, c) the station-image variant of the 12-hour model: channel 24 of 25
# is the station image, standardized in the forward with the PM2.5 planes
STN_IMG_CHANNEL = 24
STN_IMG_F32_REL = 1e-3
# the --fast forward against the standard bf16 path: the same fused stem
# and the same K1 strip launches on the same operands, so the two are
# bit-equal by construction; a staging fault that moves a few pixels (a
# pad off by a column, the station image in another slot) must show
STN_IMG_FAST_REL = 1e-6


def dataset_times():
    """The hourly times of the first DATASET_BATCH samples of phase 4's
    window: exactly one batch."""
    from datetime import timedelta

    from vit_grid_model_tpu_torch.data.timeutil import eval_time_list

    start = EVAL_WINDOW[0]
    return eval_time_list(start, start + timedelta(hours=DATASET_BATCH - 1),
                          DATASET_DIMS["prev_len"], DATASET_DIMS["output_dim"])


def dataset_arrays(t: int):
    """The in-memory arrays over ``t`` hours, from a numpy seed; column 6
    of the features is the 0/1 validity flag the classes invert."""
    rng = np.random.default_rng(SEED + 17)
    stn = DATASET_DIMS["korea_stn_num"] + DATASET_DIMS["china_stn_num"]
    korea, t_out = DATASET_DIMS["korea_stn_num"], DATASET_DIMS["output_dim"]
    feats = (rng.random((t, stn, DATASET_FEAT_DIM)) * 60).astype(np.float32)
    feats[:, :, 6] = rng.integers(0, 2, (t, stn))
    return dict(
        feats=feats, masks=rng.random((t, stn)) > 0.2,
        sat_outputs=(rng.random((t, stn, t_out)) * 25).astype(np.float32),
        sat_inputs=(rng.random((t, stn, 13)) * 25).astype(np.float32),
        simulation=(rng.random((t, korea, t_out * 24 + 4)) * 25).astype(
            np.float32),
        simulation_pm=(rng.random((t, korea, t_out * 6 + 4)) * 25).astype(
            np.float32),
        reanalysis=(rng.random((t,) + LEGACY_GRID) * 100 - 5).astype(
            np.float32))


def dataset_shapes(name: str):
    """Each field's (shape, dtype) in a batch of ``name``."""
    b, (h, w) = DATASET_BATCH, LEGACY_GRID
    d = DATASET_DIMS
    t_in, t_out, prev = d["input_dim"], d["output_dim"], d["prev_len"]
    stn, korea = d["korea_stn_num"] + d["china_stn_num"], d["korea_stn_num"]
    f32, i32, bool_ = np.float32, np.int32, np.bool_
    station_in = [((b, t_in, stn, DATASET_FEAT_DIM), f32),
                  ((b, t_in + t_out, stn), bool_)]
    targets = [((b, t_out, korea), i32), ((b, t_out, korea), f32),
               ((b, t_out, korea), bool_)]
    times = ((b, t_in + t_out, 4), f32)
    prev_stn = ((b, prev, stn), f32)
    sim_stn = ((b, korea, t_out * 24 + 4), f32)
    re, cls = ((b, t_out, h, w), f32), ((b, t_out, h, w), i32)
    return {
        "AirWithFixedSatDataset": station_in + [
            ((b, stn, t_out), f32), ((b, stn, 13), f32)] + targets + [
            times, prev_stn],
        "AirWithSimulationDataset": station_in + [sim_stn] + targets + [
            times, prev_stn],
        "AirOnlyDataset": station_in + targets + [times, prev_stn],
        "AirWithSimulationDatasetV2": station_in + [
            sim_stn, ((b, korea, t_out * 6 + 4), f32)] + targets + [
            times, prev_stn],
        "AirSimulationReanalysisDataset": station_in + [
            sim_stn, re, cls, times, prev_stn],
        "AirSimulationReanalysisDatasetWithCurr": station_in + [
            sim_stn, ((b, h, w), f32), re, cls, times, prev_stn],
        "AirSimulationReanalysisDatasetV2": station_in + [
            ((b, h, w, t_out * 28), f32), re, cls, times, prev_stn],
        "AirSimulationReanalysisDatasetWithStationImgs": [
            ((b, h, w, (t_in + t_out) * 28), f32), ((b, h, w), f32), re, cls,
            times, ((b, prev, h, w), f32), ((b, t_in, 2, h, w), f32),
            ((b, t_out, 2, h, w), f32)],
    }[name]


def datasets_on_the_tree(paths, card: str):
    """Phase 17a: one ``BatchLoader`` batch of 25 from each of the eight
    datasets, in its tuple's shapes and dtypes; the two lazy classes once
    with the native plane and once without, byte-equal; no file the native
    reader had to zero-fill.  Returns {class: samples/s}."""
    from vit_grid_model_tpu_torch.data import datasets, native, readers
    from vit_grid_model_tpu_torch.data.pipeline import BatchLoader
    from vit_grid_model_tpu_torch.data.synthetic import (DEFAULT_FEAT_INFOS,
                                                         write_station_images)

    times = dataset_times()
    t0 = time.perf_counter()
    write_station_images(paths["data_path"], times,
                         output_dim=DATASET_DIMS["output_dim"])
    print(f"station images for {len(times)} hours: "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    a = dataset_arrays(len(times))
    fm = (a["feats"], a["masks"])
    lazy = dict(cmaq_size=LEGACY_GRID, sim_data_path=paths["sim_data_path"],
                reanalysis_data_path=paths["analysis_data_path"],
                feat_infos=DEFAULT_FEAT_INFOS, **DATASET_DIMS)
    built = {
        "AirWithFixedSatDataset": lambda c: c(
            times, a["sat_outputs"], a["sat_inputs"], *fm, **DATASET_DIMS),
        "AirWithSimulationDataset": lambda c: c(
            times, *fm, a["simulation"], **DATASET_DIMS),
        "AirOnlyDataset": lambda c: c(times, *fm, **DATASET_DIMS),
        "AirWithSimulationDatasetV2": lambda c: c(
            times, *fm, a["simulation"], a["simulation_pm"], **DATASET_DIMS),
        "AirSimulationReanalysisDataset": lambda c: c(
            times, *fm, a["simulation"], a["reanalysis"], **DATASET_DIMS),
        "AirSimulationReanalysisDatasetWithCurr": lambda c: c(
            times, *fm, a["simulation"], a["reanalysis"], **DATASET_DIMS),
        "AirSimulationReanalysisDatasetV2": lambda c: c(times, *fm, **lazy),
        "AirSimulationReanalysisDatasetWithStationImgs": lambda c: c(
            times, *fm, data_path=paths["data_path"], **lazy),
    }

    def one_batch(name, use_native=None):
        ds = built[name](getattr(datasets, name))
        if use_native is not None:
            ds.use_native = use_native
        if len(ds) != DATASET_BATCH:
            raise AssertionError(f"{name}: {len(ds)} samples")
        readers.clear_caches()
        t = time.perf_counter()
        batches = list(BatchLoader(ds, batch_size=DATASET_BATCH))
        seconds = time.perf_counter() - t
        if len(batches) != 1:
            raise AssertionError(f"{name}: {len(batches)} batches")
        batch = batches[0]
        got = [(tuple(f.shape), f.dtype) for f in batch]
        want = [(s, np.dtype(d)) for s, d in dataset_shapes(name)]
        if got != want:
            raise AssertionError(f"{name}: batch fields {got}, expected "
                                 f"{want}")
        if not all(np.isfinite(f).all() for f in batch
                   if f.dtype == np.float32):
            raise AssertionError(f"{name}: a field is not finite")
        return batch, DATASET_BATCH / seconds

    native.reset_unsupported_count()
    rates = {}
    for name in IN_MEMORY_DATASETS + LAZY_DATASETS:
        batch, rates[name] = one_batch(name)
        line = (f"{name}: a batch of {DATASET_BATCH}, {len(batch)} fields, "
                f"{rates[name]:.1f} samples/s")
        if name in LAZY_DATASETS:
            slow, rates[name + " numpy"] = one_batch(name, use_native=False)
            if not all(x.dtype == y.dtype and np.array_equal(x, y)
                       for x, y in zip(batch, slow)):
                raise AssertionError(f"{name}: the native plane's batch is "
                                     "not the numpy path's")
            line += (f" (native plane); without it "
                     f"{rates[name + ' numpy']:.1f} samples/s, the batch "
                     "byte-equal")
        print(f"{line}; card: {card}", flush=True)
    if native.unsupported_count() != 0:
        raise AssertionError(f"{native.unsupported_count()} files the "
                             "native reader zero-filled")
    print("native.unsupported_count() = 0", flush=True)
    return rates


def station_image_config(**over):
    """The shipped 12-hour model with the station-image channel: 25
    channels, hidden 128, 32 heads x 32."""
    import dataclasses

    from vit_grid_model_tpu_torch.core.config import shipped_12hr_model_config
    from vit_grid_model_tpu_torch.data.synthetic import DEFAULT_FEAT_INFOS

    mean, std = DEFAULT_FEAT_INFOS["PM2.5"]
    return dataclasses.replace(
        shipped_12hr_model_config(pm25_mean=mean, pm25_std=std),
        n_variables=STN_IMG_CHANNEL + 1, stn_img_channel=STN_IMG_CHANNEL,
        **over)


def station_image_inputs(batch: int, seed: int):
    """(x (B, 25, 25, 82, 67), timestamps (B, 25, 4)) from a numpy seed,
    as phase 3 draws the 24-channel model's."""
    rng = np.random.default_rng(seed)
    x = (rng.random((batch, 25, STN_IMG_CHANNEL + 1) + LEGACY_GRID)
         * 50).astype(np.float32)
    ts = np.stack([np.full((batch, 25), 2023.0), np.ones((batch, 25)),
                   np.full((batch, 25), 15.0),
                   np.tile(np.arange(25) % 24, (batch, 1))],
                  axis=-1).astype(np.float32)
    return x, ts


def k1_counts(what: str, want: str, layers: int):
    """Raises unless the forward just run launched K1 2 x ``layers`` times,
    each on the ``want`` design; notes them under ``what``."""
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    note_k1_designs(what)
    got = (cuda_attn.launches, dict(cuda_attn.fwd_route_launches))
    if got != (2 * layers, {want: 2 * layers}):
        raise AssertionError(f"{what}: K1 launches by design {got}, "
                             f"expected {2 * layers} on the {want} design")
    return cuda_attn.launches


def station_image_model(dev, card: str):
    """Phase 17b and 17c: the station-image 12-hour model, one sample in
    f32 on the card against the CPU (K1's first design), then the --fast
    configuration (bf16, fused stem, NHWC input staged by
    ``model_input_to_nhwc``) at B = 25 against the standard path of the
    same configuration on the (B, T, C, H, W) input (K1's strip path).  Returns (f32 error, fast
    error, fast forward ms, K1 launches of the two forwards)."""
    import dataclasses

    import torch

    from vit_grid_model_tpu_torch.core.weights import seeded_model
    from vit_grid_model_tpu_torch.data.assembly import (host_stage_dtype,
                                                        model_input_to_nhwc)
    from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

    phase("17b", "the station-image 12-hour model in f32, GPU vs CPU")
    t = time.perf_counter()
    cfg = station_image_config()
    layers = sum(cfg.depth_tuple)
    x, ts = station_image_inputs(1, SEED + 17)
    xt, tst = torch.from_numpy(x), torch.from_numpy(ts)
    with torch.inference_mode():
        cpu_out = seeded_model(cfg, SEED)(xt, tst)
        gpu_model = seeded_model(cfg, SEED).to(dev)
        cuda_attn.reset_launches()
        gpu_out = gpu_model(xt.to(dev), tst.to(dev))
        torch.cuda.synchronize()
        f32_launches = k1_counts("station-image f32 forward", "first", layers)
    gpu_out = gpu_out.cpu()
    scale = cpu_out.abs().max().item()
    f32_err = (gpu_out - cpu_out).abs().max().item() / scale
    print(f"station-image MetNet3 12hr f32 (25 channels, station image at "
          f"{STN_IMG_CHANNEL}), 1 sample: max|gpu - cpu| / max|cpu| = "
          f"{f32_err:.3e} (tol {STN_IMG_F32_REL:g}); max|out| {scale:.3f}; "
          f"K1 launches {f32_launches}, all on the first design; "
          f"{time.perf_counter() - t:.1f} s", flush=True)
    if not (tuple(gpu_out.shape) == (1, 12) + LEGACY_GRID
            and torch.isfinite(gpu_out).all().item()
            and f32_err <= STN_IMG_F32_REL):
        raise AssertionError(f"station-image f32 forward: error {f32_err}")

    phase("17c", "the station-image model in the --fast configuration")
    t = time.perf_counter()
    fast_cfg = dataclasses.replace(cfg, compute_dtype="bfloat16",
                                   fuse_lead_stem=True, nhwc_input=True)
    # the standard path: the same configuration on the (B, T, C, H, W)
    # input, as tests/test_nhwc_input.py holds JAX's NHWC path to
    std_cfg = dataclasses.replace(fast_cfg, nhwc_input=False)
    x, ts = station_image_inputs(FLAGSHIP_BATCH, SEED + 18)
    t_stage = time.perf_counter()
    staged = host_stage_dtype(model_input_to_nhwc(x, fast_cfg.pad_multiple),
                              fast_cfg.compute_dtype)
    stage_s = time.perf_counter() - t_stage
    tst = torch.from_numpy(ts).to(dev)
    with torch.inference_mode():
        fast = seeded_model(fast_cfg, SEED).to(dev, torch.bfloat16)
        xn = staged.to(dev)
        cuda_attn.reset_launches()
        out = fast(xn, tst)
        torch.cuda.synchronize()
        fast_launches = k1_counts("station-image --fast forward", "strip",
                                  layers)
        standard = seeded_model(std_cfg, SEED).to(dev, torch.bfloat16)
        ref = standard(torch.from_numpy(x).to(dev, torch.bfloat16), tst)
        ms = median_ms(lambda: fast(xn, tst))
    out, ref = out.float().cpu(), ref.float().cpu()
    scale = ref.abs().max().item()
    fast_err = (out - ref).abs().max().item() / scale
    print(f"station-image --fast (bf16, fused stem, NHWC input) at B = "
          f"{FLAGSHIP_BATCH}: max|nhwc - standard bf16| / max = "
          f"{fast_err:.3e} (tol {STN_IMG_FAST_REL:g}); K1 launches "
          f"{fast_launches} a forward, all on the strip path; staging "
          f"({tuple(staged.shape)}, model_input_to_nhwc + host bf16 cast) "
          f"{stage_s * 1e3:.1f} ms on the host; forward {ms:.3f} ms (median "
          f"of {LEGACY_ITERS} after {LEGACY_WARMUP}, CUDA events); "
          f"{time.perf_counter() - t:.1f} s; card: {card}", flush=True)
    if not (tuple(out.shape) == (FLAGSHIP_BATCH, 12) + LEGACY_GRID
            and torch.isfinite(out).all().item()
            and fast_err <= STN_IMG_FAST_REL):
        raise AssertionError(f"station-image --fast forward: error "
                             f"{fast_err}")
    return f32_err, fast_err, ms, (f32_launches, fast_launches)


def station_image_path(paths, dev, card: str):
    """Phase 17: 17a the eight datasets, 17b-17c the station-image model.
    Returns the model's K1 launches (f32, --fast)."""
    phase("17a", "the eight legacy datasets on phase 4's tree")
    t = time.perf_counter()
    rates = datasets_on_the_tree(paths, card)
    print(f"phase 17a: {time.perf_counter() - t:.1f} s", flush=True)
    t = time.perf_counter()
    f32_err, fast_err, ms, launches = station_image_model(dev, card)
    print(f"phase 17b-c: {time.perf_counter() - t:.1f} s", flush=True)
    print(json.dumps({"phase17": {
        "card": card, "samples_per_s": rates,
        "station_image_f32_rel_err": f32_err,
        "station_image_fast_rel_err": fast_err,
        "station_image_fast_forward_ms": ms,
        "k1_launches": {"f32": launches[0], "fast": launches[1]}}}),
        flush=True)
    return launches


def attention_bound_ms(bw, n, dim, heads, dh, item, backward=False):
    """(least ms, what bounds it) of the window attention at this shape: its
    products' operations (qkv, scores, P.v, out-projection) at the bf16
    tensor-core peak, against x and y moved once.  The backward is K3 on
    its tensor-core path: it recomputes the forward and runs six more
    products (dO, dV, dPm, dQn, dKn, dXf; the two weight gradients are
    K3-w's), reads dy, writes dx and the weight-gradient operands once in
    bf16."""
    import torch

    from vit_grid_model_tpu_torch.repros.common import bound_ms

    fwd = 2 * n * dim * 3 * heads * dh + 4 * heads * n * n * dh \
        + 2 * n * heads * dh * dim
    bwd = 2 * n * dim * heads * dh + 4 * 2 * heads * n * n * dh \
        + 2 * n * dim * 3 * heads * dh
    ops = bw * (fwd + (bwd if backward else 0))
    moved = bw * n * dim * item * (4 if backward else 2)
    if backward:
        moved += bw * n * (dim + 4 * heads * dh) * 2
    return bound_ms(ops, moved, torch.bfloat16)


def wgrad_bound_ms(rows, dim, heads, dh):
    """(least ms, what bounds it) of K3-w: dWqkv = xf^T [dQ|dK|dV] and
    dWout = O^T dY over the rows at the bf16 tensor-core peak, against its
    bf16 operands read once and the f32 gradients written once."""
    import torch

    from vit_grid_model_tpu_torch.repros.common import bound_ms

    ops = 2 * rows * dim * 3 * heads * dh + 2 * rows * heads * dh * dim
    moved = rows * (2 * dim + 4 * heads * dh) * 2 + 4 * heads * dim * dh * 4
    return bound_ms(ops, moved, torch.bfloat16)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    # phase 4's synthetic tree, kept for phase 13, and phase 13's outputs
    with tempfile.TemporaryDirectory(prefix="vgm_smoke_") as root:
        return run(root)


def run(root: str) -> int:
    import torch

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
    wide_bf16_vs_f32(dev)

    phase("2b", "dropout keep mask vs plain on the card")
    mask_report = dropout_mask_check(dev)

    phase("2c", "forward kernel with dropout vs plain")
    dropout_report = dropout_forward(dev)

    phase("2d", "backward kernels vs plain on the card")
    bwd_report = backward_vs_plain(dev, card)

    phase(3, "whole model, GPU vs CPU")
    whole_model(dev)

    phase(4, "main path: --fast evaluation")
    eval_launches, tree = main_path(card, root)

    phase(5, "whole-model gradients, GPU vs CPU")
    whole_model_grads(dev)

    phase(6, "main path: --fast training")
    train_counts = train_path(card)

    phase("7a", "R15 fused MBConv kernel vs plain on the card")
    mb_err = mbconv_vs_plain(dev)

    phase("7b", "R15 path: the fused MBConv repro")
    def bands_design():
        """The repro's launches and the bands design's; raises when one
        took the first design (every launch there is bf16 at C 128)."""
        first = cuda_mbconv.launches_by_route["first"]
        if first:
            raise AssertionError(f"{first} fused MBConv launches of the "
                                 "repro took the first design")
        return {"fused_mbconv": cuda_mbconv.launches,
                "bands design": cuda_mbconv.launches_by_route["bands"]}

    mb_launches, mb_results = repro_path(repro, [cuda_mbconv], bands_design)

    phase("7c", "the stock MBConv's share of the --fast forward")
    mbconv_share(dev, card)

    phase("8a", "R1/R14 per-head attention kernel vs plain on the card")
    ph_err = perhead_vs_plain(dev)

    phase("8b", "R1/R14 path: the per-head attention repro")
    av = attention_variants

    def wgmma_design(name, counts):
        """The repro's launches and the per-head kernel's wgmma-design
        launches; raises when one took the first design at the repros' bf16
        widths."""
        if av.perhead_route_launches["first"]:
            raise AssertionError(f"{av.perhead_route_launches['first']} "
                                 f"per-head launches of {name} took the "
                                 "first design at the repros' bf16 widths")
        return {**counts, "wgmma design": av.perhead_route_launches["wgmma"]}

    ph_launches, ph_results = repro_path(
        repro_perhead, [attention_variants], lambda: wgmma_design(
            "R1/R14", {wpc: av.perhead_launches[wpc]
                       for wpc in repro_perhead.WINDOWS_PER_CTA}))

    phase("9a", "R7 MaxViT layer megakernel vs plain on the card")
    layer_err = layer_vs_plain(dev)

    phase("9b", "R7 path: the megakernel repro")
    layer_launches, layer_results = repro_path(
        repro_mega, [attention_variants],
        lambda: {"maxvit_layer_attention": attention_variants.layer_launches})
    ly = layer_results[300]
    print(f"R7 at S 300, bf16: {repro_mega.occupancy(torch.bfloat16)}; "
          f"kernel {ly['kernel'][0]:.3f} ms, two-K1 baseline "
          f"{ly['baseline'][0]:.3f} ms, kernel / baseline "
          f"{ly['kernel'][0] / ly['baseline'][0]:.3f}; card: {card}",
          flush=True)

    phase("10a", "R4, R10, R9 and R11 kernels vs plain on the card")
    variant_err = variants_vs_plain(dev)

    phase("10b", "R4, R10, R9 and R11 paths: their repros")
    variant_runs = {}

    def strip_design(name, counts, by_route):
        """The repro's launches, and its strip-design launches; raises when
        one took the first design at the repros' bf16 widths."""
        if by_route["first"]:
            raise AssertionError(f"{by_route['first']} {name} launches took "
                                 "the first design at the repros' bf16 "
                                 "widths")
        return {**counts, "strip design": by_route["strip"]}

    def grouped_wgmma(name, counts, by_route):
        """The repro's launches, and R4's or R3's wgmma-design launches;
        raises when one took the first design at the repros' bf16
        widths."""
        if by_route["first"]:
            raise AssertionError(f"{by_route['first']} {name} launches took "
                                 "the first design at the repros' bf16 "
                                 "widths")
        return {**counts, f"{name} wgmma design": by_route["wgmma"]}

    def ring_design(name, counts, by_route):
        """The repro's launches, and R11's ring-design launches; raises
        when one took the first design in bf16."""
        if by_route["first"]:
            raise AssertionError(f"{by_route['first']} {name} launches took "
                                 "the first design in bf16")
        return {**counts, "ring design": by_route["ring"]}

    for module, route, count in (
            (repro_r4, "headmajor_attention", lambda: av.headmajor_launches),
            (repro_r10, "stacked_softmax_attention",
             lambda: av.stacked_launches),
            (repro_r9, "perhead_weight_attention",
             lambda: av.perhead_weight_launches),
            (repro_r11, "staged_attention_core",
             lambda: av.staged_core_launches)):
        # R1's kernel runs beside each of these repros: every per-head
        # launch takes the wgmma design
        counts = (lambda: wgmma_design(route, {route: count()}))
        if module is repro_r10:
            counts = (lambda: wgmma_design(route, strip_design(
                route, {route: count()}, av.stacked_route_launches)))
        if module is repro_r4:
            counts = (lambda: wgmma_design(route, grouped_wgmma(
                route, {route: count()}, av.headmajor_route_launches)))
        if module is repro_r11:
            counts = (lambda: wgmma_design(route, ring_design(
                route, {route: count()}, av.staged_core_route_launches)))
        variant_runs[route] = repro_path(module, [av], counts)

    phase("11a", "R3 and the out-projection kernel (R12, R13, R2, R8) vs "
          "plain on the card")
    outproj_err = crosshead_outproj_vs_plain(dev)

    phase("11b", "R3, R12-R13, R2 and R8 paths: their repros")

    def outproj_count(two_pass, perhead, score=False, agg=False, wpc=8):
        return av.outproj_launches[(two_pass, perhead, score, agg, wpc)]

    def strip_only(counts):
        """The repro's launches by key, and its strip-design launches;
        raises when one took the first design."""
        if av.outproj_route_launches["first"]:
            raise AssertionError(f"{av.outproj_route_launches['first']} "
                                 "out-projection launches took the first "
                                 "design at the repros' bf16 widths")
        return {**counts, "strip design": av.outproj_route_launches["strip"]}

    # R3's repro runs R4's and R1's kernels beside R3's: every launch of
    # the three takes the wgmma design
    r3_launches, r3_results = repro_path(
        repro_r3, [av], lambda: wgmma_design("R3", grouped_wgmma(
            "headmajor_attention", grouped_wgmma(
                "crosshead_norm_attention",
                {"crosshead_norm_attention": av.crosshead_launches},
                av.crosshead_route_launches), av.headmajor_route_launches)))
    ws_launches, ws_results = repro_path(repro_ws, [av], lambda: strip_only({
        name: outproj_count(tp, pw)
        for name, (_, tp, pw) in repro_ws.VARIANTS.items()}))
    r2_launches, r2_results = repro_path(repro_r2, [av], lambda: strip_only({
        name: outproj_count(True, True, score, agg)
        for name, (score, agg) in repro_r2.CASTS.items()}))
    r8_launches, r8_results = repro_path(repro_r8, [av], lambda: strip_only({
        f"kfold={k}": outproj_count(True, True, wpc=repro_r8.BLK * k)
        for k in repro_r8.KFOLDS}))

    phase("12a", "R5/R6 head-pack kernel vs plain on the card")
    headpack_err = headpack_vs_plain(dev)

    phase("12b", "R5 and R6 paths: their repros")

    def headpack_count(k):
        return sum(v for (kk, _, _), v in av.headpack_launches.items()
                   if kk == k)

    r5_launches, r5_results = repro_path(
        repro_r5, [av], lambda: strip_design(
            "headpack_attention", {"K=2": headpack_count(2)},
            av.headpack_route_launches))
    r6_launches, r6_results = repro_path(
        repro_r6, [av], lambda: strip_design(
            "headpack_attention", {f"K={k}": headpack_count(k)
                                   for k in HEADPACK_K},
            av.headpack_route_launches))

    phase("13a", "inference entry point: serving (Forecaster) on the card")
    t13 = time.perf_counter()
    serving_launches, _, _ = serving_path(dev, card)
    k1_at_serving_shape(dev, card)
    print(f"phase 13a: {time.perf_counter() - t13:.1f} s", flush=True)

    phase("13b", "inference entry point: re-analysis generation CLI")
    t13 = time.perf_counter()
    gen_launches = generation_path(tree, root, card)
    print(f"phase 13b: {time.perf_counter() - t13:.1f} s", flush=True)

    phase("13c", "inference entry point: station evaluation CLI")
    t13 = time.perf_counter()
    station_launches = station_path(tree, root, card)
    print(f"phase 13c: {time.perf_counter() - t13:.1f} s", flush=True)

    phase("14a", "data parallel: the four CLIs under torchrun (NCCL)")
    t14 = time.perf_counter()
    torchrun_clis(tree, root)
    print(f"phase 14a: {time.perf_counter() - t14:.1f} s", flush=True)

    phase("14b", "data parallel: two ranks on cuda:0 over gloo")
    t14 = time.perf_counter()
    dp_eval_launches, dp_train_counts = ranks_on_one_card(tree, root, card)
    print(f"phase 14b: {time.perf_counter() - t14:.1f} s", flush=True)

    phase("15a", "the class head: class outputs and a training step")
    t15 = time.perf_counter()
    class_counts = class_head_path(dev, card)
    print(f"phase 15a: {time.perf_counter() - t15:.1f} s", flush=True)

    phase("15b", "int8 PTQ of the resnet convs at the --fast configuration")
    t15 = time.perf_counter()
    int8_launches = int8_path(dev, card)
    print(f"phase 15b: {time.perf_counter() - t15:.1f} s", flush=True)

    t16 = time.perf_counter()
    legacy_path(dev, card, root)
    print(f"phase 16: {time.perf_counter() - t16:.1f} s", flush=True)

    t17 = time.perf_counter()
    stn_img_launches = station_image_path(tree, dev, card)
    print(f"phase 17: {time.perf_counter() - t17:.1f} s", flush=True)

    err, k_ms, p_ms = report["bfloat16"]
    b_err, b_ms, r_ms, _, (w_err, w_ms, wp_ms, w_bound) = bwd_report[
        "bfloat16"]
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
    # K1's launches on every path that runs it, for the kernel report
    fwd_by_path = {
        "evaluation": eval_launches,
        "training": train_counts["window_attention_fwd"],
        "serving": serving_launches, "generation": gen_launches,
        "station evaluation": station_launches,
        "data parallel evaluation, rank 0": dp_eval_launches,
        "data parallel train step, rank 0": dp_train_counts[0],
        "class-head step": class_counts["window_attention_fwd"],
        "int8 forward": int8_launches[0],
        "station-image f32 forward": stn_img_launches[0],
        "station-image --fast forward": stn_img_launches[1]}
    # each path's count split by the design its launches took
    for path, n in fwd_by_path.items():
        if sum(K1_DESIGNS_BY_PATH[path].values()) != n:
            raise AssertionError(f"{path}: K1 launches by design "
                                 f"{K1_DESIGNS_BY_PATH[path]}, counted {n}")
    fwd_by_path = {path: K1_DESIGNS_BY_PATH[path] for path in fwd_by_path}
    print("window_attention_fwd launches by path and design: "
          + ", ".join(f"{k} {v}" for k, v in fwd_by_path.items())
          + f"; window_attention_bwd in the data-parallel train step "
          f"{dp_train_counts[1]}; class-head step {class_counts}; int8 convs "
          f"{int8_launches[1]}",
          flush=True)
    train_bound = attention_bound_ms(TRAIN_WINDOWS, 53, 128, 32, 32, 2)
    print(f"window_attention_fwd, bf16: Bw 9,000 {k_ms:.3f} ms (bound "
          f"{fwd_bound[0]:.3f}); Bw 1,440 rate {DROPOUT} "
          f"{dropout_report['bfloat16'][1]:.3f} ms (bound "
          f"{train_bound[0]:.3f}); card: {card}", flush=True)
    kernels = [
        ("window_attention_fwd", "window_attention_fwd.cu", f"{tpu}:139",
         train_counts["window_attention_fwd"], err, k_ms, p_ms, fwd_bound,
         None),
        ("window_attention_bwd", "window_attention_bwd.cu", f"{tpu}:534",
         train_counts["window_attention_bwd"], b_err, b_ms, r_ms, bwd_bound,
         None),
        # the plain time is that of K3-w's own plain version, two einsums;
        # no one PyTorch call computes both products
        ("window_attention_wgrad", "window_attention_wgrad.cu", f"{tpu}:534",
         train_counts["window_attention_wgrad"], w_err, w_ms, wp_ms,
         w_bound, None),
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
    # the design each entry ran, where its kernel has more than one: K1's
    # and K3's bf16 strip paths, and the routes the wrappers count (phases
    # 7b-12b refuse any other design at the repros' bf16 widths)
    designs = {"window_attention_fwd": "strip", "window_attention_bwd":
               "strip", "fused_mbconv": "bands",
               "perhead_attention_w8": "wgmma",
               "perhead_attention_w16": "wgmma",
               "perhead_weight_attention": "wgmma",
               "headmajor_attention": "wgmma",
               "crosshead_norm_attention": "wgmma",
               "maxvit_layer_attention": "strip",
               "stacked_softmax_attention": "strip",
               "dropout_keep_mask": "chunks",
               "staged_attention_core": "ring"}
    designs.update({k[0]: "strip" for k in kernels
                    if k[0].startswith(("outproj_", "headpack_"))})
    # launches on the paths besides the main one, where a kernel has them,
    # by the design each launch took
    by_path = {"window_attention_fwd": fwd_by_path}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src + source,
         "replaces": replaces, "launches": launches, "max_abs_err": e,
         "ms": ms, "plain_ms": plain_ms, "bound_ms": bound[0],
         "bound_by": bound[1], "library_ms": library,
         "design": designs.get(name, "only"),
         **({"launches_by_path": by_path[name]} if name in by_path else {})}
        for name, source, replaces, launches, e, ms, plain_ms, bound, library
        in kernels]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
