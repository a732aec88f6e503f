"""CLI: batched PM2.5 re-analysis generation, the port's entry point.

``python -m vit_grid_model_tpu_torch.cli.generate_reanalysis`` takes the
flags of ``vit_grid_model_tpu/cli/generate_reanalysis.py`` with the same
defaults, plus ``--gpus N`` (run on ``cuda:N``, failing when CUDA is
absent) or ``--gpus cpu``.  ``--data_parallel`` keeps its default of -1,
all devices; it runs when that resolves to one device and raises when it
resolves to more (data-parallel generation is not ported yet).
``--pallas`` is accepted as in the JAX CLI; on the GPU the window
attention always runs the hand-written kernel.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

import torch

from vit_grid_model_tpu_torch.cli.evaluation_vit import select_device
from vit_grid_model_tpu_torch.core.config import (DataConfig, GridConfig,
                                                  MetNet3Config)
from vit_grid_model_tpu_torch.core.weights import (load_reference_checkpoint,
                                                   seeded_model)
from vit_grid_model_tpu_torch.evaluation import driver
from vit_grid_model_tpu_torch.evaluation.generate import generate_reanalysis


def build_parser() -> argparse.ArgumentParser:
    """The options of ``vit_grid_model_tpu/cli/generate_reanalysis.py``
    with the same defaults, and ``--gpus``."""
    p = argparse.ArgumentParser(description="generate re-analysis fields")
    p.add_argument("--checkpoint", type=str, required=False, default=None)
    p.add_argument("--start", type=str, default="2023-01-01T00")
    p.add_argument("--end", type=str, default="2023-01-02T23")
    p.add_argument("--out_dir", type=str, default="reanalysis_out")
    p.add_argument("--data_path", type=str, required=True)
    p.add_argument("--sim_data_path", type=str, required=True)
    p.add_argument("--analysis_data_path", type=str, required=True)
    p.add_argument("--input_dim", type=int, default=13)
    p.add_argument("--output_dim", type=int, default=12)
    p.add_argument("--prev_len", type=int, default=13)
    p.add_argument("--feat_dim", type=int, default=12)
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--data_parallel", type=int, default=-1,
                   help="-1: all devices")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--pallas", action="store_true", default=False)
    p.add_argument("--gpus", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    return p


def data_parallel_devices(requested: int, device: torch.device) -> int:
    """``--data_parallel``'s device count: -1 is every device of the
    selected kind (the CPU counts as one).  Raises unless it is one."""
    n = requested
    if n == -1:
        n = torch.cuda.device_count() if device.type == "cuda" else 1
    if n != 1:
        raise ValueError(f"--data_parallel {requested} resolves to {n} "
                         "devices; data-parallel runs are not ported yet")
    return n


def main(argv=None, *, timing: driver.BatchTiming = None) -> int:
    args = build_parser().parse_args(argv)
    device = select_device(args.gpus)
    data_parallel_devices(args.data_parallel, device)

    data_cfg = DataConfig(
        input_dim=args.input_dim, output_dim=args.output_dim,
        prev_len=args.prev_len, feat_dim=args.feat_dim, grid=GridConfig(),
        data_path=args.data_path, sim_data_path=args.sim_data_path,
        analysis_data_path=args.analysis_data_path)
    feat_infos = driver.load_feat_infos(args.data_path)
    model_cfg = MetNet3Config(
        window_size=data_cfg.total_steps, n_variables=24,
        n_start_channels=args.hidden_dim, end_lead_time=args.output_dim,
        input_height=data_cfg.grid.height, input_width=data_cfg.grid.width,
        pm25_mean=feat_infos["PM2.5"][0], pm25_std=feat_infos["PM2.5"][1],
        compute_dtype=args.compute_dtype, fuse_lead_stem=True,
        use_pallas_attention=args.pallas,
        # bf16 generation stages host-prepared in the device layout
        nhwc_input=args.compute_dtype == "bfloat16")

    if args.checkpoint:
        if not args.checkpoint.endswith(".pkt"):
            raise ValueError(f"{args.checkpoint}: the port loads torch .pkt "
                             "checkpoints only")
        if not os.path.exists(args.checkpoint):
            raise FileNotFoundError(
                f"checkpoint not found: {args.checkpoint}")
        model = load_reference_checkpoint(args.checkpoint, model_cfg)
    else:
        print("no checkpoint: random init (smoke mode)")
        model = seeded_model(model_cfg, 0)
    model = model.to(device=device, dtype=getattr(torch, args.compute_dtype))

    n = generate_reanalysis(
        model, data_cfg, start=datetime.fromisoformat(args.start),
        end=datetime.fromisoformat(args.end), out_dir=args.out_dir,
        batch_size=args.batch_size, device=device, timing=timing)
    print(f"wrote {n} fields to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
