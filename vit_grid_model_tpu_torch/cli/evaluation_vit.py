"""CLI: the evaluation entry point of the PyTorch port.

``python -m vit_grid_model_tpu_torch.cli.evaluation_vit`` takes the flags of
``vit_grid_model_tpu/cli/evaluation_vit.py`` with the same defaults.  Here
``--gpus N`` runs on ``cuda:N`` (and fails when CUDA is absent), and
``--gpus cpu`` on the CPU.  ``--fast`` means bf16 compute, the fused lead
stem and host-prepared NHWC input; on the GPU the window attention always
runs the hand-written kernel.  ``--precision highest`` turns TF32 off for
matmuls and convolutions; any other value allows it.
"""

from __future__ import annotations

import os
import sys
from datetime import datetime

import numpy as np
import torch

from vit_grid_model_tpu.cli.evaluation_vit import build_parser
from vit_grid_model_tpu.core.config import DataConfig, GridConfig, MetNet3Config
from vit_grid_model_tpu.evaluation import parity
from vit_grid_model_tpu_torch.core.weights import (load_reference_checkpoint,
                                                   seeded_model)
from vit_grid_model_tpu_torch.evaluation import driver


def select_device(gpus: str) -> torch.device:
    if gpus == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpus {gpus}: CUDA is not available "
                           "(use --gpus cpu for the CPU)")
    return torch.device(f"cuda:{int(gpus)}")


def build_configs(args):
    """Synthetic-tree generation, DataConfig, the --fast coupling and the
    MetNet3Config.  Mutates ``args`` (paths, compute_dtype, precision) as
    the JAX CLI does.  Returns (data_cfg, model_cfg, test_start, test_end)."""
    test_start = datetime.fromisoformat(args.test_start)
    test_end = datetime.fromisoformat(args.test_end)
    if args.synthetic:
        from vit_grid_model_tpu.data import synthetic

        paths = synthetic.generate_tree(
            args.synthetic_root, test_start, test_end,
            prev_len=args.prev_len, output_dim=args.output_dim)
        args.data_path = paths["data_path"]
        args.sim_data_path = paths["sim_data_path"]
        args.analysis_data_path = paths["analysis_data_path"]

    data_cfg = DataConfig(
        input_dim=args.input_dim, output_dim=args.output_dim,
        prev_len=args.prev_len, feat_dim=args.feat_dim, grid=GridConfig(),
        data_path=args.data_path, sim_data_path=args.sim_data_path,
        analysis_data_path=args.analysis_data_path)
    feat_infos = driver.load_feat_infos(args.data_path)
    if args.fast:
        args.compute_dtype = "bfloat16"
        args.precision = "default"
    model_cfg = MetNet3Config(
        window_size=args.input_dim + args.output_dim, n_variables=24,
        n_start_channels=args.hidden_dim, end_lead_time=args.output_dim,
        input_height=data_cfg.grid.height, input_width=data_cfg.grid.width,
        pm25_mean=feat_infos["PM2.5"][0], pm25_std=feat_infos["PM2.5"][1],
        compute_dtype=args.compute_dtype, fuse_lead_stem=args.fast,
        nhwc_input=args.fast)
    return data_cfg, model_cfg, test_start, test_end


def load_model(args, model_cfg: MetNet3Config):
    """``--checkpoint`` or ``check_points/{model_name}.pkt`` when it exists,
    else weights drawn from ``--seed`` (synthetic smoke runs)."""
    ckpt = args.checkpoint or f"check_points/{args.model_name}.pkt"
    if os.path.exists(ckpt):
        if not ckpt.endswith(".pkt"):
            raise ValueError(f"{ckpt}: the port loads torch .pkt "
                             "checkpoints only")
        print(f"loaded torch checkpoint: {ckpt}")
        return load_reference_checkpoint(ckpt, model_cfg)
    if args.checkpoint is not None:
        raise FileNotFoundError(f"checkpoint not found: {ckpt}")
    print(f"checkpoint {ckpt} not found; using seeded random weights "
          "(synthetic smoke mode)")
    return seeded_model(model_cfg, args.seed)


def main(argv=None, *, timing: driver.BatchTiming = None):
    args = build_parser().parse_args(argv)
    device = select_device(args.gpus)
    np.random.seed(args.seed)
    data_cfg, model_cfg, test_start, test_end = build_configs(args)
    # --fast resets args.precision, so the TF32 switches follow it
    tf32 = args.precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    if args.data_parallel != 1:
        raise ValueError("--data_parallel is not ported yet")
    if args.collect_valid_times:
        raise ValueError("--collect_valid_times is not ported yet")

    model = load_model(args, model_cfg)
    model = model.to(device=device, dtype=getattr(torch, args.compute_dtype))
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})"
             if device.type == "cuda" else ""))
    print(args)
    metrics = driver.evaluate(
        model, data_cfg, model_name=args.model_name or "model",
        test_start=test_start, test_end=test_end,
        batch_size=args.batch_size, num_workers=args.num_workers,
        log_dir=args.log_dir, args_repr=str(args),
        max_batches=args.max_batches, timing=timing)
    summary = metrics.summary()
    print("model RMSE: {:.4f}  MAE: {:.4f}  R: {:.4f}".format(
        summary["model"]["RMSE"], summary["model"]["MAE"],
        summary["model"]["R"]))
    if args.parity_save:
        print(f"parity baseline saved: "
              f"{parity.save_baseline(args.parity_save, summary)}")
    if args.parity_report:
        lines, ok = parity.parity_report(
            summary, parity.load_baseline(args.parity_report))
        print("\n".join(lines))
        if not ok:
            sys.exit(1)
    return metrics


if __name__ == "__main__":
    main()
