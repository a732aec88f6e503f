"""CLI: the evaluation entry point of the PyTorch port.

``python -m vit_grid_model_tpu_torch.cli.evaluation_vit`` takes the flags of
``vit_grid_model_tpu/cli/evaluation_vit.py`` with the same defaults.  Here
``--gpus N`` runs on ``cuda:N`` (and fails when CUDA is absent), and
``--gpus cpu`` on the CPU.  ``--fast`` means bf16 compute, the fused lead
stem and host-prepared NHWC input; on the GPU the window attention always
runs the hand-written kernel.  ``--precision highest`` turns TF32 off for
matmuls and convolutions; any other value allows it.

Data parallel: one process a GPU, launched by torchrun,

    torchrun --nproc_per_node 8 -m vit_grid_model_tpu_torch.cli.\
evaluation_vit --data_parallel -1 ...

Each rank runs on ``cuda:LOCAL_RANK`` (``--gpus`` stays at its default 0,
or names that card; ``--gpus cpu`` runs the ranks on the CPU over gloo) and
evaluates its rows of every batch; rank 0 alone prints and writes the log.
``--data_parallel`` is -1 (the world size) or the world size; without
torchrun a request for more than one device raises with the line above.
"""

from __future__ import annotations

import argparse
import os
import sys
from datetime import datetime

import numpy as np
import torch
import torch.distributed as dist

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import (DataConfig, GridConfig,
                                                  MetNet3Config)
from vit_grid_model_tpu_torch.core.weights import (load_reference_checkpoint,
                                                   seeded_model)
from vit_grid_model_tpu_torch.data import synthetic
from vit_grid_model_tpu_torch.evaluation import driver, parity
from vit_grid_model_tpu_torch.parallel.mesh import data_parallel_for_cli

MODULE = "vit_grid_model_tpu_torch.cli.evaluation_vit"


def launch_epilog(module: str) -> str:
    """The ``--help`` text on data-parallel launches."""
    return (f"Data parallel: `torchrun --nproc_per_node N -m {module} "
            "--data_parallel -1 ...` runs one process a GPU, each on "
            "cuda:LOCAL_RANK (--gpus cpu: the ranks on the CPU over gloo); "
            "rank 0 alone prints and writes logs and checkpoints.")


def build_parser() -> argparse.ArgumentParser:
    """The options of ``vit_grid_model_tpu/cli/evaluation_vit.py`` with the
    same defaults (``tests/test_torch_port_host.py`` holds them equal)."""
    p = argparse.ArgumentParser(description="evaluation MultiAir",
                                epilog=launch_epilog(MODULE))
    # --- reference-compatible surface (defaults identical) ---
    p.add_argument("--seed", type=int, default=0, help="random seed")
    p.add_argument("--batch_size", type=int, default=24,
                   help="number of batch size")
    p.add_argument("--data_path", type=str,
                   default="../preprocessed_data_from_2016",
                   help="path of data")
    p.add_argument("--sim_data_path", type=str,
                   default="../../short_term/nier_preprocessed/CMAQ",
                   help="path of simulation data")
    p.add_argument("--analysis_data_path", type=str,
                   default="../analysis/CMAQ", help="path of analysis data")
    p.add_argument("--model_name", type=str, default="",
                   help="name of model to evaluate")
    p.add_argument("--gpus", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    p.add_argument("--hidden_dim", type=int, default=128,
                   help="hidden dimension for LSTM")
    p.add_argument("--output_dim", type=int, default=6,
                   help="number of predictions")
    p.add_argument("--input_dim", type=int, default=7,
                   help="input window size")
    p.add_argument("--prev_len", type=int, default=7,
                   help="previous length for statistics of data")
    p.add_argument("--feat_dim", type=int, default=12,
                   help="feature dimension")
    # --- additions of the rebuild ---
    p.add_argument("--checkpoint", type=str, default=None,
                   help="torch .pkt; default check_points/{model_name}.pkt "
                        "like the reference")
    p.add_argument("--test_start", type=str, default="2023-01-01T00")
    p.add_argument("--test_end", type=str, default="2023-03-31T23")
    p.add_argument("--synthetic", action="store_true",
                   help="generate a synthetic data tree (no external data)")
    p.add_argument("--synthetic_root", type=str, default="/tmp/vit_synth")
    p.add_argument("--precision", type=str, default="highest",
                   choices=["default", "high", "highest"],
                   help="highest turns TF32 off (f32 parity)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--fast", action="store_true",
                   help="throughput mode: bf16 + fused stem + host-prepared "
                        "NHWC input staging (not for checkpoint-parity "
                        "scoring)")
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--log_dir", type=str, default="logs")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks: -1 or the world size under torchrun, 1 "
                        "without")
    p.add_argument("--collect_valid_times", action="store_true",
                   help="reproduce reference quirk #19: collect encoded "
                        "sample times with last input hour == 6")
    p.add_argument("--parity_report", type=str, default=None, metavar="BASE",
                   help="after evaluating, diff the summary against a "
                        "baseline table and pass/fail the <=1e-3 model-RMSE "
                        "gate. BASE is a baseline JSON path, or the literal "
                        "'reference' for the shipped 12hr golden-log table. "
                        "Exits 1 on gate failure.")
    p.add_argument("--parity_save", type=str, default=None, metavar="PATH",
                   help="write this run's summary as a parity-baseline JSON")
    return p


def select_device(gpus: str) -> torch.device:
    """``--gpus``: the CPU, or ``cuda:N``.  Under torchrun a rank runs on
    ``cuda:LOCAL_RANK``, which ``--gpus`` at its default 0 stands for; any
    other card raises."""
    if gpus == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(f"--gpus {gpus}: CUDA is not available "
                           "(use --gpus cpu for the CPU)")
    if distributed.launched():
        local = distributed.local_rank()
        if int(gpus) not in (0, local):
            raise ValueError(f"--gpus {gpus}: under torchrun this rank runs "
                             f"on cuda:{local} (LOCAL_RANK)")
        return torch.device(f"cuda:{local}")
    return torch.device(f"cuda:{int(gpus)}")


def rank_print(group):
    """``print`` on rank 0, a no-op on the other ranks."""
    if distributed.is_primary(group):
        return print
    return lambda *a, **k: None


def synthetic_tree(group, root: str, start: datetime, end: datetime,
                   **kw):
    """``synthetic.generate_tree`` written by rank 0 alone; every rank
    returns its paths once it is written."""
    paths = [None]
    if distributed.is_primary(group):
        paths[0] = synthetic.generate_tree(root, start, end, **kw)
    if group is not None:
        dist.broadcast_object_list(paths, 0, group=group)
    return paths[0]


def build_configs(args, group=None):
    """Synthetic-tree generation, DataConfig, the --fast coupling and the
    MetNet3Config.  Mutates ``args`` (paths, compute_dtype, precision) as
    the JAX CLI does.  Returns (data_cfg, model_cfg, test_start, test_end)."""
    test_start = datetime.fromisoformat(args.test_start)
    test_end = datetime.fromisoformat(args.test_end)
    if args.synthetic:
        paths = synthetic_tree(
            group, args.synthetic_root, test_start, test_end,
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


def load_model(args, model_cfg: MetNet3Config, say=print):
    """``--checkpoint`` or ``check_points/{model_name}.pkt`` when it exists,
    else weights drawn from ``--seed`` (synthetic smoke runs)."""
    ckpt = args.checkpoint or f"check_points/{args.model_name}.pkt"
    if os.path.exists(ckpt):
        if not ckpt.endswith(".pkt"):
            raise ValueError(f"{ckpt}: the port loads torch .pkt "
                             "checkpoints only")
        say(f"loaded torch checkpoint: {ckpt}")
        return load_reference_checkpoint(ckpt, model_cfg)
    if args.checkpoint is not None:
        raise FileNotFoundError(f"checkpoint not found: {ckpt}")
    say(f"checkpoint {ckpt} not found; using seeded random weights "
        "(synthetic smoke mode)")
    return seeded_model(model_cfg, args.seed)


def place_model(model, device, dtype: str, group, say=print):
    """``model`` on ``device`` in ``dtype``; with a process group, rank 0's
    f32 weights broadcast to every rank before the cast."""
    model = model.to(device)
    if group is not None:
        distributed.broadcast_module(model, group)
    model = model.to(dtype=getattr(torch, dtype))
    say(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
        + (f"; rank 0 of {distributed.world_size(group)}"
           if group is not None else ""))
    return model


def main(argv=None, *, timing: driver.BatchTiming = None):
    """Evaluate and return the metrics (None on ranks other than 0)."""
    args = build_parser().parse_args(argv)
    device = select_device(args.gpus)
    group = data_parallel_for_cli(args.data_parallel, args.batch_size,
                                  device, module=MODULE)
    say = rank_print(group)
    np.random.seed(args.seed)
    data_cfg, model_cfg, test_start, test_end = build_configs(args, group)
    # --fast resets args.precision, so the TF32 switches follow it
    tf32 = args.precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    model = place_model(load_model(args, model_cfg, say), device,
                        args.compute_dtype, group, say)
    say(args)
    metrics = driver.evaluate(
        model, data_cfg, model_name=args.model_name or "model",
        test_start=test_start, test_end=test_end,
        batch_size=args.batch_size, num_workers=args.num_workers,
        log_dir=args.log_dir, args_repr=str(args),
        max_batches=args.max_batches, timing=timing,
        collect_valid_times=args.collect_valid_times, group=group)
    if metrics is None:
        return None
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
