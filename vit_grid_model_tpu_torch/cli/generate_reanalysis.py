"""CLI: batched PM2.5 re-analysis generation, the port's entry point.

``python -m vit_grid_model_tpu_torch.cli.generate_reanalysis`` takes the
flags of ``vit_grid_model_tpu/cli/generate_reanalysis.py`` with the same
defaults, plus ``--gpus N`` (run on ``cuda:N``, failing when CUDA is
absent) or ``--gpus cpu``.  ``--data_parallel`` keeps its default of -1,
all devices: one process a GPU, launched by torchrun,

    torchrun --nproc_per_node 8 -m vit_grid_model_tpu_torch.cli.\
generate_reanalysis ...

each rank on ``cuda:LOCAL_RANK`` writing the fields of its rows of every
batch.  The arguments may also come from a file, one a line, as
``@FILE``: where torchrun's parser has both ``--start-method`` and
``--start_method`` (and Python's argparse takes an abbreviation that two
option strings share as ambiguous), ``--start`` on torchrun's command line
stops it, and ``@FILE`` carries it past.  Without torchrun, -1 runs when it resolves to one device and
raises with that line when it resolves to more.  ``--pallas`` is accepted
as in the JAX CLI; on the GPU the window attention always runs the
hand-written kernel.
"""

from __future__ import annotations

import argparse
import os
from datetime import datetime

from vit_grid_model_tpu_torch.cli.evaluation_vit import (launch_epilog,
                                                         place_model,
                                                         rank_print,
                                                         select_device)
from vit_grid_model_tpu_torch.core.config import (DataConfig, GridConfig,
                                                  MetNet3Config)
from vit_grid_model_tpu_torch.core.weights import (load_reference_checkpoint,
                                                   seeded_model)
from vit_grid_model_tpu_torch.evaluation import driver
from vit_grid_model_tpu_torch.evaluation.generate import generate_reanalysis
from vit_grid_model_tpu_torch.parallel.mesh import data_parallel_for_cli

MODULE = "vit_grid_model_tpu_torch.cli.generate_reanalysis"


def build_parser() -> argparse.ArgumentParser:
    """The options of ``vit_grid_model_tpu/cli/generate_reanalysis.py``
    with the same defaults, and ``--gpus``."""
    p = argparse.ArgumentParser(
        description="generate re-analysis fields",
        epilog=launch_epilog(MODULE) + "  Under torchrun, pass the "
        "arguments as @FILE (one a line) if torchrun takes --start for "
        "an ambiguous abbreviation of --start-method.",
        fromfile_prefix_chars="@")
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
                   help="-1: all devices (the world size under torchrun)")
    p.add_argument("--compute_dtype", type=str, default="bfloat16")
    p.add_argument("--pallas", action="store_true", default=False)
    p.add_argument("--gpus", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    return p


def main(argv=None, *, timing: driver.BatchTiming = None) -> int:
    """Generate and return the number of fields all ranks wrote."""
    args = build_parser().parse_args(argv)
    device = select_device(args.gpus)
    group = data_parallel_for_cli(args.data_parallel, args.batch_size,
                                  device, module=MODULE)
    say = rank_print(group)

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
        say("no checkpoint: random init (smoke mode)")
        model = seeded_model(model_cfg, 0)
    model = place_model(model, device, args.compute_dtype, group, say)

    n = generate_reanalysis(
        model, data_cfg, start=datetime.fromisoformat(args.start),
        end=datetime.fromisoformat(args.end), out_dir=args.out_dir,
        batch_size=args.batch_size, device=device, timing=timing,
        group=group)
    say(f"wrote {n} fields to {args.out_dir}")
    return n


if __name__ == "__main__":
    main()
