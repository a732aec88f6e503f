"""CLI: station-wise evaluation of the grid model, the port's entry point.

``python -m vit_grid_model_tpu_torch.cli.station_eval`` takes the flags of
the evaluation CLI (``cli/evaluation_vit.py``), as
``vit_grid_model_tpu/cli/station_eval.py`` does: it runs the MetNet3
forward over the test window, samples the predicted PM2.5 fields at the
stations' grid coordinates, scores them against the ground observations
with their validity flags, and appends a reference-style metric block to
``{log_dir}/test_{model_name}_by_stn.log``.  ``--gpus N`` runs on
``cuda:N`` (and fails when CUDA is absent), ``--gpus cpu`` on the CPU.
Data parallel as the evaluation CLI:

    torchrun --nproc_per_node 8 -m vit_grid_model_tpu_torch.cli.\
station_eval --data_parallel -1 ...

each rank on ``cuda:LOCAL_RANK`` with its rows of every batch; rank 0
scores, prints and writes the log.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from vit_grid_model_tpu_torch.cli import evaluation_vit as ev
from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
from vit_grid_model_tpu_torch.evaluation.station_eval import (
    evaluate_by_station, write_station_log)
from vit_grid_model_tpu_torch.parallel.mesh import data_parallel_for_cli

MODULE = "vit_grid_model_tpu_torch.cli.station_eval"


def build_parser():
    p = ev.build_parser()
    p.description = "station-wise evaluation (by_stn workflow)"
    p.epilog = ev.launch_epilog(MODULE)
    return p


def main(argv=None, *, timing: BatchTiming = None):
    """Score and return the metrics (None on ranks other than 0)."""
    args = build_parser().parse_args(argv)
    if args.collect_valid_times:
        raise SystemExit("--collect_valid_times is a grid-eval quirk "
                         "(evaluation_vit.py:285-289); the station eval has "
                         "no valid-times bookkeeping")
    device = ev.select_device(args.gpus)
    group = data_parallel_for_cli(args.data_parallel, args.batch_size,
                                  device, module=MODULE)
    say = ev.rank_print(group)
    np.random.seed(args.seed)
    data_cfg, model_cfg, test_start, test_end = ev.build_configs(args, group)
    # --fast resets args.precision, so the TF32 switches follow it
    tf32 = args.precision != "highest"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32

    model = ev.place_model(ev.load_model(args, model_cfg, say), device,
                           args.compute_dtype, group, say)
    say(args)

    metrics = evaluate_by_station(
        model, data_cfg, test_start=test_start, test_end=test_end,
        batch_size=args.batch_size, num_workers=args.num_workers,
        max_batches=args.max_batches, device=device, timing=timing,
        group=group)
    if not distributed.is_primary(group):
        return None

    name = (args.model_name or "model") + "_by_stn"
    os.makedirs(args.log_dir, exist_ok=True)
    with open(os.path.join(args.log_dir, f"test_{name}.log"), "a") as f:
        write_station_log(f, metrics, str(args))
    s = metrics.summary()
    print("station RMSE: {:.4f}  MAE: {:.4f}  R: {:.4f}  n_obs: {}".format(
        s["RMSE"], s["MAE"], s["R"], s["n_obs"]))
    return metrics


if __name__ == "__main__":
    main()
