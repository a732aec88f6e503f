"""CLI: train MetNet3 with the PyTorch port (CMAQ -> reanalysis data, or a
synthetic tree).

``python -m vit_grid_model_tpu_torch.cli.train_vit`` takes the flags of
``vit_grid_model_tpu/cli/train_vit.py`` with the same defaults, plus
``--gpus N|cpu`` as in the port's evaluation CLI.  ``--fast`` means bf16
compute over f32 master weights, the fused lead stem and host-prepared NHWC
input; on the GPU the window attention always runs the hand-written forward
and backward kernels, so ``--use_pallas_attention(_bwd)`` are accepted and
change nothing.  Checkpoints: ``{model_name}.pkt`` (a plain state_dict that
both evaluation CLIs load), ``{model_name}_state.pt`` (the full train state;
``--resume`` continues from it) and, with ``--ema_decay``,
``{model_name}_ema.pkt``.

Data parallel: one process a GPU, launched by torchrun,

    torchrun --nproc_per_node 8 -m vit_grid_model_tpu_torch.cli.train_vit \
        --data_parallel -1 --batch_size 32 ...

``--batch_size`` is the global batch, which divides over the ranks.  Each
rank runs on ``cuda:LOCAL_RANK`` and every rank reads the same batches and
trains on its rows of each (``train/trainer.py``); rank 0 alone logs and
writes the checkpoints.
"""

from __future__ import annotations

import argparse
import itertools
import os
from datetime import datetime
from typing import Callable, List, Optional

import numpy as np
import torch

from vit_grid_model_tpu_torch.cli.evaluation_vit import (launch_epilog,
                                                         rank_print,
                                                         select_device,
                                                         synthetic_tree)
from vit_grid_model_tpu_torch.core import checkpoint as ckpt
from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import (DataConfig, GridConfig,
                                                  MetNet3Config, TrainConfig)
from vit_grid_model_tpu_torch.core.weights import (load_reference_checkpoint,
                                                   seeded_model)
from vit_grid_model_tpu_torch.data.assembly import (sim_stack_to_model_input,
                                                    sim_stack_to_nhwc_input)
from vit_grid_model_tpu_torch.data.datasets import (
    AirSimulationReanalysisDatasetV3)
from vit_grid_model_tpu_torch.data.pipeline import BatchLoader
from vit_grid_model_tpu_torch.data.timeutil import eval_time_list
from vit_grid_model_tpu_torch.evaluation import driver
from vit_grid_model_tpu_torch.parallel.mesh import (data_parallel_for_cli,
                                                    shard_rows)
from vit_grid_model_tpu_torch.train.trainer import (build_train_step,
                                                    init_train_state,
                                                    train_loop)

MODULE = "vit_grid_model_tpu_torch.cli.train_vit"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="train MetNet3 (PyTorch port)",
                                epilog=launch_epilog(MODULE))
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--data_path", type=str,
                   default="../preprocessed_data_from_2016")
    p.add_argument("--sim_data_path", type=str,
                   default="../../short_term/nier_preprocessed/CMAQ")
    p.add_argument("--analysis_data_path", type=str, default="../analysis/CMAQ")
    p.add_argument("--model_name", type=str, default="vit_tpu_model")
    p.add_argument("--gpus", type=str, default="0",
                   help="CUDA device index, or 'cpu'")
    p.add_argument("--hidden_dim", type=int, default=128)
    p.add_argument("--output_dim", type=int, default=12)
    p.add_argument("--input_dim", type=int, default=13)
    p.add_argument("--prev_len", type=int, default=13)
    p.add_argument("--feat_dim", type=int, default=12)
    p.add_argument("--train_start", type=str, default="2022-01-01T00")
    p.add_argument("--train_end", type=str, default="2022-12-31T23")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--weight_decay", type=float, default=1e-4)
    p.add_argument("--warmup_steps", type=int, default=100)
    p.add_argument("--loss", type=str, default="focal_r",
                   choices=["focal_r", "mse", "mae", "huber"])
    p.add_argument("--focal_beta", type=float, default=0.2)
    p.add_argument("--focal_gamma", type=float, default=1.0)
    p.add_argument("--focal_focusing", type=str, default="canonical",
                   choices=["canonical", "sigmoid"],
                   help="Focal-R focusing factor: canonical "
                        "(2*sigmoid(beta|e|)-1)^gamma, 0 at e=0, or the "
                        "legacy sigmoid(beta|e|)^gamma in [0.5, 1)")
    p.add_argument("--remat", action="store_true",
                   help="recompute the backbone in the backward "
                        "(torch.utils.checkpoint)")
    p.add_argument("--compute_dtype", type=str, default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--dropout", type=float, default=0.1,
                   help="attention dropout rate (reference default)")
    p.add_argument("--use_pallas_attention", action="store_true",
                   help="accepted for compatibility; the GPU always runs "
                        "the hand-written attention kernels")
    p.add_argument("--use_pallas_attention_bwd", action="store_true",
                   help="accepted for compatibility; the GPU always runs "
                        "the hand-written backward kernel")
    p.add_argument("--fuse_lead_stem", action="store_true",
                   help="compute the lead-independent part of the stem conv "
                        "once per sample (exact up to float re-association)")
    p.add_argument("--fast", action="store_true",
                   help="throughput mode: bf16 compute + fused lead stem + "
                        "host-prepared NHWC input")
    p.add_argument("--shuffle_mode", choices=("samples", "batches", "buffer"),
                   default="samples",
                   help="'samples' shuffles samples; 'batches' shuffles "
                        "batches of consecutive samples (keeps the loader's "
                        "union-assembly fast path, at the cost of coarser "
                        "SGD noise); 'buffer' keeps union assembly and mixes "
                        "batches through a --shuffle_buffer reservoir")
    p.add_argument("--shuffle_buffer", type=int, default=8,
                   help="reservoir size in batches for "
                        "--shuffle_mode buffer")
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--synthetic_root", type=str, default="/tmp/vit_synth_train")
    p.add_argument("--checkpoint_dir", type=str, default="check_points")
    p.add_argument("--checkpoint_every", type=int, default=500)
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--num_workers", type=int, default=4)
    p.add_argument("--resume", type=str, default=None,
                   help="a *_state.pt resumes the full train state "
                        "(optimizer moments, schedule step, dropout "
                        "generator, EMA) and reseeds the shuffled data "
                        "stream past consumed batches; a .pkt restores "
                        "weights only")
    p.add_argument("--ema_decay", type=float, default=0.0,
                   help="decay of an exponential moving average of the "
                        "weights and BN statistics (0 disables); saved as "
                        "{model_name}_ema.pkt")
    p.add_argument("--data_parallel", type=int, default=1,
                   help="ranks: -1 or the world size under torchrun, 1 "
                        "without")
    return p


def batches_from_dataset(dataset, data_cfg: DataConfig, batch_size: int,
                         num_workers: int, seed: int,
                         shuffle_mode: str = "samples",
                         shuffle_buffer: int = 8, nhwc: bool = False,
                         pad_multiple: int = 14, group=None):
    """Dataset samples -> train-step batches of numpy arrays, looping
    epochs.  The model input is staged in f32 (NHWC with ``nhwc``) and cast
    to the compute dtype on the device.  With a process ``group`` every
    rank reads the same global batches and assembles only its own rows;
    the timestamps stay global (``build_train_step``'s contract)."""
    shuffle = (shuffle_mode if shuffle_mode in ("batches", "buffer")
               else True)
    # the loader's SeedSequence refuses negative seeds
    loader = BatchLoader(dataset, batch_size=batch_size, shuffle=shuffle,
                         seed=seed & 0xFFFFFFFFFFFFFFFF,
                         num_workers=num_workers,
                         shuffle_buffer=shuffle_buffer)
    while True:
        for (feats, masks, sim, curr, reanalysis, cls, raw_times,
             prev) in loader:
            sim = shard_rows(sim, group)
            x = (sim_stack_to_nhwc_input(sim, data_cfg.total_steps,
                                         pad_multiple, np.float32)
                 if nhwc else
                 sim_stack_to_model_input(sim, data_cfg.total_steps,
                                          out_dtype=np.float32))
            yield {"x": x, "timestamps": raw_times,
                   "targets": shard_rows(reanalysis, group)}


def main(argv=None, *, step_seconds: Optional[List[float]] = None,
         log: Callable[[str], None] = print):
    """Train and return the final train state.  ``log`` receives the
    trainer's log lines; ``step_seconds``, when given, receives each step's
    host-clock seconds, the wait for its batch included (each step then
    waits for its loss)."""
    args = build_parser().parse_args(argv)
    device = select_device(args.gpus)
    group = data_parallel_for_cli(args.data_parallel, args.batch_size,
                                  device, module=MODULE)
    say = rank_print(group)
    log = log if distributed.is_primary(group) else say

    train_start = datetime.fromisoformat(args.train_start)
    train_end = datetime.fromisoformat(args.train_end)
    if args.synthetic:
        paths = synthetic_tree(
            group, args.synthetic_root, train_start, train_end,
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
    stations = driver.load_stations(args.data_path)
    if args.fast:
        args.compute_dtype = "bfloat16"
        args.fuse_lead_stem = True
    model_cfg = MetNet3Config(
        window_size=data_cfg.total_steps, n_variables=24,
        n_start_channels=args.hidden_dim, end_lead_time=args.output_dim,
        input_height=data_cfg.grid.height, input_width=data_cfg.grid.width,
        pm25_mean=feat_infos["PM2.5"][0], pm25_std=feat_infos["PM2.5"][1],
        compute_dtype=args.compute_dtype, dropout=args.dropout,
        fuse_lead_stem=args.fuse_lead_stem, nhwc_input=args.fast)
    train_cfg = TrainConfig(
        learning_rate=args.lr, weight_decay=args.weight_decay,
        warmup_steps=args.warmup_steps, total_steps=args.steps,
        batch_size=args.batch_size, loss=args.loss,
        focal_beta=args.focal_beta, focal_gamma=args.focal_gamma,
        focal_focusing=args.focal_focusing,
        remat=args.remat, seed=args.seed, ema_decay=args.ema_decay)

    times = eval_time_list(train_start, train_end, args.prev_len,
                           args.output_dim)
    feats, masks = driver.load_ground_obs(
        args.data_path, times, stations.total, args.feat_dim)
    dataset = AirSimulationReanalysisDatasetV3(
        times, feats, masks, input_dim=args.input_dim,
        output_dim=args.output_dim, prev_len=args.prev_len,
        korea_stn_num=stations.korea_stn_num,
        china_stn_num=stations.china_stn_num, cmaq_size=(82, 67),
        sim_data_path=args.sim_data_path,
        reanalysis_data_path=args.analysis_data_path, feat_infos=feat_infos)
    say(f"device: {device}"
        + (f" ({torch.cuda.get_device_name(device)})"
           if device.type == "cuda" else "")
        + f"; dataset: {len(dataset)} samples"
        + (f"; rank 0 of {distributed.world_size(group)}"
           if group is not None else ""))

    # f32 master weights: a .pkt to resume from, else drawn from --seed as
    # the evaluation CLI draws them
    full_resume = bool(args.resume) and args.resume.endswith("_state.pt")
    if args.resume and not full_resume:
        model = load_reference_checkpoint(args.resume, model_cfg)
        say(f"resumed parameters only from {args.resume} "
            "(optimizer moments and schedule restart)")
    else:
        model = seeded_model(model_cfg, args.seed)
    model = model.to(device)
    if group is not None:
        distributed.broadcast_module(model, group)
    state = init_train_state(model, train_cfg)
    if full_resume:
        ckpt.restore_train_state(args.resume, state, group)
        say(f"resumed full train state from {args.resume} "
            f"(step {state.step})")
    step_fn = build_train_step(model_cfg, train_cfg, group)

    ckpt_base = os.path.join(args.checkpoint_dir, args.model_name)
    os.makedirs(args.checkpoint_dir, exist_ok=True)
    # a resumed run takes fresh data: the restored step is folded into the
    # shuffle seed, as in the JAX CLI
    batches = batches_from_dataset(
        dataset, data_cfg, args.batch_size, args.num_workers,
        args.seed + state.step, shuffle_mode=args.shuffle_mode,
        shuffle_buffer=args.shuffle_buffer, nhwc=model_cfg.nhwc_input,
        pad_multiple=model_cfg.pad_multiple, group=group)

    done = 0
    remaining = args.steps - state.step
    while done < remaining:
        chunk = min(args.checkpoint_every, remaining - done)
        train_loop(state, itertools.islice(batches, chunk), step_fn,
                   log_every=args.log_every, log=log,
                   step_seconds=step_seconds)
        done += chunk
        path = ckpt.save_state_dict(f"{ckpt_base}.pkt", state.model,
                                    group=group)
        ckpt.save_train_state(f"{ckpt_base}_state.pt", state, group)
        if state.ema is not None:
            ckpt.save_state_dict(f"{ckpt_base}_ema.pkt", state.model,
                                 override=state.ema, group=group)
        say(f"step {state.step}: checkpoint -> {path} "
            f"(+ {ckpt_base}_state.pt)")
    say("training complete")
    return state


if __name__ == "__main__":
    main()
