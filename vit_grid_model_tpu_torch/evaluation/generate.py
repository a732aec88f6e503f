"""Batched re-analysis generation, on one device or data parallel.

The PyTorch counterpart of ``vit_grid_model_tpu/evaluation/generate.py``:
stream CMAQ windows through the MetNet3 forward, overlap the host->device
copy of batch k+1 with the forward of batch k, and write one PM2.5 field
file per (sample time, lead hour).  Data parallel (a process ``group``):
each batch is padded to the full batch size as on one device, each rank
assembles and runs its own rows with the global timestamps and writes the
files of its own real samples, so the ranks together write the files of
the one-process run.
"""

from __future__ import annotations

import os
import time
from datetime import datetime
from typing import Optional

import numpy as np
import torch

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import DataConfig
from vit_grid_model_tpu_torch.data.assembly import (sim_stack_to_model_input,
                                                    sim_stack_to_nhwc_input)
from vit_grid_model_tpu_torch.data.datasets import (
    AirSimulationReanalysisDatasetOnly)
from vit_grid_model_tpu_torch.data.pipeline import BatchLoader, device_prefetch
from vit_grid_model_tpu_torch.data.timeutil import eval_time_list
from vit_grid_model_tpu_torch.evaluation import driver as eval_driver
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.parallel.mesh import (pad_to_multiple,
                                                    shard_rows)


def generate_reanalysis(model: MetNet3, data_cfg: DataConfig, *,
                        start: datetime, end: datetime, out_dir: str,
                        batch_size: int = 8, num_workers: int = 4,
                        device="cuda", progress: bool = True,
                        timing: Optional[eval_driver.BatchTiming] = None,
                        group=None) -> int:
    """Generate PM2.5 re-analysis fields for every hour in [start, end].

    Writes ``{out_dir}/{YYYYmmddHH}_{lead:02d}.npy`` (82, 67) float32 per
    sample hour and lead.  Returns the number of fields written (by every
    rank, with a process ``group``, whose ranks each write their own rows'
    files; ``batch_size`` must divide over the ranks).

    ``model`` is moved to ``device`` (CUDA by default, which raises when it
    is absent; the CPU only when asked for) and computes in its parameters'
    dtype.  ``timing``, when given, receives each batch's real sample count
    and loop seconds (the first batch's include the loader's start).
    """
    device = eval_driver.resolve_device(device)
    model = model.to(device).eval()
    model_cfg = model.cfg
    compute_dtype = eval_driver.compute_dtype_of(model)
    grid = data_cfg.grid
    feat_infos = eval_driver.load_feat_infos(data_cfg.data_path)
    stations = eval_driver.load_stations(data_cfg.data_path,
                                         (grid.height, grid.width))
    times = eval_time_list(start, end, data_cfg.prev_len, data_cfg.output_dim)
    feats, masks = eval_driver.load_ground_obs(
        data_cfg.data_path, times, stations.total, data_cfg.feat_dim)
    dataset = AirSimulationReanalysisDatasetOnly(
        times, feats, masks, input_dim=data_cfg.input_dim,
        output_dim=data_cfg.output_dim, prev_len=data_cfg.prev_len,
        korea_stn_num=stations.korea_stn_num,
        china_stn_num=stations.china_stn_num,
        cmaq_size=(grid.height, grid.width),
        sim_data_path=data_cfg.sim_data_path,
        reanalysis_data_path=data_cfg.analysis_data_path,
        feat_infos=feat_infos)
    loader = BatchLoader(dataset, batch_size=batch_size,
                         num_workers=num_workers)
    world = distributed.world_size(group)
    if batch_size % world != 0:
        raise ValueError(f"batch_size {batch_size} must divide over the "
                         f"{world} data-parallel ranks")
    first = distributed.local_batch_slice(batch_size, group).start

    def prepare(batch):
        simulation, _, _, _, raw_times, _ = batch
        # Always pad to the full batch size, by repeating the last sample:
        # the time conditioning mixes embeddings across the rows of a batch
        # (reference quirk #11), so outputs are reproducible only under a
        # fixed batch composition.  The timestamps stay global; of the
        # simulation only this rank's rows are assembled.
        (simulation, raw_times), real = pad_to_multiple(
            (simulation, raw_times), batch_size)
        simulation = shard_rows(simulation, group)
        if model_cfg.nhwc_input:
            # host-prepared device layout (see evaluation/driver.py), in
            # f32 here: the bf16 cast below rounds it as the JAX package's
            # bf16 assembly does
            x = sim_stack_to_nhwc_input(simulation, data_cfg.total_steps,
                                        model_cfg.pad_multiple, np.float32)
        else:
            x = sim_stack_to_model_input(simulation, data_cfg.total_steps)
        # the host tensor rides along until its batch has been read back
        return eval_driver.stage_input(x, raw_times, compute_dtype,
                                       device) + (real,)

    os.makedirs(out_dir, exist_ok=True)
    written = 0
    sample_idx = 0
    t0 = time.time()
    t_prev = time.perf_counter()
    with torch.inference_mode():
        for x, ts, _host, real in device_prefetch(iter(loader), prepare):
            # this rank's rows first .. first + b - 1 of the batch
            preds = model(x, ts, group=group).cpu().numpy()  # (b, L, H, W)
            for b in range(min(preds.shape[0], max(real - first, 0))):
                t = times[dataset._mod_idx(sample_idx + first + b)]
                for lead in range(model_cfg.end_lead_time):
                    path = os.path.join(
                        out_dir,
                        f"{t.strftime('%Y%m%d%H')}_{lead + 1:02d}.npy")
                    np.save(path, preds[b, lead])
                    written += 1
            sample_idx += real
            now = time.perf_counter()
            if timing is not None:
                timing.samples.append(real)
                timing.seconds.append(now - t_prev)
            t_prev = now
            if (progress and distributed.is_primary(group)
                    and sample_idx % (batch_size * 5) < batch_size):
                rate = written / max(time.time() - t0, 1e-9)
                print(f"generated {written} fields ({rate:.1f} fields/s)",
                      flush=True)
    if group is not None:
        written = int(distributed.all_reduce_sum(
            torch.tensor([written], device=device), group).item())
    return written
