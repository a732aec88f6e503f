"""Evaluation driver: the PyTorch counterpart of
``vit_grid_model_tpu/evaluation/driver.py::evaluate``.

Same observable behavior: station/grid/stat metadata loading, the test
window, the batch loop with the persistence / CMAQ-21h / CMAQ-avg
baselines, and the reference-format metric log.  The data plane
(``BatchLoader``, datasets, assembly), the metric engine and the log writer
are the port's own copies of the JAX package's host code
(``vit_grid_model_tpu_torch/data``, ``evaluation/metrics.py``,
``evaluation/logwriter.py``).

Data parallel (``evaluate(..., group=...)``): every rank reads the same
batches and runs its own rows of each (``parallel/mesh.py::shard_rows``)
with the global timestamps; rank 0 gathers the predictions in batch order
and alone updates the metrics and writes the log.  A ragged final batch
(one whose size does not divide over the ranks) runs whole on rank 0 at its
true size, as the JAX package's ``UnshardedTail`` runs it.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from datetime import datetime
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import DataConfig
from vit_grid_model_tpu_torch.data.assembly import (host_stage_dtype,
                                                    sim_stack_to_model_input,
                                                    sim_stack_to_nhwc_input)
from vit_grid_model_tpu_torch.data.datasets import (
    AirSimulationReanalysisDatasetOnly)
from vit_grid_model_tpu_torch.data.pipeline import BatchLoader
from vit_grid_model_tpu_torch.data.readers import read_netcdf_var
from vit_grid_model_tpu_torch.data.timeutil import eval_time_list
from vit_grid_model_tpu_torch.evaluation import logwriter
from vit_grid_model_tpu_torch.evaluation.metrics import EvaluationMetrics
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.parallel.mesh import gather_rows, shard_rows
from vit_grid_model_tpu_torch.utils.hbm import oom_guard
from vit_grid_model_tpu_torch.utils.profiling import annotate


def resolve_device(device) -> torch.device:
    """The device an inference entry point runs on: CUDA unless the caller
    asks for the CPU; raises when CUDA is asked for and absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{device}: CUDA is not available (ask for the "
                           "CPU explicitly to run there)")
    return device


def compute_dtype_of(model: MetNet3) -> str:
    """The model's compute dtype, its parameters' dtype, by config name."""
    return ("bfloat16" if model.up.weight.dtype == torch.bfloat16
            else "float32")


def stage_input(x: np.ndarray, timestamps, compute_dtype: str, device):
    """A model input and its timestamps on ``device`` for the inference
    entry points: ``x`` cast on the host when the compute dtype is bf16
    (``host_stage_dtype``), both copied with ``non_blocking=True``.
    Returns (x, timestamps, the host tensor x was copied from).  Keep the
    last until the copy has completed (the forward's output read back):
    the pool hands it out again once no one holds it."""
    host = host_stage_dtype(x, compute_dtype)
    if isinstance(host, np.ndarray):
        host = torch.from_numpy(host)
    ts = torch.from_numpy(np.asarray(timestamps, np.float32))
    return (host.to(device, non_blocking=True),
            ts.to(device, non_blocking=True), host)


# ---------------------------------------------------------------------------
# metadata loading (the host helpers of the JAX driver)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StationInfo:
    lats: np.ndarray
    lons: np.ndarray
    korea_regions: List[str]
    korea_stn_num: int
    china_stn_num: int
    sim_coords: np.ndarray          # (korea, 2) grid indices
    cmaq_coords: np.ndarray         # (H, W, 2) lat/lon

    @property
    def total(self) -> int:
        return self.korea_stn_num + self.china_stn_num


def load_stations(data_path: str, grid_shape=(82, 67)) -> StationInfo:
    lats, lons, korea_regions = [], [], []
    korea, china = 0, 0
    with open(f"{data_path}/station_infos/korea.txt") as f:
        for line in f:
            row = line.strip().split(",")
            lats.append(float(row[2]))
            lons.append(float(row[3]))
            korea_regions.append(row[-1])
            korea += 1
    with open(f"{data_path}/station_infos/china.txt") as f:
        for line in f:
            row = line.strip().split(",")
            lats.append(float(row[2]))
            lons.append(float(row[3]))
            china += 1
    sim_coords = np.zeros((korea, 2), dtype=int)
    with open(f"{data_path}/station_infos/coords.txt") as f:
        for i, line in enumerate(f):
            row = line.strip().split(",")
            sim_coords[i] = [int(row[0]), int(row[1])]
    cmaq_coords = np.zeros(grid_shape + (2,), dtype=float)
    grid_nc = f"{data_path}/station_infos/GRID_INFO_09km.nc"
    cmaq_coords[:, :, 0] = read_netcdf_var(grid_nc, "LAT")
    cmaq_coords[:, :, 1] = read_netcdf_var(grid_nc, "LON")
    return StationInfo(np.asarray(lats), np.asarray(lons), korea_regions,
                       korea, china, sim_coords, cmaq_coords)


def load_feat_infos(data_path: str) -> Dict[str, Tuple[float, float]]:
    out = {}
    with open(f"{data_path}/feat_infos.txt") as f:
        for line in f.readlines():
            name, mean, std = line.strip().split(",")
            if name == "feature":
                continue
            out[name] = (float(mean), float(std))
    return out


def load_ground_obs(data_path: str, times, total_stn: int, feat_dim: int,
                    num_threads: int = 8):
    """Hourly station obs -> (T, stations, feat_dim) + mask, read by a
    thread pool and written by index."""
    feat = np.zeros((len(times), total_stn, feat_dim), dtype=np.float32)
    mask = np.zeros((len(times), total_stn), dtype=np.float32)

    def one(i_t):
        i, t = i_t
        arr = np.load(f"{data_path}/ground_obs/{t.year}/{t.month}/"
                      + t.strftime("%d%H") + ".npy")
        feat[i] = arr[:, :feat_dim]
        mask[i] = arr[:, -1]

    with ThreadPoolExecutor(max_workers=num_threads) as pool:
        list(pool.map(one, enumerate(times)))
    return feat, mask


def extract_baselines(simulation: np.ndarray, data_cfg: DataConfig,
                      cells: int):
    """(sim_21h, sim_avg) value series from the stacked CMAQ tensor: channel
    22 (21h-cycle PM2.5) and the mean of the four cycle PM2.5 channels per
    output hour."""
    B = simulation.shape[0]
    L = data_cfg.output_dim
    bc = data_cfg.block_channels
    sim_21h = np.zeros((B, L, cells), dtype=np.float32)
    sim_avg = np.zeros((B, L, cells), dtype=np.float32)
    pm_idx = [4, 10, 16, 22]
    for i in range(L):
        blk = simulation[:, :, :, (i + data_cfg.input_dim) * bc:
                         (i + data_cfg.input_dim + 1) * bc]
        sim_21h[:, i] = blk[:, :, :, 22].reshape(B, cells)
        sim_avg[:, i] = blk[:, :, :, pm_idx].mean(axis=3).reshape(B, cells)
    return sim_21h, sim_avg


# ---------------------------------------------------------------------------
# the eval loop
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BatchTiming:
    """Per-batch sample counts and host-clock seconds, for rate reports.

    ``seconds`` runs from the top of one batch's loop step to the next, so
    the sum covers the whole loop.  ``phases`` splits each step into
    ``launch`` (queueing the forward), ``load`` (waiting for the loader's
    next batch), ``stage`` (host staging and host->device copy of the next
    batch), ``readback`` (waiting for the forward and copying the
    predictions back) and ``metrics`` (the metric update); each phase is
    also the span ``eval.<phase>`` (``utils/profiling.py::annotate``),
    taken at the same marks."""
    samples: List[int] = dataclasses.field(default_factory=list)
    seconds: List[float] = dataclasses.field(default_factory=list)
    phases: Dict[str, List[float]] = dataclasses.field(
        default_factory=lambda: {k: [] for k in (
            "launch", "load", "stage", "readback", "metrics")})


@contextlib.contextmanager
def _phase(name: str, marks: Dict[str, Tuple[float, float]]):
    """One phase of an eval-loop step: the span ``eval.<name>``, and the
    host clock at its start and end, taken inside it, in ``marks[name]``,
    which ``BatchTiming`` reads."""
    with annotate(f"eval.{name}"):
        start = time.perf_counter()
        try:
            yield
        finally:
            marks[name] = (start, time.perf_counter())


def evaluate(model: MetNet3, data_cfg: DataConfig, *,
             model_name: str = "model",
             test_start: datetime = datetime(2023, 1, 1, 0),
             test_end: datetime = datetime(2023, 3, 31, 23),
             batch_size: int = 25, num_workers: int = 4,
             log_dir: str = "logs", args_repr: str = "",
             progress: bool = True, max_batches: Optional[int] = None,
             timing: Optional[BatchTiming] = None,
             collect_valid_times: bool = False,
             group=None) -> Optional[EvaluationMetrics]:
    """Run the evaluation with ``model`` (on its device, in its dtype);
    returns the metric accumulator and appends the reference-format log.
    ``timing``, when given, receives each batch's sample count, loop
    seconds and their split by phase.  With a process ``group``, every rank
    calls it with the same arguments; rank 0 returns the metrics and writes
    the log, the other ranks return None.

    ``collect_valid_times``: reference quirk #19, the encoded sample times
    whose last input hour is 6 (``evaluation_vit.py:285-289``) collected
    into ``metrics.valid_times``; dead bookkeeping in the reference (it
    feeds only a commented-out save path), kept behind this flag."""
    model_cfg = model.cfg
    device = model.up.weight.device
    grid = data_cfg.grid
    cells = grid.cells

    feat_infos = load_feat_infos(data_cfg.data_path)
    stations = load_stations(data_cfg.data_path, (grid.height, grid.width))
    times = eval_time_list(test_start, test_end, data_cfg.prev_len,
                           data_cfg.output_dim)
    feats, masks = load_ground_obs(data_cfg.data_path, times, stations.total,
                                   data_cfg.feat_dim)
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

    metrics = EvaluationMetrics(data_cfg.output_dim)
    L = data_cfg.output_dim
    primary = distributed.is_primary(group)
    world = distributed.world_size(group)

    def stage(batch):
        """Host assembly and host->device copy of this rank's rows of one
        batch, in f32, and the batch's timestamps; the model casts to its
        dtype on the device.  A ragged final batch keeps its true size, on
        rank 0 alone: padding it would change real predictions through the
        batch-mixing time conditioning (reference quirk #11), and at its
        true size it equals the single-process run.  ``x`` is None on a
        rank that skips the batch."""
        simulation, raw_times = batch[0], batch[4]
        ragged = simulation.shape[0] % world != 0
        if ragged and not primary:
            return batch, None, None, ragged
        if not ragged:
            simulation = shard_rows(simulation, group)
        if model_cfg.nhwc_input:
            x = sim_stack_to_nhwc_input(simulation, data_cfg.total_steps,
                                        model_cfg.pad_multiple, np.float32)
        else:
            x = sim_stack_to_model_input(simulation, data_cfg.total_steps,
                                         out_dtype=np.float32)
        x = torch.from_numpy(x).to(device)
        ts = torch.from_numpy(np.asarray(raw_times, dtype=np.float32))
        return batch, x, ts.to(device), ragged

    it = iter(loader)
    if max_batches is not None:
        it = itertools.islice(it, max_batches)
    nxt = next(it, None)
    staged = stage(nxt) if nxt is not None else None
    t0 = time.perf_counter()
    bi = -1
    with torch.inference_mode():
        while staged is not None:
            bi += 1
            tb = time.perf_counter()
            batch, x, ts, ragged = staged
            simulation, curr_re, reanalysis, re_cls = batch[:4]
            B = simulation.shape[0]
            marks = {}
            with oom_guard("MetNet3 evaluation forward", batch_size, device):
                # queued on the device; a ragged batch without the group,
                # on rank 0 alone
                with _phase("launch", marks):
                    if not ragged:
                        preds_dev = model(x, ts, group=group)
                    elif primary:
                        preds_dev = model(x, ts)
                with _phase("load", marks):
                    nxt = next(it, None)             # stage k+1 meanwhile
                with _phase("stage", marks):
                    staged = stage(nxt) if nxt is not None else None
                with _phase("readback", marks):
                    if not ragged:
                        preds_dev = gather_rows(preds_dev, group)
                    if primary:
                        preds = preds_dev.cpu().numpy().reshape(B, L, cells)
            if not primary:
                continue
            with _phase("metrics", marks):
                preds = np.maximum(preds, 0.0)
                if np.isnan(preds).any():
                    raise FloatingPointError(
                        f"NaN in model output at batch {bi}")

                persist = np.repeat(curr_re.reshape(B, 1, cells), L, axis=1)
                sim_21h, sim_avg = extract_baselines(simulation, data_cfg,
                                                     cells)
                metrics.update(
                    model=preds, persist=persist, sim_21h=sim_21h,
                    sim_avg=sim_avg, truth=reanalysis.reshape(B, L, cells),
                    truth_cls=re_cls.reshape(B, L, cells))
                if collect_valid_times:
                    # samples whose LAST input hour is 06, encoded
                    # YYYYMMDDHH
                    last_in = np.asarray(batch[4])[:, data_cfg.input_dim - 1]
                    sel = last_in[last_in[:, 3] == 6.0].astype(np.int64)
                    metrics.valid_times.append(
                        sel[:, 0] * 1000000 + sel[:, 1] * 10000
                        + sel[:, 2] * 100 + sel[:, 3])
            if timing is not None:
                timing.samples.append(B)
                timing.seconds.append(marks["metrics"][1] - tb)
                for name, (a, b) in marks.items():
                    timing.phases[name].append(b - a)
            if progress and bi % 10 == 0:
                done = metrics.step_cnt * batch_size
                rate = done / max(time.perf_counter() - t0, 1e-9)
                print(f"eval batch {bi} ({done} samples, {rate:.1f} "
                      f"samples/s cum)", flush=True)

    if not primary:
        return None
    with logwriter.open_log(model_name, log_dir) as f:
        logwriter.write_log(f, metrics, args_repr)
    return metrics
