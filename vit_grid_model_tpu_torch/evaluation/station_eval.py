"""Station-level evaluation: grid predictions scored at station locations.

The PyTorch counterpart of ``vit_grid_model_tpu/evaluation/station_eval.py``,
on one device or data parallel over a process group as the evaluation
driver is (``evaluation/driver.py``).  The reference ships the
``Air_Simulation_Reanalysis_Dataset_by_stn`` dataset
(``dataset.py:1833-2219``) but no driver that consumes it: run the grid
model, sample the predicted fields at the stations' grid coordinates
(``coords.txt``), and score against the ground observations with their
validity flags.
"""

from __future__ import annotations

import dataclasses
import time
from datetime import datetime
from typing import Dict, Optional

import numpy as np
import torch

from vit_grid_model_tpu_torch.core import distributed
from vit_grid_model_tpu_torch.core.config import DataConfig
from vit_grid_model_tpu_torch.data.assembly import (sim_stack_to_model_input,
                                                    sim_stack_to_nhwc_input)
from vit_grid_model_tpu_torch.data.datasets import (
    AirSimulationReanalysisDatasetByStn)
from vit_grid_model_tpu_torch.data.pipeline import BatchLoader
from vit_grid_model_tpu_torch.data.timeutil import eval_time_list
from vit_grid_model_tpu_torch.evaluation import driver as eval_driver
from vit_grid_model_tpu_torch.evaluation.metrics import (N_CLASSES,
                                                         PearsonMoments,
                                                         assign_class_eval)
from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
from vit_grid_model_tpu_torch.parallel.mesh import gather_rows, shard_rows


@dataclasses.dataclass
class StationMetrics:
    """Masked station-level accumulator (valid = observation present)."""

    def __post_init__(self):
        self.confusion = np.zeros((N_CLASSES, N_CLASSES))
        self.sq = 0.0
        self.ab = 0.0
        self.moments = PearsonMoments()

    def update(self, preds, truth, invalid_flag):
        """``invalid_flag`` is the by_stn dataset's UNINVERTED column-6 flag
        (True = observation invalid, ``dataset.py:1889``).  Truth classes
        are computed here from the values: the dataset's ``stn_cls`` feeds
        that flag straight into ``assign_class_masked`` and is therefore -1
        at exactly the VALID stations (a reference quirk, kept)."""
        m = (~invalid_flag.astype(bool)) & np.isfinite(truth)
        p, t = preds[m].astype(np.float64), truth[m].astype(np.float64)
        pc = assign_class_eval(preds)[m]
        tc = assign_class_eval(np.nan_to_num(truth))[m]
        valid = tc >= 0
        idx = pc[valid] * N_CLASSES + tc[valid]
        self.confusion += np.bincount(
            idx, minlength=N_CLASSES * N_CLASSES
        ).reshape(N_CLASSES, N_CLASSES)
        d = p - t
        self.sq += np.square(d).sum()
        self.ab += np.abs(d).sum()
        self.moments.update(p, t)

    def summary(self) -> Dict[str, float]:
        c = self.confusion
        acc = float(np.trace(c) / c.sum())
        pod = float(c[2:, 2:].sum() / max(c[:, 2:].sum(), 1e-9))
        far = float(c[2:, :2].sum() / max(c[2:, :].sum(), 1e-9))
        n = self.moments.n
        return {
            "ACC": acc, "POD": pod, "FAR": far,
            "F1": 2 * pod * (1 - far) / max(pod + (1 - far), 1e-9),
            "RMSE": float(np.sqrt(self.sq / n)),
            "MAE": float(self.ab / n),
            "R": self.moments.r(guard=1e-18),
            "n_obs": int(n),
        }


def write_station_log(f, metrics: StationMetrics,
                      args_repr: str = "") -> None:
    """Reference-style scalar metric block (the ``'{:.4f}'`` line format of
    ``evaluation_vit.py:635-692``) for the station-wise scores."""
    if args_repr:
        f.write(args_repr)
        f.write("\n")
    s = metrics.summary()
    f.write(f"station model total ACC: {s['ACC']:.4f}\n")
    f.write(f"station model total POD: {s['POD']:.4f}\n")
    f.write(f"station model total FAR: {s['FAR']:.4f}\n")
    f.write(f"station model total F1 score: {s['F1']:.4f}\n")
    f.write(f"station model MAE: {s['MAE']:.4f}\n")
    f.write(f"station model RMSE: {s['RMSE']:.4f}\n")
    f.write(f"station model R: {s['R']:.4f}\n")
    f.write(f"station model n_obs: {s['n_obs']}\n")
    f.flush()


def evaluate_by_station(model: MetNet3, data_cfg: DataConfig, *,
                        test_start: datetime, test_end: datetime,
                        batch_size: int = 8, num_workers: int = 4,
                        max_batches: Optional[int] = None, device="cuda",
                        timing: Optional[eval_driver.BatchTiming] = None,
                        group=None) -> Optional[StationMetrics]:
    """Score ``model`` at the stations over the test window.  ``model`` is
    moved to ``device`` (CUDA by default, which raises when it is absent;
    the CPU only when asked for) and computes in its parameters' dtype.  A
    ragged final batch runs at its true size.  ``timing``, when given,
    receives each batch's sample count and loop seconds.

    With a process ``group``, each rank runs its rows of every batch with
    the global timestamps and rank 0 gathers the predictions and alone
    scores them (a ragged final batch runs whole on rank 0); rank 0 returns
    the metrics, the other ranks None."""
    device = eval_driver.resolve_device(device)
    model = model.to(device).eval()
    model_cfg = model.cfg
    compute_dtype = eval_driver.compute_dtype_of(model)
    grid = data_cfg.grid
    feat_infos = eval_driver.load_feat_infos(data_cfg.data_path)
    stations = eval_driver.load_stations(data_cfg.data_path,
                                         (grid.height, grid.width))
    times = eval_time_list(test_start, test_end, data_cfg.prev_len,
                           data_cfg.output_dim)
    feats, masks = eval_driver.load_ground_obs(
        data_cfg.data_path, times, stations.total, data_cfg.feat_dim)
    dataset = AirSimulationReanalysisDatasetByStn(
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

    rows = stations.sim_coords[:, 0]
    cols = stations.sim_coords[:, 1]
    metrics = StationMetrics()
    primary = distributed.is_primary(group)
    world = distributed.world_size(group)
    t_prev = time.perf_counter()
    with torch.inference_mode():
        for bi, batch in enumerate(loader):
            if max_batches is not None and bi >= max_batches:
                break
            (_, _, sim, _, _, _, raw_times, _, stn_vals, stn_mask,
             stn_cls) = batch
            # a ragged batch runs whole on rank 0 at its true size: padding
            # it would change real predictions through the batch-mixing
            # time conditioning (reference quirk #11)
            ragged = sim.shape[0] % world != 0
            if ragged and not primary:
                continue
            mine = sim if ragged else shard_rows(sim, group)
            if model_cfg.nhwc_input:
                # host-prepared device layout (see evaluation/driver.py)
                x = sim_stack_to_nhwc_input(mine, data_cfg.total_steps,
                                            model_cfg.pad_multiple,
                                            np.float32)
            else:
                x = sim_stack_to_model_input(mine, data_cfg.total_steps)
            xd, td, _host = eval_driver.stage_input(x, raw_times,
                                                    compute_dtype, device)
            if ragged:
                preds = model(xd, td)
            else:
                preds = gather_rows(model(xd, td, group=group), group)
            if not primary:
                continue
            preds = np.maximum(preds.cpu().numpy(), 0.0)  # evaluation_vit:254
            del stn_cls   # -1 at valid stations (see StationMetrics.update)
            stn_preds = preds[:, :, rows, cols]          # (B, L, korea)
            metrics.update(stn_preds, stn_vals, invalid_flag=stn_mask)
            now = time.perf_counter()
            if timing is not None:
                timing.samples.append(sim.shape[0])
                timing.seconds.append(now - t_prev)
            t_prev = now
    return metrics if primary else None
