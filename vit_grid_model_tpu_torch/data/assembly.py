"""CMAQ sample assembly: the numpy core of the port's datasets.

The port's own copy of ``vit_grid_model_tpu/data/assembly.py``.  It
reproduces the reference's per-sample tensor contract
(``dataset.py:1102-1416``):

* per timestep, a 28-channel block: 6 species x 4 init cycles (03/09/15/21
  UTC order) + 4 lead-time scalar planes;
* species order CO, NO2, O3, PM10, PM2.5, SO2; all but PM2.5 standardized
  with the global ``feat_infos`` stats (PM2.5 stays raw for the model's
  in-forward standardization);
* the stack is channels-last ``(H, W, T * 28)``;
* ``prev_pm25``: per historical hour, the mean of the four cycles' raw
  PM2.5 planes.
"""

from __future__ import annotations

from datetime import datetime, timedelta
from typing import Dict, Sequence, Tuple

import numpy as np
import torch

from vit_grid_model_tpu_torch.data import native, readers
from vit_grid_model_tpu_torch.data.bufferpool import POOL
from vit_grid_model_tpu_torch.data.timeutil import (cmaq_file_name, cycle_refs,
                                                    kst_to_utc)

SPECIES = native.SPECIES
PM25_SPECIES_INDEX = native.PM25_SPECIES_INDEX
# species standardized at load; PM2.5 (index 4) stays raw
_STANDARDIZED = (0, 1, 2, 3, 5)


def cycle_block(t_kst: datetime, sim_data_path: str,
                feat_infos: Dict[str, Tuple[float, float]], n_species: int,
                grid_shape: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Assemble one timestep's 28-channel block.

    Returns (block (H, W, 4*S+4), pm25_cycles (4, H, W) raw, leads (4,)).
    """
    t_utc = kst_to_utc(t_kst)
    refs = cycle_refs(t_utc)
    h, w = grid_shape
    s = n_species
    block = np.zeros((h, w, 4 * s + 4), dtype=np.float32)
    pm25 = np.zeros((4, h, w), dtype=np.float32)
    leads = np.zeros((4,), dtype=np.float32)
    for ci, ref in enumerate(refs):
        raw = readers.load_cmaq_npy(cmaq_file_name(sim_data_path, ref),
                                    s, grid_shape)
        data = raw.copy()
        for sp in _STANDARDIZED:
            mean, std = feat_infos[SPECIES[sp]]
            data[sp] = (data[sp] - mean) / std
        pm25[ci] = raw[PM25_SPECIES_INDEX]
        block[:, :, ci * s:(ci + 1) * s] = np.moveaxis(data, 0, -1)
        leads[ci] = ref.lead
    block[:, :, 4 * s:] = leads
    return block, pm25, leads


def assemble_simulation(times: Sequence[datetime], mod_idx: int, idx: int, *,
                        input_dim: int, output_dim: int, prev_len: int,
                        sim_data_path: str,
                        feat_infos: Dict[str, Tuple[float, float]],
                        n_species: int, grid_shape: Tuple[int, int]
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Build the full (H, W, (input+output) * (4S+4)) stack plus the
    ``(prev_len, H, W)`` cycle-mean PM2.5 history: history hours
    (``prev_len - input_dim`` of them) contribute only to ``prev_pm25``;
    input and output hours fill the stack too."""
    h, w = grid_shape
    s = n_species
    bc = 4 * s + 4
    total = input_dim + output_dim
    sim = np.zeros((h, w, total * bc), dtype=np.float32)
    prev_pm25 = np.zeros((prev_len, h, w), dtype=np.float32)

    for t_idx in range(prev_len - input_dim):
        _, pm25, _ = cycle_block(times[idx + t_idx], sim_data_path,
                                 feat_infos, s, grid_shape)
        prev_pm25[t_idx] = pm25.mean(axis=0)

    for t_idx in range(input_dim):
        t = times[mod_idx - input_dim + 1 + t_idx]
        block, pm25, _ = cycle_block(t, sim_data_path, feat_infos, s,
                                     grid_shape)
        sim[:, :, t_idx * bc:(t_idx + 1) * bc] = block
        prev_pm25[t_idx + (prev_len - input_dim)] = pm25.mean(axis=0)

    for t_idx in range(output_dim):
        t = times[mod_idx + t_idx + 1]
        block, _, _ = cycle_block(t, sim_data_path, feat_infos, s, grid_shape)
        off = (t_idx + input_dim) * bc
        sim[:, :, off:off + bc] = block

    return sim, prev_pm25


def assemble_output_only_simulation(times: Sequence[datetime], mod_idx: int, *,
                                    input_dim: int, output_dim: int,
                                    sim_data_path: str,
                                    feat_infos: Dict[str, Tuple[float, float]],
                                    n_species: int,
                                    grid_shape: Tuple[int, int]) -> np.ndarray:
    """The v2 dataset's output-window-only stack ``(H, W, output*(4S+4))``
    (``dataset.py:548-656``)."""
    h, w = grid_shape
    s = n_species
    bc = 4 * s + 4
    sim = np.zeros((h, w, output_dim * bc), dtype=np.float32)
    for t_idx in range(output_dim):
        t = times[mod_idx + t_idx + 1]
        block, _, _ = cycle_block(t, sim_data_path, feat_infos, s, grid_shape)
        sim[:, :, t_idx * bc:(t_idx + 1) * bc] = block
    return sim


def read_reanalysis_window(times: Sequence[datetime], mod_idx: int, *,
                           output_dim: int, reanalysis_data_path: str,
                           grid_shape: Tuple[int, int]
                           ) -> Tuple[np.ndarray, np.ndarray]:
    """(curr_reanalysis (H, W), reanalysis (output_dim, H, W)) at the KST
    sample time and the following ``output_dim`` hours."""
    curr = readers.read_reanalysis_hour(reanalysis_data_path,
                                        kst_to_utc(times[mod_idx]))
    out = np.zeros((output_dim,) + tuple(grid_shape), dtype=np.float32)
    for t_idx in range(output_dim):
        t_utc = kst_to_utc(times[mod_idx]) + timedelta(hours=t_idx + 1)
        out[t_idx] = readers.read_reanalysis_hour(reanalysis_data_path, t_utc)
    return np.asarray(curr, dtype=np.float32), out


def sim_stack_to_model_input(simulation: np.ndarray, total_steps: int,
                             out_dtype=np.float32) -> np.ndarray:
    """The eval loop's reshape contract (``evaluation_vit.py:248-249``):
    (B, H, W, T*(4S+4)) channels-last stack -> (B, T, 4S, H, W) with the
    4 lead-time channels sliced off.  The output comes from the buffer pool
    and is filled by the native gather when it applies (the numpy path is
    byte-identical)."""
    b, h, w, ch = simulation.shape
    bc = ch // total_steps
    out = POOL.get((b, total_steps, bc - 4, h, w), out_dtype)
    if not native.repack_model_input_native(simulation, total_steps, out):
        x = simulation.reshape(b, h, w, total_steps, -1
                               ).transpose(0, 3, 4, 1, 2)[:, :, :-4]
        np.copyto(out, x, casting="same_kind")
    return out


def sim_stack_to_nhwc_input(simulation: np.ndarray, total_steps: int,
                            pad_multiple: int = 14,
                            out_dtype=np.float32) -> np.ndarray:
    """(B, H, W, T*(4S+4)) channels-last stack -> the model's
    ``nhwc_input`` contract: (B, Hp, Wp, T*4S), the 4 lead channels
    dropped per step, H/W zero-padded to ``pad_multiple`` (centered, the
    split of ``models.metnet3.pad_values``), cast to ``out_dtype``.  A
    strided channel-subset copy, native when it applies (``vg_repack_nhwc``;
    the numpy path is byte-identical)."""
    b, h, w, ch = simulation.shape
    bc = ch // total_steps
    nc = bc - 4
    pad_h = (pad_multiple - h) % pad_multiple
    pad_w = (pad_multiple - w) % pad_multiple
    left, top = pad_w // 2, pad_h // 2
    hp, wp = h + pad_h, w + pad_w
    out = POOL.get((b, hp, wp, total_steps * nc), out_dtype)
    if not native.repack_nhwc_native(simulation, total_steps,
                                     (left, top, hp, wp), out):
        out[:] = 0
        x = simulation.reshape(b, h, w, total_steps, bc)[..., :nc]
        out[:, top:top + h, left:left + w] = x.reshape(b, h, w, -1)
    return out


def model_input_to_nhwc(x: np.ndarray, pad_multiple: int = 14
                        ) -> np.ndarray:
    """(B, T, C, H, W) model input -> the model's ``nhwc_input`` layout
    (B, Hp, Wp, T*C) in f32, zero-padded centered like
    ``sim_stack_to_nhwc_input`` (the split of ``models.metnet3.pad_values``),
    from the pool.

    Generic over C, so it stages the station-image variant's 25-channel
    input (station-image channel 24, ``metnet3.py:701``), which
    ``sim_stack_to_nhwc_input``, staging straight from the channels-last
    CMAQ stack, cannot carry.  It pays a host transpose, since the source
    is channel-major.  For bf16, pass its f32 output to
    ``host_stage_dtype``."""
    b, t, c, h, w = x.shape
    pad_h = (pad_multiple - h) % pad_multiple
    pad_w = (pad_multiple - w) % pad_multiple
    left, top = pad_w // 2, pad_h // 2
    hp, wp = h + pad_h, w + pad_w
    out = POOL.get((b, hp, wp, t * c), np.float32)
    out[:] = 0
    out[:, top:top + h, left:left + w] = (
        x.reshape(b, t * c, h, w).transpose(0, 2, 3, 1))
    return out


def host_stage_dtype(x: np.ndarray, compute_dtype: str):
    """A model input in the compute dtype on the HOST when that is bf16:
    a torch bf16 tensor from the pool (page-locked when a card is present,
    so that a ``non_blocking`` copy to it is asynchronous), filled by a
    round-to-nearest-even cast whose bits are those of the JAX package's
    ``ml_dtypes`` cast.  Half-size buffers halve the host->device copy.  In
    f32, ``x`` itself.  Keep the returned tensor until its copy to the
    device has completed: the pool hands it out again once no one holds
    it (``data/bufferpool.py``)."""
    if compute_dtype == "bfloat16":
        out = POOL.get_tensor(x.shape, torch.bfloat16,
                              pin_memory=torch.cuda.is_available())
        out.copy_(torch.from_numpy(np.ascontiguousarray(x)))
        return out
    return x


RANGE_4CLASS = ((-1.0, 15.0), (15.0, 35.0), (35.0, 75.0), (75.0, np.inf))
CLASS_FOUR = (0, 1, 2, 3)


def assign_class(arr: np.ndarray, default: int = -1) -> np.ndarray:
    """PM2.5 -> {0,1,2,3} class by the (15, 35, 75] thresholds.  The dataset
    default for out-of-range (NaN) is -1 (``dataset.py:8-9``); the eval
    CLI's local copy defaults to 0 (``evaluation_vit.py:31-32``)."""
    conds = [np.logical_and(arr > lo, arr <= hi) for lo, hi in RANGE_4CLASS]
    return np.select(conds, CLASS_FOUR, default=default)


def assign_class_masked(arr: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """``assign_class2``: invalid entries forced to -1
    (``dataset.py:11-14``)."""
    cls = assign_class(arr)
    cls[~mask] = -1
    return cls
