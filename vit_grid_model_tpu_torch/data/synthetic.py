"""Synthetic CMAQ-shaped data trees.

The port's own copy of ``vit_grid_model_tpu/data/synthetic.py``; for the
same window it writes byte-identical files
(``tests/test_torch_port_host.py``).  It writes a deterministic fake data
tree with the reference's on-disk layouts, so the CLIs run end to end with
no external data:

* CMAQ cycle files   ``{sim}/{year}/{mmdd}{cycle:02d}_{lead:02d}.npy``
* reanalysis days    ``{re}/{year}/ACONC.PM_RQ40i8a.KNU_09_01.{Ymd}.nc``
  (classic NetCDF3 via scipy)
* ground obs         ``{data}/ground_obs/{Y}/{M}/{ddHH}.npy``
* station metadata   ``{data}/station_infos/{korea,china,coords}.txt`` and
  ``GRID_INFO_09km.nc``; feature stats ``{data}/feat_infos.txt``
* station images     ``{data}/{ground_obs_imgs,ground_obs_krig_imgs,
  multiair_img,multiair_krig_img}/{Y}/{M}/{ddHH}_*.npy``
  (``write_station_images``, written on request)

Fields are smooth space-time random processes seeded from the file
identity, so the same path always holds the same values and neighbouring
hours are correlated.
"""

from __future__ import annotations

import os
import zlib
from datetime import datetime, timedelta
from typing import Dict, Sequence, Tuple

import numpy as np

from vit_grid_model_tpu_torch.data.timeutil import (CycleRef, cmaq_file_name,
                                                    cycle_refs, hourly_range,
                                                    reanalysis_file_name)

GRID = (82, 67)
N_SPECIES = 6
SPECIES_SCALES = (0.5, 30.0, 40.0, 45.0, 25.0, 8.0)   # CO..SO2 magnitudes


def _rng(*key) -> np.random.Generator:
    seed = zlib.crc32("/".join(str(k) for k in key).encode())
    return np.random.default_rng(seed)


def _smooth_field(rng: np.random.Generator, shape: Tuple[int, ...],
                  scale: float) -> np.ndarray:
    """Positive, spatially smooth random field (coarse noise upsampled)."""
    coarse_shape = tuple(max(2, s // 8) for s in shape)
    out = rng.random(coarse_shape)
    for axis, target in enumerate(shape):
        reps = int(np.ceil(target / out.shape[axis]))
        out = np.repeat(out, reps, axis=axis)
        out = np.take(out, np.arange(target), axis=axis)
    return (0.25 + out) * scale


def pm25_day_field(day: datetime, hours: int = 24,
                   grid: Tuple[int, int] = GRID) -> np.ndarray:
    """(hours, H, W) 'true' PM2.5 process for one day, deterministic."""
    rng = _rng("pm25", day.strftime("%Y%m%d"))
    base = _smooth_field(rng, grid, 1.0)
    out = np.zeros((hours,) + grid, dtype=np.float32)
    for h in range(hours):
        diurnal = 1.0 + 0.35 * np.sin(2 * np.pi * (h - 7) / 24.0)
        noise = _smooth_field(_rng("pm25", day.strftime("%Y%m%d"), h),
                              grid, 0.25)
        out[h] = (base * diurnal * 24.0 + noise * 18.0).astype(np.float32)
    return out


def write_reanalysis_day(reanalysis_data_path: str, day: datetime) -> str:
    from scipy.io import netcdf_file

    path = reanalysis_file_name(reanalysis_data_path, day)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        return path
    data = pm25_day_field(day)[:, None]        # (24, 1, H, W)
    with netcdf_file(path, "w") as f:
        f.createDimension("TSTEP", 24)
        f.createDimension("LAY", 1)
        f.createDimension("ROW", GRID[0])
        f.createDimension("COL", GRID[1])
        v = f.createVariable("PM2P5", "f", ("TSTEP", "LAY", "ROW", "COL"))
        v[:] = data
    return path


def write_cmaq_cycle_file(sim_data_path: str, ref: CycleRef) -> str:
    path = cmaq_file_name(sim_data_path, ref)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if os.path.exists(path):
        return path
    valid = datetime(ref.date.year, ref.date.month, ref.date.day, ref.cycle) \
        + timedelta(hours=ref.lead)
    arr = np.zeros((N_SPECIES,) + GRID, dtype=np.float32)
    for sp in range(N_SPECIES):
        rng = _rng("cmaq", ref.date.strftime("%Y%m%d"), ref.cycle, ref.lead, sp)
        arr[sp] = _smooth_field(rng, GRID, SPECIES_SCALES[sp])
    # the PM2.5 plane tracks the 'true' reanalysis process plus cycle bias,
    # so CMAQ baselines correlate with targets like real simulation output
    truth = pm25_day_field(valid)[valid.hour]
    bias = 1.0 + 0.1 * np.sin(ref.cycle) + 0.004 * ref.lead
    arr[4] = (truth * bias + arr[4] * 0.2).astype(np.float32)
    np.save(path, arr)
    return path


def write_cmaq_range(sim_data_path: str, start_utc: datetime,
                     end_utc: datetime) -> int:
    """Write every cycle file any valid UTC hour in [start, end] can need."""
    n = 0
    for t in hourly_range(start_utc, end_utc):
        for ref in cycle_refs(t):
            write_cmaq_cycle_file(sim_data_path, ref)
            n += 1
    return n


def write_ground_obs(data_path: str, times_kst: Sequence[datetime],
                     total_stn: int, feat_dim: int = 12) -> None:
    """Hourly station observation files: (stations, feat_dim + 1); col 0
    PM2.5, col 6 invalid flag, last col station mask."""
    for t in times_kst:
        d = f"{data_path}/ground_obs/{t.year}/{t.month}"
        os.makedirs(d, exist_ok=True)
        path = f"{d}/{t.strftime('%d%H')}.npy"
        if os.path.exists(path):
            continue
        rng = _rng("obs", t.strftime("%Y%m%d%H"))
        arr = rng.random((total_stn, feat_dim + 1)).astype(np.float32)
        arr[:, 0] = 10.0 + 40.0 * arr[:, 0]            # PM2.5-ish
        arr[:, 6] = (arr[:, 6] < 0.05).astype(np.float32)  # ~5% invalid
        arr[:, -1] = 1.0
        np.save(path, arr)


def write_station_infos(data_path: str, korea_stn_num: int = 20,
                        china_stn_num: int = 5) -> None:
    d = f"{data_path}/station_infos"
    os.makedirs(d, exist_ok=True)
    regions = ["Seoul", "Busan", "Daegu", "Incheon"]
    rng = _rng("stations")
    with open(f"{d}/korea.txt", "w") as f:
        for i in range(korea_stn_num):
            lat = 33.0 + 5.0 * rng.random()
            lon = 125.0 + 4.0 * rng.random()
            f.write(f"{i},KR{i:03d},{lat:.4f},{lon:.4f},"
                    f"{regions[i % len(regions)]}\n")
    with open(f"{d}/china.txt", "w") as f:
        for i in range(china_stn_num):
            lat = 30.0 + 10.0 * rng.random()
            lon = 110.0 + 10.0 * rng.random()
            f.write(f"{i},CN{i:03d},{lat:.4f},{lon:.4f},China\n")
    with open(f"{d}/coords.txt", "w") as f:
        for i in range(korea_stn_num):
            f.write(f"{int(rng.integers(0, GRID[0]))},"
                    f"{int(rng.integers(0, GRID[1]))}\n")
    from scipy.io import netcdf_file

    path = f"{d}/GRID_INFO_09km.nc"
    if not os.path.exists(path):
        with netcdf_file(path, "w") as f:
            f.createDimension("ROW", GRID[0])
            f.createDimension("COL", GRID[1])
            lat = f.createVariable("LAT", "f", ("ROW", "COL"))
            lon = f.createVariable("LON", "f", ("ROW", "COL"))
            lat[:] = 33.0 + 5.0 * np.linspace(0, 1, GRID[0])[:, None] \
                * np.ones((1, GRID[1]))
            lon[:] = 124.0 + 6.0 * np.linspace(0, 1, GRID[1])[None, :] \
                * np.ones((GRID[0], 1))


DEFAULT_FEAT_INFOS: Dict[str, Tuple[float, float]] = {
    "CO": (0.45, 0.25), "NO2": (19.0, 13.0), "O3": (28.0, 18.0),
    "PM10": (42.0, 28.0), "PM2.5": (22.5, 15.5), "SO2": (4.1, 2.4),
}


def write_feat_infos(data_path: str) -> None:
    os.makedirs(data_path, exist_ok=True)
    with open(f"{data_path}/feat_infos.txt", "w") as f:
        f.write("feature,mean,std\n")
        for name, (mean, std) in DEFAULT_FEAT_INFOS.items():
            f.write(f"{name},{mean},{std}\n")


def generate_tree(root: str, start_kst: datetime, end_kst: datetime, *,
                  prev_len: int = 13, output_dim: int = 12,
                  korea_stn_num: int = 20, china_stn_num: int = 5,
                  feat_dim: int = 12) -> Dict[str, str]:
    """Write a complete synthetic data tree for a KST eval window.
    Returns the three path arguments of the reference CLI."""
    data_path = os.path.join(root, "preprocessed")
    sim_path = os.path.join(root, "cmaq_sim")
    re_path = os.path.join(root, "cmaq_analysis")

    times = hourly_range(start_kst - timedelta(hours=prev_len - 1),
                         end_kst + timedelta(hours=output_dim))
    write_station_infos(data_path, korea_stn_num, china_stn_num)
    write_feat_infos(data_path)
    write_ground_obs(data_path, times, korea_stn_num + china_stn_num,
                     feat_dim)
    # reanalysis + cycle files over the UTC span the windows touch
    start_utc = times[0] - timedelta(hours=9)
    end_utc = times[-1] - timedelta(hours=9)
    for t in hourly_range(start_utc.replace(hour=0), end_utc):
        if t.hour == 0:
            write_reanalysis_day(re_path, t)
    write_reanalysis_day(re_path, end_utc)
    write_cmaq_range(sim_path, start_utc, end_utc)
    return {"data_path": data_path, "sim_data_path": sim_path,
            "analysis_data_path": re_path}


def write_station_images(data_path: str, times_kst: Sequence[datetime],
                         output_dim: int = 12,
                         grid: Tuple[int, int] = GRID) -> None:
    """Kriged ground-obs and MultiAir prediction image trees read by
    ``AirSimulationReanalysisDatasetWithStationImgs``
    (``dataset.py:1591-1595,1701-1706``)."""
    for t in times_kst:
        y, m = t.strftime("%Y"), str(int(t.strftime("%m")))
        dh = t.strftime("%d%H")
        for sub, shape, suffix in (
                ("ground_obs_imgs", grid, "_img"),
                ("ground_obs_krig_imgs", (2,) + grid, "_krige_img"),
                ("multiair_img", (output_dim,) + grid, "_multiair_img"),
                ("multiair_krig_img", (output_dim, 2) + grid,
                 "_multiair_krige_img")):
            d = f"{data_path}/{sub}/{y}/{m}"
            os.makedirs(d, exist_ok=True)
            path = f"{d}/{dh}{suffix}.npy"
            if not os.path.exists(path):
                rng = _rng(sub, t.strftime("%Y%m%d%H"))
                np.save(path, (rng.random(shape) * 40).astype(np.float32))
