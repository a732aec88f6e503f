"""Host-side file readers with the reference's fault semantics and an LRU
cache.

The port's own copy of ``vit_grid_model_tpu/data/readers.py``.  A missing
or malformed CMAQ ``.npy`` becomes a zero grid (``dataset.py:784-789``),
and a hook can drop chosen files deterministically, for tests.
Consecutive samples share almost all of their files, so a process-level
LRU keyed by path keeps repeated reads off the filesystem.  Reads happen
on host threads.
"""

from __future__ import annotations

import os
import threading
from collections import OrderedDict
from datetime import datetime
from typing import Callable, Optional, Tuple

import numpy as np

from vit_grid_model_tpu_torch.data.timeutil import reanalysis_file_name

# deterministic fault injection for tests: path -> bool (True = drop)
_fault_hook: Optional[Callable[[str], bool]] = None


def set_fault_injection(hook: Optional[Callable[[str], bool]]) -> None:
    """Drop every CMAQ file for which ``hook(path)`` is true, as if it were
    missing (``None`` turns it off).  Only the numpy reader
    (``load_cmaq_npy``) consults it, and only for files not yet cached."""
    global _fault_hook
    _fault_hook = hook


class _LRU:
    def __init__(self, capacity: int):
        self.capacity = capacity
        self._d: OrderedDict = OrderedDict()
        self._lock = threading.Lock()

    def get(self, key):
        with self._lock:
            if key in self._d:
                self._d.move_to_end(key)
                return self._d[key]
        return None

    def put(self, key, value):
        with self._lock:
            self._d[key] = value
            self._d.move_to_end(key)
            while len(self._d) > self.capacity:
                self._d.popitem(last=False)

    def clear(self):
        with self._lock:
            self._d.clear()


# ~200 cycle files (6 species x 82 x 67 f32 ~ 132KB each) + ~40 reanalysis
# days (24 x 82 x 67 ~ 527KB) stay far under 1GB.
_cmaq_cache = _LRU(4096)
_nc_cache = _LRU(256)


def clear_caches() -> None:
    _cmaq_cache.clear()
    _nc_cache.clear()


def load_cmaq_npy(path: str, n_species: int,
                  grid_shape: Tuple[int, int]) -> np.ndarray:
    """Load one CMAQ cycle file -> (n_species, H, W) float32; zero grid on
    missing/malformed (``dataset.py:784-789``).  Cached raw (un-standardized)."""
    cached = _cmaq_cache.get(path)
    if cached is not None:
        return cached
    arr = None
    if (_fault_hook is None or not _fault_hook(path)) and os.path.exists(path):
        try:
            arr = np.load(path)
        except (OSError, ValueError):
            arr = None
    if arr is None or arr.ndim != 3:
        arr = np.zeros((n_species,) + tuple(grid_shape), dtype=np.float32)
    else:
        arr = np.ascontiguousarray(arr, dtype=np.float32)
    _cmaq_cache.put(path, arr)
    return arr


def read_netcdf_var(path: str, var: str) -> np.ndarray:
    """NetCDF reader with engine fallbacks: xarray -> netCDF4 -> h5py
    (NetCDF4/HDF5 files) -> scipy (classic NetCDF3)."""
    try:
        import xarray as xr  # matches the reference exactly when present

        with xr.open_dataset(path) as ds:
            return np.asarray(ds[var].values)
    except ImportError:
        pass
    try:
        import netCDF4

        with netCDF4.Dataset(path) as ds:
            return np.asarray(ds.variables[var][:])
    except ImportError:
        pass
    try:
        import h5py

        with h5py.File(path, "r") as f:
            return np.asarray(f[var])
    except (ImportError, OSError):
        pass
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as f:
        return np.array(f.variables[var][:])


def load_reanalysis_day(path: str, var: str = "PM2P5") -> np.ndarray:
    """One reanalysis day's ``var`` -> (24, 1, H, W) (or (24, L, H, W));
    cached by (path, var)."""
    cached = _nc_cache.get((path, var))
    if cached is not None:
        return cached
    arr = np.asarray(read_netcdf_var(path, var), dtype=np.float32)
    _nc_cache.put((path, var), arr)
    return arr


def read_reanalysis_hour(reanalysis_data_path: str, t_utc: datetime) -> np.ndarray:
    """PM2.5 field at one UTC hour: ``PM2P5[hour, 0]`` of the day file
    (``dataset.py:740-742``)."""
    day = load_reanalysis_day(reanalysis_file_name(reanalysis_data_path, t_utc))
    return day[t_utc.hour, 0]
