"""ctypes bindings for the native (C++) CMAQ data plane.

The port's own copy of ``vit_grid_model_tpu/data/native.py``.
``csrc/cmaq_loader.cc`` fuses the per-sample ``.npy`` reads, per-species
standardization and channel interleave into one GIL-free threaded pass.
The library is compiled at first use with ``g++`` into
``build/native/libcmaq_loader.so`` at the root of the checkout.  When it
cannot be built or loaded, every caller takes the numpy path in
``data/assembly.py``, whose outputs are byte-identical
(``tests/test_torch_port_host.py``).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from datetime import datetime
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from vit_grid_model_tpu_torch.data.bufferpool import POOL
from vit_grid_model_tpu_torch.data.timeutil import (cmaq_file_name, cycle_refs,
                                                    kst_to_utc)

# the species order of a CMAQ cycle file and the one left raw at load
SPECIES = ("CO", "NO2", "O3", "PM10", "PM2.5", "SO2")
PM25_SPECIES_INDEX = 4

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "cmaq_loader.cc"
LIBRARY = _PKG.parent / "build" / "native" / "libcmaq_loader.so"
ABI_VERSION = 5

#: native read/assemble pool width: 4 overlaps file I/O even on small hosts
THREADS = 4

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def build() -> None:
    """Compile the loader with the flags of ``native/build.sh``, into a
    temporary file renamed into place (a process may have the old library
    mapped).  Raises ``subprocess.CalledProcessError`` on a failed
    build."""
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-pthread",
                    "-std=c++17", "-o", str(tmp), str(SOURCE)],
                   check=True, capture_output=True, timeout=300)
    os.replace(tmp, LIBRARY)


def _open() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(LIBRARY))
    lib.vg_abi_version.restype = ctypes.c_int
    if lib.vg_abi_version() != ABI_VERSION:
        raise OSError(f"{LIBRARY}: ABI {lib.vg_abi_version()}, "
                      f"expected {ABI_VERSION}")
    lib.vg_assemble_sample.restype = ctypes.c_int64
    lib.vg_assemble_batch.restype = ctypes.c_int64
    lib.vg_repack_model_input.restype = None
    lib.vg_repack_nhwc.restype = None
    i64 = ctypes.c_int64
    lib.vg_load_cycle_files.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), i64, i64, i64, i64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.vg_load_cycle_files.restype = i64
    lib.vg_unsupported_count.argtypes = []
    lib.vg_unsupported_count.restype = i64
    lib.vg_reset_unsupported_count.argtypes = []
    lib.vg_reset_unsupported_count.restype = None
    return lib


def _load_library() -> Optional[ctypes.CDLL]:
    """The loader, built when missing or older than its source; None when
    it cannot be built (no compiler) or loaded."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            if (not LIBRARY.exists() or LIBRARY.stat().st_mtime
                    < SOURCE.stat().st_mtime):
                build()
            _lib = _open()
        except (OSError, subprocess.SubprocessError):
            _lib = None
        return _lib


def available() -> bool:
    return _load_library() is not None


def unsupported_count() -> int:
    """Loud load failures so far: files ``np.load`` would have accepted but
    the native reader zero-filled (each also named on stderr).  0 after a
    clean run; 0 when the library is unavailable."""
    lib = _load_library()
    return int(lib.vg_unsupported_count()) if lib is not None else 0


def reset_unsupported_count() -> None:
    lib = _load_library()
    if lib is not None:
        lib.vg_reset_unsupported_count()


def _c_paths(paths: Sequence[str]):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [p.encode() for p in paths]
    return arr


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _step_files(times_kst: Sequence[datetime], sim_data_path: str):
    paths, leads = [], np.zeros((len(times_kst), 4), np.float32)
    for ti, t in enumerate(times_kst):
        for ci, ref in enumerate(cycle_refs(kst_to_utc(t))):
            paths.append(cmaq_file_name(sim_data_path, ref))
            leads[ti, ci] = ref.lead
    return paths, leads


def _species_stats(feat_infos: Dict[str, Tuple[float, float]],
                   n_species: int):
    means = np.asarray([feat_infos[s][0] for s in SPECIES[:n_species]],
                       np.float32)
    stds = np.asarray([feat_infos[s][1] for s in SPECIES[:n_species]],
                      np.float32)
    return means, stds


def assemble_steps_native(times_kst: Sequence[datetime], sim_data_path: str,
                          feat_infos: Dict[str, Tuple[float, float]],
                          n_species: int, grid_shape: Tuple[int, int]
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Assemble the stacked blocks for a list of KST timesteps in one native
    call.  Returns (stack (H, W, T*(4S+4)), pm25 (T, 4, H, W)) or None when
    the native library is unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    h, w = grid_shape
    t_steps = len(times_kst)
    paths, leads = _step_files(times_kst, sim_data_path)
    means, stds = _species_stats(feat_infos, n_species)
    # the native pass writes every output byte, so pooled buffers need no
    # zeroing
    out = POOL.get((h, w, t_steps * (4 * n_species + 4)))
    pm25 = POOL.get((t_steps, 4, h, w))
    lib.vg_assemble_sample(
        _c_paths(paths), ctypes.c_int64(t_steps), ctypes.c_int64(n_species),
        ctypes.c_int64(h), ctypes.c_int64(w), _f32p(means), _f32p(stds),
        ctypes.c_int64(PM25_SPECIES_INDEX), _f32p(leads), _f32p(out),
        _f32p(pm25), ctypes.c_int(THREADS))
    return out, pm25


def assemble_batch_native(times_kst: Sequence[datetime], n_samples: int,
                          hist: int, n_steps: int, sim_data_path: str,
                          feat_infos: Dict[str, Tuple[float, float]],
                          n_species: int, grid_shape: Tuple[int, int]
                          ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Assemble a consecutive batch's CMAQ tensors directly into the final
    batched layout in one native pass (``vg_assemble_batch``).

    ``times_kst`` is the UNION of the batch's step windows
    (``n_samples - 1 + n_steps`` consecutive hours); sample ``b`` keeps
    steps ``[b + hist, b + n_steps)``.  Returns
    ``(batch (B, H, W, (n_steps-hist)*(4S+4)), pm25 (U, 4, H, W))`` or None
    when the native library is unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    h, w = grid_shape
    n_union = len(times_kst)
    if n_union != n_samples - 1 + n_steps:
        raise ValueError(f"{n_union} union steps for {n_samples} samples "
                         f"of {n_steps} steps")
    paths, leads = _step_files(times_kst, sim_data_path)
    means, stds = _species_stats(feat_infos, n_species)
    bc = 4 * n_species + 4
    out = POOL.get((n_samples, h, w, (n_steps - hist) * bc))
    pm25 = POOL.get((n_union, 4, h, w))
    lib.vg_assemble_batch(
        _c_paths(paths), ctypes.c_int64(n_union),
        ctypes.c_int64(n_samples), ctypes.c_int64(hist),
        ctypes.c_int64(n_steps), ctypes.c_int64(n_species),
        ctypes.c_int64(h), ctypes.c_int64(w), _f32p(means), _f32p(stds),
        ctypes.c_int64(PM25_SPECIES_INDEX), _f32p(leads), _f32p(out),
        _f32p(pm25), ctypes.c_int(THREADS))
    return out, pm25


def _repack_layout(simulation: np.ndarray, total_steps: int,
                   out: np.ndarray) -> Optional[int]:
    """The species count when the native repack applies to these f32
    arrays, else None."""
    if (not simulation.flags.c_contiguous or not out.flags.c_contiguous
            or simulation.dtype != np.float32 or out.dtype != np.float32):
        return None
    ch = simulation.shape[-1]
    if ch % total_steps != 0:
        return None
    bc = ch // total_steps
    n_species = (bc - 4) // 4
    return n_species if bc == 4 * n_species + 4 else None


def repack_model_input_native(simulation: np.ndarray, total_steps: int,
                              out: np.ndarray) -> bool:
    """Native (B, H, W, T*(4S+4)) -> (B, T, 4S, H, W) repack straight into
    the f32 ``out``.  Returns False when the native library is unavailable
    or the layout does not apply (the caller takes the numpy path)."""
    lib = _load_library()
    n_species = _repack_layout(simulation, total_steps, out)
    if lib is None or n_species is None:
        return False
    b, h, w, _ = simulation.shape
    lib.vg_repack_model_input(
        _f32p(simulation), ctypes.c_int64(b), ctypes.c_int64(h * w),
        ctypes.c_int64(total_steps), ctypes.c_int64(n_species),
        ctypes.c_void_p(out.ctypes.data), ctypes.c_int(0),
        ctypes.c_int(THREADS))
    return True


def repack_nhwc_native(simulation: np.ndarray, total_steps: int,
                       pads: Tuple[int, int, int, int],
                       out: np.ndarray) -> bool:
    """Native (B, H, W, T*(4S+4)) -> (B, Hp, Wp, T*4S) staging for the
    model's ``nhwc_input`` contract (``vg_repack_nhwc``): lead channels
    dropped, centered zero pad, into the f32 ``out``.  ``pads`` is
    (pad_left, pad_top, hp, wp).  Returns False when the native library is
    unavailable or the layout does not apply."""
    lib = _load_library()
    n_species = _repack_layout(simulation, total_steps, out)
    if lib is None or n_species is None:
        return False
    b, h, w, _ = simulation.shape
    pad_l, pad_t, hp, wp = pads
    if out.shape != (b, hp, wp, total_steps * 4 * n_species):
        return False
    lib.vg_repack_nhwc(
        _f32p(simulation), ctypes.c_int64(b), ctypes.c_int64(h),
        ctypes.c_int64(w), ctypes.c_int64(total_steps),
        ctypes.c_int64(n_species), ctypes.c_int64(pad_l),
        ctypes.c_int64(pad_t), ctypes.c_int64(hp), ctypes.c_int64(wp),
        ctypes.c_void_p(out.ctypes.data), ctypes.c_int(0),
        ctypes.c_int(THREADS))
    return True


def load_cycle_files_native(paths: Sequence[str], n_species: int,
                            grid_shape: Tuple[int, int]
                            ) -> Optional[np.ndarray]:
    """Raw cycle files -> (N, S, H, W) f32, a file that fails to load
    zero-filled; None when the native library is unavailable."""
    lib = _load_library()
    if lib is None:
        return None
    h, w = grid_shape
    out = np.zeros((len(paths), n_species, h, w), np.float32)
    lib.vg_load_cycle_files(_c_paths(paths), len(paths), n_species, h, w,
                            _f32p(out), THREADS)
    return out
