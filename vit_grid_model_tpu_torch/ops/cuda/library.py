"""The port's CUDA kernel library: its build, its ctypes binding and the
helpers every wrapper uses.

Every ``csrc/*.cu`` source is compiled at first use with ``nvcc`` (one
process per source, all started together, then one link) into
``build/kernels/libvgm_kernels.so`` at the root of the checkout, and loaded
with ctypes.  Each entry point has a plain C interface that launches on the
stream it is given and returns ``cudaGetLastError()``.  Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch
from torch import Tensor

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
LIBRARY = _PKG.parent / "build" / "kernels" / "libvgm_kernels.so"

_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return found


def build(force: bool = False) -> float:
    """Compile ``csrc/*.cu`` into the kernel library unless it is newer than
    every source and header: one ``nvcc`` per source, all started
    together, then one link.  Returns the seconds spent (0.0 when the
    library was current)."""
    sources = sorted(CSRC.glob("*.cu"))
    deps = sources + sorted(CSRC.glob("*.cuh"))
    if (not force and LIBRARY.exists() and
            all(LIBRARY.stat().st_mtime >= s.stat().st_mtime for s in deps)):
        return 0.0
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objects = [LIBRARY.parent / f"{s.stem}.{tag}.o" for s in sources]
    compiler = nvcc()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([compiler, *_NVCC_FLAGS, "-c", "-o", str(o),
                               str(s)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(sources, objects)]
    errors = []
    for proc, src in zip(procs, sources):
        _, err = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"{src.name} ({proc.returncode}):\n{err}")
    try:
        if errors:
            raise RuntimeError("nvcc failed: " + "\n".join(errors))
        tmp = LIBRARY.with_suffix(f".{tag}")
        res = subprocess.run([compiler, "-shared", "-o", str(tmp),
                              *map(str, objects)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{res.stderr}")
        os.replace(tmp, LIBRARY)
    finally:
        for o in objects:
            if o.exists():
                o.unlink()
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The kernel library, built first when it is out of date, with the
    argument types of every entry point declared."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.vgm_window_attention_fwd.argtypes = (
            [ptr] * 9 + [i32] * 8 + [i32, i32, f32, ptr])
        lib.vgm_window_attention_bwd.argtypes = (
            [ptr] * 14 + [i32] * 9 + [i32, i32, f32, ptr])
        lib.vgm_dropout_keep_mask.argtypes = [ptr] + [i32] * 5 + [f32, ptr]
        lib.vgm_fused_mbconv.argtypes = [ptr] * 15 + [i32] * 8 + [ptr]
        lib.vgm_perhead_attention.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.vgm_maxvit_layer_attention.argtypes = ([ptr] * 17 + [i32] * 9
                                                   + [ptr])
        lib.vgm_headmajor_attention.argtypes = [ptr] * 4 + [i32] * 8 + [ptr]
        lib.vgm_stacked_softmax_attention.argtypes = ([ptr] * 4 + [i32] * 8
                                                      + [ptr])
        lib.vgm_staged_attention_core.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.vgm_crosshead_norm_attention.argtypes = ([ptr] * 4 + [i32] * 8
                                                     + [ptr])
        lib.vgm_outproj_attention.argtypes = [ptr] * 5 + [i32] * 13 + [ptr]
        lib.vgm_headpack_attention.argtypes = [ptr] * 5 + [i32] * 12 + [ptr]
        for fn in (lib.vgm_window_attention_fwd, lib.vgm_window_attention_bwd,
                   lib.vgm_dropout_keep_mask, lib.vgm_fused_mbconv,
                   lib.vgm_perhead_attention,
                   lib.vgm_maxvit_layer_attention,
                   lib.vgm_headmajor_attention,
                   lib.vgm_stacked_softmax_attention,
                   lib.vgm_staged_attention_core,
                   lib.vgm_crosshead_norm_attention,
                   lib.vgm_outproj_attention,
                   lib.vgm_headpack_attention):
            fn.restype = ctypes.c_int
        lib.vgm_perhead_attention_smem_bytes.argtypes = [i32] * 3
        lib.vgm_perhead_attention_smem_bytes.restype = ctypes.c_long
        for fn in (lib.vgm_headmajor_attention_smem_bytes,
                   lib.vgm_stacked_softmax_attention_smem_bytes,
                   lib.vgm_crosshead_norm_attention_smem_bytes):
            fn.argtypes = [i32] * 4
            fn.restype = ctypes.c_long
        lib.vgm_outproj_attention_smem_bytes.argtypes = [i32] * 6
        lib.vgm_outproj_attention_smem_bytes.restype = ctypes.c_long
        lib.vgm_headpack_attention_smem_bytes.argtypes = [i32] * 7
        lib.vgm_headpack_attention_smem_bytes.restype = ctypes.c_long
        lib.vgm_maxvit_layer_attention_cluster.argtypes = [i32] * 7
        lib.vgm_maxvit_layer_attention_cluster.restype = ctypes.c_int
        lib.vgm_maxvit_layer_attention_active_clusters.argtypes = [i32] * 7
        lib.vgm_maxvit_layer_attention_active_clusters.restype = ctypes.c_int
        lib.vgm_window_attention_bwd_slot_floats.argtypes = [i32] * 4
        lib.vgm_window_attention_bwd_slot_floats.restype = ctypes.c_long
        lib.vgm_window_attention_bwd_smem_bytes.argtypes = [i32] * 3
        lib.vgm_window_attention_bwd_smem_bytes.restype = ctypes.c_long
        lib.vgm_fused_mbconv_row_tile.argtypes = [i32] * 3
        lib.vgm_fused_mbconv_row_tile.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
