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
            [ptr] * 15 + [i32] * 9 + [i32, i32, f32, ptr])
        lib.vgm_window_attention_wgrad.argtypes = [ptr] * 6 + [i32] * 4 + [
            ptr]
        lib.vgm_dropout_keep_mask.argtypes = [ptr] + [i32] * 5 + [f32, ptr]
        lib.vgm_fused_mbconv.argtypes = [ptr] * 16 + [i32] * 8 + [ptr]
        lib.vgm_perhead_attention.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
        lib.vgm_maxvit_layer_attention.argtypes = ([ptr] * 18 + [i32] * 10
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
                   lib.vgm_window_attention_wgrad, lib.vgm_dropout_keep_mask,
                   lib.vgm_fused_mbconv,
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
        lib.vgm_perhead_attention_wgmma.argtypes = ([ptr] * 4 + [i32] * 6
                                                    + [ptr])
        lib.vgm_perhead_attention_wgmma.restype = ctypes.c_int
        lib.vgm_perhead_attention_route.argtypes = [i32] * 4
        lib.vgm_perhead_attention_route.restype = ctypes.c_int
        lib.vgm_perhead_attention_occupancy.argtypes = [i32] * 4 + [ptr]
        lib.vgm_perhead_attention_occupancy.restype = ctypes.c_int
        for prefix in ("vgm_headmajor_attention",
                       "vgm_crosshead_norm_attention"):
            wgmma = getattr(lib, prefix + "_wgmma")
            wgmma.argtypes = [ptr] * 4 + [i32] * 7 + [ptr]
            route = getattr(lib, prefix + "_route")
            route.argtypes = [i32] * 5
            occupancy = getattr(lib, prefix + "_occupancy")
            occupancy.argtypes = [i32] * 5 + [ptr]
            for fn in (wgmma, route, occupancy):
                fn.restype = ctypes.c_int
        for fn in (lib.vgm_headmajor_attention_smem_bytes,
                   lib.vgm_stacked_softmax_attention_smem_bytes,
                   lib.vgm_crosshead_norm_attention_smem_bytes):
            fn.argtypes = [i32] * 4
            fn.restype = ctypes.c_long
        lib.vgm_outproj_attention_smem_bytes.argtypes = [i32] * 6
        lib.vgm_outproj_attention_smem_bytes.restype = ctypes.c_long
        lib.vgm_outproj_attention_route.argtypes = [i32] * 5
        lib.vgm_outproj_attention_route.restype = ctypes.c_int
        lib.vgm_outproj_attention_occupancy.argtypes = [i32] * 9 + [ptr]
        lib.vgm_outproj_attention_occupancy.restype = ctypes.c_int
        lib.vgm_headpack_attention_smem_bytes.argtypes = [i32] * 7
        lib.vgm_headpack_attention_smem_bytes.restype = ctypes.c_long
        lib.vgm_headpack_attention_route.argtypes = [i32] * 5
        lib.vgm_headpack_attention_occupancy.argtypes = [i32] * 8 + [ptr]
        lib.vgm_stacked_softmax_attention_route.argtypes = [i32] * 4
        lib.vgm_stacked_softmax_attention_occupancy.argtypes = ([i32] * 5
                                                                + [ptr])
        for fn in (lib.vgm_headpack_attention_route,
                   lib.vgm_headpack_attention_occupancy,
                   lib.vgm_stacked_softmax_attention_route,
                   lib.vgm_stacked_softmax_attention_occupancy):
            fn.restype = ctypes.c_int
        lib.vgm_staged_attention_core_route.argtypes = [i32] * 3
        lib.vgm_staged_attention_core_occupancy.argtypes = [i32, ptr]
        lib.vgm_dropout_keep_mask_route.argtypes = []
        lib.vgm_window_attention_fwd_route.argtypes = [i32] * 3
        for fn in (lib.vgm_staged_attention_core_route,
                   lib.vgm_staged_attention_core_occupancy,
                   lib.vgm_dropout_keep_mask_route,
                   lib.vgm_window_attention_fwd_route):
            fn.restype = ctypes.c_int
        lib.vgm_maxvit_layer_attention_cluster.argtypes = [i32] * 8
        lib.vgm_maxvit_layer_attention_cluster.restype = ctypes.c_int
        lib.vgm_maxvit_layer_attention_occupancy.argtypes = [i32] * 9
        lib.vgm_maxvit_layer_attention_occupancy.restype = ctypes.c_int
        lib.vgm_maxvit_layer_attention_scratch_floats.argtypes = [i32] * 6
        lib.vgm_maxvit_layer_attention_scratch_floats.restype = ctypes.c_long
        lib.vgm_window_attention_bwd_grad_floats.argtypes = [i32] * 4
        lib.vgm_window_attention_bwd_slot_floats.argtypes = [i32] * 5
        lib.vgm_window_attention_bwd_scratch_elems.argtypes = [i32] * 6
        lib.vgm_window_attention_wgrad_partial_floats.argtypes = [i32] * 4
        for fn in (lib.vgm_window_attention_bwd_grad_floats,
                   lib.vgm_window_attention_bwd_slot_floats,
                   lib.vgm_window_attention_bwd_scratch_elems,
                   lib.vgm_window_attention_wgrad_partial_floats):
            fn.restype = ctypes.c_long
        lib.vgm_window_attention_bwd_smem_bytes.argtypes = [i32] * 3
        lib.vgm_window_attention_bwd_smem_bytes.restype = ctypes.c_long
        lib.vgm_chan_norm_act.argtypes = [ptr] * 7 + [i32] * 9 + [f32, ptr]
        lib.vgm_chan_norm_act.restype = ctypes.c_int
        lib.vgm_joint_attention.argtypes = [ptr] * 3 + [i32] * 3 + [ptr]
        lib.vgm_joint_attention.restype = ctypes.c_int
        lib.vgm_fused_mbconv_row_tile.argtypes = [i32] * 3
        lib.vgm_fused_mbconv_route.argtypes = [i32] * 7
        lib.vgm_fused_mbconv_packed_elems.argtypes = [i32] * 2
        lib.vgm_fused_mbconv_pack.argtypes = [ptr] * 4 + [i32] * 2 + [ptr]
        for fn in (lib.vgm_fused_mbconv_row_tile, lib.vgm_fused_mbconv_route,
                   lib.vgm_fused_mbconv_packed_elems,
                   lib.vgm_fused_mbconv_pack):
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def stream(t: Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
