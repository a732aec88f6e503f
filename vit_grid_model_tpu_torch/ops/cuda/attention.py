"""Fused window-attention forward on the GPU: the wrapper of the hand-written
CUDA kernel ``csrc/window_attention_fwd.cu``, its ctypes binding and its
launch counter.

``window_attention`` takes the same arguments as the plain version
``ops.attention.attention``.  For a tensor on the CPU it runs that plain
version; for a CUDA tensor it launches the kernel or raises.  There is no
fallback from one to the other.

The kernel library is compiled at first use from the sources under
``csrc/`` with ``nvcc`` into ``build/kernels/libvgm_kernels.so`` at the
root of the checkout, and loaded with ctypes.
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

from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.attention import Attention, attention

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
LIBRARY = _PKG.parent / "build" / "kernels" / "libvgm_kernels.so"

MAX_TOKENS = 64
MAX_DIM = 256
MAX_DIM_HEAD = 64

# Kernel launches since the count was last set to 0.  Only the launch below
# adds to it.
launches = 0

_lib: Optional[ctypes.CDLL] = None


def _nvcc() -> str:
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
    every source.  Returns the seconds spent compiling (0.0 when the
    library was current)."""
    sources = sorted(CSRC.glob("*.cu"))
    if (not force and LIBRARY.exists() and
            all(LIBRARY.stat().st_mtime >= s.stat().st_mtime
                for s in sources)):
        return 0.0
    LIBRARY.parent.mkdir(parents=True, exist_ok=True)
    tmp = LIBRARY.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
           "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(tmp),
           *map(str, sources)]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed ({res.returncode}):\n{res.stderr}")
    os.replace(tmp, LIBRARY)
    return time.perf_counter() - t0


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIBRARY))
        fn = lib.vgm_window_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _film_slot(p: Attention, cond: Optional[Tensor], x: Tensor,
               windows_per_sample: int):
    """(gamma, beta, windows per row of gamma, has_film): the per-sample
    FiLM terms, or the LN affine for unconditioned layers, as f32 after
    rounding to x's dtype."""
    bw, _, dim = x.shape
    if p.film is not None and cond is not None:
        gamma, beta = p.film(cond)
        wps = windows_per_sample
    elif p.norm.weight is not None:
        gamma, beta = p.norm.weight[None], p.norm.bias[None]
        wps = bw
    else:
        empty = torch.empty(0, device=x.device, dtype=torch.float32)
        return empty, empty, 1, 0
    if gamma.shape[0] * wps != bw:
        raise ValueError(f"{gamma.shape[0]} FiLM rows x {wps} windows "
                         f"per sample != {bw} windows")

    def prep(t):
        return t.to(x.dtype).float().contiguous()

    return prep(gamma), prep(beta), wps, 1


def window_attention(p: Attention, x: Tensor, cond: Optional[Tensor],
                     bias_indices: Tensor, *,
                     windows_per_sample: int) -> Tensor:
    """The fused forward of ``ops.attention.attention`` on (Bw, n, dim)
    window tokens."""
    if x.device.type == "cpu":
        return attention(p, x, cond, bias_indices,
                         windows_per_sample=windows_per_sample)
    if x.device.type != "cuda":
        raise ValueError(f"window_attention: no kernel for {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"window_attention: dtype {x.dtype} not supported")
    if x.dim() != 3:
        raise ValueError(f"window_attention: x must be (Bw, n, dim), "
                         f"got {tuple(x.shape)}")
    bw, n, dim = x.shape
    heads, dh = p.heads, p.dim_head
    if not (1 <= n <= MAX_TOKENS and dim <= MAX_DIM and dh <= MAX_DIM_HEAD):
        raise ValueError(f"window_attention: n={n} (<= {MAX_TOKENS}), "
                         f"dim={dim} (<= {MAX_DIM}), dim_head={dh} "
                         f"(<= {MAX_DIM_HEAD}) out of the kernel's range")
    if p.to_qkv.weight.device != x.device:
        raise ValueError("window_attention: weights and x on other devices")

    x = x.contiguous()
    gamma, beta, wps, has_film = _film_slot(p, cond, x, windows_per_sample)
    bias = (vnn.embedding(p.rel_pos_bias.weight, bias_indices.to(x.device))
            .permute(2, 0, 1).float().contiguous())               # (h, n, n)
    # per-head weight slices: (heads, dim, 3*dh) and (heads, dh, dim)
    wqkv = (p.to_qkv.weight.to(x.dtype).reshape(3, heads, dh, dim)
            .permute(1, 3, 0, 2).reshape(heads, dim, 3 * dh).contiguous())
    wout = (p.to_out[0].weight.to(x.dtype).t().reshape(heads, dh, dim)
            .contiguous())
    qg = p.q_norm.gamma.reshape(heads, dh).float().contiguous()
    kg = p.k_norm.gamma.reshape(heads, dh).float().contiguous()
    out = torch.empty_like(x)

    lib = _library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.vgm_window_attention_fwd(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), wqkv.data_ptr(),
        qg.data_ptr(), kg.data_ptr(), wout.data_ptr(), bias.data_ptr(),
        out.data_ptr(), bw, n, dim, heads, dh, wps, has_film,
        int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"window_attention kernel launch failed: CUDA "
                           f"error {err}")
    global launches
    launches += 1
    return out
