"""Shared harness of the port's repros, the counterpart of
``benchmarks/mosaic_repros/common.py``.

Each repro runs one kernel variant at the flagship geometry on the GPU,
with its plain version beside it.  ``run_repro`` times a call with CUDA
events after a warmup that it discards, and returns the time with the
output's max error relative to a reference output.  Unlike the TPU harness
it catches nothing: a build, launch or numerical failure raises.
"""

from __future__ import annotations

import re
import subprocess
from typing import Callable, Dict, Tuple

import torch
from torch import Tensor

# the card's published peaks (H100 SXM data sheet): tensor-core bf16 and
# int8, CUDA-core f32, device memory
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.int8: 1979e12,
              torch.float32: 67e12}
PEAK_BYTES = 3.35e12


def bound_ms(ops: float, moved: float,
             dtype: torch.dtype) -> Tuple[float, str]:
    """(least ms, what bounds it) of work that does ``ops`` operations in
    ``dtype`` and must move ``moved`` bytes: the larger of the two times at
    the card's peak rates."""
    t_ops, t_bytes = ops / PEAK_FLOPS[dtype], moved / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "bytes" if t_bytes > t_ops else "operations")


def require_cuda() -> torch.device:
    if not torch.cuda.is_available():
        raise RuntimeError("the repros run on a CUDA device")
    return torch.device("cuda:0")


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn: Callable[[], object], iters: int = 10,
            warmup: int = 2) -> float:
    """Mean milliseconds of ``fn()`` on the current stream over ``iters``
    calls, after ``warmup`` calls that are not timed."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_ms(fn: Callable[[], object], steps: int = 3) -> Dict[str, float]:
    """{kernel name: device milliseconds per call of ``fn``} for the CUDA
    kernels torch.profiler records over ``steps`` calls after one warmup
    call.  Names are cut to the function's own name, template arguments
    dropped."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            name = re.sub(r"^(void )?(\(anonymous namespace\)::)?", "",
                          e.key).split("<")[0].split("(")[0]
            out[name] = (out.get(name, 0.0)
                         + e.self_device_time_total / 1e3 / steps)
    return out


def max_rel(ours: Tensor, ref: Tensor) -> float:
    """max|ours - ref| / max|ref|, in f32."""
    ours, ref = ours.float(), ref.float()
    return ((ours - ref).abs().max() / ref.abs().max()).item()


def run_repro(name: str, fn: Callable[[], Tensor], ref: Tensor, *,
              iters: int = 20, warmup: int = 5) -> Tuple[float, float]:
    """Time ``fn`` and print one line.  Returns (ms per call, max error
    relative to ``ref``).  Raises when the output is not finite."""
    out = fn()
    torch.cuda.synchronize()
    if not bool(torch.isfinite(out.float()).all()):
        raise FloatingPointError(f"{name}: the output is not finite")
    rel = max_rel(out, ref)
    ms = cuda_ms(fn, iters, warmup)
    print(f"{name}: {ms:.4f} ms/call, out {tuple(out.shape)} "
          f"{str(out.dtype).split('.')[-1]}, max rel vs plain {rel:.3e}",
          flush=True)
    return ms, rel


def compare_and_time(label: str, versions: Dict[str, Callable[[], Tensor]],
                     tolerance: float, *,
                     iters: int = 20) -> Dict[str, Tuple[float, float]]:
    """Time each of ``versions`` (the first is the plain reference) with
    ``run_repro``: {name: (ms, max rel vs the first's output)}.  Raises when
    a version other than the first misses ``tolerance``."""
    with torch.inference_mode():
        ref = next(iter(versions.values()))()
        out = {name: run_repro(f"{label} {name}", fn, ref, iters=iters)
               for name, fn in versions.items()}
    del ref
    torch.cuda.empty_cache()
    for name, (_, rel) in list(out.items())[1:]:
        if not rel <= tolerance:
            raise AssertionError(f"{label} {name}: max rel {rel} above "
                                 f"{tolerance}")
    return out
