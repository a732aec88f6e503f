"""Run one cell of the benchmark once and print its result.

    python3 gridbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  The cell's
workload file names its configuration and traffic kind; the traffic
driver sets the program up from the seed (weights and inputs made on the
device), runs the window, and after it the comparison with the plain
reference that decides ``correct``.  With ``--trace 0`` the result holds
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read by one reader a metric from an untraced window of the same length
and a profiled window after it.  The last line of standard output is the
result; the numbers compared, each beside its limit, are the last lines
of standard error and the result's last key.

Exits 2 without a result when CUDA is missing or has fewer devices than
the cell asks for, and 3 when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))
if __name__ == "__main__":
    # the bytecode of every module the run imports, PyTorch's and the
    # program's, kept at a fixed path inside the checkout (where the
    # environment turns Python's own cache off), so that only a
    # checkout's first run compiles it
    sys.pycache_prefix = str(ROOT / "build" / "pycache")
    sys.dont_write_bytecode = False

#: top-level module names that the measured process must never load
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_grid_model_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, the part before the first dot,
    is one of ``FORBIDDEN`` as a whole string."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def _cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout
    (the program's kernel library builds into ``build/kernels`` there by
    itself)."""
    build = ROOT / "build"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels")):
        os.environ.setdefault(var, str(build / sub))


def _finite(x: float) -> float:
    x = float(x)
    return x if math.isfinite(x) else 1e30


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, here=None, bench=None) -> dict:
    """Set up, run and check one cell on ``device``; the result's fields
    (``correct``, ``attempted``, ``failed``, ``metrics``, ``device``,
    maybe ``breakdown``, and ``checks``)."""
    import torch

    from gridbench.common import compare, spec
    from gridbench.common.trace import breakdown

    bench = bench or spec.benchmark()
    work = spec.workload(name, here)
    conf = spec.config(work["config"], here)
    traffic = spec.traffic(work["traffic"])
    device = torch.device(device)
    cuda = device.type == "cuda"

    begun = time.perf_counter()
    session = traffic.setup(work, conf, seed, device)
    setup_s = time.perf_counter() - t0
    # the parts of set-up, on earlier lines; a build of the kernel library
    # (a checkout's first run) is within the first part, and named apart
    print(f"setup: before the cell {begun - t0!r} s", file=sys.stderr)
    for part, sec in session.phases.parts:
        print(f"setup: {part} {sec!r} s", file=sys.stderr)
    print(f"setup: kernel library build {session.built_s!r} s "
          "(0.0: already built)", file=sys.stderr)
    metrics = {}
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
            "count": spec.cell_of(bench, name)["chips"]}
    extra = {}
    if trace:
        # the untraced window first: the rates the per-layer shares of
        # the peak divide, free of the profiler's cost
        first = traffic.window(session, seconds)
        out = traffic.trace(session, min(seconds, work["trace_seconds"]))
        out["attempted"] += first["attempted"]
        tr = out["trace"]
        tr.rates = dict(first["metrics"])
        for m in spec.per_layer(bench, name):
            value = spec.reader(m["name"], here).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        info["busy_s"] = tr.busy_s
        info["window_s"] = tr.window_s
        for op, sec in tr.top_ops(40):
            print(f"trace: {sec!r} s {op}", file=sys.stderr)
        bd = breakdown(tr)
        if bd:
            extra["breakdown"] = bd
    else:
        out = traffic.window(session, seconds)
        values = dict(out["metrics"], setup_s=setup_s)
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    info["memory_peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                                 if cuda else 0)
    numbers = traffic.check(session)
    ok, checks = compare.verdict(numbers, work["limits"])
    attempted = out["attempted"]
    result = {"correct": ok and attempted > 0, "attempted": attempted,
              "failed": 0 if ok else attempted, "metrics": metrics,
              "device": info, **extra,
              "checks": {k: {"value": _finite(v["value"]),
                             "limit": v["limit"]}
                         for k, v in checks.items()}}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from gridbench.common import spec

    bench = spec.benchmark()
    chips = spec.cell_of(bench, args.workload)["chips"]
    _cache_dirs()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"gridbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda:0", T0, bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"gridbench: the measured process loaded {bad}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
