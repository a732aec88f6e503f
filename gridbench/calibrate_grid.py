"""The readings that the station-to-grid LSTM cell's correctness limits are
set from, at the cell's own size, in one process:

* the program's numbers on each of ``--seeds`` (a short window at the
  cell's load, then the comparison);
* the control's: the plain reference with TF32 on in the program's place,
  on each of ``--control-seeds``;
* each fault of ``gridbench/traffic/_grid_faults.py`` planted in the
  program, on each of ``--fault-seeds``.

    python3 gridbench/calibrate_grid.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 [--out readings.jsonl]

One JSON line a reading, on standard output and appended to ``--out``;
each names the card and the peak memory of its set-up and window.  The
benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DEVICE = "cuda:0"


def _ints(text: str):
    return [int(t) for t in text.split(",") if t]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=1.0,
                   help="the window of a program or fault reading")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from gridbench.common import spec
    from gridbench.traffic import _grid_faults as faults

    work = spec.workload(args.workload)
    conf = spec.config(work["config"])
    traffic = spec.traffic(work["traffic"])
    card = torch.cuda.get_device_name(0)

    def emit(what, seed, numbers, peak, t0):
        line = {"workload": args.workload, "reading": what, "seed": seed,
                "numbers": numbers, "peak_bytes": peak, "card": card,
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    def program(seed, fault=None):
        torch.cuda.reset_peak_memory_stats()
        s = traffic.setup(work, conf, seed, DEVICE)
        if fault is None:
            s.run(args.seconds)
        else:
            # planted after set-up, whose warm-up checks the count of joint
            # attentions: the window's forwards, whose outputs are kept,
            # run with the fault
            with faults.planted(fault):
                s.run(args.seconds)
        peak = torch.cuda.max_memory_allocated()
        return traffic.check(s), peak

    for seed in args.seeds:
        t0 = time.perf_counter()
        emit("program", seed, *program(seed), t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        s = traffic.setup(work, conf, seed, DEVICE)
        emit("control", seed, traffic.control(s), None, t0)
    for name in faults.NAMES:
        for seed in args.fault_seeds:
            t0 = time.perf_counter()
            emit(f"fault:{name}", seed, *program(seed, name), t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
