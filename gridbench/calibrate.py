"""The readings that a cell's correctness limits are set from, at the
cell's own size, in one process:

* the program's numbers on each of ``--seeds`` (a short window at the
  cell's load for inference, the compared first steps for training);
* the control's: the plain reference one step below the configuration's
  precision in the program's place, on each of ``--control-seeds``;
* each fault of ``gridbench/traffic/_faults.py`` that the cell can have,
  planted in the program, on each of ``--fault-seeds``.

    python3 gridbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --control-seeds 4,5,6 --fault-seeds 7,8,9 [--out readings.jsonl]

One JSON line a reading, on standard output and appended to ``--out``.
The benchmark's own runs never run this.
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
#: the faults of gridbench/traffic/_faults.py that each traffic kind can have
FAULTS = {"infer": ("altered", "half_batch"),
          "train": ("altered", "half_batch", "frozen")}


def _ints(text: str):
    return [int(t) for t in text.split(",") if t]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=_ints, default=[])
    p.add_argument("--control-seeds", type=_ints, default=[])
    p.add_argument("--fault-seeds", type=_ints, default=[])
    p.add_argument("--seconds", type=float, default=1.0,
                   help="the inference window of a program reading")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    import torch

    from gridbench.traffic import _faults as faults
    from gridbench.common import spec

    work = spec.workload(args.workload)
    conf = spec.config(work["config"])
    traffic = spec.traffic(work["traffic"])
    kind = work["traffic"]

    def emit(what, seed, numbers, t0):
        line = {"workload": args.workload, "reading": what, "seed": seed,
                "numbers": numbers, "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(line) + "\n")

    def program(seed):
        s = traffic.setup(work, conf, seed, DEVICE)
        if kind == "infer":
            s.run(args.seconds)
        return traffic.check(s)

    for seed in args.seeds:
        t0 = time.perf_counter()
        emit("program", seed, program(seed), t0)
    for seed in args.control_seeds:
        t0 = time.perf_counter()
        emit("control", seed,
             traffic.control(traffic.setup(work, conf, seed, DEVICE)),
             t0)
    for name in FAULTS[kind]:
        for seed in args.fault_seeds:
            t0 = time.perf_counter()
            with faults.planted(name):
                numbers = program(seed)
            emit(f"fault:{name}", seed, numbers, t0)
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "peak_bytes": torch.cuda.max_memory_allocated()}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
