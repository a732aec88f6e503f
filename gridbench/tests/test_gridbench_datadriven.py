"""A configuration, a cell and a per-layer metric come in as new files and
entries, with no existing file edited: a copy of the benchmark under a
temporary directory gains a throwaway cell of each kind and runs it."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

from gridbench.tests.conftest import ROOT, TINY


def test_a_new_cell_needs_only_new_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(ROOT / "gridbench", root / "gridbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in (root / "gridbench").rglob("*")
              if p.is_file()}
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # a configuration: the f32 model cut to a toy
    conf = json.loads((root / "gridbench/configs/metnet3_12hr_f32.json")
                      .read_text())
    conf["model"].update(TINY)
    (root / "gridbench/configs/toy_f32.json").write_text(json.dumps(conf))
    # a cell on it, with a traffic kind of its own that reuses inference
    work = json.loads((root / "gridbench/workloads/"
                       "metnet3_12hr_f32.infer_b24.json").read_text())
    work.update(config="toy_f32", traffic="toy", batch=2, why="a toy")
    (root / "gridbench/workloads/toy_f32.toy.json").write_text(
        json.dumps(work))
    (root / "gridbench/traffic/toy.py").write_text(
        "from gridbench.traffic.infer import *  # noqa\n"
        "from gridbench.traffic.infer import Session  # noqa\n")
    # a per-layer metric with a reader of its own
    (root / "gridbench/metrics/forwards.toy.py").write_text(
        'LAYER = "model step"\nUNIT = "forwards"\n'
        'MOVES = "infer_fields_per_s"\n\n\n'
        'def read(trace):\n    return trace.units.get("forwards") or None\n')
    bench["configs"].append(dict(bench["configs"][1], name="toy_f32",
                                 file="gridbench/configs/toy_f32.json"))
    bench["workloads"].append({"name": "toy_f32.toy", "config": "toy_f32",
                               "traffic": "toy", "chips": 1, "why": "a toy"})
    for m in bench["end_to_end"]:
        if m["name"] == "infer_fields_per_s":
            m["workloads"].append("toy_f32.toy")
    bench["per_layer"].append({
        "name": "forwards.toy", "unit": "forwards", "better": "higher",
        "source": "device_trace", "layer": "model step",
        "moves": "infer_fields_per_s", "workloads": ["toy_f32.toy"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    for path, data in before.items():
        assert path.read_bytes() == data, path

    code = (
        "import json, sys, time\n"
        "sys.path[:0] = [%r, %r]\n"
        "import gridbench.run as run\n"
        "assert run.ROOT.as_posix() == %r, run.ROOT\n"
        "for trace in (False, True):\n"
        "    r = run.run_cell('toy_f32.toy', 2**31 + 3, 0.3, trace, 'cpu',\n"
        "                     time.perf_counter())\n"
        "    print(json.dumps(r))\n") % (str(root), str(ROOT),
                                         root.as_posix())
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True, check=True)
    plain, traced = (json.loads(line) for line in
                     proc.stdout.strip().splitlines()[-2:])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"infer_fields_per_s", "setup_s"}
    assert traced["metrics"]["forwards.toy"]["value"] > 0
