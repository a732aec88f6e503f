"""``BENCHMARK.json`` and the harness's files keep the benchmark's rules:
names, units, one workload, configuration and reader file for each entry,
the import rules, and the result line's keys."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from gridbench.common import spec
from gridbench.tests.conftest import ROOT, run_tiny

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "vit_grid_model_tpu")
PORT = "vit_grid_model_tpu_torch"


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for cell in BENCH["workloads"]:
        yield cell["config"]
        yield cell["traffic"]
    for conf in BENCH["configs"]:
        yield from conf["reduced"]


def test_names_and_units():
    names = list(_names())
    assert all(NAME.match(n) for n in names), names
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        entries = [e["name"] for e in BENCH[key]]
        assert len(entries) == len(set(entries)), key
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for text in ([c["why"] for c in BENCH["workloads"] + BENCH["configs"]]
                 + [m["layer"] for m in BENCH["per_layer"]]
                 + [c["source"] for c in BENCH["configs"]]
                 + BENCH["command"]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_shape_of_the_file():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["gridbench"]
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in (
            "host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "bound" not in m
        for cell in m["workloads"]:
            assert m["moves"] in {x["name"] for x in spec.end_to_end(
                BENCH, cell)}
    for cell in BENCH["workloads"]:
        assert cell["chips"] == 1
        names = {m["name"] for m in spec.end_to_end(BENCH, cell["name"])}
        assert "setup_s" in names and len(names) >= 2
        assert spec.per_layer(BENCH, cell["name"])


def test_every_entry_has_its_files():
    for conf in BENCH["configs"]:
        data = json.loads((ROOT / conf["file"]).read_text())
        assert data["source"] == conf["source"]
        assert data["reduced"] == conf["reduced"] == []
    for cell in BENCH["workloads"]:
        work = spec.workload(cell["name"])
        for key in ("config", "traffic", "chips", "why"):
            assert work[key] == cell[key], (cell["name"], key)
        assert (spec.HERE / "traffic" / f"{cell['traffic']}.py").exists()
        assert work["limits"]
    for m in BENCH["per_layer"]:
        reader = spec.reader(m["name"])
        assert (reader.LAYER, reader.UNIT, reader.MOVES) == (
            m["layer"], m["unit"], m["moves"]), m["name"]


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_import_rules():
    """No file imports JAX or the JAX package, by whole top-level name;
    the reference and the shared code import nothing of the program; only
    the window drivers, their helpers and the planted faults, all under
    ``traffic/``, and the tests do."""
    for path in spec.HERE.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & set(FORBIDDEN), path
        rel = path.relative_to(spec.HERE).parts
        if PORT in tops:
            assert rel[0] in ("traffic", "tests"), path


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gridbench.reference.metnet3, gridbench.reference.train\n"
            "import gridbench.reference.precision, gridbench.common.flops\n"
            "import gridbench.common.seeded, gridbench.common.compare\n"
            "import gridbench.common.trace, gridbench.common.peaks\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in %r]\n"
            "assert not bad, bad\n") % (str(ROOT), FORBIDDEN + (PORT,))
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


def test_prefix_is_not_a_match():
    from gridbench import run

    saved = dict(sys.modules)
    try:
        sys.modules["vit_grid_model_tpu_torch_extra"] = sys
        sys.modules["vit_grid_model_tpu_torch.models"] = sys
        found = run.forbidden_modules()
        assert "vit_grid_model_tpu_torch_extra" not in found
        assert "vit_grid_model_tpu_torch.models" not in found
        sys.modules["vit_grid_model_tpu.core"] = sys
        assert "vit_grid_model_tpu.core" in run.forbidden_modules()
        sys.modules["jaxlib.xla"] = sys
        assert "jaxlib.xla" in run.forbidden_modules()
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_without_cuda_no_result():
    proc = subprocess.run(
        [sys.executable, "gridbench/run.py", "--workload", BENCH["workloads"]
         [0]["name"], "--seed", str(2 ** 31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


@pytest.mark.parametrize("trace", [False, True])
def test_result_keys(tiny, trace):
    result = run_tiny(tiny, "metnet3_12hr_f32.infer_b24", trace=trace)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics",
                        "device"]
    assert keys[-1] == "checks"
    assert set(keys) <= {"correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"}
    assert result["correct"] and result["attempted"] > 0
    if not trace:
        assert set(result["metrics"]) == {"infer_fields_per_s", "setup_s"}
    json.dumps(result, allow_nan=False)
