"""The station-to-grid LSTM cell (``grid_v3_12hr_f32.infer_b24``): its
readers on synthetic traces, the joint attention's bound and the FLOP
count against counts by hand, the blocked reference against an unblocked
one, the cell's entries in ``BENCHMARK.json``, a traced run of the cell on
the CPU at a small size, a program without the joint-attention count
refused, and on the card its control failing the check at the cell's own
size.  The shared tests (``test_gridbench_faults.py``,
``test_gridbench_contract.py``) reach the cell as they reach every other,
its sound run and its faults included, through ``gridbench/conftest.py``."""

from __future__ import annotations

import json

import pytest
import torch

from gridbench.common import grid_seeded, peaks, spec
from gridbench.common.grid_flops import forward_flops
from gridbench.common.joint_bound import (joint_attention_bytes,
                                          joint_attention_flops,
                                          joint_bound_ms)
from gridbench.common.trace import Trace
from gridbench.conftest import GRID_SMALL
from gridbench.reference import grid as G
from gridbench.tests.conftest import run_tiny

CELL = "grid_v3_12hr_f32.infer_b24"
CONFIG = "grid_v3_12hr_f32"
BENCH = spec.benchmark()


def _trace(forwards, fields, spans):
    t = Trace(0, 10 ** 9, [("k", 0, 10 ** 8)], [], cuda=True)
    t.units = {"forwards": forwards, "fields": fields}
    t.cell = {"compute_dtype": "float32", "peak_flops": 67e12,
              "joint_attn": [24, 6044, 128, 12], "spans": spans}
    return t


SPANS = {"grid.forward/grid.decode/grid.joint_attn": [0.8, 300],
         "grid.forward/grid.encode/grid.lstm": [0.05, 100],
         "grid.forward/grid.decode/grid.lstm": [0.07, 90],
         "grid.forward/grid.decode/grid.head": [0.01, 40]}


def test_joint_attn_roofline_reader():
    read = spec.reader("joint_attn_roofline.infer").read
    bound_s = 12 * joint_bound_ms(24, 6044, 128, 4, 67e12)[0] * 1e-3
    assert read(_trace(2, 576, SPANS)) == pytest.approx(
        100 * bound_s * 2 / 0.8)
    assert read(_trace(0, 0, SPANS)) is None
    assert read(_trace(2, 576, {"": [1.0, 10]})) is None
    assert read(_trace(2, 576, {})) is None
    uncounted = _trace(2, 576, SPANS)
    uncounted.cell["joint_attn"] = None
    assert read(uncounted) is None


def test_lstm_reader():
    read = spec.reader("lstm_us_per_field.infer").read
    assert read(_trace(2, 576, SPANS)) == pytest.approx(1e6 * 0.12 / 576)
    assert read(_trace(0, 0, SPANS)) is None
    assert read(_trace(2, 576, {"": [1.0, 10]})) is None


def test_joint_bound_by_hand():
    b, n, e = 24, 6044, 128
    ops = b * (n * 128 * 384 + 2 * n * n * 128 + n * 128 * 128) * 2
    assert joint_attention_flops(b, n, e) == ops
    assert joint_attention_bytes(b, n, e, 4) == 2 * b * n * e * 4
    ms, what = joint_bound_ms(b, n, e, 4, 67e12)
    assert what == "operations"
    assert ms == pytest.approx(1e3 * ops / 67e12)
    # one token of width 1: 12 operations against 8 bytes
    ms, what = joint_bound_ms(1, 1, 1, 4, 67e12)
    assert what == "bytes" and ms == pytest.approx(1e3 * 8 / peaks.PEAK_BYTES)


def _by_hand(cfg: dict, batch: int) -> int:
    """2 x the multiply-adds of the LSTM cells and the joint attentions of
    one forward (the time encoders' and ``last_fc``'s products are under a
    thousandth of them)."""
    z = G.sizes(cfg)
    h, h16 = cfg["hidden_dim"], z["h16"]
    t_in, t_out = cfg["input_dim"], cfg["output_dim"]
    n = z["cells"] + z["stations"]

    def lstm(n_in, rows, steps):
        return 2 * (n_in + h) * 4 * h * rows * steps

    return batch * (
        lstm(2 * cfg["feat_dim"] + 9 * h16, z["cells"], t_in + t_out)
        + lstm(cfg["feat_dim"] + 5 * h16, z["stations"], t_in)
        + lstm(5 * h16, z["stations"], t_out)) + t_out * (
        joint_attention_flops(batch, n, h))


def test_flops_match_the_hand_count():
    cfg = spec.config(CONFIG)["model"]
    flops = forward_flops(cfg, 24)
    assert flops == pytest.approx(_by_hand(cfg, 24), rel=0.02)
    per_field = flops / (24 * cfg["output_dim"])
    assert 21e9 < per_field < 23e9


def _small(method="RevIN"):
    cfg = dict(spec.config(CONFIG)["model"], normalization_method=method,
               **GRID_SMALL)
    state = grid_seeded.weights(cfg, 5, "cpu")
    coords = grid_seeded.coords(cfg, 5, "cpu")
    ring = grid_seeded.batches(cfg, 5, 1, 3, "cpu", 0.1)
    return cfg, state, coords, [ring[k][0] for k in (
        "feats", "masks", "raw_times", "prev_vals", "simulation")]


@pytest.mark.parametrize("method", ["RevIN", "DishTS", "Standard"])
def test_blocked_reference_is_the_unblocked(method):
    cfg, state, coords, inputs = _small(method)
    with torch.no_grad():
        blocked = G.forward(state, cfg, coords, *inputs, block=7)
        whole = G.forward(state, cfg, coords, *inputs, block=10 ** 6)
    assert torch.isfinite(whole).all()
    assert float((blocked - whole).abs().max()) <= 1e-6 * float(
        whole.abs().max())


def test_cell_reports_its_metrics():
    """The cell's entries in ``BENCHMARK.json`` (their names, units, files
    and readers are the contract's, ``test_gridbench_contract.py``)."""
    assert spec.cell_of(BENCH, CELL)["config"] == CONFIG
    assert set(spec.workload(CELL)["limits"]) == {"rms_gap", "max_gap"}
    e2e = {m["name"] for m in spec.end_to_end(BENCH, CELL)}
    assert e2e == {"infer_fields_per_s", "setup_s"}
    layer = {m["name"] for m in spec.per_layer(BENCH, CELL)}
    assert layer == {"mfu_pct.infer", "idle_pct.infer",
                     "launches_per_field.infer", "joint_attn_roofline.infer",
                     "lstm_us_per_field.infer"}
    for m in BENCH["per_layer"]:
        if m["name"] in ("joint_attn_roofline.infer",
                         "lstm_us_per_field.infer"):
            assert m["workloads"] == [CELL]
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_tiny_copy_cuts_the_grid_by_its_own_table(tiny):
    model = spec.config(CONFIG, tiny)["model"]
    assert model == dict(spec.config(CONFIG)["model"], **GRID_SMALL)
    assert spec.workload(CELL, tiny)["batch"] == 2


def test_traced_run_is_correct(tiny):
    result = run_tiny(tiny, CELL, seconds=0.3, trace=True)
    assert result["correct"] and result["attempted"] > 0, result["checks"]
    # the CPU has no device trace: only the share of the peak reads
    assert set(result["metrics"]) == {"mfu_pct.infer"}
    json.dumps(result, allow_nan=False)


def test_a_program_without_the_count_refuses_the_cell(tiny, monkeypatch):
    from vit_grid_model_tpu_torch.ops import recurrent

    work = spec.workload(CELL, tiny)
    traffic = spec.traffic(work["traffic"])
    monkeypatch.delattr(recurrent, "reset_counts")
    with pytest.raises(AttributeError):
        traffic.setup(work, spec.config(CONFIG, tiny), 1, "cpu")


@pytest.mark.cuda
def test_control_fails():
    """The reference with TF32 on, in the program's place, at the cell's own
    size: the check fails it."""
    from gridbench.common import compare

    if not torch.cuda.is_available():
        pytest.skip("TF32, the f32 control, exists only on the card")
    work = spec.workload(CELL)
    traffic = spec.traffic(work["traffic"])
    s = traffic.setup(work, spec.config(CONFIG), 2 ** 31 + 9, "cuda:0")
    ok, checks = compare.verdict(traffic.control(s), work["limits"])
    assert not ok, checks
