"""The station-to-grid LSTM v3 of the benchmark's grid cell
(``gridbench/configs/grid_v3_12hr_f32.json``) at a small size on the CPU:
grid 6 x 5, 9 stations, hidden 32, 4 + 3 hours, ``prev_len`` 4, B 2, on
the benchmark's seeded weights, coordinates and inputs
(``gridbench/common/grid_seeded.py``).

* The port's ``GridModel`` against the benchmark's plain reference
  (``gridbench/reference/grid.py``) under RevIN, DishTS and Standard:
  within 1e-5 of max|reference|, f32 on both sides with the sums in
  another order through 7 recurrent steps.
* The two faults the benchmark plants (``gridbench/traffic/
  _grid_faults.py``: the station tokens dropped from the joint attention;
  the output window reading the input window's CMAQ blocks) each move
  that gap by more than 100x the tolerance.
* ``profiling.trace`` records a forward's spans, nested as the model opens
  them; under the profiler's operator recording every ATen operation of
  the forward lies in a span under ``grid.forward``.
* ``ops/recurrent.py`` counts 3 joint attentions of B n^2 score elements
  (n = 30 cells + 9 stations) a forward.
* The reference and the benchmark's shared grid code load nothing of JAX
  or of the program.

On the card (marked ``cuda``; this file imports no JAX):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_grid_config.py

a forward's kernels, every one, belong to a span under ``grid.forward``
(``kernels_by_span``).
"""

from __future__ import annotations

import glob
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch.autograd import DeviceType

from gridbench.common import grid_seeded
from gridbench.reference import grid as G
from gridbench.traffic import _grid_faults as faults
from gridbench.traffic.grid_infer import INPUTS
from vit_grid_model_tpu_torch.models.legacy.grid import (GridModel,
                                                         GridModelSpec)
from vit_grid_model_tpu_torch.ops import recurrent
from vit_grid_model_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parents[1]
SMALL = dict(version=3, input_dim=4, output_dim=3, prev_len=4, feat_dim=12,
             hidden_dim=32, korea_stn_num=6, china_stn_num=3,
             grid_shape=[6, 5], pm25_mean=17.5, pm25_std=12.3)
B, SEED, MASKED = 2, 2 ** 31 + 27, 0.1
TOL = 1e-5
METHODS = ("RevIN", "DishTS", "Standard")
SPANS = ["grid.forward", "grid.forward/grid.input", "grid.forward/grid.encode",
         "grid.forward/grid.encode/grid.lstm",
         "grid.forward/grid.encode/grid.step_input",
         "grid.forward/grid.decode", "grid.forward/grid.decode/grid.lstm",
         "grid.forward/grid.decode/grid.step_input",
         "grid.forward/grid.decode/grid.joint_attn",
         "grid.forward/grid.decode/grid.head"]


def _case(method="RevIN", device="cpu"):
    """(cfg, state, coords, the port's model, the inputs)."""
    cfg = dict(SMALL, normalization_method=method)
    state = grid_seeded.weights(cfg, SEED, device)
    coords = grid_seeded.coords(cfg, SEED, device)
    ring = grid_seeded.batches(cfg, SEED, 1, B, device, MASKED)
    spec = GridModelSpec(**dict(cfg, grid_shape=tuple(cfg["grid_shape"])))
    model = GridModel(spec, *(coords[k].cpu().numpy() for k in
                              ("lats", "lons", "cmaq_coords"))).to(device)
    model.load_state_dict(state, strict=True)
    return cfg, state, coords, model.eval(), [ring[k][0] for k in INPUTS]


def _gap(out, ref) -> float:
    return float((out - ref).abs().max() / ref.abs().max())


def _reference(cfg, state, coords, inputs):
    with torch.no_grad():
        return G.forward(state, cfg, coords, *inputs, block=7)


@pytest.mark.parametrize("method", METHODS)
def test_port_matches_the_reference(method):
    cfg, state, coords, model, inputs = _case(method)
    # some station keys of the output window are masked
    assert not inputs[1][:, cfg["input_dim"]:].all()
    with torch.inference_mode():
        ours = model(*inputs)
    ref = _reference(cfg, state, coords, inputs)
    assert ours.shape == ref.shape == (B, 30, cfg["output_dim"])
    assert _gap(ours, ref) <= TOL


@pytest.mark.parametrize("fault", faults.NAMES)
def test_planted_fault_moves_the_gap(fault):
    cfg, state, coords, model, inputs = _case()
    with torch.inference_mode(), faults.planted(fault):
        ours = model(*inputs)
    assert _gap(ours, _reference(cfg, state, coords, inputs)) > 100 * TOL


def _owner(spans, t, thread):
    """The innermost span open at ``t`` on ``thread``."""
    best = None
    for path, th, s, e in spans:
        if th == thread and s <= t < e and (best is None or s >= best[2]):
            best = (path, th, s, e)
    return best[0] if best else ""


def test_span_tree_and_every_op_owned(tmp_path):
    _, _, _, model, inputs = _case()
    with torch.inference_mode(), profiling.trace(str(tmp_path)) as events:
        model(*inputs)
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1
    assert sorted({s[0] for s in profiling.span_paths(events)}) == sorted(
        SPANS)
    with torch.inference_mode(), torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        model(*inputs)
    events = prof.profiler.kineto_results.events()
    spans = profiling.span_paths(events)
    ops = [ev for ev in events if ev.device_type() == DeviceType.CPU
           and not ev.is_user_annotation()]
    owners = {}
    for ev in ops:
        path = _owner(spans, ev.start_ns(), ev.start_thread_id())
        owners.setdefault(path, set()).add(ev.name())
    assert ops and all(p.startswith("grid.forward") for p in owners), \
        sorted(owners)
    assert "aten::sigmoid" in owners["grid.forward/grid.encode/grid.lstm"]
    assert "aten::matmul" in owners["grid.forward/grid.decode/grid.joint_attn"]


def test_counter_of_joint_attentions():
    cfg, _, _, model, inputs = _case()
    recurrent.reset_counts()
    with torch.inference_mode():
        model(*inputs)
    n = 30 + 9
    assert recurrent.attention_calls == cfg["output_dim"]
    assert recurrent.score_elements == cfg["output_dim"] * B * n * n
    recurrent.reset_counts()
    assert recurrent.attention_calls == recurrent.score_elements == 0


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import gridbench.reference.grid, gridbench.common.grid_seeded\n"
            "import gridbench.common.grid_flops\n"
            "import gridbench.common.joint_bound\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'jaxlib', 'flax', 'vit_grid_model_tpu',\n"
            "        'vit_grid_model_tpu_torch')]\n"
            "assert not bad, bad\n") % str(ROOT)
    subprocess.run([sys.executable, "-c", code], check=True, cwd=ROOT)


@pytest.mark.cuda
def test_every_kernel_owned_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _, _, _, model, inputs = _case(device="cuda")
    with torch.inference_mode(), profiling.trace(str(tmp_path)) as events:
        model(*inputs)
    owners = profiling.kernels_by_span(events)
    assert owners and all(p.startswith("grid.forward") for p in owners), \
        sorted(owners)
    assert {"grid.forward/grid.decode/grid.joint_attn",
            "grid.forward/grid.encode/grid.lstm"} <= set(owners)
