"""The port's spans (``utils/profiling.py::annotate``) on the CPU.

* With no profiler running, ``annotate`` is one shared no-op context and
  enters no ``record_function``.
* ``trace`` records the spans of a tiny ``MetNet3`` forward (fused and
  unfused stem, and ``class_outputs``), of a train step (and its remat
  recompute, which runs in the backward) and of the eval loop, nested as
  the model, the trainer and the driver open them, and no ATen operation.
* The eval loop's ``eval.*`` spans and ``BatchTiming``'s phases come from
  the same marks: their sums agree.
* ``kernels_by_span`` on synthetic profiler events: a kernel belongs to
  the innermost span open on its launching thread when its launch call
  began, a launch from the autograd engine's thread with no span of its
  own to the innermost span open at that moment on any thread; copies and
  fills are not kernels.
"""

from __future__ import annotations

import glob
from datetime import datetime

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType

from tests.test_torch_port_train import _import_dynamo  # noqa: F401
from vit_grid_model_tpu_torch.core.config import (DataConfig, MetNet3Config,
                                                  TrainConfig)
from vit_grid_model_tpu_torch.core.weights import seeded_model
from vit_grid_model_tpu_torch.data import synthetic
from vit_grid_model_tpu_torch.evaluation import driver
from vit_grid_model_tpu_torch.train import trainer
from vit_grid_model_tpu_torch.utils import profiling

T, H, W, B = 3, 18, 17, 2

FORWARD = ["metnet3.input", "metnet3.stem", "metnet3.vit",
           "metnet3.vit/maxvit.mbconv", "metnet3.vit/maxvit.block_attn",
           "metnet3.vit/maxvit.grid_attn", "metnet3.up", "metnet3.resnet2"]


def _under(parent, paths):
    return [f"{parent}/{p}" for p in paths]


def _cfg(**kw):
    return MetNet3Config(window_size=T, n_variables=24, n_start_channels=16,
                         end_lead_time=2, input_height=H, input_width=W,
                         pm25_mean=22.5, pm25_std=15.5, n_heads=4,
                         dim_head=4, **kw)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.random((B, T, 24, H, W)) * 50)
                         .astype(np.float32))
    ts = torch.from_numpy(np.stack(
        [np.full((B, T), 2023.0), rng.integers(1, 13, (B, T)),
         rng.integers(1, 29, (B, T)), rng.integers(0, 24, (B, T))],
        -1).astype(np.float32))
    return x, ts


def _recorded(tmp_path, fn):
    """The span paths ``trace`` records over ``fn()``, in start order; the
    recording holds no host event but the spans."""
    with profiling.trace(str(tmp_path)) as events:
        fn()
    assert len(glob.glob(str(tmp_path / "*.pt.trace.json"))) == 1
    host = [ev.name() for ev in events
            if ev.device_type() == DeviceType.CPU
            and not ev.is_user_annotation()]
    assert host == []
    return [s[0] for s in profiling.span_paths(events)]


def test_annotate_is_one_no_op_while_no_profiler_runs(monkeypatch):
    def refused(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(profiling, "record_function", refused)
    span = profiling.annotate("metnet3.forward")
    assert span is profiling.annotate("train.step") is profiling._OFF
    with span, profiling.annotate("eval.launch"):
        pass
    monkeypatch.undo()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity
                                            .CPU]):
        assert profiling.annotate("x") is not profiling._OFF


@pytest.mark.parametrize("case", ["unfused", "fused", "class_outputs"])
def test_forward_spans(tmp_path, case):
    x, ts = _inputs()
    if case == "class_outputs":
        model = seeded_model(_cfg(pm25_class_head=True, pm10=True,
                                  direct_regional=True), 0)
        run = lambda: model.class_outputs(x, ts)  # noqa: E731
        top = "metnet3.class_outputs"
    else:
        model = seeded_model(_cfg(fuse_lead_stem=case == "fused"), 0)
        run = lambda: model(x, ts)  # noqa: E731
        top = "metnet3.forward"
    with torch.inference_mode():
        paths = _recorded(tmp_path, run)
    assert paths == [top] + _under(top, FORWARD + ["metnet3.head"])


@pytest.mark.parametrize("remat", [False, True])
def test_train_step_spans(tmp_path, remat):
    cfg = _cfg(dropout=0.1)
    tc = TrainConfig(learning_rate=1e-3, total_steps=4, warmup_steps=1,
                     batch_size=B, remat=remat)
    state = trainer.init_train_state(seeded_model(cfg, 0), tc)
    step = trainer.build_train_step(cfg, tc)
    x, ts = _inputs()
    batch = {"x": x, "timestamps": ts,
             "targets": torch.rand(B, 2, H, W) * 60}
    step(state, batch)           # AdamW's first step builds its state
    paths = _recorded(tmp_path, lambda: trainer.train_loop(
        state, [batch], step, log_every=1, log=lambda line: None))
    top = "train.step/train.forward/metnet3.forward"
    forward = [top] + _under(top, FORWARD + ["metnet3.head"])
    # under remat the checkpointed backbone runs again in the backward
    backward = (_under("train.step/train.backward",
                       ["maxvit.mbconv", "maxvit.block_attn",
                        "maxvit.grid_attn"]) if remat else [])
    # torch.optim opens its own ranges in the user scope
    update = _under("train.step/train.update",
                    ["Optimizer.step#AdamW.step",
                     "Optimizer.zero_grad#AdamW.zero_grad"])
    assert paths == (["train.step", "train.step/train.cast",
                      "train.step/train.forward"] + forward
                     + ["train.step/train.loss", "train.step/train.backward"]
                     + backward + ["train.step/train.update"] + update
                     + ["train.log"])


def test_eval_spans_are_batch_timing_phases(tmp_path):
    start = datetime(2023, 5, 1, 0)
    paths = synthetic.generate_tree(str(tmp_path / "tree"), start,
                                    start.replace(hour=11), prev_len=4,
                                    output_dim=3)
    data_cfg = DataConfig(input_dim=4, output_dim=3, prev_len=4,
                          data_path=paths["data_path"],
                          sim_data_path=paths["sim_data_path"],
                          analysis_data_path=paths["analysis_data_path"])
    model = seeded_model(MetNet3Config(window_size=7, n_variables=24,
                                       n_start_channels=16, end_lead_time=3),
                         0)
    timing = driver.BatchTiming()
    with profiling.trace(str(tmp_path / "trace")) as events:
        driver.evaluate(model, data_cfg, test_start=start,
                        test_end=start.replace(hour=11), batch_size=5,
                        num_workers=1, log_dir=str(tmp_path / "logs"),
                        progress=False, timing=timing)
    assert timing.samples == [5, 5, 2]
    spans = profiling.span_paths(events)
    tops = [s[0] for s in spans if "/" not in s[0]]
    assert tops == [f"eval.{p}" for p in timing.phases] * 3
    assert all(s[0].startswith("eval.launch/metnet3.forward")
               for s in spans if "/" in s[0])
    for phase, seconds in timing.phases.items():
        span_s = 1e-9 * sum(s[3] - s[2] for s in spans
                            if s[0] == f"eval.{phase}")
        # the host-clock marks lie inside their span, whose ends the
        # profiler stamps on its own clock, a little outside them
        assert abs(span_s - sum(seconds)) <= (1e-3 * len(seconds)
                                              + 1e-2 * sum(seconds)), phase


class _Event:
    """A profiler event as ``kernels_by_span`` reads it."""

    def __init__(self, name, start, end, *, device=False, span=False,
                 thread=1, corr=0):
        self._name, self._start, self._end = name, start, end
        self._device, self._span = device, span
        self._thread, self._corr = thread, corr

    def name(self):
        return self._name

    def device_type(self):
        return DeviceType.CUDA if self._device else DeviceType.CPU

    def is_user_annotation(self):
        return self._span

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._end - self._start

    def start_thread_id(self):
        return self._thread

    def correlation_id(self):
        return self._corr


def _spans():
    """train.step [0, 100) holding train.backward [10, 60) and
    train.update [60, 90) on thread 1; a recompute span [20, 30) on the
    autograd engine's thread 2."""
    return [_Event("train.step", 0, 100, span=True),
            _Event("train.backward", 10, 60, span=True),
            _Event("maxvit.mbconv", 20, 30, span=True, thread=2),
            _Event("train.update", 60, 90, span=True)]


def _launch(start, thread, corr):
    """A launch call and its kernel, 20 ns long, after the spans."""
    return [_Event("cudaLaunchKernel", start, start + 2, thread=thread,
                   corr=corr),
            _Event("elementwise_kernel", 200 + corr, 220 + corr,
                   device=True, corr=corr)]


def test_span_paths_nest_across_threads():
    assert [s[0] for s in profiling.span_paths(_spans())] == [
        "train.step", "train.step/train.backward",
        "train.step/train.backward/maxvit.mbconv",
        "train.step/train.update"]


@pytest.mark.parametrize("start,thread,owner", [
    # the innermost span open on the launching thread when the call began
    (5, 1, "train.step"),
    (25, 1, "train.step/train.backward"),
    (70, 1, "train.step/train.update"),
    # on the autograd engine's thread: its own span, else the innermost
    # span open at that moment on any thread
    (25, 2, "train.step/train.backward/maxvit.mbconv"),
    (40, 2, "train.step/train.backward"),
    # launched while no span was open
    (120, 1, ""),
])
def test_kernel_owner(start, thread, owner):
    events = _spans() + _launch(start, thread, 7)
    # a copy launched inside a span is not a kernel
    events += [_Event("cudaMemcpyAsync", 70, 72, corr=8),
               _Event("Memcpy HtoD (Pageable -> Device)", 150, 160,
                      device=True, corr=8)]
    assert profiling.kernels_by_span(events) == {owner: [20e-9, 1]}


def test_kernels_by_span_sums_each_owner():
    events = _spans() + [ev for i, (t, thread) in enumerate(
        [(15, 1), (65, 1), (85, 1), (22, 2), (95, 2)])
        for ev in _launch(t, thread, i)]
    # a kernel whose launch call the trace lacks
    events.append(_Event("k", 300, 305, device=True, corr=99))
    assert profiling.kernels_by_span(events) == {
        "train.step/train.backward": [20e-9, 1],
        "train.step/train.update": [40e-9, 2],
        "train.step/train.backward/maxvit.mbconv": [20e-9, 1],
        "train.step": [20e-9, 1],
        "": [5e-9, 1]}
