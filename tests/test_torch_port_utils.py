"""The port's ``utils/``: the cases of ``tests/test_utils.py`` and
``tests/test_hbm_guard.py`` on the port's profiling timer, numerics guards
and out-of-memory guard, with ``tree_stats`` held equal to the JAX
package's; the trace file, ``host_sync`` and ``debug_nans``; and the eval
loop and ``train_loop`` rewrapping a CUDA out-of-memory error, as the JAX
package's loops do."""

import gc
import glob
import types
from datetime import datetime

import numpy as np
import pytest
import torch

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.utils import debug as jax_debug
from vit_grid_model_tpu.utils import profiling as jax_profiling
from vit_grid_model_tpu_torch.utils import debug, profiling
from vit_grid_model_tpu_torch.utils.hbm import is_oom_error, oom_guard

CARD = types.SimpleNamespace(name="NVIDIA H100 80GB HBM3",
                             total_memory=80 * 2 ** 30)


def _oom():
    return torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 146.00 MiB. <allocator state>")


@pytest.fixture
def card(monkeypatch):
    """``get_device_properties`` answering as a card would."""
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: CARD)


def test_step_timer():
    t = profiling.StepTimer(warmup=1)
    for i in range(4):
        with t.step() as out:
            out["result"] = torch.ones(8, 8) * i
    assert len(t.times) == 3
    assert t.mean() > 0
    report = profiling.throughput_report(t, 25)
    assert report["steps_measured"] == 3 and report["fields_per_sec"] > 0
    assert set(report) == set(jax_profiling.throughput_report(t, 25))


def test_host_sync_reads_the_first_tensor():
    assert profiling.host_sync({"a": [torch.full((2, 3), 2.0)],
                                "b": torch.ones(4)}) == 12.0
    assert profiling.host_sync({"a": None}) == 0.0


@pytest.mark.parametrize("convert", [np.asarray, torch.tensor])
def test_check_numerics(convert):
    debug.check_numerics(convert(np.ones(4)), "ok")
    with pytest.raises(debug.NumericsError, match="1 NaN"):
        debug.check_numerics(convert(np.asarray([1.0, np.nan])), "bad")
    with pytest.raises(debug.NumericsError, match="Inf"):
        debug.check_numerics(convert(np.asarray([np.inf])), "bad")
    assert issubclass(debug.NumericsError, FloatingPointError)


def test_tree_stats_keyed_as_jax_keys_its_paths():
    tree = {"a": np.asarray([1.0, np.nan]), "b": {"c": np.zeros((2, 3))},
            "d": [np.arange(3.0), {"e": np.full(2, 5.0)}]}
    stats = debug.tree_stats(tree)
    assert stats["a"]["nan"] == 1
    assert stats["b/c"]["shape"] == (2, 3)
    assert stats == jax_debug.tree_stats(tree)
    torch_tree = {"a": torch.tensor([1.0, float("nan")]),
                  "b": {"c": torch.zeros(2, 3)},
                  "d": [torch.arange(3.0), {"e": torch.full((2,), 5.0)}]}
    assert debug.tree_stats(torch_tree) == stats
    # a state dict: its dotted names are the keys
    sd = torch.nn.Linear(3, 2).state_dict()
    assert set(debug.tree_stats(sd)) == {"weight", "bias"}
    assert debug.tree_stats(sd) == jax_debug.tree_stats(
        {k: v.numpy() for k, v in sd.items()})


def test_debug_nans_checks_the_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    torch.sqrt(x).sum().backward()          # outside the scope: no check
    x.grad = None
    with pytest.raises(RuntimeError, match="nan"):
        with debug.debug_nans():
            torch.sqrt(x).sum().backward()


def test_trace_writes_a_trace_with_the_annotation(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.annotate("legacy_forward"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert "legacy_forward" in f.read()


def test_is_oom_error_classification():
    assert is_oom_error(_oom())
    assert not is_oom_error(ValueError("shape mismatch"))
    assert not is_oom_error(KeyboardInterrupt())
    # errors that merely mention memory are not the card's memory running
    # out: the JAX package's markers, a loader's IOError, a plain
    # RuntimeError with CUDA's own words
    assert not is_oom_error(RuntimeError(
        "RESOURCE_EXHAUSTED: Attempting to reserve 12.6G"))
    assert not is_oom_error(IOError("mmap failed: out of memory"))
    assert not is_oom_error(RuntimeError("CUDA out of memory"))


def test_oom_guard_rewraps_with_context(card):
    with pytest.raises(RuntimeError) as ei:
        with oom_guard("grid model forward", 256):
            raise _oom()
    msg = str(ei.value)
    assert "grid model forward" in msg and "batch_size=256" in msg
    assert "NVIDIA H100 80GB HBM3" in msg and "80.0 GiB" in msg
    assert "16 GB" not in msg and "\n" not in msg
    assert isinstance(ei.value.__cause__, torch.cuda.OutOfMemoryError)


def test_oom_guard_passes_other_errors():
    with pytest.raises(ValueError, match="shape mismatch"):
        with oom_guard("x", 1):
            raise ValueError("shape mismatch")
    with pytest.raises(IOError, match="out of memory"):
        with oom_guard("x", 1):
            raise IOError("mmap failed: out of memory")


def test_train_loop_runs_under_the_guard(card):
    from vit_grid_model_tpu_torch.train.trainer import train_loop

    def step_fn(state, batch):
        raise _oom()

    with pytest.raises(RuntimeError, match=r"train step at batch_size=4 "
                       r"does not fit .*NVIDIA H100"):
        train_loop(types.SimpleNamespace(step=0),
                   [{"x": np.zeros((4, 1))}], step_fn)


def test_eval_loop_runs_under_the_guard(card, tmp_path):
    from vit_grid_model_tpu_torch.core.config import (DataConfig,
                                                      MetNet3Config)
    from vit_grid_model_tpu_torch.data import synthetic
    from vit_grid_model_tpu_torch.evaluation.driver import evaluate
    from vit_grid_model_tpu_torch.models.metnet3 import MetNet3

    start = datetime(2023, 5, 1, 0)
    paths = synthetic.generate_tree(str(tmp_path), start, start,
                                    prev_len=4, output_dim=3)
    data_cfg = DataConfig(input_dim=4, output_dim=3, prev_len=4, **paths)
    model = MetNet3(MetNet3Config(window_size=7, n_variables=24,
                                  n_start_channels=16, end_lead_time=3))

    def forward(*args, **kwargs):
        raise _oom()

    model.forward = forward
    with pytest.raises(RuntimeError, match=r"MetNet3 evaluation forward at "
                       r"batch_size=2 does not fit"):
        evaluate(model, data_cfg, test_start=start, test_end=start,
                 batch_size=2, num_workers=1, log_dir=str(tmp_path / "logs"),
                 progress=False)
    # the raised error's frames hold the loader's generator: collect them,
    # so that its producer thread stops here and not at interpreter exit
    gc.collect()
