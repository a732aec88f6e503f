"""Station evaluation head to head: the port's ``evaluate_by_station`` and
its CLI against the JAX package's on one synthetic data tree (6 Korean and 2
Chinese stations), on the CPU, with twin weights (``params_from_jax`` for
the library, a reference ``.pkt`` saved once for the CLIs).  Small size:
window 7 (the time conditioning reads timestamp row 6), hidden 16, 2 leads.
The window holds 11 samples: batches of 4, 4 and a ragged 3, run at their
true size.

Every scalar of the summary agrees within 1.0001e-4 (the log prints 4
decimals, and the f32 forwards differ by ~1e-6 relative), as
``tests/test_torch_port_eval.py`` holds the grid evaluation; ``n_obs`` is
equal, and the two log blocks have the same lines apart from their values.
Also: ``StationMetrics``' masking, the eval CLIs' ``--collect_valid_times``
(equal element for element), and the station CLI's refusals."""

import dataclasses
import os
import re
from datetime import datetime

import numpy as np
import pytest
import torch

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import DataConfig as JaxDataConfig
from vit_grid_model_tpu.core.config import GridConfig as JaxGridConfig
from vit_grid_model_tpu.core.config import MetNet3Config as JaxConfig
from vit_grid_model_tpu.core.torch_export import save_torch_checkpoint
from vit_grid_model_tpu.data import readers, synthetic
from vit_grid_model_tpu.evaluation import station_eval as jax_station
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu_torch.core.config import DataConfig, MetNet3Config
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.data import readers as port_readers
from vit_grid_model_tpu_torch.evaluation import station_eval as port_station
from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming

START, END = datetime(2023, 4, 1, 0), datetime(2023, 4, 1, 10)
INPUT_DIM, OUTPUT_DIM, PREV_LEN, HIDDEN, BATCH = 5, 2, 5, 16, 4
ABS_TOL = 1.0001e-4
NAME = "stn_h2h"


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_stn")
    paths = synthetic.generate_tree(
        str(root / "tree"), START, END, prev_len=PREV_LEN,
        output_dim=OUTPUT_DIM, korea_stn_num=6, china_stn_num=2)
    readers.clear_caches()
    port_readers.clear_caches()
    return root, paths


def _assert_summaries_close(ours, ref):
    assert ours.keys() == ref.keys()
    assert ours["n_obs"] == ref["n_obs"] > 0
    for key, value in ref.items():
        assert abs(ours[key] - value) <= ABS_TOL, (key, ours[key], value)


@pytest.mark.parametrize("module", [port_station, jax_station])
def test_station_metrics_masking(module):
    m = module.StationMetrics()
    preds = np.asarray([[[10.0, 50.0, 20.0]]])
    truth = np.asarray([[[12.0, np.nan, 25.0]]])
    # column-6 semantics: True == INVALID observation (dataset.py:1889)
    invalid = np.asarray([[[False, False, True]]])
    m.update(preds, truth, invalid_flag=invalid)
    s = m.summary()
    assert s["n_obs"] == 1            # NaN and flagged-invalid dropped
    assert abs(s["MAE"] - 2.0) < 1e-9


def test_station_metrics_and_log_equal():
    """Two updates of random station scores with NaN and invalid entries:
    the same summary and the same log text in both packages."""
    rng = np.random.default_rng(4)
    engines = [port_station.StationMetrics(), jax_station.StationMetrics()]
    for b in (4, 3):
        preds = (rng.random((b, 2, 6)) * 90).astype(np.float32)
        truth = (rng.random((b, 2, 6)) * 90).astype(np.float32)
        truth[0, 0, 0] = np.nan
        invalid = rng.random((b, 2, 6)) < 0.2
        for m in engines:
            m.update(preds, truth, invalid_flag=invalid)
    assert engines[0].summary() == engines[1].summary()
    texts = []
    for m, module in zip(engines, (port_station, jax_station)):
        import io

        f = io.StringIO()
        module.write_station_log(f, m, "args")
        texts.append(f.getvalue())
    assert texts[0] == texts[1] and "station model n_obs:" in texts[0]


def test_evaluate_by_station_matches_jax(tree):
    _, paths = tree
    data = dict(input_dim=INPUT_DIM, output_dim=OUTPUT_DIM,
                prev_len=PREV_LEN, feat_dim=12,
                data_path=paths["data_path"],
                sim_data_path=paths["sim_data_path"],
                analysis_data_path=paths["analysis_data_path"])
    cfg = JaxConfig(window_size=INPUT_DIM + OUTPUT_DIM, n_variables=24,
                    n_start_channels=HIDDEN, end_lead_time=OUTPUT_DIM,
                    pm25_mean=22.5, pm25_std=15.5, n_heads=4, dim_head=4)
    params = metnet3_init(jax.random.PRNGKey(5), cfg)
    ref = jax_station.evaluate_by_station(
        params, cfg, JaxDataConfig(grid=JaxGridConfig(), **data),
        test_start=START, test_end=END, batch_size=BATCH)
    timing = BatchTiming()
    model = params_from_jax(params, MetNet3Config(**dataclasses.asdict(cfg)))
    ours = port_station.evaluate_by_station(
        model, DataConfig(**data), test_start=START, test_end=END,
        batch_size=BATCH, device="cpu", timing=timing)
    assert timing.samples == [4, 4, 3]
    _assert_summaries_close(ours.summary(), ref.summary())


def _argv(paths, log_dir, pkt, *extra):
    return ["--seed", "0", "--batch_size", str(BATCH), "--gpus", "cpu",
            "--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"],
            "--model_name", NAME, "--hidden_dim", str(HIDDEN),
            "--output_dim", str(OUTPUT_DIM), "--input_dim", str(INPUT_DIM),
            "--prev_len", str(PREV_LEN), "--checkpoint", pkt,
            "--num_workers", "2",
            "--test_start", START.strftime("%Y-%m-%dT%H"),
            "--test_end", END.strftime("%Y-%m-%dT%H"),
            "--log_dir", str(log_dir), *extra]


@pytest.fixture(scope="module")
def pkt(tree):
    """Twin weights for the CLIs, which build the default 32 heads x 32."""
    root, _ = tree
    cfg = JaxConfig(window_size=INPUT_DIM + OUTPUT_DIM, n_variables=24,
                    n_start_channels=HIDDEN, end_lead_time=OUTPUT_DIM)
    path = str(root / f"{NAME}.pkt")
    save_torch_checkpoint(metnet3_init(jax.random.PRNGKey(6), cfg), cfg,
                          path)
    return path


_VALUE = re.compile(r"^(station model [^:]+): (\S+)$")


def test_station_cli_matches_jax(tree, pkt):
    from vit_grid_model_tpu.cli import station_eval as jax_cli
    from vit_grid_model_tpu_torch.cli import station_eval as port_cli

    root, paths = tree
    jax_cli.main(_argv(paths, root / "logs_jax", pkt))
    metrics = port_cli.main(_argv(paths, root / "logs_port", pkt))
    logs = []
    for d in ("logs_jax", "logs_port"):
        with open(root / d / f"test_{NAME}_by_stn.log") as f:
            logs.append(f.read().splitlines())
    ref, ours = logs
    assert len(ours) == len(ref) == 9
    assert ours[0].replace("logs_port", "LOGS") == \
        ref[0].replace("logs_jax", "LOGS")
    for a, b in zip(ref[1:], ours[1:]):
        ma, mb = _VALUE.match(a), _VALUE.match(b)
        assert ma and mb and ma.group(1) == mb.group(1), (a, b)
        if ma.group(1) == "station model n_obs":
            assert a == b
        else:
            assert re.fullmatch(r"-?\d+\.\d{4}", mb.group(2)), b
            assert abs(float(ma.group(2)) - float(mb.group(2))) <= ABS_TOL
    assert metrics.summary()["n_obs"] == int(ref[-1].split()[-1]) > 0


def test_station_cli_refusals(tree, tmp_path, monkeypatch):
    from vit_grid_model_tpu_torch.cli import station_eval as port_cli

    _, paths = tree
    argv = _argv(paths, tmp_path / "logs", "unused.pkt")
    with pytest.raises(SystemExit, match="collect_valid_times"):
        port_cli.main(argv + ["--collect_valid_times"])
    with pytest.raises(ValueError, match="data_parallel"):
        port_cli.main(argv + ["--data_parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    no_gpus_flag = [a for i, a in enumerate(argv)
                    if a != "--gpus" and (i == 0 or argv[i - 1] != "--gpus")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(no_gpus_flag)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_station.evaluate_by_station(
            None, None, test_start=START, test_end=END)
    assert not os.path.exists(tmp_path / "logs")


def test_collect_valid_times_matches_jax(tree, pkt, monkeypatch):
    """Both evaluation CLIs with --collect_valid_times over a window whose
    sample hours include 06: the collected times are equal element for
    element, each an encoded YYYYMMDDHH with hour 06."""
    from vit_grid_model_tpu.cli import evaluation_vit as jax_cli
    from vit_grid_model_tpu.evaluation import driver as jax_driver
    from vit_grid_model_tpu_torch.cli import evaluation_vit as port_cli

    root, paths = tree
    captured = []
    evaluate = jax_driver.evaluate

    def capture(*args, **kwargs):
        captured.append(evaluate(*args, **kwargs))
        return captured[-1]

    monkeypatch.setattr(jax_driver, "evaluate", capture)
    jax_cli.main(_argv(paths, root / "vt_jax", pkt, "--collect_valid_times"))
    ours = port_cli.main(_argv(paths, root / "vt_port", pkt,
                               "--collect_valid_times")).valid_times
    ref = captured[0].valid_times
    assert len(ours) == len(ref) == 3               # one entry a batch
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype == np.int64
        np.testing.assert_array_equal(a, b)
    flat = np.concatenate(ours)
    assert flat.tolist() == [2023040106]
