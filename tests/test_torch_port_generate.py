"""Generation head to head: the port's ``generate_reanalysis`` and its CLI
against the JAX package's on one synthetic data tree, on the CPU, with twin
weights (``params_from_jax`` for the library, a reference ``.pkt`` saved
once for the CLIs).  Small size: window 7 (the time conditioning reads
timestamp row 6), hidden 16, 4 heads x 4, 2 leads.

The window holds 11 sample hours: batches of 4, 4 and a ragged 3, which
both packages pad to 4 by repeating the last sample (the batch-mixing time
conditioning makes the real samples depend on the pad).  Both write the
same set of file names, and each field agrees within 1e-4 x max|jax field|
(f32; the two frameworks sum in other orders)."""

import dataclasses
import os
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
from vit_grid_model_tpu.evaluation.generate import (
    generate_reanalysis as jax_generate)
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu_torch.core.config import DataConfig, MetNet3Config
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.data import readers as port_readers
from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
from vit_grid_model_tpu_torch.evaluation.generate import generate_reanalysis

START, END = datetime(2023, 3, 1, 0), datetime(2023, 3, 1, 10)
INPUT_DIM, OUTPUT_DIM, PREV_LEN, HIDDEN, BATCH = 5, 2, 5, 16, 4
N_SAMPLES = 11
REL_TOL = 1e-4


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("port_gen")
    paths = synthetic.generate_tree(
        str(root / "tree"), START, END, prev_len=PREV_LEN,
        output_dim=OUTPUT_DIM, korea_stn_num=6, china_stn_num=2)
    readers.clear_caches()
    port_readers.clear_caches()
    return root, paths


def _cfgs(paths):
    data = dict(input_dim=INPUT_DIM, output_dim=OUTPUT_DIM,
                prev_len=PREV_LEN, feat_dim=12,
                data_path=paths["data_path"],
                sim_data_path=paths["sim_data_path"],
                analysis_data_path=paths["analysis_data_path"])
    model = JaxConfig(window_size=INPUT_DIM + OUTPUT_DIM, n_variables=24,
                      n_start_channels=HIDDEN, end_lead_time=OUTPUT_DIM,
                      pm25_mean=22.5, pm25_std=15.5, n_heads=4, dim_head=4)
    return JaxDataConfig(grid=JaxGridConfig(), **data), DataConfig(**data), \
        model


def _params(cfg):
    return metnet3_init(jax.random.PRNGKey(11), cfg)


def _assert_same_fields(ref_dir, port_dir):
    names = sorted(os.listdir(ref_dir))
    assert names == sorted(os.listdir(port_dir))
    assert len(names) == N_SAMPLES * OUTPUT_DIM
    for name in names:
        ref = np.load(os.path.join(ref_dir, name))
        ours = np.load(os.path.join(port_dir, name))
        assert ours.dtype == np.float32 and ours.shape == ref.shape == (82, 67)
        err = np.abs(ours - ref).max()
        assert err <= REL_TOL * np.abs(ref).max(), (name, err)


def test_generate_matches_jax(tree):
    root, paths = tree
    jax_data, port_data, cfg = _cfgs(paths)
    params = _params(cfg)
    n_ref = jax_generate(params, cfg, jax_data, start=START, end=END,
                         out_dir=str(root / "lib_jax"), batch_size=BATCH,
                         progress=False)
    timing = BatchTiming()
    model = params_from_jax(params, MetNet3Config(**dataclasses.asdict(cfg)))
    n = generate_reanalysis(model, port_data, start=START, end=END,
                            out_dir=str(root / "lib_port"),
                            batch_size=BATCH, device="cpu", progress=False,
                            timing=timing)
    assert n == n_ref == N_SAMPLES * OUTPUT_DIM
    assert timing.samples == [4, 4, 3]
    _assert_same_fields(root / "lib_jax", root / "lib_port")


def _cli_argv(paths, out_dir, pkt):
    return ["--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"],
            "--input_dim", str(INPUT_DIM), "--output_dim", str(OUTPUT_DIM),
            "--prev_len", str(PREV_LEN), "--hidden_dim", str(HIDDEN),
            "--batch_size", str(BATCH), "--compute_dtype", "float32",
            "--start", START.strftime("%Y-%m-%dT%H"),
            "--end", END.strftime("%Y-%m-%dT%H"),
            "--out_dir", str(out_dir), "--checkpoint", pkt]


def test_generate_cli_matches_jax(tree):
    """Both CLIs load one reference .pkt; the port's runs with its default
    --data_parallel -1, which resolves to the one CPU."""
    from vit_grid_model_tpu.cli import generate_reanalysis as jax_cli
    from vit_grid_model_tpu_torch.cli import generate_reanalysis as port_cli

    root, paths = tree
    _, _, cfg = _cfgs(paths)
    # the CLIs build the default 32 heads x 32
    cfg = dataclasses.replace(cfg, n_heads=32, dim_head=32)
    pkt = str(root / "gen.pkt")
    save_torch_checkpoint(_params(cfg), cfg, pkt)
    jax_cli.main(_cli_argv(paths, root / "cli_jax", pkt)
                 + ["--data_parallel", "1"])
    n = port_cli.main(_cli_argv(paths, root / "cli_port", pkt)
                      + ["--gpus", "cpu"])
    assert n == N_SAMPLES * OUTPUT_DIM
    _assert_same_fields(root / "cli_jax", root / "cli_port")


def test_generate_cli_refusals(tree, tmp_path, monkeypatch):
    """--data_parallel resolving to more than one device raises, and so
    does a run without CUDA that does not ask for the CPU."""
    from vit_grid_model_tpu_torch.cli import generate_reanalysis as port_cli

    _, paths = tree
    argv = _cli_argv(paths, tmp_path / "out", "unused.pkt")[:-2]
    with pytest.raises(ValueError, match="data_parallel"):
        port_cli.main(argv + ["--gpus", "cpu", "--data_parallel", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(ValueError, match="resolves to 2 devices"):
        port_cli.main(argv + ["--gpus", "0"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        port_cli.main(argv)
    assert not os.path.exists(tmp_path / "out")


def test_generate_needs_cuda_unless_asked_for_the_cpu(tree, tmp_path,
                                                      monkeypatch):
    root, paths = tree
    _, port_data, cfg = _cfgs(paths)
    model = params_from_jax(_params(cfg),
                            MetNet3Config(**dataclasses.asdict(cfg)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate_reanalysis(model, port_data, start=START, end=END,
                            out_dir=str(tmp_path / "out"))
