"""The port's own host code against the JAX package's originals: configs,
the eval, generation and station CLIs' parsers, the state-dict exporters
(MetNet3's, the legacy station and grid models' and SimVP's),
the synthetic tree (also with its station keywords), the CLIs' three
datasets (the station one too) and ``BatchLoader``, ``device_prefetch``,
the assembly (with the host bf16 cast and the masked classes),
``pad_to_multiple``, the native loader and the metric engine with its log
writer.  The other eight datasets, their host helpers, the native
bindings, the fault hook and ``model_input_to_nhwc`` are held in
``tests/test_torch_port_datasets.py``.  Exact (bit- or
byte-equal) unless stated; the native loader is held to the numpy path at
rtol 1e-6, as ``tests/test_native_loader.py`` holds the JAX package's."""

import argparse
import dataclasses
import io
import os
from datetime import datetime

import numpy as np
import pytest

import torch

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.cli import evaluation_vit as jax_cli
from vit_grid_model_tpu.cli import generate_reanalysis as jax_gen_cli
from vit_grid_model_tpu.cli import station_eval as jax_stn_cli
from vit_grid_model_tpu.core import config as jax_config
from vit_grid_model_tpu.core import torch_export as jax_exporters
from vit_grid_model_tpu.core.torch_export import (
    export_metnet3_state_dict as jax_export)
from vit_grid_model_tpu.data import assembly as jax_assembly
from vit_grid_model_tpu.data import datasets as jax_datasets
from vit_grid_model_tpu.data import pipeline as jax_pipeline
from vit_grid_model_tpu.data import readers as jax_readers
from vit_grid_model_tpu.data import synthetic as jax_synthetic
from vit_grid_model_tpu.evaluation import logwriter as jax_logwriter
from vit_grid_model_tpu.evaluation import metrics as jax_metrics
from vit_grid_model_tpu.models import simvp as jax_simvp
from vit_grid_model_tpu.models.legacy import grid as jax_grid
from vit_grid_model_tpu.models.legacy import station as jax_station
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu.parallel import mesh as jax_mesh
from vit_grid_model_tpu_torch.cli import evaluation_vit as port_cli
from vit_grid_model_tpu_torch.cli import generate_reanalysis as port_gen_cli
from vit_grid_model_tpu_torch.cli import station_eval as port_stn_cli
from vit_grid_model_tpu_torch.core import config as port_config
from vit_grid_model_tpu_torch.core import export as port_exporters
from vit_grid_model_tpu_torch.core.export import (
    export_metnet3_state_dict as port_export)
from vit_grid_model_tpu_torch.data import assembly as port_assembly
from vit_grid_model_tpu_torch.data import datasets as port_datasets
from vit_grid_model_tpu_torch.data import native as port_native
from vit_grid_model_tpu_torch.data import pipeline as port_pipeline
from vit_grid_model_tpu_torch.data import readers as port_readers
from vit_grid_model_tpu_torch.data import synthetic as port_synthetic
from vit_grid_model_tpu_torch.data import timeutil as port_timeutil
from vit_grid_model_tpu_torch.evaluation import driver as port_driver
from vit_grid_model_tpu_torch.evaluation import logwriter as port_logwriter
from vit_grid_model_tpu_torch.evaluation import metrics as port_metrics
from vit_grid_model_tpu_torch.parallel import mesh as port_mesh

START, END = datetime(2023, 2, 1, 0), datetime(2023, 2, 1, 9)
INPUT_DIM, OUTPUT_DIM, PREV_LEN = 2, 2, 3


def _fields(cls):
    """(name, default, default factory) per field; a default that is
    itself a config compares by its fields."""
    def value(v):
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    return [(f.name, value(f.default), f.default_factory) for f in
            dataclasses.fields(cls)]


@pytest.mark.parametrize("name", ["GridConfig", "MetNet3Config",
                                  "DataConfig", "TrainConfig"])
def test_config_fields_and_defaults_match(name):
    ours, ref = getattr(port_config, name), getattr(jax_config, name)
    assert _fields(ours) == _fields(ref)
    assert dataclasses.asdict(ours()) == dataclasses.asdict(ref())


def test_config_validation_and_shipped_config_match():
    for cfg in (port_config, jax_config):
        with pytest.raises(ValueError):
            cfg.MetNet3Config(use_pallas_attention_bwd=True)
    assert dataclasses.asdict(
        port_config.shipped_12hr_model_config(22.5, 15.5)) == \
        dataclasses.asdict(jax_config.shipped_12hr_model_config(22.5, 15.5))


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type,
                     a.choices, a.nargs, a.const, a.required)
            for a in parser._actions}


def test_eval_parser_options_and_defaults_match():
    assert _options(port_cli.build_parser()) == _options(
        jax_cli.build_parser())


def test_station_parser_options_and_defaults_match():
    ours, ref = port_stn_cli.build_parser(), jax_stn_cli.build_parser()
    assert _options(ours) == _options(ref)
    assert ours.description == ref.description


class _Parser(Exception):
    pass


def test_generate_parser_options_and_defaults_match(monkeypatch):
    """The JAX CLI builds its parser inside ``main``: it is caught at
    ``parse_args``.  The port adds ``--gpus`` (default "0") only."""
    def catch(self, args=None, namespace=None):
        raise _Parser(self)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parser) as caught:
        jax_gen_cli.main([])
    monkeypatch.undo()
    ref = caught.value.args[0]
    ours = port_gen_cli.build_parser()
    options = _options(ours)
    assert options.pop("gpus") == (("--gpus",), "0", str, None, None, None,
                                   False)
    assert options == _options(ref)
    assert ours.description == ref.description


@pytest.mark.parametrize("depth", [(1,), (2,)])
def test_exporter_bit_equal(depth):
    cfg = jax_config.MetNet3Config(
        window_size=3, n_variables=4, n_start_channels=8, end_lead_time=2,
        input_height=14, input_width=14, n_heads=2, dim_head=4,
        vit_block_depth=depth)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    ref = jax_export(params, cfg)
    ours = port_export(params, port_config.MetNet3Config(
        **dataclasses.asdict(cfg)))
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert np.array_equal(ours[k], v), k


def _numpy_tree(init, seed):
    """A tree shaped as ``init(key)`` returns it, drawn with numpy."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(init, jax.random.PRNGKey(0))
    return jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(np.float32), shapes)


_LEGACY = dict(input_dim=3, feat_dim=12, hidden_dim=32, pm25_mean=20.0,
               pm25_std=10.0, output_dim=2, prev_len=3, korea_stn_num=4,
               china_stn_num=2)


@pytest.mark.parametrize("name,case", [
    ("station", ("multiair", "RevIN")), ("station", ("multiair", "DishTS")),
    ("station", ("multiair", "Standard")),
    ("station", ("simulation", "RevIN")),
    ("station", ("simulation_avg", "RevIN")), ("station", ("wo", "RevIN")),
    ("grid", (1, "Standard")), ("grid", (2, "Standard")),
    ("grid", (3, "Standard")), ("grid", (3, "RevIN")),
    ("grid", (3, "DishTS")),
    ("simvp", ((2, 2, 8, 8), 2, 2)), ("simvp", ((3, 2, 16, 16), 4, 3))])
def test_legacy_exporters_bit_equal(name, case):
    coords = np.arange(6.0)
    if name == "station":
        variant, method = case
        spec = jax_station.StationModelSpec(
            **_LEGACY, normalization_method=method, variant=variant)
        params = _numpy_tree(lambda k: jax_station.station_model_init(
            k, spec, coords, coords), 1)
        args = ("export_station_model", params, variant)
    elif name == "grid":
        version, method = case
        spec = jax_grid.GridModelSpec(
            **_LEGACY, grid_shape=(6, 5), normalization_method=method,
            version=version)
        params = _numpy_tree(lambda k: jax_grid.grid_model_init(
            k, spec, coords, coords, np.zeros((6, 5, 2))), 2)
        args = ("export_grid_model", params, version)
    else:
        shape_in, n_s, n_t = case
        spec = jax_simvp.SimVPSpec(shape_in=shape_in, hid_s=4, hid_t=8,
                                   n_s=n_s, n_t=n_t, groups=2)
        params = _numpy_tree(lambda k: jax_simvp.simvp_init(k, spec), 3)
        args = ("export_simvp", params, n_s, n_t)
    ref = getattr(jax_exporters, args[0])(*args[1:])
    ours = getattr(port_exporters, args[0])(*args[1:])
    assert list(ours) == list(ref)
    for k, v in ref.items():
        assert ours[k].dtype == v.dtype and ours[k].shape == v.shape, k
        assert np.array_equal(ours[k], v), k


def _generate(pkg, root):
    return pkg.generate_tree(str(root), START, END, prev_len=PREV_LEN,
                             output_dim=OUTPUT_DIM)


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


@pytest.fixture(scope="module")
def trees(tmp_path_factory):
    """The same window written by both packages' generators."""
    root = tmp_path_factory.mktemp("host")
    paths = {"jax": _generate(jax_synthetic, root / "jax"),
             "port": _generate(port_synthetic, root / "port")}
    jax_readers.clear_caches()
    port_readers.clear_caches()
    return root, paths


def test_synthetic_tree_byte_identical(trees):
    root, _ = trees
    ref, ours = _files(root / "jax"), _files(root / "port")
    assert sorted(ours) == sorted(ref) and len(ref) > 50
    for k in ref:
        assert ours[k] == ref[k], k


def test_synthetic_tree_with_station_keywords_byte_identical(tmp_path):
    kw = dict(prev_len=PREV_LEN, output_dim=OUTPUT_DIM, korea_stn_num=6,
              china_stn_num=2, feat_dim=8)
    for name, pkg in (("jax", jax_synthetic), ("port", port_synthetic)):
        pkg.generate_tree(str(tmp_path / name), START, START, **kw)
    ref, ours = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(ours) == sorted(ref) and len(ref) > 10
    for k in ref:
        assert ours[k] == ref[k], k
    obs = [k for k in ref if k.endswith(".npy") and "ground_obs" in k]
    assert obs and np.load(tmp_path / "port" / obs[0]).shape == (8, 9)


def _dataset(module, cls, paths, use_native=None):
    data_path = paths["data_path"]
    times = port_timeutil.eval_time_list(START, END, PREV_LEN, OUTPUT_DIM)
    stations = port_driver.load_stations(data_path)
    feats, masks = port_driver.load_ground_obs(data_path, times,
                                               stations.total, 12)
    ds = getattr(module, cls)(
        times, feats, masks, input_dim=INPUT_DIM, output_dim=OUTPUT_DIM,
        prev_len=PREV_LEN, korea_stn_num=stations.korea_stn_num,
        china_stn_num=stations.china_stn_num, cmaq_size=(82, 67),
        sim_data_path=paths["sim_data_path"],
        reanalysis_data_path=paths["analysis_data_path"],
        feat_infos=port_driver.load_feat_infos(data_path))
    if use_native is not None:
        ds.use_native = use_native
    return ds


def _assert_batches_equal(ours, ref):
    assert len(ours) == len(ref)
    for a, b in zip(ours, ref):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("cls", ["AirSimulationReanalysisDatasetOnly",
                                 "AirSimulationReanalysisDatasetV3"])
@pytest.mark.parametrize("shuffle", [False, True, "batches", "buffer"])
def test_batch_loader_yields_the_same_batches(trees, cls, shuffle):
    """Both loaders over their own package's dataset, same seed, two
    epochs: the same batches in the same order."""
    _, paths = trees

    def run(pipeline, datasets):
        loader = pipeline.BatchLoader(
            _dataset(datasets, cls, paths["port"]), batch_size=3,
            shuffle=shuffle, seed=5, num_workers=2, shuffle_buffer=2)
        return [tuple(np.array(f) for f in b)
                for _ in range(2) for b in loader]

    _assert_batches_equal(run(port_pipeline, port_datasets),
                          run(jax_pipeline, jax_datasets))


def test_assembly_outputs_equal(trees):
    _, paths = trees
    times = port_timeutil.eval_time_list(START, END, PREV_LEN, OUTPUT_DIM)
    kw = dict(input_dim=INPUT_DIM, output_dim=OUTPUT_DIM, prev_len=PREV_LEN,
              sim_data_path=paths["port"]["sim_data_path"],
              feat_infos=port_synthetic.DEFAULT_FEAT_INFOS, n_species=6,
              grid_shape=(82, 67))
    for ours, ref in zip(
            port_assembly.assemble_simulation(times, 4, 2, **kw),
            jax_assembly.assemble_simulation(times, 4, 2, **kw)):
        np.testing.assert_array_equal(ours, ref)
    rkw = dict(output_dim=OUTPUT_DIM, grid_shape=(82, 67),
               reanalysis_data_path=paths["port"]["analysis_data_path"])
    for ours, ref in zip(port_assembly.read_reanalysis_window(times, 4, **rkw),
                         jax_assembly.read_reanalysis_window(times, 4, **rkw)):
        np.testing.assert_array_equal(ours, ref)
    stack = np.random.default_rng(0).random((2, 9, 8, 3 * 28)).astype(
        np.float32)
    np.testing.assert_array_equal(
        port_assembly.sim_stack_to_model_input(stack, 3),
        jax_assembly.sim_stack_to_model_input(stack, 3))
    np.testing.assert_array_equal(
        port_assembly.sim_stack_to_nhwc_input(stack, 3, 7),
        jax_assembly.sim_stack_to_nhwc_input(stack, 3, 7))


def test_native_loader_matches_numpy(trees):
    """The port's C++ loader, built from its own copy of the source into
    build/, against the numpy path: samples, collated batches and the
    repacks."""
    assert port_native.available()
    assert port_native.LIBRARY.parent.name == "native"
    _, paths = trees
    cls = "AirSimulationReanalysisDatasetV3"
    fast = _dataset(port_datasets, cls, paths["port"], use_native=True)
    slow = _dataset(port_datasets, cls, paths["port"], use_native=False)
    for i in (0, len(fast) - 1):
        for a, b in zip(fast[i], slow[i]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    batch = fast.get_batch_collated([1, 2, 3])
    ref = slow.collate([slow[i] for i in (1, 2, 3)])
    for a, b in zip(batch, ref):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
    stack = np.random.default_rng(1).random((2, 9, 8, 3 * 28)).astype(
        np.float32)
    out = np.empty((2, 3, 24, 9, 8), np.float32)
    assert port_native.repack_model_input_native(stack, 3, out)
    np.testing.assert_array_equal(
        out, stack.reshape(2, 9, 8, 3, 28).transpose(0, 3, 4, 1, 2)[:, :, :24])


def test_metrics_and_log_text_equal():
    """Two updates with NaN-class truth cells and a ragged batch: the same
    summary and the same log text."""
    rng = np.random.default_rng(2)
    L, cells = 3, 40
    engines = [port_metrics.EvaluationMetrics(L),
               jax_metrics.EvaluationMetrics(L)]
    for b in (4, 2):
        truth = (rng.random((b, L, cells)) * 90).astype(np.float32)
        truth_cls = jax_assembly.assign_class(truth).astype(np.int32)
        truth_cls[0, 0, :3] = -1
        preds = {k: (rng.random((b, L, cells)) * 90).astype(np.float32)
                 for k in ("model", "persist", "sim_21h", "sim_avg")}
        for m in engines:
            m.update(truth=truth, truth_cls=truth_cls, **preds)
    texts = []
    for m, writer in zip(engines, (port_logwriter, jax_logwriter)):
        f = io.StringIO()
        writer.write_log(f, m, "args")
        texts.append(f.getvalue())
    assert texts[0] == texts[1] and "MultiAir CSI:" in texts[0]
    assert engines[0].summary() == engines[1].summary()


def test_by_stn_dataset_items_equal(trees):
    """The station dataset, item by item and through the loader's batches;
    its validity flag is not inverted, so ``stn_cls`` is -1 at exactly
    the valid stations (both reference quirks kept)."""
    _, paths = trees
    cls = "AirSimulationReanalysisDatasetByStn"
    assert port_datasets.Air_Simulation_Reanalysis_Dataset_by_stn is \
        port_datasets.AirSimulationReanalysisDatasetByStn
    ours = _dataset(port_datasets, cls, paths["port"])
    ref = _dataset(jax_datasets, cls, paths["port"])
    assert len(ours) == len(ref) > 0
    for i in range(len(ref)):
        a, b = ours[i], ref[i]
        assert len(a) == len(b) == 11
        for x, y in zip(a, b):
            assert x.dtype == y.dtype and x.shape == y.shape
            np.testing.assert_array_equal(x, y)
        mask, stn_cls = a[9], a[10]
        assert (stn_cls[~mask] == -1).all()
    _assert_batches_equal(
        [tuple(np.array(f) for f in batch)
         for batch in port_pipeline.BatchLoader(ours, batch_size=3)],
        [tuple(np.array(f) for f in batch)
         for batch in jax_pipeline.BatchLoader(ref, batch_size=3)])


@pytest.mark.parametrize("pipeline", [port_pipeline, jax_pipeline])
def test_device_prefetch_order_and_laziness(pipeline):
    """Nothing is staged before the first request; batch k+1 is staged
    before batch k is yielded; the order is kept."""
    puts = []

    def put(b):
        puts.append(b)
        return b * 10

    gen = pipeline.device_prefetch(iter([1, 2, 3]), put)
    assert puts == []
    assert next(gen) == 10 and puts == [1, 2]
    assert list(gen) == [20, 30] and puts == [1, 2, 3]
    assert list(pipeline.device_prefetch(iter([]), put)) == []


def _bf16_bits(t):
    return t.view(torch.int16).numpy().view(np.uint16)


def test_host_stage_dtype_bit_equal_and_pooled():
    """bf16: a torch tensor whose bits are the JAX package's ml_dtypes cast
    (round to nearest even, ties and subnormals included); f32: the input
    itself.  A pooled tensor still held, or viewed, is not handed out
    again; a released one is."""
    rng = np.random.default_rng(3)
    bits = (rng.integers(0, 2 ** 16, 2 * 3 * 5 * 7, dtype=np.uint32) << 16
            | 0x8000).astype(np.uint32)           # exact ties
    x = (rng.standard_normal(bits.size) * 100).astype(np.float32)
    x[::2] = np.where(np.isfinite(bits.view(np.float32)),
                      bits.view(np.float32), 1.0)[::2]
    x[:6] = [np.inf, -np.inf, 0.0, -0.0, 1e-40, -3e38]
    x = x.reshape(2, 3, 5, 7)
    ref = jax_assembly.host_stage_dtype(x, "bfloat16")
    ours = port_assembly.host_stage_dtype(x, "bfloat16")
    assert isinstance(ours, torch.Tensor) and ours.dtype == torch.bfloat16
    assert tuple(ours.shape) == x.shape
    np.testing.assert_array_equal(_bf16_bits(ours),
                                  np.asarray(ref).view(np.uint16))
    for module in (port_assembly, jax_assembly):
        assert module.host_stage_dtype(x, "float32") is x
    view = ours[0]
    again = port_assembly.host_stage_dtype(x, "bfloat16")
    del ours
    held = {view._base.data_ptr(), again.data_ptr()}
    third = port_assembly.host_stage_dtype(x, "bfloat16")
    assert len(held) == 2 and third.data_ptr() not in held
    ptr = third.data_ptr()
    del third
    assert port_assembly.host_stage_dtype(x, "bfloat16").data_ptr() == ptr


@pytest.mark.parametrize("rows", [3, 4, 5])
def test_pad_to_multiple_equal(rows):
    """Padding by repeating the last sample, over a tuple, a dict and a
    nested list, with the real count of the first leaf in JAX's order."""
    rng = np.random.default_rng(rows)
    x = rng.random((rows, 2, 3)).astype(np.float32)
    t = rng.random((rows, 4)).astype(np.float32)
    for batch in ((x, t), {"x": x, "t": t}, [x, (t,)]):
        ours, n = port_mesh.pad_to_multiple(batch, 4)
        ref, m = jax_mesh.pad_to_multiple(batch, 4)
        assert n == m == rows
        assert jax.tree.structure(ours) == jax.tree.structure(ref)
        for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
            assert a.shape[0] == (8 if rows > 4 else 4)
            np.testing.assert_array_equal(a, np.asarray(b))


def test_assign_class_masked_equal():
    rng = np.random.default_rng(8)
    vals = (rng.random((3, 2, 6)) * 100).astype(np.float32)
    vals[0, 0, :2] = np.nan
    mask = rng.random((3, 2, 6)) < 0.7
    ours = port_assembly.assign_class_masked(vals, mask)
    ref = jax_assembly.assign_class_masked(vals, mask)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)
    assert (ours[~mask] == -1).all()
