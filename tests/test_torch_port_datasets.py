"""The port's copies of the JAX package's remaining data code against the
originals: the eight legacy datasets on their windowed base (six in
memory, the output-window-only V2 and the station-image variant), their
batches through both packages' ``BatchLoader`` with and without the native
plane, the host helpers (``raw_time_rows``, the output-only assembly,
``assign_class``'s default, ``load_reanalysis_day``'s variable, the
station images), the native bindings (``load_cycle_files_native``, the
loud-failure count) and the fault hook, ``model_input_to_nhwc`` in f32 and
bf16, and the station-image MetNet3 (25 channels, ``stn_img_channel`` 24)
on the standard and NHWC paths.  Exact (bit- or byte-equal) unless
stated."""

import dataclasses
import os
from datetime import datetime

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.data import assembly as jax_assembly
from vit_grid_model_tpu.data import datasets as jax_datasets
from vit_grid_model_tpu.data import native as jax_native
from vit_grid_model_tpu.data import pipeline as jax_pipeline
from vit_grid_model_tpu.data import readers as jax_readers
from vit_grid_model_tpu.data import synthetic as jax_synthetic
from vit_grid_model_tpu.data import timeutil as jax_timeutil
from vit_grid_model_tpu.models.metnet3 import metnet3_apply, metnet3_init
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.data import assembly as port_assembly
from vit_grid_model_tpu_torch.data import datasets as port_datasets
from vit_grid_model_tpu_torch.data import native as port_native
from vit_grid_model_tpu_torch.data import pipeline as port_pipeline
from vit_grid_model_tpu_torch.data import readers as port_readers
from vit_grid_model_tpu_torch.data import synthetic as port_synthetic
from vit_grid_model_tpu_torch.data import timeutil as port_timeutil

START, END = datetime(2023, 1, 10, 0), datetime(2023, 1, 10, 6)
DIMS = dict(input_dim=3, output_dim=2, prev_len=4, korea_stn_num=8,
            china_stn_num=3)
GRID = (82, 67)
TIMES = port_timeutil.eval_time_list(START, END, DIMS["prev_len"],
                                     DIMS["output_dim"])

# each class with the reference's name for it
CLASSES = {
    "AirWithFixedSatDataset": "Air_with_fixed_Sat_Dataset",
    "AirWithSimulationDataset": "Air_with_Simulation_Dataset",
    "AirOnlyDataset": "Air_only_Dataset",
    "AirWithSimulationDatasetV2": "Air_with_Simulation_Dataset_v2",
    "AirSimulationReanalysisDataset": "Air_Simulation_Reanalysis_Dataset",
    "AirSimulationReanalysisDatasetWithCurr":
        "Air_Simulation_Reanalysis_Dataset_w_curr",
    "AirSimulationReanalysisDatasetV2": "Air_Simulation_Reanalysis_Dataset_v2",
    "AirSimulationReanalysisDatasetWithStationImgs":
        "Air_Simulation_Reanalysis_Dataset_with_station_imgs",
}
LAZY = ("AirSimulationReanalysisDatasetV2",
        "AirSimulationReanalysisDatasetWithStationImgs")


def _clear_caches():
    jax_readers.clear_caches()
    port_readers.clear_caches()


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """One synthetic tree with the station images over its window."""
    root = tmp_path_factory.mktemp("datasets")
    paths = port_synthetic.generate_tree(
        str(root), START, END, prev_len=DIMS["prev_len"],
        output_dim=DIMS["output_dim"], korea_stn_num=8, china_stn_num=3)
    port_synthetic.write_station_images(paths["data_path"], TIMES,
                                        output_dim=DIMS["output_dim"])
    _clear_caches()
    return paths


def _arrays():
    """Seeded station features with a non-trivial validity flag in column
    6, so that the inverted flag shows, and the in-memory tensors."""
    rng = np.random.default_rng(7)
    t, stn = len(TIMES), 11
    feats = (rng.random((t, stn, 12)) * 60).astype(np.float32)
    feats[:, :, 6] = rng.integers(0, 2, (t, stn)).astype(np.float32)
    masks = rng.integers(0, 2, (t, stn)).astype(np.float64)
    return dict(
        feats=feats, masks=masks,
        sat_outputs=rng.random((t, stn, 2)).astype(np.float32),
        sat_inputs=rng.random((t, stn, 13)).astype(np.float32),
        simulation=rng.random((t, stn, 30)).astype(np.float32),
        simulation_pm=rng.random((t, stn)).astype(np.float32),
        # across the class edges, values <= -1 (class -1) included
        reanalysis=(rng.random((t,) + GRID) * 100 - 5).astype(np.float32))


def _build(module, name, paths, use_native=None):
    a = _arrays()
    cls = getattr(module, name)
    fm = (a["feats"], a["masks"])
    if name == "AirWithFixedSatDataset":
        ds = cls(TIMES, a["sat_outputs"], a["sat_inputs"], *fm, **DIMS)
    elif name == "AirWithSimulationDataset":
        ds = cls(TIMES, *fm, a["simulation"], **DIMS)
    elif name == "AirOnlyDataset":
        ds = cls(TIMES, *fm, **DIMS)
    elif name == "AirWithSimulationDatasetV2":
        ds = cls(TIMES, *fm, a["simulation"], a["simulation_pm"], **DIMS)
    elif name in ("AirSimulationReanalysisDataset",
                  "AirSimulationReanalysisDatasetWithCurr"):
        ds = cls(TIMES, *fm, a["simulation"], a["reanalysis"], **DIMS)
    else:
        kw = dict(cmaq_size=GRID, sim_data_path=paths["sim_data_path"],
                  reanalysis_data_path=paths["analysis_data_path"],
                  feat_infos=port_synthetic.DEFAULT_FEAT_INFOS, **DIMS)
        if name == "AirSimulationReanalysisDatasetWithStationImgs":
            kw["data_path"] = paths["data_path"]
        ds = cls(TIMES, *fm, **kw)
        if use_native is not None:
            ds.use_native = use_native
    return ds


def _assert_items_equal(ours, ref):
    assert len(ours) == len(ref) > 0
    for x, y in zip(ours, ref):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", list(CLASSES))
def test_dataset_items_equal(tree, name):
    """Every element of the tuple at the first and the last index: dtype,
    shape and value; the reference's name is an alias of the class."""
    assert getattr(port_datasets, CLASSES[name]) is getattr(port_datasets,
                                                            name)
    ours = _build(port_datasets, name, tree)
    ref = _build(jax_datasets, name, tree)
    assert len(ours) == len(ref) == 7
    for i in (0, len(ref) - 1):
        _assert_items_equal(ours[i], ref[i])
    if name in ("AirWithFixedSatDataset", "AirOnlyDataset"):
        # the mask is the inverse of column 6, which is neither all set
        # nor all clear
        vals, mask = ours[0][-4], ours[0][-3]
        flag = _arrays()["feats"][DIMS["prev_len"]:
                                  DIMS["prev_len"] + DIMS["output_dim"],
                                  :DIMS["korea_stn_num"], 6].astype(bool)
        np.testing.assert_array_equal(mask, ~flag)
        assert 0 < mask.sum() < mask.size and vals.dtype == np.float32


@pytest.mark.parametrize("name", LAZY)
def test_loader_batches_equal_across_packages_and_native(tree, name):
    """Both packages' ``BatchLoader`` at batch 3 (3, 3 and a ragged 1),
    with the native plane (``use_native`` None) and without: four runs,
    the same batches."""
    runs = []
    for use_native in (None, False):
        for module, pipeline in ((port_datasets, port_pipeline),
                                 (jax_datasets, jax_pipeline)):
            _clear_caches()
            loader = pipeline.BatchLoader(
                _build(module, name, tree, use_native), batch_size=3,
                num_workers=2)
            runs.append([tuple(np.array(f) for f in b) for b in loader])
    assert [len(b[0]) for b in runs[0]] == [3, 3, 1]
    for run in runs[1:]:
        assert len(run) == len(runs[0])
        for ours, ref in zip(run, runs[0]):
            _assert_items_equal(ours, ref)


def test_v2_takes_no_union_assembly(tree, monkeypatch):
    """V2 assembles its own output window: neither batch path runs the
    native union assembly that the other lazy classes read, and the
    station-image class, which reads it, still does."""
    calls = []

    def union(*args, **kw):
        calls.append(args[0])
        return assemble(*args, **kw)

    assemble = port_native.assemble_steps_native
    monkeypatch.setattr(port_native, "assemble_steps_native", union)
    for name, want in zip(LAZY, (0, 1)):
        calls.clear()
        ds = _build(port_datasets, name, tree)
        assert ds.prefers_single_dispatch
        assert ds.get_batch_collated([0, 1, 2]) is None
        assert len(ds.get_batch([0, 1, 2])) == 3
        assert len(calls) == want, name


def test_host_helpers_equal(tree, tmp_path):
    m = 5
    assert (port_timeutil.raw_time_rows(TIMES, m, 3, 5)
            == jax_timeutil.raw_time_rows(TIMES, m, 3, 5))
    kw = dict(input_dim=3, output_dim=2, sim_data_path=tree["sim_data_path"],
              feat_infos=port_synthetic.DEFAULT_FEAT_INFOS, n_species=6,
              grid_shape=GRID)
    _assert_items_equal(
        [port_assembly.assemble_output_only_simulation(TIMES, m, **kw)],
        [jax_assembly.assemble_output_only_simulation(TIMES, m, **kw)])
    pm = np.array([np.nan, -3.0, -1.0, 0.0, 15.0, 15.5, 35.0, 75.0, 80.0],
                  np.float32)
    for default in (0, -1):
        _assert_items_equal([port_assembly.assign_class(pm, default=default)],
                            [jax_assembly.assign_class(pm, default=default)])
    assert port_assembly.assign_class(pm, default=0)[0] == 0
    assert port_assembly.assign_class(pm)[0] == -1

    # a day file with a second variable of another layer count
    from scipy.io import netcdf_file

    path = str(tmp_path / "day.nc")
    rng = np.random.default_rng(3)
    with netcdf_file(path, "w") as f:
        for dim, n in (("TSTEP", 24), ("LAY", 1), ("LAY2", 2), ("ROW", 5),
                       ("COL", 4)):
            f.createDimension(dim, n)
        f.createVariable("PM2P5", "f", ("TSTEP", "LAY", "ROW", "COL"))[:] = (
            rng.random((24, 1, 5, 4)))
        f.createVariable("O3", "f", ("TSTEP", "LAY2", "ROW", "COL"))[:] = (
            rng.random((24, 2, 5, 4)))
    for var in ("PM2P5", "O3"):
        _clear_caches()
        _assert_items_equal([port_readers.load_reanalysis_day(path, var=var)],
                            [jax_readers.load_reanalysis_day(path, var=var)])
    # the port caches by (path, var): the other variable is read afresh
    assert port_readers.load_reanalysis_day(path).shape == (24, 1, 5, 4)
    _clear_caches()


def _files(root):
    out = {}
    for d, _, names in os.walk(root):
        for n in names:
            path = os.path.join(d, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_station_images_byte_identical(tmp_path):
    for name, pkg in (("jax", jax_synthetic), ("port", port_synthetic)):
        pkg.write_station_images(str(tmp_path / name), TIMES[:3],
                                 output_dim=2)
    ref, ours = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(ours) == sorted(ref) and len(ref) == 12
    for k in ref:
        assert ours[k] == ref[k], k


def test_fault_hook_zero_fills_the_same_file(tree):
    """A cycle file dropped by the hook reads as a zero grid in both
    packages' numpy readers: the same sample, unlike the intact one."""
    name = "AirSimulationReanalysisDatasetV2"
    m = 3 + DIMS["prev_len"] - 1
    ref_t = jax_timeutil.cycle_refs(jax_timeutil.kst_to_utc(TIMES[m + 1]))[0]
    dropped = jax_timeutil.cmaq_file_name(tree["sim_data_path"], ref_t)
    assert os.path.exists(dropped)
    _clear_caches()
    intact = _build(port_datasets, name, tree, False)[3]
    samples = []
    try:
        for readers in (port_readers, jax_readers):
            readers.set_fault_injection(lambda p: p == dropped)
        for module in (port_datasets, jax_datasets):
            _clear_caches()
            samples.append(_build(module, name, tree, False)[3])
    finally:
        for readers in (port_readers, jax_readers):
            readers.set_fault_injection(None)
        _clear_caches()
    _assert_items_equal(samples[0], samples[1])
    sim, ref_sim = samples[0][2], intact[2]
    # cycle 0's PM2.5 plane of output hour 0 stays raw: zero when dropped
    assert (sim[:, :, 4] == 0).all() and (ref_sim[:, :, 4] != 0).any()
    np.testing.assert_array_equal(sim[:, :, 6:], ref_sim[:, :, 6:])


def test_native_bindings_match(tree, tmp_path, capfd):
    """``load_cycle_files_native`` against the numpy reader (rtol 1e-6, as
    tests/test_native_loader.py holds the JAX package's) and the JAX
    package's binding; the loud failures count 2 in both packages and
    ``reset_unsupported_count`` sets the count back to 0."""
    assert port_native.available() and jax_native.available()
    paths = [jax_timeutil.cmaq_file_name(tree["sim_data_path"], r)
             for t in TIMES[4:6]
             for r in jax_timeutil.cycle_refs(jax_timeutil.kst_to_utc(t))]
    paths.append(str(tmp_path / "missing.npy"))
    ours = port_native.load_cycle_files_native(paths, 6, GRID)
    _clear_caches()
    numpy_path = np.stack([port_readers.load_cmaq_npy(p, 6, GRID)
                           for p in paths])
    np.testing.assert_allclose(ours, numpy_path, rtol=1e-6)
    assert (ours[-1] == 0).all() and (ours[0] != 0).any()
    _assert_items_equal([ours], [jax_native.load_cycle_files_native(
        paths, 6, GRID)])

    rng = np.random.default_rng(2)
    wrong_shape = tmp_path / "wrong_shape.npy"
    np.save(wrong_shape, rng.random((6, 10, 10)).astype(np.float32))
    full = tmp_path / "full.npy"
    np.save(full, rng.random((6,) + GRID).astype(np.float32))
    truncated = tmp_path / "truncated.npy"
    truncated.write_bytes(full.read_bytes()[:-1000])
    loud = [str(wrong_shape), str(truncated)]
    for native in (port_native, jax_native):
        native.reset_unsupported_count()
        assert native.unsupported_count() == 0
        assert (native.load_cycle_files_native(loud, 6, GRID) == 0).all()
        assert native.unsupported_count() == 2
        native.reset_unsupported_count()
        assert native.unsupported_count() == 0
    err = capfd.readouterr().err
    assert err.count("wrong_shape.npy") == 2 and err.count("truncated") == 2
    _clear_caches()


def _bf16_bits(a):
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy().view(np.uint16)
    return np.asarray(a).view(np.uint16)


@pytest.mark.parametrize("channels", [24, 25])
def test_model_input_to_nhwc_bit_equal(channels):
    """f32: the port's staging equals JAX's, the border zero; bf16: the
    f32 staging through ``host_stage_dtype`` has the bits of JAX's bf16
    staging."""
    x = (np.random.default_rng(channels).standard_normal(
        (2, 3, channels, 18, 17)) * 30).astype(np.float32)
    ours = np.array(port_assembly.model_input_to_nhwc(x, 14))
    ref = np.array(jax_assembly.model_input_to_nhwc(x, 14))
    _assert_items_equal([ours], [ref])
    assert ours.shape == (2, 28, 28, 3 * channels)
    assert (ours[:, :5] == 0).all() and (ours[:, :, :5] == 0).all()
    bf16 = port_assembly.host_stage_dtype(
        port_assembly.model_input_to_nhwc(x, 14), "bfloat16")
    ref16 = np.array(jax_assembly.model_input_to_nhwc(x, 14, jnp.bfloat16))
    assert bf16.dtype == torch.bfloat16 and tuple(bf16.shape) == ref16.shape
    np.testing.assert_array_equal(_bf16_bits(bf16), _bf16_bits(ref16))


B, T, CS, H, W = 2, 3, 25, 18, 17
REL = 1e-4


def _stn_cfg(**kw):
    """The station-image variant at the small size of
    tests/test_torch_port_metnet3.py."""
    return MetNet3Config(window_size=T, n_variables=CS, stn_img_channel=CS - 1,
                         n_start_channels=16, end_lead_time=3,
                         input_height=H, input_width=W, pm25_mean=22.5,
                         pm25_std=15.5, n_heads=4, dim_head=8, **kw)


@pytest.fixture(scope="module")
def stn_params():
    """The variant's JAX weights (the flags of the NHWC path do not change
    them); a jitted init costs half of an eager one here."""
    return jax.jit(lambda k: metnet3_init(k, _stn_cfg()))(
        jax.random.PRNGKey(5))


def _rel(ours, ref):
    return np.abs(ours - ref).max() / np.abs(ref).max()


def _port_forward(model, x, ts):
    with torch.inference_mode():
        return model(torch.from_numpy(np.ascontiguousarray(x)),
                     torch.from_numpy(ts)).numpy()


@pytest.mark.parametrize("path", ["standard", "nhwc_input"])
def test_station_image_metnet3_matches_jax(stn_params, path):
    """25 channels with the station image at 24, JAX weights through
    ``params_from_jax``: the standard path on the (B, T, C, H, W) input,
    and the fused-stem NHWC path on each package's own
    ``model_input_to_nhwc``, within REL of max|jax|; the port's NHWC
    output within 1e-6 of its standard (fused-stem) one."""
    extra = {"standard": {},
             "nhwc_input": {"fuse_lead_stem": True, "nhwc_input": True}}[path]
    cfg, params = _stn_cfg(**extra), stn_params
    rng = np.random.default_rng(5)
    x = (rng.random((B, T, CS, H, W)) * 50).astype(np.float32)
    ts = np.stack([np.full((B, 7), 2023.0), rng.integers(1, 13, (B, 7)),
                   rng.integers(1, 29, (B, 7)), rng.integers(0, 24, (B, 7))],
                  axis=-1).astype(np.float32)
    model = params_from_jax(params, cfg)
    if path == "standard":
        jx, px = x, x
    else:
        jx = np.array(jax_assembly.model_input_to_nhwc(x, cfg.pad_multiple))
        px = np.array(port_assembly.model_input_to_nhwc(x, cfg.pad_multiple))
    ref = np.asarray(jax.jit(lambda p, a, b: metnet3_apply(p, a, b, cfg))(
        params, jnp.asarray(jx), jnp.asarray(ts)))
    ours = _port_forward(model, px, ts)
    assert ours.shape == (B, 3, H, W) and np.isfinite(ours).all()
    assert _rel(ours, ref) <= REL
    if path == "nhwc_input":
        std = params_from_jax(params, dataclasses.replace(cfg,
                                                          nhwc_input=False))
        assert _rel(ours, _port_forward(std, x, ts)) <= 1e-6
