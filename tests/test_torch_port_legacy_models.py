"""The PyTorch port's legacy station and grid models and SimVP against the
JAX package, at the sizes of ``tests/test_golden_legacy.py`` (6 stations,
hidden 32, a 6x5 grid, SimVP (2, 2, 8, 8)): JAX-initialised parameters go
through ``core/weights.py::*_from_jax`` (the port's exporter and a strict
``load_state_dict``), the same numpy inputs through both forwards (f32; JAX
under the conftest's highest matmul precision).  Tolerance: max|port -
jax| <= 1e-5 * max|jax|.  The grid versions' cases also pin v1's quirks
(grid time features from the output window, CMAQ blocks from the input
window) and the joint attention that is never written back: breaking
either breaks them."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from tests import conftest as C  # noqa: F401
from tests.test_golden_legacy import (GOLDEN_GRID_V3, GOLDEN_MULTIAIR,
                                      GOLDEN_SIMVP)
from vit_grid_model_tpu.core import torch_export as JE
from vit_grid_model_tpu.models import simvp as JV
from vit_grid_model_tpu.models.legacy import grid as JG
from vit_grid_model_tpu.models.legacy import station as JS
from vit_grid_model_tpu_torch.core import weights as W
from vit_grid_model_tpu_torch.models import simvp as TV
from vit_grid_model_tpu_torch.models.legacy import grid as TG
from vit_grid_model_tpu_torch.models.legacy import station as TS

REL = 1e-5
T_IN, T_OUT, KOREA, CHINA, FD, HIDDEN = 3, 2, 4, 2, 12, 32
STN = KOREA + CHINA
GRID = (6, 5)

STATION_CASES = [("multiair", "RevIN"), ("multiair", "DishTS"),
                 ("multiair", "Standard"), ("simulation", "RevIN"),
                 ("simulation_avg", "RevIN"), ("wo", "RevIN")]
GRID_CASES = [(1, "Standard"), (2, "Standard"), (3, "Standard"),
              (3, "RevIN"), (3, "DishTS")]
SIMVP_CASES = [dict(shape_in=(2, 2, 8, 8), hid_s=4, hid_t=8, n_s=2, n_t=2,
                    groups=2),
               # n_t 3 runs a middle decoder layer; Inception's 6 hidden
               # channels do not divide into 4 groups, so they fall back to 1
               dict(shape_in=(3, 2, 16, 16), hid_s=4, hid_t=12, n_s=4,
                    n_t=3, groups=4)]


def _simvp_params(spec, seed):
    """A ``simvp_init``-shaped tree drawn with numpy (norm gains near 1):
    compiling ``simvp_init`` itself takes ~10 s on the CPU, which the golden
    test alone pays."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: JV.simvp_init(k, spec),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map_with_path(
        lambda path, s: (float(path[-1].key == "g") + 0.3
                         * rng.standard_normal(s.shape)).astype(np.float32),
        shapes)


def _close(ours, ref, rel=REL):
    ours = ours.detach().numpy()
    ref = np.asarray(ref)
    assert ours.shape == ref.shape, (ours.shape, ref.shape)
    err = np.abs(ours - ref).max() / (np.abs(ref).max() + 1e-30)
    assert err <= rel, err


def _tensors(arrays):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in arrays.items()}


def _station_io(rng, b=2):
    """Station inputs; batch row 0 has every station masked at step 0."""
    masks = rng.random((b, T_IN + T_OUT, STN)) > 0.2
    masks[0, 0] = False
    return dict(
        feats=(rng.random((b, T_IN, STN, FD)) * 30).astype(np.float32),
        masks=masks,
        raw_times=np.stack([rng.integers(1, 13, (b, T_IN + T_OUT)),
                            rng.integers(1, 29, (b, T_IN + T_OUT)),
                            rng.integers(0, 24, (b, T_IN + T_OUT))],
                           -1).astype(np.float32))


def _station_spec(variant, method, mod=TS):
    return mod.StationModelSpec(
        input_dim=T_IN, feat_dim=FD, hidden_dim=HIDDEN, pm25_mean=20.0,
        pm25_std=10.0, output_dim=T_OUT, prev_len=T_IN, korea_stn_num=KOREA,
        china_stn_num=CHINA, normalization_method=method, variant=variant)


def _grid_spec(version, method, mod=TG):
    return mod.GridModelSpec(
        input_dim=T_IN, feat_dim=FD, hidden_dim=HIDDEN, pm25_mean=20.0,
        pm25_std=10.0, output_dim=T_OUT, prev_len=T_IN, korea_stn_num=KOREA,
        china_stn_num=CHINA, grid_shape=GRID, normalization_method=method,
        version=version)


def _coords(rng):
    return rng.random(STN) * 5 + 33, rng.random(STN) * 5 + 125


def _station_params(variant, method, seed=3):
    rng = np.random.default_rng(seed)
    return JS.station_model_init(jax.random.PRNGKey(seed),
                                 _station_spec(variant, method, JS),
                                 *_coords(rng))


def _grid_params(version, method, seed=4):
    rng = np.random.default_rng(seed)
    return JG.grid_model_init(jax.random.PRNGKey(seed),
                              _grid_spec(version, method, JG),
                              *_coords(rng), rng.random(GRID + (2,)) * 10 + 30)


@pytest.mark.parametrize("variant,method", STATION_CASES)
def test_station_model_matches_jax(variant, method):
    params = _station_params(variant, method)
    rng = np.random.default_rng(5)
    io = _station_io(rng)
    io["prev_vals"] = (rng.random((2, T_IN, STN)) * 30).astype(np.float32)
    if variant == "multiair":
        io["sat_outputs"] = (rng.random((2, STN, T_OUT)) * 25).astype(
            np.float32)
        sat_in = rng.random((2, STN, 13)).astype(np.float32)
        sat_in[sat_in < 0.1] = -1          # the missing-value sentinel
        io["sat_inputs"] = sat_in
    elif variant != "wo":
        s4 = (FD // 2) * (4 if variant == "simulation" else 1)
        io["simulation"] = (rng.random((2, KOREA, T_OUT * s4 + 4))
                            * 25).astype(np.float32)
    spec_j = _station_spec(variant, method, JS)
    y_j = jax.jit(lambda p, kw: JS.station_model_apply(p, spec_j, **kw))(
        params, io)
    model = W.station_model_from_jax(params, _station_spec(variant, method))
    with torch.no_grad():
        y_t = model(**_tensors(io))
    assert y_t.shape == (2, KOREA, T_OUT)
    _close(y_t, y_j)


@pytest.mark.parametrize("version,method", GRID_CASES)
def test_grid_model_matches_jax(version, method):
    params = _grid_params(version, method)
    rng = np.random.default_rng(6)
    io = _station_io(rng)
    io["prev_vals"] = (rng.random((2, T_IN) + GRID) * 30).astype(np.float32)
    io["simulation"] = (rng.random((2,) + GRID + ((T_IN + T_OUT) * 28,))
                        * 25).astype(np.float32)
    spec_j = _grid_spec(version, method, JG)
    y_j = jax.jit(lambda p, kw: JG.grid_model_apply(p, spec_j, **kw))(
        params, io)
    model = W.grid_model_from_jax(params, _grid_spec(version, method))
    with torch.no_grad():
        y_t = model(**_tensors(io))
    assert y_t.shape == (2, GRID[0] * GRID[1], T_OUT)
    _close(y_t, y_j)


@pytest.mark.parametrize("case", SIMVP_CASES, ids=["golden", "n_t3"])
def test_simvp_matches_jax(case):
    spec_j = JV.SimVPSpec(**case)
    params = _simvp_params(spec_j, 7)
    x = np.random.default_rng(8).standard_normal(
        (2,) + case["shape_in"]).astype(np.float32)
    y_j = jax.jit(lambda p, xx: JV.simvp_apply(p, spec_j, xx))(params, x)
    model = W.simvp_from_jax(params, TV.SimVPSpec(**case))
    with torch.no_grad():
        y_t = model(torch.from_numpy(x))
    _close(y_t, y_j)


# the golden vectors of tests/test_golden_legacy.py, from the same
# JAX-initialised parameters and inputs, at its tolerances

def _golden_station_io(seed):
    rng = np.random.default_rng(seed)
    return (rng.random((1, T_IN, STN, FD), dtype=np.float32) * 30,
            rng.random((1, T_IN + T_OUT, STN)) > 0.2,
            np.stack([rng.integers(1, 13, (1, T_IN + T_OUT)),
                      rng.integers(1, 29, (1, T_IN + T_OUT)),
                      rng.integers(0, 24, (1, T_IN + T_OUT))],
                     -1).astype(np.float32),
            rng.random((1, T_IN, STN), dtype=np.float32) * 30)


def _golden_multiair():
    spec = _station_spec("multiair", "Standard")
    rng = np.random.default_rng(1)
    params = JS.station_model_init(
        jax.random.PRNGKey(11), _station_spec("multiair", "Standard", JS),
        rng.random(6) * 5 + 33, rng.random(6) * 5 + 125)
    feats, masks, raw, prev = _golden_station_io(0)
    sat_out = rng.random((1, 6, 2), dtype=np.float32) * 25
    sat_in = rng.random((1, 6, 13), dtype=np.float32)
    y = W.station_model_from_jax(params, spec)(
        *map(torch.from_numpy, (feats, masks, raw, prev, sat_out, sat_in)))
    return [y[0, 0, 0], y[0, 2, 1], y[0, 3, 0]], GOLDEN_MULTIAIR, 1e-7


def _golden_grid_v3():
    spec = _grid_spec(3, "Standard")
    rng = np.random.default_rng(2)
    params = JG.grid_model_init(
        jax.random.PRNGKey(12), _grid_spec(3, "Standard", JG),
        rng.random(6) * 5 + 33, rng.random(6) * 5 + 125,
        rng.random((6, 5, 2)) * 10 + 30)
    feats, masks, raw, _ = _golden_station_io(2)
    prev = rng.random((1, 3, 6, 5), dtype=np.float32) * 30
    sim = rng.random((1, 6, 5, 5 * 28), dtype=np.float32) * 25
    y = W.grid_model_from_jax(params, spec)(
        *map(torch.from_numpy, (feats, masks, raw, prev, sim)))
    return [y[0, 0, 0], y[0, 15, 1], y[0, 29, 0]], GOLDEN_GRID_V3, 0.0


def _golden_simvp():
    case = SIMVP_CASES[0]
    params = JV.simvp_init(jax.random.PRNGKey(13), JV.SimVPSpec(**case))
    x = np.array(jax.random.normal(jax.random.PRNGKey(14), (1, 2, 2, 8, 8)))
    y = W.simvp_from_jax(params, TV.SimVPSpec(**case))(torch.from_numpy(x))
    return [y[0, 0, 0, 0, 0], y[0, 1, 1, 4, 4], y[0, 0, 1, 7, 7]], \
        GOLDEN_SIMVP, 1e-6


@pytest.mark.parametrize("golden", [_golden_multiair, _golden_grid_v3,
                                    _golden_simvp],
                         ids=["multiair", "grid_v3", "simvp"])
def test_golden_vectors(golden):
    with torch.no_grad():
        got, want, atol = golden()
    np.testing.assert_allclose(np.asarray([float(v) for v in got]), want,
                               rtol=2e-4, atol=atol)


def _keys_and_shapes(sd):
    return sorted((k, tuple(np.shape(v))) for k, v in sd.items())


@pytest.mark.parametrize("family,case", [("station", c) for c in STATION_CASES]
                         + [("grid", c) for c in GRID_CASES]
                         + [("simvp", (i,)) for i in range(2)])
def test_state_dict_keys_equal_the_exporters(family, case):
    """A module built from its spec has exactly the exporter's keys and
    shapes; the coordinates are buffers outside the state_dict."""
    if family == "station":
        params = _station_params(*case)
        ours = TS.StationModel(_station_spec(*case), params["lats"],
                               params["lons"])
        ref = JE.export_station_model(params, case[0])
        coords = {"lats", "lons"}
    elif family == "grid":
        params = _grid_params(*case)
        ours = TG.GridModel(_grid_spec(*case), params["lats"],
                            params["lons"], params["cmaq_coords"])
        ref = JE.export_grid_model(params, case[0])
        coords = {"lats", "lons", "cmaq_coords"}
        assert ("grid_decoder_lstm.weight_ih" in ref) == (case[0] == 1)
    else:
        spec = SIMVP_CASES[case[0]]
        params = _simvp_params(JV.SimVPSpec(**spec), 0)
        ours = TV.SimVP(TV.SimVPSpec(**spec))
        ref = JE.export_simvp(params, spec["n_s"], spec["n_t"])
        coords = set()
    assert _keys_and_shapes(ours.state_dict()) == _keys_and_shapes(ref)
    assert {n for n, _ in ours.named_buffers()} == coords


@pytest.mark.parametrize("family", ["station", "grid", "simvp"])
def test_seeded_constructors(family):
    """The seeded models (``chip_smoke.py`` phase 16 builds them at full
    width) are deterministic and give finite outputs."""
    if family == "station":
        spec = _station_spec("multiair", "RevIN")
        make = W.seeded_station_model
    elif family == "grid":
        spec = _grid_spec(3, "DishTS")
        make = W.seeded_grid_model
    else:
        spec = TV.SimVPSpec(**SIMVP_CASES[0])
        make = W.seeded_simvp
    a, b = make(spec, 0), make(spec, 0)
    for (k, v), (k2, v2) in zip(a.state_dict().items(),
                                b.state_dict().items()):
        assert k == k2 and torch.equal(v, v2)
    for name, buf in a.named_buffers():
        assert torch.equal(buf, dict(b.named_buffers())[name])
    assert not torch.equal(a.state_dict()[next(iter(a.state_dict()))],
                           make(spec, 1).state_dict()[
                               next(iter(a.state_dict()))])
    rng = np.random.default_rng(9)
    with torch.no_grad():
        if family == "simvp":
            y = a(torch.from_numpy(rng.standard_normal(
                (2,) + spec.shape_in).astype(np.float32)))
        else:
            io = _tensors(_station_io(rng))
            if family == "station":
                io.update(_tensors(dict(
                    prev_vals=rng.random((2, T_IN, STN)) * 30,
                    sat_outputs=rng.random((2, STN, T_OUT)) * 25,
                    sat_inputs=rng.random((2, STN, 13)))))
            else:
                io.update(_tensors(dict(
                    prev_vals=rng.random((2, T_IN) + GRID) * 30,
                    simulation=rng.random((2,) + GRID + (140,)) * 25)))
            io = {k: v.float() if v.is_floating_point() else v
                  for k, v in io.items()}
            y = a(**io)
    assert torch.isfinite(y).all()


def test_spec_copies_equal_the_jax_packages():
    """The port's spec dataclasses are field-for-field JAX's."""
    for ours, ref in ((TS.StationModelSpec, JS.StationModelSpec),
                      (TG.GridModelSpec, JG.GridModelSpec),
                      (TV.SimVPSpec, JV.SimVPSpec)):
        assert ([(f.name, f.default) for f in dataclasses.fields(ours)]
                == [(f.name, f.default) for f in dataclasses.fields(ref)])
