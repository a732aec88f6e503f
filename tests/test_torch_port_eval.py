"""Head to head: the port's evaluation CLI (``--gpus cpu``) against the JAX
package's CLI on one synthetic data tree, with twin weights saved once as a
reference ``.pkt`` that both load.  Every scalar and every table cell of the
two logs agrees within 1e-4 (the logs print 4 decimals, and the f32
forwards differ by ~1e-6 relative), and the logs have the same structure.
The eval window makes a ragged final batch, which both run at its true
size.

The flagship geometry and the ``--fast`` (bf16) configuration run as
``slow``; in bf16 the two frameworks round at other points, so that case
is held to 5e-2 relative instead."""

import os
import re
from datetime import datetime

import numpy as np
import pytest

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config
from vit_grid_model_tpu.core.torch_export import save_torch_checkpoint
from vit_grid_model_tpu.data import readers, synthetic
from vit_grid_model_tpu.models.metnet3 import metnet3_init

START = datetime(2023, 5, 1, 0)
MODEL_NAME = "port_h2h"

SCALAR_KEYS = ("total ACC", "total POD", "total FAR", "total F1 score",
               "MAE", "RMSE", "NMB", "NME", "R")
SCALAR_PREFIXES = ("persist", "model", "sim 21h", "sim avg")
TABLE_TITLES = ("persistance model", "MultiAir", "simulation 21h",
                "simulation avg")
TABLE_METRICS = ("CSI", "F1", "RMSE", "MAE")
_FLOAT = re.compile(r"^-?(\d+\.?\d*|\.\d+|inf|nan)$", re.IGNORECASE)

# (input_dim, output_dim, prev_len, hidden, batch, last hour, fast, rel tol)
GEOMETRIES = {
    # 7 steps, as the time conditioning reads timestamp row 6; 12 samples
    # -> batches of 5, 5 and a ragged 2
    "reduced": (4, 3, 4, 16, 5, 11, False, 0.0),
    # the shipped model's geometry (vit_stn_exp.sh) at batch 4; 6 samples
    # -> 4 + a ragged 2
    "flagship": (13, 12, 13, 128, 4, 5, False, 0.0),
    "fast": (4, 3, 4, 16, 5, 11, True, 5e-2),
}
ABS_TOL = 1.0001e-4


@pytest.fixture(scope="module", params=[
    "reduced",
    pytest.param("flagship", marks=pytest.mark.slow),
    pytest.param("fast", marks=pytest.mark.slow),
])
def logs(request, tmp_path_factory):
    """Generate the tree and the twin .pkt, run both CLIs once."""
    from vit_grid_model_tpu.cli import evaluation_vit as jax_cli
    from vit_grid_model_tpu_torch.cli import evaluation_vit as port_cli
    from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming

    (input_dim, output_dim, prev_len, hidden, batch, last_hour, fast,
     rel) = GEOMETRIES[request.param]
    end = START.replace(hour=last_hour)
    root = tmp_path_factory.mktemp(f"port_{request.param}")
    paths = synthetic.generate_tree(str(root / "tree"), START, end,
                                    prev_len=prev_len, output_dim=output_dim)
    readers.clear_caches()
    cfg = MetNet3Config(window_size=input_dim + output_dim, n_variables=24,
                        n_start_channels=hidden, end_lead_time=output_dim)
    pkt = str(root / f"{MODEL_NAME}.pkt")
    save_torch_checkpoint(metnet3_init(jax.random.PRNGKey(42), cfg), cfg, pkt)

    def argv(log_dir):
        return ["--seed", "0", "--batch_size", str(batch), "--gpus", "cpu",
                "--data_path", paths["data_path"],
                "--sim_data_path", paths["sim_data_path"],
                "--analysis_data_path", paths["analysis_data_path"],
                "--model_name", MODEL_NAME, "--hidden_dim", str(hidden),
                "--output_dim", str(output_dim), "--input_dim",
                str(input_dim), "--prev_len", str(prev_len),
                "--checkpoint", pkt, "--num_workers", "2",
                "--test_start", START.strftime("%Y-%m-%dT%H"),
                "--test_end", end.strftime("%Y-%m-%dT%H"),
                "--log_dir", log_dir] + (["--fast"] if fast else [])

    def read(log_dir):
        with open(os.path.join(log_dir, f"test_{MODEL_NAME}.log")) as f:
            return f.read()

    jax_cli.main(argv(str(root / "logs_jax")))
    timing = BatchTiming()
    port_cli.main(argv(str(root / "logs_port")), timing=timing)
    n = len(synthetic.hourly_range(START, end))
    assert timing.samples == [batch] * (n // batch) + (
        [n % batch] if n % batch else [])
    return (read(str(root / "logs_jax")), read(str(root / "logs_port")),
            output_dim, rel)


def _close(a, b, rel, what):
    assert abs(a - b) <= ABS_TOL + rel * abs(a), f"{what}: jax={a} port={b}"


def _parse_scalars(text):
    out = {}
    for prefix in SCALAR_PREFIXES:
        for key in SCALAR_KEYS:
            line_prefix = f"{prefix} {key}: "
            hits = [ln[len(line_prefix):] for ln in text.splitlines()
                    if ln.startswith(line_prefix)]
            assert len(hits) == 1, f"scalar line {line_prefix!r}: {hits}"
            out[f"{prefix} {key}"] = float(hits[0])
    return out


def _parse_tables(text, output_dim):
    """{title metric: (L, 3) array} from the table blocks."""
    lines = text.splitlines()
    out = {}
    for title in TABLE_TITLES:
        for metric in TABLE_METRICS:
            header = f"{title} {metric}:"
            idx = [i for i, ln in enumerate(lines) if ln == header]
            assert len(idx) == 1, f"table header {header!r}: {idx}"
            rows = lines[idx[0] + 2: idx[0] + 2 + output_dim]
            vals = []
            for row in rows:
                toks = row.split()
                assert len(toks) == 4, f"{header} row {row!r}"
                vals.append([float(t) for t in toks[1:]])
            out[header] = np.asarray(vals)
    return out


def _skeleton(text):
    """Per-line non-numeric tokens, the args line dropped."""
    return [tuple(t for t in ln.split() if not _FLOAT.match(t))
            for ln in text.splitlines()[1:]]


def test_every_scalar_matches(logs):
    jax_log, port_log, _, rel = logs
    ref, ours = _parse_scalars(jax_log), _parse_scalars(port_log)
    assert ref.keys() == ours.keys()
    for key in ref:
        if np.isnan(ref[key]):
            assert np.isnan(ours[key]), key
        else:
            _close(ref[key], ours[key], rel, key)


def test_every_table_cell_matches(logs):
    jax_log, port_log, output_dim, rel = logs
    ref = _parse_tables(jax_log, output_dim)
    ours = _parse_tables(port_log, output_dim)
    for key in ref:
        a, b = ref[key], ours[key]
        np.testing.assert_array_equal(np.isnan(a), np.isnan(b),
                                      err_msg=f"{key}: NaN patterns differ")
        m = ~np.isnan(a)
        for x, y in zip(a[m], b[m]):
            _close(x, y, rel, key)


def test_log_structure_matches(logs):
    jax_log, port_log, _, _ = logs
    assert _skeleton(jax_log) == _skeleton(port_log)
