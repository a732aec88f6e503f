"""Data parallelism of the port's inference entry points, on the CPU: two
ranks over gloo (``parallel/local_ranks.py``: spawned processes that join
through a ``file://`` store, with torchrun's environment) run the
evaluation, station evaluation and generation CLIs with ``--data_parallel
2``, against the JAX package's CLIs on a 2-device mesh (two of the 8 host
devices ``tests/conftest.py`` provides) and against the port in one
process, all loading one reference ``.pkt``.

One synthetic tree, window 7 (the time conditioning reads timestamp row 6),
hidden 16, 2 leads, 6 + 2 stations, batch 4 over 11 samples: batches of 4,
4 and a ragged 3.  Each rank runs 2 rows of a full batch; the ragged batch
runs whole on rank 0 at its true size.

* (a) evaluation, two ranks against the JAX mesh: every number of the log
  within 1.0001e-4 (the log prints 4 decimals; the f32 forwards differ by
  ~1e-6 relative), as ``tests/test_torch_port_eval.py`` holds one device;
* (b) evaluation, two ranks against one process: every metric of the
  summary within 1e-5 relative, the same log text, and the forward's batch
  sizes per rank;
* (c) generation, two ranks against one process: the same files, each
  field within 1e-6 of max|field|;
* the training CLI, one step at dropout 0, two ranks against one process:
  loss, RMSE and gradient norm within 1e-5 relative, every parameter and
  batch-norm statistic within 1e-5 of max, both ranks' state bit-equal;
* every CLI assembles on each rank only that rank's rows of a batch (the
  ragged batch whole on rank 0);
* (d) station evaluation, two ranks against the JAX mesh, 1.0001e-4;
* (i) the ``--data_parallel`` contract: refusals under and outside
  torchrun."""

import os
import re
from datetime import datetime

import numpy as np
import pytest
import torch

import jax

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config as JaxConfig
from vit_grid_model_tpu.core.torch_export import save_torch_checkpoint
from vit_grid_model_tpu.data import readers, synthetic
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu_torch.data import readers as port_readers
from vit_grid_model_tpu_torch.parallel import mesh as port_mesh
from vit_grid_model_tpu_torch.parallel.local_ranks import run_local_ranks

START, END = datetime(2023, 6, 1, 0), datetime(2023, 6, 1, 10)
INPUT_DIM, OUTPUT_DIM, PREV_LEN, HIDDEN, BATCH = 5, 2, 5, 16, 4
N_SAMPLES = 11
NAME = "dp"
EVAL_CLI = "vit_grid_model_tpu_torch.cli.evaluation_vit"
LOG_TOL = 1.0001e-4
_NUMBER = re.compile(r"^-?(\d+\.?\d*|\.\d+|inf|nan)$", re.IGNORECASE)


def _eval_argv(paths, pkt, log_dir, *extra):
    return ["--seed", "0", "--batch_size", str(BATCH), "--gpus", "cpu",
            "--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"],
            "--model_name", NAME, "--hidden_dim", str(HIDDEN),
            "--output_dim", str(OUTPUT_DIM), "--input_dim", str(INPUT_DIM),
            "--prev_len", str(PREV_LEN), "--checkpoint", pkt,
            "--num_workers", "1",
            "--test_start", START.strftime("%Y-%m-%dT%H"),
            "--test_end", END.strftime("%Y-%m-%dT%H"),
            "--log_dir", str(log_dir), *extra]


def _gen_argv(paths, pkt, out_dir, *extra):
    return ["--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"],
            "--input_dim", str(INPUT_DIM), "--output_dim", str(OUTPUT_DIM),
            "--prev_len", str(PREV_LEN), "--hidden_dim", str(HIDDEN),
            "--batch_size", str(BATCH), "--compute_dtype", "float32",
            "--start", START.strftime("%Y-%m-%dT%H"),
            "--end", END.strftime("%Y-%m-%dT%H"),
            "--out_dir", str(out_dir), "--checkpoint", pkt, "--gpus", "cpu",
            *extra]


def _train_argv(paths, ckpt_dir, *extra):
    return ["--data_path", paths["data_path"],
            "--sim_data_path", paths["sim_data_path"],
            "--analysis_data_path", paths["analysis_data_path"],
            "--input_dim", str(INPUT_DIM), "--output_dim", str(OUTPUT_DIM),
            "--prev_len", str(PREV_LEN), "--hidden_dim", str(HIDDEN),
            "--batch_size", str(BATCH), "--dropout", "0", "--steps", "1",
            "--num_workers", "1", "--gpus", "cpu",
            "--train_start", START.strftime("%Y-%m-%dT%H"),
            "--train_end", END.strftime("%Y-%m-%dT%H"),
            "--checkpoint_dir", str(ckpt_dir), "--model_name", NAME, *extra]


def _train(argv):
    """The training CLI on ``argv``: each step's metrics, and the trained
    state as numpy arrays."""
    from vit_grid_model_tpu_torch.cli import train_vit

    build, metrics = train_vit.build_train_step, []

    def recorded(*a, **k):
        step = build(*a, **k)

        def run(state, batch):
            m = step(state, batch)
            metrics.append({name: float(v) for name, v in m.items()})
            return m
        return run

    train_vit.build_train_step = recorded
    try:
        state = train_vit.main(argv, log=lambda line: None)
    finally:
        train_vit.build_train_step = build
    return metrics, {k: v.numpy().copy()
                     for k, v in state.model.state_dict().items()}


_ASSEMBLERS = ("sim_stack_to_model_input", "sim_stack_to_nhwc_input")
_ASSEMBLING = ("evaluation.driver", "evaluation.station_eval",
               "evaluation.generate", "cli.train_vit")


def _ranks(paths, pkt, root):
    """On each rank: the four CLIs with --data_parallel 2, the batch sizes
    each rank assembled on the host and ran through the forward, and rank
    0's results."""
    torch.set_num_threads(2)
    import importlib

    from vit_grid_model_tpu_torch.cli import evaluation_vit as ev
    from vit_grid_model_tpu_torch.cli import generate_reanalysis as gen
    from vit_grid_model_tpu_torch.cli import station_eval as stn
    from vit_grid_model_tpu_torch.evaluation.driver import BatchTiming
    from vit_grid_model_tpu_torch.models.metnet3 import MetNet3

    sizes, assembled = [], []

    def record(module, inputs):
        if isinstance(module, MetNet3):
            sizes.append(inputs[0].shape[0])

    def counted(fn):
        def assemble(simulation, *a, **k):
            assembled.append(simulation.shape[0])
            return fn(simulation, *a, **k)
        return assemble

    # the host assembly of every CLI's batches, by the names its module
    # calls
    for name in _ASSEMBLING:
        module = importlib.import_module(f"vit_grid_model_tpu_torch.{name}")
        for fn in _ASSEMBLERS:
            setattr(module, fn, counted(getattr(module, fn)))
    hook = torch.nn.modules.module.register_module_forward_pre_hook(record)
    out = {}

    def phase(name):
        out[f"{name}_sizes"], out[f"{name}_assembled"] = (list(sizes),
                                                          list(assembled))
        sizes.clear()
        assembled.clear()
    try:
        timing = BatchTiming()
        metrics = ev.main(_eval_argv(paths, pkt, os.path.join(root, "dp2"),
                                     "--data_parallel", "2"), timing=timing)
        out["eval"] = None if metrics is None else metrics.summary()
        out["eval_samples"] = timing.samples
        phase("eval")
        metrics = stn.main(_eval_argv(paths, pkt, os.path.join(root, "dp2"),
                                      "--data_parallel", "2"))
        out["station"] = None if metrics is None else metrics.summary()
        phase("station")
        out["written"] = gen.main(_gen_argv(
            paths, pkt, os.path.join(root, "fields_dp2"), "--data_parallel",
            "2"))
        phase("gen")
        out["train"] = _train(_train_argv(
            paths, os.path.join(root, "ckpt_dp2"), "--data_parallel", "2"))
        phase("train")
    finally:
        hook.remove()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tree, the .pkt, the two-rank runs, the JAX mesh-2 runs and the
    port's one-process runs."""
    from vit_grid_model_tpu.cli import evaluation_vit as jax_ev
    from vit_grid_model_tpu.cli import station_eval as jax_stn
    from vit_grid_model_tpu_torch.cli import evaluation_vit as ev
    from vit_grid_model_tpu_torch.cli import generate_reanalysis as gen

    root = tmp_path_factory.mktemp("port_dp")
    paths = synthetic.generate_tree(
        str(root / "tree"), START, END, prev_len=PREV_LEN,
        output_dim=OUTPUT_DIM, korea_stn_num=6, china_stn_num=2)
    readers.clear_caches()
    port_readers.clear_caches()
    # the CLIs build the default 32 heads x 32
    cfg = JaxConfig(window_size=INPUT_DIM + OUTPUT_DIM, n_variables=24,
                    n_start_channels=HIDDEN, end_lead_time=OUTPUT_DIM)
    pkt = str(root / f"{NAME}.pkt")
    save_torch_checkpoint(metnet3_init(jax.random.PRNGKey(7), cfg), cfg, pkt)

    ranks = run_local_ranks(_ranks, 2, (paths, pkt, str(root)),
                            root=str(root))
    jax_dp = "--data_parallel", "2"
    jax_ev.main(_eval_argv(paths, pkt, root / "jax2", *jax_dp))
    jax_stn.main(_eval_argv(paths, pkt, root / "jax2", *jax_dp))
    one = ev.main(_eval_argv(paths, pkt, root / "one")).summary()
    written = gen.main(_gen_argv(paths, pkt, root / "fields_one"))
    train = _train(_train_argv(paths, root / "ckpt_one"))

    def log(name, suffix=""):
        with open(root / name / f"test_{NAME}{suffix}.log") as f:
            return f.read()

    return dict(root=root, ranks=ranks, one=one, written=written, train=train,
                log_dp2=log("dp2"),
                log_jax2=log("jax2"), log_one=log("one"),
                stn_dp2=log("dp2", "_by_stn"), stn_jax2=log("jax2", "_by_stn"))


def _assert_logs_close(ours, ref, tol):
    """The same lines, the argument line aside; every number within
    ``tol``."""
    a, b = ours.splitlines()[1:], ref.splitlines()[1:]
    assert len(a) == len(b) > 5
    for la, lb in zip(a, b):
        ta, tb = la.split(), lb.split()
        assert len(ta) == len(tb), (la, lb)
        for x, y in zip(ta, tb):
            if _NUMBER.match(x) and _NUMBER.match(y):
                assert abs(float(x) - float(y)) <= tol or (
                    np.isnan(float(x)) and np.isnan(float(y))), (la, lb)
            else:
                assert x == y, (la, lb)


def test_eval_two_ranks_match_jax_mesh(runs):
    _assert_logs_close(runs["log_dp2"], runs["log_jax2"], LOG_TOL)


def test_eval_two_ranks_match_one_process(runs):
    rank0, rank1 = runs["ranks"]
    assert rank1["eval"] is None and rank0["eval"] is not None
    ours, ref = rank0["eval"], runs["one"]
    for name, scores in ref.items():
        if not isinstance(scores, dict):
            continue
        for key, value in scores.items():
            np.testing.assert_allclose(
                np.asarray(ours[name][key], np.float64),
                np.asarray(value, np.float64), rtol=1e-5, atol=1e-9,
                err_msg=f"{name} {key}")
    assert runs["log_dp2"].splitlines()[1:] == runs["log_one"].splitlines()[1:]
    # two rows of each full batch on each rank; the ragged 3 whole on rank 0
    assert rank0["eval_samples"] == [4, 4, 3]
    assert rank0["eval_sizes"] == [2, 2, 3]
    assert rank1["eval_sizes"] == [2, 2]


def test_generation_two_ranks_match_one_process(runs):
    root = runs["root"]
    assert [r["written"] for r in runs["ranks"]] == [runs["written"]] * 2
    assert runs["written"] == N_SAMPLES * OUTPUT_DIM
    names = sorted(os.listdir(root / "fields_one"))
    assert names == sorted(os.listdir(root / "fields_dp2"))
    assert len(names) == N_SAMPLES * OUTPUT_DIM
    for name in names:
        ref = np.load(root / "fields_one" / name)
        ours = np.load(root / "fields_dp2" / name)
        assert ours.dtype == np.float32 and ours.shape == (82, 67)
        assert np.abs(ours - ref).max() <= 1e-6 * np.abs(ref).max(), name


def test_train_cli_two_ranks_match_one_process(runs):
    """One step of the training CLI at dropout 0 (step 0's learning rate is
    0 under warmup, so the step moves the batch-norm statistics); the
    gradient norm reads the all-reduced gradients."""
    rank0, rank1 = runs["ranks"]
    (ours,), state = rank0["train"]
    (ref,), ref_state = runs["train"]
    assert rank1["train"][0] == [ours]
    for key in ("loss", "rmse", "grad_norm", "pred_mean"):
        np.testing.assert_allclose(ours[key], ref[key], rtol=1e-5,
                                   err_msg=key)
    assert state.keys() == ref_state.keys() == rank1["train"][1].keys()
    for k, v in state.items():
        np.testing.assert_array_equal(v, rank1["train"][1][k], err_msg=k)
        if v.dtype.kind == "f":
            scale = max(float(np.abs(ref_state[k]).max()), 1e-30)
            assert np.abs(v - ref_state[k]).max() <= 1e-5 * scale, k
        else:
            np.testing.assert_array_equal(v, ref_state[k], err_msg=k)


@pytest.mark.parametrize("cli,want0,want1", [
    ("eval", [2, 2, 3], [2, 2]),
    ("station", [2, 2, 3], [2, 2]),
    ("gen", [2, 2, 2], [2, 2, 2]),
    ("train", [2], [2]),
])
def test_each_rank_assembles_its_own_rows(runs, cli, want0, want1):
    """Each rank assembles on the host, and runs, only its rows of a batch
    of 4: a ragged final batch of 3 whole on rank 0 (evaluation), or padded
    to 4 and split (generation)."""
    rank0, rank1 = runs["ranks"]
    assert rank0[f"{cli}_assembled"] == want0
    assert rank1[f"{cli}_assembled"] == want1
    assert rank0[f"{cli}_sizes"] == want0
    assert rank1[f"{cli}_sizes"] == want1


def test_station_two_ranks_match_jax_mesh(runs):
    """Rank 0's log block against the JAX mesh's, every score within
    1.0001e-4 and n_obs equal; rank 0's summary is the one it logged."""
    rank0, rank1 = runs["ranks"]
    assert rank1["station"] is None
    _assert_logs_close(runs["stn_dp2"], runs["stn_jax2"], LOG_TOL)
    ours = rank0["station"]
    assert ours["n_obs"] > 0
    assert f"station model n_obs: {ours['n_obs']}" in runs["stn_jax2"]
    assert f"station model RMSE: {ours['RMSE']:.4f}" in runs["stn_dp2"]
    assert rank0["station_sizes"] == [2, 2, 3]
    assert rank1["station_sizes"] == [2, 2]


# ---------------------------------------------------------------------------
# (i) the --data_parallel contract
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("requested,batch,match", [
    (3, 4, "does not match torchrun's world size 2"),
    (1, 4, "does not match torchrun's world size 2"),
    (2, 5, "batch_size 5 must divide over the 2"),
    (-1, 3, "batch_size 3 must divide over the 2"),
    (0, 4, "-1 .all devices. or a device count"),
])
def test_data_parallel_refusals_under_torchrun(monkeypatch, requested, batch,
                                               match):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "0")
    with pytest.raises(ValueError, match=match):
        port_mesh.data_parallel_for_cli(requested, batch,
                                        torch.device("cpu"), module=EVAL_CLI)
    assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("requested", [-1, 4])
def test_data_parallel_refusals_outside_torchrun(monkeypatch, requested):
    """Several visible cards without torchrun: the message gives the
    torchrun line, and no run uses one card of several."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    with pytest.raises(ValueError, match="resolves to 4 devices.*torchrun "
                       "--nproc_per_node 4 -m vit_grid_model_tpu_torch.cli."
                       "station_eval --data_parallel 4"):
        port_mesh.data_parallel_for_cli(
            requested, 8, torch.device("cuda", 0),
            module="vit_grid_model_tpu_torch.cli.station_eval")


def test_data_parallel_one_process(monkeypatch):
    """-1 on the CPU, or on one visible card, and 1 anywhere run in one
    process, with no group."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for requested, device in ((-1, torch.device("cpu")),
                              (-1, torch.device("cuda", 0)),
                              (1, torch.device("cuda", 0))):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        assert port_mesh.data_parallel_for_cli(requested, 5, device,
                                               module=EVAL_CLI) is None


def test_gpus_flag_under_torchrun(monkeypatch):
    """Under torchrun a rank runs on cuda:LOCAL_RANK, which --gpus 0 (the
    default) stands for; another card raises; --gpus cpu stays the CPU."""
    from vit_grid_model_tpu_torch.cli.evaluation_vit import select_device

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("LOCAL_RANK", "2")
    assert select_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert select_device("0") == torch.device("cuda", 2)
    assert select_device("2") == torch.device("cuda", 2)
    with pytest.raises(ValueError, match="runs on cuda:2"):
        select_device("3")


def test_generation_arguments_from_a_file(tmp_path):
    """``@FILE`` carries the generation CLI's arguments past a torchrun
    whose parser takes ``--start`` for an ambiguous abbreviation."""
    from vit_grid_model_tpu_torch.cli import generate_reanalysis as gen

    argv = ["--data_path", "d", "--sim_data_path", "s",
            "--analysis_data_path", "a", "--start", "2023-01-10T00",
            "--data_parallel", "-1"]
    (tmp_path / "gen.args").write_text("\n".join(argv) + "\n")
    parser = gen.build_parser()
    assert parser.parse_args(["@" + str(tmp_path / "gen.args")]) == \
        parser.parse_args(argv)


def test_shard_and_gather_rows_in_one_process():
    x = np.arange(12).reshape(6, 2)
    assert port_mesh.shard_rows(x, None) is x
    t = torch.arange(6.0)
    assert port_mesh.gather_rows(t, None) is t
