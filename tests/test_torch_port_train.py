"""The port's training stack against the JAX package, on the CPU in f32.

* losses: each objective and focusing form against ``train/losses.py``,
  with NaN targets and a mask, rtol 1e-6;
* the train step: 3 steps of the reduced MetNet3 at dropout 0, lr 1e-3,
  warmup 1, on the same numpy batches, as
  ``tests/test_pallas_attention.py::test_short_train_fused_bwd_matches_xla_
  loss_curve`` runs the JAX one.  Per-step losses rtol 1e-4; the exported
  state after 3 steps: parameters within 1e-2 * lr * steps (AdamW turns
  gradient rounding into update noise of at most the step size), the conv
  biases that feed a batch-statistics BN, whose gradient is zero, within
  lr * steps, BN running statistics within 1e-4 of their max (the means,
  which take in those biases, within a further 0.1 * lr * steps); also
  with an EMA and with the sigmoid Focal-R;
* resume: 2 steps, save, restore, 2 steps is bit-identical to 4 steps,
  dropout on, so the generator state and the schedule step round-trip;
* remat recomputes the same dropout masks;
* the train CLI on the CPU writes a ``.pkt`` that the JAX evaluation CLI
  loads."""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core.config import MetNet3Config, TrainConfig
from vit_grid_model_tpu.core.torch_export import export_metnet3_state_dict
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu.train import losses as JL
from vit_grid_model_tpu.train import trainer as JT
from vit_grid_model_tpu_torch.core import checkpoint as ckpt
from vit_grid_model_tpu_torch.core.weights import (params_from_jax,
                                                   seeded_model)
from vit_grid_model_tpu_torch.train import losses as TL
from vit_grid_model_tpu_torch.train import trainer as TT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _import_dynamo():
    """torch.optim imports torch._dynamo at first use, and that import looks
    up optional packages with importlib.util.find_spec, which raises for
    the spec-less stand-in modules that tests/conftest.py::
    add_reference_to_path puts in sys.modules (other test modules call it
    when they are imported).  Import it here with those stand-ins set
    aside."""
    stand_ins = {name: sys.modules.pop(name) for name in ("ipdb", "xarray")
                 if name in sys.modules
                 and getattr(sys.modules[name], "__spec__", True) is None}
    try:
        import torch._dynamo  # noqa: F401
    finally:
        sys.modules.update(stand_ins)


_import_dynamo()
T, H, W = 3, 18, 17
LR, STEPS = 1e-3, 3


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _loss_inputs(seed=0):
    rng = np.random.default_rng(seed)
    preds = (rng.random((2, 3, 5, 4)) * 60).astype(np.float32)
    targets = (rng.random((2, 3, 5, 4)) * 60).astype(np.float32)
    targets[0, 1, :2] = np.nan
    targets[1, 2, 3, 3] = np.inf
    mask = rng.random((2, 3, 5, 4)) > 0.3
    return preds, targets, mask


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name,kw", [
    ("focal_r", {}),
    ("focal_r", dict(beta=0.5, gamma=2.0, base="l2")),
    ("focal_r", dict(focusing="sigmoid")),
    ("focal_r", dict(focusing="sigmoid", base="l2", gamma=0.5)),
    ("mse", {}), ("mae", {}), ("huber", dict(delta=10.0)),
])
def test_losses_match_jax(name, kw, masked):
    preds, targets, mask = _loss_inputs()
    m = mask if masked else None
    ref = float(JL.make_loss(name, **kw)(
        jnp.asarray(preds), jnp.asarray(targets),
        None if m is None else jnp.asarray(m)))
    ours = TL.make_loss(name, **kw)(
        torch.from_numpy(preds), torch.from_numpy(targets),
        None if m is None else torch.from_numpy(m))
    assert np.isfinite(ref)
    np.testing.assert_allclose(float(ours), ref, rtol=1e-6)


@pytest.mark.parametrize("focusing,gamma", [("canonical", 1.0),
                                            ("canonical", 2.0),
                                            ("sigmoid", 1.0)])
def test_focal_r_weight_matches_jax(focusing, gamma):
    e = np.linspace(-200.0, 200.0, 801).astype(np.float32)
    ref = np.asarray(JL.focal_r_weight(jnp.asarray(e), beta=0.2, gamma=gamma,
                                       focusing=focusing))
    ours = TL.focal_r_weight(torch.from_numpy(e), beta=0.2, gamma=gamma,
                             focusing=focusing).numpy()
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    with pytest.raises(ValueError):
        TL.focal_r_weight(torch.from_numpy(e), focusing="nope")


# ---------------------------------------------------------------------------
# the train step against the JAX one
# ---------------------------------------------------------------------------


def _cfg(**kw):
    return MetNet3Config(window_size=T, n_variables=24, n_start_channels=16,
                         end_lead_time=2, input_height=H, input_width=W,
                         pm25_mean=22.5, pm25_std=15.5, n_heads=4,
                         dim_head=4, **{"dropout": 0.0, **kw})


def _batches(n, B=2, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        targets = (rng.random((B, 2, H, W)) * 60).astype(np.float32)
        targets[0, 0, :3] = np.nan
        ts = np.stack([np.full((B, 7), 2023.0), rng.integers(1, 13, (B, 7)),
                       rng.integers(1, 29, (B, 7)),
                       rng.integers(0, 24, (B, 7))], -1).astype(np.float32)
        out.append({"x": (rng.random((B, T, 24, H, W)) * 50)
                    .astype(np.float32), "timestamps": ts,
                    "targets": targets})
    return out


# the MBConv conv biases that feed a batch-statistics BatchNorm: their
# gradient is zero (the BN removes the batch mean), so AdamW's normalized
# step turns each framework's rounding noise into an update of up to lr
_BN_FED_BIAS = re.compile(r"vit\.layers\.\d+\.0\.(fn\.)?[037]\.bias$")


def _assert_state_close(ours, ref, what):
    """Parameters within 1e-2 * lr * steps, the BN-fed conv biases within
    lr * steps; BN running statistics within 1e-4 of their max, and the
    running means, which take in those biases at momentum 0.1, within a
    further 0.1 * lr * steps."""
    for k, v in ref.items():
        if k.endswith("num_batches_tracked") or k == "pm25_boundaries":
            continue
        if k not in ours:
            continue
        o = ours[k].detach().numpy()
        if k.endswith("running_var"):
            bound = 1e-4 * np.abs(v).max()
        elif k.endswith("running_mean"):
            bound = 1e-4 * np.abs(v).max() + 0.1 * LR * STEPS
        elif _BN_FED_BIAS.search(k):
            bound = LR * STEPS
        else:
            bound = 1e-2 * LR * STEPS
        d = np.abs(o - v).max()
        assert d <= bound, (what, k, d, bound)


@pytest.mark.parametrize("extra", [{}, {"ema_decay": 0.9},
                                   {"focal_focusing": "sigmoid"}])
def test_train_steps_match_jax(extra):
    cfg = _cfg()
    tc = TrainConfig(learning_rate=LR, total_steps=STEPS + 1, warmup_steps=1,
                     batch_size=2, **extra)
    params = metnet3_init(jax.random.PRNGKey(0), cfg)
    batches = _batches(STEPS)

    jstate = JT.init_train_state(jax.tree.map(jnp.array, params), tc)
    jstep = JT.build_train_step(cfg, tc)
    ref = []
    for b in batches:
        jstate, m = jstep(jstate, b)
        ref.append(float(m["loss"]))

    state = TT.init_train_state(params_from_jax(params, cfg), tc)
    step = TT.build_train_step(cfg, tc)
    ours = [float(step(state, b)["loss"]) for b in batches]
    assert state.step == STEPS
    np.testing.assert_allclose(ours, ref, rtol=1e-4)
    _assert_state_close(state.model.state_dict(),
                        export_metnet3_state_dict(jstate.params, cfg),
                        "params")
    if tc.ema_decay > 0:
        want = export_metnet3_state_dict(jstate.ema_params, cfg)
        assert set(state.ema) <= set(want)
        _assert_state_close(state.ema, want, "ema")


def test_learning_rate_is_optax_warmup_cosine():
    import optax

    tc = TrainConfig(learning_rate=3e-4, total_steps=50, warmup_steps=10)
    sched = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 10, 50)
    # optax evaluates the cosine in f32
    for s in (0, 1, 5, 10, 11, 30, 49, 50, 80):
        np.testing.assert_allclose(TT.learning_rate(tc, s), float(sched(s)),
                                   rtol=2e-5, atol=1e-12)


def test_bf16_compute_keeps_f32_masters_and_bn_statistics():
    """bf16 compute over f32 master weights: the parameters and the BN
    statistics the step writes back stay f32, and the statistics move."""
    cfg = _cfg(compute_dtype="bfloat16", dropout=0.1)
    tc = TrainConfig(learning_rate=LR, total_steps=4, warmup_steps=1,
                     batch_size=2)
    model = seeded_model(cfg, 0)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TT.init_train_state(model, tc)
    step = TT.build_train_step(cfg, tc)
    for b in _batches(2):
        assert np.isfinite(float(step(state, b)["loss"]))
    after = model.state_dict()
    stats = [k for k in after if k.endswith("running_var")]
    assert stats
    for k, v in after.items():
        if v.is_floating_point():
            assert v.dtype == torch.float32, k
    assert all(not torch.equal(after[k], before[k]) for k in stats)
    assert not torch.equal(after["vit.layers.0.1.to_qkv.weight"],
                           before["vit.layers.0.1.to_qkv.weight"])


# ---------------------------------------------------------------------------
# resume and remat (the port alone)
# ---------------------------------------------------------------------------


def _port_state(cfg, tc, seed=0):
    return TT.init_train_state(seeded_model(cfg, seed), tc)


def test_resume_matches_uninterrupted(tmp_path):
    """Mirror of ``tests/test_training.py::test_resume_matches_
    uninterrupted``, with dropout on and an EMA: the restored state is
    bit-identical to the uninterrupted one."""
    cfg = _cfg(dropout=0.1)
    tc = TrainConfig(learning_rate=LR, total_steps=4, warmup_steps=2,
                     batch_size=2, ema_decay=0.5)
    batches = _batches(4, seed=1)
    step = TT.build_train_step(cfg, tc)

    full = _port_state(cfg, tc)
    for b in batches:
        step(full, b)

    half = _port_state(cfg, tc)
    for b in batches[:2]:
        step(half, b)
    path = ckpt.save_train_state(str(tmp_path / "t_state.pt"), half)
    resumed = ckpt.restore_train_state(path, _port_state(cfg, tc, seed=1))
    assert resumed.step == 2
    for b in batches[2:]:
        step(resumed, b)

    assert resumed.step == full.step == 4
    a, b = full.model.state_dict(), resumed.model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(torch.equal(full.ema[k], resumed.ema[k]) for k in full.ema)
    sa, sb = full.optimizer.state_dict(), resumed.optimizer.state_dict()
    for i, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(v, sb["state"][i][name]), (i, name)
    assert torch.equal(full.generator.get_state(),
                       resumed.generator.get_state())


def test_remat_recomputes_the_same_dropout_masks():
    """torch.utils.checkpoint over the backbone: the loss and every
    gradient equal those of the plain forward, dropout on."""
    cfg = _cfg(dropout=0.25)
    batch = _batches(1, seed=2)[0]
    x, ts = torch.from_numpy(batch["x"]), torch.from_numpy(batch["timestamps"])

    def grads(remat):
        model = seeded_model(cfg, 3).train()
        gen = torch.Generator().manual_seed(7)
        stats = []
        preds = model(x, ts, generator=gen, bn_stats=stats, remat=remat)
        loss = preds.square().mean()
        params = list(model.parameters())
        return loss, torch.autograd.grad(loss, params), stats

    (l0, g0, s0), (l1, g1, s1) = grads(False), grads(True)
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))
    assert len(s0) == len(s1) == 3
    assert all(torch.equal(a[1], b[1]) and torch.equal(a[2], b[2])
               for a, b in zip(s0, s1))


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------


def test_train_cli_writes_a_pkt_the_jax_evaluation_loads(tmp_path):
    from vit_grid_model_tpu.cli import evaluation_vit as jcli

    common = ["--input_dim", "2", "--output_dim", "2", "--prev_len", "2",
              "--hidden_dim", "16", "--batch_size", "1"]
    argv = [sys.executable, "-m", "vit_grid_model_tpu_torch.cli.train_vit",
            "--synthetic", "--gpus", "cpu", *common, "--steps", "2",
            "--log_every", "1", "--num_workers", "1",
            "--train_start", "2023-01-10T00", "--train_end", "2023-01-10T05",
            "--synthetic_root", str(tmp_path / "tree"),
            "--checkpoint_dir", str(tmp_path / "ckpt"),
            "--model_name", "tiny"]
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        filter(None, [ROOT, os.environ.get("PYTHONPATH")])))
    out = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    assert out.stdout.count("loss=") == 2 and "training complete" in out.stdout
    pkt = tmp_path / "ckpt" / "tiny.pkt"
    assert (tmp_path / "ckpt" / "tiny_state.pt").exists()

    tree = tmp_path / "tree"
    args = jcli.build_parser().parse_args(
        [*common, "--checkpoint", str(pkt),
         "--data_path", str(tree / "preprocessed"),
         "--sim_data_path", str(tree / "cmaq_sim"),
         "--analysis_data_path", str(tree / "cmaq_analysis")])
    _, model_cfg, _, _ = jcli.build_configs(args)
    params = jcli.load_model_params(args, model_cfg)
    sd = torch.load(pkt, weights_only=True)
    for k, v in export_metnet3_state_dict(params, model_cfg).items():
        np.testing.assert_array_equal(np.asarray(v), sd[k].numpy(), k)


def test_train_cli_refuses_data_parallel():
    """Outside torchrun, a request for two ranks raises with the launch
    line."""
    from vit_grid_model_tpu_torch.cli import train_vit

    with pytest.raises(ValueError, match="resolves to 2 devices.*torchrun "
                       "--nproc_per_node 2 -m vit_grid_model_tpu_torch.cli."
                       "train_vit"):
        train_vit.main(["--gpus", "cpu", "--data_parallel", "2"])
