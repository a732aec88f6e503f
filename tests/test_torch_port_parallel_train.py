"""Data-parallel training of the port, on the CPU: two ranks over gloo
(``parallel/local_ranks.py``) against the JAX package's mesh and against
the port in one process, and the four places where a per-rank program
loses the global batch's semantics, each pinned by a case that the
per-rank shortcut fails.

* (e) one train step at dropout 0, two ranks against JAX's
  ``build_train_step`` on a 2-device mesh (XLA attention), on the reduced
  MetNet3 of ``tests/test_torch_port_train.py`` at batch 4 with NaN targets
  in rank 0's rows only: loss within 1e-5 relative, the global gradient
  norm within 1e-4 relative, every parameter and BN running statistic
  within 1e-4 (``tests/test_training.py::test_data_parallel_matches_
  single_device``'s bound; step 0's learning rate is 0 under warmup, so the
  step moves the BN statistics); both ranks' state bit-equal;
* (e2) one step at dropout 0.1: rank 0's dropout seeds and keep masks equal
  the one-process step's, rank 1's seeds are JAX's ``seed + 1 *
  0x3C6EF35F`` in int32 and its masks the JAX kernel's at that seed; both
  ranks' state bit-equal;
* (f) trap 1, the time conditioning mixes rows across the batch: a
  per-rank ``_condition_time`` differs from the global one's rows, and the
  sharded forward equals the global forward's rows (1e-5 of max);
* (g) trap 2, batch norm: the gradient through the global statistics
  equals the one-process gradient at the doubled batch (1e-5), the
  per-rank statistics' does not;
* (h) trap 4, dropout seeds: ``rank_seed`` is JAX's int32 wraparound for
  ranks 0..7, and the port's attention on shard r with it equals JAX's
  sharded Pallas wrapper's shard r on an 8-device mesh, in interpret mode;
* (j) trap 3, the masked mean: the ranks' shares sum to the one-process
  loss over the global count of valid targets, with its gradient; the
  average of per-rank means is another number;
* replicas: rank 0's weights broadcast over a perturbed rank 1; a train
  state saved by rank 0 alone and restored on both ranks, bit-equal; the
  replica check raises on every rank when one rank's weights differ."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from tests.test_torch_port_attention import WPS, _bias_idx, _case, _port
from vit_grid_model_tpu.core.config import MeshConfig, TrainConfig
from vit_grid_model_tpu.core.config import MetNet3Config as JaxConfig
from vit_grid_model_tpu.core.torch_export import export_metnet3_state_dict
from vit_grid_model_tpu.models.metnet3 import metnet3_init
from vit_grid_model_tpu.ops import attention as jattn
from vit_grid_model_tpu.ops.window import relative_position_indices
from vit_grid_model_tpu.parallel import mesh as jmesh
from vit_grid_model_tpu.train import trainer as JT
from vit_grid_model_tpu_torch.core.config import MetNet3Config
from vit_grid_model_tpu_torch.core.config import \
    TrainConfig as PortTrainConfig
from vit_grid_model_tpu_torch.core.weights import params_from_jax
from vit_grid_model_tpu_torch.models import maxvit as port_maxvit
from vit_grid_model_tpu_torch.models.metnet3 import SEED_STRIDE, rank_seed
from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.dropout import keep_mask
from vit_grid_model_tpu_torch.parallel.local_ranks import run_local_ranks
from vit_grid_model_tpu_torch.train import losses as TL
from vit_grid_model_tpu_torch.train import trainer as TT

T, H, W, L, B = 3, 18, 17, 2, 4
RATE = 0.1
TC = dict(learning_rate=1e-3, total_steps=2, warmup_steps=1, batch_size=B)


def _cfg(**kw):
    return JaxConfig(window_size=T, n_variables=24, n_start_channels=16,
                     end_lead_time=L, input_height=H, input_width=W,
                     pm25_mean=22.5, pm25_std=15.5, n_heads=4, dim_head=4,
                     **{"dropout": 0.0, **kw})


def _port_cfg(cfg):
    return MetNet3Config(**dataclasses.asdict(cfg))


def _batch():
    """Batch 4, one sample a distinct (month, day, hour), NaN targets in
    rank 0's rows only."""
    rng = np.random.default_rng(3)
    targets = (rng.random((B, L, H, W)) * 60).astype(np.float32)
    targets[0, :, :9] = np.nan
    targets[1, 1, 4:] = np.nan
    ts = np.stack([np.full((B, 7), 2023.0), rng.integers(1, 13, (B, 7)),
                   rng.integers(1, 29, (B, 7)),
                   rng.integers(0, 24, (B, 7))], -1).astype(np.float32)
    return {"x": (rng.random((B, T, 24, H, W)) * 50).astype(np.float32),
            "timestamps": ts, "targets": targets}


class _SeedLog:
    """Records (seed, Bw, heads, n) of every window attention the model
    runs."""

    def __init__(self):
        self.calls = []
        self._orig = port_maxvit.window_attention

    def __enter__(self):
        def record(p, tokens, *a, seed=None, **k):
            self.calls.append((seed, tokens.shape[0], p.heads,
                               tokens.shape[1]))
            return self._orig(p, tokens, *a, seed=seed, **k)

        port_maxvit.window_attention = record
        return self

    def __exit__(self, *exc):
        port_maxvit.window_attention = self._orig


def _state(model):
    return {k: v.detach().numpy().copy()
            for k, v in model.state_dict().items()}


def _bn_case():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((B, 6, 5, 7)).astype(np.float32) * 3 + 1
    x[:2] += 4.0                 # the ranks' rows differ in their statistics
    w = rng.standard_normal(x.shape).astype(np.float32)
    bn = {"weight": rng.uniform(0.5, 1.5, 6), "bias": rng.normal(0, .2, 6),
          "running_mean": rng.normal(0, .2, 6),
          "running_var": rng.uniform(.5, 1.5, 6)}
    return x, w, {k: torch.tensor(v, dtype=torch.float32)
                  for k, v in bn.items()}


def _bn_grads(x, w, bn_state, group):
    bn = torch.nn.BatchNorm2d(x.shape[1])
    bn.load_state_dict(bn_state, strict=False)
    xt = torch.from_numpy(x).requires_grad_()
    y, mean, var = vnn.batch_norm_train(xt, bn, group=group)
    (y * torch.from_numpy(w)).sum().backward()
    return (xt.grad.numpy(), bn.weight.grad.clone(), bn.bias.grad.clone(),
            mean.numpy(), var.numpy())


def _loss_case():
    rng = np.random.default_rng(6)
    preds = (rng.random((B, L, 5, 6)) * 60).astype(np.float32)
    targets = (rng.random((B, L, 5, 6)) * 60).astype(np.float32)
    targets[:2, :, :4] = np.nan                # rank 0 holds fewer valid
    return preds, targets


def _ranks(params, cfg_kw, batch, root):
    """On each rank: (e), (e2), (f), (g), (j) and the replica checks."""
    torch.set_num_threads(2)
    import os

    from vit_grid_model_tpu_torch.core import checkpoint as ckpt
    from vit_grid_model_tpu_torch.core import distributed
    from vit_grid_model_tpu_torch.parallel.mesh import shard_rows

    group = distributed.group()
    rows = distributed.local_batch_slice(B, group)
    mine = {k: v if k == "timestamps" else shard_rows(v, group)
            for k, v in batch.items()}
    out = {}
    for rate in (0.0, RATE):
        cfg = MetNet3Config(**{**cfg_kw, "dropout": rate})
        state = TT.init_train_state(params_from_jax(params, cfg),
                                    PortTrainConfig(**TC))
        step = TT.build_train_step(cfg, PortTrainConfig(**TC), group)
        with _SeedLog() as log:
            metrics = step(state, mine)
        out[rate] = ({k: float(v) for k, v in metrics.items()},
                     _state(state.model), log.calls)

    # replicas: the last step's state saved by rank 0, restored on both
    path = os.path.join(root, "state.pt")
    ckpt.save_train_state(path, state, group)
    out["writers"] = os.path.exists(path)
    fresh = TT.init_train_state(params_from_jax(params, cfg),
                                PortTrainConfig(**TC))
    with torch.no_grad():
        if distributed.rank(group) == 1:
            for p in fresh.model.parameters():
                p.add_(1.0)
        distributed.broadcast_module(fresh.model, group)
        out["broadcast"] = _state(fresh.model)
    ckpt.restore_train_state(path, fresh, group)
    out["restored"] = (_state(fresh.model), fresh.step)
    with torch.no_grad():
        if distributed.rank(group) == 1:
            next(fresh.model.parameters()).view(-1)[0] += 2.0 ** -10
    try:
        distributed.assert_replicas_equal(fresh.model, group)
        out["disagree"] = None
    except RuntimeError as e:
        out["disagree"] = str(e)

    # (f) the sharded forward
    model = params_from_jax(params, MetNet3Config(**cfg_kw))
    with torch.no_grad():
        out["f"] = model(torch.from_numpy(shard_rows(batch["x"], group)),
                         torch.from_numpy(batch["timestamps"]),
                         group=group).numpy()

    # (g) batch norm over the global batch; the parameter gradients summed
    # over the ranks, as the trainer sums them
    x, w, bn_state = _bn_case()
    dx, dw, db, mean, var = _bn_grads(x[rows], w[rows], bn_state, group)
    for g in (dw, db):
        torch.distributed.all_reduce(g, group=group)
    out["g"] = (dx, dw.numpy(), db.numpy(), mean, var)

    # (j) the masked mean over the global count
    preds, targets = _loss_case()
    p = torch.from_numpy(preds[rows]).requires_grad_()
    share = TL.make_loss("focal_r")(p, torch.from_numpy(targets[rows]),
                                    group=group)
    share.backward()
    out["j"] = (float(share), p.grad.numpy())
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    params = jax.tree.map(np.asarray,
                          metnet3_init(jax.random.PRNGKey(0), _cfg()))
    root = tmp_path_factory.mktemp("port_dp_train")
    return params, run_local_ranks(
        _ranks, 2, (params, dataclasses.asdict(_cfg()), _batch(), str(root)),
        root=str(root))


# ---------------------------------------------------------------------------
# (e), (e2): the train step
# ---------------------------------------------------------------------------


def test_train_step_two_ranks_match_jax_mesh(ranks):
    params, (r0, r1) = ranks
    cfg, tc = _cfg(), TrainConfig(**TC)
    mesh = jmesh.make_mesh(MeshConfig(data=2, model=1),
                           devices=jax.devices()[:2])
    state = JT.init_train_state(jax.tree.map(jnp.array, params), tc)
    state = jax.device_put(state, jmesh.replicated(mesh))
    with mesh:
        state, m = JT.build_train_step(cfg, tc, mesh)(
            state, jmesh.shard_batch(mesh, _batch()))
    metrics, ours, _ = r0[0.0]
    np.testing.assert_allclose(metrics["loss"], float(m["loss"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"], float(m["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(metrics["rmse"], float(m["rmse"]), rtol=1e-5)
    np.testing.assert_allclose(metrics["pred_mean"], float(m["pred_mean"]),
                               rtol=1e-5)
    want = export_metnet3_state_dict(state.params, cfg)
    assert set(want) <= set(ours)
    diffs = {k: np.abs(ours[k] - np.asarray(v)).max()
             for k, v in want.items() if v.dtype != np.int64}
    assert max(diffs.values()) < 1e-4, max(diffs.items(), key=lambda i: i[1])
    # the step moved the BN statistics, which span the global batch
    init = export_metnet3_state_dict(params, cfg)
    assert any(np.abs(np.asarray(want[k]) - init[k]).max() > 1e-3
               for k in want if k.endswith("running_var"))
    for k, v in r1[0.0][1].items():
        np.testing.assert_array_equal(v, ours[k], err_msg=k)


def _jax_mask(seed32, bw, heads, n, wps):
    """The keep mask JAX's Pallas forward samples at int32 ``seed32`` for
    ``bw`` windows of ``n`` tokens (its ``emit_mask`` hook)."""
    from jax.experimental.pallas import tpu as pltpu

    from vit_grid_model_tpu.ops.pallas.attention import (
        _window_attention_fwd_impl)

    dim = 16
    p = jattn.attention_init(jax.random.PRNGKey(0), dim, cond_dim=2,
                             heads=heads, dim_head=4, window_size=7,
                             num_registers=n - 49)
    with pltpu.force_tpu_interpret_mode():
        _, mask = _window_attention_fwd_impl(
            p, jnp.zeros((bw, n, dim)), jnp.zeros((bw // wps, 2)),
            relative_position_indices(7, n - 49), None, heads, wps, 8,
            jnp.asarray([seed32], jnp.int32), RATE, True)
    return np.asarray(mask)


def test_train_step_with_dropout_two_ranks(ranks):
    params, (r0, r1) = ranks
    cfg = _port_cfg(_cfg(dropout=RATE))
    state = TT.init_train_state(params_from_jax(params, cfg),
                                PortTrainConfig(**TC))
    with _SeedLog() as log:
        TT.build_train_step(cfg, PortTrainConfig(**TC))(state, _batch())
    one, calls0, calls1 = log.calls, r0[RATE][2], r1[RATE][2]
    assert len(one) == len(calls0) == len(calls1) == 2
    for (s, bw, heads, n), c0, c1 in zip(one, calls0, calls1):
        assert c0 == (s, bw // 2, heads, n)
        wrapped = int(jnp.int32(s) + jnp.int32(1) * jnp.int32(SEED_STRIDE))
        assert c1 == (wrapped, bw // 2, heads, n)
        # rank 0's windows are the first half of the one-process batch's
        np.testing.assert_array_equal(
            keep_mask(c0[0], bw // 2, heads, n, RATE).numpy(),
            keep_mask(s, bw, heads, n, RATE)[:bw // 2].numpy())
    seed, bw, heads, n = calls1[0]
    wps = bw // (B // 2 * L)
    np.testing.assert_array_equal(keep_mask(seed, bw, heads, n, RATE).numpy(),
                                  _jax_mask(seed, bw, heads, n, wps))
    for k, v in r1[RATE][1].items():
        np.testing.assert_array_equal(v, r0[RATE][1][k], err_msg=k)
    assert np.isfinite(r0[RATE][0]["loss"])


def test_replicas_broadcast_checkpoint_and_check(ranks):
    params, (r0, r1) = ranks
    init = _state(params_from_jax(params, _port_cfg(_cfg())))
    for k, v in init.items():
        # rank 1's perturbed weights were overwritten with rank 0's
        np.testing.assert_array_equal(r1["broadcast"][k], v, err_msg=k)
        np.testing.assert_array_equal(r0["broadcast"][k], v, err_msg=k)
    assert r0["writers"] and r1["writers"]
    for r in (r0, r1):
        state, step = r["restored"]
        assert step == 1
        for k, v in r0[RATE][1].items():
            np.testing.assert_array_equal(state[k], v, err_msg=k)
    # one rank's weights a hair off: every rank raises
    assert r0["disagree"] == r1["disagree"] == \
        "the replicas disagree on 1 of 2 ranks"


# ---------------------------------------------------------------------------
# the traps
# ---------------------------------------------------------------------------


def test_trap1_time_conditioning_over_the_global_batch(ranks):
    params, (r0, r1) = ranks
    model = params_from_jax(params, _port_cfg(_cfg()))
    batch = _batch()
    ts = torch.from_numpy(batch["timestamps"])
    x = torch.from_numpy(batch["x"])
    with torch.no_grad():
        rows = torch.cat([ts[:, 6], torch.zeros(B, 1)], -1)
        rows = rows.repeat_interleave(L, 0)
        rows[:, -1] = torch.arange(1, L + 1).repeat(B)
        whole = model._condition_time(rows, B * L)
        half = B // 2 * L
        per_rank = model._condition_time(rows[:half], half)
        assert (per_rank - whole[:half]).abs().max() > 0.1
        ref = model(x, ts).numpy()
        shortcut = model(x[B // 2:], ts[B // 2:]).numpy()
    scale = np.abs(ref).max()
    np.testing.assert_allclose(np.concatenate([r0["f"], r1["f"]]), ref,
                               rtol=0, atol=1e-5 * scale)
    assert np.abs(shortcut - ref[B // 2:]).max() > 1e-3 * scale


def test_trap2_batch_norm_over_the_global_batch(ranks):
    _, (r0, r1) = ranks
    x, w, bn_state = _bn_case()
    dx, dw, db, mean, var = _bn_grads(x, w, bn_state, None)
    np.testing.assert_allclose(np.concatenate([r0["g"][0], r1["g"][0]]), dx,
                               rtol=1e-5, atol=1e-6)
    for r in (r0, r1):
        np.testing.assert_allclose(r["g"][1], dw.numpy(), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r["g"][2], db.numpy(), rtol=1e-5,
                                   atol=1e-5)
        # the running statistics count the global batch (n / (n - 1))
        np.testing.assert_allclose(r["g"][3], mean, rtol=1e-6)
        np.testing.assert_allclose(r["g"][4], var, rtol=1e-6)
    shortcut = _bn_grads(x[:B // 2], w[:B // 2], bn_state, None)[0]
    assert np.abs(shortcut - dx[:B // 2]).max() > 1e-2 * np.abs(dx).max()


def test_trap3_masked_mean_over_the_global_count(ranks):
    _, (r0, r1) = ranks
    preds, targets = _loss_case()
    p = torch.from_numpy(preds).requires_grad_()
    loss = TL.make_loss("focal_r")(p, torch.from_numpy(targets))
    loss.backward()
    np.testing.assert_allclose(r0["j"][0] + r1["j"][0], loss.item(),
                               rtol=1e-6)
    np.testing.assert_allclose(np.concatenate([r0["j"][1], r1["j"][1]]),
                               p.grad.numpy(), rtol=1e-6, atol=1e-12)
    per_rank = [float(TL.make_loss("focal_r")(
        torch.from_numpy(preds[s]), torch.from_numpy(targets[s])))
        for s in (slice(0, 2), slice(2, 4))]
    assert abs(np.mean(per_rank) - loss.item()) > 1e-3 * loss.item()


@pytest.mark.parametrize("seed", [12345, 2 ** 30 + 7, 2 ** 31 - 2])
def test_trap4_rank_seeds_wrap_as_int32(seed):
    for r in range(8):
        want = int(jnp.int32(seed)
                   + jnp.asarray(r, jnp.int32) * jnp.int32(SEED_STRIDE))
        assert rank_seed(seed, r) == want, r
        assert -2 ** 31 <= want < 2 ** 31
    # from rank 3 on the product itself leaves int32
    assert 3 * SEED_STRIDE > 2 ** 31 - 1


def test_trap4_rank_masks_match_the_sharded_pallas_wrapper():
    """Rank r's attention on its windows, seeded with ``rank_seed``, equals
    shard r of ``window_attention_pallas_sharded`` on an 8-device mesh."""
    from jax.experimental.pallas import tpu as pltpu
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from vit_grid_model_tpu.ops.pallas.attention import (
        window_attention_pallas_sharded)

    heads, shards, seed, rate = 4, 8, 2 ** 31 - 2, 0.25
    p, x, cond = _case(heads, 8, 32, True, bw=WPS * shards)
    mesh = jax.make_mesh((shards,), ("data",))
    with jax.set_mesh(mesh):
        xs = jax.device_put(x, NamedSharding(mesh, P("data")))
        conds = jax.device_put(cond, NamedSharding(mesh, P("data")))
        with pltpu.force_tpu_interpret_mode():
            ref = np.asarray(jax.jit(
                lambda pp, xx: window_attention_pallas_sharded(
                    pp, xx, conds, relative_position_indices(7, 4), None,
                    jnp.asarray([seed], jnp.int32), heads, WPS, 8, rate,
                    "data"))(p, xs))
    m = _port(p, heads, 8, 32, True)
    with torch.no_grad():
        for r in range(shards):
            rows = slice(r * WPS, (r + 1) * WPS)
            ours = cuda_attn.window_attention(
                m, torch.from_numpy(x[rows]), torch.from_numpy(cond[r:r + 1]),
                _bias_idx(), windows_per_sample=WPS,
                seed=rank_seed(seed, r), dropout_rate=rate).numpy()
            assert np.abs(ours - ref[rows]).max() <= \
                2e-5 * np.abs(ref[rows]).max(), r
            if r:
                # the unoffset seed draws other masks
                plain = cuda_attn.window_attention(
                    m, torch.from_numpy(x[rows]),
                    torch.from_numpy(cond[r:r + 1]), _bias_idx(),
                    windows_per_sample=WPS, seed=seed,
                    dropout_rate=rate).numpy()
                assert np.abs(plain - ref[rows]).max() > 1e-3
