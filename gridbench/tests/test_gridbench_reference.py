"""The plain reference against the program's plain CPU path at a tiny
size: the parameter table, the dropout keep mask, the inference forward in
both input layouts and the first three train steps."""

from __future__ import annotations

import pytest
import torch

from gridbench.common import compare, seeded, spec
from gridbench.reference import dropout as RD
from gridbench.reference import metnet3 as M
from gridbench.reference import train as RT
from gridbench.tests.conftest import TINY


def _cfg(name="metnet3_12hr_f32"):
    conf = spec.config(name)
    conf["model"].update(TINY)
    return conf


def test_param_table_is_the_state_dict():
    from gridbench.traffic import _program as P

    for conf in (_cfg(), spec.config("metnet3_12hr_bf16")):
        mcfg = P.model_config(conf, {})
        with torch.device("meta"):
            from vit_grid_model_tpu_torch.models.metnet3 import MetNet3
            sd = MetNet3(mcfg).state_dict()
        table = M.param_table(conf["model"])
        assert list(table) == list(sd)
        for k, (shape, _, _) in table.items():
            assert tuple(sd[k].shape) == tuple(shape), k


@pytest.mark.parametrize("seed,rate", [(0, 0.1), (123456789, 0.25),
                                       (-2147483000, 0.5)])
def test_keep_mask_is_the_programs(seed, rate):
    from vit_grid_model_tpu_torch.ops.dropout import keep_mask

    assert torch.equal(RD.keep_mask(seed, 5, 3, 53, rate),
                       keep_mask(seed, 5, 3, 53, rate))


@pytest.mark.parametrize("nhwc", [False, True])
def test_forward_matches_the_program(nhwc):
    from gridbench.traffic import _program as P

    conf = _cfg()
    cfg = conf["model"]
    flags = {"fuse_lead_stem": nhwc, "nhwc_input": nhwc}
    state = seeded.weights(cfg, 11, "cpu")
    model = P.build_model(P.model_config(conf, flags), state, "cpu").eval()
    ring = seeded.batches(cfg, 12, 1, 3, "cpu")
    x, ts = ring["x"][0], ring["timestamps"][0]
    inp = seeded.nhwc(x, cfg["pad_multiple"], torch.float32) if nhwc else x
    with torch.no_grad():
        ours = model(inp, ts)
        ref = M.forward(state, cfg, x, ts)
        blocked = M.forward(state, cfg, x, ts, block=2)
    scale = float(ref.abs().max())
    assert float((ours - ref).abs().max()) <= 1e-5 * scale
    assert float((blocked - ref).abs().max()) <= 1e-6 * scale


def test_three_train_steps_match_the_program():
    """f32, unfused stem: the program's step on the CPU (plain attention,
    the same keep masks) and the reference agree to f32 round-off."""
    from vit_grid_model_tpu_torch.core.config import TrainConfig
    from vit_grid_model_tpu_torch.train import trainer

    from gridbench.traffic import _program as P

    conf = _cfg()
    cfg = conf["model"]
    work = spec.workload("metnet3_12hr_bf16.train_b4")
    tc = dict(work["train"], warmup_steps=1)
    state = seeded.weights(cfg, 21, "cpu")
    model = P.build_model(P.model_config(conf, {}), state, "cpu")
    tcfg = TrainConfig(learning_rate=tc["learning_rate"],
                       weight_decay=tc["weight_decay"], warmup_steps=1,
                       total_steps=tc["total_steps"], seed=77)
    ts = trainer.init_train_state(model, tcfg)
    step = trainer.build_train_step(P.model_config(conf, {}), tcfg)
    ring = seeded.batches(cfg, 22, 3, 2, "cpu", targets=True)
    batches = [{k: v[i] for k, v in ring.items()} for i in range(3)]
    losses = [float(step(ts, b)["loss"]) for b in batches]
    ref = RT.run_steps(cfg, tc, state, batches, 77)
    assert losses == pytest.approx(ref["loss"], rel=1e-5)
    after = model.state_dict()
    # biases ahead of a BatchNorm have no gradient but round-off, which
    # Adam scales up: the rule of ``compare.moved`` leaves them out
    kept = compare.moved(ref["grad1"]) + [
        k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
    assert len(kept) > 0.9 * len(ref["state"])
    for k in kept:
        v = ref["state"][k]
        change = (v - state[k].float()).norm()
        ours = (after[k].float() - state[k].float()).norm()
        assert abs(float(ours - change)) <= 1e-3 * float(change) + 1e-7, k


def test_focal_r_and_schedule():
    preds = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
    targets = torch.tensor([[1.5, float("nan")], [0.0, 4.0]])
    e = torch.tensor([-0.5, 3.0, 0.0])
    want = (torch.tanh(0.5 * (0.2 * e).abs()) * e.abs()).mean()
    assert float(RT.focal_r(preds, targets, 0.2, 1.0)) == pytest.approx(
        float(want))
    tc = {"learning_rate": 1.0, "warmup_steps": 10, "total_steps": 110}
    assert RT.learning_rate(tc, 0) == 0.0
    assert RT.learning_rate(tc, 5) == 0.5
    assert RT.learning_rate(tc, 60) == pytest.approx(0.5)
    assert RT.learning_rate(tc, 110) == pytest.approx(0.0)
