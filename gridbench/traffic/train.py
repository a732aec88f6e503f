"""Training traffic: ``train_loop`` over ``build_train_step``'s step, fed
from a ring of ``RING`` seeded device-resident batches, as the training CLI
builds the state (``init_train_state`` over ``MetNet3(cfg)`` with f32
master weights) and logs (every ``log_every`` steps, which waits for the
step).

Set-up drives that one state through its first ``COMPARED_STEPS`` steps,
through the window's own call and feed, on ring slots that all differ, and
keeps what the comparison reads: the weights before, the first gradient as
autograd hands it to each master parameter (a tensor hook, before the
clip), each step's predictions, loss and rmse, and the parameters and
BatchNorm running statistics after the last.  The window then continues
the same state for its length.  The plain reference trains a copy of the
same weights over the same batches from the same seed, after the window
(``check``).
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, List

import torch

from gridbench.common import compare, seeded
from gridbench.common.trace import traced
from gridbench.reference import metnet3 as M
from gridbench.reference import precision
from gridbench.reference import train as RT
from gridbench.traffic import _program as P

_MASK = 2 ** 63 - 1
#: seeded batches the window cycles over
RING = 4
#: set-up steps that the reference follows (as many as ``RING`` at most,
#: so that their batches all differ)
COMPARED_STEPS = 3


class Session:
    def __init__(self, work: dict, conf: dict, seed: int, device):
        from vit_grid_model_tpu_torch.core.config import TrainConfig
        from vit_grid_model_tpu_torch.train import trainer

        self.trainer = trainer
        self.work, self.conf = work, conf
        self.device = torch.device(device)
        self.cfg = dict(conf["model"])
        self.tc = dict(work["train"])
        self.train_seed = seed & _MASK
        self.phases = P.Phases(self.device)
        self.phases.mark("CUDA context")
        self.built_s = P.kernel_library(self.device)
        self.phases.mark("kernel library")
        flags = work["flags"]
        P.set_tf32(flags)
        mcfg = P.model_config(conf, flags)
        tcfg = TrainConfig(
            learning_rate=self.tc["learning_rate"],
            weight_decay=self.tc["weight_decay"],
            warmup_steps=self.tc["warmup_steps"],
            total_steps=self.tc["total_steps"], batch_size=work["batch"],
            grad_clip_norm=self.tc["grad_clip_norm"],
            focal_gamma=self.tc["focal_gamma"],
            focal_beta=self.tc["focal_beta"],
            focal_focusing=self.tc["focal_focusing"], loss=self.tc["loss"],
            seed=self.train_seed)
        self.state0 = seeded.weights(self.cfg, seed, self.device)
        model = P.build_model(mcfg, self.state0, self.device)
        self.state = trainer.init_train_state(model, tcfg)
        self.step = trainer.build_train_step(mcfg, tcfg)
        self.phases.mark("weights and train state")
        ring = seeded.batches(self.cfg, seed, RING, work["batch"],
                              self.device, targets=True)
        stage = P.dtype_of(flags["stage_dtype"])
        self.x = ring["x"].to(stage).float()
        x = (seeded.nhwc(self.x, self.cfg["pad_multiple"], stage)
             if flags.get("nhwc_input") else self.x)
        self.ring = [{"x": x[i], "timestamps": ring["timestamps"][i],
                      "targets": ring["targets"][i]}
                     for i in range(RING)]
        self.feed = self._feed()
        self.deadline = float("inf")
        self.steps = 0
        self.logged: List[str] = []
        self.metrics: List[Dict[str, torch.Tensor]] = []
        self.preds: List[torch.Tensor] = []
        self.recording = True
        self.phases.mark("ring")
        self._first_steps()
        self.phases.mark("compared steps")

    def _feed(self):
        for i in itertools.count():
            if time.perf_counter() >= self.deadline:
                return
            yield self.ring[i % len(self.ring)]

    def _step(self, state, batch):
        hook = None
        if self.recording:
            # the step's own forward hands its predictions to the check
            hook = state.model.register_forward_hook(
                lambda mod, args, out: self.preds.append(
                    out.detach().to("cpu", torch.float32, copy=True)))
        try:
            m = self.step(state, batch)
        finally:
            if hook is not None:
                hook.remove()
        self.steps += 1
        if self.recording:
            self.metrics.append(m)
        return m

    def _loop(self, steps=None) -> None:
        batches = self.feed if steps is None else itertools.islice(
            self.feed, steps)
        self.trainer.train_loop(self.state, batches, self._step,
                                log_every=self.tc["log_every"],
                                log=self.logged.append)

    def _first_steps(self) -> None:
        model = self.state.model
        grads: Dict[str, torch.Tensor] = {}

        def keep(name):
            def hook(grad):
                grads[name] = grad.detach().float().clone()
            return hook

        hooks = [p.register_hook(keep(k)) for k, p in model.named_parameters()]
        try:
            self._loop(1)
        finally:
            for h in hooks:
                h.remove()
        self.grad1 = {k: g.cpu() for k, g in grads.items()}
        self._loop(COMPARED_STEPS - 1)
        with torch.no_grad():
            # copies: the window goes on training these tensors
            self.after = {k: v.detach().to("cpu", torch.float32, copy=True)
                          for k, v in model.state_dict().items()}
        self.history = {k: [float(m[k]) for m in self.metrics]
                        for k in ("loss", "rmse")}
        self.history["preds"] = self.preds
        self.recording = False
        self.steps = 0
        P.sync(self.device)

    def run(self, seconds: float) -> float:
        """Train for ``seconds``; the seconds until the last step has
        finished."""
        t0 = time.perf_counter()
        self.deadline = t0 + seconds
        self.feed = self._feed()
        self._loop()
        P.sync(self.device)
        return time.perf_counter() - t0


def setup(work: dict, conf: dict, seed: int, device) -> Session:
    return Session(work, conf, seed, device)


def window(s: Session, seconds: float) -> dict:
    before = s.steps
    elapsed = s.run(seconds)
    steps = s.steps - before
    return {"attempted": steps, "metrics": {
        "train_samples_per_s": steps * s.work["batch"] / elapsed}}


def trace(s: Session, seconds: float) -> dict:
    from gridbench.common.flops import train_step_flops

    before = s.steps
    t = traced(lambda: s.run(seconds), lambda: P.sync(s.device))
    steps = s.steps - before
    cfg = s.cfg
    n = cfg["vit_window_size"] ** 2 + cfg["num_register_tokens"]
    left, right, top, bottom = M.pad_values(
        cfg["input_height"], cfg["input_width"], cfg["pad_multiple"])
    w = cfg["vit_window_size"]
    bw = (s.work["batch"] * cfg["end_lead_time"]
          * ((cfg["input_height"] + top + bottom) // 2 // w)
          * ((cfg["input_width"] + left + right) // 2 // w))
    t.units = {"steps": steps, "samples": steps * s.work["batch"]}
    t.cell = {"compute_dtype": s.conf["compute_dtype"],
              "peak_flops": s.conf["peak_flops"],
              "flops_per_sample": train_step_flops(cfg, s.work["batch"])
              / s.work["batch"],
              "attention_calls": [
                  (bw, n, d_out, cfg["n_heads"], cfg["dim_head"], 2)
                  for _, d_out, _ in M.layer_dims(
                      cfg["n_start_channels"], M._depth(cfg))
                  for _ in (0, 1)]}
    return {"attempted": steps, "trace": t}


def _reference(s: Session, prec: M.Precision, tf32: bool) -> dict:
    n = COMPARED_STEPS
    batches = [{"x": s.x[i], "timestamps": s.ring[i]["timestamps"],
                "targets": s.ring[i]["targets"]} for i in range(n)]
    with precision.tf32(tf32):
        return RT.run_steps(s.cfg, s.tc, s.state0, batches, s.train_seed,
                            prec)


def _numbers(cfg: dict, history: dict, grad1: dict, before: dict,
             after: dict, ref: dict) -> Dict[str, float]:
    table = M.param_table(cfg)
    _, stats = RT.split(table, {k: before[k] for k in table})
    ref_g = {k: g.float().cpu() for k, g in ref["grad1"].items()}
    grad1 = {k: grad1.get(k, torch.zeros_like(g)) for k, g in ref_g.items()}

    def change(state, names):
        return {k: state[k].float().cpu() - before[k].float().cpu()
                for k in names}

    kept = compare.moved(ref_g)
    stat_names = [k for k in stats if table[k][1] in ("running_mean",
                                                      "running_var")]
    # before the clip: the clip's scale, a global norm, would carry the
    # one-element leaf's rounding into every other leaf
    gaps = compare.leaf_gaps(grad1, ref_g, kept)
    grad1_gap, grad1_leaf = compare.worst(
        {k: g for k, g in gaps.items() if ref_g[k].numel() > 1})
    scalar_gap, scalar_leaf = compare.worst(
        {k: g for k, g in gaps.items() if ref_g[k].numel() == 1})
    change_gap, change_leaf = compare.worst(compare.leaf_gaps(
        change(after, kept), change(ref["state"], kept)))
    bn_gap, bn_leaf = compare.worst(compare.leaf_gaps(
        change(after, stat_names), change(ref["state"], stat_names)))
    gnorm_gap = compare.global_gap(grad1, ref_g, kept)
    preds = compare.field_gaps(zip(history["preds"], ref["preds"]))
    if len(history["preds"]) != len(ref["preds"]):
        preds = {"rms_gap": float("inf"), "max_gap": float("inf")}
    return {
        "pred_rms_gap": preds["rms_gap"], "pred_max_gap": preds["max_gap"],
        "grad1_gap": grad1_gap, "change_gap": change_gap, "bn_gap": bn_gap,
        # for the record: read, not held to a limit
        "grad1_norm": sum(float(g.square().sum())
                          for g in ref_g.values()) ** 0.5,
        "gnorm_gap": gnorm_gap,
        "loss_gap": compare.step_gap(history["loss"], ref["loss"]),
        "rmse_gap": compare.step_gap(history["rmse"], ref["rmse"]),
        "grad1_scalar_gap": scalar_gap,
        "grad1_leaf": grad1_leaf, "grad1_scalar_leaf": scalar_leaf,
        "change_leaf": change_leaf, "bn_leaf": bn_leaf,
    }


def check(s: Session) -> Dict[str, float]:
    """The first steps' readings against the reference's, after the
    program's state has been freed."""
    s.state = s.step = s.feed = None
    s.ring = [{"timestamps": r["timestamps"], "targets": r["targets"]}
              for r in s.ring]
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    before = {k: v.float().cpu() for k, v in s.state0.items()}
    ref = _reference(s, M.Precision(), False)
    return _numbers(s.cfg, s.history, s.grad1, before, s.after, ref)


def control(s: Session) -> Dict[str, float]:
    """The reference one step below the configuration's precision, in the
    program's place."""
    s.state = s.step = s.feed = None
    before = {k: v.float().cpu() for k, v in s.state0.items()}
    ref = _reference(s, M.Precision(), False)
    prec, tf32 = precision.control(s.conf["compute_dtype"])
    low = _reference(s, prec, tf32)
    grads = {k: g.float().cpu() for k, g in low["grad1"].items()}
    return _numbers(s.cfg, low, grads, before, low["state"], ref)
