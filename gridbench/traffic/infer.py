"""Inference traffic: a closed loop of ``MetNet3.forward`` over a ring of
``RING`` seeded device-resident batches, at most ``queue_depth`` forwards
queued, in ``torch.inference_mode`` as the evaluation loop runs it.

The window queues forwards until the host clock passes its length, then
synchronises; its time runs until that synchronise returns.  The output
of each ring slot's last forward is kept, and after the window every kept
output is held to the plain reference's forward over the same batch
(``check``).  One field is one sample's PM2.5 grid at one lead.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from gridbench.common import compare, seeded
from gridbench.common.trace import traced
from gridbench.reference import metnet3 as M
from gridbench.reference import precision
from gridbench.traffic import _program as P

#: seeded batches the window cycles over
RING = 4
#: forwards in set-up, which build and warm every kernel the window runs
WARMUP = 2
#: rows of a batch the plain reference computes at once
REFERENCE_BLOCK = 8


class Session:
    def __init__(self, work: dict, conf: dict, seed: int, device):
        self.work, self.conf = work, conf
        self.device = torch.device(device)
        self.cfg = dict(conf["model"])
        self.phases = P.Phases(self.device)
        self.phases.mark("CUDA context")
        self.built_s = P.kernel_library(self.device)
        self.phases.mark("kernel library")
        flags = work["flags"]
        P.set_tf32(flags)
        mcfg = P.model_config(conf, flags)
        self.state = seeded.weights(self.cfg, seed, self.device)
        self.model = P.build_model(mcfg, self.state, self.device)
        self.model.to(P.dtype_of(conf["compute_dtype"])).eval()
        self.phases.mark("weights and model")
        ring = seeded.batches(self.cfg, seed, RING, work["batch"],
                              self.device)
        stage = P.dtype_of(flags["stage_dtype"])
        # the reference reads what the program is handed
        self.x = ring["x"].to(stage).float()
        self.ts = ring["timestamps"]
        self.inputs = (seeded.nhwc(self.x, self.cfg["pad_multiple"], stage)
                       if flags.get("nhwc_input") else self.x)
        self.outs: List[Optional[torch.Tensor]] = [None] * RING
        self.forwards = 0
        self.phases.mark("ring")
        with torch.inference_mode():
            for i in range(WARMUP):
                self._forward(i % RING, keep=False)
        self.phases.mark("warm-up forwards")

    @property
    def fields_per_forward(self) -> int:
        return self.work["batch"] * self.cfg["end_lead_time"]

    def _forward(self, slot: int, keep: bool = True) -> None:
        out = self.model(self.inputs[slot], self.ts[slot])
        if keep:
            self.outs[slot] = out

    def run(self, seconds: float) -> float:
        """Queue forwards for ``seconds``; the seconds until the last one
        has finished."""
        queue = P.InFlight(self.work["queue_depth"], self.device)
        t0 = time.perf_counter()
        deadline = t0 + seconds
        with torch.inference_mode():
            while time.perf_counter() < deadline:
                self._forward(self.forwards % RING)
                self.forwards += 1
                queue.queued()
            P.sync(self.device)
        return time.perf_counter() - t0


def setup(work: dict, conf: dict, seed: int, device) -> Session:
    return Session(work, conf, seed, device)


def window(s: Session, seconds: float) -> dict:
    before = s.forwards
    elapsed = s.run(seconds)
    forwards = s.forwards - before
    return {"attempted": forwards, "metrics": {
        "infer_fields_per_s": forwards * s.fields_per_forward / elapsed}}


def trace(s: Session, seconds: float) -> dict:
    before = s.forwards
    t = traced(lambda: s.run(seconds), lambda: P.sync(s.device))
    forwards = s.forwards - before
    cfg = s.cfg
    n = cfg["vit_window_size"] ** 2 + cfg["num_register_tokens"]
    bw = _windows(cfg, s.work["batch"])
    item = torch.finfo(P.dtype_of(s.conf["compute_dtype"])).bits // 8
    t.units = {"forwards": forwards,
               "fields": forwards * s.fields_per_forward}
    t.cell = {"compute_dtype": s.conf["compute_dtype"],
              "peak_flops": s.conf["peak_flops"],
              "flops_per_field": _flops(cfg, s.work["batch"])
              / s.fields_per_forward,
              # (Bw, n, dim, heads, dh, item) of each attention call a
              # forward makes: block and grid per MaxViT layer
              "attention_calls": [
                  (bw, n, d_out, cfg["n_heads"], cfg["dim_head"], item)
                  for _, d_out, _ in M.layer_dims(
                      cfg["n_start_channels"], M._depth(cfg))
                  for _ in (0, 1)]}
    return {"attempted": forwards, "trace": t}


def _windows(cfg: dict, batch: int) -> int:
    left, right, top, bottom = M.pad_values(
        cfg["input_height"], cfg["input_width"], cfg["pad_multiple"])
    hp = (cfg["input_height"] + top + bottom) // 2
    wp = (cfg["input_width"] + left + right) // 2
    w = cfg["vit_window_size"]
    return batch * cfg["end_lead_time"] * (hp // w) * (wp // w)


def _flops(cfg: dict, batch: int) -> int:
    from gridbench.common.flops import forward_flops

    return forward_flops(cfg, batch)


def _reference(s: Session, prec: M.Precision, tf32: bool) -> List:
    refs = []
    with torch.no_grad(), precision.tf32(tf32):
        for slot in range(RING):
            refs.append(M.forward(s.state, s.cfg, s.x[slot], s.ts[slot],
                                  prec=prec, block=REFERENCE_BLOCK))
    return refs


def check(s: Session) -> Dict[str, float]:
    """The window's kept outputs against the reference, after the
    program's model has been freed."""
    outs = [(i, o) for i, o in enumerate(s.outs) if o is not None]
    s.model = s.inputs = None
    s.outs = []
    if s.device.type == "cuda":
        torch.cuda.empty_cache()
    if not outs:
        return {}
    refs = _reference(s, M.Precision(), False)
    return compare.field_gaps((o, refs[i]) for i, o in outs)


def control(s: Session) -> Dict[str, float]:
    """The reference one step below the configuration's precision, in the
    program's place."""
    s.model = s.inputs = None
    refs = _reference(s, M.Precision(), False)
    prec, tf32 = precision.control(s.conf["compute_dtype"])
    lows = _reference(s, prec, tf32)
    return compare.field_gaps(zip(lows, refs))
