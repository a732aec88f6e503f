"""Inference traffic of the station-to-grid LSTM: a closed loop of
``GridModel.forward`` over a ring of ``RING`` seeded device-resident
batches, at most ``queue_depth`` forwards queued, in
``torch.inference_mode`` as the evaluation loop runs it.

The protocol and the window loop are ``infer.py``'s: the window queues
forwards until the host clock passes its length, then synchronises; the
output of each ring slot's last forward is kept, and after the window,
with the program's model freed, every kept output is held to the plain
reference's forward over the same batch (``check``).  One field is one sample's PM2.5 grid at one lead.

The program counts its joint attentions (``ops/recurrent.py``); set-up
reads the count over its warm-up forwards, so a program without the count
refuses the cell at once.  The traced window records the CUDA activity and
the program's spans alone (``utils/profiling.py::trace``, with no ATen
operation) and hands ``gridbench.common.trace.Trace`` the device's
operations and the host's CUDA calls; each span's device seconds and
operations, copies and fills among them (``kernels_by_span`` with
``copies``: the clone inside ``masked_fill`` is the joint attention's own
work), go into ``cell["spans"]``.
"""

from __future__ import annotations

import math
import tempfile
from typing import Dict, List, Optional

import torch
from torch.autograd import DeviceType
from torch.profiler import record_function

from gridbench.common import compare, grid_seeded
from gridbench.common.trace import WINDOW, Event, Trace, _bounds
from gridbench.reference import grid as G
from gridbench.reference import precision
from gridbench.traffic import _program as P
from gridbench.traffic import infer
from vit_grid_model_tpu_torch.models.legacy.grid import (GridModel,
                                                         GridModelSpec)
from vit_grid_model_tpu_torch.ops import recurrent
from vit_grid_model_tpu_torch.utils import profiling

#: seeded batches the window cycles over
RING = 4
#: forwards in set-up, which warm every shape the window runs
WARMUP = 2
INPUTS = ("feats", "masks", "raw_times", "prev_vals", "simulation")


class Session:
    def __init__(self, work: dict, conf: dict, seed: int, device):
        # a program that does not count its joint attentions cannot run
        # the cell: it stops here, before any work
        recurrent.reset_counts()
        self.work, self.conf = work, conf
        self.device = torch.device(device)
        self.cfg = dict(conf["model"])
        self.phases = P.Phases(self.device)
        self.phases.mark("CUDA context")
        # the forward launches no hand-written kernel: no library to build
        self.built_s = 0.0
        P.set_tf32(work["flags"])
        self.state = grid_seeded.weights(self.cfg, seed, self.device)
        self.coords = grid_seeded.coords(self.cfg, seed, self.device)
        spec = GridModelSpec(**dict(self.cfg,
                                    grid_shape=tuple(self.cfg["grid_shape"])))
        where = {k: v.cpu().numpy() for k, v in self.coords.items()}
        model = GridModel(spec, where["lats"], where["lons"],
                          where["cmaq_coords"]).to(self.device)
        model.load_state_dict(self.state, strict=True)
        self.model = model.eval()
        self.phases.mark("weights and model")
        self.ring = grid_seeded.batches(self.cfg, seed, RING, work["batch"],
                                        self.device, work["masked_share"])
        self.outs: List[Optional[torch.Tensor]] = [None] * RING
        self.forwards = 0
        self.phases.mark("ring")
        with torch.inference_mode():
            for i in range(WARMUP):
                self._forward(i % RING, keep=False)
        self.phases.mark("warm-up forwards")
        self.joint = self._joint_shape(recurrent.attention_calls,
                                       recurrent.score_elements)

    @property
    def fields_per_forward(self) -> int:
        return self.work["batch"] * self.cfg["output_dim"]

    def _joint_shape(self, calls: int,
                     elements: int) -> Optional[List[int]]:
        """(B, n, E, steps) of the joint attentions of a forward, as the
        program counted them over the warm-up; None where it counted
        none."""
        if not calls:
            return None
        b = self.work["batch"]
        n = math.isqrt(elements // (calls * b))
        return [b, n, self.cfg["hidden_dim"], calls // WARMUP]

    def _forward(self, slot: int, keep: bool = True) -> None:
        out = self.model(*(self.ring[k][slot] for k in INPUTS))
        if keep:
            self.outs[slot] = out

    # infer.py's window loop: it calls ``_forward`` on each ring slot
    run = infer.Session.run


def setup(work: dict, conf: dict, seed: int, device) -> Session:
    return Session(work, conf, seed, device)


window = infer.window


def _recorded(s: Session, seconds: float) -> list:
    """The profiler's events of ``s.run(seconds)`` between two device
    synchronises, inside the window span: the CUDA activity and the spans,
    no ATen operation (``profiling.trace``, its file written into a
    temporary directory)."""
    with tempfile.TemporaryDirectory() as tmp:
        with profiling.trace(tmp) as events, record_function(WINDOW):
            P.sync(s.device)
            s.run(seconds)
            P.sync(s.device)
    return events


def trace(s: Session, seconds: float) -> dict:
    before = s.forwards
    events = _recorded(s, seconds)
    forwards = s.forwards - before
    cuda = s.device.type == "cuda"
    device: List[Event] = []
    host: List[Event] = []
    for ev in events:
        e = (ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
        if ev.device_type() == DeviceType.CUDA:
            if not ev.is_user_annotation():
                device.append(e)
        elif not (cuda and ev.is_user_annotation()):
            # on the card the host's CUDA calls; without one the spans,
            # the window's among them
            host.append(e)
    start, end = _bounds(device, host, cuda)
    t = Trace(start, end,
              [e for e in device if e[2] > start and e[1] < end],
              [e for e in host if e[2] > start and e[1] < end], cuda=cuda)
    t.units = {"forwards": forwards,
               "fields": forwards * s.fields_per_forward}
    t.cell = {"compute_dtype": s.conf["compute_dtype"],
              "peak_flops": s.conf["peak_flops"],
              "flops_per_field": _flops(s.cfg, s.work["batch"])
              / s.fields_per_forward,
              # (B, n, E, steps) of the joint attentions of a forward
              "joint_attn": s.joint,
              # {span path: [device seconds, operations]} of the window,
              # copies included
              "spans": profiling.kernels_by_span(events, copies=True)}
    return {"attempted": forwards, "trace": t}


def _flops(cfg: dict, batch: int) -> int:
    from gridbench.common.grid_flops import forward_flops

    return forward_flops(cfg, batch)


def _reference(s: Session, tf32: bool) -> List:
    refs = []
    with torch.no_grad(), precision.tf32(tf32):
        for slot in range(RING):
            refs.append(G.forward(s.state, s.cfg, s.coords,
                                  *(s.ring[k][slot] for k in INPUTS)))
    return refs


def _free(s: Session) -> None:
    s.model = None
    if s.device.type == "cuda":
        torch.cuda.empty_cache()


def check(s: Session) -> Dict[str, float]:
    """The window's kept outputs against the reference, after the
    program's model has been freed."""
    outs = [(i, o) for i, o in enumerate(s.outs) if o is not None]
    s.outs = []
    _free(s)
    if not outs:
        return {}
    refs = _reference(s, False)
    return compare.field_gaps((o, refs[i]) for i, o in outs)


def control(s: Session) -> Dict[str, float]:
    """The reference with TF32 on, one step below the configuration's
    precision, in the program's place."""
    _free(s)
    refs = _reference(s, False)
    return compare.field_gaps(zip(_reference(s, True), refs))
