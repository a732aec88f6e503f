"""A resnet ``Block``'s epilogue in one pass on the GPU: the wrapper of
``csrc/chan_norm_act.cu`` and its counters.

``chan_norm_act(x, g, b, scale_shift, residual)`` computes what
``models/metnet3.py::_norm_act`` computes, ChanLayerNorm over the channels of
NCHW ``x`` (biased variance, ``rsqrt(max(var, eps))``), the FiLM
``* (scale + 1) + shift`` where ``scale_shift`` is given, ReLU, then the
residual where it is given, with the sums in f32 and one rounding to x's
dtype.  For a tensor on the CPU it runs the plain version
``chan_norm_act_reference``; for a CUDA tensor it launches the kernel or
raises.  The kernel reads ``x`` in the layout it has, and ``route`` names
it: "nhwc" (channels_last) or "nchw" (contiguous, a channel's run of
pixels a multiple of 16 bytes); the output keeps it.  A residual in the
other dense layout is copied into x's first (``relaid_residuals``): the
int8 convs write channels_last where the fused stem's residual is NCHW.

The model takes the kernel where ``route`` names one (``_norm_act`` then
calls ``launch``): a CUDA forward that needs no gradient, in f32 or bf16,
C a multiple of 8 up to ``MAX_CHANNELS``, every map dense.  Elsewhere (the
CPU, training and its recompute, other layouts) it runs the eager ops, and
a CUDA forward that does so counts in ``eager_epilogues``.
"""

from __future__ import annotations

from collections import Counter
from typing import Optional, Tuple

import torch
from torch import Tensor

from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.cuda import library

ROUTES = ("nchw", "nhwc")
MAX_CHANNELS = 512
EPS = 1e-5   # the model's ChanLayerNorm's (``vnn.chan_layer_norm``'s default)

# Since the counts were last set to 0: the kernel's launches, in all and by
# route, the residuals copied into x's layout for a launch, and the
# epilogues of CUDA forwards that ran the eager ops.
launches = 0
launches_by_route: Counter = Counter()
relaid_residuals = 0
eager_epilogues = 0


def reset_launches() -> None:
    global launches, relaid_residuals, eager_epilogues
    launches = 0
    relaid_residuals = 0
    eager_epilogues = 0
    launches_by_route.clear()


def count_eager() -> None:
    """Count one epilogue that a CUDA forward ran with the eager ops."""
    global eager_epilogues
    eager_epilogues += 1


def chan_norm_act_reference(x: Tensor, g: Tensor, b: Tensor,
                            scale_shift: Optional[Tuple[Tensor, Tensor]]
                            = None, residual: Optional[Tensor] = None, *,
                            eps: float = EPS) -> Tensor:
    """The plain version: the eager epilogue (``vnn.chan_layer_norm``, the
    FiLM, ReLU, the residual add) computed in f32, rounded once to x's
    dtype.  In f32 it is the eager ops themselves."""
    h = vnn.chan_layer_norm(x.float(), g.float(), b.float(), eps=eps)
    if scale_shift is not None:
        scale, shift = scale_shift
        h = h * (scale.float() + 1.0) + shift.float()
    h = torch.relu(h)
    if residual is not None:
        h = h + residual.float()
    return h.to(x.dtype)


def layout(x: Tensor) -> Optional[str]:
    """"nchw" for a contiguous 4-D tensor, "nhwc" for a channels_last one,
    None for any other strides."""
    if x.dim() != 4:
        return None
    if x.is_contiguous():
        return "nchw"
    if x.is_contiguous(memory_format=torch.channels_last):
        return "nhwc"
    return None


def refusal(x: Tensor, g: Tensor, b: Tensor,
            scale_shift: Optional[Tuple[Tensor, Tensor]] = None,
            residual: Optional[Tensor] = None) -> Optional[str]:
    """Why the kernel does not take these operands, or None where it
    does."""
    operands = [x, g, b, *(scale_shift or ()),
                *(() if residual is None else (residual,))]
    if torch.is_grad_enabled() and any(t.requires_grad for t in operands):
        return "an operand requires grad (the kernel has no backward)"
    if x.dtype not in (torch.float32, torch.bfloat16):
        return f"dtype {x.dtype}"
    if any(t.dtype != x.dtype or t.device != x.device for t in operands):
        return "operands of another dtype or device than x"
    form = layout(x)
    if form is None:
        return "x is neither contiguous nor channels_last"
    n, c, h, w = x.shape
    if c % 8 or not 8 <= c <= MAX_CHANNELS:
        return f"{c} channels (a multiple of 8 up to {MAX_CHANNELS})"
    if form == "nchw" and h * w * x.element_size() % 16:
        return "a channel's run of pixels is no multiple of 16 bytes"
    if residual is not None and (residual.shape != x.shape
                                 or layout(residual) is None):
        return "the residual has another shape than x, or is not dense"
    if g.numel() != c or b.numel() != c or not (g.is_contiguous()
                                                and b.is_contiguous()):
        return "g and b must be contiguous with one value a channel"
    if scale_shift is not None and any(
            tuple(t.shape) != (n, c, 1, 1) for t in scale_shift):
        return "scale and shift must be (N, C, 1, 1)"
    if x.data_ptr() % 16 or (residual is not None
                             and layout(residual) == form
                             and residual.data_ptr() % 16):
        return "x or the residual is not 16-byte aligned"
    if x.device.type != "cuda":
        return f"no kernel for {x.device}"
    return None


def route(x: Tensor, g: Tensor, b: Tensor,
          scale_shift: Optional[Tuple[Tensor, Tensor]] = None,
          residual: Optional[Tensor] = None) -> Optional[str]:
    """The layout the kernel reads these operands in ("nchw" | "nhwc"), or
    None where it takes none of them (``refusal`` says why)."""
    if refusal(x, g, b, scale_shift, residual) is not None:
        return None
    return layout(x)


def chan_norm_act(x: Tensor, g: Tensor, b: Tensor,
                  scale_shift: Optional[Tuple[Tensor, Tensor]] = None,
                  residual: Optional[Tensor] = None, *,
                  eps: float = EPS) -> Tensor:
    """The epilogue of (N, C, H, W) ``x``: ``g`` and ``b`` hold one value a
    channel, ``scale_shift`` (N, C, 1, 1) each, ``residual`` x's shape in
    either dense layout."""
    if x.device.type == "cpu":
        return chan_norm_act_reference(x, g, b, scale_shift, residual,
                                       eps=eps)
    form = route(x, g, b, scale_shift, residual)
    if form is None:
        raise ValueError(
            f"chan_norm_act: {refusal(x, g, b, scale_shift, residual)}")
    return launch(form, x, g, b, scale_shift, residual, eps=eps)


def launch(form: str, x: Tensor, g: Tensor, b: Tensor,
           scale_shift: Optional[Tuple[Tensor, Tensor]] = None,
           residual: Optional[Tensor] = None, *, eps: float = EPS) -> Tensor:
    """Launch the kernel on operands that ``route`` took, in the layout
    ``form`` it named; no check of its own."""
    global launches, relaid_residuals
    if residual is not None and layout(residual) != form:
        residual = residual.contiguous(
            memory_format=torch.channels_last if form == "nhwc"
            else torch.contiguous_format)
        relaid_residuals += 1
    n, c, h, w = x.shape
    scale, shift = scale_shift if scale_shift is not None else (None, None)
    out = torch.empty_like(x)
    library.check(library.load().vgm_chan_norm_act(
        x.data_ptr(), g.data_ptr(), b.data_ptr(),
        None if scale is None else scale.data_ptr(),
        None if shift is None else shift.data_ptr(),
        None if residual is None else residual.data_ptr(), out.data_ptr(),
        n, c, h * w, *(scale.stride()[:2] if scale is not None else (0, 0)),
        *(shift.stride()[:2] if shift is not None else (0, 0)),
        int(form == "nhwc"), int(x.dtype == torch.bfloat16), eps,
        library.stream(x)), "chan_norm_act")
    launches += 1
    launches_by_route[form] += 1
    return out
