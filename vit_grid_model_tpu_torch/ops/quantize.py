"""Post-training int8 quantization of the resnet 3x3 convs (inference).

Counterpart of ``vit_grid_model_tpu/ops/quantize.py``, with the same
recipe and the same numbers:

* weights: symmetric per-output-channel int8 (the OIHW weight's channel is
  its first axis, so the maximum runs over (I, H, W));
* activations: symmetric per-tensor int8 with a static scale calibrated
  offline by one ``collect_amax`` forward over calibration batches;
* accumulation in int32, dequantize and bias in f32, output in the input's
  dtype, in JAX's order of operations, which makes the output bit-equal to
  ``conv2d_int8``'s on the same input.

A quantized conv is an ``Int8Conv`` sidecar module, ``proj_q`` beside the
``Block``'s float ``proj``; its state_dict keys are ``*.proj_q.{wq, sw, sx,
b}``.  Its int8 weight and f32 scales and bias keep their dtypes under
``model.to(torch.bfloat16)``: rounding the dequantize scales to bf16 would
add a systematic per-channel gain error, which the JAX package avoids by
leaving its ``proj_q`` leaves out of the bf16 cast.

The integer conv: for a tensor on the CPU, the plain version, a float64
conv over the int8 values, which is exact (|sum| <= 9 * C * 127**2, far
below 2**53; an f32 or TF32 conv is not exact above 2**24, which C = 128
passes).  For a CUDA tensor, PyTorch's int8 GEMM ``torch._int_mm``
(cuBLASLt, int32 out) over a 9-tap im2col of the zero-padded NHWC int8
input, in row chunks of at most ``IM2COL_BYTES``; no route falls back to a
float conv.  The JAX package leaves this conv to XLA, so it is a stock
call here too, and ``launches`` counts the convs it runs.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F
from torch import Tensor, nn

#: int8 convs the im2col route ran (each one ``torch._int_mm`` a chunk)
#: since the count was last set to 0
launches = 0

#: the largest im2col chunk the CUDA route builds at once
IM2COL_BYTES = 1 << 30

#: the first block's first conv consumes the raw (T*C)-channel CMAQ stack,
#: whose PM planes have a far wider range than the inner activations; the
#: fused stem does not even run it per lead.  Excluded by default, as in
#: the JAX package.
DEFAULT_SKIP = frozenset({"resnet1.0.block1"})


def reset_launches() -> None:
    global launches
    launches = 0


class Int8Conv(nn.Module):
    """The int8 sidecar of one 3x3 conv: ``wq`` int8 (O, I, 3, 3), ``sw``
    (O,) f32, ``sx`` () f32 and the bias ``b`` (O,) f32.  A device move
    reaches the buffers, a dtype cast does not."""

    def __init__(self, wq: Tensor, sw: Tensor, sx: Tensor, b: Tensor):
        super().__init__()
        self.register_buffer("wq", wq)
        self.register_buffer("sw", sw)
        self.register_buffer("sx", sx)
        self.register_buffer("b", b)

    def _apply(self, fn, recurse=True):
        for name, t in self._buffers.items():
            moved = fn(t)
            self._buffers[name] = (moved if moved.dtype == t.dtype
                                   else t.to(moved.device))
        return self


def quantize_conv(weight: Tensor, bias: Tensor, act_amax: float) -> Int8Conv:
    """One OIHW conv's sidecar for ``conv2d_int8``; ``act_amax`` is the
    calibrated max-|activation| at the conv's input."""
    w = weight.detach().float()
    sw = (w.abs().amax(dim=(1, 2, 3)) / 127.0).clamp(min=1e-12)
    wq = torch.round(w / sw[:, None, None, None]).clamp(-127, 127)
    sx = torch.tensor(max(float(act_amax), 1e-12) / 127.0,
                      dtype=torch.float32, device=w.device)
    return Int8Conv(wq.to(torch.int8), sw, sx, bias.detach().float().clone())


def quantize_input(x: Tensor, sx: Tensor) -> Tensor:
    """``clip(round(x * (1 / sx)), -127, 127)`` as int8, in f32, rounding
    half to even as ``jnp.round`` does."""
    inv_sx = 1.0 / sx
    return torch.round(x.float() * inv_sx).clamp(-127, 127).to(torch.int8)


def int8_conv_accumulate_plain(xq: Tensor, wq: Tensor) -> Tensor:
    """The plain version: the int32 accumulator of the 3x3, padding-1 conv
    of int8 ``xq`` (N, C, H, W) with int8 ``wq`` (O, C, 3, 3), through an
    exact float64 conv."""
    y = F.conv2d(xq.double(), wq.double(), padding=1)
    return y.to(torch.int32)


def _int_mm_padded(a: Tensor, b: Tensor) -> Tensor:
    """``a @ b`` for int8 ``a`` (M, K) and column-major ``b`` (K, O) into
    int32, padded with zeros to ``_int_mm``'s rules (M > 16; K and O
    multiples of 8), which changes no sum."""
    m, o = a.shape[0], b.shape[1]
    pad_k, pad_o = -a.shape[1] % 8, -o % 8
    pad_m = max(17 - m, 0)
    if pad_k or pad_m:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    if pad_k or pad_o:
        b = F.pad(b.t(), (0, pad_k, 0, pad_o)).t()
    return torch._int_mm(a, b)[:m, :o]


def int8_conv_accumulate_im2col(xq: Tensor, wq: Tensor) -> Tensor:
    """The CUDA route of the 3x3, padding-1 integer conv: the zero-padded
    NHWC input's nine taps side by side (K = 9 * C, tap-major) times the
    (O, kh, kw, C) weight, by ``torch._int_mm`` over chunks of whole
    samples of at most ``IM2COL_BYTES`` (one sample at least).  Returns
    the (N, O, H, W) int32 accumulator in the channels_last layout.  It
    runs on CPU tensors as well, where the tests hold it against the plain
    version."""
    global launches
    n, c, h, w = xq.shape
    o = wq.shape[0]
    if tuple(wq.shape[1:]) != (c, 3, 3):
        raise ValueError(f"a 3x3 conv over {c} channels, got "
                         f"{tuple(wq.shape)}")
    xp = F.pad(xq.permute(0, 2, 3, 1), (0, 0, 1, 1, 1, 1))   # (N,H+2,W+2,C)
    wk = wq.permute(0, 2, 3, 1).reshape(o, 9 * c)             # tap-major K
    out = torch.empty(n, h, w, o, dtype=torch.int32, device=xq.device)
    rows = max(1, IM2COL_BYTES // (9 * c * h * w))            # samples a chunk
    for s in range(0, n, rows):
        part = xp[s:s + rows]
        cols = torch.cat([part[:, dy:dy + h, dx:dx + w]
                          for dy in range(3) for dx in range(3)], dim=-1)
        acc = _int_mm_padded(cols.reshape(-1, 9 * c), wk.t())
        out[s:s + rows] = acc.reshape(-1, h, w, o)
    launches += 1
    return out.permute(0, 3, 1, 2)


def int8_conv_accumulate(xq: Tensor, wq: Tensor) -> Tensor:
    """The int32 accumulator of the 3x3, padding-1 conv of int8 ``xq``
    (N, C, H, W) with int8 ``wq``: the plain version for a CPU tensor, the
    CUDA route for a CUDA tensor."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise TypeError(f"int8 operands expected, got {xq.dtype}, {wq.dtype}")
    if xq.is_cuda:
        return int8_conv_accumulate_im2col(xq, wq)
    if xq.device.type != "cpu":
        raise ValueError(f"no int8 conv route on {xq.device}")
    return int8_conv_accumulate_plain(xq, wq)


def dequantize(acc: Tensor, q: Int8Conv, dtype: torch.dtype) -> Tensor:
    """``acc * (sx * sw) + b`` in f32, cast to ``dtype``."""
    y = acc.float() * (q.sx * q.sw)[:, None, None]
    return (y + q.b[:, None, None]).to(dtype)


def conv2d_int8(q: Int8Conv, x: Tensor) -> Tensor:
    """The 3x3, padding-1 int8 conv of NCHW ``x`` with static per-tensor
    activation scale: quantize, integer conv, dequantize; in x's dtype."""
    acc = int8_conv_accumulate(quantize_input(x, q.sx), q.wq)
    return dequantize(acc, q, x.dtype)


def record_amax(collect: Dict[str, Tensor], site: str, x: Tensor) -> None:
    """Keep the running max-|x| for ``site`` in ``collect`` (f32)."""
    m = x.detach().abs().amax().float()
    collect[site] = torch.maximum(collect[site], m) if site in collect else m


def _block(model: nn.Module, site: str) -> nn.Module:
    """'resnet1.0.block1' -> model.resnet1.blocks[0].block1."""
    stage, idx, block = site.split(".")
    return getattr(getattr(model, stage).blocks[int(idx)], block)


def attach_int8_sidecars(model: nn.Module, amax: Dict[str, float]):
    """Give each site's ``Block`` in ``amax`` (site -> calibrated activation
    amax) its int8 sidecar, quantized from the block's float conv, in
    place; returns ``model``."""
    for site, m in amax.items():
        block = _block(model, site)
        block.proj_q = quantize_conv(block.proj.weight, block.proj.bias,
                                     float(m))
    return model


def add_sidecars_of(model: nn.Module, state_dict):
    """Empty sidecars at the sites whose sidecars ``state_dict`` holds
    (keys ``{stage}.blocks.{i}.{block}.proj_q.wq``), so that it loads into
    ``model`` strictly; returns ``model``."""
    for key in state_dict:
        parts = key.split(".")
        if parts[-2:] == ["proj_q", "wq"]:
            stage, _, idx, name = parts[:4]
            block = _block(model, f"{stage}.{idx}.{name}")
            w = block.proj.weight
            o = w.shape[0]
            block.proj_q = Int8Conv(
                torch.zeros(w.shape, dtype=torch.int8), torch.ones(o),
                torch.ones(()), torch.zeros(o)).to(w.device)
    return model


def quantize_metnet3_int8(model: nn.Module, calibration_batches,
                          skip=DEFAULT_SKIP):
    """Calibrate and quantize ``model`` (a ``MetNet3`` in eval mode) in
    place: ``collect_amax`` forwards over ``calibration_batches`` (an
    iterable of (x, timestamps)) at ``cfg.compute_dtype`` over the model's
    own weights and buffers, as ``metnet3_apply`` casts its f32 pytree,
    then an int8 sidecar for every recorded resnet ``Block`` conv not in
    ``skip``, quantized from the block's own (f32 master) weights.  The
    model then runs unchanged under ``int8_convs=False`` and takes the
    sidecars under ``int8_convs=True``; returns ``model``."""
    from torch.func import functional_call

    if model.training:
        raise ValueError("calibrate a model in eval mode")
    dtype = getattr(torch, model.cfg.compute_dtype)
    # every float parameter and buffer but the sidecars', as metnet3_apply
    # casts its pytree
    tensors = dict(model.named_parameters())
    tensors.update(model.named_buffers())
    cast = {k: t.to(dtype) for k, t in tensors.items()
            if t.is_floating_point() and ".proj_q." not in k}
    amax: Dict[str, float] = {}
    with torch.no_grad():
        for x, ts in calibration_batches:
            got: Dict[str, Tensor] = {}
            functional_call(model, cast, (x, ts), dict(collect_amax=got))
            for k, v in got.items():
                if k not in skip:
                    amax[k] = max(amax.get(k, 0.0), float(v))
    return attach_int8_sidecars(model, amax)
