"""The joint attention's streaming kernel (``csrc/joint_attention.cu``,
wrapper ``ops/cuda/joint_attention.py``) on the GPU.  Skips without a CUDA
device.  This file imports no JAX, so it runs on a machine without it:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_port_joint_attention_cuda.py

* The kernel against the plain eager core (``ops/recurrent.py::
  attention_core``) in f32 with TF32 off, on the in-projection's (B, n, 3E)
  output: the grid cell's shape (24, 6,044) with a tenth of the 550
  station keys masked; the stations' n 550 with two batch rows masked
  whole, whose core must be exact zeros; ragged n 39 and 6,043; B 1; no
  mask.  Within 2e-5 of max|plain| (seen: 6e-6): the sums over up to
  6,044 keys run in another order (a fixed FFMA chain and an online
  rescale against cuBLAS's products and one exp of the shifted map).  A
  second launch is bit-identical.
* A grid model v3 inference forward at the 13 + 12-hour widths over the
  82 x 67 grid (``chip_smoke.joint_grid_forward``, B 2) launches the
  kernel once a decode step, 12 "streaming" and 0 "eager", with
  ``attention_calls`` 12 and ``score_elements`` 12 B n^2; the same forward
  with grad enabled runs 12 "eager" and no launch, and the two outputs
  agree within 1e-5 of max|eager|.
"""

import pytest
import torch

import chip_smoke
from vit_grid_model_tpu_torch.ops import recurrent
from vit_grid_model_tpu_torch.ops.cuda import joint_attention as cuda_joint

pytestmark = pytest.mark.cuda

E = 128
TOL = 2e-5
STATIONS = 550
# (name, B, n, station keys a tenth of which are masked, batch rows
# masked whole; None: no mask)
CASES = [("cell", 24, 6044, STATIONS, 0), ("stations", 8, 550, STATIONS, 2),
         ("ragged 39", 3, 39, 10, 1), ("ragged 6043", 2, 6043, STATIONS, 0),
         ("B 1", 1, 6044, STATIONS, 0), ("no mask", 4, 1000, None, 0)]


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.fixture
def no_tf32():
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cuda.matmul.allow_tf32 = before


def _operands(b, n, stations, dead):
    """``chip_smoke``'s in-projection output and key mask, with the first
    ``dead`` batch rows masked whole (no mask where ``stations`` is
    None)."""
    qkv, mask = chip_smoke.joint_operands((b, n, E), stations or 0, 0)
    if stations is None:
        return qkv, None
    mask[:dead] = True
    return qkv, mask


@pytest.mark.parametrize("name,b,n,stations,dead", CASES)
def test_kernel_matches_plain(no_tf32, name, b, n, stations, dead):
    _need_cuda()
    qkv, mask = _operands(b, n, stations, dead)
    assert cuda_joint.route(qkv[..., :E], (), mask) == "streaming"
    before = (cuda_joint.launches, cuda_joint.launches_by_route["streaming"])
    with torch.inference_mode():
        ours = cuda_joint.joint_attention(qkv, mask)
        again = cuda_joint.joint_attention(qkv, mask)
        ref = recurrent.attention_core(qkv, mask)
    torch.cuda.synchronize()
    assert (cuda_joint.launches,
            cuda_joint.launches_by_route["streaming"]) == (before[0] + 2,
                                                           before[1] + 2)
    assert ours.shape == (b, n, E) and torch.isfinite(ours).all()
    assert torch.equal(ours, again)
    scale = ref.abs().max().item()
    err = (ours - ref).abs().max().item()
    assert scale > 0 and err <= TOL * scale, (name, err, scale)
    if dead:
        assert torch.equal(ours[:dead], torch.zeros_like(ours[:dead]))
        assert ours[dead:].abs().sum() > 0


def test_grid_forward_routes(no_tf32):
    _need_cuda()
    forward = chip_smoke.joint_grid_forward(torch.device("cuda"))
    spec = chip_smoke.JOINT_GRID_SPEC
    b, steps = chip_smoke.JOINT_GRID_BATCH, spec["output_dim"]
    n = (chip_smoke.LEGACY_GRID[0] * chip_smoke.LEGACY_GRID[1]
         + spec["korea_stn_num"] + spec["china_stn_num"])
    outs = {}
    for route in ("streaming", "eager"):
        recurrent.reset_counts()
        cuda_joint.reset_launches()
        if route == "streaming":
            with torch.inference_mode():
                outs[route] = forward()
        else:
            with torch.enable_grad():
                outs[route] = forward().detach()
        torch.cuda.synchronize()
        assert (recurrent.attention_calls,
                recurrent.score_elements) == (steps, steps * b * n * n)
        assert dict(cuda_joint.launches_by_route) == {route: steps}
        assert cuda_joint.launches == (steps if route == "streaming" else 0)
    scale = outs["eager"].abs().max().item()
    err = (outs["streaming"] - outs["eager"]).abs().max().item()
    assert scale > 0 and err <= 1e-5 * scale, (err, scale)
