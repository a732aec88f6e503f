"""The port's window attention against the JAX package: the plain PyTorch
version against ``ops.attention.attention`` and against the Pallas kernel
``window_attention_pallas`` run in TPU interpret mode, on the same numpy
inputs in f32.  Tolerance: max|port - jax| <= 2e-5 * max|jax| (the
bound ``tests/test_pallas_attention.py`` holds the Pallas kernel to).

The CUDA kernel itself runs only on a GPU: ``test_torch_port_cuda.py``
holds it against the plain version there."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu.core import torch_export
from vit_grid_model_tpu.ops import attention as jattn
from vit_grid_model_tpu.ops.window import relative_position_indices
from vit_grid_model_tpu_torch.ops import attention as tattn
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn

REL = 2e-5
WPS = 3


def _case(heads, dim_head, dim, conditioned, seed=0, bw=6, n=53):
    p = jattn.attention_init(jax.random.PRNGKey(seed), dim,
                             cond_dim=2 if conditioned else None,
                             heads=heads, dim_head=dim_head, window_size=7,
                             num_registers=4)
    rng = np.random.default_rng(seed)
    if not conditioned:      # non-trivial LN affine
        p["norm"] = {"g": jnp.asarray(rng.uniform(0.5, 1.5, dim), jnp.float32),
                     "b": jnp.asarray(rng.normal(0, 0.2, dim), jnp.float32)}
    p["q_norm"]["gamma"] = jnp.asarray(
        rng.uniform(0.5, 1.5, (heads, 1, dim_head)), jnp.float32)
    x = rng.standard_normal((bw, n, dim)).astype(np.float32)
    cond = (rng.standard_normal((bw // WPS, 2)).astype(np.float32)
            if conditioned else None)
    return p, x, cond


def _port(p, heads, dim_head, dim, conditioned):
    m = tattn.Attention(dim, cond_dim=2 if conditioned else None,
                        heads=heads, dim_head=dim_head, window_size=7)
    sd = {}
    torch_export._emit_attention(sd, "a", p)
    m.load_state_dict({k[2:]: torch.from_numpy(v) for k, v in sd.items()},
                      strict=True)
    return m.eval()


def _bias_idx():
    return torch.from_numpy(np.array(relative_position_indices(7, 4)))


def _run_port(m, x, cond):
    bias_idx = _bias_idx()
    with torch.no_grad():
        return tattn.attention(
            m, torch.from_numpy(x),
            None if cond is None else torch.from_numpy(cond), bias_idx,
            windows_per_sample=WPS).numpy()


def _run_jax(p, x, cond, heads):
    return np.asarray(jattn.attention(
        p, jnp.asarray(x), None if cond is None else jnp.asarray(cond),
        relative_position_indices(7, 4), heads=heads,
        windows_per_sample=WPS))


def _run_pallas(p, x, cond, heads):
    from jax.experimental.pallas import tpu as pltpu

    from vit_grid_model_tpu.ops.pallas.attention import window_attention_pallas

    with pltpu.force_tpu_interpret_mode():
        return np.asarray(window_attention_pallas(
            p, jnp.asarray(x), None if cond is None else jnp.asarray(cond),
            relative_position_indices(7, 4), None, heads, WPS))


def _rel_err(ours, ref):
    return np.abs(ours - ref).max() / np.abs(ref).max()


CASES = [(4, 8, 32, True), (4, 8, 32, False), (3, 8, 24, True),
         (3, 8, 24, False)]


@pytest.mark.parametrize("heads,dim_head,dim,conditioned", CASES)
def test_plain_matches_jax_attention(heads, dim_head, dim, conditioned):
    p, x, cond = _case(heads, dim_head, dim, conditioned)
    ours = _run_port(_port(p, heads, dim_head, dim, conditioned), x, cond)
    assert _rel_err(ours, _run_jax(p, x, cond, heads)) <= REL


@pytest.mark.parametrize("heads,dim_head,dim,conditioned", CASES)
def test_plain_matches_pallas_interpret(heads, dim_head, dim, conditioned):
    p, x, cond = _case(heads, dim_head, dim, conditioned)
    ours = _run_port(_port(p, heads, dim_head, dim, conditioned), x, cond)
    assert _rel_err(ours, _run_pallas(p, x, cond, heads)) <= REL


def _diverging_case():
    """Head 0's scores sit ~200 below head 1's: a softmax shifted by a
    joint row max of the pair underflows to 0/0 in head 0."""
    heads, dim_head, dim = 2, 8, 16
    p, x, cond = _case(heads, dim_head, dim, True, seed=3)
    table = np.asarray(p["rel_pos_bias"]["table"]).copy()
    table[:, 0] -= 200.0
    p["rel_pos_bias"]["table"] = jnp.asarray(table)
    return p, x, cond, heads, dim_head, dim


def test_plain_diverging_head_scores():
    p, x, cond, heads, dim_head, dim = _diverging_case()
    ours = _run_port(_port(p, heads, dim_head, dim, True), x, cond)
    ref = _run_jax(p, x, cond, heads)
    assert np.isfinite(ours).all()
    assert _rel_err(ours, ref) <= REL


def test_wrapper_runs_plain_on_cpu_without_nvcc(monkeypatch):
    """A CPU tensor takes the plain version: nothing is compiled or loaded
    and the launch count does not move."""
    def refuse(*a, **k):
        raise AssertionError("the kernel library was touched on the CPU")

    monkeypatch.setattr(cuda_attn, "build", refuse)
    monkeypatch.setattr(cuda_attn, "_library", refuse)
    monkeypatch.setattr(cuda_attn, "_nvcc", refuse)
    monkeypatch.setattr(cuda_attn, "launches", 0)
    p, x, cond = _case(3, 8, 24, True)
    m = _port(p, 3, 8, 24, True)
    bias_idx = _bias_idx()
    with torch.no_grad():
        ours = cuda_attn.window_attention(
            m, torch.from_numpy(x), torch.from_numpy(cond), bias_idx,
            windows_per_sample=WPS).numpy()
    np.testing.assert_array_equal(ours, _run_port(m, x, cond))
    assert cuda_attn.launches == 0
