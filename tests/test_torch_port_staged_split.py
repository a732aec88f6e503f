"""The plans of K1-d's keep-mask writer (``csrc/dropout_keep_mask.cu``, the
chunks design) and of R11's staged core (``csrc/staged_attention_core.cu``,
the ring design), on the CPU.

K1-d: a CTA owns ``planes_a_cta`` whole (window, head) planes of n x n
values (a multiple of 4) and walks their 16-byte chunks; a chunk's first
element is split into (plane, row, col) by two multiply-high divisions,
the three others step col with a carry into row and the plane, and the
hash reads idx = (plane * n_pad + row) * n_pad + col (mod 2**32).  Here
that walk is emulated in numpy, every CTA's every chunk, and its keep
values (through ``ops/dropout.py::hash_keep``) are bit-equal to
``keep_mask`` at ragged totals (3 x 3 x 53^2 = 25,281 elements), n 1, 3,
7 and 64, seeds 1234 and 2**31 - 2, with every element written once; the
division is exact on sampled and boundary values of every 32-bit x.

R11: a persistent grid, CTA c walking the pairs [c P / G, (c + 1) P / G)
in head-major order and reloading its bias registers when the head
changes; each window in its own ring slot of 64 rows, rows n..63 zero;
S + bias (keys >= n at -inf) in f32, P = e * (1 / sum) rounded to bf16,
P.v with f32 sums.  The walk covers every (head, window) once at Bw 1, 7
and 2,881 and 3 and 32 heads for grids of 1 CTA up to one a pair; the plan
in plain PyTorch is held to the plain version (2e-2 of max|plain| in bf16,
1e-5 in f32) at n 17-64 and dim_head 16-64, and to R11's ``core_kernel``
in Pallas TPU interpret mode at the repro's widths; the ring's shared
memory fits a CTA's 232,448 bytes at every dim_head.  The wrappers on CPU
tensors run the plain versions and count no launch, and
``repros/staged_core_sections.py`` finds every place it patches.
"""

import functools
import re

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_staged_headmajor as R11
from tests import conftest as C  # noqa: F401
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention as cuda_attn
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.dropout import hash_keep, keep_mask
from vit_grid_model_tpu_torch.repros import baseline_perhead as rp1
from vit_grid_model_tpu_torch.repros import staged_core_sections as tool

MASK_SOURCE = library.CSRC / "dropout_keep_mask.cu"
R11_SOURCE = library.CSRC / "staged_attention_core.cu"
SMEM_LIMIT = 232448
SM_SMEM, RESERVED = 233472, 1024
M32 = 0xFFFFFFFF


def _constant(path, name: str) -> int:
    m = re.search(rf"constexpr int {name} = (\d+);", path.read_text())
    assert m, f"{path.name} has no {name}"
    return int(m.group(1))


# ---- K1-d -----------------------------------------------------------------

def divisor(d: int):
    """``make_divisor``: (d, m_lo, m_hi) with m = floor(2**64 / d) + 1,
    from floor((2**64 - 1) / d) as the kernel's host code forms it."""
    if d < 2:
        return d, 0, 0
    m = (2 ** 64 - 1) // d
    if (2 ** 64 - 1) % d == d - 1:
        m += 1
    m += 1
    return d, m & M32, m >> 32


def divide(x: np.ndarray, div) -> np.ndarray:
    """The kernel's ``divide`` on uint64 arrays of 32-bit x: (x m_hi +
    umulhi(x, m_lo)) >> 32, each product inside 64 bits."""
    d, lo, hi = div
    x = x.astype(np.uint64)
    if d == 1:
        return x
    top = x * np.uint64(hi) + ((x * np.uint64(lo)) >> np.uint64(32))
    return top >> np.uint64(32)


def planes_a_cta(nn: int) -> int:
    want = (4 * _constant(MASK_SOURCE, "kMaskThreads")
            * _constant(MASK_SOURCE, "kMaskChunksPerThread"))
    return (-(-want // nn) + 3) // 4 * 4


def chunk_walk(seed: int, bw: int, heads: int, n: int, rate: float):
    """The chunks design's output, CTA by CTA, chunk by chunk, as a (bw,
    heads, n, n) f32 tensor; asserts every element is written once."""
    nn, n_pad = n * n, (n + 7) // 8 * 8
    planes = bw * heads
    per_cta = planes_a_cta(nn)
    by_plane, by_row = divisor(nn), divisor(n)
    out = np.zeros(planes * nn, np.float32)
    writes = np.zeros(planes * nn, np.int64)
    for p0 in range(0, planes, per_cta):
        span = min(per_cta, planes - p0) * nn
        assert span < 2 ** 32 and (p0 * nn * 4) % 16 == 0
        e = 4 * np.arange(-(-span // 4), dtype=np.uint64)
        dp = divide(e, by_plane)
        rem = e - dp * np.uint64(nn)
        row = divide(rem, by_row)
        col = rem - row * np.uint64(n)
        idx_row = ((np.uint64(p0) + dp) * np.uint64(n_pad) + row) \
            * np.uint64(n_pad) & np.uint64(M32)
        for i in range(4):
            idx = (idx_row + col) & np.uint64(M32)
            keep = hash_keep(torch.from_numpy(idx.astype(np.int64)), seed,
                             rate).numpy()
            at = e + np.uint64(i)
            live = at < np.uint64(span)
            flat = p0 * nn + at[live].astype(np.int64)
            out[flat] = keep[live]
            writes[flat] += 1
            col = col + np.uint64(1)
            wrap = col == np.uint64(n)
            col[wrap] = 0
            idx_row[wrap] += np.uint64(n_pad)
            row[wrap] += np.uint64(1)
            plane = wrap & (row == np.uint64(n))
            row[plane] = 0
            idx_row[plane] += np.uint64((n_pad - n) * n_pad)
            idx_row &= np.uint64(M32)
    assert (writes == 1).all()
    return torch.from_numpy(out.reshape(bw, heads, n, n))


DIVISORS = [1, 2, 3, 7, 8, 49, 53, 56, 64, 2809, 3136, 4096, 2 ** 28,
            2 ** 31 - 1, 2 ** 31, 2 ** 31 + 1, 2 ** 32 - 1]


@pytest.mark.parametrize("d", DIVISORS)
def test_divide_is_exact_over_every_32_bit_x(d):
    """m = floor(2**64 / d) + 1 and floor(x m / 2**64) = floor(x / d) on
    random x and at every boundary the kernel's range has (q d - 1, q d,
    q d + 1 for the first and last quotients, 2**32 - 1)."""
    div = divisor(d)
    if d > 1:
        assert div[1] + (div[2] << 32) == 2 ** 64 // d + 1
    rng = np.random.default_rng(d)
    q_max = (2 ** 32 - 1) // d
    edges = {0, 1, 2 ** 32 - 1, d - 1, d, d + 1}
    for q in (1, 2, 3, q_max - 1, q_max, q_max + 1):
        edges |= {q * d - 1, q * d, q * d + 1}
    x = np.concatenate([rng.integers(0, 2 ** 32, 200_000, dtype=np.uint64),
                        np.array(sorted(e for e in edges
                                        if 0 <= e < 2 ** 32), np.uint64)])
    np.testing.assert_array_equal(divide(x, div), x // np.uint64(d))


@pytest.mark.parametrize("seed", [1234, 2 ** 31 - 2])
@pytest.mark.parametrize("bw,heads,n", [(3, 3, 53), (2, 3, 7), (3, 2, 64),
                                        (1, 1, 1), (5, 3, 3)])
def test_chunk_walk_is_keep_mask(bw, heads, n, seed):
    ours = chunk_walk(seed, bw, heads, n, 0.1)
    assert torch.equal(ours, keep_mask(seed, bw, heads, n, 0.1))


def test_mask_plan_keeps_offsets_in_range():
    """A CTA's run is a multiple of 4 whole planes, at least the chunks a
    thread the source asks for, and under 2**32 elements up to n 16,384
    (the entry's limit)."""
    threads = _constant(MASK_SOURCE, "kMaskThreads")
    per_thread = _constant(MASK_SOURCE, "kMaskChunksPerThread")
    for n in (1, 3, 7, 53, 56, 64, 1000, 16384):
        p = planes_a_cta(n * n)
        assert p % 4 == 0 and p * n * n >= 4 * threads * per_thread
        assert p * n * n < 2 ** 32
    assert "n > 16384" in MASK_SOURCE.read_text()


def test_keep_mask_wrapper_on_cpu_is_plain():
    before = (cuda_attn.mask_launches, dict(cuda_attn.mask_route_launches))
    ours = cuda_attn.dropout_keep_mask(2 ** 31 - 2, 3, 3, 53, 0.1,
                                       torch.device("cpu"))
    assert torch.equal(ours, keep_mask(2 ** 31 - 2, 3, 3, 53, 0.1))
    assert (cuda_attn.mask_launches,
            dict(cuda_attn.mask_route_launches)) == before


# ---- R11 ------------------------------------------------------------------

def ring_walk(heads: int, bw: int, grid: int):
    """Each CTA's visits [(head, window, bias reloaded)] in the kernel's
    order: pairs [c P / G, (c + 1) P / G), the window stepping with a
    carry into the head."""
    pairs = heads * bw
    walks = []
    for c in range(grid):
        first = pairs * c // grid
        count = pairs * (c + 1) // grid - first
        h, w = divmod(first, bw)
        bias_head, visits = -1, []
        for _ in range(count):
            visits.append((h, w, h != bias_head))
            bias_head = h
            w += 1
            if w == bw:
                w, h = 0, h + 1
        walks.append(visits)
    return walks


@pytest.mark.parametrize("heads", [3, 32])
@pytest.mark.parametrize("bw", [1, 7, 2881])
def test_ring_walk_covers_every_pair_once(bw, heads):
    pairs = heads * bw
    for grid in sorted({1, 2, 7, 132 * 3, 132 * 4, pairs}):
        grid = min(grid, pairs)
        walks = ring_walk(heads, bw, grid)
        seen = [h * bw + w for visits in walks for h, w, _ in visits]
        assert sorted(seen) == list(range(pairs))
        for visits in walks:
            assert visits, "a CTA with no pair"
            run = [h * bw + w for h, w, _ in visits]
            assert run == list(range(run[0], run[0] + len(run)))
            reloads = [h for h, _, r in visits if r]
            assert reloads == sorted({h for h, _, _ in visits})


def ring_plan(qn, kn, v, bias):
    """The ring design on head-major (heads, Bw, n, dh) operands in plain
    PyTorch: each window in a slot of 64 rows (rows n..63 zero), key-tile
    pairs wholly past n skipped, S + bias with keys >= n at -inf, P =
    exp(S - max) * (1 / sum) rounded to v's dtype, P.v in f32, rows < n."""
    heads, bw, n, dh = qn.shape
    rows = 64

    def slot(t):
        s = torch.zeros(heads, bw, rows, dh)
        s[:, :, :n] = t.float()
        return s

    q, k, vs = slot(qn), slot(kn), slot(v)
    s = q @ k.transpose(-1, -2)
    live_pairs = -(-n // 16) * 16
    s[..., live_pairs:] = 0.0
    key = torch.arange(rows)
    bb = torch.zeros(heads, rows, rows)
    bb[:, :n, :n] = bias
    bb[:, :, n:] = float("-inf")
    s = s + bb[:, None]
    e = torch.exp(s - s.max(-1, keepdim=True).values)
    p = (e * (1.0 / e.sum(-1, keepdim=True))).to(v.dtype).float()
    assert (p[..., key >= n] == 0).all()
    return (p @ vs).to(v.dtype)[:, :, :n]


def _staged(bw, n, dh, dtype, seed, heads=3):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((heads, bw, n, dh)) for _ in range(3))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    k /= np.linalg.norm(k, axis=-1, keepdims=True)
    bias = rng.standard_normal((heads, n, n))
    bias[0] -= 200.0
    bias[-1] *= 25.0
    return (*(torch.from_numpy(a.astype(np.float32)).to(dtype)
              for a in (q, k, v)), torch.from_numpy(bias.astype(np.float32)))


def _rel(ours, ref) -> float:
    ours, ref = ours.float(), ref.float()
    return ((ours - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dh", [16, 32, 48, 64])
@pytest.mark.parametrize("n", [17, 49, 56, 64])
def test_ring_plan_matches_plain(n, dh):
    ops = _staged(5, n, dh, torch.bfloat16, n * dh)
    assert _rel(ring_plan(*ops), plain.staged_headmajor_core(*ops)) <= 2e-2
    ops = _staged(2, n, dh, torch.float32, n + dh)
    assert _rel(ring_plan(*ops), plain.staged_headmajor_core(*ops)) <= 1e-5


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_plan_matches_r11_core_kernel(monkeypatch, dtype):
    """The plan on R1's staged repro inputs against R11's ``core_kernel``
    under the repro's pallas_call specs, in interpret mode, at BW 16."""
    bw = 16
    monkeypatch.setattr(RC, "BW", bw)
    x, wqkv, bias = rp1.inputs(bw, torch.float32, torch.device("cpu"), 0)
    tdt = getattr(torch, dtype)
    qn, kn, v = plain.stage_headmajor(x @ wqkv, RC.HEADS, RC.DIM_HEAD, tdt)
    spec = pl.BlockSpec((RC.HEADS, RC.BLK, RC.N_PAD, RC.DIM_HEAD),
                        lambda i: (0, i, 0, 0), memory_space=pltpu.VMEM)
    with pltpu.force_tpu_interpret_mode():
        call = pl.pallas_call(
            functools.partial(R11.core_kernel, heads=RC.HEADS, blk=RC.BLK),
            grid=(bw // RC.BLK,),
            in_specs=[spec, spec, spec,
                      pl.BlockSpec(memory_space=pltpu.VMEM)],
            out_specs=spec,
            out_shape=jax.ShapeDtypeStruct(tuple(qn.shape),
                                           getattr(jnp, dtype)))
        ref = np.asarray(call(*(jnp.asarray(t.float().numpy(),
                                            getattr(jnp, dtype))
                                for t in (qn, kn, v)),
                              jnp.asarray(bias.numpy())), np.float32)
    ours = ring_plan(qn, kn, v, bias)
    assert _rel(ours, torch.from_numpy(ref.copy())) <= {"float32": 1e-5,
                                                 "bfloat16": 2e-2}[dtype]


@pytest.mark.parametrize("dh", [16, 32, 48, 64])
def test_ring_fits_a_cta(dh):
    """kStages slots of q | k | v (64 rows at dh + 8) fit a CTA, at least
    one CTA an SM."""
    stages = _constant(R11_SOURCE, "kStages")
    assert _constant(R11_SOURCE, "kRingThreads") == 128
    need = chip_smoke.staged_ring_bytes(dh, stages)
    assert need == stages * 3 * 64 * (dh + 8) * 2
    assert need <= SMEM_LIMIT
    assert SM_SMEM // (need + RESERVED) >= 1


def test_staged_core_wrapper_on_cpu_is_plain():
    ops = _staged(7, 17, 32, torch.bfloat16, 3)
    before = (cuda_av.staged_core_launches,
              dict(cuda_av.staged_core_route_launches))
    torch.testing.assert_close(cuda_av.staged_attention_core(*ops),
                               plain.staged_headmajor_core(*ops),
                               rtol=0, atol=0)
    assert (cuda_av.staged_core_launches,
            dict(cuda_av.staged_core_route_launches)) == before


def test_staged_core_sections_patches_every_place():
    srcs = tool.variants(library.CSRC)
    assert set(srcs) == {"ring", "ring3", "ring4", "ring6", "noload",
                         "nomath", "nostore", "chunks", "bulk"}
    for name in ("ring3", "ring4", "ring6", "noload", "nomath", "nostore"):
        assert srcs[name] != srcs["ring"]
    assert "section: math" not in srcs["nomath"]
    assert "ldmatrix_x4(qa" not in srcs["nomath"]
    assert "pack_bf16(o[u][0], o[u][1])" not in srcs["nostore"]
    assert "cp.async.bulk.global.shared::cta" in srcs["bulk"]
    assert "__stcs" in srcs["chunks"] and "__stcs" not in srcs["bulk"]
    assert tool.included_headers(R11_SOURCE) == {"attention_common.cuh"}
    assert tool.included_headers(MASK_SOURCE) == {"dropout_hash.cuh"}
