"""The numeric plan and the register layouts of the per-head kernel's wgmma
design (R1, R14, R9), on the CPU.

In bf16 at dim_head 16 or 32 ``csrc/perhead_attention.cu`` runs every
product on warpgroup MMA: a window's rows padded to 64 (rows n..63 of x
zero), per head q | k | v = x . Wqkv_h with f32 sums, qn and kn
l2-normalised (no sqrt(dh), no gain), S = qn kn^T and O = P v from f32
operands split into a bf16 high part and the bf16 rounding of the remainder
(lo.hi + hi.lo + hi.hi, f32 sums), bias_h added to rows < n, the padded
keys at -inf before each row's own max, P normalised before its split, and
o_h rounded once to bf16 into columns h dh of rows < n.  Here that plan is
emulated in plain PyTorch at 3 heads x 16, dim 48 and n 9, 49, 56 and 64:

* against the port's plain ``perhead_qkv_attention``: with o_h kept in f32
  (f32 inputs holding bf16 values, where the plain version rounds nothing)
  within 2e-5 of max|out|, as ``tests/test_torch_port_fwd_split.py`` holds
  K1's plan; with bf16 inputs and o_h rounded, within one bf16 step at
  max|out|'s binade (2^(e - 7) for max|out| in [2^e, 2^(e+1))): both round
  o_h once, and an f32 sum in another order can round an element to the
  neighbouring bf16 value;
* against ``benchmarks/mosaic_repros/repro_baseline_perhead.py`` (R1 at 8
  windows a program, R14 at 16) and ``repro_perhead_weight_gemm.py`` (R9)
  run in Pallas TPU interpret mode, their geometry shrunk to these widths
  through monkeypatch (nothing in ``benchmarks/`` changes): within two bf16
  steps at max|reference|'s binade, one for each side's rounding of o_h.

The layouts the kernel's source note cites are tabulated from the PTX ISA
("Asynchronous Warpgroup Level Matrix Multiply"): the f32 accumulator of
m64nNk16, (thread, register) -> (row, column), whose rows each lie in one
quad of lanes, and the register A fragment of m64k16, which S's
accumulator, packed as bf16 pairs, is for the P.v product; and the 8 x 8
core-matrix layout into which the wrapper puts each head's Wqkv_h^T.  The
wrappers on CPU tensors run the plain version and count no route; the
route's documented widths follow from the kernel's shared-memory plan; and
``repros/perhead_sections.py`` finds every place it patches.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_baseline_perhead as R1
from benchmarks.mosaic_repros import repro_perhead_weight_gemm as R9
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_bwd_split import pad_rows, split_product
from tests.test_torch_port_fwd_split import REL
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as rp1
from vit_grid_model_tpu_torch.repros.perhead_weight_gemm import weight4

HEADS, DIM_HEAD, DIM = 3, 16, 48
BW = 16                    # two 8-window programs, one 16-window program
NS = [9, 49, 56, 64]
SMEM_LIMIT = 232448        # bytes of shared memory a CTA may have
SOURCE = library.CSRC / "perhead_attention.cu"
BODY = library.CSRC / "perhead_wgmma_body.cuh"


def inputs(n: int, dtype=torch.bfloat16, seed: int = 4):
    """(x, wqkv, bias) at these widths, from a numpy seed
    (``repros/baseline_perhead.inputs``); x and wqkv hold bf16 values in
    ``dtype``, the bias is f32."""
    x, wqkv, bias = rp1.inputs(BW, torch.bfloat16, torch.device("cpu"), seed,
                               n=n, dim=DIM, heads=HEADS, dim_head=DIM_HEAD)
    return x.to(dtype), wqkv.to(dtype), bias


def wgmma_plan(x, wqkv, bias, *, round_o=True) -> torch.Tensor:
    """The wgmma design in plain PyTorch, in f32 on the 64-row tile: x (bw,
    n, dim), wqkv R1's (dim, 3 heads dh), bias (heads, n, n).  Returns (bw,
    n, heads dh) in f32, o_h rounded to bf16 when ``round_o``."""
    bw, n, dim = x.shape
    heads, dh = bias.shape[0], wqkv.shape[1] // (3 * bias.shape[0])
    xp = pad_rows(x.float())                       # rows n..63 zero
    w = wqkv.float().reshape(dim, 3, heads, dh)
    out = []
    for h in range(heads):
        q, k, v = (xp @ w[:, i, h] for i in range(3))
        qn = q * torch.rsqrt((q * q).sum(-1, keepdim=True).clamp_min(1e-24))
        kn = k * torch.rsqrt((k * k).sum(-1, keepdim=True).clamp_min(1e-24))
        s = split_product(qn, kn.transpose(-1, -2))
        s[:, :n, :n] += bias[h]                    # rows >= n read no bias
        s[..., n:] = float("-inf")                 # the padded keys
        p = torch.softmax(s, dim=-1)               # each row's own max
        o = split_product(p, v)
        if round_o:
            o = o.bfloat16().float()
        out.append(o[:, :n])                       # rows < n are stored
    return torch.cat(out, dim=-1)


def _rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _bf16_steps(ours, ref) -> float:
    """max|ours - ref| in bf16 steps at max|ref|'s binade."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return float(np.abs(ours - ref).max() / step)


@pytest.mark.parametrize("n", NS)
def test_wgmma_plan_matches_plain(n):
    # split products, o_h in f32: the plain version in f32 rounds nothing
    x, wqkv, bias = inputs(n, torch.float32)
    ours = wgmma_plan(x, wqkv, bias, round_o=False)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    assert ours.shape == ref.shape == (BW, n, HEADS * DIM_HEAD)
    assert torch.isfinite(ours).all()
    assert _rel(ours, ref) <= REL
    # bf16: both round each head's output once
    x, wqkv, bias = inputs(n)
    ours = wgmma_plan(x, wqkv, bias)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    assert ref.dtype == torch.bfloat16
    assert _bf16_steps(ours, ref.float()) <= 1


def _jax(t, dtype=jnp.bfloat16):
    return jnp.asarray(t.float().numpy(), dtype)


@pytest.mark.parametrize("n", [56, 9])
@pytest.mark.parametrize("repro", ["R1", "R14", "R9"])
def test_wgmma_plan_matches_repro_interpret(monkeypatch, repro, n):
    for name, value in (("BW", BW), ("N_PAD", n), ("DIM", DIM),
                        ("HEADS", HEADS), ("DIM_HEAD", DIM_HEAD)):
        monkeypatch.setattr(RC, name, value)
    fn = {"R1": lambda: R1.build(8), "R14": lambda: R1.build(16),
          "R9": R9.build}[repro]()
    x, wqkv, bias = inputs(n)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(fn(_jax(x), _jax(wqkv), _jax(bias, jnp.float32)),
                         np.float32)
    assert ref.shape == (BW, n, HEADS * DIM_HEAD) and np.isfinite(ref).all()
    ours = wgmma_plan(x, wqkv, bias)
    assert _bf16_steps(ours.numpy(), ref) <= 2


# The PTX ISA's layouts of a warpgroup's registers, as tables.

def accumulator_layout(n_cols: int):
    """{(thread, register): (row, column)} of m64nNk16's f32 accumulator:
    warp w holds rows 16 w .. 16 w + 15, lane 4 g + t register 4 c + e the
    element at row 16 w + g + 8 (e // 2), column 8 c + 2 t + e % 2."""
    table = {}
    for thread in range(128):
        w, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for reg in range(n_cols // 2):
            c, e = reg // 4, reg % 4
            table[thread, reg] = (16 * w + g + 8 * (e // 2),
                                  8 * c + 2 * t + e % 2)
    return table


def a_fragment_layout():
    """{(thread, register, half): (row, column)} of the bf16 A fragment of
    m64k16 from registers: register j holds the pair (half 0 the low
    column) at row 16 w + g + 8 (j % 2), columns 8 (j // 2) + 2 t + half."""
    table = {}
    for thread in range(128):
        w, g, t = thread // 32, (thread % 32) // 4, thread % 4
        for j in range(4):
            for half in range(2):
                table[thread, j, half] = (16 * w + g + 8 * (j % 2),
                                          8 * (j // 2) + 2 * t + half)
    return table


@pytest.mark.parametrize("n_cols", [16, 32, 48, 64, 96])
def test_accumulator_rows_lie_in_one_quad(n_cols):
    table = accumulator_layout(n_cols)
    cells = set(table.values())
    assert len(cells) == len(table) == 64 * n_cols     # every element once
    assert cells == {(r, c) for r in range(64) for c in range(n_cols)}
    holders = {}
    for (thread, _), (row, _) in table.items():
        holders.setdefault(row, set()).add(thread)
    for row, threads in holders.items():
        # the four lanes 4 g .. 4 g + 3 of one warp: a quad's shuffles
        # (xor 1, xor 2) reduce the row
        assert len(threads) == 4
        base = min(threads)
        assert base % 4 == 0 and threads == set(range(base, base + 4))


def test_score_accumulator_packs_into_the_pv_a_fragment():
    """S's accumulator (m64n64k16), packed as the kernel packs it (register
    r of k16 step j from d[8 j + 2 r] and d[8 j + 2 r + 1]), is the A
    fragment of step j of P.v: the same thread holds the same (row, key);
    q's columns of the qkv accumulator pack into S's A fragments alike."""
    acc = accumulator_layout(64)
    frag = a_fragment_layout()
    for thread in range(128):
        for j in range(4):
            for r in range(4):
                for half in range(2):
                    row, col = acc[thread, 8 * j + 2 * r + half]
                    frow, fcol = frag[thread, r, half]
                    assert (row, col) == (frow, 16 * j + fcol)
    qkv = accumulator_layout(3 * 32)
    for thread in range(128):
        for j in range(2):                       # dh 32: two k16 steps
            for r in range(4):
                row, col = qkv[thread, 8 * j + 2 * r]
                assert (row, col) == (frag[thread, r, 0][0],
                                      16 * j + frag[thread, r, 0][1])


def core_offset(r: int, k: int, k_cols: int) -> int:
    """Byte offset of element (r, k) of a K-major bf16 operand in the 8 x 8
    core-matrix layout (``wgmma_common.cuh::core_offset``)."""
    return (((r // 8) * (k_cols // 8) + k // 8) * 128 + (r % 8) * 16
            + (k % 8) * 2)


def test_weight_tiles_and_bias_rows_are_the_kernels_layouts():
    """``_wgmma_operands`` puts each head's Wqkv_h^T element (r, k) at the
    core-matrix offset the descriptors read, and pads the bias rows to
    ``BIAS_LD`` floats."""
    rng = np.random.default_rng(1)
    heads, dim, dh, n = 2, 32, 16, 9
    w_heads = torch.from_numpy(rng.standard_normal((heads, dim, 3 * dh),
                                                   np.float32))
    bias = torch.from_numpy(rng.standard_normal((heads, n, n), np.float32))
    tiles, rows = cuda_av._wgmma_operands(w_heads, bias)
    assert tiles.is_contiguous() and tiles.numel() == w_heads.numel()
    flat = tiles.reshape(heads, -1)
    offsets = {core_offset(r, k, dim) for r in range(3 * dh)
               for k in range(dim)}
    assert offsets == set(range(0, 2 * 3 * dh * dim, 2))
    for h in range(heads):
        for r in range(3 * dh):
            for k in range(0, dim, 5):
                assert (flat[h, core_offset(r, k, dim) // 2]
                        == w_heads[h, k, r])
    assert rows.shape == (heads, n, cuda_av.BIAS_LD) and rows.is_contiguous()
    assert torch.equal(rows[..., :n], bias)
    assert (rows[..., n:] == 0).all()


def test_wrappers_on_cpu_count_no_route():
    """On CPU tensors R1's, R14's and R9's wrappers run the plain version
    and count no launch on either design, and load no library."""
    x, wqkv, bias = inputs(9)
    before = dict(cuda_av.perhead_route_launches)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    for wpc in (8, 16):
        torch.testing.assert_close(
            cuda_av.perhead_attention(x, wqkv, bias, wpc), ref, rtol=0,
            atol=0)
    torch.testing.assert_close(
        cuda_av.perhead_weight_attention(x, weight4(wqkv, HEADS), bias), ref,
        rtol=0, atol=0)
    assert dict(cuda_av.perhead_route_launches) == before
    assert library._lib is None


def _constant(name: str) -> int:
    """A constant of the per-head source or of the wgmma body's header."""
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                  SOURCE.read_text() + BODY.read_text())
    assert m, name
    return int(m.group(1))


def wgmma_smem_bytes(n: int, dim: int, dh: int) -> int:
    """``make_wgmma_plan``'s bytes: two weight-tile and two bias-row
    buffers, each warpgroup's x buffer and four n x n operand planes, two
    mbarriers and two counters, each part 128-byte aligned."""
    def a128(b):
        return (b + 127) // 128 * 128
    wgs = _constant("kWarpgroups")
    x_bytes, kv = 64 * dim * 2, 64 * dh * 2
    off = 2 * a128(3 * dh * dim * 2) + 2 * a128(n * cuda_av.BIAS_LD * 4)
    off += wgs * a128(x_bytes + 4 * kv)
    return a128(off + 2 * 8 + 2 * 4)


def test_route_widths_follow_the_shared_memory_plan(monkeypatch):
    """The widths ``perhead_route`` documents for the wgmma design: dim a
    multiple of 16 up to 176 at dim_head 32 and 288 at 16 (the next
    multiple does not fit a CTA), n up to 64; the repros' (dim 128, dh 32)
    and the small case (dim 48, dh 16) among them.  The route's name is the
    kernel export's index into PERHEAD_ROUTES."""
    assert _constant("kBiasLd") == cuda_av.BIAS_LD
    assert _constant("kMaxSmem") == SMEM_LIMIT
    for dh, widest in ((32, 176), (16, 288)):
        assert wgmma_smem_bytes(64, widest, dh) <= SMEM_LIMIT
        assert wgmma_smem_bytes(64, widest + 16, dh) > SMEM_LIMIT
    for n, dim, dh in ((56, 128, 32), (64, 128, 32), (9, 128, 32),
                       (56, 48, 16)):
        assert wgmma_smem_bytes(n, dim, dh) <= SMEM_LIMIT
    assert cuda_av.perhead_route.__doc__.count("176") == 1
    assert "288" in cuda_av.perhead_route.__doc__

    class Lib:
        def vgm_perhead_attention_route(self, n, dim, dh, is_bf16):
            return int(is_bf16 and dh in (16, 32))

    monkeypatch.setattr(library, "load", lambda: Lib())
    assert cuda_av.perhead_route(56, 128, 32, torch.bfloat16) == "wgmma"
    assert cuda_av.perhead_route(56, 128, 32, torch.float32) == "first"
    assert cuda_av.perhead_route(56, 128, 64, torch.bfloat16) == "first"


def test_perhead_sections_patches_every_place():
    """``repros/perhead_sections.py`` finds its places in the committed
    source (its headers inlined): a stamp after each of the first design's
    six sections and the wgmma design's seven, the counts opened and
    flushed in both kernels, the wgmma design at the other warpgroup
    counts and without its next-window copies (the body's, shared with R4
    and R3, whose earlier form the tool also takes from a parent)."""
    from vit_grid_model_tpu_torch.repros import perhead_sections as tool

    v = tool.variants(library.CSRC)
    default = _constant("kWarpgroups")
    others = {f"wg{k}" for k in tool.WARPGROUP_COUNTS if k != default}
    assert set(v) == {"plain", "stamp", "nocopy"} | others
    assert tool.NEXT_COPY in v["plain"] and tool.NEXT_COPY not in v["nocopy"]
    for text in v.values():
        assert '#include "' not in text
        for export in ("_route", "_occupancy", "_wgmma"):
            assert "vgm_perhead_attention" + export in text
        assert "sections_occupancy_of" not in text
    for name in others:
        assert tool.WARPGROUPS.format(name[2:]) in v[name]
        assert tool.WARPGROUPS.format(default) not in v[name]
    stamp = v["stamp"]
    assert stamp.count("STAMP(") == (len(tool.FIRST_SECTIONS)
                                     + len(tool.WGMMA_SECTIONS) + 1)
    assert stamp.count("atomicAdd(&g_sections[k]") == 2
    assert stamp.count("long long sec_acc[16]") == 2
    for k in range(len(tool.WGMMA_SECTIONS)):
        assert f"STAMP({tool.WGMMA_BASE + k});" in stamp
    assert tool.NEXT_COPY == tool.NEXT_COPIES[0]
    assert all(c not in v["plain"] for c in tool.NEXT_COPIES[1:])


def test_ptxas_report_is_read():
    from vit_grid_model_tpu_torch.repros import perhead_sections as tool

    log = "\n".join([
        "ptxas info    : Compiling entry function '_Z1kv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1kv",
        "    80 bytes stack frame, 0 bytes spill stores, 0 bytes spill "
        "loads",
        "ptxas info    : Used 162 registers, used 16 barriers, 80 bytes "
        "cumulative stack size",
        "ptxas info    : Compiling entry function '_Z1jv' for 'sm_90a'",
        "ptxas info    : Function properties for _Z1jv",
        "    0 bytes stack frame, 44 bytes spill stores, 60 bytes spill "
        "loads",
        "ptxas info    : Used 128 registers, used 1 barriers"])
    got = tool.ptxas_kernels(log)
    assert sorted(got.values()) == [(128, 44, 60), (162, 0, 0)]
