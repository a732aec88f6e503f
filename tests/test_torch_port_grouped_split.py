"""R4's and R3's kernels on the per-head kernel's wgmma body, on the CPU:
the numeric plan, the indicator norm's register layouts, the shared-memory
plan and the head-buffer schedule.

In bf16 at dim_head 16 or 32 ``csrc/headmajor_attention.cu`` (R4) and
``csrc/crosshead_norm_attention.cu`` (R3) run ``csrc/perhead_wgmma_body.cuh``
with G heads on one staged x: each warpgroup of a CTA takes the CTA's
windows wgi, wgi + 3, ... and runs its steps in the order (head group,
window, head in the group), each head as the per-head kernel's wgmma
design does (``tests/test_torch_port_perhead_split.py::wgmma_plan``).  R3
takes the q and k norms as one product of the squared q | k, split into
bf16 high and low parts, with the exact 0/1 indicator (m64n8k16 steps from
registers), where R4 sums them by quad shuffles.  Here:

* that plan, with its step order and either norm, is emulated in plain
  PyTorch at 3 heads x 16, dim 48, G 2 (a ragged last group) and n 9, 49,
  56, 64: every (window, head) is computed once, x is staged once a (group,
  window), and the output is held to the plain ``perhead_qkv_attention``
  (f32 inputs holding bf16 values, o_h in f32: within 2e-5 of max|out|;
  bf16: one bf16 step at max|out|'s binade) and to R4's and R3's TPU
  repros run in Pallas TPU interpret mode with their geometry shrunk
  through monkeypatch (nothing in ``benchmarks/`` changes): f32 within
  2e-5, bf16 within two bf16 steps;
* the indicator product's layouts, from the PTX ISA's tables: the squares'
  A fragments from the qkv accumulator, the 0/1 B operand in core matrices
  (each k16 step 256 bytes on), and the m64n8 accumulator's columns 0 and 1
  in lane 4 g of each quad; the hi/lo split's sums within 2^-14 of sum q^2;
* the shared-memory plan at G 1 and 2 and 2 or 3 warpgroups against
  232,448 B, and the widths the routes take;
* a step-by-step model of the head-buffer schedule (fills, mbarrier
  parities, the counters of warpgroups done with a group, the last
  finisher's refills) in random interleavings, for ragged groups and
  ragged window counts: no read precedes its fill, no fill lands in a
  buffer still to be read, no two live groups share a counter;
* the wrappers on CPU tensors, and ``repros/grouped_sections.py``'s patch
  points in the committed sources.
"""

import random
import re
from collections import Counter

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import chip_smoke
from benchmarks.mosaic_repros import common as RC
from benchmarks.mosaic_repros import repro_crosshead_rmsnorm_gemm as R3
from benchmarks.mosaic_repros import repro_headmajor_batched as R4
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_bwd_split import pad_rows, split, split_product
from tests.test_torch_port_fwd_split import REL
from tests.test_torch_port_perhead_split import (
    a_fragment_layout, accumulator_layout, core_offset)
from vit_grid_model_tpu_torch.ops import attention_variants as plain
from vit_grid_model_tpu_torch.ops.cuda import attention_variants as cuda_av
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.repros import baseline_perhead as rp1

HEADS, DIM_HEAD, DIM = 3, 16, 48
BW = 16                    # two 8-window CTAs
GROUP = 2                  # the wrappers' heads a staged x
WINDOWS_PER_CTA = 8
WARPGROUPS = 3
SMEM_LIMIT = 232448
SOURCES = {"R4": library.CSRC / "headmajor_attention.cu",
           "R3": library.CSRC / "crosshead_norm_attention.cu"}
BODY = library.CSRC / "perhead_wgmma_body.cuh"


def inputs(n: int, dtype=torch.bfloat16, seed: int = 4):
    """(x, wqkv, bias) at these widths from a numpy seed; x and wqkv hold
    bf16 values in ``dtype``, the bias is f32."""
    x, wqkv, bias = rp1.inputs(BW, torch.bfloat16, torch.device("cpu"), seed,
                               n=n, dim=DIM, heads=HEADS, dim_head=DIM_HEAD)
    return x.to(dtype), wqkv.to(dtype), bias


def indicator(dh: int) -> torch.Tensor:
    """The 0/1 indicator (2 dh, 8): column 0 on q's columns, 1 on k's."""
    ind = torch.zeros(2 * dh, 8)
    ind[:dh, 0] = 1.0
    ind[dh:, 1] = 1.0
    return ind


def norms(q, k, indicator_norm: bool):
    """rsqrt(max(sum of squares, 1e-24)) of q's and k's rows: as one
    product of the split squares of q | k with the indicator (R3), or as
    row sums (R4)."""
    if indicator_norm:
        sq = torch.cat([q, k], -1).square()
        hi, lo = split(sq)
        ind = indicator(q.shape[-1])
        sums = lo @ ind + hi @ ind            # the small part first
        sums = sums[..., :1], sums[..., 1:2]
    else:
        sums = ((q * q).sum(-1, keepdim=True), (k * k).sum(-1, keepdim=True))
    return tuple(torch.rsqrt(s.clamp_min(1e-24)) for s in sums)


def head_step(xw, w_h, bias_h, n, indicator_norm, round_o):
    """One (window, head) step of the body on the 64-row tile."""
    q, k, v = (xw @ w_h[:, i] for i in range(3))
    sq, sk = norms(q, k, indicator_norm)
    s = split_product(q * sq, (k * sk).transpose(-1, -2))
    s[:n, :n] += bias_h                       # rows >= n read no bias
    s[:, n:] = float("-inf")                  # the padded keys
    o = split_product(torch.softmax(s, dim=-1), v)
    return (o.bfloat16().float() if round_o else o)[:n]


def grouped_plan(x, wqkv, bias, group, *, indicator_norm=False,
                 round_o=True):
    """The body in plain PyTorch, in its step order: each CTA of
    ``WINDOWS_PER_CTA`` windows, each of its ``WARPGROUPS`` warpgroups its
    windows wgi, wgi + 3, ..., steps (group, window, head in the group).
    Returns (out (bw, n, heads dh) f32, {(cta, wgi): [(group, window, head)
    in order]}, the x copies a warpgroup makes)."""
    bw, n, dim = x.shape
    heads, dh = bias.shape[0], wqkv.shape[1] // (3 * bias.shape[0])
    xp = pad_rows(x.float())                  # rows n..63 zero
    w = wqkv.float().reshape(dim, 3, heads, dh)
    out = torch.full((bw, n, heads * dh), float("nan"))
    steps, copies = {}, Counter()
    for cta in range((bw + WINDOWS_PER_CTA - 1) // WINDOWS_PER_CTA):
        w0 = cta * WINDOWS_PER_CTA
        nw = min(WINDOWS_PER_CTA, bw - w0)
        for wgi in range(WARPGROUPS):
            order = steps.setdefault((cta, wgi), [])
            for h0 in range(0, heads, group):
                for win in range(w0 + wgi, w0 + nw, WARPGROUPS):
                    xw = xp[win]              # staged once for the group
                    copies[cta, wgi] += 1
                    for h in range(h0, min(h0 + group, heads)):
                        order.append((h0 // group, win, h))
                        out[win, :, h * dh:(h + 1) * dh] = head_step(
                            xw, w[:, :, h], bias[h], n, indicator_norm,
                            round_o)
    return out, steps, copies


def _rel(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    return float(np.abs(ours - ref).max() / np.abs(ref).max())


def _bf16_steps(ours, ref) -> float:
    """max|ours - ref| in bf16 steps at max|ref|'s binade."""
    ours, ref = np.asarray(ours, np.float32), np.asarray(ref, np.float32)
    step = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
    return float(np.abs(ours - ref).max() / step)


@pytest.mark.parametrize("indicator_norm", [False, True], ids=["R4", "R3"])
@pytest.mark.parametrize("n", [9, 49, 56, 64])
def test_grouped_plan_matches_plain(n, indicator_norm):
    x, wqkv, bias = inputs(n, torch.float32)
    ours, steps, copies = grouped_plan(x, wqkv, bias, GROUP,
                                       indicator_norm=indicator_norm,
                                       round_o=False)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    assert ours.shape == ref.shape == (BW, n, HEADS * DIM_HEAD)
    assert torch.isfinite(ours).all()
    assert _rel(ours, ref) <= REL
    # every (window, head) once; a warpgroup's steps go (group, window,
    # head); x staged once a (group, window): two groups (2 heads and 1)
    done = Counter((win, h) for order in steps.values()
                   for _, win, h in order)
    assert done == Counter({(win, h): 1 for win in range(BW)
                            for h in range(HEADS)})
    for (cta, wgi), order in steps.items():
        assert order == sorted(order)
        windows = len(range(wgi, WINDOWS_PER_CTA, WARPGROUPS))
        assert copies[cta, wgi] == 2 * windows
    x, wqkv, bias = inputs(n)
    ours, _, _ = grouped_plan(x, wqkv, bias, GROUP,
                              indicator_norm=indicator_norm)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    assert _bf16_steps(ours, ref.float()) <= 1


def test_grouped_plan_does_not_depend_on_the_group():
    """A head's output is the same at every G (the same k-order), as the
    kernel's R4 output is bit-identical to the per-head kernel's."""
    x, wqkv, bias = inputs(56)
    outs = [grouped_plan(x, wqkv, bias, g)[0] for g in (1, 2, 3)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def _jax(t, dtype):
    return jnp.asarray(t.float().numpy(), getattr(jnp, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n", [56, 9])
@pytest.mark.parametrize("repro", ["R4", "R3"])
def test_grouped_plan_matches_repro_interpret(monkeypatch, repro, n, dtype):
    for name, value in (("BW", BW), ("N_PAD", n), ("DIM", DIM),
                        ("HEADS", HEADS), ("DIM_HEAD", DIM_HEAD)):
        monkeypatch.setattr(RC, name, value)
    module = {"R4": R4, "R3": R3}[repro]
    x, wqkv, bias = inputs(n, getattr(torch, dtype))
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(module.build()(
            _jax(x, dtype), _jax(wqkv, dtype), _jax(bias, "float32")),
            np.float32)
    assert ref.shape == (BW, n, HEADS * DIM_HEAD) and np.isfinite(ref).all()
    ours, _, _ = grouped_plan(x, wqkv, bias, GROUP,
                              indicator_norm=repro == "R3",
                              round_o=dtype == "bfloat16")
    if dtype == "float32":
        assert _rel(ours, ref) <= REL
    else:
        assert _bf16_steps(ours.numpy(), ref) <= 2


# The indicator product's register layouts (PTX ISA, "Asynchronous Warpgroup
# Level Matrix Multiply"), from tests/test_torch_port_perhead_split.py's
# tables.

@pytest.mark.parametrize("dh", [16, 32])
def test_indicator_a_fragments_are_the_squared_qk_accumulator(dh):
    """Register r of k16 step j of the squares' A fragments, packed from
    the qkv accumulator's d[8 j + 2 r] and d[8 j + 2 r + 1] as the kernel
    packs them, holds the element the fragment's layout puts there: row
    16 w + g (+8), column 16 j + 2 t (+1, +8) of q | k, whose 2 dh columns
    are the accumulator's first (q, then k)."""
    acc = accumulator_layout(3 * dh)
    frag = a_fragment_layout()
    for thread in range(128):
        for j in range(2 * dh // 16):
            for r in range(4):
                for half in range(2):
                    row, col = acc[thread, 8 * j + 2 * r + half]
                    frow, fcol = frag[thread, r, half]
                    assert (row, col) == (frow, 16 * j + fcol)
                    assert col < 2 * dh


@pytest.mark.parametrize("dh", [16, 32])
def test_indicator_b_operand_in_core_matrices(dh):
    """The kernel writes the indicator^T (8 x 2 dh, K-major) at
    ``core_offset(c, k, 2 dh)``: read back as m64n8k16's B, element (k, c)
    is the exact 0/1 indicator; k16 step j's two core matrices lie at 256 j
    and 256 j + 128 (the descriptor's start and its 128-byte leading
    offset); the whole is 2 dh x 8 bf16."""
    image = np.zeros(8 * 2 * dh * 2, np.uint8)
    one = np.frombuffer(torch.tensor([1.0], dtype=torch.bfloat16).view(
        torch.int16).numpy().tobytes(), np.uint8)
    for e in range(8 * 2 * dh):
        c, k = e // (2 * dh), e % (2 * dh)
        if c == k // dh:
            off = core_offset(c, k, 2 * dh)
            image[off:off + 2] = one
    assert image.nbytes == (1024 if dh == 32 else 512)
    ind = indicator(dh)
    for k in range(2 * dh):
        for c in range(8):
            off = core_offset(c, k, 2 * dh)
            j = k // 16
            assert 256 * j <= off < 256 * j + 256
            assert (off - 256 * j) // 128 == (k % 16) // 8
            got = torch.from_numpy(image[off:off + 2].copy()).view(
                torch.bfloat16).float().item()
            assert got == ind[k, c]


def test_indicator_sums_lie_in_lane_4g_of_each_quad():
    """m64n8's accumulator holds column 0 (q's sum) and 1 (k's) of rows
    16 w + g and + 8 in lane 4 g of the warp, registers 0, 1 (row r0) and
    2, 3 (row r0 + 8): the four lanes of a quad share their rows, so each
    reads its sums from lane ``lane & ~3``."""
    acc = accumulator_layout(8)
    for thread in range(128):
        w, lane = thread // 32, thread % 32
        g = lane // 4
        src = 32 * w + (lane & ~3)
        rows = (16 * w + g, 16 * w + g + 8)
        assert acc[src, 0] == (rows[0], 0) and acc[src, 1] == (rows[0], 1)
        assert acc[src, 2] == (rows[1], 0) and acc[src, 3] == (rows[1], 1)
        # this thread's own rows of the qkv accumulator are the same
        qkv = accumulator_layout(96)
        assert {qkv[thread, reg][0] for reg in range(48)} == set(rows)


@pytest.mark.parametrize("scale", [1e-3, 1.0, 37.0])
def test_hi_lo_split_sums_lie_within_2_pow_minus_14(scale):
    """The squares split into a bf16 high part and the bf16 rounding of the
    remainder, summed against the 0/1 indicator in f32, lie within 2^-14
    of sum q^2 (f64), where the squares rounded once to bf16 would not."""
    rng = np.random.default_rng(7)
    qk = torch.from_numpy(rng.standard_normal((64, 64)).astype(np.float32)
                          * scale)
    exact = (qk.double() ** 2) @ indicator(32).double()
    sq = qk.square()
    hi, lo = split(sq)
    ind = indicator(32)
    ours = lo @ ind + hi @ ind
    bound = 2.0 ** -14 * exact
    assert ((ours.double() - exact).abs() <= bound).all()
    once = sq.bfloat16().float() @ ind
    assert ((once.double() - exact).abs() > bound).any()


def test_r1_bound_tells_the_hi_lo_split_from_bf16_squares(monkeypatch):
    """The bound by which the card holds R3's kernel to R1's
    (``grouped_sections.against_r1``: at most ``R3_GAP`` of max|plain| and
    ``R3_DIFFER_SHARE`` of the elements different) holds for the plan with
    R3's hi/lo split norm against the plan with the shuffle norm, as the
    kernels differ, and fails for the squares rounded once to bf16 (the
    sections tool's ``hionly`` control), at n 56 in bf16."""
    from vit_grid_model_tpu_torch.repros import grouped_sections as tool

    x, wqkv, bias = inputs(56)
    scale = plain.perhead_qkv_attention(
        x, wqkv, bias, HEADS, DIM_HEAD).float().abs().max().item()
    r1_out = grouped_plan(x, wqkv, bias, GROUP)[0]
    r3_out = grouped_plan(x, wqkv, bias, GROUP, indicator_norm=True)[0]
    gap, share, _ = tool.against_r1(r3_out, r1_out, scale)
    assert 0 < share <= tool.R3_DIFFER_SHARE and gap <= tool.R3_GAP
    monkeypatch.setitem(globals(), "split", lambda a: (
        a.bfloat16().float(), torch.zeros_like(a)))
    hi_out = grouped_plan(x, wqkv, bias, GROUP, indicator_norm=True)[0]
    _, hi_share, _ = tool.against_r1(hi_out, r1_out, scale)
    assert hi_share > 5 * tool.R3_DIFFER_SHARE, hi_share


# The shared-memory plan and the routes' widths.

def _constant(path, name: str) -> int:
    m = re.search(rf"constexpr (?:int|size_t) {name} = (\d+);",
                  path.read_text())
    assert m, (path.name, name)
    return int(m.group(1))


# chip_smoke's model of ``make_wgmma_plan``; the card tests hold it to the
# kernels' occupancy exports
plan_bytes = chip_smoke.wgmma_plan_bytes
grouped_design = chip_smoke.grouped_design


@pytest.mark.parametrize("warpgroups", [2, 3])
@pytest.mark.parametrize("group", [1, 2])
def test_shared_memory_plan(group, warpgroups):
    """At the repros' widths (n 56, dim 128, dh 32): the layouts the
    sections tool sweeps, (a) three warpgroups and three head buffers (the
    kernels' own) and (b) two and four, fit 232,448 B a CTA at G 1 and 2;
    three warpgroups with four buffers do not.  Two buffers hold G 2 too,
    without the next group's first head ahead."""
    assert _constant(BODY, "kMaxSmem") == SMEM_LIMIT
    fits = {b: plan_bytes(56, 128, 32, b, warpgroups) <= SMEM_LIMIT
            for b in range(group, 5)}
    want = {2: {b: True for b in range(group, 5)},
            3: {b: b <= 3 for b in range(group, 5)}}[warpgroups]
    assert fits == want
    wgs = _constant(BODY, "kGroupWarpgroups")
    bufs = _constant(BODY, "kGroupBuffers")
    assert (wgs, bufs) == (3, 3)
    assert _constant(BODY, "kMaxWgmmaGroup") == GROUP <= bufs
    assert _constant(BODY, "kBiasLd") == cuda_av.BIAS_LD
    assert plan_bytes(56, 128, 32, 3, 3) == 220544
    assert plan_bytes(56, 128, 32, 3, 3, True) == 221568
    assert plan_bytes(56, 128, 32, 2, 3) == 179840     # R1's plan
    assert plan_bytes(56, 128, 32, 4, 2) == 228480
    assert plan_bytes(64, 128, 32, 4, 2) > SMEM_LIMIT  # (b) misses n 64


def test_route_widths_follow_the_shared_memory_plan(monkeypatch):
    """The widths the wrappers document: dim a multiple of 16 up to 128 at
    dim_head 32 and 224 at 16 for every n <= 64 (more at small n); the
    repros' (dim 128, dh 32) and the small case (dim 48, dh 16) among them,
    the first design for f32, dim_head 64, three heads a staged x, n 65 and
    dim 144 at dim_head 32; the route's name is the kernel export's index
    into PERHEAD_ROUTES."""
    for dh, widest in ((32, 128), (16, 224)):
        for ind in (False, True):
            assert all(grouped_design(n, widest, dh, "bfloat16", 2, ind)
                       == "wgmma" for n in range(1, 65))
            assert grouped_design(64, widest + 16, dh, "bfloat16", 2,
                                  ind) == "first"
    assert grouped_design(9, 176, 32, "bfloat16", 2) == "wgmma"
    for n, dim, dh, dt, g, want in (
            (56, 128, 32, "bfloat16", 2, "wgmma"),
            (56, 48, 16, "bfloat16", 1, "wgmma"),
            (9, 176, 32, "bfloat16", 1, "wgmma"),
            (56, 128, 32, "float32", 2, "first"),
            (56, 128, 64, "bfloat16", 2, "first"),
            (56, 128, 32, "bfloat16", 3, "first"),
            (64, 144, 32, "bfloat16", 2, "first"),
            (65, 128, 32, "bfloat16", 2, "first")):
        assert grouped_design(n, dim, dh, dt, g) == want, (n, dim, dh, dt, g)
    assert "128" in cuda_av.grouped_route.__doc__
    assert "224" in cuda_av.grouped_route.__doc__

    class Lib:
        def vgm_headmajor_attention_route(self, n, dim, dh, group, is_bf16):
            return int(is_bf16 and dh in (16, 32) and group <= 2)

        vgm_crosshead_norm_attention_route = vgm_headmajor_attention_route

    monkeypatch.setattr(library, "load", lambda: Lib())
    assert cuda_av.headmajor_route(56, 128, 32, torch.bfloat16) == "wgmma"
    assert cuda_av.crosshead_route(56, 128, 32, torch.bfloat16) == "wgmma"
    assert cuda_av.headmajor_route(56, 128, 32, torch.float32) == "first"
    assert cuda_av.crosshead_route(56, 128, 32, torch.bfloat16, 3) == "first"


# A step-by-step model of the head-buffer schedule.

def run_schedule(heads, group, buffers, warpgroups, windows, seed,
                 counters=None):
    """Steps the body's schedule for one CTA in a random interleaving of
    its warpgroups and of the bulk copies' landings, as the kernel runs it:
    the first ``buffers`` heads staged at the start; a warpgroup waits for
    a head's fill (mbarrier parity (h / buffers) & 1 of buffer h % buffers)
    at the group's start, or before its first window reads it when G > 1
    and it has windows; the last warpgroup done with a group (counter
    group % ``counters``) refills the group's buffers with heads h +
    ``buffers``.  Raises AssertionError when a wait passes before its own
    fill landed, a read finds another head or an unlanded fill, a fill is
    issued into a buffer a warpgroup will still read, two live groups
    share a counter, or no step can run."""
    counters = counters or buffers
    rng = random.Random(seed)
    issued = [[] for _ in range(buffers)]     # heads filled into a buffer
    landed = [0] * buffers                    # fills landed (the phase)
    flying = []                               # fills issued, not landed
    done = [0] * counters
    owner = [None] * counters                 # the group a counter counts
    groups_done = [0] * warpgroups            # groups a warpgroup finished

    def issue(h):
        b = h % buffers
        old = issued[b][-1] if issued[b] else None
        if old is not None:                   # every warpgroup past it
            assert all(d > old // group for d in groups_done), (h, old)
        issued[b].append(h)
        flying.append(b)

    def program(wgi):
        count = len(range(wgi, windows, warpgroups))
        for h0 in range(0, heads, group):
            gn = min(group, heads - h0)
            lazy = group > 1 and count > 0
            if not lazy:
                for gh in range(gn):
                    yield "wait", h0 + gh
            for j in range(count):
                for gh in range(gn):
                    if lazy and j == 0:
                        yield "wait", h0 + gh
                    yield "read", h0 + gh
            yield "done", h0

    for h in range(min(buffers, heads)):
        issue(h)
    progs = [program(wgi) for wgi in range(warpgroups)]
    nexts = [next(p, None) for p in progs]
    reads = Counter()

    def ready(action):
        kind, h = action
        b = h % buffers
        # mbarrier.try_wait.parity passes once the phase of that parity,
        # the current one or the one before, has completed
        return kind != "wait" or landed[b] % 2 != (h // buffers) % 2

    while any(a is not None for a in nexts) or flying:
        choices = [("wg", i) for i, a in enumerate(nexts)
                   if a is not None and ready(a)]
        choices += [("land", i) for i in range(len(flying))]
        assert choices, f"deadlock: {nexts}"
        kind, i = rng.choice(choices)
        if kind == "land":
            landed[flying.pop(i)] += 1
            continue
        what, h = nexts[i]
        b = h % buffers
        if what == "wait":                    # its own fill, none later
            assert landed[b] == h // buffers + 1, (h, landed[b])
        elif what == "read":
            assert issued[b][-1] == h and landed[b] == len(issued[b]), h
            reads[h] += 1
        else:
            g = h // group
            c = g % counters
            assert owner[c] in (None, g), (g, owner[c])
            owner[c] = g
            done[c] += 1
            groups_done[i] += 1
            if done[c] == warpgroups:
                done[c], owner[c] = 0, None
                for gh in range(min(group, heads - h)):
                    if h + gh + buffers < heads:
                        issue(h + gh + buffers)
        nexts[i] = next(progs[i], None)
    assert reads == Counter({h: windows for h in range(heads)})


@pytest.mark.parametrize("heads,group,buffers,warpgroups", [
    (32, 2, 3, 3),      # layout (a), the kernels' own
    (32, 2, 4, 2),      # layout (b)
    (32, 1, 2, 3),      # R1's
    (32, 1, 3, 3),      # R4 and R3 at G 1
    (32, 2, 2, 3),      # G 2 on two buffers: a stall a group, no fault
    (3, 2, 3, 3),       # a ragged last group, every head staged at once
    (5, 2, 3, 3),       # a ragged last group with refills
    (7, 2, 4, 2)])
def test_buffer_schedule_has_no_hazard(heads, group, buffers, warpgroups):
    """For 1, 2, 5 and 8 windows a CTA (warpgroups with none, ragged
    counts) over many interleavings."""
    for windows in (1, 2, 5, 8):
        for seed in range(12):
            run_schedule(heads, group, buffers, warpgroups, windows, seed)


def test_buffer_schedule_catches_shared_counters():
    """The model finds the fault of two counters at three buffers and G 1:
    a warpgroup with no window runs two groups ahead and counts the next
    group on a counter the slowest still counts."""
    with pytest.raises(AssertionError):
        for seed in range(50):
            run_schedule(32, 1, 3, 3, 1, seed, counters=2)


# The wrappers and the sections tool.

def test_wrappers_on_cpu_count_no_route():
    """On CPU tensors R4's and R3's wrappers run the plain version at any
    group and count no launch on either design."""
    x, wqkv, bias = inputs(9)
    ref = plain.perhead_qkv_attention(x, wqkv, bias, HEADS, DIM_HEAD)
    before = (dict(cuda_av.headmajor_route_launches),
              dict(cuda_av.crosshead_route_launches))
    for g in (None, 1, 2):
        for fn in (cuda_av.headmajor_attention,
                   cuda_av.crosshead_norm_attention):
            torch.testing.assert_close(fn(x, wqkv, bias, g), ref, rtol=0,
                                       atol=0)
    assert (dict(cuda_av.headmajor_route_launches),
            dict(cuda_av.crosshead_route_launches)) == before
    assert cuda_av.WGMMA_GROUP == GROUP


def test_grouped_sections_patches_every_place():
    """``repros/grouped_sections.py`` finds its places in the committed
    sources (headers inlined): a build a layout with both constants
    replaced, a ``nocopy`` build without the next-window copy, R3's
    ``hionly`` control without the low parts' indicator step, a stamp
    after each of the body's sections, the counts opened and flushed once
    in the body's kernel."""
    from vit_grid_model_tpu_torch.repros import grouped_sections as tool

    for name, (source, entry) in tool.KERNELS.items():
        v = tool.variants(library.CSRC / source)
        control = {"hionly"} if name == "R3" else set()
        assert set(v) == set(tool.LAYOUTS) | {"nocopy", "stamp"} | control
        if control:   # R3's indicator product without its low parts' step
            assert tool.INDICATOR_STEPS in v["a"]
            assert tool.INDICATOR_STEPS not in v["hionly"]
            assert v["hionly"].count(tool.HI_ONLY_STEP) == 1
        for layout, wb in tool.LAYOUTS.items():
            assert tool.layout_of(v[layout]) == wb
        for text in v.values():
            assert '#include "' not in text
            for export in ("_route", "_occupancy", "_wgmma"):
                assert entry + export in text
        assert any(c in v["a"] for c in tool.NEXT_COPIES)
        assert not any(c in v["nocopy"] for c in tool.NEXT_COPIES)
        stamp = v["stamp"]
        assert stamp.count("STAMP(") == len(tool.SECTIONS) + 1
        for k in range(len(tool.SECTIONS)):
            assert f"STAMP({k});" in stamp
        assert stamp.count("atomicAdd(&g_sections[k]") == 1
        assert stamp.count("long long sec_acc[16]") == 1
