"""The numeric plan and the layouts of the fused MBConv's bands design
(R15, ``csrc/fused_mbconv.cu``), on the CPU.

In bf16 at the instantiated widths the kernel runs a prep (we^T and wp^T
rounded to bf16 once as wgmma core matrices, the taps rounded to bf16),
stage (A) on bands of 7 output rows (fewer on rows too wide for seven: the
most whose shared-memory plan fits a CTA) with a one-row halo (the
expand recomputed on the halo, h1 rounded and zero on rows off the image,
the depthwise conv's columns zero-padded, h2 = gelu(.) in f32 summed per
channel into one row of ``partial`` a band and stored rounded to x's type),
stage (B) (the bands' sums in band order, the SE MLP) and stage (C) on
64-pixel tiles that never straddle two samples (h3 = round(h2 * g), the
project with f32 sums, + bp + x rounded once).  Here that plan is emulated
in plain PyTorch:

* against the plain version ``fused_mbconv_reference``: in f32 within 1e-5
  of max|plain| (sums in another order), in bf16 within 2e-2 (the plan
  also rounds h2 to bf16 before h2 * g), at H 42 and 9, W 35, 7 and 56
  (bands of 6 rows, seven m64 tiles), with
  the CTAs' walk of 1 and 4 samples a block giving the same output;
* against R15's TPU kernel, ``repro_fused_mbconv.py::build(False)`` run in
  Pallas TPU interpret mode with its geometry shrunk by monkeypatch to
  (BN, H, W, DIN, HID, SHR) = (3, 9, 7, 32, 128, 32) (nothing in
  ``benchmarks/`` changes), in f32 within 1e-5 of max|kernel|.

The packed layouts are checked against ``wgmma_common.cuh::core_offset``
(each k16 step's descriptor origin, each 64-channel chunk of we^T one
contiguous block), the shared-memory plans of both designs against a CTA's
232,448 bytes at both widths and dtypes, the band's rows and the route as
functions of the shapes, and the wrapper on CPU tensors, which runs the plain version and
counts no route.  ``repros/mbconv_sections.py`` finds every place it
patches.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from benchmarks.mosaic_repros import repro_fused_mbconv as R15
from tests import conftest as C  # noqa: F401
from tests.test_torch_port_fused_mbconv import _operands
from tests.test_torch_port_perhead_split import core_offset
from vit_grid_model_tpu_torch.ops import nn as vnn
from vit_grid_model_tpu_torch.ops.cuda import library
from vit_grid_model_tpu_torch.ops.cuda import mbconv as cuda_mbconv
from vit_grid_model_tpu_torch.ops.mbconv import fused_mbconv_reference

SOURCE = library.CSRC / "fused_mbconv.cu"
SMEM_LIMIT = 232448
PIX = 64                 # pixels a project tile


def bands_plan(x: torch.Tensor, ops, spb: int = 1) -> torch.Tensor:
    """The bands design in plain PyTorch on NHWC ``x``, on bands of
    ``band_rows`` rows; CTA (band b, group j) walks band b of samples j spb
    .. j spb + spb - 1, as the kernel's grid does.  Returns x's dtype."""
    we, be, wd, bd, w1, b1, w2, b2, wp, bp = ops
    dt = x.dtype

    def r(t):
        return t.to(dt).float()

    n, h, w, c = x.shape
    hid = we.shape[1]
    rows = band_rows(w, c)
    bands = -(-h // rows)
    xf, taps = x.float(), r(wd)
    h2 = torch.zeros(n, h, w, hid)
    partial = torch.zeros(n, bands, hid)
    for b in range(bands):
        for j in range(-(-n // spb)):
            for s in range(j * spb, min(n, (j + 1) * spb)):
                r0 = b * rows
                staged = torch.zeros(rows + 2, w, c)
                on = [0 <= r0 - 1 + i < h for i in range(rows + 2)]
                for i in range(rows + 2):
                    if on[i]:
                        staged[i] = xf[s, r0 - 1 + i]
                # the expand over the band and its halo, h1 rounded, zero
                # on rows off the image
                h1 = r(vnn.gelu(staged @ r(we) + be))
                h1[[i for i in range(rows + 2) if not on[i]]] = 0.0
                h1 = torch.nn.functional.pad(h1, (0, 0, 1, 1))  # columns
                out_rows = min(rows, h - r0)
                acc = torch.zeros(out_rows, w, hid)
                for dy in range(3):
                    for dx in range(3):
                        acc = acc + h1[dy:dy + out_rows, dx:dx + w] * taps[
                            dy, dx]
                v = vnn.gelu(acc + bd)
                partial[s, b] = v.sum(dim=(0, 1))
                h2[s, r0:r0 + out_rows] = r(v)        # stored in x's type
    mean = torch.zeros(n, hid)
    for b in range(bands):                            # band order
        mean = mean + partial[:, b]
    g = torch.relu(r(mean / (h * w)) @ r(w1) + b1)
    g = torch.sigmoid(r(g) @ r(w2) + b2)
    out = torch.empty(n, h * w, c, dtype=dt)
    h2, xf = h2.reshape(n, h * w, hid), xf.reshape(n, h * w, c)
    for s in range(n):
        for p0 in range(0, h * w, PIX):               # within one sample
            h3 = r(h2[s, p0:p0 + PIX] * g[s])
            y = h3 @ r(wp) + bp
            out[s, p0:p0 + PIX] = (y + xf[s, p0:p0 + PIX]).to(dt)
    return out.reshape(n, h, w, c)


def _inputs(n, h, w, c, dtype, seed=3):
    ops = tuple(map(torch.from_numpy, _operands(seed, c, 4 * c, c)))
    x = torch.from_numpy(np.random.default_rng(seed + 1).standard_normal(
        (n, h, w, c)).astype(np.float32)).to(dtype)
    return x, ops


def _rel(ours, ref) -> float:
    ours, ref = ours.float(), ref.float()
    return ((ours - ref).abs().max() / ref.abs().max()).item()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("n,h,w,c", [(2, 42, 35, 128), (5, 9, 7, 32),
                                     (2, 3, 5, 32), (2, 9, 56, 128)])
def test_bands_plan_matches_plain(n, h, w, c, dtype, tol):
    x, ops = _inputs(n, h, w, c, dtype)
    ref = fused_mbconv_reference(x, ops)
    ours = bands_plan(x, ops, spb=1)
    assert ours.dtype == dtype and ours.shape == ref.shape
    assert torch.isfinite(ours.float()).all()
    assert _rel(ours, ref) <= tol
    # the walk of four samples a block leaves every value as it was
    assert torch.equal(bands_plan(x, ops, spb=4), ours)


def test_bands_plan_matches_the_tpu_kernel_interpret(monkeypatch):
    """R15's Pallas kernel (one sample a program) in interpret mode at
    (3, 9, 7, 32, 128, 32), f32: one band of 7 rows and one of 2, one m64
    tile a band, a ragged last project tile in every sample."""
    for name, value in (("BN", 3), ("H", 9), ("W", 7), ("DIN", 32),
                        ("HID", 128), ("SHR", 32)):
        monkeypatch.setattr(R15, name, value)
    x, ops = _inputs(3, 9, 7, 32, torch.float32, seed=11)
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(R15.build(False)(
            jnp.asarray(x.numpy()), *(jnp.asarray(t.numpy()) for t in ops)),
            np.float32)
    assert ref.shape == (3, 9, 7, 32) and np.isfinite(ref).all()
    ours = bands_plan(x, ops)
    assert _rel(ours, torch.from_numpy(ref.copy())) <= 1e-5


# --- the packed operands and the descriptors that read them ---------------

def _descriptor_reads(origin: int, n_rows: int, k_cols: int):
    """{(row, k) of a k16 step: byte} that a K-major descriptor at byte
    ``origin`` (leading offset 128, stride offset 16 k_cols, no swizzle)
    reads for ``n_rows`` rows: core matrix (row / 8, k / 8) of the step at
    origin + (row / 8) 16 k_cols + (k / 8) 128."""
    return {(row, k): origin + (row // 8) * 16 * k_cols + (k // 8) * 128
            + (row % 8) * 16 + (k % 8) * 2
            for row in range(n_rows) for k in range(16)}


@pytest.mark.parametrize("c,hid", [(128, 512), (32, 128)])
def test_packed_operands_are_the_descriptors_layouts(c, hid):
    """``packed_reference`` (the prep's plain version) lays we^T and wp^T
    out as ``core_offset`` does; each 64-channel chunk of we^T is one
    contiguous block of 64 C elements (one bulk copy), and the descriptor
    of each k16 step (the chunk's origin + 256 kk bytes) reads exactly the
    step's elements; wp^T's steps likewise over K = HID; the taps follow,
    rounded to bf16."""
    ops = tuple(map(torch.from_numpy, _operands(5, c, hid, c // 4 * 4)))
    we, wd, wp = ops[0], ops[2], ops[8]
    packed = cuda_mbconv.packed_reference(ops)
    assert packed.dtype == torch.bfloat16
    assert packed.numel() == 2 * c * hid + 9 * hid
    flat = packed.float()
    we_t, wp_t = flat[:c * hid], flat[c * hid:2 * c * hid]
    # core_offset over every element, both operands
    for j in range(0, hid, 7):
        for k in range(c):
            assert we_t[core_offset(j, k, c) // 2] == we[k, j].bfloat16()
    for o in range(c):
        for k in range(0, hid, 5):
            assert wp_t[core_offset(o, k, hid) // 2] == wp[k, o].bfloat16()
    # chunk q of we^T: rows 64 q .. 64 q + 63, elements [64 q c, 64 (q+1) c)
    for q in range(hid // 64):
        offs = {core_offset(64 * q + r, k, c) // 2 for r in range(64)
                for k in range(c)}
        assert offs == set(range(64 * q * c, 64 * (q + 1) * c))
        chunk = we_t[64 * q * c:64 * (q + 1) * c]
        for kk in range(c // 16):
            for (row, k), byte in _descriptor_reads(256 * kk, 64, c).items():
                assert chunk[byte // 2] == we[16 * kk + k, 64 * q + row] \
                    .bfloat16()
    for step in (0, 1, hid // 16 - 1):
        for (row, k), byte in _descriptor_reads(256 * step, c, hid).items():
            assert wp_t[byte // 2] == wp[16 * step + k, row].bfloat16()
    assert torch.equal(packed[2 * c * hid:], wd.reshape(-1).bfloat16())


@pytest.mark.parametrize("w,c", [(35, 128), (7, 32)])
def test_staged_operands_are_the_descriptors_layouts(w, c):
    """Stage (A)'s x band (pixel q, channel k at ``core_offset(q, k, C)``,
    its eight-thread copies filling whole core matrices) read by m64 tile
    mt's k16 step kk at byte 64 mt C 2 + 256 kk, and stage (C)'s h2 (then
    h3) k-chunk (64 pixels x 64 channels, ``core_offset(px, k, 64)``, a
    quarter-warp's eight 16-byte copies filling one core matrix) read at
    256 kk."""
    m = 9 * w
    m_tiles = -(-m // 64)
    for mt in range(m_tiles):
        for kk in range(c // 16):
            for (row, k), byte in _descriptor_reads(
                    64 * mt * c * 2 + 256 * kk, 64, c).items():
                assert byte == core_offset(64 * mt + row, 16 * kk + k, c)
    segs = c // 8
    m8 = -(-m // 8) * 8
    starts = []
    for e in range(m8 * segs):
        q, s = e // (8 * segs) * 8 + (e & 7), (e >> 3) % segs
        starts.append(core_offset(q, 8 * s, c))
    assert sorted(starts) == list(range(0, m8 * c * 2, 16))
    for i in range(0, len(starts), 8):        # eight threads, 128 bytes
        assert starts[i:i + 8] == list(range(starts[i], starts[i] + 128, 16))
    for kk in range(4):
        for (row, k), byte in _descriptor_reads(256 * kk, 64, 64).items():
            assert byte == core_offset(row, 16 * kk + k, 64)
    items = {}
    for e in range(512):
        px = (e & 7) + 8 * ((e >> 5) & 7)
        s = ((e >> 3) & 3) + 4 * (e >> 8)
        items[e] = core_offset(px, 8 * s, 64)
        if e % 8 == 7:
            quarter = [items[e - 7 + i] for i in range(8)]
            assert quarter == list(range(quarter[0], quarter[0] + 128, 16))
    assert sorted(items.values()) == list(range(0, 64 * 64 * 2, 16))


# --- the shared-memory plans and the route --------------------------------

def _constant(name: str) -> int:
    m = re.search(rf"constexpr (?:int|size_t) {name} = ([^;]+);",
                  SOURCE.read_text())
    assert m, name
    return int(eval(m.group(1), {}, {"kChunk": 64}))  # noqa: S307


def _a128(b: int) -> int:
    return (b + 127) // 128 * 128


def band_plan_bytes(rows: int, w: int, c: int) -> int:
    """``band_plan``'s bytes for bands of ``rows`` rows: x's band in m64
    tiles, the we^T buffers, h1 of a chunk for the (rows + 2) w staged
    pixels at ``kH1Ld`` bf16, each warp's channel sums, the mbarriers."""
    chunk = _constant("kChunk")
    m = (rows + 2) * w
    off = _a128(-(-m // 64) * 64 * c * 2)
    off = _a128(off + _constant("kWeightBuffers") * chunk * c * 2)
    off = _a128(off + m * _constant("kH1Ld") * 2)
    off = _a128(off + _constant("kBandWarpgroups") * 4 * chunk * 4)
    return _a128(off + _constant("kWeightBuffers") * 8)


def project_plan_bytes(c: int, hid: int) -> int:
    """``project_plan``'s bytes: wp^T, each warpgroup's ring of 64 x 64
    h2 k-chunks and its gate, the mbarrier."""
    wgs = _constant("kProjectWarpgroups")
    off = _a128(c * hid * 2)
    off += wgs * _a128(_constant("kRingStages") * 64 * 64 * 2)
    off = _a128(off + wgs * hid * 4)
    return _a128(off + 8)


def band_rows(w: int, c: int) -> int:
    """``band_rows``: ``kBandRows``, or the most rows whose plans fit a
    CTA; 0 when none does."""
    if project_plan_bytes(c, 4 * c) > SMEM_LIMIT:
        return 0
    return next((r for r in range(_constant("kBandRows"), 0, -1)
                 if band_plan_bytes(r, w, c) <= SMEM_LIMIT), 0)


def first_plan_bytes(th: int, w: int, c: int, hid: int):
    """The first design's (f32) ``plan_a`` (a row tile of th rows and its
    halo) and ``plan_c`` bytes."""
    m_pad = -(-(th + 2) * w // 16) * 16
    off = _a128(4 * m_pad * (c + 1))
    off = _a128(off + 4 * c * 64)
    off = _a128(off + 4 * m_pad * 68)
    off = _a128(off + 4 * 9 * 64)
    off = _a128(off + 4 * 2 * 64)
    a = _a128(off + 4 * 256)
    off = _a128(4 * 64 * 65)
    off = _a128(off + 4 * 64 * c)
    off = _a128(off + 4 * 64 * (c + 4))
    return a, _a128(off + 4 * hid)


def first_rows(w: int, c: int) -> int:
    """``row_tile``: the most rows that fit two blocks an SM, else one."""
    for budget in (_constant("kSmemTwoBlocks"), SMEM_LIMIT):
        for th in range(_constant("kMaxRowTile"), 0, -1):
            if first_plan_bytes(th, w, c, 4 * c)[0] <= budget:
                return th
    return 0


def route_of(w: int, c: int, bf16: bool):
    if bf16:
        return "bands" if band_rows(w, c) else None
    return "first" if first_rows(w, c) else None


@pytest.mark.parametrize("c,hid", [(128, 512), (32, 128)])
@pytest.mark.parametrize("bf16", [True, False])
def test_plans_fit_a_cta(c, hid, bf16):
    """At both widths and both dtypes the plans of the design a launch
    takes fit a CTA's 232,448 bytes at rows of 35, 7 and 56 pixels: in
    bf16 the bands design's stage (A) (165,376 B at C 128, W 35, 7 rows;
    6 rows at W 56) and stage (C) (217,216 B); in f32 the first design at
    its row tile."""
    assert _constant("kSmemMax") == SMEM_LIMIT
    assert _constant("kBandRows") == 7
    assert _constant("kH1Ld") == 72        # 144 bytes: no bank conflict
    for w in (35, 7, 56):
        if bf16:
            rows = band_rows(w, c)
            assert route_of(w, c, True) == "bands"
            assert rows == (6 if (w, c) == (56, 128) else 7)
            assert band_plan_bytes(rows, w, c) <= SMEM_LIMIT
            assert project_plan_bytes(c, hid) <= SMEM_LIMIT
        else:
            th = first_rows(w, c)
            a, cc = first_plan_bytes(th, w, c, hid)
            assert th >= 1 and a <= SMEM_LIMIT and cc <= SMEM_LIMIT
            assert route_of(w, c, False) == "first"
    if (c, bf16) == (128, True):
        assert band_plan_bytes(7, 35, 128) == 165376
        assert band_plan_bytes(7, 56, 128) > SMEM_LIMIT
        assert project_plan_bytes(128, 512) == 217216


def test_route_follows_the_plans(monkeypatch):
    """bf16 takes the bands design at every row width where one band row
    fits (7 rows up to 49 pixels at C 128, fewer beyond, none past 149),
    f32 the first design; the wrapper's ``route`` and ``rows`` give the
    kernel exports' answers and ``route`` raises where no design takes
    the shapes."""
    assert [band_rows(w, 128) for w in (49, 50, 56, 100, 149, 150)] == [
        7, 6, 6, 2, 1, 0]
    assert band_rows(345, 32) == 1 and band_rows(346, 32) == 0
    for w in range(1, 150):
        assert route_of(w, 128, True) == "bands"
    assert route_of(150, 128, True) is None
    assert route_of(35, 128, False) == "first"
    assert route_of(150, 128, False) is None
    assert "149" in cuda_mbconv.route.__doc__

    class Lib:
        def vgm_fused_mbconv_route(self, n, h, w, c, hid, se, is_bf16):
            if (c, hid, se) not in cuda_mbconv.WIDTHS:
                return -1
            r = route_of(w, c, is_bf16)
            return -1 if r is None else cuda_mbconv.ROUTES.index(r)

        def vgm_fused_mbconv_row_tile(self, w, c, is_bf16):
            return band_rows(w, c) if is_bf16 else first_rows(w, c)

    monkeypatch.setattr(library, "load", lambda: Lib())
    bf16, f32 = torch.bfloat16, torch.float32
    assert cuda_mbconv.route(384, 42, 35, 128, 512, 128, bf16) == "bands"
    assert cuda_mbconv.route(5, 9, 7, 32, 128, 32, bf16) == "bands"
    assert cuda_mbconv.route(8, 42, 35, 128, 512, 128, f32) == "first"
    assert cuda_mbconv.route(1, 4, 56, 128, 512, 128, bf16) == "bands"
    assert cuda_mbconv.rows(35, 128, bf16) == 7
    assert cuda_mbconv.rows(56, 128, bf16) == 6
    assert cuda_mbconv.rows(35, 128, f32) == first_rows(35, 128)
    for args in ((1, 4, 4, 16, 64, 16, bf16), (1, 4, 150, 128, 512, 128,
                                                bf16)):
        with pytest.raises(ValueError):
            cuda_mbconv.route(*args)


def test_wrapper_on_cpu_counts_no_route():
    """A CPU tensor takes the plain version: no launch, no route counted,
    no library loaded."""
    x, ops = _inputs(2, 9, 7, 32, torch.bfloat16)
    before = (cuda_mbconv.launches, dict(cuda_mbconv.launches_by_route))
    for spb in (1, 4):
        torch.testing.assert_close(
            cuda_mbconv.fused_mbconv(x, ops, samples_per_block=spb),
            fused_mbconv_reference(x, ops), rtol=0, atol=0)
    assert (cuda_mbconv.launches,
            dict(cuda_mbconv.launches_by_route)) == before
    assert library._lib is None


def test_mbconv_sections_patches_every_place():
    """``repros/mbconv_sections.py`` finds its places in the committed
    source (its headers inlined): each patched build changes one place, the
    stamped build stamps each of stage (A)'s sections once and opens and
    flushes its counts in the bands kernel alone."""
    from vit_grid_model_tpu_torch.repros import mbconv_sections as tool

    v = tool.variants(library.CSRC)
    assert set(v) == {"a", "stamp"} | set(tool.PATCHES)
    for text in v.values():
        assert '#include "' not in text
        assert "vgm_fused_mbconv_route" in text
        assert "sections_read" in text
    for name, (old, new) in tool.PATCHES.items():
        assert old in v["a"] and old not in v[name]
        assert v[name] == v["a"].replace(old, new)
    stamp = v["stamp"]
    assert stamp.count("STAMP(") == len(tool.SECTIONS) + 1  # + the macro
    for k in range(len(tool.SECTIONS)):
        assert f"STAMP({k});" in stamp
    assert stamp.count("long long sec_acc[16]") == 1
    assert stamp.count("atomicAdd(&g_sections[k]") == 1
    kernel = stamp.index(f"    {tool.BANDS_KERNEL}(")
    assert kernel < stamp.index("long long sec_acc[16]") < stamp.index(
        "    mbconv_project_wgmma(")
