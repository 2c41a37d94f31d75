"""The dequantized GEMM's warp-specialised walk (``csrc/dequant_wgmma.cuh``),
row 14 of the kernel table, on the CPU.

* The route rule: every Fig. 15 case (chip_smoke's DEQUANT_SHAPES x
  DEQUANT_ROWS) takes the walk; of the ragged cases the fp32, odd-K and
  scaled int8 ones keep the CUDA cores.  The grid is a pure function of the
  static shapes and fills the card's 132 SMs at Fig. 15's shapes; the
  walk's shared memory at its constants (stated once in Python, passed to
  the source as the build's macros) stays within the 232,448 bytes a block
  may take, and its threads within 120 registers each where it runs four
  consumers.
* A rehearsal of the kernel's fragment map, bit for bit: each lane's 16-byte
  loads from the swizzled stage, its byte permutes, the magic-number decode
  (fp16_pair for fp16's integer codes, decode_pairs for the rest) and the
  scales, emulated on integers and 16-bit values,
  put every code in the A-register slot that mma.sync's layout (k16; the s8
  k32 layout for int8 activations) gives it.  The weight the slots hold
  equals ``ref.dequant_weight`` (rounded to the activations' type and
  scaled there, as the TPU kernel does; s8 codes scaled by 16 or 64 in
  their byte) for every format, with and without scales, at BM 8 and 256;
  the product is within fp32 noise of ``ref.dequant_matmul``; k slots 2t+1
  and 2t+8 exchanged fail it.
* The ring's protocol as an event model with parity waits and loads
  landing in any order: a producer and C consumers on every C-th stage,
  the ring a multiple of C stages (2 C at least), never deadlock, overwrite
  a stage before its consumer released it, pass a wait before its tile
  landed or end with a load in flight; C stages deadlock, and a ring that is
  no multiple of C lets a wait pass on a round two behind.
* The card path with the C call recorded: route codes, ``tc_launches``; a
  plan past the shared-memory budget raises before any call; a refused
  launch raises and counts nothing.
* The plain ``ref.dequant_matmul`` against the JAX package's
  ``dequant_matmul_program`` through Pallas interpret, int4 and nf4 with
  scales.

The kernel itself runs only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import random
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import dequant_matmul as D
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
SMS = 132  # an H100's SMs
PACK = ref.WEIGHT_PACK
F16, BF16, I8 = torch.float16, torch.bfloat16, torch.int8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: under the suite's six workers more threads
    only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


class _Fake:
    """A tensor stand-in for the route rule: an address only."""

    def __init__(self, ptr=0):
        self._ptr = ptr

    def data_ptr(self):
        return self._ptr


# ---------------------------------------------------------------------------
# the route, the grid and the shared-memory budget
# ---------------------------------------------------------------------------


def test_every_fig15_case_takes_the_walk(cs):
    for label, (m, n, k) in cs.DEQUANT_SHAPES.items():
        for fmt, adtype in cs.DEQUANT_ROWS:
            assert D.route(getattr(torch, adtype), fmt, k, False, _Fake(), _Fake()) == "wgmma", (
                label, fmt, adtype)
            assert D.grid(m, n)[1] == 1  # one activation block: each weight tile decoded once


def test_ragged_cases_routes(cs):
    """fp32, odd K (K / pack 24) and a scaled int8 case keep the CUDA cores;
    the scale groups no K tile matches take the walk."""
    want = {"fp32 m256": "cuda", "odd K": "cuda", "group 96": "wgmma", "group 32 bf16": "wgmma",
            "group 128 M 5": "wgmma", "group 48 int8": "cuda"}
    for label, (m, n, k), fmt, adtype, group in cs.ragged_cases()["dequant_matmul"]:
        got = D.route(getattr(torch, adtype), fmt, k, group is not None, _Fake(), _Fake())
        assert got == want[label], label
    assert set(want) == {c[0] for c in cs.ragged_cases()["dequant_matmul"]}


def test_chip_smoke_gate_holds_the_walk_to_every_fig15_case(cs, monkeypatch):
    """wgmma_gate passes with one walk launch a Fig. 15 case and none for the
    fp32 and odd-K cases, and raises where a case is missing, took the CUDA
    cores, or a CUDA-core case took the walk; DEQUANT_EARLIER_MS holds the
    18 cells' times before the walk, each printed beside its case."""
    fig15 = [f"{s} {f} x {a}" for s in cs.DEQUANT_SHAPES for f, a in cs.DEQUANT_ROWS]
    assert sorted(cs.DEQUANT_EARLIER_MS) == sorted(fig15) and len(fig15) == 18
    labels = {c[0] + " " + c[2] + " x " + c[3] for c in cs.ragged_cases()["dequant_matmul"]}
    assert set(cs.DEQUANT_NO_WGMMA) <= labels

    def rows(walk=1, none=0, drop=None):
        out = [{"kernel": "matmul", "label": f"M{i} bfloat16", "wgmma_launches": 1}
               for i in range(8)]
        out += [{"kernel": "mla", "label": label, "wgmma_launches": 1} for label in cs.MLA_WGMMA]
        out += [{"kernel": "dequant_matmul", "label": label, "wgmma_launches": walk}
                for label in fig15 if label != drop]
        out += [{"kernel": "dequant_matmul", "label": label, "wgmma_launches": none}
                for label in cs.DEQUANT_NO_WGMMA]
        return out
    _, _, dq = cs.wgmma_gate(rows())
    assert [dq[label] for label in fig15] == [1] * 18
    for bad in (rows(walk=0), rows(walk=2), rows(none=1), rows(drop=fig15[3])):
        with pytest.raises(AssertionError, match="dequantized GEMM"):
            cs.wgmma_gate(bad)
    r = {"kernel": "dequant_matmul", "label": fig15[13], "shape": (256, 8192, 8192), "err": 1.0,
         "limit": 2.0, "metric": "units", "max_abs_err": 0.1, "ms": 0.07, "plain_ms": 2.0,
         "yardstick_ms": 0.065, "yardstick_bound_ms": 0.04, "bound_ms": 0.035,
         "bound_by": "operations", "wgmma_launches": 1}
    lines = []
    monkeypatch.setattr(cs, "log", lines.append)
    cs.log_library(r)
    assert "before the redesign 0.2291 ms (3.27x)" in lines[0] and "[wgmma]" in lines[0]


def test_route_refusals():
    a = _Fake()
    assert D.route(F16, "int4", 256, False, a, _Fake(8)) == "cuda"  # unaligned
    assert D.route(torch.float32, "int4", 256, False, a) == "cuda"
    assert D.route(I8, "nf4", 256, False, a) == "cuda"
    assert D.route(I8, "int4", 256, True, a) == "cuda"
    assert D.route(I8, "int2", D.S8_MAX_K, False, a) == "wgmma"
    assert D.route(I8, "int2", D.S8_MAX_K + 64, False, a) == "cuda"
    assert D.route(F16, "int2", 96, False, a) == "cuda"  # K / 4 = 24
    assert D.route(F16, "int8", 48, False, a) == "wgmma"
    assert D.route(BF16, "nf4", 64, True, a) == "wgmma"
    assert D.ROUTES == {"cuda": 0, "wgmma": 1}


def test_block_rows_ladder():
    assert [D.block_rows(m) for m in (1, 5, 8, 9, 12, 16, 17, 64, 65, 70, 129, 256, 257, 1000)] == [
        8, 8, 8, 16, 16, 16, 32, 64, 128, 128, 256, 256, 256, 256]
    assert D.grid(1000, 100) == (2, 4) and D.grid(256, 8192) == (128, 1)


def test_grid_fills_the_card_at_fig15_shapes(cs):
    """From static shapes alone: 64 weight rows a block (one an SM), one
    activation block at M <= 256; at N 16384 256 blocks (two waves), at N
    8192 128 blocks (all but 4 SMs busy), each block's consumers splitting
    K: four at M 8, 16 decoding warps an SM."""
    for label, (m, n, k) in cs.DEQUANT_SHAPES.items():
        gx, gy = D.grid(m, n)
        blocks = gx * gy
        assert 0.95 * SMS <= blocks <= 2 * SMS, label
        for fmt, adtype in cs.DEQUANT_ROWS:
            plan = D.tile_plan(D.block_rows(m), 1 if adtype == "int8" else 2, PACK[fmt])
            assert plan["consumers"] == (4 if m == 8 else 2)
    assert list(D.grid.__code__.co_varnames[:2]) == ["m", "n"]  # no data


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = ([0-9]+);", text).group(1))


def test_shared_memory_budget_at_the_walks_constants():
    """The source states no tile constant of its own (it stops without the
    macros); Python's ROWS / MAX_SMEM are the source's; every instantiated
    plan (BM 8-256, 16-bit and int8 activations, 1 / 2 / 4 codes a byte)
    fits a block's 232,448 bytes with its barriers and codebook, a ring of
    a multiple of its consumers (twice them at least), whole 1 KB stages, an
    even number of register groups a stage, and the other consumers' sums in
    the ring."""
    text = (CSRC / "dequant_wgmma.cuh").read_text()
    assert "#error" in text and not re.search(r"#define DQ_(?!ABLATE)", text)
    assert _constant(text, "MAX_SMEM") == D.MAX_SMEM == 232448
    assert _constant(text, "ROWS") == D.ROWS
    assert D.KERNEL.defines == D.DEFINES and {f"-D{k}={v}" for k, v in D.DEFINES.items()} <= set(
        D.KERNEL.flags())
    static = 2 * 8 * D.MAX_STAGES + 2 * 16  # the barriers and the codebook
    bm = D.MIN_BM
    while bm <= D.MAX_BM:
        for asz in (1, 2):
            for pack in (1, 2, 4):
                p = D.tile_plan(bm, asz, pack)
                assert p["smem"] + static <= D.MAX_SMEM, (bm, asz, pack)
                assert p["stages"] >= 2 * p["consumers"] and p["stages"] % p["consumers"] == 0
                assert p["stage"] % 1024 == 0
                assert p["chunks"] % 2 == 0 and p["wb"] in (16, 32, 64, 128)
                assert p["bk"] % (16 if asz == 2 else 32) == 0
                # the epilogue's sums
                assert (p["consumers"] - 1) * D.ROWS * bm * 4 <= p["stages"] * p["stage"]
                assert p["threads"] * 96 <= 65536
        bm *= 2


# ---------------------------------------------------------------------------
# the fragment map, rehearsed bit for bit
# ---------------------------------------------------------------------------


def _prmt(x, y, sel):
    """__byte_perm(x, y, sel)."""
    b = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(b[(sel >> (4 * i)) & 7] << (8 * i) for i in range(4))


def _half(bits, dtype):
    """The value of 16-bit pattern ``bits`` in ``dtype``."""
    if dtype == F16:
        return float(np.array([bits], np.uint16).view(np.float16)[0])
    return float(np.array([bits << 16], np.uint32).view(np.float32)[0])


def _round(v, dtype):
    return torch.tensor(v, dtype=torch.float64).to(dtype).item()


MAGIC = {F16: (0x6400, 1024.0), BF16: (0x4300, 128.0)}


def _decode_pairs(w4, fmt, dtype, cb):
    """decode_pairs<FMT, CT>: 2 PACK pairs (codes 2j, 2j + 1) of a word."""
    pack = PACK[fmt]
    if fmt == "nf4":
        return [(cb[(w4 >> (8 * j)) & 15], cb[(w4 >> (8 * j + 4)) & 15]) for j in range(2 * pack)]
    s8 = lambda v: v - 256 if v >= 128 else v  # noqa: E731
    if fmt == "int8" and dtype == BF16:
        return [(float(s8((w4 >> (16 * j)) & 0xFF)), float(s8((w4 >> (16 * j + 8)) & 0xFF)))
                for j in range(2)]
    bits = 8 // pack
    half = 1 << (bits - 1)
    field = (1 << bits) - 1
    mask = field | (field << 16)
    flip = {128: 0x80808080, 8: 0x88888888, 2: 0xAAAAAAAA}[half]
    s = 16 // bits
    magic, base = MAGIC[dtype]
    x = w4 ^ flip
    p = []
    for sh in range(s):
        u = ((x >> (bits * sh)) & mask) | (magic * 0x10001)
        p.append((_half(u & 0xFFFF, dtype) - (base + half), _half(u >> 16, dtype) - (base + half)))
    out = []
    for j in range(2 * pack):
        c = 2 * j
        out.append((p[c][0], p[c + 1][0]) if c < s else (p[c - s][1], p[c - s + 1][1]))
    return out


def _swz(wb, g):
    return {128: g & 7, 64: (g >> 1) & 3, 32: (g >> 2) & 1, 16: 0}[wb]


def _swizzled(tile, wb):
    """The weight tile (64, wb) bytes as TMA lays it out: row r's 16-byte
    chunk c at chunk c ^ swz(r)."""
    out = np.zeros_like(tile)
    for r in range(tile.shape[0]):
        for c in range(wb // 16):
            p = c ^ _swz(wb, r % 8)
            out[r, 16 * p:16 * p + 16] = tile[r, 16 * c:16 * c + 16]
    return out


def _words(row, chunk, swz, nbytes=16, off=0):
    """The words of a row's logical 16-byte chunk (``nbytes`` from ``off``)."""
    b = row[16 * (chunk ^ swz) + off:16 * (chunk ^ swz) + off + nbytes]
    return [int.from_bytes(bytes(b[4 * i:4 * i + 4]), "little") for i in range(nbytes // 4)]


def _fp16_pair(y, bits, s):
    """fp16_pair<BITS, S>: lop3 (flip, mask, 1024.0 around the fields) and
    hfma2 (1, 2^-S) . u + the biases."""
    field, half = (1 << bits) - 1, 1 << (bits - 1)
    mask = field | (field << (16 + s))
    out = (half | (half << (16 + s))) | (0x64006400 & ~mask)
    u = (((y ^ out) & mask) | (out & ~mask)) & 0xFFFFFFFF
    return (_half(u & 0xFFFF, F16) - (1024 + half),
            _half(u >> 16, F16) / (1 << s) - (1024 / (1 << s) + half))


def _decode_row16(row, byte0, swz, t, fmt, dtype, cb, chunk):
    """decode_row16: [(lo pair, hi pair)] of each step of the group."""
    out = []
    if dtype == F16 and fmt == "int8":
        sel = (2 * t) | ((2 * t + 1) << 8)
        for j in range(chunk):
            v = _words(row, (byte0 >> 4) + j, swz)
            out.append((_fp16_pair(_prmt(v[0], v[1], sel), 8, 0),
                        _fp16_pair(_prmt(v[2], v[3], sel), 8, 0)))
    elif dtype == F16 and fmt == "int4":
        sel = t | ((t + 4) << 4) | (t << 8) | ((t + 4) << 12)
        for j in range(0, chunk, 2):
            v = _words(row, (byte0 >> 4) + j // 2, swz)
            for p in (_prmt(v[0], v[1], sel), _prmt(v[2], v[3], sel)):
                out.append((_fp16_pair(p, 4, 4), _fp16_pair(p >> 8, 4, 4)))
    elif dtype == F16 and fmt == "int2":
        w = (_words(row, byte0 >> 4, swz) if chunk == 4
             else _words(row, byte0 >> 4, swz, 8, byte0 & 15))
        for j in range(chunk):
            x = w[j] >> (4 * t)
            out.append((_fp16_pair(_prmt(x, 0, 0x4040), 2, 2),
                        _fp16_pair(_prmt(x, 0, 0x4242), 2, 2)))
    elif fmt == "int8":
        sel = (2 * t) | ((2 * t + 1) << 4)
        for j in range(chunk):
            v = _words(row, (byte0 >> 4) + j, swz)
            g4 = _prmt(_prmt(v[0], v[1], sel), _prmt(v[2], v[3], sel), 0x5410)
            p = _decode_pairs(g4, fmt, dtype, cb)
            out.append((p[0], p[1]))
    elif fmt in ("int4", "nf4"):
        sel = t | ((t + 4) << 4)
        for j in range(0, chunk, 2):
            v = _words(row, (byte0 >> 4) + j // 2, swz)
            g4 = _prmt(_prmt(v[0], v[1], sel), _prmt(v[2], v[3], sel), 0x5410)
            p = _decode_pairs(g4, fmt, dtype, cb)
            out += [(p[0], p[1]), (p[2], p[3])]
    else:
        w = (_words(row, byte0 >> 4, swz) if chunk == 4
             else _words(row, byte0 >> 4, swz, 8, byte0 & 15))
        nib = 0
        for j in range(chunk):
            nib |= ((w[j] >> (4 * t)) & 0x000F000F) << (4 * j)
        p = _decode_pairs(nib, fmt, dtype, cb)
        out = [(p[j], p[4 + j]) for j in range(chunk)]
    return out


def _decode_row8(row, byte0, swz, t, fmt, chunk):
    """decode_row8: [(a0 word, a2 word)] of each step of the group."""
    out = []
    if fmt == "int8":
        for j in range(chunk):
            c = (byte0 >> 4) + 2 * j
            out.append((_words(row, c, swz)[t], _words(row, c + 1, swz)[t]))
    elif fmt == "int4":
        sel = (2 * t) | ((2 * t) << 4) | ((2 * t + 1) << 8) | ((2 * t + 1) << 12)
        f = lambda y: ((y << 4) & 0x00F000F0) | (y & 0xF000F000)  # noqa: E731
        for j in range(chunk):
            v = _words(row, (byte0 >> 4) + j, swz)
            out.append((f(_prmt(v[0], v[1], sel)), f(_prmt(v[2], v[3], sel))))
    else:
        sel = t | 0x4440
        for j in range(0, chunk, 2):
            v = _words(row, (byte0 >> 4) + j // 2, swz)
            r = []
            for q in range(4):
                u = (_prmt(v[q], 0, sel) * 4097) & 0xFFFFFFFF
                r.append(((u << 6) | (u << 12)) & 0xC0C0C0C0)
            out += [(r[0], r[1]), (r[2], r[3])]
    return out


def rehearse(bq, fmt, m, adtype, scales=None, group=None, fault=False):
    """The weight the walk's A registers hold, (N, K) float64: the kernel's
    lanes over every block and stage, each slot put back at the (row, k)
    that mma.sync's A layout gives it.  s8 codes come back as their bytes
    (16 / 64 times the code for int4 / int2).  ``fault`` exchanges k slots
    2t+1 and 2t+8 (s8: 4t+1 and 4t+16)."""
    pack = PACK[fmt]
    s8 = adtype == I8
    asz = 1 if s8 else 2
    plan = D.tile_plan(D.block_rows(m), asz, pack)
    bk, wb, chunk, chunks = plan["bk"], plan["wb"], plan["chunk"], plan["chunks"]
    kstep = 32 if s8 else 16
    n, kb = bq.shape
    k = kb * pack
    ktiles = -(-k // bk)
    rows = -(-n // D.ROWS) * D.ROWS
    padded = np.zeros((rows, ktiles * wb), np.uint8)
    padded[:n, :kb] = bq.numpy().view(np.uint8)
    cb = [_round(v, adtype) for v in ref.NF4_CODEBOOK.tolist()] if not s8 else None
    w = np.zeros((rows, ktiles * bk), np.float64)
    groups = k // group if scales is not None else 0
    # the wrapper hands the kernel scales in the activations' type
    sc = scales.to(adtype).to(torch.float64).numpy() if scales is not None else None
    for n0 in range(0, rows, D.ROWS):
        for kt in range(ktiles):
            tile = _swizzled(padded[n0:n0 + D.ROWS, kt * wb:(kt + 1) * wb], wb)
            for lane_id in range(128):
                warp, lane = lane_id // 32, lane_id % 32
                g, t = lane // 4, lane % 4
                r0 = 16 * warp + g
                swz = _swz(wb, g)
                for ch in range(chunks):
                    for h in range(2):
                        r = r0 + 8 * h
                        row = tile[r]
                        byte0 = ch * chunk * kstep // pack
                        group_regs = (_decode_row8(row, byte0, swz, t, fmt, chunk) if s8 else
                                      _decode_row16(row, byte0, swz, t, fmt, adtype, cb, chunk))
                        for j in range(chunk):
                            kk = kt * bk + (ch * chunk + j) * kstep
                            if s8:
                                for half, word in enumerate(group_regs[j]):
                                    vals = [((word >> (8 * i)) & 0xFF) for i in range(4)]
                                    vals = [v - 256 if v >= 128 else v for v in vals]
                                    ks = [kk + 4 * t + 16 * half + i for i in range(4)]
                                    if fault and half == 0:
                                        ks[1] = kk + 4 * t + 16
                                    if fault and half == 1:
                                        ks[0] = kk + 4 * t + 1
                                    for kx, v in zip(ks, vals):
                                        w[n0 + r, kx] = v
                                continue
                            for half, pair in enumerate(group_regs[j]):
                                k0 = kk + 2 * t + 8 * half
                                ks = [k0, k0 + 1]
                                if fault:
                                    ks = ([k0, kk + 2 * t + 8] if half == 0
                                          else [kk + 2 * t + 1, k0 + 1])
                                for kx, v in zip(ks, pair):
                                    if sc is not None:  # scale_row: hmul2 rounds once in CT
                                        srow = sc[min(n0 + r, n - 1)]
                                        v = _round(v * srow[min(kx // group, groups - 1)], adtype)
                                    w[n0 + r, kx] = v
    return torch.as_tensor(w[:n, :k])


def _want(bq, fmt, adtype, scales, group):
    """ref.dequant_weight as the kernel multiplies it: in the activations'
    16-bit type, scaled there (chip_smoke.rounded_weight's rule); s8 codes
    times their byte's factor."""
    w = ref.dequant_weight(bq, fmt)
    if adtype == I8:
        return (w * {"int8": 1, "int4": 16, "int2": 64}[fmt]).double()
    w = w.to(adtype)
    if scales is not None:
        n, k = w.shape
        w = (w.float().reshape(n, k // group, group)
             * scales.to(adtype).float()[..., None]).to(adtype).reshape(n, k)
    return w.double()


# (fmt, activations, M, N, K, group): BM 8 (k 128 to 512 a stage, 4 products a
# group) and BM 256 (k 64 or 128 a stage, 2 a group, the weight rows 16 to 64
# bytes); a ragged N; groups of 3 (int8), 32, 48
REHEARSALS = [
    ("int8", F16, 8, 72, 384, None), ("int4", F16, 8, 72, 512, None),
    ("int2", F16, 8, 64, 512, None), ("nf4", F16, 8, 64, 512, None),
    ("int8", BF16, 8, 64, 384, 3), ("int4", BF16, 256, 64, 256, 32),
    ("int2", BF16, 256, 72, 384, 48), ("nf4", BF16, 256, 64, 256, 32),
    ("int2", F16, 256, 64, 256, None), ("int4", F16, 8, 64, 512, 32),
    ("int8", I8, 8, 72, 512, None), ("int4", I8, 8, 64, 512, None),
    ("int2", I8, 8, 64, 1024, None), ("int8", I8, 256, 64, 256, None),
    ("int4", I8, 256, 64, 256, None), ("int2", I8, 256, 64, 512, None),
]


def _case(fmt, adtype, n, k, group, seed):
    rng = np.random.default_rng(seed)
    bq = torch.as_tensor(rng.integers(-128, 128, size=(n, k // PACK[fmt])).astype(np.int8))
    scales = None
    if group is not None:
        scales = torch.as_tensor((rng.random((n, k // group)) * 0.1 + 0.01).astype(np.float32))
    return bq, scales


@pytest.mark.parametrize("case", REHEARSALS, ids=lambda c: f"{c[0]}-{str(c[1])[6:]}-m{c[2]}-g{c[5]}")
def test_fragment_map_rehearsal_bit_for_bit(case):
    fmt, adtype, m, n, k, group = case
    bq, scales = _case(fmt, adtype, n, k, group, 7)
    got = rehearse(bq, fmt, m, adtype, scales, group)
    want = _want(bq, fmt, adtype, scales, group)
    assert torch.equal(got, want), (got - want).abs().max()


@pytest.mark.parametrize("case", [REHEARSALS[1], REHEARSALS[2], REHEARSALS[11]],
                         ids=["int4-f16", "int2-f16", "int4-s8"])
def test_rehearsed_product_within_fp32_noise_while_the_planted_fault_fails(case):
    """The rehearsed weight times seeded activations against
    ref.dequant_matmul (integer codes: exact in either type) within fp32
    noise; with slots 2t+1 and 2t+8 (s8: 4t+1 and 4t+16) exchanged the
    weight differs and the product leaves that limit by orders of
    magnitude."""
    fmt, adtype, m, n, k, group = case
    bq, _ = _case(fmt, adtype, n, k, group, 8)
    rng = np.random.default_rng(9)
    if adtype == I8:
        a = torch.as_tensor(rng.integers(-128, 128, size=(m, k)).astype(np.int8))
        div = {"int8": 1, "int4": 16, "int2": 64}[fmt]
    else:
        a = torch.as_tensor(rng.standard_normal((m, k)).astype(np.float32)).to(adtype)
        div = 1
    plain = ref.dequant_matmul(a, bq, fmt, None, 128, torch.float32).double()
    scale = plain.abs().max().clamp_min(1.0)
    for fault in (False, True):
        w = rehearse(bq, fmt, m, adtype, fault=fault) / div
        got = a.double() @ w.t()
        err = ((got - plain).abs().max() / scale).item()
        if fault:
            assert err > 1e-2 and not torch.equal(w * div, _want(bq, fmt, adtype, None, None))
        else:
            assert err <= 1e-5


# ---------------------------------------------------------------------------
# the ring's protocol, as an event model
# ---------------------------------------------------------------------------


def _ring(ktiles, stages, consumers, seed):
    """The producer, the TMA loads and the consumers of the walk's ring under
    one random schedule: loads land in any order, and each wait is an
    mbarrier parity wait (it passes while the barrier's current phase has
    the other parity, as mbarrier.try_wait.parity does).  A consumer
    releases its previous stage at its next stage's wait (after the
    warpgroup barrier), and its last never.  Returns the events; raises on a
    deadlock, a wait passed before its tile landed, a load into a stage not
    yet released, or the block ending with a load in flight."""
    rng = random.Random(seed)
    full = [0] * stages  # completed phases
    empty = [0] * stages
    held = [None] * stages  # the tile a stage holds until its consumer releases it
    flight = []  # loads issued, not landed
    landed = set()
    issued = 0
    nxt = list(range(consumers))
    prev = [None] * consumers
    log = []
    while True:
        moves = []
        if issued < ktiles:
            s, r = issued % stages, issued // stages
            if r == 0 or empty[s] % 2 != (r - 1) % 2:  # its (r - 1)-th release
                moves.append(("issue",))
        moves += [("land", t) for t in flight]
        for c in range(consumers):
            kt = nxt[c]
            if kt < ktiles and full[kt % stages] % 2 != (kt // stages) % 2:
                moves.append(("use", c))
        if not moves:
            if issued == ktiles and all(n >= ktiles for n in nxt):
                if flight:
                    raise AssertionError(f"the block ends with loads {flight} in flight")
                return log
            raise AssertionError("deadlock")
        move = rng.choice(moves)
        if move[0] == "issue":
            s = issued % stages
            if held[s] is not None:
                raise AssertionError(f"tile {issued} overwrites tile {held[s]}")
            held[s] = issued
            flight.append(issued)
            log.append(("load", issued))
            issued += 1
        elif move[0] == "land":
            flight.remove(move[1])
            landed.add(move[1])
            full[move[1] % stages] += 1
        else:
            c = move[1]
            kt = nxt[c]
            if kt not in landed:
                raise AssertionError(f"consumer {c} passed its wait for tile {kt} before it landed")
            if prev[c] is not None:
                held[prev[c]] = None
                empty[prev[c]] += 1
            prev[c] = kt % stages
            log.append(("use", kt, c))
            nxt[c] += consumers


@pytest.mark.parametrize("consumers,stages", [(2, 4), (2, 6), (2, 16), (4, 8), (4, 12), (4, 16)])
@pytest.mark.parametrize("ktiles", [1, 2, 3, 7, 64])
def test_ring_protocol_runs_every_tile_once(consumers, stages, ktiles):
    """The plan's rings (a multiple of the consumers, twice them at least)
    under 20 schedules each."""
    for seed in range(20):
        log = _ring(ktiles, stages, consumers, seed)
        assert [e[1] for e in log if e[0] == "load"] == list(range(ktiles))
        used = sorted(e[1] for e in log if e[0] == "use")
        assert used == list(range(ktiles))
        assert all(e[2] == e[1] % consumers for e in log if e[0] == "use")


@pytest.mark.parametrize("consumers,stages", [(2, 5), (4, 6)])
def test_ring_faults_fail_the_model(consumers, stages):
    """A ring of as many stages as consumers deadlocks; one that is no
    multiple of them hands a stage between consumers, and some schedule
    (loads landing out of order) lets a consumer's parity wait pass on a
    round two behind: the fault the ablation's loads alone met on the card."""
    with pytest.raises(AssertionError, match="deadlock"):
        _ring(8 * consumers, consumers, consumers, 0)
    with pytest.raises(AssertionError, match="before it landed|in flight|overwrites"):
        for seed in range(200):
            _ring(64, stages, consumers, seed)


# ---------------------------------------------------------------------------
# the card path, with the C call recorded
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnCard)


@pytest.fixture
def card_path(monkeypatch):
    calls = []

    def fn(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(D.KERNEL, "function", lambda: fn)
    monkeypatch.setattr(D.KERNEL, "launches", 0)
    monkeypatch.setattr(D.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ref, "dequant_matmul", no_plain)
    return calls


def test_card_path_counts_wgmma_launches(card_path):
    """16-bit and int8 activations take route 1 and count tc_launches; fp32,
    scaled int8 and odd K take route 0; the group and M, N, K are handed
    over where the C call reads them."""
    bq4 = _card(torch.zeros(40, 128, dtype=torch.int8))
    ops.dequant_matmul(_card(torch.zeros(8, 256, dtype=F16)), bq4, fmt="int4")
    ops.dequant_matmul(_card(torch.zeros(256, 256, dtype=BF16)), bq4, fmt="nf4",
                       scales=_card(torch.ones(40, 8)))
    ops.dequant_matmul(_card(torch.zeros(8, 256, dtype=I8)), bq4, fmt="int4",
                       out_dtype=torch.float32)
    ops.dequant_matmul(_card(torch.zeros(8, 256)), bq4, fmt="int4")
    ops.dequant_matmul(_card(torch.zeros(8, 256, dtype=I8)), _card(torch.zeros(40, 64, dtype=I8)),
                       fmt="int2", scales=_card(torch.ones(40, 4)), out_dtype=torch.float32)
    ops.dequant_matmul(_card(torch.zeros(8, 48, dtype=F16)), _card(torch.zeros(40, 24, dtype=I8)),
                       fmt="int4")
    routes = [c[-2] for c in card_path]
    assert routes == [1, 1, 1, 0, 0, 0]
    assert [c[7:11] for c in card_path[:2]] == [(8, 40, 256, 0), (256, 40, 256, 32)]
    assert (D.KERNEL.launches, D.KERNEL.tc_launches) == (6, 3)


def test_a_plan_past_the_budget_raises_before_any_call(card_path, monkeypatch):
    a, bq = _card(torch.zeros(256, 256, dtype=F16)), _card(torch.zeros(40, 128, dtype=I8))
    monkeypatch.setattr(D, "ACT_STAGE", 4 * D.MAX_SMEM)
    with pytest.raises(ValueError, match="shared memory"):
        ops.dequant_matmul(a, bq, fmt="int4")
    assert card_path == [] and D.KERNEL.launches == 0
    monkeypatch.setattr(D, "ACT_STAGE", D.DEFINES["DQ_ACT_STAGE"])
    monkeypatch.setattr(D.KERNEL, "function", lambda: (lambda *args: 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.dequant_matmul(a, bq, fmt="int4")
    assert (D.KERNEL.launches, D.KERNEL.tc_launches) == (0, 0)


# ---------------------------------------------------------------------------
# the plain version against the JAX package's program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int4", "nf4"])
def test_plain_version_matches_the_pallas_program_with_scales(fmt):
    """ref.dequant_matmul (the plain version the CPU path and the card's
    checks use) against the JAX package's dequant_matmul_program in Pallas
    interpret mode, one scale group a K block, fp32 at 1e-4."""
    from repro.kernels import ops as jops

    rng = np.random.default_rng(11)
    m, n, k, block_k = 16, 32, 128, 32
    a = rng.standard_normal((m, k), dtype=np.float32)
    bp = rng.integers(-128, 128, size=(n, k // PACK[fmt])).astype(np.int8)
    sc = (rng.standard_normal((n, k // block_k), dtype=np.float32) * 0.1).astype(np.float32)
    got = ref.dequant_matmul(torch.as_tensor(a), torch.as_tensor(bp), fmt, torch.as_tensor(sc),
                             block_k, torch.float32).numpy()
    want = np.asarray(jops.dequant_matmul(a, bp, fmt=fmt, scales=sc, backend="pallas",
                                          block_k=block_k))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
