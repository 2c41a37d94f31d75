"""The tensor-core paths of the quantized GQA chunked prefill and of the
Mamba-2 SSD's chunk_scan, on the CPU.

* Each wrapper picks its tensor-core kernel from dtype, shapes and strides
  alone: qwen2-1.5B's int8 / int4 serving shapes and mamba2-2.7B's training
  shapes (on the views its layer hands over) take it; fp32, hymba-1.5B's
  P 50 / N 16 and pages that do not nest in a 64-key tile do not.
* The kernels' walks, rehearsed in plain PyTorch against the plain
  versions within chip_smoke's bf16 limit (2 bf16 ulps of the plain
  value).  The prefill: a block of page_size x group query rows, the
  dequantized bf16 tiles of 64 keys (prior pages, then the chunk's own
  keys) with their positions and one positional mask, KG key groups merged
  at the end, P as the pair hi + lo.  The scan: C B^T once per (batch,
  chunk, group of heads), the decay selected before the exp, the decayed
  scores and the carried state each as three bf16 terms hi + mid + lo.
  Faulty walks fail the limit: P / the scores rounded once to bf16, the
  scores or the carried state as a pair, chunk keys cut at the block's
  first position, the decay taken without its select.
* The dequantization rule of the shared loader (csrc/kv_dequant.cuh) is the
  plain version's dequantize-then-round bit for bit at qwen's widths.
* On the card path (a CUDA tensor, here a recorder in the kernel's place)
  a bf16 call takes the tensor-core path; the quantized prefill hands q and
  the output over by their strides, with no repack.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro_torch.configs import get_config
from repro_torch.kernels import chunk_scan as CSC
from repro_torch.kernels import prefill_attention_quant as PFQ
from repro_torch.kernels import ref
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]
KEYS = 64  # keys a tile of the prefill walk
NEG_CLAMP = -2.0 ** 20


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _over(cs, got, want):
    """Whether ``got`` fails the bf16 limit (NaN fails it too)."""
    return not cs.bf16_ulps(torch, got, want) <= cs.BF16_ULPS


# ---------------------------------------------------------------------------
# (a) the path rules at full width
# ---------------------------------------------------------------------------


def test_quant_prefill_path_rule_at_qwen_serving_shapes():
    """qwen2-1.5B (both packages' configs: 12 query heads over 2, head dim
    128) served with pages of 16 and 64 table entries takes the tensor
    cores in bf16, int8 and int4 alike; pages of 8 and (with a group of 4)
    32 too, and pages of 32 x a group of 6 (192 rows, split over two
    blocks).  fp32, fp16, head dim 96, pages of 12 or 128 and a table row
    past the staging area's room do not."""
    cfg, jcfg = get_config("qwen2_1_5b"), jconfigs.get_config("qwen2_1_5b")
    hq, hkv, d = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    assert (hq, hkv, d) == (jcfg.num_heads, jcfg.num_kv_heads, jcfg.head_dim) == (12, 2, 128)
    g, bf = hq // hkv, torch.bfloat16
    assert PFQ.tensor_core_path(bf, d, 16, g, 1024 // 16)
    assert PFQ.tensor_core_path(bf, d, 8, g, 128)
    assert PFQ.tensor_core_path(bf, 64, 16, g, 64)
    assert PFQ.tensor_core_path(bf, d, 32, 4, 32)
    assert not PFQ.tensor_core_path(torch.float32, d, 16, g, 64)
    assert not PFQ.tensor_core_path(torch.float16, d, 16, g, 64)
    assert not PFQ.tensor_core_path(bf, 96, 16, g, 64)
    assert not PFQ.tensor_core_path(bf, d, 12, g, 64)
    assert not PFQ.tensor_core_path(bf, d, 128, 1, 64)
    assert PFQ.tensor_core_path(bf, d, 32, g, 32)
    assert not PFQ.tensor_core_path(bf, d, 16, g, PFQ.TC_MAX_PAGES + 1)


def _mamba_views(arch, seq=256, batch=1, dtype=torch.bfloat16):
    """The SSD operands a full-width layer of ``arch`` hands chunk_scan:
    the conv-split C / B head-broadcast views, X times dt, dA_cum and the
    carried states, as (B, H, nc, L, .) views."""
    cfg = get_config(arch)
    sm = cfg.ssm
    di, nh, n, p = sm.d_inner(cfg.d_model), sm.num_heads(cfg.d_model), sm.state_dim, sm.head_dim
    conv_out = torch.zeros(batch, seq, di + 2 * n, dtype=dtype)
    xin, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    xh = xin.reshape(batch, seq, nh, p).transpose(1, 2)
    bh, ch = (t[:, None].expand(batch, nh, seq, n) for t in (bm, cm))
    dth = torch.ones(batch, nh, seq)
    xdt = xh * dth[..., None].to(xh.dtype)
    cc, bb, xx, da = L.ssd_operands(ch, bh, xdt, dth, torch.zeros(nh), min(sm.chunk, seq))
    prev = torch.zeros(*xx.shape[:-2], n, p)
    return cfg, (cc, bb, xx, da, prev)


def test_chunk_scan_path_rule_at_mamba2_training_shapes():
    """mamba2-2.7B's layer (80 heads of P 64, N 128, chunks of 128) hands
    chunk_scan bf16 views that take the tensor cores: its C and B are the
    conv output's columns 5248 and 5120 of rows 5376 wide, broadcast over
    the heads (head stride 0); 40 heads a block at its training grid on 132
    SMs.  fp32, hymba-1.5B's P 50 / N 16, a chunk of 17 rows or of 256, N
    256 and a row that is not 16-byte aligned do not take them."""
    cfg, (cc, bb, xx, da, prev) = _mamba_views("mamba2_2_7b")
    n, p, length = cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.ssm.chunk
    assert (n, p, length) == (128, 64, 128)
    assert cc.stride(1) == bb.stride(1) == 0 and cc.stride(-2) == 5376
    assert CSC.rows_aligned(cc, bb, xx, prev)
    assert CSC.tensor_core_path(torch.bfloat16, length, n, p, CSC.rows_aligned(cc, bb, xx, prev))
    assert CSC.tensor_core_path(torch.bfloat16, 64, n, p)  # seq 192: chunks of 64
    assert CSC.head_group(8, 80, 8, p, 132, broadcast=True) == 40
    assert CSC.head_group(8, 80, 8, p, 132, broadcast=False) == 1
    assert CSC.head_group(2, 80, 3, p, 132, broadcast=True) == 4
    assert not CSC.tensor_core_path(torch.float32, length, n, p)
    hy, (hc, hb, hx, _, hs) = _mamba_views("hymba_1_5b")
    assert (hy.ssm.state_dim, hy.ssm.head_dim) == (16, 50)
    assert not CSC.tensor_core_path(torch.bfloat16, length, 16, 50, CSC.rows_aligned(hc, hb, hx, hs))
    assert not CSC.tensor_core_path(torch.bfloat16, 17, n, p)
    assert not CSC.tensor_core_path(torch.bfloat16, 256, n, p)
    assert not CSC.tensor_core_path(torch.bfloat16, length, 256, p)
    assert not CSC.rows_aligned(torch.zeros(2, 1, 1, 8, 20, dtype=torch.bfloat16)[..., 2:18])


# ---------------------------------------------------------------------------
# (b) the quantized prefill's walk, rehearsed
# ---------------------------------------------------------------------------

SLOTS, CHUNK, HKV, D = 4, 64, 2, 128
SCALE = D ** -0.5


def _prefill_inputs(seed, hq, ps, fmt):
    """numpy-seeded bf16 queries, chunk and pools, quantized; a table and
    page-aligned starts with an idle slot (1), a one-token chunk (0) and a
    partial one (2)."""
    rng = np.random.default_rng(seed)
    mp = (256 + CHUNK) // ps
    num_pages = SLOTS * mp + 1
    tables = torch.as_tensor((rng.permutation(num_pages - 1)[: SLOTS * mp] + 1)
                             .reshape(SLOTS, mp).astype("int32"))
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype("float32")).bfloat16()  # noqa: E731
    starts = torch.as_tensor(np.array([0, 32, 96, 256], "int32") // ps * ps)
    lens = torch.tensor([1, 0, 37, CHUNK], dtype=torch.int32)
    (kq, ks), (vq, vs) = (ref.quantize_rows(f(SLOTS, HKV, CHUNK, D), fmt) for _ in range(2))
    (pk, pks), (pv, pvs) = (ref.quantize_rows(f(HKV, num_pages, ps, D), fmt) for _ in range(2))
    return dict(q=f(SLOTS, hq, CHUNK, D), new=(kq, vq, ks, vs), pools=(pk, pv, pks, pvs),
                tables=tables, starts=starts, lens=lens)


def prefill_walk(start, ln, ps, bq, max_pages, window, fault=None):
    """The tensor-core kernel's walk for chunk page bq of a slot
    (prefill_attention_kernel_tc): the prior tiles over pages [p_lo,
    p_hi), then the chunk's keys [c_lo, c_hi) in tiles of 64."""
    i_lo = bq * ps
    q_lo = start + i_lo
    p_hi = min(-(-start // ps), max_pages)
    p_lo = max(0, q_lo - window + 1) // ps if window else 0
    n_prior = -(-(max(0, p_hi - p_lo) * ps) // KEYS)
    c_lo = (max(0, i_lo - window + 1) if window else 0) // KEYS * KEYS
    c_hi = min(i_lo + (1 if fault == "chunk cut at the first position" else ps), ln)
    n_chunk = -(-(c_hi - c_lo) // KEYS) if c_hi > c_lo else 0
    return dict(i_lo=i_lo, q_lo=q_lo, p_lo=p_lo, p_hi=p_hi, n_prior=n_prior, c_lo=c_lo,
                c_hi=c_hi, n=n_prior + n_chunk)


def walk_tile(w, t, start, table, ps, num_pages):
    """PrefillWalk.key for each of tile t's 64 rows: (prior, row, pos), pos
    -1 for a dead row (zero-filled, scale 0, in the kernel)."""
    r = torch.arange(KEYS)
    if t < w["n_prior"]:
        j = t * KEYS + r
        slot, off = w["p_lo"] + j // ps, j % ps
        page = table.long()[slot.clamp(max=len(table) - 1)]
        live = (slot < w["p_hi"]) & (page >= 0) & (page < num_pages)
        pos = slot * ps + off
        live &= pos < start
        return True, page * ps + off, torch.where(live, pos, -1)
    kj = w["c_lo"] + (t - w["n_prior"]) * KEYS + r
    return False, kj, torch.where(kj < w["c_hi"], start + kj, -1)


def pair_tile(state, qs, k, v, live, qscale, fault):
    """One tile of attention_mma.cuh's WarpAttention.tile on fp32 state
    (m, l, o): scores in the log2 domain, the running max clamped at
    NEG_CLAMP, exp2, P.V as the pair hi + lo (``fault`` "P rounded once":
    hi alone)."""
    m, l, o = state
    s = (qs.float() @ k.float().T) * qscale
    s = s.masked_fill(~live, float("-inf"))
    m_cur = torch.maximum(m, s.amax(-1, keepdim=True))
    mc = m_cur.clamp_min(NEG_CLAMP)
    alpha, p = torch.exp2(m.clamp_min(NEG_CLAMP) - mc), torch.exp2(s - mc)
    hi = p.bfloat16().float()
    lo = torch.zeros_like(p) if fault == "P rounded once" else (p - hi).bfloat16().float()
    return m_cur, l * alpha + p.sum(-1, keepdim=True), o * alpha + hi @ v.float() + lo @ v.float()


def prefill_rehearsal(x, fmt, ps, window, fault=None):
    """The quantized tensor-core kernel's output in plain PyTorch: grid
    (kv head, chunk page, slot), block row r = query head h G + r % G at
    chunk position bq ps + r / G; the tiles dequantized to bf16 (code x
    scale in fp32, rounded once); KG key groups (two where their warps fit
    384 threads) take every other tile and merge at the end."""
    q, (kq, vq, ks, vs), (pk, pv, pks, pvs) = x["q"], x["new"], x["pools"]
    b, hq, c, d = q.shape
    group, num_pages, max_pages = hq // HKV, pk.shape[1], x["tables"].shape[1]
    rows = ps * group
    kg = 2 if 2 * 32 * -(-rows // 16) <= 384 else 1
    deq = lambda a, s: ref.dequantize_rows(a, s, fmt).bfloat16()  # noqa: E731
    kc, vc = deq(kq, ks), deq(vq, vs)
    kp, vp = (deq(a, s).reshape(HKV, num_pages * ps, d) for a, s in ((pk, pks), (pv, pvs)))
    qscale = SCALE * math.log2(math.e)
    out = torch.zeros_like(q)
    r = torch.arange(rows)
    for bi in range(b):
        start, ln = int(x["starts"][bi]), int(x["lens"][bi])
        for h in range(HKV):
            for bq in range(c // ps):
                w = prefill_walk(start, ln, ps, bq, max_pages, window, fault)
                heads, pos_q = h * group + r % group, w["i_lo"] + r // group
                qs = q[bi, heads, pos_q]
                qp = (w["q_lo"] + r // group)[:, None]
                states = []
                for g in range(kg):
                    st = (torch.full((rows, 1), float("-inf")), torch.zeros(rows, 1),
                          torch.zeros(rows, d))
                    for t in range(g, w["n"], kg):
                        prior, at, pos = walk_tile(w, t, start, x["tables"][bi], ps, num_pages)
                        src_k, src_v = (kp[h], vp[h]) if prior else (kc[bi, h], vc[bi, h])
                        safe = at.clamp(0, src_k.shape[0] - 1)
                        dead = (pos < 0)[:, None]
                        k = torch.where(dead, 0, src_k[safe])
                        v = torch.where(dead, 0, src_v[safe])
                        live = (pos[None] >= 0) & (pos[None] <= qp)
                        if window:
                            live &= (qp - pos[None]) < window
                        st = pair_tile(st, qs, k, v, live, qscale, fault)
                    states.append(st)
                m, l, o = states[0]
                for m1, l1, o1 in states[1:]:  # WarpAttention.absorb
                    mc = torch.maximum(m, m1).clamp_min(NEG_CLAMP)
                    a, bb = torch.exp2(m.clamp_min(NEG_CLAMP) - mc), torch.exp2(m1.clamp_min(NEG_CLAMP) - mc)
                    m, l, o = torch.maximum(m, m1), l * a + l1 * bb, o * a + o1 * bb
                out[bi, heads, pos_q] = (o / l.clamp_min(1e-30)).to(q.dtype)
    return out


# (query heads, page size, format, window): qwen2-1.5B's 12 over 2 on
# pages of 16 (96 rows: two key groups of 6 warps) and 8 (48 rows), and a
# group of 4 on pages of 32 (128 rows: one key group of 8 warps)
PREFILL_CASES = [(12, 16, "int8", None), (12, 16, "int4", 96), (12, 8, "int8", 96),
                 (8, 32, "int4", None)]


@pytest.mark.parametrize("hq,ps,fmt,window", PREFILL_CASES, ids=[str(c) for c in PREFILL_CASES])
def test_quant_prefill_walk_rehearsal_within_the_bf16_limit(cs, hq, ps, fmt, window):
    """The walk at qwen's head dim, with an idle slot, a one-token chunk, a
    partial chunk and window 96, against ref.paged_prefill_attention_quant:
    within 2 bf16 ulps everywhere; P rounded once and chunk keys cut at the
    block's first position fail the limit."""
    x = _prefill_inputs(11, hq, ps, fmt)
    plain = ref.paged_prefill_attention_quant(
        x["q"], *x["new"], *[t.clone() for t in x["pools"]], x["tables"], x["starts"],
        x["lens"], fmt=fmt, sm_scale=SCALE, window=window)[0]
    got = prefill_rehearsal(x, fmt, ps, window)
    assert cs.bf16_ulps(torch, got, plain) <= cs.BF16_ULPS
    assert got[1].abs().max() > 0  # the idle slot's rows still attend its prior pages
    for fault in ("P rounded once", "chunk cut at the first position"):
        assert _over(cs, prefill_rehearsal(x, fmt, ps, window, fault), plain), fault


# ---------------------------------------------------------------------------
# (b) the tensor-core scan, rehearsed
# ---------------------------------------------------------------------------


def _scan_operands(seed, batch, heads, nc, length, n=128, p=64, shallow=False):
    """numpy-seeded operands: C and B broadcast over the heads (bf16), X
    (bf16), and a deep decay (dA_cum near -0.7 a row, exp(dA) below fp32's
    normals by a chunk's end) with N(0, 1) carried states, or (``shallow``)
    a decay of 0.1 a row with the states the chunks carry (the plain
    chunk_state and recurrence: tens, where a row of C S_prev cancels)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype("float32"))  # noqa: E731
    cm, bm = (f(batch, 1, nc, length, n).bfloat16().expand(batch, heads, nc, length, n)
              for _ in range(2))
    x = f(batch, heads, nc, length, p).bfloat16()
    da = torch.cumsum((-0.1 if shallow else -0.7) * f(batch, heads, nc, length).abs(), dim=-1)
    prev = f(batch, heads, nc, n, p)
    if shallow:
        prev = ref.state_recurrence(ref.chunk_state(bm, x, da), da[..., -1])
    return cm, bm, x, da, prev


def _terms(t, n):
    """t as the sum of n bf16 terms, each the rounding of what the ones
    before it leave (n 2: the pair hi + lo; 3: hi + mid + lo)."""
    out = []
    for _ in range(n):
        out.append(t.bfloat16().float())
        t = t - out[-1]
    return out


SCORE_TERMS = {None: 3, "scores as the pair hi + lo": 2, "scores rounded once": 1}
STATE_TERMS = {None: 3, "carried state as the pair hi + lo": 2}


def scan_rehearsal(cm, bm, x, da, prev, hg, fault=None):
    """chunk_scan_kernel_tc in plain PyTorch: per (batch, chunk) and group
    of ``hg`` heads, S = C B^T once from the group's first head (fp32 sums
    of exact bf16 products); per head, C times S_prev as three bf16 terms
    hi + mid + lo, times exp(dA_l), plus the decayed scores (the select
    before the exp) as three terms times X; Y rounded once.  ``fault``: the
    scores as the pair or rounded once, or "decay without its select"."""
    batch, heads, nc, length, _ = cm.shape
    tril = torch.ones(length, length, dtype=torch.bool).tril()
    y = torch.empty(x.shape, dtype=x.dtype)
    for h0 in range(0, heads, hg):
        s = cm[:, h0].float() @ bm[:, h0].float().transpose(-1, -2)  # (B, nc, L, L)
        for h in range(h0, min(heads, h0 + hg)):
            d = da[:, h]
            seg = d[..., :, None] - d[..., None, :]
            if fault == "decay without its select":
                att = s * torch.exp(seg)
            else:
                att = torch.where(tril, s * torch.exp(torch.where(tril, seg, 0.0)), 0.0)
            c, xh = cm[:, h].float(), x[:, h].float()
            state = _terms(prev[:, h], STATE_TERMS.get(fault, 3))
            acc = sum(c @ term for term in state) * torch.exp(d)[..., None]
            for term in _terms(att, SCORE_TERMS.get(fault, 3)):
                acc = acc + term @ xh
            y[:, h] = acc.to(x.dtype)
    return y


# (batch, heads, chunks, L, heads a block, shallow decay): mamba2's N 128 /
# P 64 with a few heads in groups of 3 (the last group short), chunks of
# 128 and of 64, and the carried states of a shallow decay
SCAN_CASES = [(2, 5, 2, 128, 3, False), (1, 4, 3, 64, 2, False), (1, 3, 2, 128, 1, False),
              (1, 4, 4, 128, 2, True)]


@pytest.mark.parametrize("case", SCAN_CASES, ids=[str(c) for c in SCAN_CASES])
def test_scan_walk_rehearsal_within_the_bf16_limit(cs, case):
    """The scan's walk with C B^T shared across a group of heads, against
    ref.chunk_scan: within 2 bf16 ulps; the scores rounded once to bf16
    and the decay taken without its select fail the limit, and so do the
    pair hi + lo that serves attention's P in place of three terms: for the
    scores at chunks of 128 (a row's 128 signed products cancel past the
    pair's 16 bits) and for the carried states of a shallow decay."""
    batch, heads, nc, length, hg, shallow = case
    ops_ = _scan_operands(13, batch, heads, nc, length, shallow=shallow)
    plain = ref.chunk_scan(*ops_)
    assert cs.bf16_ulps(torch, scan_rehearsal(*ops_, hg), plain) <= cs.BF16_ULPS
    faults = ["scores rounded once", "decay without its select"]
    if length == 128 and not shallow:
        faults.append("scores as the pair hi + lo")
    if shallow:
        faults.append("carried state as the pair hi + lo")
    for fault in faults:
        assert _over(cs, scan_rehearsal(*ops_, hg, fault), plain), fault


# ---------------------------------------------------------------------------
# (c) the dequantization rule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_dequantization_rule_is_the_plain_versions_bit_for_bit(fmt):
    """kv_dequant.cuh's arithmetic, step by step: each byte (int8) or
    nibble (int4, low first) biased into the low mantissa bits of 2^23 (by
    XOR with 0x80 / 0x8), the float less 2^23 + bias (the code, exactly),
    times the row's bf16 scale in fp32, rounded once to bf16: bytes equal
    to ref.dequantize_rows(...).to(bfloat16) on K rows of qwen's head dim."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal((96, D)).astype("float32")).bfloat16()
    x[7] = 0  # an all-zero row: scale 1
    packed, scales = ref.quantize_rows(x, fmt)
    b = packed.numpy().view(np.uint8).astype(np.uint32)
    if fmt == "int8":
        biased, bias = b ^ 0x80, 128.0
    else:
        biased = (np.stack([b & 0xF, b >> 4], -1).reshape(b.shape[0], -1)) ^ 0x8
        bias = 8.0
    as_float = (np.uint32(0x4B000000) | biased).view(np.float32)
    codes = as_float - np.float32(8388608.0 + bias)
    prod = torch.as_tensor(codes * scales.float().numpy())
    want = ref.dequantize_rows(packed, scales, fmt).bfloat16()
    assert torch.equal(prod.bfloat16().view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# (d) the card path, with the kernel call recorded
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
    """Both wrappers' C entry points replaced by recorders, the CUDA stream
    and the SM count by stand-ins and the plain versions by a failure."""
    calls = {}
    for name, mod in (("prefill_attention_quant", PFQ), ("chunk_scan", CSC)):
        def fn(*args, _name=name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(mod.KERNEL, "function", lambda _fn=fn: _fn)
        monkeypatch.setattr(mod.KERNEL, "launches", 0)
        monkeypatch.setattr(mod.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(CSC, "sm_count", lambda index: 8)  # a small card: groups of heads
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("paged_prefill_attention_quant", "chunk_scan"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


def test_quant_prefill_card_path_passes_q_and_out_by_strides(card_path):
    """The prefill layer's q (B, Hq, C, D), a view of (B, C, Hq, D), at
    qwen2-1.5B's serving shapes: bf16 (int8 and int4) passes tc 1 and the
    view's own data and strides, with the output in the same layout (no
    repack either way); fp32 packs q chunk-major for the CUDA-core kernel."""
    b, c, hq, ps, mp = 2, 64, 12, 16, 8
    num_pages = b * mp + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    starts = _card(torch.tensor([0, 32], dtype=torch.int32))
    lens = _card(torch.tensor([64, 20], dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float32):
        for fmt, pack in (("int8", 1), ("int4", 2)):
            q = _card(torch.randn(b, c, hq, D).to(dtype)).transpose(1, 2)
            (kq, ks), (vq, vs) = (ref.quantize_rows(torch.randn(b, HKV, c, D).to(dtype), fmt)
                                  for _ in range(2))
            pools = [_card(torch.zeros(HKV, num_pages, ps, D // pack, dtype=torch.int8))
                     for _ in range(2)]
            scales = [_card(torch.zeros(HKV, num_pages, ps, 1, dtype=dtype)) for _ in range(2)]
            out, *kept = PFQ.prefill_attention_quant(
                q, *map(_card, (kq, vq, ks, vs)), *pools, *scales, tables, starts, lens,
                fmt=fmt, window=96)
            call = card_path["prefill_attention_quant"][-1]
            assert all(a is w for a, w in zip(kept, pools + scales)) and out.shape == q.shape
            assert call[1:3] == (int(dtype == torch.bfloat16), pack)
            assert call[22:31] == (b, HKV, hq // HKV, c, D, ps, mp, num_pages, 96)
            if dtype == torch.bfloat16:
                assert call[3] == q.data_ptr() and out.stride() == q.stride()
                assert call[16:22] == (*q.stride()[:3], *out.stride()[:3])
            else:
                assert call[3] != q.data_ptr() and call[16:22] == (0,) * 6
    assert (PFQ.KERNEL.launches, PFQ.KERNEL.tc_launches) == (4, 2)


def test_chunk_scan_card_path_takes_tensor_cores_for_bf16(card_path):
    """mamba2's operands: broadcast C and B in bf16 pass tc 1 with a head
    group sharing C B^T (3 heads: 2 x 2 chunks x 2 groups fill 8 SMs),
    materialised copies with X in rows 2 P apart tc 1 with groups of one
    head; fp32 and hymba's P 50 pass tc 0."""
    batch, heads, nc, length = 2, 6, 2, 128
    for dtype, n, p, want in ((torch.bfloat16, 128, 64, (1, 3)), (torch.float32, 128, 64, (0, 1)),
                              (torch.bfloat16, 16, 50, (0, 1))):
        cm, bm, x, da, prev = _scan_operands(3, batch, heads, nc, length, n, p)
        xs = torch.cat([x, x], -1)[..., :p]  # rows 2 P apart
        args = [_card(t) for t in (cm.to(dtype), bm.to(dtype), x.to(dtype), da, prev)]
        CSC.chunk_scan(*args)
        call = card_path["chunk_scan"][-1]
        assert call[:3] == (CSC.DTYPES[dtype], *want)
        if dtype == torch.bfloat16 and p == 64:
            CSC.chunk_scan(*[_card(t.contiguous()) for t in (cm, bm)], _card(xs), *args[3:])
            assert card_path["chunk_scan"][-1][:3] == (1, 1, 1)
    assert (CSC.KERNEL.launches, CSC.KERNEL.tc_launches) == (4, 2)
