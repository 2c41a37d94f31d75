"""The tensor-core path of the MLA chunked prefill and its quantized twin,
on the CPU.

* The wrappers pick the tensor-core kernel from dtype and shape alone: bf16
  at deepseek-v2-lite-16B's full-width latent (R 512, Dpe 64, in both
  packages' configs) takes it; fp32, another latent width, pages that do
  not nest in its 32-key tiles and the reduced config's shape do not.
* The CPU route of ``ops.mla_prefill`` / ``ops.mla_prefill_quant`` (the
  plain versions) matches the JAX package's XLA path on the same
  numpy-seeded inputs at those widths.
* The kernel's walk, rehearsed in plain PyTorch: 64 chunk-major query rows
  a block, the prior pages through the table then the chunk's own rows in
  tiles of 32 keys, each key with its absolute position (-1: dead) and one
  positional mask, the online softmax with P as the pair hi + lo.  At
  deepseek's widths, on pages of 1 to 32 positions, with an idle slot, a
  one-token chunk, a partial chunk and windows, it reads within chip_smoke's
  bf16 limit of the plain version; two faulty walks do not.
* The quantized twin's dequantization rule (each code times its row's
  scale in fp32, rounded once to bf16; int4 low nibble first) is bit for
  bit the plain version's.
* On the card path (a CUDA tensor) the wrappers hand the kernel the path
  and count the tensor-core launches: here the kernel call is replaced by
  a recorder, since this machine has no card.

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
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import mla_prefill as MF
from repro_torch.kernels import mla_prefill_quant as MFQ
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
ARCH = "deepseek_v2_lite_16b"
HEADS, RANK, ROPE = 16, 512, 64
SCALE = (128 + 64) ** -0.5
ROWS, KEYS = 64, MF.TC_KEYS  # the tensor-core kernel's query rows and keys a tile


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def test_tensor_core_path_rule_at_deepseek_shapes():
    """bf16 at deepseek-v2-lite-16B's latent (both packages' config) takes
    the tensor cores on every page size that nests in a 32-key tile; fp32,
    fp16, R 256, R + Dpe not a multiple of 64, pages of 64 or 12 and the
    reduced config (R 32, Dpe 8) take the CUDA-core kernel."""
    cfg, jcfg = get_config(ARCH), jconfigs.get_config(ARCH)
    r, pe = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    assert (r, pe) == (jcfg.mla.kv_lora_rank, jcfg.mla.qk_rope_head_dim) == (RANK, ROPE)
    assert cfg.num_heads == jcfg.num_heads == HEADS
    for ps in (1, 2, 8, 16, 32):
        assert MF.tensor_core_path(torch.bfloat16, r, pe, ps)
    assert not MF.tensor_core_path(torch.float32, r, pe, 16)
    assert not MF.tensor_core_path(torch.float16, r, pe, 16)
    assert not MF.tensor_core_path(torch.bfloat16, 256, pe, 16)
    assert not MF.tensor_core_path(torch.bfloat16, r, 32, 16)
    assert not MF.tensor_core_path(torch.bfloat16, r, pe, 64)
    assert not MF.tensor_core_path(torch.bfloat16, r, pe, 12)
    red = cfg.reduced().mla
    assert not MF.tensor_core_path(torch.bfloat16, red.kv_lora_rank, red.qk_rope_head_dim, 16)


# ---------------------------------------------------------------------------
# inputs at deepseek's widths
# ---------------------------------------------------------------------------

SLOTS, CHUNK = 4, 32


def _inputs(seed, ps, mp=None):
    """numpy fp32 queries, chunk and pools, a table, and chunk starts /
    lengths with an idle slot (0), a one-token chunk and a partial one."""
    mp = mp or 128 // ps
    rng = np.random.default_rng(seed)
    num_pages = SLOTS * mp + 1
    tables = (rng.permutation(num_pages - 1)[: SLOTS * mp] + 1).reshape(SLOTS, mp)
    f = lambda *s: rng.standard_normal(s).astype("float32")  # noqa: E731
    starts = np.array([0, 16, 48, 96], "int32") // ps * ps
    return dict(q=f(SLOTS, HEADS, CHUNK, RANK), qpe=f(SLOTS, HEADS, CHUNK, ROPE),
                ckv=f(SLOTS, CHUNK, RANK), kpe=f(SLOTS, CHUNK, ROPE),
                ckv_pool=f(num_pages, ps, RANK), kpe_pool=f(num_pages, ps, ROPE),
                tables=tables.astype("int32"), starts=starts,
                lens=np.array([1, 0, 19, 32], "int32"))


@pytest.mark.parametrize("fmt,window", [(None, None), (None, 40), ("int8", 40), ("int4", None)])
def test_cpu_route_matches_the_jax_package_at_full_width(fmt, window):
    """ops.mla_prefill / ops.mla_prefill_quant on CPU tensors (the plain
    versions, which the tensor-core kernels are held against on the card)
    against the JAX package's XLA path on the same inputs, fp32, R 512:
    outputs at 1e-4, pools equal on every page but the sink page 0 (where
    the two write dead positions in different orders)."""
    x = _inputs(5, 16)
    t = lambda a: torch.as_tensor(np.array(a))  # noqa: E731
    if fmt is None:
        pools = [x["ckv_pool"], x["kpe_pool"]]
        fn, jfn, kw = ops.mla_prefill, jops.mla_prefill, {}
    else:
        (cq, cs_), (pq, ps_) = (jref.quantize_rows(x[k], fmt) for k in ("ckv_pool", "kpe_pool"))
        pools = [np.asarray(a) for a in (cq, pq, cs_, ps_)]
        fn, jfn, kw = ops.mla_prefill_quant, jops.mla_prefill_quant, {"fmt": fmt}
    args = (x["tables"], x["starts"], x["lens"])
    got = fn(t(x["q"]), t(x["qpe"]), t(x["ckv"]), t(x["kpe"]), *map(t, pools), *map(t, args),
             sm_scale=SCALE, window=window, **kw)
    want = jfn(x["q"], x["qpe"], x["ckv"], x["kpe"], *pools, *args, sm_scale=SCALE,
               window=window, backend="xla", **kw)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4)
    for g, w in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])


# ---------------------------------------------------------------------------
# the kernel's walk, rehearsed
# ---------------------------------------------------------------------------


def block_walk(start, ln, ps, bq, sub, max_pages, window, fault=None):
    """The tensor-core kernel's Walk for block (sub, bq) of a slot: its
    rows [r0, r0 + rows) of the chunk page, and its key tiles: n_prior
    tiles of prior positions [p_lo ps, min(start, p_hi ps)), then the
    chunk's rows [c_lo, c_hi).  ``fault`` plants a wrong bound."""
    r0 = sub * ROWS
    rows = min(ROWS, ps * HEADS - r0)
    i_first = bq * ps
    i_lo, i_hi = i_first + r0 // HEADS, i_first + (r0 + rows - 1) // HEADS
    if fault == "window from the last row":
        i_lo = i_hi
    p_hi = min(-(-start // ps), max_pages)
    p_lo = max(0, start + i_lo - window + 1) // ps if window else 0
    n_prior = -(-((p_hi - p_lo) * ps) // KEYS) if p_hi > p_lo else 0
    c_lo = max(0, i_lo - window + 1) if window else 0
    c_hi = min(i_hi + 1, ln)
    if fault == "chunk to the first row":
        c_hi = min(i_first + r0 // HEADS + 1, ln)
    n = n_prior + (-(-(c_hi - c_lo) // KEYS) if c_hi > c_lo else 0)
    return dict(r0=r0, rows=rows, i_first=i_first, p_lo=p_lo, p_hi=p_hi,
                n_prior=n_prior, c_lo=c_lo, c_hi=c_hi, n=n)


def walk_keys(w, start, table, ps, num_pages):
    """Walk.key for every row of every tile: (prior, at, pos), pos -1 for a
    dead row (zero-filled in the kernel)."""
    u = torch.arange(w["n"])[:, None]
    r = torch.arange(KEYS)[None, :]
    k = w["p_lo"] * ps + u * KEYS + r  # a prior tile's absolute positions
    idx = (k // ps).clamp(max=len(table) - 1)
    page = torch.as_tensor(table).long()[idx]
    prior = u < w["n_prior"]
    live_prior = prior & (k < start) & (k // ps < w["p_hi"]) & (page >= 0) & (page < num_pages)
    kj = w["c_lo"] + (u - w["n_prior"]) * KEYS + r
    live_chunk = ~prior & (kj < w["c_hi"])
    at = torch.where(prior, page * ps + k % ps, kj)
    pos = torch.where(live_prior, k, torch.where(live_chunk, start + kj, -1))
    return prior.expand_as(pos).reshape(-1), at.reshape(-1), pos.reshape(-1)


def pair_tiles(qs, ks, vs, live, scale):
    """mla_mma.cuh's step over 32-key tiles: fp32 scores in the log2
    domain, exp2, the running max clamped at NEG_CLAMP, P.V as the pair
    hi + lo accumulated in fp32, the output divided by max(l, 1e-30)."""
    s_all = (qs.float() @ ks.float().T) * (scale * math.log2(math.e))
    s_all = s_all.masked_fill(~live, float("-inf"))
    clamp = -2.0 ** 20
    m = torch.full((qs.shape[0], 1), float("-inf"))
    l = torch.zeros(qs.shape[0], 1)
    acc = torch.zeros(qs.shape[0], vs.shape[1])
    for t in range(0, ks.shape[0], KEYS):
        sc = s_all[:, t:t + KEYS]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        mc = m_new.clamp_min(clamp)
        alpha, p = torch.exp2(m.clamp_min(clamp) - mc), torch.exp2(sc - mc)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = vs[t:t + KEYS].float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    return acc / l.clamp_min(1e-30)


def kernel_rehearsal(q, qpe, ckv, kpe, ckv_pool, kpe_pool, tables, starts, lens, ps,
                     window=None, fault=None):
    """The tensor-core kernel's output in plain PyTorch from its walk: the
    bf16 tensors it attends (for the quantized twin, the dequantized pages
    and chunk), grid (ceil(ps H / 64), chunk pages, slots)."""
    b, h, c, r = q.shape
    num_pages, max_pages = ckv_pool.shape[0], tables.shape[1]
    pool_keys = torch.cat([ckv_pool, kpe_pool], -1).reshape(num_pages * ps, -1)
    new_keys = torch.cat([ckv, kpe], -1)
    qall = torch.cat([q, qpe], -1)
    out = torch.zeros_like(q)
    for bi in range(b):
        start, ln = int(starts[bi]), int(lens[bi])
        for bq in range(c // ps):
            for sub in range(-(-ps * h // ROWS)):
                w = block_walk(start, ln, ps, bq, sub, max_pages, window, fault)
                prior, at, pos = walk_keys(w, start, tables[bi], ps, num_pages)
                keys = torch.where(prior[:, None], pool_keys[at.clamp(0, num_pages * ps - 1)],
                                   new_keys[bi, at.clamp(0, c - 1)])
                keys = torch.where((pos >= 0)[:, None], keys, torch.zeros_like(keys))
                g = w["r0"] + torch.arange(w["rows"])
                heads, ii = g % h, w["i_first"] + g // h
                qp = start + ii
                live = (pos[None] >= 0) & (pos[None] <= qp[:, None])
                if window:
                    live &= (qp[:, None] - pos[None]) < window
                o = pair_tiles(qall[bi, heads, ii], keys, keys[:, :r], live, SCALE)
                out[bi, heads, ii] = o.to(q.dtype)
    return out


REHEARSALS = [(16, None, None), (16, 40, None), (8, None, "int8"), (32, 40, "int4"),
              (1, None, None), (2, 40, "int8")]


@pytest.mark.parametrize("ps,window,fmt", REHEARSALS, ids=[str(c) for c in REHEARSALS])
def test_kernel_walk_rehearsal_within_the_bf16_limit(cs, ps, window, fmt):
    """The walk, bf16 at deepseek's widths (pages of 16 and 8: 4 and 2 row
    blocks a chunk page; 32: 8; 2 and 1: one block with 32 and 48 dead
    rows), against ref.paged_mla_prefill(_quant): within 2 bf16 ulps
    everywhere, idle slot and dead query rows included."""
    x = _inputs(7, ps)
    bf = {k: torch.as_tensor(v).bfloat16() for k, v in x.items()
          if k not in ("tables", "starts", "lens")}
    tables, st, ln = (torch.as_tensor(x[k]) for k in ("tables", "starts", "lens"))
    if fmt is None:
        pools = [bf["ckv_pool"].clone(), bf["kpe_pool"].clone()]
        plain = ref.paged_mla_prefill(bf["q"], bf["qpe"], bf["ckv"], bf["kpe"], *pools,
                                      tables, st, ln, sm_scale=SCALE, window=window)[0]
        attended = [bf[k] for k in ("ckv", "kpe", "ckv_pool", "kpe_pool")]
    else:
        quant = {k: ref.quantize_rows(bf[k], fmt) for k in ("ckv", "kpe", "ckv_pool", "kpe_pool")}
        pools = [quant["ckv_pool"][0], quant["kpe_pool"][0], quant["ckv_pool"][1],
                 quant["kpe_pool"][1]]
        plain = ref.paged_mla_prefill_quant(
            bf["q"], bf["qpe"], quant["ckv"][0], quant["kpe"][0], quant["ckv"][1],
            quant["kpe"][1], *[p.clone() for p in pools], tables, st, ln, fmt=fmt,
            sm_scale=SCALE, window=window)[0]
        attended = [ref.dequantize_rows(*quant[k], fmt).bfloat16()
                    for k in ("ckv", "kpe", "ckv_pool", "kpe_pool")]
    got = kernel_rehearsal(bf["q"], bf["qpe"], *attended, x["tables"], x["starts"],
                           x["lens"], ps, window)
    assert cs.bf16_ulps(torch, got, plain) <= cs.BF16_ULPS
    if ps == 16:  # the limit sees a walk that drops keys
        for fault in ("window from the last row", "chunk to the first row"):
            if fault.startswith("window") and window is None:
                continue
            bad = kernel_rehearsal(bf["q"], bf["qpe"], *attended, x["tables"], x["starts"],
                                   x["lens"], ps, window, fault)
            assert cs.bf16_ulps(torch, bad, plain) > cs.BF16_ULPS, fault


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_dequantization_rule_is_the_plain_versions_bit_for_bit(fmt):
    """The quantized twin's dequant (csrc/mla_prefill.cu, dequant<PACK>):
    code (int8, or int4 low nibble first, sign-extended) times the row's
    bf16 scale in fp32, rounded once to bf16: bytes equal to
    ref.dequantize_rows(...).to(bfloat16) on rows of deepseek's widths."""
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal((64, RANK + ROPE)).astype("float32")).bfloat16()
    x[5] = 0  # an all-zero row: scale 1
    packed, scales = ref.quantize_rows(x, fmt)
    b = packed.numpy().view(np.uint8).astype(np.int32)
    if fmt == "int8":
        codes = np.where(b >= 128, b - 256, b)
    else:
        nib = np.stack([b & 0xF, b >> 4], -1).reshape(b.shape[0], -1)
        codes = np.where(nib >= 8, nib - 16, nib)
    prod = torch.as_tensor(codes.astype(np.float32) * scales.float().numpy())
    want = ref.dequantize_rows(packed, scales, fmt).bfloat16()
    assert torch.equal(prod.bfloat16().view(torch.int16), want.view(torch.int16))


# ---------------------------------------------------------------------------
# the card path, with the kernel call recorded
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
    by a stand-in and the plain versions by a failure."""
    calls = {}
    for name, mod in (("mla_prefill", MF), ("mla_prefill_quant", MFQ)):
        def fn(*args, _name=name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(mod.KERNEL, "function", lambda _fn=fn: _fn)
        monkeypatch.setattr(mod.KERNEL, "launches", 0)
        monkeypatch.setattr(mod.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("paged_mla_prefill", "paged_mla_prefill_quant"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


def test_card_path_takes_tensor_cores_for_bf16_at_full_width(card_path):
    """deepseek's serving shape (16 heads, R 512, Dpe 64, pages of 16):
    bf16 passes tc 1 to both entry points and counts a tensor-core launch;
    fp32 passes tc 0 (and the CUDA-core row block)."""
    x = _inputs(1, 16, mp=8)
    for dtype in (torch.bfloat16, torch.float32):
        c = {k: _card(torch.as_tensor(v)) for k, v in x.items()}
        f = {k: c[k].to(dtype) for k in ("q", "qpe", "ckv", "kpe", "ckv_pool", "kpe_pool")}
        out, *_ = MF.mla_prefill(f["q"], f["qpe"], f["ckv"], f["kpe"], f["ckv_pool"],
                                 f["kpe_pool"], c["tables"], c["starts"], c["lens"],
                                 sm_scale=SCALE, window=96)
        call = card_path["mla_prefill"][-1]
        tc = int(dtype == torch.bfloat16)
        assert out.shape == f["q"].shape and call[:2] == (tc, tc)
        assert call[12:22] == (SLOTS, HEADS, CHUNK, RANK, ROPE, 16, MF.row_block(16, HEADS),
                               8, x["ckv_pool"].shape[0], 96)
        for fmt, pack in (("int8", 1), ("int4", 2)):
            (cq, cs_), (pq, ps_) = (ref.quantize_rows(f[k], fmt) for k in ("ckv", "kpe"))
            pools = [ref.quantize_rows(f[k], fmt) for k in ("ckv_pool", "kpe_pool")]
            MFQ.mla_prefill_quant(f["q"], f["qpe"], cq, pq, cs_, ps_, pools[0][0], pools[1][0],
                                  pools[0][1], pools[1][1], c["tables"], c["starts"],
                                  c["lens"], fmt=fmt, sm_scale=SCALE)
            call = card_path["mla_prefill_quant"][-1]
            assert call[:3] == (tc, tc, pack)
    assert (MF.KERNEL.launches, MF.KERNEL.tc_launches) == (2, 1)
    assert (MFQ.KERNEL.launches, MFQ.KERNEL.tc_launches) == (4, 2)
