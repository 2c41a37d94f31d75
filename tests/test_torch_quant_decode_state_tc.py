"""The quantized GQA decode on the split-KV tensor-core walk, and Mamba-2's
chunk_state on the tensor cores, on the CPU.

* The quantized decode's split rehearsal (``paged_attention.split_decode``
  over the pools dequantized to q's dtype, as the kernel's staged loader
  hands them to the walk: partial softmax states over each split's 64-key
  tiles, then the merge that rescales them to their common max) equals the
  plain version ``ref.paged_attention_quant`` in int8 and int4, window None
  and 256, at qwen2-1.5B's reduced and serving shapes and on its edges
  (lengths 0, 1, a tile's last key and the next, the whole table).  Limits:
  1e-5 in fp32; two bf16 ulps of the plain value in bf16, with P as the
  kernel's pair hi + lo (chip_smoke.py's limit).
* The control: the merge that sums the splits without rescaling them fails
  that limit.
* The quantized decode's card path, with the kernel's C call replaced by a
  recorder: fp32 scratch of the split grid's shapes, ``splits`` and
  ``split_keys`` from ``decode_splits``, ``tc`` from ``tensor_core_path``.
* chunk_state's tensor-core arithmetic in plain PyTorch: the decay put on X
  (Xd = exp(dA_last - dA_l) X_l in fp32), Xd as the bf16 pair hi + lo, B^T
  times each term summed in fp32 over 16-row k steps, B taken from a head
  group's first head.  Within 1e-4 of max(1, max |plain|) of
  ``ref.chunk_state`` at mamba2-2.7B's N 128 / P 64, deep and shallow decay,
  chunks of 128 and 64; Xd rounded once to bf16 fails that limit.  Readings
  (error / max(1, max |plain|)) of STATE_CASES, the pair against Xd
  rounded once: deep 128 2.8e-6 / 1.8e-3, shallow 128 2.8e-6 / 1.7e-3,
  deep 64 3.7e-6 / 2.1e-3, shallow 64 2.7e-6 / 1.5e-3, growing 128 3.0e-6
  / 2.0e-3: the pair passes with a margin of 27x and more, so the kernel
  does not need chunk_scan's three terms.
* chunk_state's routing: bf16 at mamba2-2.7B's shapes (on the views its
  layer hands over) takes the tensor cores; hymba-1.5B's P 50 and fp32 do
  not; a block takes a group of heads only where B has head stride 0.
* tools/chunk_state_ablation.py's text edits still match the kernel.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import chunk_state as CST
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_attention_quant as PAQ
from repro_torch.kernels import ref
from repro_torch.models import layers as L

ROOT = Path(__file__).resolve().parents[1]
SMS = 132  # an H100 SXM's streaming multiprocessors


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# ---------------------------------------------------------------------------
# (a) the quantized decode's split rehearsal
# ---------------------------------------------------------------------------


def _quant_inputs(seed, slots, hq, hkv, d, ps, max_pages, lens, dtype, fmt):
    """numpy-seeded q and pools of ``dtype``, the pools quantized per row;
    a shuffled table (page 0 reserved)."""
    rng = np.random.default_rng(seed)
    num_pages = slots * max_pages + 1
    tables = torch.as_tensor((rng.permutation(num_pages - 1) + 1)
                             .reshape(slots, max_pages).astype("int32"))
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype("float32")).to(dtype)  # noqa: E731
    q = f(slots, hq, d)
    (kq, ks), (vq, vs) = (ref.quantize_rows(f(hkv, num_pages, ps, d), fmt) for _ in range(2))
    return q, (kq, vq, ks, vs), tables, torch.tensor(lens, dtype=torch.int32)


def _rehearsal(q, pools, tables, lens, fmt, window, **kw):
    """The quantized split kernel in plain PyTorch: the pools dequantized
    to q's dtype (the staged loader's rule), then the split decode."""
    kq, vq, ks, vs = pools
    kp, vp = (ref.dequantize_rows(a, s, fmt).to(q.dtype) for a, s in ((kq, ks), (vq, vs)))
    splits, keys = PA.decode_splits(q.shape[0], kp.shape[0], tables.shape[1], kp.shape[2], SMS)
    return PA.split_decode(q, kp, vp, tables, lens, splits, keys, window=window,
                           pair=q.dtype == torch.bfloat16, **kw)


def _error(cs, got, want):
    if got.dtype == torch.bfloat16:
        return cs.bf16_ulps(torch, got, want)
    return (got.float() - want.float()).abs().max().item()


def _limit(cs, dtype):
    return cs.BF16_ULPS if dtype == torch.bfloat16 else 1e-5


# name: (slots, Hq, Hkv, D, page size, max pages, lengths): qwen2-1.5B's reduced
# model and its serving shape (slots 8, 64 pages of 16); the edges: an empty
# slot, one key, a tile's last key and the next, the whole table
SHAPES = {
    "reduced": (4, 4, 2, 16, 16, 8, [77, 0, 64, 128]),
    "serving": (8, 12, 2, 128, 16, 64, [5, 300, 0, 1024, 77, 1024, 640, 999]),
    "edges": (6, 12, 2, 128, 16, 64, [0, 1, 64, 65, 700, 1024]),
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_quant_split_rehearsal_matches_plain_version(cs, shape, dtype, fmt, window):
    slots, hq, hkv, d, ps, mp, lens = SHAPES[shape]
    q, pools, tables, ln = _quant_inputs(1, slots, hq, hkv, d, ps, mp, lens, dtype, fmt)
    got = _rehearsal(q, pools, tables, ln, fmt, window)
    plain = ref.paged_attention_quant(q, *pools, tables, ln, fmt=fmt, window=window)
    assert _error(cs, got, plain) <= _limit(cs, dtype)
    assert torch.all(got[lens.index(0)] == 0)  # an empty slot emits zeros
    assert torch.isfinite(got).all()


# ---------------------------------------------------------------------------
# (b) the merge without the rescale
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_quant_merge_without_rescale_fails_the_limit(cs, dtype, fmt):
    """The splits' states summed as they stand, not rescaled to their
    common max, read far beyond the limit at qwen's serving shape."""
    slots, hq, hkv, d, ps, mp, lens = SHAPES["serving"]
    q, pools, tables, ln = _quant_inputs(1, slots, hq, hkv, d, ps, mp, lens, dtype, fmt)
    plain = ref.paged_attention_quant(q, *pools, tables, ln, fmt=fmt)
    sound = _error(cs, _rehearsal(q, pools, tables, ln, fmt, None), plain)
    faulty = _error(cs, _rehearsal(q, pools, tables, ln, fmt, None, rescale=False), plain)
    assert sound <= _limit(cs, dtype) < faulty
    assert faulty > 100 * _limit(cs, dtype)


# ---------------------------------------------------------------------------
# (c) the quantized decode's card path, with the kernel call recorded
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
    """The two wrappers' C entry points replaced by recorders, the CUDA
    stream and the SM count by stand-ins, ``torch.empty`` by a recorder of
    the shapes it makes and the plain versions by a failure."""
    calls = {}
    for name, mod in (("paged_attention_quant", PAQ), ("chunk_state", CST)):
        def fn(*args, _name=name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(mod.KERNEL, "function", lambda _fn=fn: _fn)
        monkeypatch.setattr(mod.KERNEL, "launches", 0)
        monkeypatch.setattr(mod.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(PA, "sm_count", lambda index: SMS)
    monkeypatch.setattr(CST, "sm_count", lambda index: SMS)
    empty = torch.empty
    shapes = calls.setdefault("scratch", [])

    def recording_empty(*size, **kw):
        t = empty(*size, **kw)
        shapes.append((tuple(t.shape), t.dtype))
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("paged_attention_quant", "chunk_state"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


@pytest.mark.parametrize("fmt", ["int8", "int4"])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_quant_decode_card_path_hands_the_kernel_its_split_grid(card_path, dtype, fmt):
    """qwen2-1.5B's serving shape: whatever the lengths, the kernel gets
    decode_splits' grid (16 splits of 64 keys), (slots, Hq, splits, D) and
    (2, slots, Hq, splits) fp32 scratch, and tc 1 for bf16 at D 128 (the
    tensor-core rule of the fp decode), 0 for fp32; the head dim 96 takes
    the CUDA cores in bf16 too."""
    b, hq, hkv, d, ps, mp = 8, 12, 2, 128, 16, 64
    pack = ref.KV_PACK[fmt]
    num_pages = b * mp + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    splits, keys = PA.decode_splits(b, hkv, mp, ps, SMS)
    assert (splits, keys) == (16, 64)
    for head_dim in (d, 96):
        q = _card(torch.zeros(b, hq, head_dim, dtype=dtype))
        kq = _card(torch.zeros(hkv, num_pages, ps, head_dim // pack, dtype=torch.int8))
        ks = _card(torch.zeros(hkv, num_pages, ps, 1, dtype=dtype))
        tc = PA.tensor_core_path(dtype, head_dim, hq // hkv)
        assert tc == (dtype == torch.bfloat16 and head_dim == d)
        for lens in ([0] * b, [1024] * b, [5, 300, 0, 1024, 77, 1024, 640, 999]):
            card_path["scratch"].clear()
            out = PAQ.paged_attention_quant(q, kq, kq, ks, ks, tables,
                                            _card(torch.tensor(lens, dtype=torch.int32)),
                                            fmt=fmt, window=256)
            call = card_path["paged_attention_quant"][-1]
            assert out.shape == q.shape
            assert call[:3] == (PA.DTYPES[dtype], int(tc), pack)
            assert call[13:23] == (b, hq, hkv, head_dim, ps, mp, num_pages, 256, splits, keys)
            assert ((b, hq, splits, head_dim), torch.float32) in card_path["scratch"]
            assert ((2, b, hq, splits), torch.float32) in card_path["scratch"]
    assert PAQ.KERNEL.launches == 6
    assert PAQ.KERNEL.tc_launches == (3 if dtype == torch.bfloat16 else 0)


# ---------------------------------------------------------------------------
# (d) chunk_state's tensor-core arithmetic, rehearsed
# ---------------------------------------------------------------------------


def _state_operands(seed, batch, heads, nc, length, n=128, p=64, decay="deep"):
    """numpy-seeded operands: B broadcast over the heads (bf16), X (bf16),
    dA_cum falling by 0.7 |N(0, 1)| a row (deep: exp(dA) denormal by a
    chunk's end), by 0.1 |N(0, 1)| (shallow) or rising by it (growing)."""
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.as_tensor(rng.standard_normal(s).astype("float32"))  # noqa: E731
    bm = f(batch, 1, nc, length, n).bfloat16().expand(batch, heads, nc, length, n)
    x = f(batch, heads, nc, length, p).bfloat16()
    rate = {"deep": -0.7, "shallow": -0.1, "growing": 0.1}[decay]
    step = rate * f(batch, heads, nc, length).abs()
    return bm, x, torch.cumsum(step, dim=-1)


def state_rehearsal(bm, x, da, hg, terms=2):
    """chunk_state_kernel_tc in plain PyTorch: per (batch, chunk) and group
    of ``hg`` heads, B from the group's first head; per head Xd = exp(dA_last
    - dA_l) X_l in fp32, as ``terms`` bf16 terms (2: the pair hi + lo; 1:
    rounded once), B^T times each term summed in fp32 over 16-row k
    steps."""
    batch, heads, nc, length, n = bm.shape
    out = torch.empty(batch, heads, nc, n, x.shape[-1])
    for h0 in range(0, heads, hg):
        bt = bm[:, h0].float().transpose(-1, -2)  # (B, nc, N, L)
        for h in range(h0, min(heads, h0 + hg)):
            d = da[:, h]
            xd = x[:, h].float() * torch.exp(d[..., -1:] - d)[..., None]
            parts = []
            for _ in range(terms):
                parts.append(xd.bfloat16().float())
                xd = xd - parts[-1]
            acc = torch.zeros(batch, nc, n, x.shape[-1])
            for k in range(0, length, 16):
                acc = acc + sum(bt[..., k:k + 16] @ t[..., k:k + 16, :] for t in parts)
            out[:, h] = acc
    return out


# (batch, heads, chunks, L, heads a block, decay): mamba2's N 128 / P 64
STATE_CASES = [(1, 5, 3, 128, 2, "deep"), (1, 4, 3, 128, 4, "shallow"),
               (1, 4, 4, 64, 3, "deep"), (1, 4, 4, 64, 1, "shallow"),
               (1, 3, 2, 128, 3, "growing")]


@pytest.mark.parametrize("case", STATE_CASES, ids=[str(c) for c in STATE_CASES])
def test_state_rehearsal_within_the_limit(cs, case):
    """The pair hi + lo within 1e-4 of max(1, max |plain|), with a margin
    of 10x; Xd rounded once to bf16 fails the limit, and so does
    chip_smoke's control (``state_variant``, the same rounding)."""
    batch, heads, nc, length, hg, decay = case
    bm, x, da = _state_operands(17, batch, heads, nc, length, decay=decay)
    plain = ref.chunk_state(bm, x, da)
    scale = max(1.0, plain.abs().max().item())
    rel = lambda got: (got - plain).abs().max().item() / scale  # noqa: E731
    assert rel(state_rehearsal(bm, x, da, hg)) <= cs.FP32_ATOL / 10
    assert rel(state_rehearsal(bm, x, da, hg, terms=1)) > cs.FP32_ATOL
    assert rel(cs.state_variant(torch, bm, x, da, torch.bfloat16)) > cs.FP32_ATOL


# ---------------------------------------------------------------------------
# (e) chunk_state's routing
# ---------------------------------------------------------------------------


def _layer_views(arch, seq=256, batch=1, dtype=torch.bfloat16):
    """The chunk_state operands a full-width layer of ``arch`` hands over:
    the conv-split B head-broadcast view, X times dt and dA_cum, as (B, H,
    nc, L, .) views."""
    cfg = get_config(arch)
    sm = cfg.ssm
    di, nh, n, p = sm.d_inner(cfg.d_model), sm.num_heads(cfg.d_model), sm.state_dim, sm.head_dim
    conv_out = torch.zeros(batch, seq, di + 2 * n, dtype=dtype)
    xin, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    xh = xin.reshape(batch, seq, nh, p).transpose(1, 2)
    bh, ch = (t[:, None].expand(batch, nh, seq, n) for t in (bm, cm))
    dth = torch.ones(batch, nh, seq)
    xdt = xh * dth[..., None].to(xh.dtype)
    _, bb, xx, da = L.ssd_operands(ch, bh, xdt, dth, torch.zeros(nh), min(sm.chunk, seq))
    return cfg, (bb, xx, da)


def test_state_path_rule_at_mamba2_training_shapes():
    """mamba2-2.7B's layer hands chunk_state bf16 views that take the
    tensor cores (N 128, P 64, chunks of 128; B broadcast over the 80
    heads); 20 heads a block at its training grid, two blocks an SM on 132
    SMs.  fp32 and hymba-1.5B's P 50 do not take them."""
    cfg, (bb, xx, da) = _layer_views("mamba2_2_7b")
    n, p, length = cfg.ssm.state_dim, cfg.ssm.head_dim, cfg.ssm.chunk
    assert (n, p, length) == (128, 64, 128) and bb.stride(1) == 0
    assert CST.tensor_core_path(torch.bfloat16, length, n, p, CST.rows_aligned(bb, xx))
    assert CST.head_group(8, 80, 8, p, SMS, True, per_sm=CST.STATE_BLOCKS_PER_SM) == 20
    assert CST.head_group(8, 80, 8, p, SMS, False, per_sm=CST.STATE_BLOCKS_PER_SM) == 1
    assert not CST.tensor_core_path(torch.float32, length, n, p)
    hy, (hb, hx, _) = _layer_views("hymba_1_5b")
    assert (hy.ssm.state_dim, hy.ssm.head_dim) == (16, 50)
    assert not CST.tensor_core_path(torch.bfloat16, length, 16, 50, CST.rows_aligned(hb, hx))


def test_state_card_path_routes(card_path, monkeypatch):
    """On the card path: bf16 at mamba2's N 128 / P 64 passes tc 1, with a
    head group for broadcast B (2 of 8 heads on a small card of 8 SMs, two
    blocks each: 2 x 2 chunks x 4 groups) and groups of one head for a
    materialised B; fp32 and hymba's P 50 pass tc 0; the recorded call
    carries B's head stride 0."""
    monkeypatch.setattr(CST, "sm_count", lambda index: 8)
    batch, heads, nc, length = 2, 8, 2, 128
    for dtype, n, p, broadcast, want in (
            (torch.bfloat16, 128, 64, True, (1, 2)), (torch.bfloat16, 128, 64, False, (1, 1)),
            (torch.float32, 128, 64, True, (0, 1)), (torch.bfloat16, 16, 50, True, (0, 1))):
        bm = torch.zeros(batch, 1, nc, length, n, dtype=dtype).expand(batch, heads, nc, length, n)
        if not broadcast:
            bm = bm.contiguous()
        x = torch.zeros(batch, heads, nc, length, p, dtype=dtype)
        da = torch.zeros(batch, heads, nc, length)
        out = CST.chunk_state(_card(bm), _card(x), _card(da))
        call = card_path["chunk_state"][-1]
        assert out.shape == (batch, heads, nc, n, p) and out.dtype == torch.float32
        assert call[:3] == (CST.DTYPES[dtype], *want)
        assert call[7:11] == tuple(bm.stride()[:4]) and (call[8] == 0) == broadcast
    assert (CST.KERNEL.launches, CST.KERNEL.tc_launches) == (4, 2)


@pytest.mark.parametrize("variant", ["no stores", "no terms", "no mma", "hi only",
                                     "plain stores"])
def test_ablation_edits_match_the_kernel_source(variant):
    """tools/chunk_state_ablation.py's text edits each match
    chunk_state_kernel_tc's source exactly once (the tool raises on the card
    where one no longer does)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "chunk_state_ablation", ROOT / "tools" / "chunk_state_ablation.py")
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    source = (ROOT / "src/repro_torch/kernels/csrc/linear_attention.cu").read_text()
    _, edits = tool.VARIANTS[variant]
    assert edits and all(source.count(old) == 1 for old, _ in edits)
