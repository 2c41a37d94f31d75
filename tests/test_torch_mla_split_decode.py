"""The split-KV paged MLA decode and its quantized twin, on the CPU.

* The split rehearsal (``mla_paged.split_decode``: partial softmax states
  over each split's 32-key tiles, then the fp32 merge that rescales them to
  their common max) equals the plain versions ``ref.mla_paged`` and
  ``ref.mla_paged_quant`` (the rehearsal over the pools dequantized to q's
  dtype, what the kernel attends) at deepseek-v2-lite-16B's reduced and
  serving shapes, and on its edges: window None and 256, a len-0 slot,
  lengths inside a split, at its ends and wholly before later splits, pages
  of 8, 16 and 32, int8 and int4.  Limits: 1e-6 in fp32 (the two differ
  only in exp2 against exp and the order of fp32 sums); in bf16, with P as
  the tensor-core kernel's pair hi + lo, two bf16 ulps of the plain value
  (chip_smoke.py's limit).  At the reduced shape both are also held against
  the JAX package's XLA path on the same numpy inputs.
* The control: a merge that sums the splits without rescaling them to the
  common max fails that limit.
* The split rule is the GQA decode's with head blocks for kv heads: one
  wave, or a tile a split, at deepseek's serving shape (16 splits of 64
  keys, 128 blocks), every key covered, no length among its inputs.
* The card path, with the kernels' C calls replaced by a recorder (the
  tests run without a card): each wrapper hands its kernel the fp32 scratch of
  the partial states and the grid, bf16 at R 512 takes the tensor-core
  route, ``tc_launches`` counts it, and a shape the kernel does not take
  raises ValueError without reaching the plain version.
* chip_smoke.py's int4 logits gate: the CPU run on the card's codes
  (``replayed_codes``) removes the codes' rounding from the comparison.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import dataclasses
import inspect
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import mla_paged as MP
from repro_torch.kernels import mla_paged_quant as MPQ
from repro_torch.kernels import mla_prefill as MF
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref
from repro_torch.models import lm

ROOT = Path(__file__).resolve().parents[1]
SMS = 132  # an H100 SXM's streaming multiprocessors
ARCH = "deepseek_v2_lite_16b"


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def _inputs(seed, slots, h, r, pe, ps, max_pages, lens, dtype, fmt):
    """numpy inputs, and the tensors: (kernel args, the pools the kernel
    attends).  Quantized pools are quantized per row from q's dtype."""
    rng = np.random.default_rng(seed)
    num_pages = slots * max_pages + 1  # page 0 reserved
    tables = (rng.permutation(num_pages - 1) + 1).reshape(slots, max_pages).astype("int32")
    q = rng.standard_normal((slots, h, r), dtype=np.float32)
    qpe = rng.standard_normal((slots, h, pe), dtype=np.float32)
    ckv = torch.as_tensor(rng.standard_normal((num_pages, ps, r), dtype=np.float32)).to(dtype)
    kpe = torch.as_tensor(rng.standard_normal((num_pages, ps, pe), dtype=np.float32)).to(dtype)
    scalars = [torch.as_tensor(tables), torch.as_tensor(np.asarray(lens, "int32"))]
    queries = [torch.as_tensor(q).to(dtype), torch.as_tensor(qpe).to(dtype)]
    if fmt is None:
        return queries + [ckv, kpe] + scalars, (ckv, kpe)
    (cq, cs_), (pq, ps_) = ref.quantize_rows(ckv, fmt), ref.quantize_rows(kpe, fmt)
    attended = (ref.dequantize_rows(cq, cs_, fmt).to(dtype),
                ref.dequantize_rows(pq, ps_, fmt).to(dtype))
    return queries + [cq, pq, cs_, ps_] + scalars, attended


def _plain(args, fmt, window):
    if fmt is None:
        return ref.mla_paged(*args, window=window)
    return ref.mla_paged_quant(*args, fmt=fmt, window=window)


def _split(args, attended, window, dtype, **kw):
    q, qpe, *_, tables, lens = args
    splits, keys = MP.split_grid(q.shape[0], q.shape[1], tables.shape[1],
                                 attended[0].shape[1], SMS)
    return MP.split_decode(q, qpe, *attended, tables, lens, splits, keys, window=window,
                           pair=dtype == torch.bfloat16, **kw)


def _error(cs, got, want):
    if got.dtype == torch.bfloat16:
        return cs.bf16_ulps(torch, got, want)
    return (got.float() - want.float()).abs().max().item()


def _limit(cs, dtype):
    return cs.BF16_ULPS if dtype == torch.bfloat16 else 1e-6


# name: (slots, heads, R, Dpe, page size, max pages, lengths): deepseek-v2-
# lite-16B's reduced model (4 heads, R 32, Dpe 8) and its serving shape (16
# heads, R 512, Dpe 64; slots 8, max_len 1024, page 16), lengths with an
# empty slot, one inside a split, a split's last key and the whole table
SHAPES = {
    "reduced": (4, 4, 32, 8, 16, 8, [77, 0, 64, 128]),
    "serving": (8, 16, 512, 64, 16, 64, [5, 300, 0, 1024, 77, 1024, 640, 999]),
}
DTYPES = [torch.float32, torch.bfloat16]
FMTS = [None, "int8", "int4"]


def test_shapes_are_deepseeks():
    cfg = get_config(ARCH)
    for shape, c in (("serving", cfg), ("reduced", cfg.reduced())):
        _, h, r, pe, *_ = SHAPES[shape]
        assert (h, r, pe) == (c.num_heads, c.mla.kv_lora_rank, c.mla.qk_rope_head_dim)


@pytest.mark.parametrize("fmt", FMTS, ids=str)
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_rehearsal_matches_plain_version(cs, shape, dtype, window, fmt):
    slots, h, r, pe, ps, mp, lens = SHAPES[shape]
    args, attended = _inputs(0, slots, h, r, pe, ps, mp, lens, dtype, fmt)
    got = _split(args, attended, window, dtype)
    plain = _plain(args, fmt, window)
    assert _error(cs, got, plain) <= _limit(cs, dtype)
    assert torch.all(got[lens.index(0)] == 0)  # an empty slot emits zeros
    if shape == "reduced" and dtype == torch.float32:  # the JAX package's XLA path
        np_args = [a.numpy() for a in args]
        if fmt is None:
            want = jops.mla_paged(*np_args, window=window, backend="xla")
        else:
            want = jops.mla_paged_quant(*np_args, fmt=fmt, window=window, backend="xla")
        live = np.asarray(lens) > 0  # the reference's XLA softmax gives NaN at len 0
        np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], rtol=0,
                                   atol=1e-6)


# lengths: empty, one key, a split's last key and the next split's first,
# one inside the second split, windows past the start, the whole table (16
# splits of 64 keys: the splits past a short length are wholly empty)
EDGE_LENS = [0, 1, 64, 65, 100, 700, 1023, 1024]


@pytest.mark.parametrize("fmt", FMTS, ids=str)
@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_split_rehearsal_edges(cs, page_size, dtype, window, fmt):
    mp = 1024 // page_size
    args, attended = _inputs(page_size, len(EDGE_LENS), 16, 512, 64, page_size, mp,
                             EDGE_LENS, dtype, fmt)
    splits, keys = MP.split_grid(len(EDGE_LENS), 16, mp, page_size, SMS)
    assert keys % page_size == 0 and keys % MP.TC_KEYS == 0 and splits * keys >= 1024
    got = _split(args, attended, window, dtype)
    assert _error(cs, got, _plain(args, fmt, window)) <= _limit(cs, dtype)
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()


@pytest.mark.parametrize("fmt", [None, "int8"], ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_merge_without_rescale_fails_the_limit(cs, dtype, fmt):
    """The control: the splits' states summed as they stand, not rescaled to
    the common max, read far beyond the limit."""
    slots, h, r, pe, ps, mp, lens = SHAPES["serving"]
    args, attended = _inputs(0, slots, h, r, pe, ps, mp, lens, dtype, fmt)
    plain = _plain(args, fmt, None)
    sound = _error(cs, _split(args, attended, None, dtype), plain)
    faulty = _error(cs, _split(args, attended, None, dtype, rescale=False), plain)
    assert sound <= _limit(cs, dtype) < faulty
    assert faulty > 100 * _limit(cs, dtype)


# (slots, heads, max pages, page size)
GRIDS = [(8, 16, 64, 16), (1, 16, 2048, 16), (64, 16, 256, 16), (8, 32, 128, 8),
         (3, 12, 7, 32), (256, 16, 64, 16), (4, 4, 8, 16)]


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_split_rule_fills_a_wave_from_static_shapes(grid):
    slots, h, mp, ps = grid
    splits, keys = MP.split_grid(slots, h, mp, ps, SMS)
    blocks = h // MP.head_block(h) * slots * splits
    tiles = -(-mp * ps // PA.SPLIT_KEYS)
    assert keys % MP.TC_KEYS == 0 and keys % ps == 0  # whole 32-key tiles and pages
    assert splits * keys >= mp * ps and (splits - 1) * keys < mp * ps  # every key, no empty split
    assert blocks >= min(SMS, h // MP.head_block(h) * slots * tiles)  # a wave, or a tile a split
    if grid == (8, 16, 64, 16):  # deepseek-v2-lite-16B's serving shape
        assert (splits, keys, blocks) == (16, 64, 128)
    assert list(inspect.signature(MP.split_grid).parameters) == [
        "slots", "heads", "max_pages", "page_size", "sms"]  # no lengths


def test_tensor_core_rule_is_one_for_the_mla_kernels():
    """The decode takes the rule of the MLA prefills: bf16 at deepseek's R
    512 + Dpe 64 on every page that nests in a 32-key tile; fp32 and the
    reduced widths take the CUDA-core body."""
    cfg = get_config(ARCH)
    r, pe = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    assert MF.tensor_core_path is MP.tensor_core_path
    for ps in (1, 8, 16, 32):
        assert MP.tensor_core_path(torch.bfloat16, r, pe, ps)
    assert not MP.tensor_core_path(torch.float32, r, pe, 16)
    red = cfg.reduced().mla
    assert not MP.tensor_core_path(torch.bfloat16, red.kv_lora_rank, red.qk_rope_head_dim, 16)


# ---------------------------------------------------------------------------
# the card path, with the kernel calls recorded
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's: it sends a
    wrapper down its kernel path."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnCard)


@pytest.fixture
def card_path(monkeypatch):
    """The two kernels' C entry points replaced by recorders, the CUDA
    stream and SM count by stand-ins, the plain versions by a failure:
    returns the recorded calls by kernel name (scratch shapes too)."""
    calls = {}
    for name, mod in (("mla_paged", MP), ("mla_paged_quant", MPQ)):
        def fn(*args, _name=name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(mod.KERNEL, "function", lambda _fn=fn: _fn)
        monkeypatch.setattr(mod.KERNEL, "launches", 0)
        monkeypatch.setattr(mod.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(MP, "sm_count", lambda index: SMS)
    empty = torch.empty
    shapes = calls.setdefault("scratch", [])

    def recording_empty(*size, **kw):
        t = empty(*size, **kw)
        shapes.append((tuple(t.shape), t.dtype))
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("mla_paged", "mla_paged_quant"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


B, H, R, PE, PS, MPAGES = 8, 16, 512, 64, 16, 64


def _card_inputs(dtype, fmt):
    num_pages = B * MPAGES + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(B, MPAGES))
    q, qpe = _card(torch.zeros(B, H, R, dtype=dtype)), _card(torch.zeros(B, H, PE, dtype=dtype))
    if fmt is None:
        pools = [_card(torch.zeros(num_pages, PS, n, dtype=dtype)) for n in (R, PE)]
    else:
        pack = ref.KV_PACK[fmt]
        pools = ([_card(torch.zeros(num_pages, PS, n // pack, dtype=torch.int8))
                  for n in (R, PE)]
                 + [_card(torch.ones(num_pages, PS, 1, dtype=dtype)) for _ in range(2)])
    return q, qpe, pools, tables, num_pages


@pytest.mark.parametrize("fmt", FMTS, ids=str)
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_card_path_hands_the_kernel_its_scratch(card_path, dtype, fmt):
    """deepseek-v2-lite-16B's serving shape: the grid's splits come from the
    shapes (16 of 64 keys), the same for any lengths; the kernel gets (slots,
    H, splits, R) and (2, slots, H, splits) fp32 scratch; bf16 takes the
    tensor cores (``tc_launches``), fp32 the CUDA cores."""
    q, qpe, pools, tables, num_pages = _card_inputs(dtype, fmt)
    mod = MP if fmt is None else MPQ
    head = 2 if fmt is None else 3  # dtype, tc (, pack)
    for lens in ([0] * B, [1024] * B, [5, 300, 0, 1024, 77, 1024, 640, 999]):
        card_path["scratch"].clear()
        lens = _card(torch.tensor(lens, dtype=torch.int32))
        if fmt is None:
            out = MP.mla_paged(q, qpe, *pools, tables, lens, window=256)
        else:
            out = MPQ.mla_paged_quant(q, qpe, *pools, tables, lens, fmt=fmt, window=256)
        call = card_path[mod.KERNEL.name][-1]
        assert out.shape == q.shape and len(call) == len(mod.KERNEL.argtypes)
        assert call[:2] == (PA.DTYPES[dtype], int(dtype == torch.bfloat16))
        assert fmt is None or call[2] == ref.KV_PACK[fmt]
        assert call[head + 9 + 2 * (fmt is not None):-2] == (
            B, H, 16, R, PE, PS, MPAGES, num_pages, 256, 16, 64)
        assert ((B, H, 16, R), torch.float32) in card_path["scratch"]
        assert ((2, B, H, 16), torch.float32) in card_path["scratch"]
    assert mod.KERNEL.launches == 3
    assert mod.KERNEL.tc_launches == (3 if dtype == torch.bfloat16 else 0)


def test_card_path_refuses_what_the_kernel_does_not_take(card_path):
    """On a CUDA tensor a shape or type the kernel does not take raises
    ValueError: no silent fallback to the plain version."""
    q, qpe, pools, tables, _ = _card_inputs(torch.bfloat16, None)
    lens = _card(torch.full((B,), 5, dtype=torch.int32))
    with pytest.raises(ValueError, match="window"):
        MP.mla_paged(q, qpe, *pools, tables, lens, window=0)
    with pytest.raises(ValueError, match="int32"):
        MP.mla_paged(q, qpe, *pools, tables, _card(torch.full((B,), 5)))
    with pytest.raises(ValueError, match="dtype"):
        MP.mla_paged(q, qpe, *[_card(p.float()) for p in pools], tables, lens)
    q8, qpe8, pools8, tables8, _ = _card_inputs(torch.bfloat16, "int8")
    with pytest.raises(ValueError, match="format"):
        MPQ.mla_paged_quant(q8, qpe8, *pools8, tables8, lens, fmt="int2")
    assert MP.KERNEL.launches == MPQ.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's int4 logits gate, rehearsed at reduced widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch,layers", [("qwen2_1_5b", 4), (ARCH, 2)])
def test_int4_logits_on_shared_codes(cs, arch, layers):
    """bf16 against fp32 on the CPU, as chip_smoke.py's phase 4 holds the
    card: over its own codes int4's reading is 2-4x the one over the bf16
    run's codes (a value one code step apart moves by a row's absmax / 7),
    and the run on shared codes passes the gate."""
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers,
                              dtype="bfloat16", kv_dtype="int4")
    own, shared = cs.teacher_forced(torch, np, lm, cfg, torch.device("cpu"),
                                    shared_codes=True)
    assert shared["err"] < own["err"] / 2
    assert cs.teacher_forced_ok(shared, argmax=False), shared


def test_replayed_codes_are_the_recorded_ones(cs):
    """``replayed_codes`` hands back each recorded quantization in order, on
    the caller's device and in its scale dtype, and refuses a run that
    quantizes fewer rows than were recorded."""
    codes = []
    x = torch.randn(3, 16).bfloat16()
    with cs.recorded_codes(ref, codes):
        first = ref.quantize_rows(x, "int4")
        ref.quantize_rows(x[:1], "int4")
    assert len(codes) == 2 and ref.quantize_rows.__name__ == "quantize_rows"
    with cs.replayed_codes(ref, codes):
        packed, scales = ref.quantize_rows(x.float() * 1.01, "int4")
        assert torch.equal(packed, first[0]) and scales.dtype == torch.float32
        assert torch.equal(scales, first[1].float())
        ref.quantize_rows(x[:1].float(), "int4")
    with pytest.raises(AssertionError, match="fewer"):
        with cs.replayed_codes(ref, codes):
            ref.quantize_rows(x.float(), "int4")
