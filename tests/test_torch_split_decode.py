"""The split-KV GQA decode and the library GEMM's routes, on the CPU.

* The split rehearsal (``paged_attention.split_decode``: partial softmax
  states over each split's 64-key tiles, then the fp32 merge that rescales
  them to their common max) equals the plain version ``ref.paged_attention``
  at qwen2-1.5B's reduced and serving shapes, and on its edges: window None
  and 256, a len-0 slot, lengths inside a split and at its ends, splits
  wholly past the length, pages of 8, 16 and 32.  Limits: 1e-6 in fp32 (the
  two differ only in exp2 against exp and the order of fp32 sums); in bf16,
  with P as the tensor-core kernel's pair hi + lo, two bf16 ulps of the
  plain value (chip_smoke.py's limit).  At the reduced shape both are also
  held against the JAX package's XLA oracle on the same numpy inputs.
* The control: a merge that sums the splits without rescaling them to the
  common max fails that limit.
* The split rule is a plain function of static shapes and the SM count: one
  wave at least (>= 132 blocks at qwen's serving shape), every key of the
  table covered, and the same grid whatever the lengths.
* The card path, with the kernel's C call replaced by a recorder (this
  machine has no card): the decode wrapper hands the kernel its fp32
  scratch and the tensor-core route for bf16 at D 128; the GEMM wrapper
  routes 16-bit operands with M >= 17 to wgmma, M <= 16 to mma.sync and the
  rest to CUDA cores, and counts the wgmma launches.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import inspect
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import matmul as MM
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import ref

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


def _inputs(seed, slots, hq, hkv, d, ps, max_pages, lens, dtype):
    rng = np.random.default_rng(seed)
    num_pages = slots * max_pages + 1  # page 0 reserved
    tables = (rng.permutation(num_pages - 1) + 1).reshape(slots, max_pages).astype("int32")
    q = rng.standard_normal((slots, hq, d), dtype=np.float32)
    kp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    vp = rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32)
    np_in = (q, kp, vp, tables, np.asarray(lens, "int32"))
    t = [torch.as_tensor(x) for x in np_in]
    return np_in, [x.to(dtype) for x in t[:3]] + t[3:]


def _split(args, window, dtype, **kw):
    q, kp, vp, tables, lens = args
    splits, keys = PA.decode_splits(q.shape[0], kp.shape[0], tables.shape[1], kp.shape[2], SMS)
    return PA.split_decode(q, kp, vp, tables, lens, splits, keys, window=window,
                           pair=dtype == torch.bfloat16, **kw)


def _error(cs, got, want):
    if got.dtype == torch.bfloat16:
        return cs.bf16_ulps(torch, got, want)
    return (got.float() - want.float()).abs().max().item()


def _limit(cs, dtype):
    return cs.BF16_ULPS if dtype == torch.bfloat16 else 1e-6


# name: (slots, Hq, Hkv, D, page size, max pages, lengths): qwen2-1.5B's reduced model
# (Hq 4, Hkv 2, D 16) and its serving shape (Hq 12, Hkv 2, D 128; slots 8,
# max_len 1024, page 16), lengths with an empty slot, one inside a split, a
# split's last key and the whole table
SHAPES = {
    "reduced": (4, 4, 2, 16, 16, 8, [77, 0, 64, 128]),
    "serving": (8, 12, 2, 128, 16, 64, [5, 300, 0, 1024, 77, 1024, 640, 999]),
}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", list(SHAPES))
def test_split_rehearsal_matches_plain_version(cs, shape, dtype, window):
    slots, hq, hkv, d, ps, mp, lens = SHAPES[shape]
    np_in, args = _inputs(0, slots, hq, hkv, d, ps, mp, lens, dtype)
    got = _split(args, window, dtype)
    plain = ref.paged_attention(*args, window=window)
    assert _error(cs, got, plain) <= _limit(cs, dtype)
    assert torch.all(got[lens.index(0)] == 0)  # an empty slot emits zeros
    if shape == "reduced" and dtype == torch.float32:  # the JAX package's oracle
        q, kp, vp, tables, ln = np_in
        want = jops.paged_attention(q, jnp.asarray(kp), jnp.asarray(vp), tables, ln,
                                    window=window, backend="xla")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)


# lengths: empty, one key, a tile's last key and the next, one inside the
# second split, windows past the start, the whole table (64 tiles of 64
# keys: the splits past a short length are wholly empty)
EDGE_LENS = [0, 1, 64, 65, 100, 700, 1023, 1024]


@pytest.mark.parametrize("window", [None, 256])
@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("page_size", [8, 16, 32])
def test_split_rehearsal_edges(cs, page_size, dtype, window):
    _, args = _inputs(page_size, len(EDGE_LENS), 12, 2, 64, page_size, 1024 // page_size,
                      EDGE_LENS, dtype)
    splits, keys = PA.decode_splits(len(EDGE_LENS), 2, 1024 // page_size, page_size, SMS)
    assert keys % page_size == 0 and splits * keys >= 1024  # whole pages, every key
    got = _split(args, window, dtype)
    assert _error(cs, got, ref.paged_attention(*args, window=window)) <= _limit(cs, dtype)
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_merge_without_rescale_fails_the_limit(cs, dtype):
    """The control: the splits' states summed as they stand, not rescaled to
    the common max, read far beyond the limit."""
    slots, hq, hkv, d, ps, mp, lens = SHAPES["serving"]
    _, args = _inputs(0, slots, hq, hkv, d, ps, mp, lens, dtype)
    plain = ref.paged_attention(*args)
    sound = _error(cs, _split(args, None, dtype), plain)
    faulty = _error(cs, _split(args, None, dtype, rescale=False), plain)
    assert sound <= _limit(cs, dtype) < faulty
    assert faulty > 100 * _limit(cs, dtype)


# (slots, kv heads, max pages, page size)
GRIDS = [(8, 2, 64, 16), (1, 1, 2048, 16), (64, 8, 256, 16), (8, 2, 128, 8), (3, 4, 7, 32),
         (256, 2, 64, 16)]


@pytest.mark.parametrize("grid", GRIDS, ids=str)
def test_split_rule_fills_a_wave_from_static_shapes(grid):
    slots, hkv, mp, ps = grid
    splits, keys = PA.decode_splits(slots, hkv, mp, ps, SMS)
    tiles = -(-mp * ps // PA.SPLIT_KEYS)
    assert keys % PA.SPLIT_KEYS == 0 and splits * keys >= mp * ps  # every key, whole tiles
    assert (splits - 1) * keys < mp * ps  # no split wholly past the table
    assert hkv * slots * splits >= min(SMS, hkv * slots * tiles)  # a wave, or a tile a split
    if grid == (8, 2, 64, 16):  # qwen2-1.5B's serving shape
        assert (splits, keys) == (16, 64) and hkv * slots * splits >= 132
    assert list(inspect.signature(PA.decode_splits).parameters) == [
        "slots", "kv_heads", "max_pages", "page_size", "sms"]  # no lengths


def test_tensor_core_rule_at_qwen_shapes():
    cfg = get_config("qwen2_1_5b")
    group = cfg.num_heads // cfg.num_kv_heads
    assert PA.tensor_core_path(torch.bfloat16, cfg.head_dim, group)
    assert PA.tensor_core_path(torch.bfloat16, 64, 64)
    assert not PA.tensor_core_path(torch.float32, cfg.head_dim, group)
    assert not PA.tensor_core_path(torch.bfloat16, 96, group)
    assert not PA.tensor_core_path(torch.bfloat16, 128, 65)


# ---------------------------------------------------------------------------
# the card path, with the kernel call recorded
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
    for name, mod in (("paged_attention", PA), ("matmul", MM)):
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
    empty = torch.empty
    shapes = calls.setdefault("scratch", [])

    def recording_empty(*size, **kw):
        t = empty(*size, **kw)
        shapes.append((tuple(t.shape), t.dtype))
        return t
    monkeypatch.setattr(torch, "empty", recording_empty)

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("paged_attention", "matmul"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_decode_card_path_hands_the_kernel_its_scratch(card_path, dtype):
    """qwen2-1.5B's serving shape: the grid's splits come from the shapes
    (16 of 64 keys), the same for any lengths; the kernel gets (slots, Hq,
    splits, D) and (2, slots, Hq, splits) fp32 scratch; bf16 takes the
    tensor cores (``tc_launches``), fp32 the CUDA cores."""
    b, hq, hkv, d, ps, mp = 8, 12, 2, 128, 16, 64
    num_pages = b * mp + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    q = _card(torch.zeros(b, hq, d, dtype=dtype))
    kp = _card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype))
    for lens in ([0] * b, [1024] * b, [5, 300, 0, 1024, 77, 1024, 640, 999]):
        card_path["scratch"].clear()
        out = PA.paged_attention(q, kp, kp, tables, _card(torch.tensor(lens, dtype=torch.int32)),
                                 window=256)
        call = card_path["paged_attention"][-1]
        assert out.shape == q.shape
        assert call[:2] == (PA.DTYPES[dtype], int(dtype == torch.bfloat16))
        assert call[10:20] == (b, hq, hkv, d, ps, mp, num_pages, 256, 16, 64)
        assert ((b, hq, 16, d), torch.float32) in card_path["scratch"]
        assert ((2, b, hq, 16), torch.float32) in card_path["scratch"]
    assert PA.KERNEL.launches == 3
    assert PA.KERNEL.tc_launches == (3 if dtype == torch.bfloat16 else 0)


# (M, N, K, dtype, route): Table 2's M5 and the ragged edges of the wgmma
# line, the GEMVs, fp32 and ragged K / N
GEMM_ROUTES = [
    (8192, 8192, 8192, torch.bfloat16, "wgmma"), (17, 8, 8, torch.float16, "wgmma"),
    (129, 264, 4104, torch.bfloat16, "wgmma"), (16, 136, 72, torch.bfloat16, "mma"),
    (1, 16384, 16384, torch.bfloat16, "mma"), (64, 64, 64, torch.float32, "cuda"),
    (4096, 100, 64, torch.bfloat16, "cuda"), (4096, 64, 57, torch.float16, "cuda"),
]


@pytest.mark.parametrize("case", GEMM_ROUTES, ids=str)
def test_gemm_card_path_routes(card_path, case):
    m, n, k, dtype, route = case
    assert MM.route(dtype, m, k, n) == route
    if m * k > 1 << 20:  # Table 2's operands: the rule alone
        return
    a, b = _card(torch.zeros((m, k), dtype=dtype)), _card(torch.zeros((k, n), dtype=dtype))
    out = MM.matmul(a, b)
    call = card_path["matmul"][-1]
    assert out.shape == (m, n) and call[5:9] == (m, n, k, MM.ROUTES[route])
    assert (MM.KERNEL.launches, MM.KERNEL.tc_launches) == (1, int(route == "wgmma"))
