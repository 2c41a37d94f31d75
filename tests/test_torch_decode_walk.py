"""The paged decode's bulk-copy walk (``csrc/decode_walk.cuh``), on the CPU:
row 1 (``paged_attention``) and its quantized twin (row 3) at head width 256
and where the route takes a group of 1.

* The routes and the split rule: ``walk_path`` takes bf16 at D 256 up to
  ``WALK_MAX_GROUP`` query heads a kv head over pages of 8 or more; fp32,
  pages under 8 and every other model's shape keep ``tensor_core_path``'s
  route; ``route`` hands the C entry point its code.  ``walk_splits`` is a
  pure function of static shapes and the SM count.  The walk's shared
  memory at its constants (stated once in Python, passed to the source as
  the build's macros) stays within the 232,448 bytes a block may take.
* A rehearsal: ``paged_attention.walk_decode`` (the warps' key shares, each
  warp's online softmax, the warps' merge, the splits' merge) within two
  bf16 ulps of ``ref.paged_attention`` / ``ref.paged_attention_quant`` at
  D 256 with groups 1 and 2 and at D 128 with a group of 1, on ragged
  lengths, a len-0 slot, lengths past a split's end and past the table, a
  window, int8 and int4; the warps' merge without its rescale, the splits'
  merge without its rescale and bf16 accumulation each fail that limit.
* The bulk-copy ring as an event model: the producer's copies and skipped
  pages, every consumer warp's wait and release; a wrong parity, a stage
  released before it was read and a skipped page left unreleased fail.
* The card path, with the C call recorded: a walk launch counts
  ``walk_launches`` and no ``tc_launches``, its grid is ``walk_splits``'; a
  shape the walk takes but cannot launch raises before any call.
* The port's plain decode and its int8 twin at D 256 with a group of 1
  against the JAX package's Pallas programs in interpret mode, fp32 at 1e-4.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import inspect
import random
import re
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import paged_attention_quant as PAQ
from repro_torch.kernels import ref
from test_torch_wgmma_d256 import MBar

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BF16, FP32 = torch.bfloat16, torch.float32
BF16_ULPS = 2.0
SMS = 132  # an H100's SMs
JAX_TOL = dict(rtol=1e-4, atol=1e-4)


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


# ---------------------------------------------------------------------------
# the routes, the split rule and the shared-memory budget
# ---------------------------------------------------------------------------

# (model, hq, hkv, d): the served models' decode heads
MODELS = [("qwen2-1.5B", 12, 2, 128), ("hymba-1.5B", 25, 5, 64),
          ("granite-moe-3b-a800m", 24, 8, 64), ("chatglm3-6b", 32, 2, 128),
          ("gemma-7b", 16, 16, 256), ("deepseek-7b", 32, 32, 128)]


@pytest.mark.parametrize("model", MODELS, ids=[m[0] for m in MODELS])
def test_route_at_each_models_decode_shape(model, cs):
    """bf16 at gemma-7b's D 256 takes the walk (code 2); deepseek-7b's group
    of 1 at D 128 the walk only where WALK_GROUP1_HEAD_DIMS holds 128; every
    other model keeps tensor_core_path's route (mma.sync, code 1); fp32 the
    CUDA cores (code 0).  chip_smoke.py's restated rule agrees."""
    name, hq, hkv, d = model
    group = hq // hkv
    walk = d == 256 or (group == 1 and d in PA.WALK_GROUP1_HEAD_DIMS)
    assert PA.walk_path(BF16, d, group, 16) == walk
    assert PA.route(BF16, d, group, 16) == (2 if walk else int(PA.tensor_core_path(BF16, d, group)))
    assert PA.route(FP32, d, group, 16) == 0
    if name not in ("gemma-7b", "deepseek-7b"):
        assert PA.route(BF16, d, group, 16) == 1
    shape = cs.DecodeShape(name, cs.SLOTS, cs.MAX_LEN, hq, hkv, d)
    assert cs.gqa_takes_walk(BF16, shape) == walk and not cs.gqa_takes_walk(FP32, shape)
    assert cs.gqa_takes_tensor_cores(BF16, shape) == (PA.route(BF16, d, group, 16) == 1)


def test_walk_rule_and_its_refusals(cs):
    for group in range(1, PA.WALK_MAX_GROUP + 1):
        for ps in (8, 16, 32):
            assert PA.walk_path(BF16, 256, group, ps)
    assert not PA.walk_path(BF16, 256, PA.WALK_MAX_GROUP + 1, 16)
    assert not PA.walk_path(FP32, 256, 1, 16)
    assert not PA.walk_path(BF16, 256, 1, 4)  # a scale column under 16 bytes
    assert not PA.walk_path(BF16, 96, 1, 16) and not PA.walk_path(BF16, 128, 2, 16)
    assert PA.ROUTES == {"cuda cores": 0, "mma.sync": 1, "walk": 2}
    assert (cs.WALK_HEAD_DIMS, cs.WALK_MAX_GROUP, cs.WALK_MIN_PAGE,
            cs.WALK_GROUP1_HEAD_DIMS) == (PA.WALK_HEAD_DIMS, PA.WALK_MAX_GROUP,
                                          PA.WALK_MIN_PAGE, PA.WALK_GROUP1_HEAD_DIMS)
    assert inspect.signature(PA.walk_path).parameters.keys() == {
        "dtype", "head_dim", "group", "page_size"}


# (slots, kv heads, max pages, page size)
WALK_GRIDS = [(8, 16, 64, 16), (8, 32, 64, 16), (1, 16, 64, 16), (8, 2, 64, 16),
              (64, 16, 2048, 16), (3, 4, 7, 32), (8, 16, 128, 8), (1, 1, 3, 32)]


@pytest.mark.parametrize("grid", WALK_GRIDS, ids=str)
def test_walk_splits_fill_the_card_from_static_shapes(grid):
    slots, hkv, mp, ps = grid
    splits, keys = PA.walk_splits(slots, hkv, mp, ps, SMS)
    assert keys % ps == 0 and ps <= keys <= max(PA.WALK_SPLIT_KEYS, ps)  # whole pages
    assert keys // ps <= PA.WALK_SPLIT_KEYS // PA.WALK_MIN_PAGE  # the table entries' place
    assert splits * keys >= mp * ps and (splits - 1) * keys < mp * ps  # every key, none past
    # halved while the grid held fewer than WALK_WAVE_BLOCKS blocks an SM, and
    # no further than one page
    assert keys == ps or slots * hkv * splits >= PA.WALK_WAVE_BLOCKS * SMS
    if keys < max(PA.WALK_SPLIT_KEYS, ps):
        assert slots * hkv * -(-mp * ps // (2 * keys)) < PA.WALK_WAVE_BLOCKS * SMS
    if grid == (8, 16, 64, 16):  # gemma-7b's serving shape: 8 splits of 128, 1024 blocks
        assert (splits, keys) == (8, 128)
    assert list(inspect.signature(PA.walk_splits).parameters) == [
        "slots", "kv_heads", "max_pages", "page_size", "sms"]  # no lengths


def test_decode_splits_stay_as_they_were():
    """The mma.sync and CUDA-core bodies and the MLA decodes keep
    decode_splits: qwen2-1.5B's 16 splits of 64 keys, deepseek-7b's one."""
    assert PA.decode_splits(8, 2, 64, 16, SMS) == (16, 64)
    assert PA.decode_splits(8, 32, 64, 16, SMS) == (1, 1024)
    assert PA.decode_splits(8, 16, 64, 16, SMS) == (2, 512)


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = ([0-9]+);", text).group(1))


def test_shared_memory_budget_at_the_walks_constants():
    """walk_smem_bytes, the wrappers' guard, is decode_walk.cuh's Layout at
    the constants the source is built with: the modules' WALK_* macros
    (the source states no value of its own and stops without them), within
    the 232,448 bytes a block may take at every shape the kernel
    instantiates: D 256 up to 4 rows a warp, D 64 / 128 at one, pages of 8
    to 32, bf16 / int8 / int4 rows."""
    text = (CSRC / "decode_walk.cuh").read_text()
    assert _constant(text, "MAX_SMEM") == PA.MAX_SMEM == 232448
    assert _constant(text, "MIN_PAGE") == PA.WALK_MIN_PAGE
    assert "#error" in text and not re.search(r"#define WALK_(STAGES|SPLIT_KEYS|WARPS|ROUND)\b",
                                              text)
    want = {"WALK_STAGES": PA.WALK_STAGES, "WALK_SPLIT_KEYS": PA.WALK_SPLIT_KEYS,
            "WALK_WARPS": PA.WALK_WARPS, "WALK_ROUND": PA.WALK_ROUND}
    assert PA.KERNEL.defines == PAQ.KERNEL.defines == want
    assert {f"-D{k}={v}" for k, v in want.items()} <= set(PA.KERNEL.flags())
    assert PAQ.KERNEL.library_path() == PA.KERNEL.library_path()  # one library
    for d, groups in ((256, (1, 2, 3, 4)), (128, (1,)), (64, (1,))):
        for group in groups:
            rows = 1 << (group - 1).bit_length()
            for ps in (8, 16, 32):
                for pack in (0, 1, 2):
                    row = 2 * d if pack == 0 else d // pack
                    stage = 2 * (ps * row + (2 * ps if pack else 0))
                    want_bytes = (PA.WALK_STAGES * stage + 16 * PA.WALK_STAGES
                                  + 4 * (PA.WALK_SPLIT_KEYS // 8) + 4 * PA.WALK_WARPS * rows * (d + 2))
                    got = PA.walk_smem_bytes(d, group, ps, pack)
                    assert got == want_bytes and got <= PA.MAX_SMEM, (d, group, ps, pack)
                    assert stage % 16 == 0  # every bulk copy's place 16-byte aligned


# ---------------------------------------------------------------------------
# the walk's arithmetic, rehearsed
# ---------------------------------------------------------------------------

def _inputs(seed, slots, hq, hkv, d, ps, mp, fmt=None):
    """numpy-seeded bf16 inputs, page 0 reserved (NaN, never in a table):
    (q, pools for the wrapper, kp / vp the pages the kernel attends, tables,
    num_pages)."""
    rng = np.random.default_rng(seed)
    num_pages = slots * mp + 1
    tables = torch.as_tensor((rng.permutation(num_pages - 1)[:slots * mp] + 1)
                             .reshape(slots, mp).astype("int32"))
    q = torch.as_tensor(rng.standard_normal((slots, hq, d), dtype=np.float32)).bfloat16()
    kf, vf = (torch.as_tensor(rng.standard_normal((hkv, num_pages, ps, d), dtype=np.float32))
              .bfloat16() for _ in range(2))
    if fmt is None:
        pools = [kf, vf]
        for t in pools:
            t[:, 0] = float("nan")
        return q, pools, kf, vf, tables, num_pages
    (kq, ks), (vq, vs) = ref.quantize_rows(kf, fmt), ref.quantize_rows(vf, fmt)
    for t in (ks, vs):
        t[:, 0] = float("nan")
    kp, vp = (ref.dequantize_rows(a, s, fmt).bfloat16() for a, s in ((kq, ks), (vq, vs)))
    return q, [kq, vq, ks, vs], kp, vp, tables, num_pages


# (label, hq, hkv, d, ps, mp, lens, window, fmt): gemma-7b's heads cut to 2
# over 2 at pages of 16 and 64 pages (its serving grid: 8 splits of 128, 4
# warps of 2 keys a round), a group of 2, a group of 1 at D 128, pages of 8
# and 32, int8 and int4; lengths empty, one key, a page's last key, one past
# a 128-key split's end, the whole table, past the table
REHEARSALS = [
    ("D 256, group 1", 2, 2, 256, 16, 64, [0, 1, 16, 129, 500, 1000, 1024, 1030], None, None),
    ("D 256, group 1, window 200", 2, 2, 256, 16, 64, [0, 1, 16, 129, 500, 1000, 1024, 1030],
     200, None),
    ("D 256, group 2, pages of 8", 4, 2, 256, 8, 32, [0, 3, 8, 129, 256, 200], 100, None),
    ("D 128, group 1", 2, 2, 128, 16, 32, [0, 7, 129, 300, 512, 333], None, None),
    ("D 256, group 1, pages of 32, int8", 2, 2, 256, 32, 16, [0, 31, 129, 512, 400], 150, "int8"),
    ("D 256, group 2, int4", 4, 2, 256, 16, 16, [0, 17, 129, 256, 60], None, "int4"),
]


def _plain(q, pools, tables, lens, window, fmt):
    if fmt is None:
        return ref.paged_attention(q, *pools, tables, lens, window=window)
    return ref.paged_attention_quant(q, *pools, tables, lens, window=window, fmt=fmt)


@pytest.mark.parametrize("case", REHEARSALS, ids=[c[0] for c in REHEARSALS])
def test_walk_rehearsal_within_two_ulps_while_its_faults_fail(case, cs):
    _, hq, hkv, d, ps, mp, lens, window, fmt = case
    q, pools, kp, vp, tables, _ = _inputs(REHEARSALS.index(case), len(lens), hq, hkv, d, ps, mp,
                                          fmt)
    lens = torch.tensor(lens, dtype=torch.int32)
    want = _plain(q, pools, tables, lens, window, fmt)
    # the grid at gemma-7b's 16 kv heads (8 splits of 128 keys at its 64
    # pages of 16): the kernel's split boundaries, with fewer heads walked
    splits, keys = PA.walk_splits(len(lens), 16, mp, ps, SMS)
    assert splits > 1
    walk = lambda **kw: PA.walk_decode(q, kp, vp, tables, lens, splits, keys,  # noqa: E731
                                       window=window, **kw)
    got = walk()
    assert torch.all(got[0] == 0) and torch.isfinite(got).all()
    assert cs.bf16_ulps(torch, got, want) <= BF16_ULPS
    for fault in ({"warp_rescale": False}, {"split_rescale": False}, {"acc_dtype": BF16}):
        assert cs.bf16_ulps(torch, walk(**fault), want) > BF16_ULPS, fault


def test_walk_rehearsal_skips_a_page_outside_the_pool(cs):
    """A table entry outside the pool on a live page: the walk leaves its
    keys out (the kernel copies nothing for it), where the plain version
    clamps it into the pool.  With slot 0's first page out, the walk equals
    the plain decode under a window that starts past that page."""
    q, pools, kp, vp, tables, num_pages = _inputs(5, 2, 2, 2, 256, 16, 16)
    lens = torch.tensor([256, 100], dtype=torch.int32)
    bad = tables.clone()
    bad[0, 0] = num_pages + 3  # slot 0's first 16 keys
    splits, keys = PA.walk_splits(2, 2, 16, 16, SMS)
    got = PA.walk_decode(q, kp, vp, bad, lens, splits, keys)
    assert torch.isfinite(got).all()
    # keys 16..255 of slot 0 are what a window of 240 leaves
    want = ref.paged_attention(q, kp, vp, tables, lens, window=240)
    assert cs.bf16_ulps(torch, got[0], want[0]) <= BF16_ULPS
    assert cs.bf16_ulps(torch, got[1], ref.paged_attention(q, kp, vp, tables, lens)[1]) <= BF16_ULPS


def _walk_dequant(codes: np.ndarray, scales: np.ndarray, bias: int) -> np.ndarray:
    """decode_walk.cuh's load_row on the CPU: the biased code (code + bias,
    a byte) in the low mantissa bits of 2^23, less 2^23 + bias, times the
    scale in fp32, rounded to bf16 by integer arithmetic (round_bf16)."""
    u = (codes.astype(np.int64) + bias).astype(np.uint32) | np.uint32(0x4B000000)
    with np.errstate(over="ignore"):  # the largest scales: inf on both sides
        x = (u.view(np.float32) - np.float32(8388608 + bias)) * scales
    b = x.view(np.uint32).astype(np.uint64)
    return ((b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000).astype(np.uint32).view(np.float32)


def test_walk_dequant_rule_bit_for_bit():
    """The walk's dequantization (no conversion unit: the code from 2^23's
    mantissa, the rounding by integer arithmetic) equals the plain
    version's ref.dequantize_rows(...).to(bfloat16) bit for bit over every
    int8 and int4 code and 4096 bf16 scales: exponents across fp32's range,
    subnormal ones, both signs."""
    text = (CSRC / "decode_walk.cuh").read_text()
    assert "(u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u" in text
    assert "__byte_perm(u, 0x4B000000u, 0x7650 + k)) - (8388608.f + BIAS)" in text
    rng = np.random.default_rng(7)
    bits = rng.integers(0, 1 << 16, size=4096).astype(np.uint16)
    bits = bits[(bits & 0x7F80) != 0x7F80][:4000]  # finite
    scales = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    for fmt, lo, hi, bias in (("int8", -128, 127, 128), ("int4", -8, 7, 8)):
        codes = torch.arange(lo, hi + 1, dtype=torch.int8)
        packed = ref.pack_int4(codes.repeat(2)[: 2 * (hi - lo + 1)]) if fmt == "int4" else codes
        vals = ref.unpack_int4(packed) if fmt == "int4" else packed
        grid_codes = vals[None, :].expand(len(scales), -1)
        want = ref.dequantize_rows(packed[None, :].expand(len(scales), -1),
                                   scales[:, None], fmt).bfloat16().float().numpy()
        got = _walk_dequant(grid_codes.numpy(), scales.float().numpy()[:, None], bias)
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


# ---------------------------------------------------------------------------
# the ring's mbarrier protocol, as an event model
# ---------------------------------------------------------------------------


def walk_producer(st, pages, stages, parity=lambda r: (r - 1) & 1):
    """decode_walk_kernel's producer: page i into stage i % stages after the
    stage's (r - 1)-th release; a page outside the pool copied by nobody,
    its full barrier arrived on without bytes."""
    for i, live in enumerate(pages):
        s, r = i % stages, i // stages
        if r > 0:
            yield ("wait", st["empty"][s], parity(r))
        if live:
            st["full"][s].expect_tx(1)
            st["inflight"].append((s, i))
        else:
            st["skipped"][s] = i
            st["full"][s].arrive()
        yield ("step",)


def walk_consumer(st, c, pages, stages, parity=lambda i, s: (i // s) & 1,
                  early_release=False, release_skipped=True):
    """A consumer warp: every stage waited for, read when its page was
    copied (the stage must hold it from the wait to the release), then
    released."""
    for i, live in enumerate(pages):
        s = i % stages
        yield ("wait", st["full"][s], parity(i, stages))
        if not live:
            assert st["skipped"][s] == i, f"warp {c} waited for page {i}, a phase off"
            if release_skipped:
                st["empty"][s].arrive()
            yield ("step",)
            continue
        assert st["stage"][s] == i, f"warp {c} waited for page {i}, read {st['stage'][s]}"
        if early_release:
            st["empty"][s].arrive()
        yield ("step",)
        assert st["stage"][s] == i, f"page {i} overwritten while warp {c} read it"
        st["read"].append((c, i))
        if not early_release:
            st["empty"][s].arrive()
        yield ("step",)


def run_walk_ring(seed, pages, stages, warps, make_producer=walk_producer, **consumer_kw):
    """One random interleaving of the producer, the consumer warps and the
    bulk copies landing.  Returns the (warp, page) reads; raises on a
    misread or a deadlock."""
    rng = random.Random(seed)
    st = {"full": [MBar(1) for _ in range(stages)], "empty": [MBar(warps) for _ in range(stages)],
          "stage": [None] * stages, "skipped": [None] * stages, "inflight": [], "read": []}
    agents = [make_producer(st, pages, stages)]
    agents += [walk_consumer(st, c, pages, stages, **consumer_kw) for c in range(warps)]
    waiting = [None] * len(agents)
    live = set(range(len(agents)))
    while live or st["inflight"]:
        ready = [i for i in live if waiting[i] is None or waiting[i][0].done(waiting[i][1])]
        choices = ready + (["copy"] if st["inflight"] else [])
        if not choices:
            raise RuntimeError("deadlock: every agent waits on a phase that never completes")
        pick = rng.choice(choices)
        if pick == "copy":
            s, i = st["inflight"].pop(rng.randrange(len(st["inflight"])))
            st["stage"][s] = i
            st["full"][s].complete_tx(1)
            continue
        waiting[pick] = None
        try:
            op = next(agents[pick])
        except StopIteration:
            live.discard(pick)
            continue
        if op[0] == "wait":
            waiting[pick] = (op[1], op[2])
    return st["read"]


# (label, pages: True where the table entry lies in the pool)
RING_CASES = [("a full split", [True] * 8), ("one page", [True]),
              ("pages outside the pool", [True, False, True, True, False, False, True, True, True]),
              ("every page outside", [False] * 5), ("a long walk", [True] * 23)]


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_walk_ring_reads_each_copied_page_once_a_warp(case):
    _, pages = case
    for seed in range(30):
        reads = run_walk_ring(seed, pages, PA.WALK_STAGES, PA.WALK_WARPS)
        want = sorted((c, i) for c in range(PA.WALK_WARPS) for i, live in enumerate(pages) if live)
        assert sorted(reads) == want


def test_walk_ring_faults_fail_the_model():
    """A consumer waiting on the wrong parity, a producer waiting for the
    wrong release, a stage released before its page was read, and a
    skipped page left unreleased: each misreads or hangs under some
    interleaving."""
    pages = [True, False, True, True, True, True, False, True, True, True]

    def fails(**kw):
        for seed in range(200):
            try:
                run_walk_ring(seed, pages, PA.WALK_STAGES, PA.WALK_WARPS, **kw)
            except (AssertionError, RuntimeError):
                return True
        return False

    assert not fails()
    assert fails(parity=lambda i, s: ((i // s) + 1) & 1)
    assert fails(make_producer=lambda st, p, s: walk_producer(st, p, s, parity=lambda r: r & 1))
    assert fails(early_release=True)
    assert fails(release_skipped=False)


# ---------------------------------------------------------------------------
# the card path, with the C call recorded
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
    """Both decodes' C entry points replaced by recorders, the CUDA stream
    and SM count by stand-ins, the plain versions by a failure: returns the
    recorded calls by kernel name."""
    calls = {}
    for mod in (PA, PAQ):
        def fn(*args, _name=mod.KERNEL.name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(mod.KERNEL, "function", lambda _fn=fn: _fn)
        for count in ("launches", "tc_launches", "walk_launches"):
            monkeypatch.setattr(mod.KERNEL, count, 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(PA, "sm_count", lambda index: SMS)

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("paged_attention", "paged_attention_quant"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


def _gemma_operands(dtype, fmt=None, b=8, hq=16, hkv=16, d=256, ps=16, mp=64):
    num_pages = b * mp + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    q = _card(torch.zeros(b, hq, d, dtype=dtype))
    if fmt is None:
        kp = _card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype))
        return q, (kp, kp), tables, num_pages
    kq = _card(torch.zeros(hkv, num_pages, ps, d // ref.KV_PACK[fmt], dtype=torch.int8))
    ks = _card(torch.zeros(hkv, num_pages, ps, 1, dtype=dtype))
    return q, (kq, kq, ks, ks), tables, num_pages


@pytest.mark.parametrize("fmt", [None, "int8", "int4"], ids=["bf16", "int8", "int4"])
def test_card_path_counts_walk_launches_at_gemmas_shape(card_path, fmt):
    """gemma-7b's serving shape: bf16 launches take route 2 on walk_splits'
    grid (8 splits of 128 keys) whatever the lengths, count walk_launches
    and no tc_launches; fp32 takes the CUDA cores on decode_splits' grid
    (2 of 512)."""
    mod = PA if fmt is None else PAQ
    kernel = PA.paged_attention if fmt is None else PAQ.paged_attention_quant
    kw = {} if fmt is None else {"fmt": fmt}
    for dtype, route, grid in ((BF16, 2, (8, 128)), (FP32, 0, (2, 512))):
        q, pools, tables, num_pages = _gemma_operands(dtype, fmt)
        for lens in ([0] * 8, [1024] * 8, [5, 300, 0, 1024, 77, 1024, 640, 999]):
            out = kernel(q, *pools, tables, _card(torch.tensor(lens, dtype=torch.int32)),
                         window=256, **kw)
            call = card_path[mod.KERNEL.name][-1]
            assert out.shape == q.shape and call[1] == route  # the route code
            assert call[-4:-2] == grid and call[-5] == 256
    assert (mod.KERNEL.launches, mod.KERNEL.tc_launches, mod.KERNEL.walk_launches) == (6, 0, 3)


def test_card_path_keeps_qwens_route(card_path):
    """qwen2-1.5B's serving shape keeps mma.sync (route 1, tc_launches) on
    decode_splits' 16 splits of 64 keys."""
    q, pools, tables, _ = _gemma_operands(BF16, b=8, hq=12, hkv=2, d=128)
    PA.paged_attention(q, *pools, tables, _card(torch.full((8,), 700, dtype=torch.int32)))
    call = card_path["paged_attention"][-1]
    assert call[1] == 1 and call[-4:-2] == (16, 64)
    assert (PA.KERNEL.launches, PA.KERNEL.tc_launches, PA.KERNEL.walk_launches) == (1, 1, 0)


def test_a_shape_the_walk_cannot_launch_raises_before_any_call(card_path, monkeypatch):
    """Scale pools off a 16-byte boundary (the walk copies a page's scale
    column whole), and a shared-memory budget past the block's (at a larger
    ring): ValueError, no call, no count; a launch the kernel refuses:
    RuntimeError, no count."""
    q, (kq, _, ks, _), tables, num_pages = _gemma_operands(BF16, "int8")
    lens = _card(torch.full((8,), 100, dtype=torch.int32))
    flat = torch.zeros(ks.numel() + 1, dtype=BF16)
    odd = _card(flat[1:].view(ks.shape))  # contiguous, 2 bytes off
    with pytest.raises(ValueError, match="16-byte aligned"):
        PAQ.paged_attention_quant(q, kq, kq, odd, odd, tables, lens, fmt="int8")
    monkeypatch.setattr(PA, "WALK_STAGES", 32)
    with pytest.raises(ValueError, match="shared memory"):
        PAQ.paged_attention_quant(q, kq, kq, ks, ks, tables, lens, fmt="int8")
    q, pools, tables, _ = _gemma_operands(BF16)
    with pytest.raises(ValueError, match="shared memory"):
        PA.paged_attention(q, *pools, tables, lens)
    assert card_path == {}
    monkeypatch.setattr(PA, "WALK_STAGES", 4)
    monkeypatch.setattr(PA.KERNEL, "function", lambda: (lambda *a: 1))
    with pytest.raises(RuntimeError, match="launch failed"):
        PA.paged_attention(q, *pools, tables, lens)
    assert (PA.KERNEL.launches, PA.KERNEL.walk_launches, PAQ.KERNEL.launches) == (0, 0, 0)


# ---------------------------------------------------------------------------
# the plain decodes at D 256 against the JAX package's Pallas programs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", [None, "int8"], ids=["fp", "int8"])
def test_plain_decode_at_256_matches_the_pallas_program(fmt):
    """fp32 at D 256 and a group of 1 (gemma-7b's heads, cut to 2): the
    port's decode on CPU tensors (its plain version) against the JAX
    package's paged_attention / paged_attention_quant on the Pallas path
    (interpret mode on the CPU), with a window and a len-0 slot."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    b, hq, hkv, d, ps, mp, num_pages = 3, 2, 2, 256, 16, 4, 14
    rng = np.random.default_rng(30)
    tables = (1 + rng.permutation(num_pages - 1)[:b * mp]).reshape(b, mp).astype("int32")
    lens = np.array([50, 0, 64], "int32")
    q = rng.standard_normal((b, hq, d)).astype("float32")
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    for window in (None, 40):
        if fmt is None:
            kp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
            vp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
            got = PA.paged_attention(t(q), t(kp), t(vp), t(tables), t(lens), window=window)
            want = jops.paged_attention(q, jnp.asarray(kp), jnp.asarray(vp), tables, lens,
                                        window=window, backend="pallas")
        else:
            (kq, ks), (vq, vs) = (ref.quantize_rows(torch.as_tensor(
                rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")), fmt)
                for _ in range(2))
            got = PAQ.paged_attention_quant(t(q), kq, vq, ks, vs, t(tables), t(lens), fmt=fmt,
                                            window=window)
            want = jops.paged_attention_quant(q, *(a.numpy() for a in (kq, vq, ks, vs)), tables,
                                              lens, fmt=fmt, window=window, backend="pallas")
        assert np.all(got[1].numpy() == 0.0)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)
    assert PA.KERNEL.launches == PAQ.KERNEL.launches == 0
