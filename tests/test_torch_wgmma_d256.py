"""Head width 256 on Hopper's warpgroup tensor cores, on the CPU: the bf16
flash forward at (Dk, Dv) = (256, 256) (``flash_attention_kernel_wg``) and
the chunked prefill at D 256 (``prefill_attention_kernel_wg``), both over
``csrc/hopper_attention.cuh``.

* The routes: flash (256, 256) in bf16 goes to the wgmma path; fp32 and
  every other pair keep theirs.  The prefill takes wgmma at gemma-7b's
  serving shape (a chunk of 64 positions x a group of 1 over pages of 16)
  and keeps the CUDA-core body where its rule refuses; the quantized twin
  keeps the CUDA-core body at D 256, as does a chunk below 64 positions
  (a query tile is one TMA box at one head).  Each rule's shared-memory
  budget is the kernel's, at tile constants stated once in Python that
  reach the sources as the build's macros.
* The card path (a CUDA tensor), with the C call recorded
  (``test_torch_tensor_cores.card_path``): each D 256 bf16 launch counts one
  ``tc_launches``, a refused launch raises, no launch reaches the plain
  version.
* Plain-PyTorch rehearsals of both walks: 64-row consumer tiles, 32-key
  tiles, P as the bf16 pair hi + lo, causal skips and the masked diagonal
  tiles, ragged Sq / Sk / lens, Sq > Sk rows emitting zeros; the prefill's
  alternate tiles per consumer and their final merge.  At D 256 they lie
  within 2 bf16 ulps of ``ref.attention`` and ``ref.paged_prefill_attention``;
  P rounded once, a skipped rescale and a merge without its rescale fail.
  The prefill's walk reads q through the kernel's TMA box coordinates, so
  a chunk the rule refuses shows the misread.
* The port's plain flash and prefill at D 256 against the JAX package's
  Pallas programs in interpret mode (1e-4 in fp32), the pools equal on
  live rows.
* The ring's full / empty mbarrier protocol as a CPU event model: every
  stage loaded only after its release, every consumer reading the tile it
  waited for, no wait left hanging; a wrong parity or a tile released
  before it landed fails.
* chip_smoke.py's phase 15 (gemma-7b training) rehearsed at reduced widths.

The kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import dataclasses
import random
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import prefill_attention as PF
from repro_torch.kernels import prefill_attention_quant as PFQ
from repro_torch.kernels import ref
from test_torch_tensor_cores import _card, card_path  # noqa: F401  (the recorder fixture)

ROOT = Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc"
BF16_ULPS = 2.0


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
# the ring's mbarrier protocol, as an event model
# ---------------------------------------------------------------------------


class MBar:
    """An mbarrier: ``count`` arrivals plus the expected transaction bytes
    complete a phase; ``done(parity)`` is try_wait.parity's answer (the
    phase of that parity has completed: the current phase's parity
    differs)."""

    def __init__(self, count):
        self.count, self.pending, self.tx, self.phase = count, count, 0, 0

    def _complete(self):
        if self.pending == 0 and self.tx == 0:
            self.phase += 1
            self.pending = self.count

    def arrive(self):
        self.pending -= 1
        assert self.pending >= 0, "an arrival past the phase's count"
        self._complete()

    def expect_tx(self, n):
        self.tx += n
        self.arrive()

    def complete_tx(self, n):
        self.tx -= n
        self._complete()

    def done(self, parity):
        return (self.phase & 1) != parity


def producer(st, n, stages, parity=lambda r: (r - 1) & 1):
    """The producer's loop (flash_attention_kernel_wg,
    prefill_attention_kernel_wg): tile u into stage u % stages after the
    stage's (r - 1)-th release."""
    for u in range(n):
        s, r = u % stages, u // stages
        if r > 0:
            yield ("wait", st["empty"][s], parity(r))
        st["full"][s].expect_tx(1)
        st["inflight"].append((s, u))
        yield ("step",)


def consumer(st, c, walk, passed, stages, parity=lambda t, s: (t // s) & 1,
             wait_to_pass=True):
    """A consumer: tiles ``walk`` read (the stage must hold the tile from
    its wait to its release), then tiles ``passed`` landed and released."""
    for t in walk:
        s = t % stages
        yield ("wait", st["full"][s], parity(t, stages))
        assert st["stage"][s] == t, f"consumer {c} waited for tile {t}, read {st['stage'][s]}"
        yield ("step",)
        assert st["stage"][s] == t, f"tile {t} overwritten while consumer {c} read it"
        st["read"].append((c, t))
        st["empty"][s].arrive()
        yield ("step",)
    for t in passed:
        s = t % stages
        if wait_to_pass:
            yield ("wait", st["full"][s], parity(t, stages))
        st["empty"][s].arrive()
        yield ("step",)


def run_ring(seed, n, stages, readers, walks, make_producer=producer, **consumer_kw):
    """One random interleaving of the producer, the consumers (``walks``: a
    (walk, passed) pair each) and the TMA copies landing.  Returns the
    (consumer, tile) reads; raises on a misread or a deadlock."""
    rng = random.Random(seed)
    st = {"full": [MBar(1) for _ in range(stages)],
          "empty": [MBar(readers) for _ in range(stages)],
          "stage": [None] * stages, "inflight": [], "read": []}
    agents = [make_producer(st, n, stages)]
    agents += [consumer(st, c, w, p, stages, **consumer_kw) for c, (w, p) in enumerate(walks)]
    waiting = [None] * len(agents)
    live = set(range(len(agents)))
    while live or st["inflight"]:
        ready = [i for i in live if waiting[i] is None or waiting[i][0].done(waiting[i][1])]
        choices = ready + (["tma"] if st["inflight"] else [])
        if not choices:
            raise RuntimeError("deadlock: every agent waits on a phase that never completes")
        pick = rng.choice(choices)
        if pick == "tma":
            s, u = st["inflight"].pop(rng.randrange(len(st["inflight"])))
            st["stage"][s] = u
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


def flash_walks(n0, n1, n):
    """The flash kernel's consumers: each walks its own tiles, then passes
    the block's later ones."""
    return [(range(n0), range(n0, n)), (range(n1), range(n1, n))]


def prefill_walks(n, split):
    """The prefill's consumers: alternate tiles at 64 rows (each stage read
    by one), every tile at 128."""
    if split:
        return [(range(0, n, 2), ()), (range(1, n, 2), ())]
    return [(range(n), ()), (range(n), ())]


RING_CASES = [  # (label, tiles, stages, readers, walks): each kernel's stages
    ("flash, causal diagonal block", 16, FA.WG_STAGES, 2, flash_walks(15, 16, 16)),
    ("flash, first consumer done early", 9, FA.WG_STAGES, 2, flash_walks(2, 9, 9)),
    ("flash, second consumer without rows", 5, FA.WG_STAGES, 2, flash_walks(5, 0, 5)),
    ("flash, non-causal", 7, FA.WG_STAGES, 2, flash_walks(7, 7, 7)),
    ("prefill, 64 rows: alternate tiles", 31, PF.WG_STAGES, 1, prefill_walks(31, True)),
    ("prefill, 64 rows, one tile", 1, PF.WG_STAGES, 1, prefill_walks(1, True)),
    ("prefill, 128 rows", 10, PF.WG_STAGES, 2, prefill_walks(10, False)),
]


@pytest.mark.parametrize("case", RING_CASES, ids=[c[0] for c in RING_CASES])
def test_ring_protocol_loads_after_release_and_reads_what_it_waited_for(case):
    _, n, stages, readers, walks = case
    for seed in range(40):
        reads = run_ring(seed, n, stages, readers, walks)
        want = sorted((c, t) for c, (w, _) in enumerate(walks) for t in w)
        assert sorted(reads) == want


def test_alternate_tiles_need_an_even_number_of_stages():
    """The prefill's 64-row split at 3 stages: a stage's rounds alternate
    between the consumers, and one waiting two phases ahead passes on the
    wrong parity, which the model shows as a misread or a hang (on the card
    the 3-stage copy faulted); prefill_attention.cu asserts an even count."""
    text = (CSRC / "prefill_attention.cu").read_text()
    assert "static_assert(WG_STAGES % 2 == 0" in text
    failed = 0
    for seed in range(200):
        try:
            run_ring(seed, 31, 3, 1, prefill_walks(31, True))
        except (AssertionError, RuntimeError):
            failed += 1
    assert failed > 0
    for seed in range(40):  # 2 stages: each keeps one reader
        run_ring(seed, 31, 2, 1, prefill_walks(31, True))


def test_ring_protocol_faults_fail_the_model():
    """A consumer waiting on the wrong parity, a producer waiting for the
    wrong release, and a consumer releasing a tile it passes before the
    tile landed: each hangs or misreads under some interleaving."""
    walks = flash_walks(2, 9, 9)

    def fails(**kw):
        for seed in range(200):
            try:
                run_ring(seed, 9, FA.WG_STAGES, 2, walks, **kw)
            except (AssertionError, RuntimeError):
                return True
        return False

    assert fails(parity=lambda t, s: ((t // s) + 1) & 1)
    assert fails(make_producer=lambda st, n, s: producer(st, n, s, parity=lambda r: r & 1))
    assert fails(wait_to_pass=False)


# ---------------------------------------------------------------------------
# the routes and their shared-memory budgets
# ---------------------------------------------------------------------------

BF16, FP32 = torch.bfloat16, torch.float32


def test_flash_route_takes_wgmma_at_256_in_bf16_only():
    assert FA.WGMMA_PAIRS == ((256, 256),) and (256, 256) not in FA.MMA_PAIRS
    assert FA.tensor_core_path(BF16, 256) and FA.tensor_core_path(BF16, 256, 256)
    assert not FA.tensor_core_path(FP32, 256, 256)
    for dk, dv in FA.MMA_PAIRS:  # mma.sync keeps its pairs
        assert FA.tensor_core_path(BF16, dk, dv) and not FA.tensor_core_path(FP32, dk, dv)
    for dk, dv in ((256, 128), (128, 256), (192, 256), (320, 320), (96, 96)):
        assert not FA.tensor_core_path(BF16, dk, dv)
    FA.check_widths(BF16, 256, 256)
    FA.check_widths(FP32, 256, 256)  # the CUDA-core body keeps fp32 at D 256


def test_prefill_route_at_gemmas_serving_shape_and_its_edges(cs):
    sh, mp = cs.GEMMA_DECODE, cs.MAX_LEN // cs.PAGE
    group = sh.hq // sh.hkv
    assert (group, sh.d) == (1, 256)
    assert PF.tensor_core_path(BF16, sh.d, cs.PAGE, group, mp, cs.CHUNK)
    assert PF.head_split(True, group, cs.PAGE, sh.d) == 1
    assert PF.tensor_core_path(BF16, 256, 16, 2, mp, 64)  # 128 rows: a tile a consumer
    assert PF.tensor_core_path(BF16, 256, 8, 1, mp, 128)
    assert PF.tensor_core_path(BF16, 256, 32, 1, mp, 64)  # a page a key tile
    assert not PF.tensor_core_path(FP32, 256, 16, 1, mp, 64)
    for ps, group, chunk in ((16, 1, 32), (16, 4, 64), (16, 1, 256), (4, 1, 64), (12, 1, 48)):
        assert not PF.tensor_core_path(BF16, 256, ps, group, mp, chunk), (ps, group, chunk)
    # C x G of 64 or 128 over a chunk below 64 positions (hq 8 over hkv 4 at
    # chunk 32 first): a 64-row TMA box of q at one head would bring zeros
    # past C, not the next head's rows, so these stay on the CUDA cores
    for ps, group, chunk in ((16, 2, 32), (16, 4, 32), (8, 8, 16), (8, 16, 8)):
        assert chunk * group in PF.WG_BLOCK_ROWS
        assert not PF.tensor_core_path(BF16, 256, ps, group, mp, chunk), (ps, group, chunk)
    # the table row beside the ring: the most entries a block takes
    for q_tiles, chunk in ((1, 64), (2, 128)):
        most = (FA.MAX_SMEM - FA.wgmma_smem_bytes(q_tiles, PF.WG_KEYS, PF.WG_STAGES)) // 4
        assert PF.tensor_core_path(BF16, 256, 16, 1, most, chunk)
        assert not PF.tensor_core_path(BF16, 256, 16, 1, most + 1, chunk)
    # mma.sync's rule is unchanged, whatever the chunk
    for chunk in (7, 32, 64):
        assert PF.tensor_core_path(BF16, 128, 16, 6, mp, chunk) == PF.mma_fits(16, mp)
    # the quantized twin keeps its CUDA-core body at D 256, and mma.sync's rule
    assert not PFQ.tensor_core_path(BF16, 256, cs.PAGE, group, mp)
    assert PFQ.tensor_core_path(BF16, 128, cs.PAGE, 6, mp)


def _constant(text, name):
    return int(re.search(rf"constexpr int {name} = ([0-9]+);", text).group(1))


def test_shared_memory_budgets_are_the_kernels_constants():
    """flash_attention.wgmma_smem_bytes, behind both routes, is
    ha::Layout::bytes at the tile constants each source instantiates: the
    module's WG_KEYS and WG_STAGES, which reach the source as the build's
    macros (the source states no value of its own)."""
    core = (CSRC / "hopper_attention.cuh").read_text()
    d, rows, box = (_constant(core, n) for n in ("D", "ROWS", "BOX"))
    bars = _constant(core, "BARS")
    assert (d, rows, FA.MAX_SMEM) == (FA.WG_D, FA.WG_ROWS, _constant(core, "MAX_SMEM"))
    for src, mod in (("flash_attention.cu", FA), ("prefill_attention.cu", PF)):
        text = (CSRC / src).read_text()
        keys, stages = mod.WG_KEYS, mod.WG_STAGES
        assert mod.KERNEL.defines == {"WG_KEYS": keys, "WG_STAGES": stages}, src
        assert {f"-DWG_KEYS={keys}", f"-DWG_STAGES={stages}"} <= set(mod.KERNEL.flags())
        assert not re.search(r"(constexpr int|#define) WG_(KEYS|STAGES)\b", text), src
        assert "#error" in text, src  # a build without the macros fails
        k_box = keys * box * 2
        for q_tiles in (1, 2):
            for extra in (0, 256, 4 * 16384):
                want = (q_tiles * rows * d * 2 + stages * 2 * (d // box) * k_box + bars + extra
                        + 1024)
                assert FA.wgmma_smem_bytes(q_tiles, keys, stages, extra) == want
        # the merge's O (64 x 256 fp32 over 128 threads) and row state fit the ring
        assert stages * 2 * (d // box) * k_box >= 128 * (128 + 4) * 4
    # the flash block: two query tiles
    assert FA.wgmma_smem_bytes(2, FA.WG_KEYS, FA.WG_STAGES) <= FA.MAX_SMEM
    # the quantized twin shares the prefill's source, so its macros: one library
    assert PFQ.KERNEL.defines == PF.KERNEL.defines
    assert PFQ.KERNEL.library_path() == PF.KERNEL.library_path()


# ---------------------------------------------------------------------------
# the card path, with the C call recorded
# ---------------------------------------------------------------------------


def test_flash_card_path_counts_wgmma_launches(card_path):
    b, s, hq, hkv = 2, 96, 4, 2
    for dtype in (BF16, FP32):
        q = _card(torch.randn(b, s, hq, 256).to(dtype)).transpose(1, 2)
        k = _card(torch.randn(b, s, hkv, 256).to(dtype)).transpose(1, 2)
        v = _card(torch.randn(b, s, hkv, 256).to(dtype)).transpose(1, 2)
        out = FA.flash_attention(q, k, v, causal=True)
        call = card_path["flash_attention"][-1]
        assert out.shape == q.shape and out.stride() == q.stride()
        assert call[6:18] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *out.stride()[:3])
        assert call[18:26] == (b, hq, hkv, s, s, 256, 1, 256)
        assert call[:2] == ((1, 1) if dtype == BF16 else (0, 0))
    assert (FA.KERNEL.launches, FA.KERNEL.tc_launches) == (2, 1)


def test_prefill_card_path_counts_wgmma_launches(card_path, cs):
    b, c, hq, hkv, d, ps, mp = 2, 64, 4, 4, 256, 16, 8
    num_pages = b * mp + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    starts = _card(torch.tensor([0, 32], dtype=torch.int32))
    lens = _card(torch.tensor([64, 20], dtype=torch.int32))
    for dtype in (BF16, FP32):
        q = _card(torch.randn(b, c, hq, d).to(dtype)).transpose(1, 2)
        kn = _card(torch.randn(b, hkv, c, d).to(dtype))
        vn = _card(torch.randn(b, hkv, c, d).to(dtype))
        kp = _card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype))
        vp = _card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype))
        out, k_pages, v_pages = PF.prefill_attention(q, kn, vn, kp, vp, tables, starts, lens)
        call = card_path["prefill_attention"][-1]
        assert k_pages is kp and v_pages is vp and out.shape == q.shape
        assert call[17:23] == (b, hkv, 1, c, d, ps) and call[-1] == 1  # one block a kv head
        if dtype == BF16:
            assert call[:3] == (1, 1, q.data_ptr()) and out.stride() == q.stride()
            assert call[11:17] == (*q.stride()[:3], *out.stride()[:3])
        else:
            assert call[:2] == (0, 0)
    assert (PF.KERNEL.launches, PF.KERNEL.tc_launches) == (2, 1)


def test_a_refused_launch_raises(card_path, monkeypatch):
    for mod in (FA, PF):
        monkeypatch.setattr(mod.KERNEL, "function", lambda: (lambda *a: 1))
    q = _card(torch.randn(1, 2, 64, 256).bfloat16())
    with pytest.raises(RuntimeError, match="launch failed"):
        FA.flash_attention(q, q, q, causal=True)
    kp = _card(torch.zeros(2, 9, 16, 256).bfloat16())
    with pytest.raises(RuntimeError, match="launch failed"):
        PF.prefill_attention(q, q, q, kp, kp.clone(),
                             _card(torch.arange(1, 5, dtype=torch.int32).reshape(1, 4)),
                             _card(torch.zeros(1, dtype=torch.int32)),
                             _card(torch.full((1,), 64, dtype=torch.int32)))
    assert FA.KERNEL.tc_launches == PF.KERNEL.tc_launches == 0


# ---------------------------------------------------------------------------
# plain rehearsals of the two walks
# ---------------------------------------------------------------------------

LOG2E = 1.4426950408889634
NEG_CLAMP = -2.0 ** 20
ROWS = FA.WG_ROWS


class Walk:
    """One consumer warpgroup's state over its 64 rows, as the kernel keeps
    it: O, the running max and sum, fp32."""

    def __init__(self, dv, mode="pair", rescale=True):
        self.o = torch.zeros(ROWS, dv)
        self.m = torch.full((ROWS,), -float("inf"))
        self.l = torch.zeros(ROWS)
        self.mode, self.rescale = mode, rescale

    def tile(self, q, kt, vt, live, qscale):
        s = torch.where(live, (q @ kt.T) * qscale, -float("inf"))
        m_cur = torch.maximum(self.m, s.amax(1))
        mc = m_cur.clamp(min=NEG_CLAMP)
        a = torch.exp2(self.m.clamp(min=NEG_CLAMP) - mc)
        p = torch.exp2(s - mc[:, None])
        self.l = self.l * a + p.sum(1)
        self.m = m_cur
        hi = p.bfloat16().float()
        pv = hi @ vt if self.mode == "once" else hi @ vt + (p - hi).bfloat16().float() @ vt
        self.o = (self.o * a[:, None] if self.rescale else self.o) + pv

    def merge(self, other, rescale=True):
        mc = torch.maximum(self.m, other.m).clamp(min=NEG_CLAMP)
        a = torch.exp2(self.m.clamp(min=NEG_CLAMP) - mc)
        b = torch.exp2(other.m.clamp(min=NEG_CLAMP) - mc)
        if not rescale:
            a = b = torch.ones_like(a)
        self.o = self.o * a[:, None] + other.o * b[:, None]
        self.l = self.l * a + other.l * b
        self.m = torch.maximum(self.m, other.m)

    def out(self):
        return self.o / self.l.clamp(min=1e-30)[:, None]


def _tile_rows(x, lo, n):
    """Rows [lo, lo + n) of x (rows, D) with rows past its end as zeros:
    what a TMA box brings."""
    out = torch.zeros(n, x.shape[1])
    hi = min(lo + n, x.shape[0])
    if hi > lo:
        out[:hi - lo] = x[lo:hi]
    return out


def flash_walk(q, k, v, causal, mode="pair", rescale=True):
    """flash_attention_kernel_wg in plain PyTorch: blocks of 128 query rows,
    a 64-row tile a consumer, tiles of FA.WG_KEYS keys to each consumer's
    last live row's diagonal, only the tiles crossing it or the keys' end
    masked."""
    KEYS = FA.WG_KEYS
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    group, off, qscale = hq // hkv, sk - sq, d ** -0.5 * LOG2E
    n_all = -(-sk // KEYS)
    out = torch.zeros(b, hq, sq, dv)
    for bi in range(b):
        for h in range(hq):
            qf, kf, vf = q[bi, h].float(), k[bi, h // group].float(), v[bi, h // group].float()
            for q_lo in range(0, sq, 2 * ROWS):
                nq = min(2 * ROWS, sq - q_lo)
                for c in range(2):
                    live_rows, q0 = min(ROWS, nq - c * ROWS), q_lo + c * ROWS
                    if live_rows <= 0:
                        continue
                    last = q0 + live_rows - 1 + off
                    nc = n_all if not causal else (0 if last < 0 else min(n_all, last // KEYS + 1))
                    w = Walk(dv, mode, rescale)
                    qt = _tile_rows(qf, q0, ROWS)
                    r = torch.arange(ROWS)[:, None]
                    for t in range(nc):
                        k0 = t * KEYS
                        kj = k0 + torch.arange(KEYS)[None, :]
                        masked = k0 + KEYS - 1 >= sk or (causal and k0 + KEYS - 1 > q0 + off)
                        live = (kj < sk) & (~torch.tensor(causal) | (kj <= q0 + r + off))
                        if not masked:
                            live = torch.ones_like(live)
                        w.tile(qt, _tile_rows(kf, k0, KEYS), _tile_rows(vf, k0, KEYS), live,
                               qscale)
                    out[bi, h, q0:q0 + live_rows] = w.out()[:live_rows]
    return out.to(q.dtype)


def prefill_walk(q, k_new, v_new, k_pages, v_pages, tables, starts, lens, window=None,
                 mode="pair", rescale=True, merge_rescale=True):
    """prefill_attention_kernel_wg's attention in plain PyTorch: a block a
    (slot, kv head) holding the chunk's C x G rows head-major, each 64-row
    query tile i read as the kernel's TMA box brings it (64 rows of head
    h G + 64 i / C from position 64 i % C, zeros past C); prior tiles
    of PF.WG_KEYS keys gathered page by page through the table (a dead page
    read from the sink page 0 and masked), then the chunk's own tiles; at 64
    rows the two consumers take alternate tiles and merge, at 128 each takes
    its 64 rows over every tile."""
    KEYS = PF.WG_KEYS
    b, hq, chunk, d = q.shape
    hkv, _, ps, _ = k_pages.shape
    max_pages, group = tables.shape[1], hq // hkv
    rows, qscale, per = chunk * group, d ** -0.5 * LOG2E, KEYS // ps
    out = torch.zeros(b, hq, chunk, d)
    for s in range(b):
        start, ln = int(starts[s]), int(lens[s])
        p_hi = min(-(-start // ps), max_pages)
        p_lo = max(0, start - window + 1) // ps if window else 0
        n_prior = -(-max(0, p_hi - p_lo) * ps // KEYS)
        n = n_prior + -(-ln // KEYS)
        for h in range(hkv):
            qt = [_tile_rows(q[s, h * group + i * ROWS // chunk].float(), i * ROWS % chunk, ROWS)
                  for i in range(rows // ROWS)]

            def tile(t, r0):
                r = r0 + torch.arange(ROWS)[:, None]
                i = r % chunk
                j = torch.arange(KEYS)[None, :]
                if t < n_prior:
                    kt, vt, live = [], [], []
                    for p in range(per):
                        slot = p_lo + t * per + p
                        page = int(tables[s, slot]) if slot < p_hi else -1
                        ok = 0 <= page < k_pages.shape[1]
                        kt.append(k_pages[h, page if ok else 0].float())
                        vt.append(v_pages[h, page if ok else 0].float())
                        pos = slot * ps + torch.arange(ps)[None, :]
                        lv = (pos < start) & ok & (slot < p_hi)
                        if window:
                            lv = lv & (start + i - pos < window)
                        live.append(lv.expand(ROWS, ps))
                    return torch.cat(kt), torch.cat(vt), torch.cat(live, 1)
                k0 = (t - n_prior) * KEYS
                kj = k0 + j
                live = (kj <= i) & (kj < ln)
                if window:
                    live = live & (i - kj < window)
                kt = _tile_rows(k_new[s, h].float(), k0, KEYS)
                return kt, _tile_rows(v_new[s, h].float(), k0, KEYS), live

            walks = []
            for c in range(2):
                r0 = 0 if rows == ROWS else c * ROWS
                w = Walk(d, mode, rescale)
                for t in (range(c, n, 2) if rows == ROWS else range(n)):
                    kt, vt, live = tile(t, r0)
                    w.tile(qt[r0 // ROWS], kt, vt, live, qscale)
                walks.append((r0, w))
            if rows == ROWS:
                walks[0][1].merge(walks[1][1], merge_rescale)
                walks = walks[:1]
            for r0, w in walks:
                o = w.out()
                for r in range(ROWS):
                    out[s, h * group + (r0 + r) // chunk, (r0 + r) % chunk] = o[r]
    return out.to(q.dtype)


def _bf16(rng, *shape):
    return torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32).bfloat16()


FLASH_WALKS = [  # (b, hq, hkv, sq, sk, causal)
    (1, 2, 1, 200, 230, True),  # ragged Sq and Sk, two blocks, a diagonal tile masked
    (1, 2, 2, 200, 170, True),  # Sq > Sk: the first 30 rows see no key
    (1, 1, 1, 70, 90, False),  # non-causal, a partial second consumer tile
]


@pytest.mark.parametrize("case", FLASH_WALKS, ids=[str(c) for c in FLASH_WALKS])
def test_flash_walk_rehearsal_within_two_ulps_while_its_faults_fail(case, cs):
    b, hq, hkv, sq, sk, causal = case
    rng = np.random.default_rng(sum(case))
    q, k, v = _bf16(rng, b, hq, sq, 256), _bf16(rng, b, hkv, sk, 256), _bf16(rng, b, hkv, sk, 256)
    want = ref.attention(q, k, v, causal=causal)
    got = flash_walk(q, k, v, causal)
    dead = max(0, sq - sk) if causal else 0
    assert torch.all(got[:, :, :dead] == 0)
    live = (slice(None), slice(None), slice(dead, None))
    assert cs.bf16_ulps(torch, got[live], want[live]) <= BF16_ULPS
    assert cs.bf16_ulps(torch, flash_walk(q, k, v, causal, mode="once")[live],
                        want[live]) > BF16_ULPS
    assert cs.bf16_ulps(torch, flash_walk(q, k, v, causal, rescale=False)[live],
                        want[live]) > BF16_ULPS


def _prefill_inputs(rng, slots, hq, hkv, chunk, ps, max_pages):
    """Distinct live pages a slot (page 0 the sink), page-aligned starts, a
    full chunk, a partial one, an idle slot and a one-token chunk; slot 0's
    second table entry lies outside the pool (a page the kernel skips)."""
    num_pages = slots * max_pages + 1
    tables = torch.as_tensor(1 + rng.permutation(num_pages - 1)[:slots * max_pages]
                             .reshape(slots, max_pages), dtype=torch.int32)
    tables[0, 1] = num_pages
    starts = torch.as_tensor([3 * ps, 0, 6 * ps, 2 * ps][:slots], dtype=torch.int32)
    lens = torch.as_tensor([chunk, 37, 0, 1][:slots], dtype=torch.int32)
    return (_bf16(rng, slots, hq, chunk, 256), _bf16(rng, slots, hkv, chunk, 256),
            _bf16(rng, slots, hkv, chunk, 256), _bf16(rng, hkv, num_pages, ps, 256),
            _bf16(rng, hkv, num_pages, ps, 256), tables, starts, lens)


def _prefill_plain(q, kn, vn, kp, vp, tables, starts, lens, window):
    """``ref.prefill_attention`` over the gathered pages with a table entry
    outside the pool dead, the kernels' rule (``ref.paged_prefill_attention``
    clamps it into the pool instead)."""
    b, _, chunk, d = q.shape
    hkv, num_pages, ps, _ = kp.shape
    ok = (tables >= 0) & (tables < num_pages)
    ids = torch.where(ok, tables, 0).long()
    kg, vg = (p[:, ids].transpose(0, 1).reshape(b, hkv, -1, d) for p in (kp, vp))
    si = torch.arange(kg.shape[2])
    ctx_pos = torch.where((si[None] < starts[:, None]) & ok.repeat_interleave(ps, 1), si, -1)
    q_pos = starts[:, None] + torch.arange(chunk)
    return ref.prefill_attention(q, kn, vn, kg, vg, ctx_pos.int(), q_pos.int(), lens,
                                 window=window)


PREFILL_WALKS = [  # (hq, hkv, chunk, ps, window)
    (2, 2, 64, 16, None),  # gemma's group of 1: 64 rows, alternate tiles and a merge
    (4, 2, 64, 16, None),  # 128 rows: a head a consumer
    (2, 2, 64, 8, 40),  # pages of 8, a window
    (2, 2, 128, 32, None),  # 128 rows of one head: the second tile from position 64
]


@pytest.mark.parametrize("case", PREFILL_WALKS, ids=[str(c) for c in PREFILL_WALKS])
def test_prefill_walk_rehearsal_within_two_ulps_while_its_faults_fail(case, cs):
    hq, hkv, chunk, ps, window = case
    rng = np.random.default_rng(hq + ps)
    inputs = _prefill_inputs(rng, 4, hq, hkv, chunk, ps, 10)
    q, kn, vn, kp, vp, tables, starts, lens = inputs
    want = _prefill_plain(*inputs, window)
    live = tables.clone()
    live[0, 1] = 0
    if window is None:  # where every entry is live the rule is the plain version's
        ctx0 = starts.clone()
        ctx0[0] = 0  # slot 0 then reads no page: its dead entry plays no part
        a = _prefill_plain(q, kn, vn, kp, vp, live, ctx0, lens, None)
        b = ref.paged_prefill_attention(q, kn, vn, kp.clone(), vp.clone(), live, ctx0, lens)[0]
        assert torch.equal(a, b)
    got = prefill_walk(*inputs, window)
    assert cs.bf16_ulps(torch, got, want) <= BF16_ULPS
    assert cs.bf16_ulps(torch, prefill_walk(*inputs, window, mode="once"), want) > BF16_ULPS
    assert cs.bf16_ulps(torch, prefill_walk(*inputs, window, rescale=False), want) > BF16_ULPS
    if chunk * hq // hkv == ROWS:
        assert cs.bf16_ulps(torch, prefill_walk(*inputs, window, merge_rescale=False),
                            want) > BF16_ULPS


def test_prefill_walk_below_a_64_position_chunk_misreads_q(cs):
    """Why the wgmma rule wants C a multiple of 64: at hq 8 over hkv 4 and
    a chunk of 32, a block's 64 rows span two heads, and the kernel's one
    64-row box of q at one head brings the second head's rows as zeros.
    The walk reading q through those box coordinates is then far off the
    plain version on every second head; the rule keeps the shape on the
    CUDA cores."""
    hq, hkv, chunk, ps = 8, 4, 32, 16
    assert chunk * hq // hkv == ROWS
    assert not PF.tensor_core_path(BF16, 256, ps, hq // hkv, 10, chunk)
    inputs = _prefill_inputs(np.random.default_rng(9), 4, hq, hkv, chunk, ps, 10)
    inputs[7][1] = 17  # a partial chunk within the 32 positions
    want = _prefill_plain(*inputs, None)
    got = prefill_walk(*inputs)
    assert cs.bf16_ulps(torch, got[:, 0::2], want[:, 0::2]) <= BF16_ULPS
    assert cs.bf16_ulps(torch, got[:, 1::2], want[:, 1::2]) > BF16_ULPS


# ---------------------------------------------------------------------------
# the port's plain versions at D 256 against the JAX package's Pallas programs
# ---------------------------------------------------------------------------

JAX_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("causal", (True, False))
def test_plain_flash_at_256_matches_the_pallas_program(causal):
    """fp32, the JAX package's flash program in interpret mode (as its
    tests run it) against ``flash_attention`` on CPU tensors (the plain
    version): GQA, the queries a suffix of the keys."""
    from repro.core import Schedule
    from repro.core import compile as tl_compile
    from repro.kernels.flash_attention import flash_attention_program

    kw = dict(batch=1, heads=2, kv_heads=1, seq_q=32, seq_kv=64, head_dim=256, causal=causal,
              block_M=16, block_N=32)
    kern = tl_compile(flash_attention_program(**kw), Schedule(interpret=True))
    rng = np.random.default_rng(5)
    q = rng.standard_normal((1, 2, 32, 256), dtype=np.float32)
    k = rng.standard_normal((1, 1, 64, 256), dtype=np.float32)
    v = rng.standard_normal((1, 1, 64, 256), dtype=np.float32)
    got = FA.flash_attention(*(torch.as_tensor(a) for a in (q, k, v)), causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(kern(q, k, v)), **JAX_TOL)
    assert FA.KERNEL.launches == 0


def test_plain_prefill_at_256_matches_the_pallas_program():
    """fp32, the JAX package's chunked prefill on its Pallas path (interpret
    mode on the CPU) against ``prefill_attention`` on CPU tensors: outputs,
    and the pools on every live position."""
    import jax.numpy as jnp

    from repro.kernels import ops as jops

    b, hq, hkv, chunk, ps, mp, num_pages = 2, 2, 2, 32, 16, 4, 10
    rng = np.random.default_rng(6)
    tables = (1 + rng.permutation(num_pages - 1)[:b * mp]).reshape(b, mp).astype("int32")
    starts = np.array([2 * ps, 0], "int32")
    lens = np.array([chunk, 21], "int32")
    q = rng.standard_normal((b, hq, chunk, 256)).astype("float32")
    kn = rng.standard_normal((b, hkv, chunk, 256)).astype("float32")
    vn = rng.standard_normal((b, hkv, chunk, 256)).astype("float32")
    kp = rng.standard_normal((hkv, num_pages, ps, 256)).astype("float32")
    vp = rng.standard_normal((hkv, num_pages, ps, 256)).astype("float32")
    jout, jk, jv = jops.prefill_attention(q, kn, vn, jnp.asarray(kp), jnp.asarray(vp), tables,
                                          starts, lens, backend="pallas")
    t = lambda a: torch.as_tensor(np.asarray(a))  # noqa: E731
    out, tk, tv = PF.prefill_attention(t(q), t(kn), t(vn), t(kp), t(vp), t(tables), t(starts),
                                       t(lens))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **JAX_TOL)
    for s in range(b):
        for c in range(int(lens[s])):
            pos = int(starts[s]) + c
            pg, of = tables[s, pos // ps], pos % ps
            for pool, jpool in ((tk, jk), (tv, jv)):
                np.testing.assert_array_equal(pool[:, pg, of].numpy(), np.asarray(jpool)[:, pg, of])
    assert PF.KERNEL.launches == 0


# ---------------------------------------------------------------------------
# chip_smoke.py's phase 15, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_gemma_training_phase_rehearses_on_the_cpu(cs):
    """Phase 15 at reduced width with gemma's head structure (4 heads of
    256 over 4, GeGLU, tied) in bf16, with CPU tensors: 8 training steps
    and 2 profiled at batch 2 x seq 64 (the loss falling, no kernel
    launched here), then the depth-2 check with each planted attention
    fault failing the attention cosine."""
    from repro_torch.configs import get_config
    from repro_torch.models import lm

    full = get_config(cs.GEMMA_ARCH)
    assert (full.num_heads, full.num_kv_heads, full.head_dim, full.num_layers) == (16, 16, 256, 28)
    assert cs.GEMMA_TRAIN_LAYERS == 2 and cs.TRAIN_FLASH == ("flash_attention",)
    cfg = dataclasses.replace(full.reduced(), num_heads=4, num_kv_heads=4, head_dim=256,
                              dtype="bfloat16")
    cpu = torch.device("cpu")
    assert cs.gemma_training_phase(torch, np, lm, cpu, full=cfg, batch=2, seq=64) == {
        "flash_attention": 0}
    r = cs.train_card_vs_cpu(torch, np, lm, dataclasses.replace(cfg, num_layers=2), cpu)
    assert cs.train_card_vs_cpu_ok(r), r
    for fault in cs.TRAIN_FAULTS:
        assert "attn grad cosine" in cs.train_limits_failed(r, f"fault: {fault}"), (fault, r)


def test_the_ablation_tools_edits_match_the_sources():
    """tools/d256_wgmma_ablation.py builds each variant as a kernel of its
    own whose tile macros alone differ from the module's: the same source,
    entry and signature, a library of its own, and the prefill never given
    an odd number of stages."""
    from repro_torch.kernels import build

    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import d256_wgmma_ablation as abl
    finally:
        sys.path.remove(str(ROOT / "tools"))
    stock = {"flash_attention": FA.KERNEL, "prefill_attention": PF.KERNEL}
    per_label = abl.variants(build, stock)
    want = {f"{keys} x {stages}" for shapes in abl.VARIANTS.values() for keys, stages in shapes}
    assert set(per_label) == want
    for label, per in per_label.items():
        keys, stages = map(int, label.split(" x "))
        for name, k in per.items():
            s = stock[name]
            assert (k.source, k.entry, k.argtypes) == (s.source, s.entry, s.argtypes)
            assert k.defines == {**s.defines, "WG_KEYS": keys, "WG_STAGES": stages}
            assert k.library_path() != s.library_path()
            assert name != "prefill_attention" or stages % 2 == 0
