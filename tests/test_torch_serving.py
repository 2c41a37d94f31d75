"""The port's serving layer held against the JAX package: the dispatch guard,
the page allocator and prefix index replayed op for op, the chunk planner,
and the engine on one workload at one ``ServeConfig``.

Scheduling is deterministic host logic, so tick counts must be equal
exactly.  Greedy outputs must be equal wherever the reference's top-2 logit
margin clears MARGIN: random-init reduced models have flat logits, and the
two frameworks sum fp32 in different orders (ROADMAP ground rule 3).
Within the port, chunked vs replay prefill and prefix cache on vs off are
byte-for-byte invariants, as in the reference's own tests.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.configs import get_config as jget_config
from repro.core.errors import GuardError as JGuardError
from repro.kernels.ops import guard_dispatch as jguard
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import paged_cache as jpc
from repro.serving import plan_prefill_chunks as jplan
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.errors import GuardError
from repro_torch.kernels.ops import guard_dispatch
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine, paged_cache as tpc
from repro_torch.serving import plan_prefill_chunks

MARGIN = 1e-3  # logit top-2 margin below which a greedy flip is a tie


# ---------------------------------------------------------------------------
# host-side pieces, replayed op for op
# ---------------------------------------------------------------------------


def test_guard_dispatch_matches_reference():
    rng = np.random.default_rng(0)
    for trial in range(200):
        rows, mp, ps, num_pages = 3, 4, 4, 14
        tables = rng.integers(-1, num_pages + 1, size=(rows, mp))
        if trial % 3 == 0:
            tables = rng.permutation(num_pages - 1)[: rows * mp].reshape(rows, mp) + 1
        work = []
        for r in range(rows):
            if rng.random() < 0.8:
                beg = int(rng.integers(0, mp * ps + 2))
                n = int(rng.integers(1, 6))
                work.append((r, beg + n, beg, beg + n))
        outcome = []
        for fn, err in ((jguard, JGuardError), (guard_dispatch, GuardError)):
            try:
                fn(tables, num_pages, ps, work)
                outcome.append(None)
            except err as e:
                outcome.append(e.violations)
        assert outcome[0] == outcome[1], (tables, work)


def _pool_state(pool, tables, prefix):
    return (pool.free, pool.in_use, pool.peak_in_use, pool.total_allocs,
            dict(pool._ref), tables.tables().tolist(),
            [tables.blocks(s) for s in range(tables.slots)],
            prefix.pages, prefix.hits, prefix.evictions, prefix.insertions)


def test_block_pool_slot_tables_prefix_cache_replay_matches_reference():
    rng = np.random.default_rng(1)
    vocab, ps, slots, mp = 3, 2, 3, 6
    sides = []
    for mod in (jpc, tpc):
        pool = mod.BlockPool(10, ps, base=1)
        sides.append((pool, mod.SlotTables(pool, slots, mp),
                      mod.PrefixCache(pool, salt=("m", ps)), mod.PoolExhausted))
    for _ in range(600):
        op = rng.choice(["grow", "attach", "insert", "cow", "release", "trim",
                         "evict"])
        s = int(rng.integers(0, slots))
        toks = rng.integers(0, vocab, size=int(rng.integers(0, 9))).tolist()
        n = int(rng.integers(0, mp * ps + 1))
        pick = int(rng.integers(0, 1 << 20))  # page index for "cow", count for "evict"
        results = []
        for pool, tables, prefix, exhausted in sides:
            try:
                if op == "grow":
                    r = tables.ensure_capacity(s, n)
                elif op == "attach":
                    pages = prefix.match(toks, mp - tables.num_blocks(s))
                    r = tables.attach(s, pages)
                elif op == "insert":
                    k = min(len(toks) // ps, tables.num_blocks(s))
                    r = prefix.insert(toks[: k * ps], tables.blocks(s)[:k])
                    for idx, cached in r:
                        tables.repoint(s, idx, cached)
                elif op == "cow":
                    r = (tables.ensure_writable(s, pick % tables.num_blocks(s))
                         if tables.num_blocks(s) else None)
                elif op == "release":
                    r = tables.release_slot(s)
                elif op == "trim":
                    r = tables.trim(s, n)
                else:
                    r = prefix.evict(pick % 4)
            except (exhausted, ValueError) as e:
                r = type(e).__name__
            results.append((r, _pool_state(pool, tables, prefix)))
        assert results[0] == results[1], op


def test_plan_prefill_chunks_matches_reference():
    rng = np.random.default_rng(2)
    for _ in range(300):
        pending = [(s, int(rng.integers(0, 50)), int(rng.integers(0, 40)))
                   for s in range(int(rng.integers(0, 6)))]
        args = (int(rng.integers(1, 80)), int(rng.integers(0, 8)), pending,
                int(rng.integers(1, 33)))
        assert plan_prefill_chunks(*args) == jplan(*args)


# ---------------------------------------------------------------------------
# the engine against the reference engine
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_config("qwen2_1_5b").reduced()
    cfg_t = get_config("qwen2_1_5b").reduced()
    pj = jlm.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, pj, cfg_t, pt


def _workload(seed=0):
    """A shared 8-token prefix on three prompts (attach at admission) plus
    two unrelated prompts; with 6 blocks of 4 tokens the pool preempts."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=8).tolist()
    return ([shared + rng.integers(0, 256, size=t).tolist() for t in (5, 2, 9)]
            + [rng.integers(0, 256, size=n).tolist() for n in (11, 6)])


SCFG = dict(slots=3, max_len=32, max_new_tokens=5, page_size=4,
            prefill_chunk=8, num_blocks=6)


def _run(engine_cls, scfg_cls, cfg, params, prompts, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**{**SCFG, **kw}), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return eng, reqs


def _assert_greedy_equal(cfg_j, pj, prompt, ours, theirs):
    """Equal greedy tokens up to the first position where the reference's
    own top-2 margin is a tie; past a legitimate flip the streams differ."""
    for i, (a, b) in enumerate(zip(ours, theirs)):
        if a == b:
            continue
        seq = jnp.asarray([prompt + theirs[:i]], jnp.int32)
        logits = np.asarray(jlm.forward(pj, cfg_j, seq)[0][0, -1])
        top2 = np.sort(logits)[-2:]
        assert top2[1] - top2[0] < MARGIN, (i, a, b, top2)
        return
    assert len(ours) == len(theirs)


@pytest.mark.parametrize("prefill", ["chunked", "replay"])
def test_engine_matches_reference_engine(model, prefill):
    cfg_j, pj, cfg_t, pt = model
    prompts = _workload()
    ours, rq = _run(ServingEngine, ServeConfig, cfg_t, pt, prompts, prefill=prefill)
    theirs, rj = _run(JServingEngine, JServeConfig, cfg_j, pj, prompts,
                      prefill=prefill)
    assert ours.steps_run == theirs.steps_run
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert [r.preemptions for r in rq] == [r.preemptions for r in rj]
    assert ours.preemptions == theirs.preemptions > 0
    assert ours.pages_shared == theirs.pages_shared > 0
    assert ours.pool.peak_in_use == theirs.pool.peak_in_use
    assert ours.pool.in_use == theirs.pool.in_use
    for p, a, b in zip(prompts, rq, rj):
        _assert_greedy_equal(cfg_j, pj, p, a.output, b.output)


def test_chunked_matches_replay_and_prefix_cache_is_invisible(model):
    """Byte-for-byte within the port: chunked vs replay prefill, prefix
    cache on vs off."""
    _, _, cfg, params = model
    prompts = _workload()
    base, _ = _run(ServingEngine, ServeConfig, cfg, params, prompts)
    outs = [r.output for r in base.completed]
    for kw in ({"prefill": "replay"}, {"prefix_cache": False},
               {"prefill": "replay", "prefix_cache": False}):
        eng, _ = _run(ServingEngine, ServeConfig, cfg, params, prompts, **kw)
        by_uid = {r.uid: r.output for r in eng.completed}
        assert [by_uid[r.uid] for r in base.completed] == outs, kw
    assert base.pages_shared > 0


def test_copy_on_write_of_a_shared_page(model):
    """A write into a genuinely shared page copies it first (fresh page,
    device copy, repoint), with outputs byte-identical to an unshared run
    (tests/test_serving.py:910)."""
    _, _, cfg, params = model
    prompt = list(range(3, 9))
    ref, (r0,) = _run(ServingEngine, ServeConfig, cfg, params, [prompt],
                      slots=1, num_blocks=None)
    eng = ServingEngine(cfg, params, ServeConfig(
        slots=2, max_len=32, max_new_tokens=5, page_size=4, prefill_chunk=8,
        prefix_cache=False), device="cpu")
    r1, r2 = eng.submit(prompt), eng.submit(prompt)
    eng._admit()
    eng.tables.repoint(1, 0, eng.tables.blocks(0)[0])
    eng._tables_dirty = True
    eng.run()
    assert eng.pages_copied == 1
    assert r1.output == r0.output and r2.output == r0.output
    assert eng.pool.in_use == 0
