"""The port's serving fault tolerance, held against the JAX package on the
CPU: the classes of tests/test_chaos.py (request lifecycle, fault injection,
the invariant auditor, the dispatch guard under table corruption, the
seeded chaos schedules, snapshot / restore, faults inside the speculative
window) on the reduced qwen2, its weights the reference's
``lm.init(cfg, PRNGKey(0))`` through ``convert.py``.

Each engine case runs the port's engine and the reference's on the same
prompts, configuration and fault schedule, and holds the port to the
reference's statuses, outputs, error texts and counters (poisoned rows,
preemptions, guard failures, table corruptions, audits, ticks, dispatches,
window and speculation counts, the faults fired), besides the contract
itself: output-preserving faults leave every stream equal to the fault-free
run, the others fail exactly the hit request, and no page leaks.  The
snapshot's nodes equal the reference's and its page contents
(``lm.gather_pages``) equal them at 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving import AuditError as JAuditError
from repro.serving import Fault as JFault
from repro.serving import FaultInjector as JFaultInjector
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import audit_engine as jaudit_engine
from repro.serving import faults as jfaults
from repro.serving import random_schedule as jrandom_schedule
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serving import (AuditError, Fault, FaultInjector, ServeConfig,
                                 ServingEngine, audit_engine, faults,
                                 random_schedule)
from repro_torch.serving.engine import (CANCELLED, COMPLETED, FAILED, QUEUED,
                                        REJECTED, TERMINAL, TIMED_OUT)

COUNTERS = ("poisoned_rows", "preemptions", "guard_failures", "table_corruptions",
            "audits_run", "steps_run", "dispatches", "decode_windows",
            "window_fallbacks", "spec_windows", "spec_rounds", "spec_proposed",
            "spec_accepted", "spec_all_rejected", "spec_fallbacks", "pages_shared")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced-model engine runs are small ops: one intra-op thread, as the
    other model test modules; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODEL = []


def _model():
    """(reference config, port config, reference params, port params)."""
    if not _MODEL:
        jcfg = jconfigs.get_config("qwen2_1_5b").reduced()
        cfg = tconfigs.get_config("qwen2_1_5b").reduced()
        tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
        _MODEL.extend([jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                       params_from_numpy(tree, cfg, device="cpu")])
    return _MODEL


def _engine(reference, schedule=None, **kw):
    jcfg, cfg, jparams, params = _model()
    if reference:
        inj = None if schedule is None else JFaultInjector(
            [JFault(f.site, tick=f.tick, slot=f.slot) for f in schedule])
        return JServingEngine(jcfg, jparams, JServeConfig(**kw), injector=inj)
    inj = None if schedule is None else FaultInjector(
        [Fault(f.site, tick=f.tick, slot=f.slot) for f in schedule])
    return ServingEngine(cfg, params, ServeConfig(**kw), injector=inj, device="cpu")


def _run(reference, prompts, schedule=None, submit_kw=None, **kw):
    eng = _engine(reference, schedule, **kw)
    submit_kw = submit_kw or [{}] * len(prompts)
    reqs = [eng.submit(p, **k) for p, k in zip(prompts, submit_kw)]
    eng.run()
    return reqs, eng


def _both(prompts, schedule=None, submit_kw=None, **kw):
    """The port's run and the reference's on the same inputs, held equal:
    statuses, outputs, errors, counters, faults fired.  Returns the port's."""
    reqs, eng = _run(False, prompts, schedule, submit_kw, **kw)
    jreqs, jeng = _run(True, prompts, schedule, submit_kw, **kw)
    _same(reqs, eng, jreqs, jeng)
    return reqs, eng


def _same(reqs, eng, jreqs, jeng):
    assert [r.status for r in reqs] == [r.status for r in jreqs]
    assert [r.output for r in reqs] == [r.output for r in jreqs]
    assert [r.error for r in reqs] == [r.error for r in jreqs]
    assert [r.preemptions for r in reqs] == [r.preemptions for r in jreqs]
    for name in COUNTERS:
        assert getattr(eng, name) == getattr(jeng, name), name
    if eng.injector is not None:
        assert eng.injector.fired == jeng.injector.fired


def _prompts(sizes=(6, 3, 9, 2), seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in sizes]


def _shared_prompts(seed=0, tails=(3, 5, 2, 6)):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=8).tolist()
    return [shared + rng.integers(0, 256, size=n).tolist() for n in tails]


def _leftover(eng):
    """Pages still allocated beyond what the prefix index holds."""
    held = eng.prefix.pages if eng.prefix is not None else 0
    return eng.pool.in_use - held


# ---------------------------------------------------------------------------
# Request lifecycle: terminal statuses and the freed-page guarantee
# ---------------------------------------------------------------------------

LIFE = dict(slots=1, max_len=48, max_new_tokens=6, page_size=4, audit=True)
LIFECYCLE = {
    # (sizes, submit_kw, ServeConfig overrides, the statuses)
    "cancel_queued": ((6, 5, 4), [{}, {}, {"cancel": True}], {},
                      [COMPLETED, COMPLETED, CANCELLED]),
    "deadline_in_queue": ((6, 6), [{}, {"deadline_ticks": 2}], {},
                          [COMPLETED, TIMED_OUT]),
    "deadline_mid_generation": ((4,), [{"deadline_ticks": 4}],
                                {"max_new_tokens": 20}, [TIMED_OUT]),
    "reject_never_fits": ((4, 64), [{}, {}], {"max_len": 16, "max_new_tokens": 2},
                          [COMPLETED, REJECTED]),
}


@pytest.mark.parametrize("case", list(LIFECYCLE))
def test_lifecycle_statuses_match_the_reference(case):
    """tests/test_chaos.py TestLifecycle: cancel, deadlines (queued and
    mid-generation, partial output kept) and fail-fast rejection, under
    the auditor, with the reference's statuses, outputs and errors."""
    sizes, submit, over, want = LIFECYCLE[case]
    prompts = _prompts(sizes)
    out = []
    for reference in (False, True):
        eng = _engine(reference, **{**LIFE, **over})
        reqs = [eng.submit(p, **{k: v for k, v in kw.items() if k != "cancel"})
                for p, kw in zip(prompts, submit)]
        for r, kw in zip(reqs, submit):
            if kw.get("cancel"):
                r.cancel()
        eng.run()
        assert [r.status for r in reqs] == want and _leftover(eng) == 0
        out.append((reqs, eng))
    _same(*out[0], *out[1])


def test_cancel_running_keeps_partial_output_and_is_noop_after_terminal():
    prompt = _prompts((6,))[0]
    outs = []
    for reference in (False, True):
        eng = _engine(reference, **LIFE)
        req = eng.submit(prompt)
        while not req.output:  # step until mid-generation
            eng.step()
        req.cancel()
        eng.run()
        assert req.status == CANCELLED and "cancel" in req.error
        assert 0 < len(req.output) < LIFE["max_new_tokens"] and _leftover(eng) == 0
        done = eng.submit(prompt)
        eng.run()
        done.cancel()
        assert done.status == COMPLETED  # not flipped to CANCELLED
        outs.append((req.output, done.output, eng.audits_run, eng.steps_run))
    assert outs[0] == outs[1]


@pytest.mark.parametrize("case", ["max_retries", "retry_backoff"])
def test_preemption_budget_and_backoff_match_the_reference(case):
    """Two shared-prefix requests in a pool too small for both: the victim
    past ``max_retries`` FAILs; with ``retry_backoff`` both complete with
    their solo streams (recompute resume is exact)."""
    head = _prompts((4,), seed=5)[0]
    prompts = [head + p for p in _prompts((4, 4), seed=6)]
    solo = [_run(False, [p], slots=1, max_len=16, max_new_tokens=6,
                 page_size=4)[0][0].output for p in prompts]
    kw = dict(slots=2, max_len=16, max_new_tokens=6, page_size=4, num_blocks=5,
              audit=True)
    if case == "max_retries":
        reqs, eng = _both(prompts, submit_kw=[{}, {"max_retries": 0}], **kw)
        assert reqs[1].status == FAILED and "max_retries" in reqs[1].error
        assert reqs[0].output == solo[0]
    else:
        reqs, eng = _both(prompts, retry_backoff=2, **kw)
        assert eng.preemptions >= 1 and [r.output for r in reqs] == solo
        assert getattr(reqs[1], "_not_before", 0) > 0
    assert _leftover(eng) == 0


def test_drain_finishes_residents_and_keeps_the_queue():
    prompts = _prompts((6, 5, 4))
    runs = []
    for reference in (False, True):
        eng = _engine(reference, **LIFE)
        reqs = [eng.submit(p) for p in prompts]
        eng.step()  # reqs[0] holds the single slot
        eng.drain()
        assert reqs[0].status == COMPLETED
        assert [r.status for r in reqs[1:]] == [QUEUED, QUEUED]
        assert not eng.admission_open and len(eng.queue) == 2
        eng.admission_open = True  # reopen: queued work resumes
        eng.run()
        assert all(r.status == COMPLETED for r in reqs)
        runs.append((reqs, eng))
    _same(*runs[0], *runs[1])


def test_shutdown_frees_every_page():
    prompts = _prompts()
    runs = []
    for reference in (False, True):
        eng = _engine(reference, **LIFE)
        reqs = [eng.submit(p) for p in prompts]
        eng.step()
        eng.shutdown()
        assert all(r.done and r.status in TERMINAL for r in reqs)
        assert sum(r.status == CANCELLED for r in reqs) >= 1
        assert eng.pool.in_use == 0 and eng.prefix.pages == 0
        runs.append((reqs, eng))
    _same(*runs[0], *runs[1])


# ---------------------------------------------------------------------------
# Fault injection at the allocation / dispatch sites
# ---------------------------------------------------------------------------

def test_injector_contract_matches_the_reference():
    """Sites are validated; a fault fires once, at or after its tick on the
    bound clock; ``random_schedule`` draws the reference's schedule."""
    with pytest.raises(ValueError, match="unknown fault site"):
        Fault("cosmic_ray")
    assert faults.SITES == jfaults.SITES
    inj = FaultInjector([Fault("pool_alloc", tick=3)], clock=lambda: 5)
    assert inj.pending("pool_alloc") and inj.remaining == 1
    f = inj.fire("pool_alloc")
    assert f is not None and f.fired_at == 5 and inj.fire("pool_alloc") is None
    assert inj.fired == {"pool_alloc": 1, "grant": 0, "poison": 0,
                         "table_corrupt": 0, "spec_poison": 0}
    now = [0]
    inj = FaultInjector([Fault("grant", tick=4)], clock=lambda: now[0])
    assert inj.fire("grant") is None
    now[0] = 4
    assert inj.fire("grant") is not None and inj.remaining == 0
    for seed in (1, 2, 3):
        kw = dict(n_faults=7, max_tick=20, sites=("pool_alloc", "grant", "poison"))
        assert ([dataclasses.astuple(f) for f in random_schedule(seed, **kw)]
                == [dataclasses.astuple(f) for f in jrandom_schedule(seed, **kw)])


INJECT = dict(slots=2, max_len=48, max_new_tokens=5, page_size=4, audit=True)
INJECTION = {
    # (schedule, ServeConfig overrides, output-preserving)
    "pool_alloc": ([Fault("pool_alloc", tick=t) for t in (0, 2, 4)], {}, True),
    "grant": ([Fault("grant", tick=2)], {"sync_every": 4}, True),
    "poison": ([Fault("poison", tick=3, slot=0)], {}, False),
    "poison_inside_window": ([Fault("poison", tick=3, slot=1)], {"sync_every": 8}, False),
}


@pytest.mark.parametrize("case", list(INJECTION))
def test_fault_injection_matches_the_reference(case):
    """tests/test_chaos.py TestFaultInjection: pool and grant faults keep
    every stream (the grant's fallback counted); a poisoned row FAILs
    exactly its request, also when a window would have covered the tick
    (a pending poison closes the windows); the reference's counters."""
    schedule, over, preserving = INJECTION[case]
    prompts = _prompts()
    clean, _ = _run(False, prompts, **{**INJECT, **over})
    reqs, eng = _both(prompts, schedule, **{**INJECT, **over})
    assert sum(eng.injector.fired.values()) == len(schedule)
    if preserving:
        assert all(r.status == COMPLETED for r in reqs)
        assert [r.output for r in reqs] == [r.output for r in clean]
        assert case != "grant" or eng.window_fallbacks >= 1
    else:
        failed = [r for r in reqs if r.status == FAILED]
        assert eng.poisoned_rows == 1 and len(failed) == 1
        assert "poisoned" in failed[0].error
        assert all(r.output == c.output for r, c in zip(reqs, clean)
                   if r.status == COMPLETED)
    assert _leftover(eng) == 0


# ---------------------------------------------------------------------------
# Invariant auditor
# ---------------------------------------------------------------------------

AUDIT = dict(slots=2, max_len=32, max_new_tokens=4, page_size=4)


def test_clean_run_audits_every_tick():
    prompts = _prompts()
    reqs, eng = _both(prompts, audit=True, **AUDIT)
    assert eng.audits_run >= eng.dispatches > 0


def _orphan(eng):
    eng.pool.alloc(owner="leak")  # allocated, referenced by nobody


def _freed_table_page(eng):
    eng.pool.release([eng.tables.blocks(0)[0]])  # the table -> a freed page


def _terminal_in_slot(eng):
    eng.slot_req[0].done = True  # bypassed _terminate: the slot still held


@pytest.mark.parametrize("plant,match", [(_orphan, "referenced by no"),
                                         (_freed_table_page, "refcount"),
                                         (_terminal_in_slot, "terminal request")])
def test_planted_ledger_faults_raise_the_references_audit_error(plant, match):
    """The three planted ledger faults of TestAuditor: each engine's books
    are sane after a step, then the planted fault raises AuditError with
    the reference's message."""
    prompt = _prompts((6,))[0]
    msgs = []
    for reference, audit, error in ((False, audit_engine, AuditError),
                                    (True, jaudit_engine, JAuditError)):
        eng = _engine(reference, **AUDIT)
        eng.submit(prompt)
        eng.step()  # slot 0 live and holding blocks
        audit(eng)
        plant(eng)
        with pytest.raises(error, match=match) as e:
            audit(eng)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


# ---------------------------------------------------------------------------
# Dispatch guard: every corruption flavor rejected before any launch
# ---------------------------------------------------------------------------

GUARD = dict(slots=2, max_len=48, max_new_tokens=6, page_size=4, num_blocks=14,
             sync_every=4)
CORRUPTION = {
    "clean_guards_off": ([], {"guards": False}),
    "one_corruption": ([Fault("table_corrupt", tick=3)], {}),
    # ticks spaced wider than sync_every: each fault lands on its own dispatch
    "every_flavor": ([Fault("table_corrupt", tick=t, slot=t) for t in (2, 7, 12)], {}),
}


@pytest.mark.parametrize("case", list(CORRUPTION))
def test_table_corruption_fails_only_the_hit_request(case):
    """tests/test_chaos.py TestGuardedDispatch: with no corruption the guard
    changes no token; a corrupted entry (out-of-pool id, reserved page 0,
    another row's page, cycling) FAILs exactly the request it hit with the
    reference's guard text, the rest as fault-free; shutdown leaves the
    pool empty."""
    schedule, over = CORRUPTION[case]
    prompts = _shared_prompts()
    clean, clean_eng = _run(False, prompts, **GUARD)
    reqs, eng = _both(prompts, schedule or None, audit=True, **{**GUARD, **over})
    assert eng.table_corruptions == len(schedule)
    assert eng.guard_failures >= len(schedule) and clean_eng.guard_failures == 0
    failed = [r for r in reqs if r.status == FAILED]
    assert all("dispatch guard" in r.error for r in failed)
    assert (len(failed) >= 1) == bool(schedule)
    assert case != "one_corruption" or (len(failed) == 1 == eng.guard_failures)
    assert all(r.output == c.output for r, c in zip(reqs, clean) if r.status == COMPLETED)
    eng.drain()
    eng.shutdown()
    assert eng.pool.in_use == 0


def test_unguarded_corruption_is_caught_by_the_auditor():
    """With guards off the out-of-pool entry reaches the dispatch (the plain
    paths read a clamped page, as JAX's gather does) and the per-tick
    ledger audit raises, in both packages."""
    prompts = _shared_prompts()
    kw = dict(GUARD, sync_every=1, guards=False, audit=True)
    sched = [Fault("table_corrupt", tick=3)]
    with pytest.raises(AuditError, match="diverged") as ours:
        _run(False, prompts, sched, **kw)
    with pytest.raises(JAuditError, match="diverged") as theirs:
        _run(True, prompts, sched, **kw)
    assert str(ours.value) == str(theirs.value)


# ---------------------------------------------------------------------------
# Chaos harness: seeded workloads x fault schedules
# ---------------------------------------------------------------------------

def test_fixed_schedule_smoke_matches_the_reference():
    """``faults.chaos_smoke`` (the port's module, on its own seeded weights)
    against the reference's: the same summary (the schedule's outcome
    follows the prompt lengths and blocks, not the weights)."""
    ours = faults.chaos_smoke(seed=0, verbose=False, device="cpu")
    theirs = jfaults.chaos_smoke(seed=0, verbose=False)
    assert ours == theirs
    assert ours["mismatched"] == 0 and ours["leaked_pages"] == 0
    assert ours["affected"] <= 2 and ours["faults_fired"]["table_corrupt"] == 1
    assert ours["guard_failures"] >= 1 and ours["audits_run"] > 0


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_random_preserving_schedules_byte_identical(seed):
    """pool / grant faults only: every request completes with the fault-free
    tokens under audit and drains to an empty pool, as the reference."""
    prompts = _shared_prompts(seed=seed)
    kw = dict(slots=2, max_len=48, max_new_tokens=5, page_size=4, num_blocks=14,
              sync_every=4)
    clean, _ = _run(False, prompts, **kw)
    sched = random_schedule(seed, n_faults=5, max_tick=20, sites=("pool_alloc", "grant"))
    reqs, eng = _both(prompts, sched, audit=True, **kw)
    assert all(r.status == COMPLETED for r in reqs)
    assert [r.output for r in reqs] == [r.output for r in clean]
    eng.drain()
    assert _leftover(eng) == 0
    eng.shutdown()
    assert eng.pool.in_use == 0


# ---------------------------------------------------------------------------
# Crash-safe persistence: snapshot / restore
# ---------------------------------------------------------------------------

SNAP = dict(slots=1, max_len=48, max_new_tokens=3, page_size=4, prefill_chunk=4,
            token_budget=5)


def _warm(reference, prompt, **over):
    eng = _engine(reference, **{**SNAP, **over})
    cold, warm = eng.submit(prompt), eng.submit(prompt)
    eng.run()
    return eng, cold, warm


def test_roundtrip_restores_warm_ttft_as_the_reference():
    """A snapshot's nodes equal the reference's and its pages equal them at
    1e-5; the restored engine serves the warm request's cached tokens,
    admission TTFT and stream."""
    prompt = _prompts((20,), seed=7)[0]
    jcfg, cfg, jparams, params = _model()
    eng, cold, warm = _warm(False, prompt)
    jeng, jcold, jwarm = _warm(True, prompt)
    assert warm.ttft_admit_ticks < cold.ttft_admit_ticks
    snap, jsnap = eng.snapshot(), jeng.snapshot()
    assert snap["nodes"] == jsnap["nodes"] and len(snap["nodes"]) == 5
    assert lm.page_leaf_shapes(eng.cache) == jlm.page_leaf_shapes(jeng.cache)
    assert len(snap["leaves"]) == len(jsnap["leaves"])
    for got, want in zip(snap["leaves"], jsnap["leaves"]):
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)
    pages = [page for _, _, page in eng.prefix.export()]
    assert pages == [page for _, _, page in jeng.prefix.export()]
    eng2 = ServingEngine.restore(cfg, params, ServeConfig(**SNAP), snap, device="cpu")
    audit_engine(eng2)  # the grafted pages are ledger-consistent
    for a, b in zip(lm.gather_pages(eng2.cache, [p for _, _, p in eng2.prefix.export()]),
                    snap["leaves"]):
        assert np.array_equal(a, b)
    restored = eng2.submit(prompt)
    eng2.run()
    jeng2 = JServingEngine.restore(jcfg, jparams, JServeConfig(**SNAP), jsnap)
    jrestored = jeng2.submit(prompt)
    jeng2.run()
    assert restored.output == cold.output == jrestored.output
    assert restored.cached_tokens == warm.cached_tokens == jrestored.cached_tokens
    assert restored.ttft_admit_ticks == warm.ttft_admit_ticks == jrestored.ttft_admit_ticks
    eng2.shutdown()
    assert eng2.pool.in_use == 0


def test_snapshot_pickles_to_disk_with_bf16_pages(tmp_path):
    """A pickled snapshot restores; a bf16 pool's pages travel as raw 16-bit
    patterns named "bfloat16" and come back bit for bit."""
    prompt = _prompts((20,), seed=7)[0]
    jcfg, cfg, jparams, params = _model()
    eng, cold, warm = _warm(False, prompt)
    path = str(tmp_path / "kv.snap")
    snap = eng.snapshot(path)
    assert len(snap["nodes"]) == eng.prefix.pages
    eng2 = ServingEngine.restore(cfg, params, ServeConfig(**SNAP), path, device="cpu")
    restored = eng2.submit(prompt)
    eng2.run()
    assert restored.output == cold.output
    assert restored.ttft_admit_ticks == warm.ttft_admit_ticks
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bparams = lm.init(bcfg, 0, device="cpu")
    beng = ServingEngine(bcfg, bparams, ServeConfig(**SNAP), device="cpu")
    beng.submit(prompt)
    beng.run()
    bsnap = beng.snapshot(str(tmp_path / "bf16.snap"))
    assert set(bsnap["leaf_dtypes"]) == {"bfloat16"}
    assert all(a.dtype == np.uint16 for a in bsnap["leaves"])
    beng2 = ServingEngine.restore(bcfg, bparams, ServeConfig(**SNAP),
                                  str(tmp_path / "bf16.snap"), device="cpu")
    again = beng2.snapshot()
    assert again["nodes"] == bsnap["nodes"]
    assert all(np.array_equal(a, b) for a, b in zip(again["leaves"], bsnap["leaves"]))


def test_partial_restore_when_pool_short():
    prompt = _prompts((20,), seed=7)[0]
    jcfg, cfg, jparams, params = _model()
    snap = _warm(False, prompt)[0].snapshot()
    jsnap = _warm(True, prompt)[0].snapshot()
    small = ServingEngine(cfg, params, ServeConfig(num_blocks=3, **SNAP), device="cpu")
    jsmall = JServingEngine(jcfg, jparams, JServeConfig(num_blocks=3, **SNAP))
    got = small.load_snapshot(snap)
    assert got == jsmall.load_snapshot(jsnap) and got < len(snap["nodes"])
    audit_engine(small)  # the partial graft is still consistent


@pytest.mark.parametrize("field,value", [("page_size", 8), ("format", 99),
                                         ("model", "other"), ("kv_dtype", "int8"),
                                         ("layout", None)])
def test_snapshot_mismatch_is_loud(field, value):
    """Model, page size, kv dtype, format and page-pool layout mismatches
    raise the reference's ValueErrors."""
    prompt = _prompts((20,), seed=7)[0]
    jcfg, cfg, jparams, params = _model()
    snap = _warm(False, prompt)[0].snapshot()
    fresh = ServingEngine(cfg, params, ServeConfig(**SNAP), device="cpu")
    if field == "page_size":
        other = ServingEngine(cfg, params, ServeConfig(
            slots=1, max_len=48, max_new_tokens=3, page_size=8), device="cpu")
        with pytest.raises(ValueError, match="page_size"):
            other.load_snapshot(snap)
        return
    if field == "layout":
        bad = dict(snap, leaves=[a[:, :1] for a in snap["leaves"]])
        with pytest.raises(ValueError, match="layout"):
            fresh.load_snapshot(bad)
        return
    with pytest.raises(ValueError, match=field):
        fresh.load_snapshot(dict(snap, **{field: value}))


def test_snapshot_requires_prefix_cache():
    for reference in (False, True):
        eng = _engine(reference, slots=1, max_len=16, max_new_tokens=1,
                      prefix_cache=False)
        with pytest.raises(ValueError, match="prefix cache"):
            eng.snapshot()
    eng = _engine(False, slots=1, max_len=16, max_new_tokens=1, cache="contiguous")
    with pytest.raises(ValueError, match="prefix cache"):
        eng.snapshot()
    with pytest.raises(ValueError, match="paged cache"):
        lm.gather_pages(eng.cache, [1])


# ---------------------------------------------------------------------------
# Faults inside the speculative draft-verify window
# ---------------------------------------------------------------------------

SPEC = dict(slots=2, max_len=48, max_new_tokens=6, page_size=4, sync_every=4,
            spec_decode="ngram", draft_len=3, audit=True)
SPEC_FAULTS = {
    "spec_poison": [Fault("spec_poison", tick=3, slot=0)],
    "grant_mid_draft_window": [Fault("grant", tick=2)],
    "table_corrupt": [Fault("table_corrupt", tick=3)],
}


@pytest.mark.parametrize("case", list(SPEC_FAULTS))
def test_spec_window_faults_match_the_reference(case):
    """tests/test_chaos.py TestSpecWindowFaults: poisoned verify logits FAIL
    exactly the hit request (detected on the device, read at the window's
    drain); a denied grant closes the draft window and keeps every stream;
    a corrupted entry is rejected by the guard; rollback leaks no page."""
    prompts = _prompts()
    clean, _ = _run(False, prompts, **SPEC)
    reqs, eng = _both(prompts, SPEC_FAULTS[case], **SPEC)
    failed = [r for r in reqs if r.status == FAILED]
    if case == "grant_mid_draft_window":
        assert eng.spec_fallbacks >= 1 and not failed
    else:
        text = "poisoned verify logits" if case == "spec_poison" else "dispatch guard"
        assert len(failed) == 1 and text in failed[0].error
    assert all(r.output == c.output for r, c in zip(reqs, clean) if r.status == COMPLETED)
    assert _leftover(eng) == 0


def test_spec_window_guard_failure_falls_back_past_the_failed_slot():
    """A corruption in the speculative window's preamble FAILs its slot and
    declines the window; the plain window then runs without that slot.  The
    reference hands the plain window its stale slot list and raises
    AttributeError there (ROADMAP Queue 3)."""
    prompts = _prompts()
    sched = [Fault("table_corrupt", tick=1, slot=0)]
    clean, _ = _run(False, prompts, **SPEC)
    reqs, eng = _run(False, prompts, sched, **SPEC)
    failed = [r for r in reqs if r.status == FAILED]
    assert len(failed) == 1 and "dispatch guard" in failed[0].error
    assert eng.spec_fallbacks >= 1 and eng.table_corruptions == eng.guard_failures == 1
    assert all(r.output == c.output for r, c in zip(reqs, clean) if r.status == COMPLETED)
    assert _leftover(eng) == 0
    with pytest.raises(AttributeError, match="prompt"):
        _run(True, prompts, sched, **SPEC)


# ---------------------------------------------------------------------------
# The entry points and chip_smoke.py's phase 13
# ---------------------------------------------------------------------------

def test_chaos_module_and_serve_cli_run_on_the_cpu(capsys):
    """``python -m repro_torch.serving.faults --device cpu`` prints the
    chaos summary; ``launch/serve.py --audit`` counts its clean audits and
    ``--cache contiguous`` serves an attention model over strips."""
    import subprocess
    import sys
    from pathlib import Path

    from repro_torch.launch import serve

    root = Path(__file__).resolve().parents[1]
    r = subprocess.run([sys.executable, "-m", "repro_torch.serving.faults", "--device",
                        "cpu"], capture_output=True, text=True, timeout=300,
                       env={"PYTHONPATH": str(root / "src"), "PATH": "/usr/bin:/bin",
                            "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0 and "chaos smoke OK" in r.stdout, r.stderr[-2000:]
    done = serve.main(["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu",
                       "--audit", "--num-blocks", "6"])
    out = capsys.readouterr().out
    assert all(r.status == "completed" for r in done) and "audits clean" in out
    assert ", 0 preemptions" not in out  # the small pool preempts
    done = serve.main(["--arch", "deepseek_v2_lite_16b", "--reduced", "--device", "cpu",
                       "--cache", "contiguous", "--sync-every", "4", "--requests", "3"])
    out = capsys.readouterr().out
    assert all(r.status == "completed" for r in done)
    assert "contiguous cache" in out and "[chunked prefill]" in out


def test_chip_smoke_fault_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 13 with CPU tensors at reduced widths: the
    chaos passes (the schedule's outcome is the card's: it follows prompt
    lengths and blocks), guards off, snapshot / restore, and the contiguous
    checks on two requests."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    qwen = dataclasses.replace(tconfigs.get_config("qwen2_1_5b").reduced(), num_layers=1)
    mla = dataclasses.replace(tconfigs.get_config("deepseek_v2_lite_16b").reduced(),
                              num_layers=2)
    cs.fault_phase(torch, np, lm, torch.device("cpu"), qwen, mla, contig_requests=2)
