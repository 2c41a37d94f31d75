"""Fault injection and live invariant auditing for the serving engine, the
port's copy of ``repro.serving.faults`` (host-side logic, near verbatim:
importing the reference module would import JAX).

:class:`FaultInjector` is a deterministic schedule of faults threaded
through the allocation and dispatch sites the engine already has:

* ``"pool_alloc"``: :meth:`BlockPool.alloc` raises :class:`PoolExhausted`
  before allocating, as a genuinely empty pool would (admission growth,
  per-tick growth, grow-ahead grants, copy-on-write copies);
* ``"grant"``: the multi-step grow-ahead grant fails at the sync boundary,
  forcing the per-tick fallback path;
* ``"poison"``: one dispatched logits row is overwritten with NaN on the
  device before sampling (a ``where`` on a mask uploaded with the tick's
  other inputs), modelling numerical corruption from a bad kernel or flaky
  device memory;
* ``"table_corrupt"``: one block-table entry of a dispatched slot is
  overwritten (out-of-range id / reserved page 0 / duplicate of another
  row's page, cycling).  The dispatch guard (``ServeConfig.guards``) must
  reject the row before any kernel launches; with guards off,
  :func:`audit_engine`'s ledger check is what notices;
* ``"spec_poison"``: one slot's speculative *verify* logits are
  overwritten with NaN on the device (``lm.spec_decode_loop``'s ``poison``
  mask); the loop emits nothing for that slot and reports it ``bad``, read
  at the window's one drain, and the engine FAILs exactly that request.

Pool and grant faults are output-preserving (preemption resumes by
recompute, grant failure degrades to per-tick stepping); poison and
table-corrupt faults fail the affected request and leave everyone else
untouched.

:func:`audit_engine` re-derives the refcount ledger from scratch after every
tick under ``ServeConfig.audit=True`` and raises :class:`AuditError` at the
tick the books diverge.

    PYTHONPATH=src python -m repro_torch.serving.faults --device cpu

runs the seeded chaos smoke (:func:`chaos_smoke`) on the reduced qwen2; the
default device is the card.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Callable, List, Optional, Sequence

import numpy as np

from .paged_cache import blocks_for

SITES = ("pool_alloc", "grant", "poison", "table_corrupt", "spec_poison")


@dataclasses.dataclass
class Fault:
    """One scheduled fault: fires at the first opportunity at or after
    engine tick ``tick``.  ``slot`` selects the dispatched row (mod the rows
    live that tick) for the poison and table-corrupt sites."""

    site: str
    tick: int = 0
    slot: int = 0
    fired_at: Optional[int] = None  # engine tick it actually fired, once

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r} "
                             f"(expected one of {SITES})")


class FaultInjector:
    """Deterministic fault schedule consumed by the engine's hooks.

    Each :class:`Fault` fires exactly once, at the first call to
    :meth:`fire` for its site once the bound clock reaches its tick, so the
    same schedule against the same workload replays the same run.  The
    engine binds the clock at construction (``lambda: engine.steps_run``).
    """

    def __init__(self, schedule: Sequence[Fault],
                 clock: Optional[Callable[[], int]] = None):
        self.schedule: List[Fault] = sorted(schedule, key=lambda f: f.tick)
        self._clock = clock or (lambda: 0)
        self.fired = {site: 0 for site in SITES}

    def bind_clock(self, clock: Callable[[], int]) -> None:
        self._clock = clock

    def fire(self, site: str) -> Optional[Fault]:
        """Consume and return the earliest due, unfired fault for ``site``
        (or None).  Called by the fault sites: a returned fault means "fail
        now"."""
        now = self._clock()
        for f in self.schedule:
            if f.fired_at is None and f.site == site and f.tick <= now:
                f.fired_at = now
                self.fired[site] += 1
                return f
        return None

    def pending(self, site: str) -> bool:
        """Any unfired fault for ``site``, due or not (the engine routes
        around paths that cannot observe it: the plain multi-step window has
        no per-row poison detection)."""
        return any(f.fired_at is None and f.site == site
                   for f in self.schedule)

    @property
    def remaining(self) -> int:
        return sum(1 for f in self.schedule if f.fired_at is None)


def random_schedule(rng, n_faults: int = 6, max_tick: int = 40,
                    sites: Sequence[str] = SITES,
                    slots: int = 4) -> List[Fault]:
    """Seeded random fault schedule.  ``rng`` is a ``numpy.random.Generator``
    or an int seed; the draws are the reference's, so a seed gives the same
    schedule in both packages."""
    if isinstance(rng, (int, np.integer)):
        rng = np.random.default_rng(int(rng))
    return [
        Fault(site=str(rng.choice(list(sites))),
              tick=int(rng.integers(0, max_tick)),
              slot=int(rng.integers(0, max(1, slots))))
        for _ in range(n_faults)
    ]


# ---------------------------------------------------------------------------
# Invariant auditor
# ---------------------------------------------------------------------------


class AuditError(AssertionError):
    """A serving invariant does not hold.  Raised by :func:`audit_engine`
    at the tick the books diverged."""


def _fail(msg: str):
    raise AuditError(msg)


def audit_engine(engine) -> None:
    """Re-derive the engine's refcount ledger from scratch and check every
    serving invariant (faults.py:153).  O(pool + tables + index) a call:
    test and debug machinery (``ServeConfig.audit=True``).

    1. **Page conservation**: the free list and the refcount ledger
       partition the pool exactly; the reserved page 0 is never allocatable.
    2. **Refcount consistency**: every block's refcount equals the slot-table
       entries referencing it plus one if the radix index holds it; no
       allocated block is referenced by nobody.
    3. **Radix reachability**: every index node hangs off its parent under
       its own token block, holds a full page of tokens and an allocated
       page; no page is indexed twice.
    4. **No orphaned slots**: an empty slot holds no request state and no
       blocks (its table row is all page 0); an occupied slot's request is
       live and its blocks cover every written position.
    """
    slots = engine.scfg.slots
    # -- slot/request pairing (both cache layouts) ----------------------
    for s in range(slots):
        req = engine.slot_req[s]
        if req is None:
            if engine.slot_state[s] is not None:
                _fail(f"slot {s}: empty but state={engine.slot_state[s]!r}")
            if engine.tables is not None and engine.tables.num_blocks(s):
                _fail(f"slot {s}: empty but holds "
                      f"{engine.tables.num_blocks(s)} blocks")
        elif req.done:
            _fail(f"slot {s}: terminal request uid={req.uid} "
                  f"({req.status}) still holds the slot")
    for req in engine.queue:
        if req.done:
            _fail(f"queued request uid={req.uid} is terminal "
                  f"({req.status})")

    pool = engine.pool
    if pool is None:
        return  # contiguous layout: no pages to conserve

    # -- 1. page conservation -------------------------------------------
    free = set(pool._free)
    refd = set(pool._ref)
    if len(free) != len(pool._free):
        _fail("free list holds duplicate block ids")
    if free & refd:
        _fail(f"blocks both free and referenced: {sorted(free & refd)}")
    universe = set(range(pool.base, pool.base + pool.num_blocks))
    if free | refd != universe:
        _fail(f"pool books lost blocks: missing "
              f"{sorted(universe - free - refd)}, "
              f"foreign {sorted((free | refd) - universe)}")
    if any(c <= 0 for c in pool._ref.values()):
        _fail("allocated block with non-positive refcount")

    # -- rebuild the expected ledger from tables + index ----------------
    expected: collections.Counter = collections.Counter()
    tables = engine.tables
    for s in range(slots):
        blks = tables.blocks(s)
        for blk in blks:
            expected[blk] += 1
        row = tables._np[s]
        if list(row[: len(blks)]) != blks:
            _fail(f"slot {s}: device table row diverged from block list")
        if row[len(blks):].any():
            _fail(f"slot {s}: table tail past {len(blks)} blocks not page 0")
        req = engine.slot_req[s]
        if req is not None:
            written = int(engine.pos[s])
            if written > 0 and len(blks) < blocks_for(written, pool.page_size):
                _fail(f"slot {s}: {written} written tokens exceed its "
                      f"{len(blks)} blocks")

    # -- 3. radix reachability ------------------------------------------
    if engine.prefix is not None:
        seen_pages = set()
        stack = list(engine.prefix._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            if nd.page in seen_pages:
                _fail(f"page {nd.page} indexed twice in the radix tree")
            seen_pages.add(nd.page)
            if nd.parent.children.get(nd.token_block) is not nd:
                _fail(f"radix node for page {nd.page} unreachable from its "
                      "parent under its own token block")
            if len(nd.token_block) != pool.page_size:
                _fail(f"radix node for page {nd.page} holds "
                      f"{len(nd.token_block)} tokens, not a full page")
            if pool.refcount(nd.page) < 1:
                _fail(f"radix index points at free page {nd.page}")
            expected[nd.page] += 1

    # -- 2. refcount consistency ----------------------------------------
    for blk, want in expected.items():
        have = pool.refcount(blk)
        if have != want:
            _fail(f"block {blk}: pool refcount {have}, but tables+index "
                  f"hold {want} references")
    orphans = refd - set(expected)
    if orphans:
        _fail(f"allocated blocks referenced by no table and no index: "
              f"{sorted(orphans)}")


# ---------------------------------------------------------------------------
# Seeded chaos smoke (python -m repro_torch.serving.faults)
# ---------------------------------------------------------------------------

# the reference's fixed schedule (faults.py:298-302): poison early, since
# windows stay closed while a poison fault is pending, so the grant fault
# comes due after it
CHAOS_SCHEDULE = (("pool_alloc", 2, 0), ("poison", 4, 1), ("pool_alloc", 6, 0),
                  ("grant", 7, 0), ("pool_alloc", 10, 0),
                  ("table_corrupt", 12, 0))


def chaos_smoke(seed: int = 0, verbose: bool = True, device="cuda") -> dict:
    """The fixed-schedule chaos run (faults.py:267): a small shared-prefix
    workload on the reduced qwen2 driven twice, fault-free and then under
    :data:`CHAOS_SCHEDULE` with the auditor on every tick, asserting the
    fault-tolerance contract end to end.  Returns a summary dict; raises
    :class:`AuditError` on any violation."""
    from ..configs import get_config
    from ..core.device import resolve_device
    from ..models import lm
    from .engine import ServeConfig, ServingEngine

    dev = resolve_device(device)
    cfg = get_config("qwen2_1_5b").reduced()
    params = lm.init(cfg, 0, device=dev)
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, cfg.vocab_size, size=8).tolist()
    prompts = [shared + rng.integers(0, cfg.vocab_size, size=n).tolist()
               for n in (3, 5, 2, 6, 4, 3)]
    kw = dict(slots=2, max_len=48, max_new_tokens=6, page_size=4,
              num_blocks=14, temperature=0.0, sync_every=4)

    def drive(injector):
        eng = ServingEngine(cfg, params, ServeConfig(audit=True, **kw),
                            injector=injector, device=dev)
        reqs = [eng.submit(p) for p in prompts]
        eng.run(max_steps=500)
        return eng, reqs

    _, ref_reqs = drive(None)
    schedule = [Fault(site, tick=t, slot=s) for site, t, s in CHAOS_SCHEDULE]
    eng, reqs = drive(FaultInjector(schedule))
    eng.drain()
    eng.shutdown()

    ref_out = {r.uid: r.output for r in ref_reqs}
    mismatched = [r.uid for r in reqs
                  if r.status == "completed" and r.output != ref_out[r.uid]]
    affected = [r.uid for r in reqs if r.status != "completed"]
    summary = {
        "seed": seed,
        "completed": sum(r.status == "completed" for r in reqs),
        "affected": len(affected),
        "mismatched": len(mismatched),
        "faults_fired": dict(eng.injector.fired),
        "poisoned_rows": eng.poisoned_rows,
        "preemptions": eng.preemptions,
        "leaked_pages": eng.pool.in_use,
        "audits_run": eng.audits_run,
        "table_corruptions": eng.table_corruptions,
        "guard_failures": eng.guard_failures,
    }
    if mismatched:
        raise AuditError(f"unaffected requests diverged: uids {mismatched}")
    if eng.table_corruptions and not eng.guard_failures:
        raise AuditError(
            f"table corruption fired but the guard caught nothing: {summary}")
    if eng.pool.in_use != 0:
        raise AuditError(
            f"shutdown leaked {eng.pool.in_use} pages: {summary}")
    if eng.injector.remaining and verbose:
        print(f"note: {eng.injector.remaining} scheduled faults never came "
              "due (run too short)")
    if verbose:
        print("chaos smoke OK:", summary)
    return summary


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    args = ap.parse_args()
    chaos_smoke(seed=args.seed, device=args.device)
