"""Batched serving engine: continuous batching over a paged KV cache, the
per-tick path of ``repro.serving.engine``.

The scheduler is the reference's host logic, ported line for line, so on the
same workload and ``ServeConfig`` it takes the same decisions on the same
ticks (``steps_run``, TTFT ticks, preemptions and shared pages are equal):

* **paged KV cache** (serving/paged_cache.py): admission gates on free
  blocks, growth preempts the lowest-priority (then youngest) request back
  to the queue when the pool runs dry (recompute resume), and completion
  recycles blocks at once;
* **chunked prefill** under the token-budget scheduler
  (:func:`plan_prefill_chunks`): each tick runs one decode step for the
  generating slots plus prompt chunks within the leftover budget, through
  ``lm.prefill_step`` and the prefill_attention kernel; ``prefill="replay"``
  streams prompts one token per tick through the decode step instead, the
  only mode of a model with recurrent state (``lm.supports_chunked_prefill``:
  the hybrid runs it over its paged pools plus each slot's Mamba-2 rows);
* **prefix cache**: full prompt pages are indexed when a request finishes
  prefilling, and a later request whose prompt shares them attaches the
  pages at admission; a write into a shared page goes through copy-on-write
  (``lm.copy_pages``, on the device) first;
* **dispatch guard** (``kernels.ops.guard_dispatch``) before every paged
  dispatch, failing exactly the offending request;
* **quantized KV** (``kv_dtype="int8"|"int4"``): the page pools hold packed
  bytes plus per-token scales, a storage format the engine forwards into the
  model config; scheduling, sharing and COW run unchanged over them;
* **multi-step decode window** (``sync_every > 1``): when every active slot
  is generating, up to ``sync_every`` decode ticks run back to back on the
  device (``lm.decode_loop``) after one all-or-nothing grow-ahead page
  grant, and the host drains their tokens once at the end;
* **sampling** (``temperature > 0``): each step samples on the device
  (``sampling.sample_step``) under a device-resident PRNG key carry, the
  reference's threefry stream (``serving.prng``), advanced exactly where the
  reference's jitted steps advance it: once a decode step and once a
  prefill step, and once an iteration of the window while any slot lives;
  greedy never splits it;
* **speculative decoding** (``spec_decode="ngram"``): when every active
  slot is generating, up to ``sync_every`` draft-verify rounds run on the
  device (``lm.spec_decode_loop``): each drafts ``draft_len`` tokens from
  the slot's own history, scores them with the feed token in one chunk
  (``lm.verify_step``, whose attention takes the plain version: its chunks
  start at any position), and emits the accepted prefix plus the model's
  own next token.  Greedy streams are byte-identical to plain decode; a
  sampled round splits the key ``draft_len + 2`` ways whatever it accepts;
* request lifecycle: every request ends in one terminal status through one
  exit path (``_terminate``) that releases its pages; deadlines and
  ``cancel()`` are honoured before each dispatch; ``drain()`` stops intake
  and finishes the residents, ``shutdown()`` also cancels the queue and
  flushes the prefix index, leaving the pool empty;
* **fault tolerance** (engine.py:81-91): a ``serving.faults.FaultInjector``
  fires at the real allocation and dispatch sites (the pool's ``alloc``,
  the grow-ahead grant, a NaN logits row written on the device before
  sampling, a corrupted block-table entry that the dispatch guard must
  reject before any launch, poisoned verify logits inside the speculative
  window), and ``ServeConfig.audit=True`` re-derives the page ledger after
  every tick (``faults.audit_engine``);
* **persistence**: ``snapshot()`` / ``restore()`` carry the radix index and
  its pages' contents across an engine restart, so a warm prefix stays warm
  (bf16 pages as raw 16-bit patterns named ``"bfloat16"``).

* **contiguous mode** (``cache="contiguous"``): per-slot strips of
  ``max_len`` (ring strips of ``window`` entries for windowed layers) for
  the attention families, the latent strips for MLA, the recurrent state
  for the SSM family (and both beside each other for the hybrid); no pool,
  no block table, no prefix cache and no guard (the reference's
  ``self.pool is None`` / ``self.tables is None`` branches).  Chunked
  prefill, the window and speculation run over the strips; the attention
  there is the plain version, as the reference's contiguous layers call
  ``ref.*`` (no Pallas kernel exists for it).

Each tick runs eagerly on the device (no jit): the KV pools, strips and the
recurrent state are updated in place and the sampled token ids are the
only per-tick download (one per window with ``sync_every > 1``).
``spec_decode`` for a model without chunked prefill raises the reference's
``ValueError``.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.device import resolve_device
from ..core.errors import GuardError
from ..kernels.ops import guard_dispatch
from ..models import lm
from ..models.config import ModelConfig
from .paged_cache import (
    BlockPool,
    PoolExhausted,
    PrefixCache,
    SlotTables,
    blocks_for,
)
from . import prng
from .faults import FaultInjector, audit_engine
from .sampling import sample_step, spec_accept, spec_sample_step


def plan_prefill_chunks(
    budget: int,
    n_gen: int,
    pending: Sequence[Tuple[int, int, int]],  # (slot, admit_seq, remaining)
    chunk: int,
) -> Dict[int, int]:
    """Sarathi-style budget split: decode tokens are spent first (one per
    generating slot), the leftover feeds prompt chunks oldest-admitted
    first.  Grants are all-or-nothing per request, always ``min(chunk,
    remaining)``, so every chunk *starts* at a multiple of ``chunk``: the
    page-alignment contract of the prefill kernel's page writes."""
    room = budget - n_gen
    out: Dict[int, int] = {}
    for slot, _seq, remaining in sorted(pending, key=lambda t: t[1]):
        n = min(chunk, remaining)
        if n <= 0:
            continue
        if n > room:
            break
        out[slot] = n
        room -= n
    return out


@dataclasses.dataclass
class ServeConfig:
    slots: int = 8  # decode batch width
    max_len: int = 1024  # per-request logical cache length
    max_new_tokens: int = 128
    eos_id: int = -1  # -1: never stops early
    temperature: float = 0.0
    seed: int = 0
    cache: str = "paged"  # "paged" | "contiguous"
    page_size: int = 16  # tokens per KV block (paged mode)
    # pool size in blocks; None = slots * ceil(max_len / page_size).  Size it
    # below that to oversubscribe memory (that's the point of paging).
    num_blocks: Optional[int] = None
    # KV storage format of the page pools: None = the model's dtype;
    # "int8"/"int4" = packed per-token quantization with per-row scales
    # (paged mode only); overrides ModelConfig.kv_dtype for this engine
    kv_dtype: Optional[str] = None
    # -- prefill fast path ------------------------------------------------
    prefill: str = "chunked"  # "chunked" | "replay"
    # prompt tokens per chunk-wide forward pass; clamped at engine init to
    # token_budget - slots + 1 so a chunk always fits the leftover budget
    prefill_chunk: int = 16
    # per-tick token budget shared by the decode batch and prefill chunks;
    # None = slots + prefill_chunk.  Floored at `slots`.
    token_budget: Optional[int] = None
    # -- prefix caching ---------------------------------------------------
    prefix_cache: bool = True
    # -- multi-step decode window -----------------------------------------
    # decode ticks per host dispatch: 1 = per-tick stepping; N > 1 runs up
    # to N ticks back to back on the device when every active slot is
    # generating, after an all-or-nothing grow-ahead page grant (else that
    # boundary falls back to a per-tick step)
    sync_every: int = 1
    # -- speculative decoding ---------------------------------------------
    # draft proposer name (lm.DRAFT_PROPOSERS) or None = off; a round drafts
    # draft_len tokens and verifies them with the feed token in one chunk,
    # up to sync_every rounds a dispatch; needs a chunked-prefill model
    # (checked at engine init)
    spec_decode: Optional[str] = None
    draft_len: int = 4
    # -- fault tolerance --------------------------------------------------
    # run the invariant auditor (faults.audit_engine) after every tick
    audit: bool = False
    # base ticks a preemption victim waits before re-admission, doubling
    # per preemption (capped at 32x).  0 = immediate re-admission.
    retry_backoff: int = 0
    # discharge the kernels' runtime obligations before every paged dispatch
    guards: bool = True

    def __post_init__(self):
        for name in ("slots", "max_len", "max_new_tokens", "page_size",
                     "prefill_chunk", "draft_len"):
            v = getattr(self, name)
            if v <= 0:
                raise ValueError(f"{name} must be positive, got {v}")
        if self.num_blocks is not None and self.num_blocks <= 0:
            raise ValueError(
                f"num_blocks must be positive, got {self.num_blocks}"
            )
        if self.token_budget is not None and self.token_budget < self.slots:
            raise ValueError(
                f"token_budget={self.token_budget} < slots={self.slots}: "
                "a full generation batch could never fit in one tick"
            )
        if self.kv_dtype not in (None, "int8", "int4"):
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r} "
                "(expected None, 'int8' or 'int4')"
            )
        if self.cache not in ("paged", "contiguous"):
            raise ValueError(f"unknown cache mode {self.cache!r}")
        if self.prefill not in ("chunked", "replay"):
            raise ValueError(f"unknown prefill mode {self.prefill!r}")
        if self.retry_backoff < 0:
            raise ValueError(
                f"retry_backoff must be >= 0, got {self.retry_backoff}"
            )
        if (self.spec_decode is not None
                and self.spec_decode not in lm.DRAFT_PROPOSERS):
            raise ValueError(
                f"unknown spec_decode proposer {self.spec_decode!r} "
                f"(registered: {sorted(lm.DRAFT_PROPOSERS)})"
            )
        if self.kv_dtype is not None and self.cache != "paged":
            # the reference raises this at engine init (engine.py:500)
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} requires cache='paged'")


# Request lifecycle: QUEUED <-> RUNNING (preemption re-queues), ending in
# exactly one terminal status, which releases every block the request held.
QUEUED = "queued"
RUNNING = "running"
COMPLETED = "completed"  # EOS / token limit reached
TIMED_OUT = "timed_out"  # deadline_ticks expired before completion
CANCELLED = "cancelled"  # cancel() honored
FAILED = "failed"  # poisoned logits, retry budget, or outgrew the pool
REJECTED = "rejected"  # could never be served (admission fail-fast)
TERMINAL = (COMPLETED, TIMED_OUT, CANCELLED, FAILED, REJECTED)

# snapshot() / restore() wire format version (engine.py:433)
SNAPSHOT_FORMAT = 1


@dataclasses.dataclass
class Request:
    uid: int
    prompt: List[int]
    max_new_tokens: Optional[int] = None
    priority: int = 0  # higher survives preemption longer
    # ticks from submission before the request times out wherever it is
    deadline_ticks: Optional[int] = None
    # preemption re-admissions before the request fails instead of retrying
    max_retries: Optional[int] = None
    # filled by the engine:
    status: str = QUEUED  # QUEUED <-> RUNNING -> one of TERMINAL
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    preemptions: int = 0
    error: Optional[str] = None  # why a non-COMPLETED request ended
    submit_step: int = 0  # engine tick at submission
    first_token_step: Optional[int] = None  # tick that produced output[0]
    admit_step: Optional[int] = None  # tick of first admission into a slot
    cached_tokens: int = 0  # prompt tokens covered by prefix-cache hits
    _cancel: bool = dataclasses.field(default=False, repr=False)

    def cancel(self) -> None:
        """Request cancellation, honored at the next scheduler boundary."""
        if not self.done:
            self._cancel = True

    @property
    def ttft_ticks(self) -> Optional[int]:
        """Engine ticks from submission to the first generated token."""
        if self.first_token_step is None:
            return None
        return self.first_token_step - self.submit_step + 1

    @property
    def ttft_admit_ticks(self) -> Optional[int]:
        """Engine ticks from first admission to the first generated token."""
        if self.first_token_step is None or self.admit_step is None:
            return None
        return self.first_token_step - self.admit_step + 1


class ServingEngine:
    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 injector: Optional[FaultInjector] = None, *, device="cuda"):
        self.device = resolve_device(device)
        if serve_cfg.kv_dtype is not None and cfg.kv_dtype != serve_cfg.kv_dtype:
            # the storage format is a property of the cache the steps run
            # over, so it lives on the model config (engine.py:488-492)
            cfg = dataclasses.replace(cfg, kv_dtype=serve_cfg.kv_dtype)
        emb = params["embed"]["embedding"]
        if emb.device.type != self.device.type:
            raise ValueError(
                f"params are on {emb.device}, the engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        b = serve_cfg.slots
        self.cache_mode = serve_cfg.cache
        if self.cache_mode == "paged":
            ps = serve_cfg.page_size
            self.max_pages = blocks_for(serve_cfg.max_len, ps)
            nb = serve_cfg.num_blocks or b * self.max_pages
            # physical page 0 is reserved (padding/garbage page), so the
            # device pool holds nb + 1 pages and the allocator hands out ids
            # 1..nb.
            self.cache = lm.init_cache(
                cfg, b, serve_cfg.max_len, layout="paged", page_size=ps,
                num_blocks=nb + 1, device=self.device,
            )
            page_bytes = self.cache.kv_bytes() // (nb + 1)
            self.pool = BlockPool(nb, ps, base=1, page_bytes=page_bytes)
            self.tables = SlotTables(self.pool, b, self.max_pages)
        else:
            # per-slot strips and/or recurrent state (engine.py:527-530)
            self.pool = None
            self.tables = None
            self.cache = lm.init_cache(cfg, b, serve_cfg.max_len,
                                       layout="contiguous", device=self.device)

        # prefix cache: paged attention families only (engine.py:532-543):
        # recurrent SSM/hybrid state must replay
        self.prefix: Optional[PrefixCache] = None
        if (self.cache_mode == "paged" and serve_cfg.prefix_cache
                and lm.supports_chunked_prefill(cfg)):
            self.prefix = PrefixCache(
                self.pool, salt=(cfg.name, serve_cfg.page_size)
            )
        self.pages_shared = 0  # cache-hit pages attached at admission
        self.pages_copied = 0  # copy-on-write page duplications
        self.pages_deduped = 0  # duplicate prefill pages absorbed at insert

        self.pos = np.zeros((b,), np.int32)  # next write position per slot
        self.slot_req: List[Optional[Request]] = [None] * b
        # chunked mode: "prefill" until the replay cursor reaches the end of
        # prompt+output, then "gen" (replay mode leaves these unused)
        self.slot_state: List[Optional[str]] = [None] * b
        self.queue: collections.deque[Request] = collections.deque()
        self._uid = itertools.count()
        self._admit_seq = itertools.count()
        self.prefill_mode = (
            "chunked"
            if serve_cfg.prefill == "chunked" and lm.supports_chunked_prefill(cfg)
            else "replay"
        )
        # the PRNG key, a device carry advanced only by sampling steps
        self._key = prng.key(serve_cfg.seed, device=self.device)
        self.sync_every = max(1, serve_cfg.sync_every)
        if (serve_cfg.spec_decode is not None
                and not lm.supports_chunked_prefill(cfg)):
            # engine.py:575: the verify pass is a chunked prefill
            raise ValueError(
                f"spec_decode={serve_cfg.spec_decode!r} requires a chunked-"
                f"prefill arch (GQA/MLA); {cfg.name} (attention="
                f"{cfg.attention}, family={cfg.family}) cannot run the "
                "verify pass")
        self.spec_proposer = serve_cfg.spec_decode
        self.spec_windows = 0  # speculative dispatches taken
        self.spec_rounds = 0  # draft-verify rounds drained (>=1 emit or bad)
        self.spec_proposed = 0  # draft tokens scored by verify
        self.spec_accepted = 0  # draft tokens accepted (excl. the bonus token)
        self.spec_all_rejected = 0  # live slot-rounds accepting zero drafts
        self.spec_fallbacks = 0  # spec window declined -> plain window/tick
        # the device block table is re-uploaded only after the scheduler
        # mutates tables (admission growth, grow-ahead grants and trims,
        # preemption, EOS recycling, COW)
        self._tables_dirty = True
        self.table_uploads = 0  # host->device table transfers
        self.decode_windows = 0  # multi-step dispatches taken
        self.window_fallbacks = 0  # grow-ahead denied -> per-tick boundary
        # step() calls that ran device work: a window counts once however
        # many ticks it covers
        self.dispatches = 0
        self.token_budget = max(
            serve_cfg.token_budget or (b + serve_cfg.prefill_chunk), b
        )
        # grants are all-or-nothing (chunk starts must stay chunk-aligned),
        # so the chunk is clamped to the worst-case leftover room
        self.prefill_chunk = max(
            1, min(serve_cfg.prefill_chunk, self.token_budget - b + 1)
        )
        self.tick_tokens: "collections.deque[int]" = collections.deque(
            maxlen=4096
        )
        self.completed: List[Request] = []
        self.steps_run = 0
        self.preemptions = 0
        # -- fault tolerance (engine.py:622-634) --------------------------
        self.admission_open = True  # drain() / shutdown() close intake
        self.poisoned_rows = 0  # logits rows with no finite value seen
        self.audits_run = 0  # invariant audits executed (scfg.audit)
        self.guard_failures = 0  # requests FAILed by the dispatch guard
        self.table_corruptions = 0  # injected table_corrupt faults fired
        self._corrupt_mode = 0  # cycles the injected corruption flavors
        self.injector = injector
        if injector is not None:
            injector.bind_clock(lambda: self.steps_run)
            if self.pool is not None:
                self.pool.injector = injector

    # ------------------------------------------------------------------
    def submit(self, prompt: Sequence[int], max_new_tokens=None,
               priority: int = 0, deadline_ticks: Optional[int] = None,
               max_retries: Optional[int] = None) -> Request:
        req = Request(next(self._uid), list(prompt), max_new_tokens,
                      priority=priority, deadline_ticks=deadline_ticks,
                      max_retries=max_retries, submit_step=self.steps_run)
        self.queue.append(req)
        return req

    # -- scheduler ------------------------------------------------------
    def _resident_tokens(self, req: Request) -> int:
        """Tokens the request must hold to make forward progress: its full
        replay (prompt + already-generated) plus the next write."""
        return len(req.prompt) + len(req.output) + 1

    def _admit(self):
        """FIFO admission into free slots, gated on free blocks (the
        request's replay footprint is allocated up front, prefix-cache hits
        attached first).  Preemption victims still in retry backoff step
        aside; nothing else skips the queue head."""
        if not self.admission_open:
            return
        for s in range(self.scfg.slots):
            if self.slot_req[s] is not None or not self.queue:
                continue
            req = None
            for cand in self.queue:
                if getattr(cand, "_not_before", 0) > self.steps_run:
                    continue  # backing off after a preemption storm
                req = cand
                break
            if req is None:
                break  # everyone queued is backing off
            matched: List[int] = []
            if self.pool is not None:
                need = blocks_for(self._resident_tokens(req),
                                  self.pool.page_size)
                if need > min(self.pool.num_blocks, self.max_pages):
                    # can never fit: fail fast instead of wedging the queue
                    self.queue.remove(req)
                    self._terminate(req, REJECTED, error=(
                        f"needs {need} KV blocks; pool holds "
                        f"{self.pool.num_blocks}, table holds {self.max_pages}"
                    ))
                    continue
                if self.prefix is not None:
                    # keep one replay token uncached (the decode needs a real
                    # last token to feed) and consume only prompt pages
                    ps = self.pool.page_size
                    replay_len = len(req.prompt) + len(req.output)
                    cap = min(len(req.prompt), replay_len - 1) // ps
                    matched = self.prefix.match(req.prompt, cap)
                shortfall = (need - len(matched)) - self.pool.free
                if shortfall > 0 and self.prefix is not None:
                    self.prefix.evict(shortfall, protect=frozenset(matched))
                if self.pool.free < need - len(matched):
                    break
            self.queue.remove(req)
            self.slot_req[s] = req
            self.slot_state[s] = "prefill"
            req.status = RUNNING
            start = len(matched) * self.pool.page_size if matched else 0
            self.pos[s] = start
            req._cursor = start  # type: ignore[attr-defined]
            req._admit_seq = next(self._admit_seq)  # type: ignore[attr-defined]
            req._prefix_done = False  # type: ignore[attr-defined]
            if req.admit_step is None:
                req.admit_step = self.steps_run
            req.cached_tokens = start
            if self.tables is not None:
                if matched:
                    self.tables.attach(s, matched)
                    self.pages_shared += len(matched)
                    self._tables_dirty = True
                try:
                    if self.tables.ensure_capacity(
                            s, self._resident_tokens(req), req.uid):
                        self._tables_dirty = True
                except PoolExhausted:
                    # an injected alloc fault fired past the free-count
                    # gate: roll the admission back (matched pages return
                    # their references) and retry next tick (engine.py:723)
                    self.tables.release_slot(s)
                    self._tables_dirty = True
                    self.slot_req[s] = None
                    self.slot_state[s] = None
                    self.pos[s] = 0
                    req._cursor = 0  # type: ignore[attr-defined]
                    req.cached_tokens = 0
                    req.status = QUEUED
                    self.queue.appendleft(req)
                    break

    def _pick_victim(self, exclude) -> Optional[int]:
        """Preemption victim: lowest priority, then youngest admission."""
        excluded = {exclude} if isinstance(exclude, int) else set(exclude)
        best = None
        for s in range(self.scfg.slots):
            if s in excluded or self.slot_req[s] is None:
                continue
            r = self.slot_req[s]
            key = (r.priority, -r._admit_seq)  # type: ignore[attr-defined]
            if best is None or key < best[0]:
                best = (key, s)
        return None if best is None else best[1]

    def _preempt(self, s: int):
        """Evict slot ``s``: blocks back to the pool, request to the front of
        the queue (recompute resume).  A victim past ``max_retries`` fails;
        with ``retry_backoff`` it waits out an exponential backoff."""
        req = self.slot_req[s]
        req.preemptions += 1
        self.preemptions += 1
        if req.max_retries is not None and req.preemptions > req.max_retries:
            self._terminate(req, FAILED, slot=s, error=(
                f"preempted {req.preemptions} times "
                f"(max_retries={req.max_retries})"
            ))
            return
        self.tables.release_slot(s)
        self._tables_dirty = True
        self.slot_req[s] = None
        self.slot_state[s] = None
        self.pos[s] = 0
        req._cursor = 0  # type: ignore[attr-defined]
        req.status = QUEUED
        if self.scfg.retry_backoff > 0:
            wait = self.scfg.retry_backoff * (
                1 << min(req.preemptions - 1, 5)
            )
            req._not_before = self.steps_run + wait  # type: ignore[attr-defined]
        self.queue.appendleft(req)

    def _reclaim(self, want: int) -> int:
        """Evict up to ``want`` unreferenced prefix-cache pages back to the
        pool, before any live slot is preempted."""
        if self.prefix is None or want <= 0:
            return 0
        return self.prefix.evict(want)

    def _ensure_with_evict(self, s: int, target_tokens: int, owner) -> bool:
        """ensure_capacity with prefix-cache eviction as the pressure valve.
        Returns False only when eviction cannot free enough blocks."""
        while True:
            try:
                if self.tables.ensure_capacity(s, target_tokens, owner):
                    self._tables_dirty = True
                return True
            except PoolExhausted:
                need = blocks_for(target_tokens, self.pool.page_size) - self.tables.num_blocks(s)
                if self.prefix is None or self.prefix.evict(need - self.pool.free) == 0:
                    return False

    def _grow(self, s: int) -> bool:
        """Ensure slot ``s`` can write at ``pos[s]``; preempt on exhaustion.
        Returns False when ``s`` itself was evicted to make room."""
        req = self.slot_req[s]
        if blocks_for(int(self.pos[s]) + 1, self.pool.page_size) > self.pool.num_blocks:
            self._terminate(req, FAILED, slot=s,
                            error="request outgrew the KV block pool")
            return False
        while True:
            if self._ensure_with_evict(s, int(self.pos[s]) + 1, req.uid):
                return True
            victim = self._pick_victim(exclude=s)
            if victim is None:
                self._preempt(s)
                return False
            # don't evict someone strictly more important than s
            v = self.slot_req[victim]
            if (v.priority, -v._admit_seq) > (req.priority, -req._admit_seq):  # type: ignore[attr-defined]
                self._preempt(s)
                return False
            self._preempt(victim)

    def _terminate(self, req: Request, status: str,
                   slot: Optional[int] = None,
                   error: Optional[str] = None):
        """The single request exit path: the request ends exactly once,
        with its slot's pages released, whatever the reason."""
        if slot is not None:
            self.slot_req[slot] = None
            self.slot_state[slot] = None
            self.pos[slot] = 0
            if self.tables is not None:
                self.tables.release_slot(slot)  # blocks recycle immediately
                self._tables_dirty = True
        if error is not None:
            req.error = error
        req.status = status
        req.done = True
        self.completed.append(req)

    def _sweep_lifecycle(self):
        """Honor ``cancel()`` and ``deadline_ticks`` before dispatching,
        wherever the request lives (queue or slot).  Partial output stays."""
        now = self.steps_run
        for req in list(self.queue):
            verdict = self._lifecycle_verdict(req, now)
            if verdict is not None:
                self.queue.remove(req)
                self._terminate(req, verdict[0], error=verdict[1])
        for s in range(self.scfg.slots):
            req = self.slot_req[s]
            if req is None:
                continue
            verdict = self._lifecycle_verdict(req, now)
            if verdict is not None:
                self._terminate(req, verdict[0], slot=s, error=verdict[1])

    @staticmethod
    def _lifecycle_verdict(req: Request, now: int):
        if req._cancel:
            return (CANCELLED, "cancelled by caller")
        if (req.deadline_ticks is not None
                and now - req.submit_step >= req.deadline_ticks):
            return (TIMED_OUT,
                    f"deadline of {req.deadline_ticks} ticks exceeded")
        return None

    def _emit_token(self, s: int, req: Request, tok: int):
        """Record a generated token and apply the stop conditions."""
        req.output.append(tok)
        if req.first_token_step is None:
            req.first_token_step = self.steps_run
        limit = req.max_new_tokens or self.scfg.max_new_tokens
        if (
            tok == self.scfg.eos_id
            or len(req.output) >= limit
            or self.pos[s] >= self.scfg.max_len
        ):
            self._terminate(req, COMPLETED, slot=s)

    # -- device work ----------------------------------------------------
    def _fresh_cache(self) -> lm.Cache:
        """The cache for the next step, its block table re-uploaded only
        after a scheduler mutation."""
        if self.tables is not None and self._tables_dirty:
            self.cache = self.cache.with_tables(torch.as_tensor(
                self.tables.tables(), device=self.device))
            self._tables_dirty = False
            self.table_uploads += 1
        return self.cache

    def _window_sample(self, logits, key, gate):
        """The window's ``sample_fn``: one decode iteration's tokens, the key
        split only while ``gate`` (any slot live) holds."""
        return sample_step(logits, key, temperature=self.scfg.temperature,
                           gate=gate)

    def _spec_sample(self, logits, key, gate):
        """The speculative window's ``sample_fn``: a target a chunk
        position, the key split draft_len + 2 ways a live round."""
        return spec_sample_step(logits, key, temperature=self.scfg.temperature,
                                gate=gate)

    def _sample(self, logits, poison=None) -> Tuple[np.ndarray, np.ndarray]:
        """Sampled tokens (the key carry advanced once, unless greedy) plus
        a per-row flag for logits with no finite value (failed instead of
        emitted), in one download.  ``poison`` (slots,) bool, the injector's
        mask, turns its rows to NaN on the device first (engine.py:166)."""
        if poison is not None:
            logits = torch.where(self._dev(poison)[:, None], torch.nan, logits)
        bad = ~torch.isfinite(logits).any(dim=-1)
        tok, self._key = sample_step(logits, self._key,
                                     temperature=self.scfg.temperature)
        both = torch.stack([tok, bad.to(torch.int32)]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.array(a), device=self.device)

    def _decode(self, feed: np.ndarray, live: np.ndarray, poison=None):
        logits, self.cache = lm.decode_step(
            self.params, self.cfg, self._fresh_cache(), self._dev(feed),
            self._dev(self.pos), live=self._dev(live))
        return self._sample(logits, poison)

    def _prefill(self, toks: np.ndarray, lens: np.ndarray, poison=None):
        logits, self.cache = lm.prefill_step(
            self.params, self.cfg, self._fresh_cache(), self._dev(toks),
            self._dev(self.pos), self._dev(lens))
        return self._sample(logits, poison)

    # -- per-tick step --------------------------------------------------
    def _gen_ready(self, s: int) -> bool:
        """Slot ``s`` is in steady generation: its next feed is its last
        known token and every later feed a model output, the work the
        device-resident loop runs without the host (engine.py:904)."""
        req = self.slot_req[s]
        if self.prefill_mode == "chunked" and self.slot_state[s] != "gen":
            return False
        return req._cursor == len(req.prompt) + len(req.output) - 1  # type: ignore[attr-defined]

    def step(self) -> int:
        """One engine tick (one host dispatch).  Replay mode: one batched
        decode step.  Chunked mode: one decode step for the generating slots
        plus prompt chunks for prefilling slots, together bounded by
        ``token_budget``.  Cancellations and deadlines are honoured before
        the dispatch; with ``ServeConfig.audit`` the invariant auditor runs
        after it.  Returns #active slots."""
        self._sweep_lifecycle()
        n = self._step_inner()
        if self.scfg.audit:
            self.audits_run += 1
            audit_engine(self)
        return n

    def _step_inner(self) -> int:
        self._admit()
        if self.tables is not None:
            for s in range(self.scfg.slots):
                if self.slot_req[s] is not None:
                    self._grow(s)
            self._admit()  # preemption may have freed blocks for the queue head
        active = [s for s in range(self.scfg.slots) if self.slot_req[s] is not None]
        if not active:
            if self.queue and self.admission_open:
                # every queued request is waiting out a retry backoff: the
                # clock must still advance or backoffs would never expire
                self.steps_run += 1
            return 0
        self.dispatches += 1
        all_gen = all(self._gen_ready(s) for s in active)
        spec_ok = self.spec_proposer is not None and all_gen
        window_ok = self.sync_every > 1 and all_gen
        if self.injector is not None and self.injector.pending("poison"):
            # poison faults land per tick, where per-row detection runs
            # (engine.py:953-958); the spec window has its own site
            spec_ok = window_ok = False
        if spec_ok:
            done = self._step_spec_window(active)
            if done is not None:
                return done
            self.spec_fallbacks += 1  # no headroom / grant denied
            # the preamble's guard may have FAILed a slot: the plain window
            # reads every slot it is given (the reference passes the stale
            # list on and raises there, ROADMAP Queue 3)
            active = [s for s in active if self.slot_req[s] is not None]
            window_ok = window_ok and bool(active)
        if window_ok:
            done = self._step_window(active)
            if done is not None:
                return done
            self.window_fallbacks += 1  # pool too tight for grow-ahead
        if self.prefill_mode == "chunked":
            return self._step_chunked(active)
        return self._step_replay(active)

    # -- device-resident multi-step window ------------------------------
    def _grant_window(self, active: List[int], spans: Dict[int, int]) -> bool:
        """All-or-nothing grow-ahead (engine.py:973): every active slot gets
        pages covering its worst-case window span (``spans[s]`` tokens past
        its position, never past ``max_len``).  On any shortfall the grant
        rolls back exactly (each slot trimmed to its pre-grant block count,
        the table-dirty flag restored) and the boundary falls back to a
        per-tick step.  The grant never preempts."""
        if self.injector is not None and self.injector.fire("grant"):
            return False  # injected grant failure (engine.py:983)
        pre = {s: self.tables.num_blocks(s) for s in active}
        dirty_before = self._tables_dirty
        for s in active:
            req = self.slot_req[s]
            target = min(int(self.pos[s]) + spans[s], self.scfg.max_len)
            if not self._ensure_with_evict(s, target, req.uid):
                ps = self.pool.page_size
                for t in active:
                    self.tables.trim(t, pre[t] * ps)
                self._tables_dirty = dirty_before
                return False
        return True

    def _prepare_window(self, active: List[int],
                        spans: Dict[int, int]) -> bool:
        """The window's preamble (engine.py:998): grow-ahead grant,
        copy-on-write over the whole write span, and the dispatch guard over
        the grown tables.  On any failure the grow-ahead is given back
        (survivors trimmed to ``pos + 1``) and the caller falls back to a
        per-tick step.  The contiguous mode has nothing to prepare."""
        if self.tables is None:
            return True
        if not self._grant_window(active, spans):
            return False
        pairs: List[Tuple[int, int]] = []
        try:
            for s in active:
                target = min(int(self.pos[s]) + spans[s], self.scfg.max_len)
                last = max(int(self.pos[s]), target - 1)
                self._cow_range(s, last, protect=frozenset(active), out=pairs)
        except PoolExhausted:
            # apply the copies already repointed, give back the grow-ahead
            # and fall back: the per-tick path's COW failure preempts
            self._apply_cow(pairs)
            self._trim_to_pos(active)
            return False
        self._apply_cow(pairs)
        work = [(s, spans[s]) for s in active]
        if len(self._guard_work(work)) != len(work):
            # the guard FAILed the blamed slot(s); the survivors' next path
            # re-checks its own trimmed dispatch
            self._trim_to_pos(active)
            return False
        return True

    def _trim_to_pos(self, slots: List[int]):
        """Return each live slot's unused grow-ahead pages (keeping the next
        write), so boundary admission and preemption see the pool a per-tick
        engine would."""
        if self.tables is None:
            return
        for s in slots:
            if self.slot_req[s] is not None:
                if self.tables.trim(s, int(self.pos[s]) + 1):
                    self._tables_dirty = True

    def _window_inputs(self, active: List[int]):
        """Each slot's feed (its last known token), live flag and token
        allowance for a multi-step window over the ``active`` slots."""
        b = self.scfg.slots
        feed = np.zeros((b,), np.int32)
        live = np.zeros((b,), bool)
        rem = np.zeros((b,), np.int32)
        for s in active:
            req = self.slot_req[s]
            feed[s] = (req.prompt + req.output)[req._cursor]  # type: ignore[attr-defined]
            live[s] = True
            limit = req.max_new_tokens or self.scfg.max_new_tokens
            rem[s] = limit - len(req.output)
        return feed, live, rem

    def _step_window(self, active: List[int]) -> Optional[int]:
        """Up to ``sync_every`` decode ticks in one dispatch
        (engine.py:1042).  Feed, positions, stop flags and emitted tokens
        stay on the device through ``lm.decode_loop``; the host uploads one
        feed vector and downloads one token buffer.  Returns #active slots,
        or ``None`` when the pool cannot cover the worst-case window (the
        caller falls back to a per-tick step)."""
        feed, live, rem = self._window_inputs(active)
        # clamp the window to the slots' host-known spans (token allowance
        # and max_len headroom) by halving, as the reference does: iterations
        # past every slot's stop would burn full-batch decode steps and delay
        # the next boundary's admission
        n = self.sync_every
        max_span = max(min(int(rem[s]), self.scfg.max_len - int(self.pos[s]))
                       for s in active)
        while n // 2 >= max_span:
            n //= 2
        spans = {s: min(n, int(rem[s]) + 1) for s in active}
        if not self._prepare_window(active, spans):
            return None
        toks, emitted, self._key = lm.decode_loop(
            self.params, self.cfg, self._fresh_cache(), self._dev(feed),
            self._dev(self.pos), self._key, self._dev(live), self._dev(rem),
            n_steps=n, sample_fn=self._window_sample, eos_id=self.scfg.eos_id,
            max_len=self.scfg.max_len)
        self.decode_windows += 1
        both = torch.cat([toks, emitted.to(torch.int32)]).cpu().numpy()
        toks, emitted = both[:n], both[n:].astype(bool)
        # drain: replay each in-window tick through the host bookkeeping the
        # per-tick path runs, so requests, tick counts and EOS recycling stay
        # identical to per-tick stepping
        for t in range(n):
            row = emitted[t]
            if not row.any():
                break  # every slot stopped; later rows are all False too
            for s in active:
                if not row[s]:
                    continue
                req = self.slot_req[s]
                self.pos[s] += 1
                req._cursor += 1  # type: ignore[attr-defined]
                self._emit_token(s, req, int(toks[t, s]))
            self.tick_tokens.append(int(row.sum()))
            self.steps_run += 1
        self._trim_to_pos(active)
        return len(active)

    # -- speculative draft-verify window --------------------------------
    def _step_spec_window(self, active: List[int]) -> Optional[int]:
        """Up to ``sync_every`` draft-verify rounds in one dispatch
        (engine.py:1115, ``lm.spec_decode_loop``).  Each round's verify chunk
        writes ``draft_len + 1`` positions through the block tables, so the
        grow-ahead covers a slot's worst case, ``n * (draft_len + 1)``
        tokens capped by its allowance plus one round's draft tail; rejected
        tails stay behind the position carry and ``trim`` returns their
        pages at the boundary.  Returns #active slots, or ``None`` when a
        slot lacks ``max_len`` headroom for even one round or the grant /
        COW / guard preamble declines (the caller falls back to the plain
        window or a per-tick step, byte-identical by construction)."""
        scfg = self.scfg
        k = scfg.draft_len
        c = k + 1
        b = scfg.slots
        feed, live, rem = self._window_inputs(active)

        def span(s: int, n: int) -> int:
            # furthest write over n rounds: each chunk lands c positions from
            # the slot's position, and a live round commits at least one
            return min(n * c, int(rem[s]) + k)

        # halve the rounds to the emission spans, then until every slot's
        # worst-case chunk write fits under max_len (a verify chunk writes
        # ahead of what it commits, so headroom is a precondition)
        n = self.sync_every
        max_rounds = max(
            -(-min(int(rem[s]), scfg.max_len - int(self.pos[s])) // c)
            for s in active
        )
        while n // 2 >= max_rounds:
            n //= 2
        while n > 1 and any(
            int(self.pos[s]) + span(s, n) > scfg.max_len for s in active
        ):
            n //= 2
        if any(int(self.pos[s]) + span(s, n) > scfg.max_len for s in active):
            return None  # a slot within c of max_len: the plain path ends it
        spans = {s: span(s, n) for s in active}
        if not self._prepare_window(active, spans):
            return None

        hist = np.zeros((b, scfg.max_len), np.int32)
        for s in active:
            req = self.slot_req[s]
            toks = req.prompt + req.output
            hist[s, : len(toks)] = toks
        poison = self._poison_mask(active, site="spec_poison")
        toks, emitted, bad, self._key = lm.spec_decode_loop(
            self.params, self.cfg, self._fresh_cache(), self._dev(feed),
            self._dev(self.pos), self._key, self._dev(live), self._dev(rem),
            self._dev(hist), n_rounds=n, draft_len=k,
            propose_fn=lm.DRAFT_PROPOSERS[self.spec_proposer],
            sample_fn=self._spec_sample, accept_fn=spec_accept,
            eos_id=scfg.eos_id, max_len=scfg.max_len,
            poison=None if poison is None else self._dev(poison))
        self.spec_windows += 1
        flat = torch.cat([toks.flatten(), emitted.flatten().to(torch.int32),
                          bad.flatten().to(torch.int32)]).cpu().numpy()
        m = n * b * c
        toks = flat[:m].reshape(n, b, c)
        emitted = flat[m:2 * m].reshape(n, b, c).astype(bool)
        bad = flat[2 * m:].reshape(n, b).astype(bool)
        # drain: replay each round through the per-tick path's bookkeeping;
        # the emit masks already hold acceptance, EOS, the allowance and
        # max_len, so _emit_token stops on exactly the tokens they deliver
        for t in range(n):
            row = emitted[t]
            rbad = bad[t]
            if not row.any() and not rbad.any():
                break  # every slot stopped; later rounds are dead too
            self.spec_rounds += 1
            for s in active:
                req = self.slot_req[s]
                if req is None:
                    continue
                if rbad[s]:
                    self.poisoned_rows += 1
                    self._terminate(
                        req, FAILED, slot=s,
                        error="poisoned verify logits (no finite value)")
                    continue
                if not row[s].any():
                    continue
                acc = int(row[s].sum()) - 1  # drafts accepted this round
                self.spec_proposed += k
                self.spec_accepted += acc
                if acc == 0:
                    self.spec_all_rejected += 1
                for i in range(c):
                    if not row[s, i]:
                        continue
                    self.pos[s] += 1
                    req._cursor += 1  # type: ignore[attr-defined]
                    self._emit_token(s, req, int(toks[t, s, i]))
                    if req.done:
                        break
            self.tick_tokens.append(int(row.sum()))
            self.steps_run += 1
        # rejected draft tails sit in pages past pos under the grow-ahead
        # grant; trim reclaims them with the unused grant
        self._trim_to_pos(active)
        return len(active)

    # -- prefix-cache bookkeeping ---------------------------------------
    def _register_prefix(self, s: int, req: Request):
        """Publish the slot's full prompt pages into the prefix index once
        prefill completes; pages already cached elsewhere are repointed to
        the canonical copy so the duplicate recycles."""
        if self.prefix is None or getattr(req, "_prefix_done", False):
            return
        req._prefix_done = True  # type: ignore[attr-defined]
        ps = self.pool.page_size
        n_pages = min(len(req.prompt) // ps, self.tables.num_blocks(s))
        if n_pages <= 0:
            return
        pages = self.tables.blocks(s)[:n_pages]
        for idx, cached in self.prefix.insert(req.prompt[: n_pages * ps], pages):
            self.tables.repoint(s, idx, cached)
            self.pages_deduped += 1
            self._tables_dirty = True

    def _cow_range(self, s: int, last_pos: int,
                   protect: frozenset = frozenset(),
                   out: Optional[List[Tuple[int, int]]] = None,
                   ) -> List[Tuple[int, int]]:
        """Copy-on-write guard for the pages slot ``s`` may write this
        dispatch (positions ``pos[s]..last_pos``): shared pages are swapped
        for fresh private copies and the (src, dst) pairs returned for the
        device copy.  Exhaustion tries prefix-cache eviction, then
        preempting a victim outside ``protect | {s}``, then raises."""
        pairs = out if out is not None else []
        ps = self.pool.page_size
        req = self.slot_req[s]
        first = int(self.pos[s]) // ps
        last = min(last_pos // ps, self.tables.num_blocks(s) - 1)
        for pidx in range(first, last + 1):
            while True:
                try:
                    pair = self.tables.ensure_writable(s, pidx, req.uid)
                    break
                except PoolExhausted:
                    if self._reclaim(1):
                        continue
                    victim = self._pick_victim(exclude=protect | {s})
                    if victim is None:
                        raise
                    self._preempt(victim)
            if pair:
                pairs.append(pair)
        return pairs

    def _cow_or_preempt(self, work: List[Tuple[int, int]],
                        ) -> Tuple[List[int], List[Tuple[int, int]]]:
        """Run the COW gate for each ``(slot, last_pos)`` about to be
        dispatched; a slot whose copy cannot be satisfied is preempted and
        dropped.  Returns (surviving slots, device copy pairs)."""
        dispatch = frozenset(s for s, _ in work)
        survivors: List[int] = []
        pairs: List[Tuple[int, int]] = []
        for s, last in work:
            if self.slot_req[s] is None:
                continue  # became a victim earlier in this loop
            try:
                local = self._cow_range(s, last, protect=dispatch)
            except PoolExhausted:
                self._preempt(s)  # recompute resume replays it cleanly
                continue
            survivors.append(s)
            pairs += local
        return survivors, pairs

    def _poison_mask(self, rows: List[int],
                     site: str = "poison") -> Optional[np.ndarray]:
        """(slots,) bool, the rows the injector poisons this dispatch
        (``site``: "poison" for per-tick logits, "spec_poison" for the
        speculative window's verify logits), or None with no injector.  A
        due fault targets ``fault.slot`` mod the dispatched rows
        (engine.py:1325)."""
        if self.injector is None:
            return None
        mask = np.zeros((self.scfg.slots,), bool)
        while rows:
            f = self.injector.fire(site)
            if f is None:
                break
            mask[rows[f.slot % len(rows)]] = True
        return mask

    def _fire_table_corrupt(self, work: List[Tuple[int, int]]):
        """Due ``table_corrupt`` faults overwrite one block-table entry of a
        dispatched slot: the page backing its write position, inside both
        the guarded live prefix and the write range (engine.py:1342).
        Corruption fires whether or not guards are on (with guards off the
        auditor notices the row diverging from the ledger).  Flavors cycle:
        out-of-range id, reserved page 0, another dispatched row's page."""
        if self.injector is None or self.tables is None or not work:
            return
        ps = self.pool.page_size
        out_of_range = self.pool.base + self.pool.num_blocks + 5
        while True:
            f = self.injector.fire("table_corrupt")
            if f is None:
                break
            s, n = work[f.slot % len(work)]
            j = max(0, -(-(int(self.pos[s]) + n) // ps) - 1)
            mode = self._corrupt_mode % 3
            self._corrupt_mode += 1
            if mode == 0:
                bad = out_of_range
            elif mode == 1:
                bad = 0  # the reserved sink page inside the live prefix
            else:
                other = next((t for t, _ in work if t != s
                              and self.tables.num_blocks(t) > 0), None)
                bad = (self.tables.blocks(other)[0]
                       if other is not None else out_of_range)
            self.tables.poke(s, j, bad)
            self._tables_dirty = True
            self.table_corruptions += 1

    def _guard_work(self, work: List[Tuple[int, int]],
                    ) -> List[Tuple[int, int]]:
        """Discharge the kernels' runtime obligations for the ``(slot,
        n_tokens)`` pairs about to dispatch, after any due table corruption
        fired.  A violating slot FAILs through ``_terminate`` and is
        dropped; the survivors proceed untouched."""
        if self.tables is None or not work:
            return work
        self._fire_table_corrupt(work)
        if not self.scfg.guards:
            return work
        rows = []
        for s, n in work:
            p = int(self.pos[s])
            rows.append((s, p + n, p, p + n))
        try:
            guard_dispatch(
                self.tables.tables(),
                self.pool.base + self.pool.num_blocks,
                self.pool.page_size, rows,
            )
        except GuardError as e:
            blamed = sorted({row for row, _, _ in e.violations})
            detail = {row: f"{kind}: {msg}"
                      for row, kind, msg in reversed(e.violations)}
            for s in blamed:
                req = self.slot_req[s]
                if req is None:
                    continue
                self.guard_failures += 1
                self._terminate(req, FAILED, slot=s,
                                error=f"dispatch guard: {detail[s]}")
            dead = set(blamed)
            return [(s, n) for s, n in work if s not in dead]
        return work

    def _apply_cow(self, pairs: List[Tuple[int, int]]):
        """Run the device-side page copies for COW repoints."""
        if not pairs:
            return
        self.pages_copied += len(pairs)
        self._tables_dirty = True
        src, dst = zip(*pairs)
        lm.copy_pages(self.cache, list(src), list(dst))

    # -- per-tick paths -------------------------------------------------
    def _step_replay(self, active: List[int]) -> int:
        if self.tables is not None:
            active, pairs = self._cow_or_preempt(
                [(s, int(self.pos[s])) for s in active]
            )
            self._apply_cow(pairs)
            active = [s for s, _ in self._guard_work([(s, 1) for s in active])]
            if not active:
                self.dispatches -= 1  # nothing actually dispatched
                return 0
        feed = np.zeros((self.scfg.slots,), np.int32)
        live = np.zeros((self.scfg.slots,), bool)
        full_len: Dict[int, int] = {}
        for s in active:
            req = self.slot_req[s]
            cur = req._cursor  # type: ignore[attr-defined]
            np_ = len(req.prompt)
            full_len[s] = np_ + len(req.output)
            feed[s] = (
                req.prompt[cur] if cur < np_ else req.output[cur - np_]
            )
            live[s] = True
        next_tok, bad = self._decode(feed, live, self._poison_mask(active))
        for s in active:
            req = self.slot_req[s]
            cur = req._cursor  # type: ignore[attr-defined]
            self.pos[s] += 1
            req._cursor = cur + 1  # type: ignore[attr-defined]
            if bad[s]:
                self.poisoned_rows += 1
                self._terminate(req, FAILED, slot=s,
                                error="poisoned logits row (no finite value)")
                continue
            if cur + 1 >= full_len[s]:  # this step produced a real token
                self._register_prefix(s, req)
                self._emit_token(s, req, int(next_tok[s]))
        self.tick_tokens.append(len(active))
        self.steps_run += 1
        return len(active)

    def _step_chunked(self, active: List[int]) -> int:
        """One token-budget tick: decode for generating slots + prompt
        chunks for prefilling slots (oldest admitted first) within the
        leftover budget."""
        gen = [s for s in active if self.slot_state[s] == "gen"]
        pending = []
        for s in active:
            if self.slot_state[s] != "prefill":
                continue
            req = self.slot_req[s]
            remaining = len(req.prompt) + len(req.output) - req._cursor  # type: ignore[attr-defined]
            pending.append((s, req._admit_seq, remaining))  # type: ignore[attr-defined]
        chunk_lens = plan_prefill_chunks(
            self.token_budget, len(gen), pending, self.prefill_chunk
        )

        if gen and self.tables is not None:
            gen, pairs = self._cow_or_preempt(
                [(s, int(self.pos[s])) for s in gen]
            )
            self._apply_cow(pairs)
            gen = [s for s, _ in self._guard_work([(s, 1) for s in gen])]
        if gen:
            feed = np.zeros((self.scfg.slots,), np.int32)
            live = np.zeros((self.scfg.slots,), bool)
            for s in gen:
                req = self.slot_req[s]
                feed[s] = req.output[-1]
                live[s] = True
            next_tok, bad = self._decode(feed, live, self._poison_mask(gen))
            for s in gen:
                req = self.slot_req[s]
                self.pos[s] += 1
                req._cursor += 1  # type: ignore[attr-defined]
                if bad[s]:
                    self.poisoned_rows += 1
                    self._terminate(
                        req, FAILED, slot=s,
                        error="poisoned logits row (no finite value)")
                    continue
                self._emit_token(s, req, int(next_tok[s]))

        # COW during the gen dispatch may have preempted a prefilling slot
        chunk_lens = {s: n for s, n in chunk_lens.items()
                      if self.slot_req[s] is not None}
        if chunk_lens and self.tables is not None:
            ok, pairs = self._cow_or_preempt(
                [(s, int(self.pos[s]) + n - 1) for s, n in chunk_lens.items()]
            )
            chunk_lens = {s: chunk_lens[s] for s in ok}
            self._apply_cow(pairs)
            chunk_lens = dict(self._guard_work(list(chunk_lens.items())))
        if chunk_lens:
            width = self.prefill_chunk
            toks = np.zeros((self.scfg.slots, width), np.int32)
            lens = np.zeros((self.scfg.slots,), np.int32)
            for s, n in chunk_lens.items():
                req = self.slot_req[s]
                cur = req._cursor  # type: ignore[attr-defined]
                replay = (req.prompt + req.output)[cur : cur + n]
                toks[s, :n] = replay
                lens[s] = n
            ptok, pbad = self._prefill(toks, lens,
                                       self._poison_mask(sorted(chunk_lens)))
            for s, n in chunk_lens.items():
                req = self.slot_req[s]
                self.pos[s] += n
                req._cursor += n  # type: ignore[attr-defined]
                if pbad[s]:
                    self.poisoned_rows += 1
                    self._terminate(
                        req, FAILED, slot=s,
                        error="poisoned logits row (no finite value)")
                    continue
                if req._cursor >= len(req.prompt) + len(req.output):  # type: ignore[attr-defined]
                    # the chunk reached the end of the replay stream: its
                    # last live logits produce the next real token
                    self.slot_state[s] = "gen"
                    self._register_prefix(s, req)
                    self._emit_token(s, req, int(ptok[s]))

        self.tick_tokens.append(len(gen) + sum(chunk_lens.values()))
        self.steps_run += 1
        return len(active)

    def run(self, max_steps: int = 10_000) -> List[Request]:
        """Drive until queue + slots drain (or step budget)."""
        for _ in range(max_steps):
            if self.step() == 0 and not self.queue:
                break
        return self.completed

    # -- lifecycle: drain / shutdown (engine.py:1589-1619) ----------------
    def drain(self, max_steps: int = 10_000) -> List[Request]:
        """Stop admission and finish every request already holding a slot.
        Queued requests stay queued; afterwards the pool holds only
        prefix-cache pages (reopen intake by setting ``admission_open``)."""
        self.admission_open = False
        for _ in range(max_steps):
            if self.step() == 0:
                break
        return self.completed

    def shutdown(self) -> List[Request]:
        """Drain in-flight work, cancel everything still queued, and flush
        the prefix index: afterwards the pool holds zero allocated blocks."""
        self.drain()
        for s in range(self.scfg.slots):
            req = self.slot_req[s]
            if req is not None:  # drain ran out of its step budget
                self._terminate(req, CANCELLED, slot=s,
                                error="engine shutdown")
        while self.queue:
            self._terminate(self.queue.popleft(), CANCELLED,
                            error="engine shutdown")
        if self.prefix is not None:
            self.prefix.flush()
            self._tables_dirty = True
        if self.scfg.audit:
            self.audits_run += 1
            audit_engine(self)
        return self.completed

    # -- crash-safe persistence (engine.py:1622-1720) --------------------
    def snapshot(self, path: Optional[str] = None) -> dict:
        """The prefix-cache radix index and the KV contents of its pages:
        the warm state a restart would otherwise lose.  In-flight slots are
        not captured (requests are re-submittable).  Returns the snapshot
        dict; ``path`` also pickles it there.  Page contents are numpy
        arrays, a bf16 pool's as its raw 16-bit patterns, with their dtype
        names under ``"leaf_dtypes"``."""
        if self.prefix is None:
            raise ValueError(
                "snapshot() needs the prefix cache enabled "
                "(paged cache + an attention family)")
        entries = self.prefix.export()
        snap = {
            "format": SNAPSHOT_FORMAT,
            "model": self.cfg.name,
            "page_size": self.pool.page_size,
            "kv_dtype": self.cfg.kv_dtype,
            "nodes": [(parent, list(blk)) for parent, blk, _ in entries],
            "leaves": lm.gather_pages(self.cache,
                                      [page for _, _, page in entries]),
            "leaf_dtypes": [name for _, name in lm.page_leaf_shapes(self.cache)],
        }
        if path is not None:
            with open(path, "wb") as f:
                pickle.dump(snap, f)
        return snap

    def load_snapshot(self, snap) -> int:
        """Graft a snapshot's cached page chains into this engine (normally
        a fresh one: :meth:`restore`).  A model, page size, kv dtype or page
        layout that differs is a loud ``ValueError``.  When the pool is
        smaller than the snapshot, the longest chain prefixes that fit are
        restored.  Returns the pages restored."""
        if not isinstance(snap, dict):
            with open(snap, "rb") as f:
                snap = pickle.load(f)
        if self.prefix is None:
            raise ValueError("load_snapshot() needs the prefix cache enabled")
        if snap.get("format") != SNAPSHOT_FORMAT:
            raise ValueError(
                f"unknown snapshot format {snap.get('format')!r} "
                f"(this engine writes {SNAPSHOT_FORMAT})")
        for field, mine in (("model", self.cfg.name),
                            ("page_size", self.pool.page_size),
                            ("kv_dtype", self.cfg.kv_dtype)):
            if snap[field] != mine:
                raise ValueError(
                    f"snapshot {field}={snap[field]!r} does not match "
                    f"engine {field}={mine!r}")
        names = snap.get("leaf_dtypes") or [str(a.dtype) for a in snap["leaves"]]
        want = [(tuple(a.shape[1:]), name)
                for a, name in zip(snap["leaves"], names)]
        if want != lm.page_leaf_shapes(self.cache):
            raise ValueError(
                "snapshot page-pool layout does not match this engine's "
                "cache (different reduced config or leaf set)")
        phys: Dict[int, int] = {}
        keep: List[int] = []
        for i, (parent, _blk) in enumerate(snap["nodes"]):
            if parent >= 0 and parent not in phys:
                continue  # ancestor skipped (pool ran short): skip the chain
            if not self.pool.free:
                continue  # partial restore: the longest prefixes that fit
            phys[i] = self.pool.alloc(owner="prefix-snapshot")
            keep.append(i)
        if keep:
            lm.scatter_pages(self.cache, [phys[i] for i in keep],
                             [np.asarray(a)[keep] for a in snap["leaves"]])
            local = {i: j for j, i in enumerate(keep)}
            entries = []
            for i in keep:
                parent, blk = snap["nodes"][i]
                entries.append((local[parent] if parent >= 0 else -1,
                                tuple(blk), phys[i]))
            self.prefix.import_nodes(entries)
        return len(keep)

    @classmethod
    def restore(cls, cfg: ModelConfig, params, serve_cfg: ServeConfig, snap,
                injector: Optional[FaultInjector] = None, *,
                device="cuda") -> "ServingEngine":
        """Crash-safe restart: a fresh engine pre-warmed with a
        ``snapshot()``'s radix index and page contents, so a warm-prefix
        request hits the cache at once."""
        eng = cls(cfg, params, serve_cfg, injector=injector, device=device)
        eng.load_snapshot(snap)
        return eng

    # -- accounting -----------------------------------------------------
    def kv_cache_bytes(self) -> int:
        """Bytes held by the KV page pools or strips and the recurrent
        state."""
        return self.cache.kv_bytes()

    def peak_kv_blocks(self) -> Optional[int]:
        return None if self.pool is None else self.pool.peak_in_use
