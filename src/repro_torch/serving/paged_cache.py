"""Paged KV cache bookkeeping: refcounted block pool, per-slot block tables
with copy-on-write, and the prefix-cache radix index.

The port's copy of ``repro.serving.paged_cache``, near verbatim: it is
numpy-only host logic, and importing the reference module would import JAX
(through ``repro/serving/__init__.py``).  The ``injector`` hook of
:class:`BlockPool` stays for parity; the port's engine does not pass one yet
(ROADMAP Queue 1 item 11).

The vLLM insight applied to the tile model: the KV cache is a pool of
fixed-size **blocks** (pages) of ``page_size`` tokens, and each request owns
an ordered list of physical blocks — its *block table* — instead of a
contiguous ``max_len`` strip.  Memory then scales with the tokens actually
resident, not ``slots x max_len``; admission/preemption decisions reduce to
free-block counting.

Blocks are **refcounted** so N slot tables (and the prefix index) can share
one physical page: two block tables pointing at the same page *is* the
sharing mechanism — the table-directed gather in the paged kernels needs no
change at all.  ``release`` decrements; a block recycles when its count
hits zero.  A slot that must write into a shared page first goes through
:meth:`SlotTables.ensure_writable` — **copy-on-write**: it gets a fresh
page, the caller copies the shared contents device-side
(``models.lm.copy_pages``), and the table entry is repointed before the
step runs.

:class:`PrefixCache` is the SGLang-style radix index over token ids at page
granularity: full pages of prompt tokens map to chains of physical pages.
Chain keys are rolling hashes (``hash((parent_key, page_tokens))`` from a
per-model-config salted root) but child lookup is by the exact token block,
so a hash collision can never alias two different prefixes.  The index
holds one reference per cached page; eviction (LRU leaves first) only ever
reclaims pages with refcount 1 — pages no slot table references — so a hot
pool degrades gracefully to the uncached behavior instead of failing
admission.

Everything here is host-side (numpy/python) bookkeeping: allocation,
per-slot tables, the padded ``(slots, max_pages)`` int32 table tensor the
decode step consumes.  The device-side page pools live in the model cache
pytree (``models.lm.init_cache(layout="paged")``); the gather itself is the
``paged_attention`` kernel (or its XLA oracle) indexing pages through this
table.

Invariants (property-tested in tests/test_property.py):

* a block recycles exactly when its refcount reaches zero (alloc/retain/
  release conserve blocks — never leak, never free early);
* after a copy-on-write the written page is reachable from exactly one
  table;
* eviction never reclaims a page with refcount > 1;
* table entries beyond a slot's live length hold page 0 — a *valid* page id
  (the kernel DMAs padding pages and masks their contribution).
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Dict, FrozenSet, List, Optional, Sequence, Tuple

import numpy as np


class PoolExhausted(Exception):
    """No free blocks; caller should evict cached pages, preempt or queue."""


def blocks_for(num_tokens: int, page_size: int) -> int:
    """Blocks needed to hold ``num_tokens`` tokens (ceil division)."""
    return -(-num_tokens // page_size)


def blocks_for_bytes(budget_bytes: int, page_bytes: int) -> int:
    """Blocks a byte budget affords at ``page_bytes`` per block (floor).

    This is how a quantized cache converts its smaller per-page footprint
    into *capacity*: at a fixed byte budget, fewer bytes per page means more
    pages in the pool, which means later preemption under pressure.  Pair
    with :attr:`BlockPool.page_bytes` for accounting."""
    if page_bytes <= 0:
        raise ValueError("page_bytes must be positive")
    return int(budget_bytes) // int(page_bytes)


class BlockPool:
    """Fixed pool of refcounted KV blocks with owner tracking and peak
    accounting.

    ``alloc`` hands out a block at refcount 1; ``retain`` adds a reference
    (a second table, the prefix index); ``release`` drops one — the block
    returns to the free list only at zero.  ``in_use``/``peak_in_use``
    count *physical* blocks, not references: that is what admission and
    memory accounting care about.

    ``base`` offsets the physical ids handed out: the serving engine uses
    ``base=1`` so physical page 0 is never allocatable — it is the padding
    page that zeroed table rows (inactive slots, table tails) read from and
    inactive slots harmlessly write to.
    """

    def __init__(self, num_blocks: int, page_size: int, base: int = 0,
                 page_bytes: Optional[int] = None, injector=None):
        if num_blocks <= 0 or page_size <= 0:
            raise ValueError("num_blocks and page_size must be positive")
        # optional serving.faults.FaultInjector: when its schedule says so,
        # alloc() raises PoolExhausted exactly as a genuinely empty pool
        # would — chaos testing exercises every caller's rollback path
        self.injector = injector
        self.num_blocks = int(num_blocks)
        self.page_size = int(page_size)
        self.base = int(base)
        # bytes one physical page occupies across every pool leaf (packed
        # data + scales for quantized caches); purely advisory accounting
        # used by byte-budget sizing (``blocks_for_bytes``) and benchmarks
        self.page_bytes = None if page_bytes is None else int(page_bytes)
        # stack of free ids; reversed so .pop() hands out ascending ids first
        self._free: List[int] = list(
            range(base + self.num_blocks - 1, base - 1, -1)
        )
        self._ref: Dict[int, int] = {}
        self._owner: Dict[int, object] = {}
        self.peak_in_use = 0
        self.total_allocs = 0  # cumulative alloc() calls (sharing avoids them)

    # ------------------------------------------------------------------
    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def can_fit(self, num_tokens: int) -> bool:
        return self.free >= blocks_for(num_tokens, self.page_size)

    # ------------------------------------------------------------------
    def alloc(self, owner: object = None) -> int:
        if self.injector is not None and self.injector.fire("pool_alloc"):
            raise PoolExhausted("injected fault: pool_alloc")
        if not self._free:
            raise PoolExhausted(
                f"all {self.num_blocks} KV blocks in use"
            )
        blk = self._free.pop()
        self._ref[blk] = 1
        self._owner[blk] = owner
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self.total_allocs += 1
        return blk

    def retain(self, block: int) -> None:
        """Add a reference to an allocated block (page sharing)."""
        if block not in self._ref:
            raise ValueError(f"retain of free KV block {block}")
        self._ref[block] += 1

    def release(self, blocks: Sequence[int]) -> None:
        """Drop one reference per listed block; recycle at zero."""
        for blk in blocks:
            if blk not in self._ref:
                raise ValueError(f"double free of KV block {blk}")
            self._ref[blk] -= 1
            if self._ref[blk] == 0:
                del self._ref[blk]
                del self._owner[blk]
                self._free.append(blk)

    def refcount(self, block: int) -> int:
        return self._ref.get(block, 0)

    def owner_of(self, block: int) -> object:
        return self._owner.get(block)


@dataclasses.dataclass
class SlotTables:
    """Per-slot block lists + the padded device table tensor.

    ``tables()`` returns the ``(slots, max_pages)`` int32 array the decode
    step consumes; unowned entries point at page 0 (valid but masked).

    Sharing-aware operations: :meth:`attach` installs already-filled pages
    (cache hits) into a slot's table, :meth:`repoint` swaps one entry for a
    deduplicated twin, and :meth:`ensure_writable` is the copy-on-write
    gate every write path runs before touching a page.
    """

    pool: BlockPool
    slots: int
    max_pages: int

    def __post_init__(self):
        self._blocks: List[List[int]] = [[] for _ in range(self.slots)]
        self._np = np.zeros((self.slots, self.max_pages), np.int32)

    # ------------------------------------------------------------------
    def blocks(self, slot: int) -> List[int]:
        return list(self._blocks[slot])

    def num_blocks(self, slot: int) -> int:
        return len(self._blocks[slot])

    def ensure_capacity(self, slot: int, num_tokens: int, owner=None) -> int:
        """Grow ``slot``'s table to hold ``num_tokens`` tokens.

        Returns the number of blocks newly allocated.  Raises
        :class:`PoolExhausted` (allocating nothing) when the pool cannot
        cover the growth — the scheduler's preemption trigger.
        """
        need = blocks_for(num_tokens, self.pool.page_size)
        if need > self.max_pages:
            raise ValueError(
                f"slot {slot}: {num_tokens} tokens need {need} blocks "
                f"> max_pages={self.max_pages}"
            )
        have = len(self._blocks[slot])
        grow = need - have
        if grow <= 0:
            return 0
        if self.pool.free < grow:
            raise PoolExhausted(
                f"slot {slot} needs {grow} blocks, pool has {self.pool.free}"
            )
        got: List[int] = []
        try:
            for _ in range(grow):
                blk = self.pool.alloc(owner)
                got.append(blk)
                self._blocks[slot].append(blk)
                self._np[slot, len(self._blocks[slot]) - 1] = blk
        except PoolExhausted:
            # an injected alloc fault can fire past the free-count
            # pre-check above: roll back so the allocate-nothing contract
            # holds however the failure arrived
            n = len(self._blocks[slot])
            del self._blocks[slot][n - len(got):]
            self._np[slot, n - len(got): n] = 0
            self.pool.release(got)
            raise
        return grow

    def attach(self, slot: int, pages: Sequence[int]) -> int:
        """Append already-filled ``pages`` (a prefix-cache hit) to ``slot``'s
        table, retaining each — the slot now co-owns them with whoever
        filled them.  Returns the number of pages attached."""
        blks = self._blocks[slot]
        if len(blks) + len(pages) > self.max_pages:
            raise ValueError(
                f"slot {slot}: attaching {len(pages)} pages onto "
                f"{len(blks)} exceeds max_pages={self.max_pages}"
            )
        for p in pages:
            self.pool.retain(p)
            blks.append(p)
            self._np[slot, len(blks) - 1] = p
        return len(pages)

    def repoint(self, slot: int, page_idx: int, page: int) -> None:
        """Swap the entry at ``page_idx`` for ``page`` (dedup: an identical
        page already cached elsewhere).  Retains the new page, drops the
        slot's reference on the old one."""
        old = self._blocks[slot][page_idx]
        if old == page:
            return
        self.pool.retain(page)
        self.pool.release([old])
        self._blocks[slot][page_idx] = page
        self._np[slot, page_idx] = page

    def ensure_writable(self, slot: int, page_idx: int,
                        owner=None) -> Optional[Tuple[int, int]]:
        """Copy-on-write gate: make the page at ``page_idx`` exclusively
        ``slot``'s before a write lands in it.

        A page referenced only by this table (refcount 1) is already
        writable — returns ``None``.  A shared page gets a fresh block, the
        table entry is repointed, and ``(src, dst)`` is returned: the
        caller must copy page ``src`` onto ``dst`` device-side
        (``models.lm.copy_pages``) *before* dispatching the step, then
        re-upload the table.  Raises :class:`PoolExhausted` when no fresh
        block is available (the caller may evict cached pages and retry)."""
        blk = self._blocks[slot][page_idx]
        if self.pool.refcount(blk) <= 1:
            return None
        fresh = self.pool.alloc(owner)
        self.pool.release([blk])
        self._blocks[slot][page_idx] = fresh
        self._np[slot, page_idx] = fresh
        return (blk, fresh)

    def trim(self, slot: int, num_tokens: int) -> int:
        """Release ``slot``'s blocks beyond those holding ``num_tokens``
        tokens (the multi-step engine's grow-ahead give-back: unused
        worst-case pages return to the pool at the sync boundary).  Returns
        the number of blocks dropped from the table (shared blocks survive
        under their remaining references)."""
        need = blocks_for(num_tokens, self.pool.page_size) if num_tokens > 0 else 0
        blks = self._blocks[slot]
        extra = blks[need:]
        if not extra:
            return 0
        self.pool.release(extra)
        del blks[need:]
        self._np[slot, need:] = 0
        return len(extra)

    def release_slot(self, slot: int) -> int:
        """Drop all of ``slot``'s references (EOS / preemption); unshared
        blocks return to the pool."""
        blks = self._blocks[slot]
        n = len(blks)
        self.pool.release(blks)
        self._blocks[slot] = []
        self._np[slot, :] = 0
        return n

    def tables(self) -> np.ndarray:
        return self._np.copy()

    def poke(self, slot: int, idx: int, value: int) -> int:
        """Chaos hook: overwrite one *device-table* entry without touching
        the block ledger (``_blocks`` stays truthful, so release paths and
        page conservation are unaffected).  Models a corrupted table upload
        — the dispatch guard is expected to catch the divergence before
        any kernel consumes it.  Returns the previous entry."""
        prev = int(self._np[slot, idx])
        self._np[slot, idx] = int(value)
        return prev

    def lookup(self, slot: int, pos: int) -> int:
        """Physical page holding token position ``pos`` of ``slot``."""
        page = pos // self.pool.page_size
        if page >= len(self._blocks[slot]):
            raise IndexError(
                f"slot {slot} pos {pos}: logical page {page} not allocated"
            )
        return self._blocks[slot][page]


# ---------------------------------------------------------------------------
# Prefix cache: radix index over token ids -> page chains
# ---------------------------------------------------------------------------


class _PrefixNode:
    """One full page of cached tokens: a radix-tree edge labelled by the
    page's token block, holding the physical page those tokens' KV lives
    in."""

    __slots__ = ("page", "key", "parent", "token_block", "children",
                 "last_use")

    def __init__(self, page, key, parent, token_block):
        self.page = page
        self.key = key
        self.parent = parent
        self.token_block = token_block
        self.children: Dict[tuple, "_PrefixNode"] = {}
        self.last_use = 0


class PrefixCache:
    """Radix index mapping token-id prefixes to chains of filled KV pages
    (SGLang's radix attention at page granularity).

    Nodes are whole pages: a prompt contributes ``len(prompt) //
    page_size`` nodes, each holding the physical page whose KV was computed
    from exactly that token prefix.  Node keys are rolling content hashes —
    ``hash((parent_key, page_tokens))`` seeded from a per-model-config salt
    — used as chain identity; child *lookup* is by the exact token block,
    so hash collisions can never alias two different prefixes.

    The index holds one pool reference per cached page (``retain`` on
    insert).  :meth:`match` returns the longest cached page chain for a
    prompt (LRU-touched), :meth:`insert` indexes freshly-filled pages and
    reports duplicates for the caller to absorb, and :meth:`evict` reclaims
    LRU leaf pages **only** when no slot table references them (pool
    refcount 1) — the graceful-degradation contract: a hot pool behaves
    like an uncached engine rather than refusing admission.
    """

    def __init__(self, pool: BlockPool, salt: tuple = ()):
        self.pool = pool
        self.page_size = pool.page_size
        root_key = hash(("prefix-root", tuple(salt)))
        self._root = _PrefixNode(None, root_key, None, None)
        self._clock = 0
        self.hits = 0
        self.lookups = 0
        self.insertions = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _blocks_of(self, tokens: Sequence[int]) -> List[tuple]:
        ps = self.page_size
        return [
            tuple(tokens[i * ps:(i + 1) * ps])
            for i in range(len(tokens) // ps)
        ]

    @property
    def pages(self) -> int:
        """Physical pages currently held by the index."""
        n, stack = 0, [self._root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            n += 1
        return n - 1  # root holds no page

    # ------------------------------------------------------------------
    def match(self, tokens: Sequence[int],
              max_pages: Optional[int] = None) -> List[int]:
        """Longest cached chain of full pages prefixing ``tokens`` (at most
        ``max_pages`` of them), LRU-touched.  Returns the physical page
        ids in logical order; the caller attaches them to a slot table
        (which takes the references) before any further allocation can
        evict them."""
        self.lookups += 1
        now = self._tick()
        node = self._root
        pages: List[int] = []
        blocks = self._blocks_of(tokens)
        if max_pages is not None:
            blocks = blocks[: max(0, max_pages)]
        for blk in blocks:
            child = node.children.get(blk)
            if child is None:
                break
            child.last_use = now
            pages.append(child.page)
            node = child
        if pages:
            self.hits += 1
        return pages

    def insert(self, tokens: Sequence[int],
               pages: Sequence[int]) -> List[Tuple[int, int]]:
        """Index ``pages`` — the physical pages now holding the full-page
        prefix of ``tokens`` — retaining each newly-indexed page.

        Content-hash dedup happens here: when a token block is already
        cached under a *different* physical page (two requests prefilled
        the same prompt concurrently), the existing page wins and ``(idx,
        cached_page)`` is reported so the caller can repoint its table and
        free its duplicate copy.  Idempotent for pages already indexed."""
        now = self._tick()
        node = self._root
        dups: List[Tuple[int, int]] = []
        for idx, blk in enumerate(self._blocks_of(tokens)[: len(pages)]):
            child = node.children.get(blk)
            if child is None:
                page = pages[idx]
                child = _PrefixNode(page, hash((node.key, blk)), node, blk)
                node.children[blk] = child
                self.pool.retain(page)
                self.insertions += 1
            elif child.page != pages[idx]:
                dups.append((idx, child.page))
            child.last_use = now
            node = child
        return dups

    def evict(self, want: int,
              protect: FrozenSet[int] = frozenset()) -> int:
        """Reclaim up to ``want`` cached pages, LRU leaves first, skipping
        ``protect`` (e.g. pages just matched but not yet attached) and any
        page a slot table still references (pool refcount > 1).  Returns
        pages freed.  Removing a leaf can expose its parent as the next
        candidate, so eviction walks chains tail-first — a prefix chain
        never loses an interior page while a descendant survives."""
        freed = 0
        while freed < want:
            leaves = []
            stack = [self._root]
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                if nd is not self._root and not nd.children:
                    if nd.page not in protect and \
                            self.pool.refcount(nd.page) == 1:
                        leaves.append(nd)
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_use)
            for nd in leaves:
                if freed >= want:
                    break
                del nd.parent.children[nd.token_block]
                self.pool.release([nd.page])
                self.evictions += 1
                freed += 1
        return freed

    # -- persistence (engine.snapshot / restore) ------------------------
    def export(self) -> List[Tuple[int, tuple, int]]:
        """Flatten the index to ``(parent, token_block, page)`` triples
        with parents strictly before children (parent ``-1`` = root) — the
        serializable half of the engine's ``snapshot()`` (the other half
        is the page *contents*, gathered from the device pools)."""
        out: List[Tuple[int, tuple, int]] = []
        index = {id(self._root): -1}
        queue = collections.deque([self._root])
        while queue:
            nd = queue.popleft()
            for child in nd.children.values():
                out.append((index[id(nd)], child.token_block, child.page))
                index[id(child)] = len(out) - 1
                queue.append(child)
        return out

    def import_nodes(self, entries: Sequence[Tuple[int, tuple, int]]) -> int:
        """Rebuild exported chains: each entry ``(parent, token_block,
        page)`` references an earlier entry by position (``-1`` = root) and
        hands the index a freshly-allocated page whose single reference the
        index takes over — the steady state a published prefill page
        reaches.  A token block already cached keeps its existing page and
        the caller's duplicate allocation is released.  Returns nodes
        added."""
        now = self._tick()
        nodes: Dict[int, _PrefixNode] = {-1: self._root}
        added = 0
        for i, (parent, blk, page) in enumerate(entries):
            pnode = nodes[parent]
            blk = tuple(blk)
            child = pnode.children.get(blk)
            if child is None:
                child = _PrefixNode(page, hash((pnode.key, blk)), pnode, blk)
                child.last_use = now
                pnode.children[blk] = child
                self.insertions += 1
                added += 1
            else:
                self.pool.release([page])
            nodes[i] = child
        return added

    def flush(self) -> int:
        """Drop the index's reference on every cached page and reset the
        tree (engine shutdown).  Pages a slot table still shares survive
        under their remaining references; the rest recycle immediately.
        Returns pages the index let go."""
        freed = 0
        stack = list(self._root.children.values())
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            self.pool.release([nd.page])
            freed += 1
        self._root.children = {}
        return freed
