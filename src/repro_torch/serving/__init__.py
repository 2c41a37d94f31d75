"""Serving of the port: paged KV bookkeeping, greedy sampling and the
continuous-batching engine (per-tick path and multi-step decode window,
fp or quantized KV pages)."""
from .engine import Request, ServeConfig, ServingEngine, plan_prefill_chunks
from .paged_cache import BlockPool, PoolExhausted, PrefixCache, SlotTables

__all__ = [
    "BlockPool", "PoolExhausted", "PrefixCache", "Request", "ServeConfig",
    "ServingEngine", "SlotTables", "plan_prefill_chunks",
]
