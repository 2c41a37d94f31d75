"""Serving of the port: paged KV bookkeeping, sampling, the continuous-batching
engine (per-tick path, multi-step decode window, speculative decoding, fp or
quantized KV pages, or contiguous strips), and its fault injection and
invariant auditor (the names of ``repro.serving``)."""
from .engine import (
    TERMINAL,
    Request,
    ServeConfig,
    ServingEngine,
    plan_prefill_chunks,
)
from .faults import AuditError, Fault, FaultInjector, audit_engine, random_schedule
from .paged_cache import BlockPool, PoolExhausted, PrefixCache, SlotTables
from .sampling import sample, sample_step

__all__ = [
    "AuditError", "BlockPool", "Fault", "FaultInjector", "PoolExhausted",
    "PrefixCache", "Request", "ServeConfig", "ServingEngine", "SlotTables",
    "TERMINAL", "audit_engine", "plan_prefill_chunks", "random_schedule",
    "sample", "sample_step",
]
