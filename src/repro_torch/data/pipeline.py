"""Token data pipeline: synthetic + sharded binary file reader, with
deterministic resume and background prefetch.

The port's copy of ``repro.data.pipeline`` (numpy only, the same code):
batch ``i`` is the same array as the reference's for the same config.

Design points for the 1000+-node posture:

* **host sharding** — each host reads only its slice (``host_id``/
  ``num_hosts``); the global batch is assembled by the runtime from
  per-host shards.
* **deterministic resume** — batch ``i`` is a pure function of (seed, i),
  so restoring step ``k`` replays the exact stream without saved iterator
  state.
* **prefetch** — a small background thread keeps ``prefetch`` batches ready.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np


@dataclasses.dataclass
class DataConfig:
    batch: int  # per-host batch
    seq: int
    vocab_size: int
    seed: int = 0
    host_id: int = 0
    num_hosts: int = 1
    prefetch: int = 2


class SyntheticTokens:
    """Zipf-ish synthetic LM tokens; infinite, deterministic per (seed, idx)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        # zipf-like unnormalized weights over a capped alphabet for speed
        self.alphabet = min(cfg.vocab_size, 32768)

    def batch_at(self, index: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + index) * cfg.num_hosts + cfg.host_id
        )
        # cheap zipf via pareto-quantized draw
        u = rng.random((cfg.batch, cfg.seq + 1))
        toks = np.minimum(
            (self.alphabet * (u ** 2.5)).astype(np.int32), cfg.vocab_size - 1
        )
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class TokenFileDataset:
    """Reader over sharded flat binary token files (.bin of uint16/uint32).

    Files are memory-mapped; sample ``i`` is a deterministic window, so the
    stream is resumable and identical across restarts.
    """

    def __init__(self, cfg: DataConfig, paths: Sequence[str], dtype=np.uint16):
        self.cfg = cfg
        self.maps = [np.memmap(p, dtype=dtype, mode="r") for p in paths]
        self.sizes = [len(m) - cfg.seq - 1 for m in self.maps]
        if any(s <= 0 for s in self.sizes):
            raise ValueError("shard shorter than one sample")
        self.total = sum(self.sizes)

    def batch_at(self, index: int) -> dict:
        cfg = self.cfg
        rng = np.random.default_rng(
            (cfg.seed * 1_000_003 + index) * cfg.num_hosts + cfg.host_id
        )
        toks = np.empty((cfg.batch, cfg.seq + 1), np.int32)
        for b in range(cfg.batch):
            off = int(rng.integers(0, self.total))
            for m, size in zip(self.maps, self.sizes):
                if off < size:
                    toks[b] = np.asarray(m[off : off + cfg.seq + 1], np.int32)
                    break
                off -= size
        toks = np.minimum(toks, cfg.vocab_size - 1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


def make_loader(dataset, start_step: int = 0) -> Iterator[dict]:
    """Background-prefetched iterator starting at ``start_step``."""
    cfg = dataset.cfg
    q: queue.Queue = queue.Queue(maxsize=max(cfg.prefetch, 1))
    stop = threading.Event()

    def worker():
        i = start_step
        while not stop.is_set():
            batch = dataset.batch_at(i)
            while not stop.is_set():
                try:
                    q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue
            i += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
