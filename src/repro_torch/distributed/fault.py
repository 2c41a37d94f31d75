"""Fault tolerance: failure injection, checkpoint/restart and straggler
detection; the single-process part of ``repro.distributed.fault``.

The recovery contract is the reference's: synchronous training restarts the
failed step from the last complete checkpoint, and stragglers are detected
by deadline.  Failures and stragglers are *injected* (the same
``np.random.default_rng(seed)`` stream as the reference, so the same steps
fail), so the recovery paths are exercised by tests.  Elastic re-meshing
re-places a state on a mesh with another data axis (``elastic_remesh``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch


class SimulatedNodeFailure(RuntimeError):
    """Injected stand-in for a lost host / device."""


@dataclasses.dataclass
class FaultConfig:
    failure_prob: float = 0.0  # per-step probability of injected failure
    straggler_prob: float = 0.0  # per-step probability of injected delay
    straggler_delay_s: float = 0.2
    deadline_factor: float = 3.0  # median multiplier before flagging
    seed: int = 0


class StragglerMonitor:
    """Deadline-based straggler detection over step wall times.

    A step slower than ``deadline_factor`` × median is flagged; the runner's
    policy (re-dispatch on real clusters, log here) is pluggable.
    """

    def __init__(self, factor: float = 3.0, window: int = 32):
        self.factor = factor
        self.window = window
        self.times: List[float] = []
        self.flagged: List[int] = []

    def observe(self, step: int, seconds: float) -> bool:
        straggled = False
        if len(self.times) >= 5:
            med = float(np.median(self.times[-self.window:]))
            if seconds > self.factor * med:
                self.flagged.append(step)
                straggled = True
        self.times.append(seconds)
        return straggled


class FaultInjector:
    def __init__(self, cfg: FaultConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(cfg.seed)
        self.injected_failures = 0
        self.injected_stragglers = 0

    def before_step(self, step: int):
        if self.rng.random() < self.cfg.straggler_prob:
            self.injected_stragglers += 1
            time.sleep(self.cfg.straggler_delay_s)
        if self.rng.random() < self.cfg.failure_prob:
            self.injected_failures += 1
            raise SimulatedNodeFailure(f"injected failure at step {step}")


def _block_until_ready(metrics):
    """Wait for the device work behind a step's metrics (a dict of
    tensors), as the reference blocks on its first leaf."""
    for v in metrics.values():
        if isinstance(v, torch.Tensor) and v.is_cuda:
            torch.cuda.synchronize(v.device)
            return


def run_with_recovery(
    train_step: Callable,
    state,
    loader_factory: Callable[[int], Any],
    steps: int,
    ckpt_manager,
    shardings=None,
    fault: Optional[FaultConfig] = None,
    max_restarts: int = 10,
) -> Dict[str, Any]:
    """The fault-tolerant training loop.

    ``loader_factory(step)`` must return a deterministic-resume iterator
    starting at ``step``; ``shardings`` (a tree of
    ``distributed.sharding.NamedSharding``) places a restored state on its
    mesh.  On (injected) failure: restore the latest
    checkpoint, rebuild the loader at that step, continue.  Returns run
    metadata (restarts, straggler log, final state).
    """
    injector = FaultInjector(fault or FaultConfig())
    monitor = StragglerMonitor(
        factor=(fault or FaultConfig()).deadline_factor
    )
    step = 0
    restarts = 0
    ckpt_manager.maybe_save(state, 0, force=True)
    loader = loader_factory(0)
    metrics = None
    while step < steps:
        try:
            t0 = time.time()
            injector.before_step(step)
            batch = next(loader)
            state, metrics = train_step(state, batch)
            _block_until_ready(metrics)
            monitor.observe(step, time.time() - t0)
            step += 1
            ckpt_manager.maybe_save(state, step)
        except SimulatedNodeFailure:
            restarts += 1
            if restarts > max_restarts:
                raise
            # a save still in flight completes first: the reference reads
            # the directory at once, and a failure right after the forced
            # step-0 save can find no complete checkpoint there yet
            ckpt_manager.wait()
            last = ckpt_manager.latest()
            state = ckpt_manager.restore(state, shardings=shardings, step=last)
            step = last
            if hasattr(loader, "close"):
                loader.close()
            loader = loader_factory(step)
    ckpt_manager.maybe_save(state, steps, force=True)
    if hasattr(loader, "close"):
        loader.close()
    return {
        "state": state,
        "steps": step,
        "restarts": restarts,
        "stragglers_flagged": monitor.flagged,
        "injected": {
            "failures": injector.injected_failures,
            "stragglers": injector.injected_stragglers,
        },
        "last_metrics": metrics,
    }


# ---------------------------------------------------------------------------
# Elastic re-meshing
# ---------------------------------------------------------------------------


def elastic_remesh(host_state, new_mesh, state_specs):
    """Re-place a (host) state tree onto a different mesh.

    Because ZeRO-1 state sharding is *derived* from the mesh (zero1_specs),
    growing/shrinking the data axis is just a placement on the new mesh —
    no tensor layout surgery.  ``state_specs`` must be the specs computed
    against ``new_mesh``; each leaf (a tensor or numpy array every rank
    holds whole, or a DTensor of another mesh, gathered first) becomes a
    DTensor of its spec on ``new_mesh`` (fault.py:144-157)."""
    from torch.distributed.tensor import DTensor

    from . import sharding as shd

    def place(spec, x):
        if isinstance(x, DTensor):
            x = x.full_tensor()
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(np.asarray(x))
        return shd.place(t.to(new_mesh.device_type), new_mesh, spec)

    return shd.tree_map2(place, state_specs, host_state)
