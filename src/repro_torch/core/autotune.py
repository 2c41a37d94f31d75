"""Cost-model-driven configuration search (paper §6 future direction), the
port of ``repro.core.autotune`` on the H100's own model.

Because TileLang exposes thread mapping, memory access and compute behavior
explicitly, a static cost model is enough to rank configurations without
running them.  The pass pipeline (``core.lowering``) records a
:class:`KernelCost` (FLOPs, HBM bytes, the block's shared-memory plan, grid)
and layout inference records padding waste and each GEMM's tensor-core
utilization; :func:`autotune` combines them into a roofline-style score and
returns the best-scoring feasible config.

The card's model: the peaks are ``roofline.analysis.HW_H100``'s, read
through ``lowering.cost`` (no other constant): a GEMM's operands set the
rate (int8 the int8 tensor-core rate, bf16 / fp16 the 16-bit one, fp32 the
CUDA cores', where the emitter runs fp32 products; a program with no GEMM
the CUDA cores' too), derated by the worst ``GemmReport.mma_utilization``
(the tile padded to whole m16n8k instructions); memory is the raw HBM
traffic at the card's bandwidth; a config is feasible when its
shared-memory plan fits the block's 232,448 bytes (``Schedule.smem_limit``).

Candidates are scored from the cached analysis artifact
(``lowering.analyze``) alone: no backend code is emitted while searching,
only the winning config is compiled (for ``target``, the ``cuda`` backend
unless asked).  A winner that fails at emission is demoted and the next one
compiled.  Scores are cached per (key, schedule, target, config), LRU-bounded,
so kernel libraries with dynamic shape sets amortize the search.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
from typing import Any, Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from .compiler import DEFAULT_TARGET, compile as tl_compile
from .errors import ScheduleError, TileError
from .lowering import CompiledKernel, analyze, schedule_key
from .lowering.cost import _h100
from .schedule import Schedule


def peak_for(dtype: Optional[str]) -> float:
    """The card's rate (OP/s) for a GEMM's operand type; ``None`` (no GEMM)
    the CUDA cores' fp32 rate."""
    if dtype in ("int8", "uint8"):
        return _h100("peak_ops_int8")
    if dtype in ("bfloat16", "float16"):
        return _h100("peak_flops_bf16")
    return _h100("peak_flops_fp32")


@dataclasses.dataclass
class Candidate:
    config: Dict[str, Any]
    score: float  # estimated seconds (lower is better)
    compute_s: float
    memory_s: float
    mma_util: float
    pad_waste: float
    feasible: bool
    reason: str = ""


# Scored candidates, LRU-bounded: config sweeps over many shape buckets must
# not pin a Candidate per visited config for the process's lifetime.
_CACHE: "collections.OrderedDict[Tuple, Candidate]" = collections.OrderedDict()
_CACHE_MAX = 512


def _cache_get(key):
    cand = _CACHE.get(key)
    if cand is not None:
        _CACHE.move_to_end(key)
    return cand


def _cache_put(key, cand) -> None:
    _CACHE[key] = cand
    _CACHE.move_to_end(key)
    while len(_CACHE) > _CACHE_MAX:
        _CACHE.popitem(last=False)


def _score(cost, inference, num_stages) -> Tuple[float, float, float, float]:
    """Roofline-style score: max(compute, memory) with the tensor cores'
    derate, ``(total, compute_s, memory_s, mma_util)``.

    * compute is derated by the worst GEMM tile's tensor-core utilization
      and runs at the rate of the GEMMs' operand type (all int8: the int8
      rate; otherwise the first GEMM's type);
    * memory is raw HBM traffic (shared-memory padding is a capacity
      effect, planned by ``plan_vmem``, not wire traffic);
    * with two or more stages the two overlap, else they add.
    """
    mma = 1.0
    dtype = None
    if inference.gemms:
        mma = min(g.mma_utilization for g in inference.gemms)
        dtype = inference.gemms[0].a_dtype
        if all(g.a_dtype in ("int8", "uint8") for g in inference.gemms):
            dtype = "int8"
    compute_s = cost.compute_seconds(peak_for(dtype)) / max(mma, 1e-3)
    memory_s = cost.memory_seconds(_h100("hbm_bw"))
    total = max(compute_s, memory_s) if num_stages >= 2 else compute_s + memory_s
    return total, compute_s, memory_s, mma


def score_kernel(kernel: CompiledKernel) -> Tuple[float, float, float, float]:
    """Score an already-compiled kernel (the shared model)."""
    info = kernel.info
    return _score(info.cost, info.inference, info.num_stages)


def score_module(module) -> Tuple[float, float, float, float]:
    """Score a :class:`LoweredModule` analysis artifact, with no emission."""
    return _score(module.cost, module.inference, module.num_stages)


def autotune(
    build: Callable[..., Any],
    configs: Iterable[Dict[str, Any]],
    schedule: Optional[Schedule] = None,
    cache_key: Optional[Tuple] = None,
    return_all: bool = False,
    target: Optional[str] = None,
):
    """Pick the best config for a program factory.

    ``build(**config)`` must return a TileProgram.  Infeasible configs (a
    shared-memory plan over the block's budget, lowering errors) are
    skipped but recorded.  Scoring runs on the cached pipeline analysis;
    only the winner is compiled for ``target`` (default ``cuda``).
    Returns ``(kernel, winner)``, and every candidate with ``return_all``.
    """
    schedule = schedule or Schedule()
    target = target or DEFAULT_TARGET
    results: List[Candidate] = []

    def key_of(config):
        # the schedule and target in the key: a config can be feasible under
        # one schedule and not another, and fail one backend's emission only
        return (cache_key, schedule_key(schedule), target, tuple(sorted(config.items())))

    for config in configs:
        if cache_key is not None:
            hit = _cache_get(key_of(config))
            if hit is not None:
                results.append(hit)
                continue
        try:
            module = analyze(build(**config), schedule)
            if not module.vmem.ok:
                raise ScheduleError(f"shared-memory budget exceeded —\n{module.vmem.summary()}")
            total, cs, ms, mma = score_module(module)
            waste = max(module.inference.waste.values(), default=0.0)
            cand = Candidate(config, total, cs, ms, mma, waste, True)
        except (ScheduleError, TileError) as e:
            cand = Candidate(config, float("inf"), 0, 0, 0, 0, False, str(e))
        results.append(cand)
        if cache_key is not None:
            _cache_put(key_of(config), cand)
    # Compile winners best-first (the analysis is cached, so this runs only
    # the backend's emission).  A config that fails there is demoted to
    # infeasible, as a copy (a Candidate may be aliased into _CACHE and into
    # lists returned earlier), and the next-best one is tried.
    kernel = winner = None
    for cand in sorted((c for c in results if c.feasible), key=lambda c: c.score):
        try:
            kernel = tl_compile(build(**cand.config), schedule=schedule, target=target)
            winner = cand
            break
        except (ScheduleError, TileError) as e:
            demoted = dataclasses.replace(cand, feasible=False, score=float("inf"),
                                          reason=str(e))
            results[results.index(cand)] = demoted
            if cache_key is not None:  # later calls skip the failing emission
                _cache_put(key_of(cand.config), demoted)
    if kernel is None:
        msgs = "; ".join(c.reason[:80] for c in results[:4])
        raise ScheduleError(f"autotune: no feasible config ({msgs})")
    if return_all:
        return kernel, winner, results
    return kernel, winner


def grid_configs(**axes: Sequence[Any]) -> List[Dict[str, Any]]:
    """Cartesian product of named axis values -> list of config dicts."""
    names = list(axes)
    return [dict(zip(names, vals)) for vals in itertools.product(*(axes[n] for n in names))]
