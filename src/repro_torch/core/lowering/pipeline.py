"""The ordered pass pipeline and the analysis cache (DESIGN.md §3).

``run_pipeline`` executes every pass over a fresh :class:`LoweredModule`;
``analyze`` memoizes the result on ``(program fingerprint, schedule key)`` so
autotuning over N candidate schedules of the same dataflow — or serving
traffic that compiles the same kernel per request — re-runs nothing.

Each pass is a plain ``fn(module) -> None`` mutating its own slice of the
artifact, which keeps them individually testable: build a module with
``LoweredModule(program, schedule)``, run a prefix of PIPELINE, inspect.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Tuple

from ..errors import TileError
from ..infer import infer_layouts
from ..schedule import Schedule, plan_vmem
from .cost import estimate_cost
from .fingerprint import program_fingerprint, schedule_key
from .grid import plan_grid
from .module import LoweredModule
from .phases import split_phases
from .verify import pass_verify
from .windows import collect_windows


# ---------------------------------------------------------------------------
# Passes
# ---------------------------------------------------------------------------


def pass_split_phases(m: LoweredModule) -> None:
    m.phases = split_phases(m.program)


def pass_infer_layouts(m: LoweredModule) -> None:
    m.inference = infer_layouts(m.program)


def pass_collect_windows(m: LoweredModule) -> None:
    m.in_windows, m.out_windows, m.fed_by, m.stores = collect_windows(
        m.program, m.phases
    )
    m.window_of = {
        w.onchip.name: i for i, w in enumerate(m.in_windows) if w.onchip is not None
    }
    m.out_window_of = {id(w.param): j for j, w in enumerate(m.out_windows)}


def pass_plan_grid(m: LoweredModule) -> None:
    m.grid_plan = plan_grid(m.program, m.phases, m.schedule)


def pass_plan_stages(m: LoweredModule) -> None:
    pipe = m.phases.pipeline
    m.num_stages = (
        m.schedule.num_stages
        if m.schedule.num_stages is not None
        else (pipe.num_stages if pipe is not None else 1)
    )


def pass_plan_vmem(m: LoweredModule) -> None:
    # check=False: analysis records the footprint; whether an over-budget
    # plan is fatal is the backend's call (the reference interpreter has no
    # shared memory; the CUDA backend raises before it emits).
    m.vmem = plan_vmem(m.program, m.schedule, check=False)


def pass_plan_params(m: LoweredModule) -> None:
    """Parameter / operand ordering shared by every backend.

    ``window_param_idx[i]`` is the position in ``arg_params`` feeding input
    window i, or ``None`` when the window reads a *written* global — legal
    for the reference interpreter."""
    program = m.program
    m.scratch_bufs = [b for b in program.allocs if b.name not in m.fed_by]
    m.scratch_pos = {b.name: i for i, b in enumerate(m.scratch_bufs)}

    written = {id(p) for p in program.written_globals()}
    aliased_params = [w.param for w in m.out_windows if w.aliased]
    m.arg_params = [p for p in program.params if id(p) not in written]
    m.arg_params += list(aliased_params)  # in-out params passed as inputs
    m.out_params = [p for p in program.params if id(p) in written]

    param_pos = {id(p): i for i, p in enumerate(m.arg_params)}
    m.window_param_idx = [param_pos.get(id(w.param)) for w in m.in_windows]
    m.scalar_params = program.scalar_params()


def pass_estimate_cost(m: LoweredModule) -> None:
    m.cost = estimate_cost(
        m.program, m.phases, m.grid, m.in_windows, m.out_windows, m.vmem
    )


PIPELINE: List[Tuple[str, Callable[[LoweredModule], None]]] = [
    ("split_phases", pass_split_phases),
    ("infer_layouts", pass_infer_layouts),
    ("collect_windows", pass_collect_windows),
    ("plan_grid", pass_plan_grid),
    ("plan_stages", pass_plan_stages),
    ("plan_vmem", pass_plan_vmem),
    ("plan_params", pass_plan_params),
    ("verify", pass_verify),
    ("estimate_cost", pass_estimate_cost),
]


# ---------------------------------------------------------------------------
# Driver + analysis cache
# ---------------------------------------------------------------------------

_ANALYSIS_CACHE: Dict[Tuple[str, tuple], LoweredModule] = {}


def run_pipeline(program, schedule: Schedule) -> LoweredModule:
    """Run every pass; no caching (unit tests / debugging).

    A TileError escaping a pass is tagged with the program name and the
    failing pass (``TileError.context``) so a mid-pipeline failure names
    its kernel instead of surfacing as a bare message three layers up.
    """
    m = LoweredModule(program, schedule)
    for name, p in PIPELINE:
        try:
            p(m)
        except TileError as e:
            if e.context is None:
                e.context = f"program {program.name!r}, pass {name!r}"
            raise
    return m


def analyze(program, schedule: Schedule = None, use_cache: bool = True) -> LoweredModule:
    """Cached ``TileProgram -> LoweredModule``.

    The cache key is structural, so re-traced copies of the same kernel
    (fresh buffer names, fresh factory call) hit the same entry."""
    schedule = schedule or Schedule()
    if not use_cache:
        return run_pipeline(program, schedule)
    key = (program_fingerprint(program), schedule_key(schedule))
    mod = _ANALYSIS_CACHE.get(key)
    if mod is None:
        mod = run_pipeline(program, schedule)
        _ANALYSIS_CACHE[key] = mod
    return mod


def clear_analysis_cache() -> None:
    _ANALYSIS_CACHE.clear()
