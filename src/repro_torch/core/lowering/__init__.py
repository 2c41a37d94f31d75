"""The pass-based lowering pipeline (DESIGN.md §1, §3).

``TileProgram -> LoweredModule`` is a sequence of explicit, individually
testable passes (see :mod:`.pipeline` for the ordered list):

    split_phases -> infer_layouts -> collect_windows -> plan_grid
    -> plan_stages -> plan_vmem -> plan_params -> estimate_cost

Each pass fills a slice of the :class:`LoweredModule` analysis artifact and
never emits target code; code emission lives in ``core.backends``,
which consume the finished artifact.  ``analyze`` memoizes the whole pipeline
on ``(program fingerprint, schedule key)`` so the autotuner and kernel
libraries score candidates without re-running the passes.
"""
from .cost import KernelCost, estimate_cost
from .fingerprint import program_fingerprint, schedule_key
from .grid import GridPlan, plan_grid
from .indexing import make_index_map, no_loads
from .module import CompiledKernel, LoweredInfo, LoweredModule
from .phases import LOOP, POST, PRE, Phases, split_phases
from .pipeline import PIPELINE, analyze, clear_analysis_cache, run_pipeline
from .windows import Window, collect_windows

__all__ = [
    "KernelCost",
    "estimate_cost",
    "program_fingerprint",
    "schedule_key",
    "GridPlan",
    "plan_grid",
    "make_index_map",
    "no_loads",
    "CompiledKernel",
    "LoweredInfo",
    "LoweredModule",
    "PRE",
    "LOOP",
    "POST",
    "Phases",
    "split_phases",
    "PIPELINE",
    "analyze",
    "clear_analysis_cache",
    "run_pipeline",
    "Window",
    "collect_windows",
]
