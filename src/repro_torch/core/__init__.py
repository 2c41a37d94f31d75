"""repro_torch.core — the tile-DSL compiler on torch, the port of
``repro.core`` (the paper's primary contribution), and the port's device
and error helpers.

A Python-embedded tile DSL (program.py) whose dataflow operators
(tile_ops.py) are decoupled from scheduling (schedule.py), with
priority-ordered layout inference (infer.py, layout.py) on the card's
geometry, a pass-based lowering pipeline (lowering/) producing a
LoweredModule analysis artifact, and a pluggable backend registry
(backends/: ``cuda`` — CUDA C++ for ``sm_90a`` — the ``reference`` trace
interpreter over torch tensors, and ``sanitize``).  ``autotune`` adds the
cost-model config search over cached analyses, on the card's peaks::

    from repro_torch.core import compile, lang as T
    kernel = compile(program, target="cuda")        # on the card
    kernel = compile(program, target="reference")   # on the CPU
"""

from . import program as lang  # the "T" namespace:  from repro_torch.core import lang as T
from .autotune import autotune, grid_configs
from .backends import available_backends, get_backend, register_backend
from .buffer import FRAGMENT, GLOBAL, SCALAR, SHARED, Region, TileBuffer
from .compiler import clear_compile_cache, compile
from .device import resolve_device
from .errors import (
    GuardError,
    LayoutError,
    LoweringError,
    ScheduleError,
    TileError,
    TraceError,
)
from .infer import InferenceResult, infer_layouts
from .layout import Fragment, IterVar, Layout, padded, row_major, swizzle_2d, tiled_2d, warp_fragment
from .lowering import (
    CompiledKernel,
    KernelCost,
    LoweredInfo,
    LoweredModule,
    analyze,
    program_fingerprint,
)
from .program import ScalarTensor, TileProgram, Tensor, prim_func
from .schedule import Schedule, plan_vmem

__all__ = [
    "lang",
    "autotune",
    "grid_configs",
    "FRAGMENT",
    "GLOBAL",
    "SCALAR",
    "SHARED",
    "Region",
    "TileBuffer",
    "GuardError",
    "TileError",
    "TraceError",
    "LoweringError",
    "LayoutError",
    "ScheduleError",
    "InferenceResult",
    "infer_layouts",
    "Fragment",
    "IterVar",
    "Layout",
    "padded",
    "row_major",
    "swizzle_2d",
    "tiled_2d",
    "warp_fragment",
    "CompiledKernel",
    "KernelCost",
    "LoweredInfo",
    "LoweredModule",
    "analyze",
    "program_fingerprint",
    "compile",
    "clear_compile_cache",
    "available_backends",
    "get_backend",
    "register_backend",
    "TileProgram",
    "Tensor",
    "ScalarTensor",
    "prim_func",
    "Schedule",
    "plan_vmem",
    "resolve_device",
]
