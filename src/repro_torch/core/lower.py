"""Compatibility shim: the names of the JAX package's ``repro.core.lower``
(src/repro/core/lower.py), where the monolithic lowering once lived.

The port's compiler is split as the JAX package's (DESIGN.md §1):

* :mod:`repro_torch.core.lowering` — the pass pipeline producing a
  :class:`~repro_torch.core.lowering.LoweredModule` analysis artifact
  (``split_phases``, ``collect_windows``, layout inference, ``plan_grid``,
  ``plan_vmem``: the block's shared-memory plan, cost estimation),
  memoized per (program fingerprint, schedule);
* :mod:`repro_torch.core.backends` — the pluggable backend registry;
  ``cuda`` (CUDA C++ for ``sm_90a``), ``reference`` (the trace
  interpreter over torch tensors) and ``sanitize`` are built in, others
  added with :func:`repro_torch.core.backends.register_backend`;
* :mod:`repro_torch.core.compiler` — the ``compile()`` entry point
  dispatching through the registry, with kernel-level caching.

Importing the old names from here keeps working; new code imports from the
packages above.
"""
from .backends import available_backends, get_backend, register_backend  # noqa: F401
from .compiler import clear_compile_cache, compile  # noqa: F401
from .lowering import (  # noqa: F401
    LOOP,
    POST,
    PRE,
    CompiledKernel,
    KernelCost,
    LoweredInfo,
    LoweredModule,
    Phases,
    Window,
    analyze,
    collect_windows,
    estimate_cost,
    make_index_map,
    split_phases,
)
from .lowering.indexing import no_loads as _no_loads  # noqa: F401
from .lowering.windows import _is_onchip, _merge_out_window, _same_starts  # noqa: F401

# Pre-split private names kept for callers that reached into the module.
_estimate_cost = estimate_cost

__all__ = [
    "compile",
    "CompiledKernel",
    "KernelCost",
    "LoweredInfo",
    "LoweredModule",
    "Phases",
    "Window",
    "PRE",
    "LOOP",
    "POST",
    "split_phases",
    "collect_windows",
    "make_index_map",
    "analyze",
    "available_backends",
    "get_backend",
    "register_backend",
    "clear_compile_cache",
]
