"""``repro_torch.core.compile``: pipeline analysis + backend dispatch +
caching (the JAX package's ``repro.core.compile``).

    kernel = compile(program, schedule, target="cuda")     # or "reference"

The analysis half (``lowering.analyze``) is memoized on the program's
structural fingerprint and the schedule, and the emitted kernel is memoized
again per target — so autotuners, kernel libraries and the serving engine
can call ``compile`` per request and pay nothing after the first hit
(DESIGN.md §3.3).  Third-party targets plug in through
``repro_torch.core.backends.register_backend``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from .backends import available_backends, canonical_target, get_backend
from .errors import LoweringError
from .lowering import (
    CompiledKernel,
    LoweredModule,
    analyze,
    clear_analysis_cache,
    program_fingerprint,
    schedule_key,
)
from .schedule import Schedule

DEFAULT_TARGET = "cuda"

_KERNEL_CACHE: Dict[Tuple[str, tuple, str], CompiledKernel] = {}


def compile(  # noqa: A001 — mirrors tilelang.compile
    program,
    schedule: Optional[Schedule] = None,
    target: Optional[str] = None,
    backend: Optional[str] = None,
    use_cache: bool = True,
) -> CompiledKernel:
    """Compile a TileProgram for ``target`` (by registry name).

    ``backend=`` is an accepted alias of ``target=`` (the pre-registry
    keyword); passing both with different values is an error.
    """
    if backend is not None:
        if target is not None and canonical_target(target) != canonical_target(backend):
            raise LoweringError(
                f"compile: conflicting target={target!r} and backend={backend!r}"
            )
        target = backend
    target = canonical_target(target or DEFAULT_TARGET)
    schedule = schedule or Schedule()

    if not use_cache:
        return get_backend(target)(analyze(program, schedule, use_cache=False))

    key = (program_fingerprint(program), schedule_key(schedule), target)
    kernel = _KERNEL_CACHE.get(key)
    if kernel is None:
        module = analyze(program, schedule)
        kernel = get_backend(target)(module)
        _KERNEL_CACHE[key] = kernel
    return kernel


def clear_compile_cache() -> None:
    """Drop both the kernel cache and the underlying analysis cache."""
    _KERNEL_CACHE.clear()
    clear_analysis_cache()


__all__ = [
    "compile",
    "clear_compile_cache",
    "available_backends",
    "DEFAULT_TARGET",
]
