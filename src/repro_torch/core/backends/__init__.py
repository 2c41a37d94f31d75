"""Pluggable backend registry (the JAX package's ``repro.core.backends``).

A *backend* is a function ``emit(module: LoweredModule) -> CompiledKernel``
registered under a target name.  ``core.compile(..., target=...)``
dispatches through this registry, so adding a target is:

    from repro_torch.core.backends import register_backend

    @register_backend("my_target")
    def emit_my_target(module):
        ...
        return CompiledKernel(module.program, fn, module.info(), ...)

Built-ins: ``cuda`` (alias ``gpu``: CUDA C++ for ``sm_90a`` built with
``nvcc`` and launched on the card), ``reference`` (aliases ``ref``,
``interp``: a trace interpreter over torch tensors — the independent oracle
for the lowering, on the CPU or the card) and ``sanitize`` (the interpreter
under instrumentation).
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from ..errors import LoweringError
from ..lowering.module import CompiledKernel, LoweredModule

BackendFn = Callable[[LoweredModule], CompiledKernel]

_REGISTRY: Dict[str, BackendFn] = {}

# Alternate spellings accepted by compile(target=...).
_ALIASES = {
    "gpu": "cuda",
    "interp": "reference",
    "ref": "reference",
}


def register_backend(name: str, emit: Optional[BackendFn] = None):
    """Register ``emit`` under ``name``; usable directly or as a decorator."""
    if name in _ALIASES:
        raise LoweringError(
            f"backend name {name!r} is reserved as an alias of "
            f"{_ALIASES[name]!r}; register under a different name"
        )

    def _register(fn: BackendFn) -> BackendFn:
        _REGISTRY[name] = fn
        return fn

    if emit is not None:
        return _register(emit)
    return _register


def canonical_target(name: str) -> str:
    """Resolve alias spellings so caches key on one name per backend."""
    return _ALIASES.get(name, name)


def get_backend(name: str) -> BackendFn:
    fn = _REGISTRY.get(canonical_target(name))
    if fn is None:
        raise LoweringError(
            f"Unknown backend {name!r}; available: {sorted(_REGISTRY)}"
        )
    return fn


def available_backends() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


# Built-in backends self-register on import.
from . import cuda as _cuda  # noqa: E402,F401
from . import reference as _reference  # noqa: E402,F401

__all__ = [
    "BackendFn",
    "register_backend",
    "get_backend",
    "available_backends",
]
