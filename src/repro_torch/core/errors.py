"""Error types for the tile language (the JAX package's ``repro.core.errors``)."""

from typing import Optional


class TileError(Exception):
    """Base error for all tile-language failures.

    ``context`` carries where the failure happened — typically the program
    name and the pipeline pass that raised (attached by ``run_pipeline``) —
    so a mid-pipeline error names its kernel instead of surfacing as a bare
    message three layers up.
    """

    def __init__(self, *args, context: Optional[str] = None):
        super().__init__(*args)
        self.context = context

    def __str__(self) -> str:
        base = super().__str__()
        if self.context:
            return f"{base} [{self.context}]"
        return base


class TraceError(TileError):
    """Raised when the Python-embedded frontend is used outside a kernel
    context or with malformed arguments."""


class LoweringError(TileError):
    """Raised when a traced program cannot be lowered to the requested
    backend (e.g. an op the CUDA backend does not take)."""


class LayoutError(TileError):
    """Raised by the layout-inference pass on conflicting constraints."""


class ScheduleError(TileError):
    """Raised for invalid schedule parameters (shared-memory budget, stages...)."""


class VerifyError(LoweringError):
    """Raised by the static verifier pass (lowering/verify.py): a window
    provably escapes its buffer, two grid cells provably write overlapping
    output regions, or the in-out alias wiring is inconsistent."""


class SanitizeError(TileError):
    """Raised by the reference interpreter on unsanitary kernel behavior:
    out-of-bounds region starts or scalar-load indices (checked always —
    Python's negative-index wrap-around must never silently read the end of
    a buffer), plus duplicate cross-cell writes, uninitialized-output reads
    and non-finite outputs under sanitize mode."""


class GuardError(TileError):
    """A runtime obligation failed at dispatch time (kernels/ops.py guard):
    a block table directed a kernel at an out-of-range, reserved, or
    duplicated writable page.  ``violations`` is a list of ``(row, kind,
    message)`` tuples so a batch dispatcher can fail exactly the offending
    rows and keep the rest."""

    def __init__(self, violations, context: Optional[str] = None):
        self.violations = list(violations)
        msg = "; ".join(
            f"row {r}: {kind}: {m}" for r, kind, m in self.violations
        )
        super().__init__(f"dispatch guard: {msg}", context=context)
