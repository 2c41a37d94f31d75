"""Error types, copied from ``repro.core.errors`` (the subset the serving path
raises)."""

from typing import Optional


class TileError(Exception):
    """Base error for all tile-language failures.

    ``context`` carries where the failure happened, so an error names its
    kernel or dispatch site instead of surfacing as a bare message.
    """

    def __init__(self, *args, context: Optional[str] = None):
        super().__init__(*args)
        self.context = context

    def __str__(self) -> str:
        base = super().__str__()
        if self.context:
            return f"{base} [{self.context}]"
        return base


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
