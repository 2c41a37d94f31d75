"""Static verification pass over a :class:`LoweredModule` (DESIGN.md §5.8).

TileLang's thesis — scheduling as annotations decoupled from dataflow —
means the dataflow of every lowered kernel is statically analyzable.  This
pass spends that analyzability on safety:

* **Window bounds.**  Every static window start expression is interval-
  analyzed over the grid/loop variable extents; a window that can escape
  its declared buffer shape is a :class:`VerifyError` at lowering time.
* **Write races.**  Two grid cells whose output windows can overlap lose
  writes nondeterministically on a parallel grid (and silently, in order,
  on an ``arbitrary`` one).  A grid variable that never reaches any start
  expression of an output window is a proven race; variables that do reach
  one are proven disjoint where the affine structure allows (mixed-radix
  argument below).
* **Alias wiring.**  The ``aliased`` in-out marks decided by
  ``lowering/windows.py`` must match the operand wiring a backend
  builds for its in-out operands; :func:`alias_wiring` is the single
  source of truth both sides check against.

Checks that depend on *runtime* scalars — table-directed windows whose
starts load a scalar-prefetch buffer (paged-KV block tables) — cannot be
proved here.  They are not skipped: each becomes a structured
:class:`Obligation` attached to the module, and the dispatch guard in
``kernels/ops.py`` discharges them against the concrete tables before
every launch (entries in range, writable pages disjoint).

What is proved vs. deferred:

====================  =========================================
static start exprs    in-bounds proved here (interval analysis)
table-directed axis   ``table_in_range`` obligation -> dispatch guard
grid var not in any
  output start        write race, rejected here
affine output starts  disjointness proved here (mixed-radix)
table-directed store  ``table_writes_disjoint`` obligation -> guard
atomic (accumulate)   exempt: commutative by construction
====================  =========================================
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

from ..buffer import SCALAR
from ..errors import VerifyError
from ..expr import (
    BinExpr,
    CastExpr,
    ConstExpr,
    Expr,
    LoadExpr,
    UnaryExpr,
    VarExpr,
    WhereExpr,
    free_vars,
    linear_decompose,
    loads_in,
)
from .module import LoweredModule
from .windows import Window

INF = math.inf


# ---------------------------------------------------------------------------
# Runtime obligations
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Obligation:
    """One check the dispatcher owes the kernel before launch.

    kind
        ``table_in_range`` — axis ``axis`` of ``param`` is positioned by
        entries of scalar buffer ``table``; every entry consumed by the
        launch must place the ``size``-wide window inside the buffer
        (for page pools: entry in ``[0, num_pages)``, with page 0 reserved
        by the serving convention).
        ``table_writes_disjoint`` — ``param`` is *written* through a
        table-directed window; the table rows of one launch must not map
        two grid cells onto the same page (duplicate writable entries).
    """

    kind: str  # "table_in_range" | "table_writes_disjoint"
    param: str  # global buffer the window manages
    tables: Tuple[str, ...]  # scalar-prefetch buffers the start loads
    axis: int  # buffer axis the tables position
    size: int  # window extent along that axis
    writable: bool  # True when the window is an output

    def describe(self) -> str:
        return (
            f"{self.kind}: {self.param}[axis {self.axis}, block {self.size}] "
            f"directed by {'+'.join(self.tables)}"
            + (" (writable)" if self.writable else "")
        )


# ---------------------------------------------------------------------------
# Interval analysis over start expressions
# ---------------------------------------------------------------------------


def _mul_bound(a: float, b: float) -> float:
    if (a in (INF, -INF) and b == 0) or (b in (INF, -INF) and a == 0):
        return 0.0
    return a * b


def interval(e: Expr) -> Tuple[float, float]:
    """Conservative ``[lo, hi]`` bounds of a *static* expression, using
    ``VarExpr.extent`` (every grid/loop/parallel var carries one).  Unknown
    constructs widen to ``(-inf, inf)``; loads must be handled by the
    caller (they make the expression dynamic, not wide)."""
    if isinstance(e, ConstExpr):
        v = float(e.value)
        return (v, v)
    if isinstance(e, VarExpr):
        if e.extent is not None and e.extent >= 1:
            return (0.0, float(e.extent - 1))
        return (-INF, INF)
    if isinstance(e, CastExpr):
        return interval(e.operand)
    if isinstance(e, WhereExpr):
        tl, th = interval(e.then)
        ol, oh = interval(e.otherwise)
        return (min(tl, ol), max(th, oh))
    if isinstance(e, UnaryExpr):
        lo, hi = interval(e.operand)
        if e.op == "neg":
            return (-hi, -lo)
        if e.op == "abs":
            if lo >= 0:
                return (lo, hi)
            return (0.0, max(abs(lo), abs(hi)))
        if e.op in ("floor", "ceil"):
            return (lo, hi)
        return (-INF, INF)
    if isinstance(e, BinExpr):
        if e.op in ("lt", "le", "gt", "ge", "eq", "ne"):
            return (0.0, 1.0)
        ll, lh = interval(e.lhs)
        rl, rh = interval(e.rhs)
        if e.op == "add":
            return (ll + rl, lh + rh)
        if e.op == "sub":
            return (ll - rh, lh - rl)
        if e.op == "mul":
            prods = [
                _mul_bound(ll, rl),
                _mul_bound(ll, rh),
                _mul_bound(lh, rl),
                _mul_bound(lh, rh),
            ]
            return (min(prods), max(prods))
        if e.op == "max":
            return (max(ll, rl), max(lh, rh))
        if e.op == "min":
            return (min(ll, rl), min(lh, rh))
        if e.op in ("floordiv", "mod") and rl == rh and rl > 0:
            b = rl
            if e.op == "floordiv":
                lo = -INF if ll == -INF else math.floor(ll / b)
                hi = INF if lh == INF else math.floor(lh / b)
                return (float(lo), float(hi))
            # Python mod with a positive divisor lands in [0, b)
            if ll >= 0 and lh < b:
                return (ll, lh)
            return (0.0, b - 1)
        return (-INF, INF)
    if isinstance(e, LoadExpr):
        # dynamic; callers split loads out before calling interval()
        return (-INF, INF)
    return (-INF, INF)


def _dynamic_tables(start: Expr) -> List[str]:
    """Scalar-prefetch buffers loaded by a start expression (the axis is
    table-directed when non-empty)."""
    return sorted(
        {ld.buffer.name for ld in loads_in(start) if ld.buffer.scope == SCALAR}
    )


# ---------------------------------------------------------------------------
# Alias wiring — single source of truth for in-out operand positions
# ---------------------------------------------------------------------------


def alias_wiring(m: LoweredModule) -> Dict[int, int]:
    """The in-out alias mapping a backend's call must use:
    operand position (over scalar-prefetch + input-window + aliased-output
    operands, in that order) -> output index.  The backend builds its own
    wiring from its operand list and cross-checks it against this."""
    n_scalars = len(m.scalar_params)
    n_in_ops = len(m.in_windows)
    aliased_js = [j for j, w in enumerate(m.out_windows) if w.aliased]
    return {n_scalars + n_in_ops + i: j for i, j in enumerate(aliased_js)}


def check_alias_marks(m: LoweredModule) -> None:
    """Structural invariants tying window ``aliased`` marks to the operand
    plan (plan_params) — violated marks would desynchronize the backend's
    in-out wiring from the tensors actually passed."""
    name = m.program.name
    aliased = [w for w in m.out_windows if w.aliased]
    # plan_params appends aliased out-params to the tail of arg_params, in
    # out_windows order; a backend's operand assembly relies on exactly that.
    tail = m.arg_params[len(m.arg_params) - len(aliased):]
    if [id(w.param) for w in aliased] != [id(p) for p in tail]:
        raise VerifyError(
            f"{name}: aliased out-params are not the tail of arg_params; "
            "operand order no longer matches the in-out wiring"
        )
    for w in aliased:
        if sum(1 for p in m.arg_params if p is w.param) != 1:
            raise VerifyError(
                f"{name}: aliased param {w.param.name} appears "
                "more than once in arg_params"
            )
        if w.onchip is not None and not _any_table_axis(w):
            # aliasing for non-atomic stores is only granted when the write
            # placement is data-dependent (lowering/windows.py); a static
            # aliased store would overlap its own reads
            raise VerifyError(
                f"{name}: output window for {w.param.name} is aliased but "
                "statically indexed; aliasing requires a table-directed store"
            )
    for w in m.out_windows:
        if not w.aliased and any(p is w.param for p in m.arg_params):
            raise VerifyError(
                f"{name}: written param {w.param.name} also appears in "
                "arg_params without an alias mark"
            )


def _any_table_axis(w: Window) -> bool:
    return any(_dynamic_tables(s) for s in w.region.starts)


# ---------------------------------------------------------------------------
# The verifier pass
# ---------------------------------------------------------------------------


def _check_bounds(name: str, w: Window, obligations: List[Obligation]) -> None:
    shape = w.param.shape
    for axis, (start, size) in enumerate(zip(w.region.starts, w.region.sizes)):
        tables = _dynamic_tables(start)
        if tables:
            obligations.append(
                Obligation(
                    kind="table_in_range",
                    param=w.param.name,
                    tables=tuple(tables),
                    axis=axis,
                    size=size,
                    writable=w.is_output,
                )
            )
            continue
        if loads_in(start):
            raise VerifyError(
                f"{name}: window start of {w.param.name} axis {axis} loads a "
                "non-scalar buffer; index expressions may only load "
                "scalar-prefetch params"
            )
        lo, hi = interval(start)
        # The index-map fold (lowering/indexing.py) realizes the start as
        # either the expression itself (size-1 / size-divisible affine) or
        # ``(e // size) * size`` (runtime-div fallback).  Both realizations
        # lie in [floor(lo/size)*size, hi], so ``lo >= 0`` and
        # ``hi + size <= extent`` bound every fold soundly.
        if lo < 0 or hi + size > shape[axis]:
            raise VerifyError(
                f"{name}: window of {w.param.name} can escape axis {axis}: "
                f"start in [{lo:g}, {hi:g}], block {size}, extent "
                f"{shape[axis]} ({start!r})"
            )


def _radix_injective(groups: List[Tuple[int, int]], block: int) -> bool:
    """True when ``sum coeff_i * v_i`` (each ``v_i`` in ``[0, extent_i)``)
    maps distinct tuples at least ``block`` apart — i.e. the windows the
    cells select along this axis cannot overlap.

    Mixed-radix argument: sort by |coeff| ascending with uniform sign; if
    ``|c_1| >= block`` and each ``|c_{i+1}| >= |c_i| * extent_i``, the
    smallest nonzero difference between two assignments is ``|c_1|``.
    """
    if not groups:
        return False
    coeffs = [c for c, _ in groups]
    if 0 in coeffs:
        return False
    if not (all(c > 0 for c in coeffs) or all(c < 0 for c in coeffs)):
        return False
    ordered = sorted(((abs(c), e) for c, e in groups))
    if ordered[0][0] < block:
        return False
    for (c0, e0), (c1, _e1) in zip(ordered, ordered[1:]):
        if c1 < c0 * e0:
            return False
    return True


def _check_races(
    name: str,
    w: Window,
    cell_vars: Dict[str, int],
    obligations: List[Obligation],
) -> None:
    """Every variable that distinguishes grid cells must provably steer
    this output window to a distinct region (or be covered by a runtime
    obligation on a table-directed axis)."""
    if w.onchip is None:
        return  # atomic accumulate: commutative, any overlap is the point
    covered: Set[str] = set()
    proven: Set[str] = set()
    dyn_tables: List[Tuple[int, Tuple[str, ...]]] = []
    decomps: List[Tuple[int, int, Optional[Dict[str, int]]]] = []
    for axis, (start, size) in enumerate(zip(w.region.starts, w.region.sizes)):
        tables = _dynamic_tables(start)
        if tables:
            dyn_tables.append((axis, tuple(tables)))
            # the table owns disjointness for every var feeding its lookup
            covered |= free_vars(start)
            continue
        covered |= free_vars(start)
        decomps.append((axis, size, linear_decompose(start)))
    for axis, size, dec in decomps:
        if dec is None:
            continue
        group = [
            (coeff, cell_vars[v])
            for v, coeff in dec.items()
            if v in cell_vars and coeff != 0
        ]
        named = [v for v, c in dec.items() if v in cell_vars and c != 0]
        extra = [
            v for v, c in dec.items() if v and c != 0 and v not in cell_vars
        ]
        if extra:
            # a non-cell variable (e.g. a serial loop) also moves this axis;
            # the radix argument over cell vars alone is no longer airtight
            continue
        if _radix_injective(group, size):
            proven |= set(named)
    for axis, tables in dyn_tables:
        obligations.append(
            Obligation(
                kind="table_writes_disjoint",
                param=w.param.name,
                tables=tables,
                axis=axis,
                size=w.region.sizes[axis],
                writable=True,
            )
        )
    missing = [v for v in cell_vars if v not in covered]
    if missing:
        raise VerifyError(
            f"{name}: write race on {w.param.name}: grid var(s) "
            f"{', '.join(sorted(missing))} never reach the output window "
            f"{w.region!r} — two grid cells write the same region"
        )
    # vars that reach the window but defeat the affine proof are accepted
    # (documented limitation: we reject proven races, we don't demand a
    # disjointness proof for every non-affine pattern)
    del proven


def verify_module(m: LoweredModule) -> List[Obligation]:
    """Run all static checks; returns the runtime obligations."""
    name = m.program.name
    obligations: List[Obligation] = []
    for w in list(m.in_windows) + list(m.out_windows):
        _check_bounds(name, w, obligations)
    pipe_var = (
        m.phases.pipeline.var.name if m.phases.pipeline is not None else None
    )
    # grid cells = parallel kernel axes; the pipelined axis revisits the
    # *same* cell (accumulator semantics), so it is exempt from race checks
    cell_vars = {
        v.name: int(e)
        for v, e in m.program.grid_axes
        if e > 1 and v.name != pipe_var
    }
    for w in m.out_windows:
        _check_races(name, w, cell_vars, obligations)
    check_alias_marks(m)
    # one obligation per distinct check, even when several windows merge
    seen = set()
    unique: List[Obligation] = []
    for ob in obligations:
        if ob not in seen:
            seen.add(ob)
            unique.append(ob)
    return unique


def pass_verify(m: LoweredModule) -> None:
    m.obligations = verify_module(m)
