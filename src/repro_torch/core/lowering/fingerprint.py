"""Stable structural fingerprints for programs and schedules.

Two independently traced programs with identical structure must hash the
same even though tracing mints fresh buffer/variable names (``sbuf17``,
``k3``...), so the serializer renames buffers and loop variables to their
position in a canonical traversal.  The fingerprint keys the analysis and
compile caches: ``(program_fingerprint, schedule_key, target)`` identifies a
compiled kernel exactly (DESIGN.md §3.3).

``CustomOp`` bodies are opaque Python callables; they contribute
``(name, id(fn))`` so two programs sharing the *same* function object can
share a cache entry but freshly minted closures never alias each other.
"""
from __future__ import annotations

import hashlib
from typing import Dict, List

from ..buffer import TileBuffer
from ..expr import (
    BinExpr,
    CastExpr,
    ConstExpr,
    Expr,
    LoadExpr,
    UnaryExpr,
    VarExpr,
    WhereExpr,
)
from ..schedule import Schedule
from ..tile_ops import (
    AtomicOp,
    CopyOp,
    CumsumOp,
    CustomOp,
    FillOp,
    GemmOp,
    ParallelOp,
    PipelinedOp,
    ReduceOp,
    ResolvedRegion,
    SerialOp,
    TileOp,
)


class _Canon:
    """Stable id assignment for buffers and trace variables."""

    def __init__(self):
        self.bufs: Dict[int, str] = {}
        self.vars: Dict[str, str] = {}

    def buf(self, b: TileBuffer) -> str:
        key = id(b)
        if key not in self.bufs:
            self.bufs[key] = f"%b{len(self.bufs)}"
        return self.bufs[key]

    def var(self, name: str) -> str:
        if name not in self.vars:
            self.vars[name] = f"%v{len(self.vars)}"
        return self.vars[name]


def _ser_buf_decl(b: TileBuffer, c: _Canon) -> str:
    return f"{c.buf(b)}:{b.scope}:{b.dtype}:{b.shape}"


def _ser_expr(e: Expr, c: _Canon) -> str:
    if isinstance(e, ConstExpr):
        return f"c({e.value!r},{e.dtype})"
    if isinstance(e, VarExpr):
        return f"v({c.var(e.name)},{e.extent})"
    if isinstance(e, BinExpr):
        return f"b({e.op},{_ser_expr(e.lhs, c)},{_ser_expr(e.rhs, c)})"
    if isinstance(e, UnaryExpr):
        return f"u({e.op},{_ser_expr(e.operand, c)})"
    if isinstance(e, CastExpr):
        return f"cast({_ser_expr(e.operand, c)},{e.target_dtype})"
    if isinstance(e, WhereExpr):
        return (
            f"w({_ser_expr(e.cond, c)},{_ser_expr(e.then, c)},"
            f"{_ser_expr(e.otherwise, c)})"
        )
    if isinstance(e, LoadExpr):
        idx = ",".join(_ser_expr(i, c) for i in e.indices)
        return f"ld({c.buf(e.buffer)},[{idx}])"
    return f"expr({e!r})"


def _ser_region(r: ResolvedRegion, c: _Canon) -> str:
    starts = ",".join(_ser_expr(s, c) for s in r.starts)
    return f"{c.buf(r.buffer)}[{starts};{r.sizes};{r.collapsed}]"


def _ser_op(op: TileOp, c: _Canon, out: List[str]) -> None:
    if isinstance(op, CopyOp):
        out.append(f"copy({_ser_region(op.src, c)}->{_ser_region(op.dst, c)})")
    elif isinstance(op, GemmOp):
        out.append(
            f"gemm({c.buf(op.a)},{c.buf(op.b)},{c.buf(op.c)},"
            f"{op.transpose_a},{op.transpose_b},{op.m},{op.n},{op.k})"
        )
    elif isinstance(op, FillOp):
        out.append(f"fill({c.buf(op.buffer)},{_ser_expr(op.value, c)})")
    elif isinstance(op, ReduceOp):
        out.append(
            f"reduce({op.kind},{c.buf(op.src)},{c.buf(op.dst)},{op.axis},{op.clear})"
        )
    elif isinstance(op, CumsumOp):
        out.append(
            f"cumsum({c.buf(op.src)},{c.buf(op.dst)},{op.axis},{op.reverse})"
        )
    elif isinstance(op, ParallelOp):
        axes = ",".join(c.var(a.name) for a in op.axes)
        out.append(f"parallel[{axes};{op.extents}](")
        for buf, idx, val in op.stores:
            sidx = ",".join(_ser_expr(i, c) for i in idx)
            out.append(f"  st({c.buf(buf)},[{sidx}],{_ser_expr(val, c)})")
        out.append(")")
    elif isinstance(op, PipelinedOp):
        out.append(
            f"pipelined({c.var(op.var.name)},{op.extent},{op.num_stages},"
            f"{op.order},{op.stage}]("
        )
        for o in op.body:
            _ser_op(o, c, out)
        out.append(")")
    elif isinstance(op, SerialOp):
        out.append(f"serial({c.var(op.var.name)},{op.extent},{op.unroll}](")
        for o in op.body:
            _ser_op(o, c, out)
        out.append(")")
    elif isinstance(op, AtomicOp):
        out.append(f"atomic({op.kind},{_ser_region(op.dst, c)},{c.buf(op.src)})")
    elif isinstance(op, CustomOp):
        out.append(
            f"custom({op.name},{id(op.fn)},"
            f"{[c.buf(b) for b in op.inputs]},{c.buf(op.output)})"
        )
    else:
        out.append(f"op({op!r})")


def program_fingerprint(program) -> str:
    """Hex digest identifying the program's structure (not its trace names)."""
    c = _Canon()
    parts: List[str] = [program.name]
    for p in program.params:
        parts.append("param " + _ser_buf_decl(p, c))
    for v, e in program.grid_axes:
        parts.append(f"axis {c.var(v.name)}:{e}")
    for b in program.allocs:
        parts.append("alloc " + _ser_buf_decl(b, c))
    for op in program.ops:
        _ser_op(op, c, parts)
    ann = program.annotations
    parts.append(f"swizzle={ann.swizzle}")
    for name, layout in sorted(ann.layouts.items()):
        parts.append(f"layout {name}={layout!r}")
    blob = "\n".join(parts).encode()
    return hashlib.sha256(blob).hexdigest()


def schedule_key(schedule: Schedule) -> tuple:
    """Hashable key over the schedule fields that affect lowering output
    (``notes`` is advisory metadata and deliberately excluded)."""
    return (
        schedule.num_stages,
        schedule.grid_swizzle,
        tuple(schedule.dimension_semantics)
        if schedule.dimension_semantics is not None
        else None,
        schedule.smem_limit,
        schedule.workspace,
    )
