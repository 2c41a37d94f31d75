"""Priority-ordered layout & binding inference (paper §4.1–4.2).

The paper's scheme: maintain a LayoutMap over all buffers; process tile
operators from the *strictest* layout requirements down to the most flexible,
letting strict ops (tensor-core GEMM) pin layouts that flexible ops
(elementwise) must then conform to.  The walk is the JAX package's
(``repro.core.infer``) on the card's geometry (layout.py):

  level 0 (STRICT)  GemmOp  — tensor-core (mma m16n8k16) alignment, warp
                     fragments for operands/accumulator
  level 1 (COMMON)  Copy/Reduce — shared tiles padded to whole 16-byte rows,
                     contiguous minor dims
  level 2 (FLEX)    Parallel/Fill — whatever is still unbound; vectorization
                     width (lanes of a warp) and replication inferred per
                     Fig. 7/8

The result feeds the cost report (padding waste, tensor-core utilization)
and tests that assert the Fig. 7 replication semantics.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from .buffer import FRAGMENT, GLOBAL, SCALAR, SHARED, TileBuffer
from .errors import LayoutError
from .expr import VarExpr, linear_decompose
from .layout import (
    MMA,
    WARP,
    Fragment,
    Layout,
    mma_k,
    padded,
    round_up,
    vector_elems,
    warp_fragment,
)
from .tile_ops import (
    LEVEL_COMMON,
    LEVEL_FLEX,
    LEVEL_STRICT,
    CopyOp,
    CustomOp,
    FillOp,
    GemmOp,
    ParallelOp,
    PipelinedOp,
    ReduceOp,
    SerialOp,
    TileOp,
)


@dataclasses.dataclass
class GemmReport:
    op: str
    m: int
    n: int
    k: int
    mma_m: int
    mma_n: int
    mma_k: int
    a_dtype: str = "float32"

    @property
    def mma_utilization(self) -> float:
        """Fraction of tensor-core issue slots doing useful work for this
        tile (the tile padded to whole m16n8k instructions)."""
        return (self.m / self.mma_m) * (self.n / self.mma_n) * (self.k / self.mma_k)


@dataclasses.dataclass
class ParallelBinding:
    """Inferred binding for one T.Parallel op (paper Fig. 7/8)."""

    axes: Tuple[str, ...]
    extents: Tuple[int, ...]
    vector_width: int  # lanes engaged on the innermost axis
    # buffer -> replication count (elements held in >1 partition)
    replication: Dict[str, int] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class InferenceResult:
    layouts: Dict[str, Layout]
    gemms: List[GemmReport]
    parallels: List[ParallelBinding]
    waste: Dict[str, float]

    def summary(self) -> str:
        lines = ["layout inference:"]
        for name, lay in self.layouts.items():
            w = self.waste.get(name, 0.0)
            lines.append(f"  {name:<18} {lay!r}" + (f"  waste={w:.0%}" if w else ""))
        for g in self.gemms:
            lines.append(
                f"  gemm {g.op}: {g.m}x{g.n}x{g.k} on mma tiles "
                f"{g.mma_m}x{g.mma_n}x{g.mma_k} util={g.mma_utilization:.0%}"
            )
        for p in self.parallels:
            rep = {k: v for k, v in p.replication.items() if v > 1}
            lines.append(
                f"  parallel {p.axes}: vec={p.vector_width}"
                + (f" replicated={rep}" if rep else "")
            )
        return "\n".join(lines)


def _walk(ops):
    for op in ops:
        yield op
        if isinstance(op, (PipelinedOp, SerialOp)):
            yield from _walk(op.body)


def _padded_layout(buf: TileBuffer) -> Layout:
    """Physical shared-memory layout: identity coordinates inside a box whose
    rows are whole 16-byte vectors (the non-bijective padding layout of paper
    Fig. 5c)."""
    if buf.ndim == 0:
        raise LayoutError(f"Scalar buffer {buf.name} not supported")
    pad_to = list(buf.shape)
    pad_to[-1] = round_up(pad_to[-1], vector_elems(buf.dtype))
    return padded(buf.shape, pad_to)


def _fragment_layout(buf: TileBuffer) -> Fragment:
    """Warp fragment over the last two dims (leading dims repeat tiles)."""
    if buf.ndim == 1:
        return warp_fragment((1, buf.shape[-1]))
    frag = warp_fragment((buf.shape[-2], buf.shape[-1]))
    for d in range(buf.ndim - 3, -1, -1):
        frag = frag.repeat(buf.shape[d], axis=0)
    return frag


def infer_layouts(program) -> InferenceResult:
    layouts: Dict[str, Layout] = {}
    gemms: List[GemmReport] = []
    parallels: List[ParallelBinding] = []

    # User annotations always win (T.annotate_layout).
    user = dict(program.annotations.layouts)

    def assign(buf: TileBuffer, make):
        # GLOBAL operands live in HBM; SCALAR operands live in SMEM and are
        # read element-wise — neither gets an on-chip tile layout.
        if buf.scope in (GLOBAL, SCALAR) or buf.name in layouts:
            return
        if buf.name in user:
            layouts[buf.name] = user[buf.name]
            return
        layouts[buf.name] = make(buf)

    ops = list(_walk(program.ops))

    # ---- level 0: GEMM (strict) ------------------------------------------
    for op in ops:
        if not isinstance(op, GemmOp):
            continue
        for buf in (op.a, op.b):
            assign(buf, _padded_layout if buf.scope == SHARED else _fragment_layout)
        assign(op.c, _fragment_layout)
        # tensor-core alignment: M and N pad to whole m16n8 instructions,
        # the contraction dim K to the instruction's depth on the operand
        # dtype (256 bits).
        gemms.append(
            GemmReport(
                op=f"{op.a.name}@{op.b.name}",
                m=op.m,
                n=op.n,
                k=op.k,
                mma_m=round_up(op.m, MMA[0]),
                mma_n=round_up(op.n, MMA[1]),
                mma_k=round_up(op.k, mma_k(op.a.dtype)),
                a_dtype=op.a.dtype,
            )
        )

    # ---- level 1: copy / reduce (common) -----------------------------------
    for op in ops:
        if isinstance(op, CopyOp):
            for buf in (op.src.buffer, op.dst.buffer):
                assign(buf, _padded_layout if buf.scope == SHARED else _fragment_layout)
        elif isinstance(op, ReduceOp):
            assign(op.src, _fragment_layout if op.src.scope == FRAGMENT else _padded_layout)
            assign(op.dst, _fragment_layout if op.dst.scope == FRAGMENT else _padded_layout)

    # ---- level 2: elementwise / fill (flex) ---------------------------------
    for op in ops:
        if isinstance(op, FillOp):
            assign(op.buffer, _padded_layout if op.buffer.scope == SHARED else _fragment_layout)
        elif isinstance(op, CustomOp):
            for buf in (*op.inputs, op.output):
                assign(buf, _padded_layout if buf.scope == SHARED else _fragment_layout)
        elif isinstance(op, ParallelOp):
            for buf in (*op.buffers_read(), *op.buffers_written()):
                assign(buf, _padded_layout if buf.scope == SHARED else _fragment_layout)
            parallels.append(_infer_parallel_binding(op))

    # ---- waste accounting ----------------------------------------------------
    waste: Dict[str, float] = {}
    by_name = {b.name: b for b in program.allocs}
    for name, lay in layouts.items():
        buf = by_name.get(name)
        if buf is None:
            continue
        phys = math.prod(lay.out_shape()) if not isinstance(lay, Fragment) else None
        if phys is None:
            # fragments: partition*local slots
            shp = lay.out_shape()
            phys = math.prod(shp)
        log = buf.size
        waste[name] = max(0.0, 1.0 - log / max(phys, 1))

    return InferenceResult(layouts, gemms, parallels, waste)


def _infer_parallel_binding(op: ParallelOp) -> ParallelBinding:
    """Replication & vectorization inference for one elementwise op.

    A buffer whose index expressions do not mention some parallel axis is
    *replicated* across that axis (paper Fig. 7: the bias row needed by every
    thread column).  The innermost axis determines the vector width: if the
    buffer accesses are affine with unit stride in that axis, consecutive
    lanes of a warp take consecutive elements (up to 32).
    """
    from .expr import free_vars, loads_in

    axis_names = tuple(a.name for a in op.axes)
    replication: Dict[str, int] = {}
    unit_stride = True
    inner = axis_names[-1]

    def visit_access(buf: TileBuffer, idx_exprs):
        used = set()
        for e in idx_exprs:
            used |= free_vars(e)
        rep = 1
        for nm, ext in zip(axis_names, op.extents):
            if nm not in used:
                rep *= ext
        prev = replication.get(buf.name, 1)
        replication[buf.name] = max(prev, rep)
        # unit-stride check on the innermost axis in the minor index
        if idx_exprs:
            dec = linear_decompose(idx_exprs[-1])
            nonlocal unit_stride
            if dec is None or dec.get(inner, 0) not in (0, 1):
                unit_stride = False

    for buf, idx, val in op.stores:
        visit_access(buf, idx)
        for ld in loads_in(val):
            visit_access(ld.buffer, ld.indices)

    vec = min(op.extents[-1], WARP) if unit_stride else 1
    return ParallelBinding(axis_names, tuple(op.extents), vec, replication)
