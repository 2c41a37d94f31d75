"""The TileLang-style Python-embedded frontend (``import ... as T``).

A kernel is an ordinary Python function whose parameters are annotated with
:class:`Tensor` placeholders.  Decorating it with :func:`prim_func` executes
the body once with symbolic values ("tracing"), producing a
:class:`TileProgram` — a grid, explicit buffer allocations, and a tree of
tile operators.  The program is then compiled by ``core.compile`` to a CUDA
kernel for the card or run by the reference interpreter over torch tensors.

Dataflow vs scheduling (the paper's thesis) shows up directly here: the body
only ever states *what moves where* (T.copy/T.gemm/T.reduce over explicitly
placed buffers); *how* it runs (grid pipelining, layouts, vectorization,
swizzles) is carried by annotations (T.Pipelined/T.annotate_layout/
T.use_swizzle) and otherwise inferred.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

from .buffer import (
    FRAGMENT,
    GLOBAL,
    SCALAR,
    SHARED,
    Region,
    TileBuffer,
    canonical_dtype,
)
from .errors import TraceError
from .expr import (
    BinExpr,
    CastExpr,
    ConstExpr,
    Expr,
    UnaryExpr,
    VarExpr,
    WhereExpr,
    wrap,
)
from .tile_ops import (
    AtomicOp,
    CopyOp,
    CumsumOp,
    CustomOp,
    FillOp,
    GemmOp,
    ParallelOp,
    PipelinedOp,
    ReduceOp,
    SerialOp,
    TileOp,
    as_region,
    resolve_copy_regions,
)

_name_counter = itertools.count()


# ---------------------------------------------------------------------------
# Builder state
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Annotations:
    layouts: Dict[str, Any] = dataclasses.field(default_factory=dict)
    swizzle: Optional[int] = None
    extra: Dict[str, Any] = dataclasses.field(default_factory=dict)


class ProgramBuilder:
    def __init__(self, name: str):
        self.name = name
        self.grid_axes: List[Tuple[VarExpr, int]] = []
        self.threads: Optional[int] = None
        self.allocs: List[TileBuffer] = []
        self.annotations = Annotations()
        self._op_stack: List[List[TileOp]] = [[]]
        self._parallel_stack: List[ParallelOp] = []
        self.kernel_entered = False

    # -- op recording -----------------------------------------------------
    @property
    def ops(self) -> List[TileOp]:
        return self._op_stack[0]

    def record(self, op: TileOp):
        self._op_stack[-1].append(op)

    def push_ops(self, lst: List[TileOp]):
        self._op_stack.append(lst)

    def pop_ops(self):
        self._op_stack.pop()


_BUILDERS: List[ProgramBuilder] = []


def _builder() -> ProgramBuilder:
    if not _BUILDERS:
        raise TraceError(
            "Tile-language primitive used outside a @T.prim_func body."
        )
    return _BUILDERS[-1]


def current_parallel_context() -> Optional["_ParallelRecorder"]:
    if not _BUILDERS:
        return None
    b = _BUILDERS[-1]
    return b._parallel_stack[-1] if b._parallel_stack else None  # type: ignore[return-value]


# ---------------------------------------------------------------------------
# Signature placeholders
# ---------------------------------------------------------------------------


class Tensor:
    """Annotation for a global (HBM) tensor parameter: ``A: T.Tensor(shape, dtype)``."""

    def __init__(self, shape: Sequence[Union[int, Any]], dtype: str = "float32"):
        self.shape = tuple(int(s) for s in shape)
        self.dtype = canonical_dtype(dtype)

    def __repr__(self):
        return f"T.Tensor({self.shape}, {self.dtype!r})"


Buffer = Tensor  # alias familiar from TVM-style frontends


class ScalarTensor(Tensor):
    """Annotation for a scalar-prefetch parameter: a small integer tensor
    (block tables, sequence lengths) whose *elements* may appear in index
    expressions — including the starts of global->shared ``T.copy`` regions,
    which is how a kernel gathers non-contiguous tiles (paged KV pages).

    The reference interpreter reads them as plain tensors; the CUDA backend
    does not take them yet.  Only integer dtypes are allowed.
    """

    def __init__(self, shape: Sequence[Union[int, Any]], dtype: str = "int32"):
        super().__init__(shape, dtype)
        if not self.dtype.startswith(("int", "uint")):
            raise TraceError(
                f"T.ScalarTensor must have an integer dtype, got {self.dtype!r}"
            )


# ---------------------------------------------------------------------------
# The traced program
# ---------------------------------------------------------------------------


class TileProgram:
    def __init__(
        self,
        name: str,
        params: List[TileBuffer],
        grid_axes: List[Tuple[VarExpr, int]],
        threads: Optional[int],
        ops: List[TileOp],
        allocs: List[TileBuffer],
        annotations: Annotations,
        source_lines: int = 0,
    ):
        self.name = name
        self.params = params
        self.grid_axes = grid_axes
        self.threads = threads
        self.ops = ops
        self.allocs = allocs
        self.annotations = annotations
        self.source_lines = source_lines
        self._validate()

    # -- dataflow classification -------------------------------------------
    def _walk(self, ops=None):
        for op in self.ops if ops is None else ops:
            yield op
            if isinstance(op, (PipelinedOp, SerialOp)):
                yield from self._walk(op.body)

    def written_globals(self) -> List[TileBuffer]:
        seen, out = set(), []
        for op in self._walk():
            for b in op.buffers_written():
                if b.scope == GLOBAL and id(b) not in seen:
                    seen.add(id(b))
                    out.append(b)
        return out

    def read_globals(self) -> List[TileBuffer]:
        seen, out = set(), []
        for op in self._walk():
            for b in op.buffers_read():
                if b.scope == GLOBAL and id(b) not in seen:
                    seen.add(id(b))
                    out.append(b)
        return out

    def input_params(self) -> List[TileBuffer]:
        written = {id(b) for b in self.written_globals()}
        return [p for p in self.params if id(p) not in written]

    def output_params(self) -> List[TileBuffer]:
        written = {id(b) for b in self.written_globals()}
        return [p for p in self.params if id(p) in written]

    def pipelined_ops(self) -> List[PipelinedOp]:
        return [op for op in self._walk() if isinstance(op, PipelinedOp)]

    def scalar_params(self) -> List[TileBuffer]:
        """Scalar-prefetch params (T.ScalarTensor), in declaration order."""
        return [p for p in self.params if p.scope == SCALAR]

    def scalar_reads(self) -> List[TileBuffer]:
        """Scalar-prefetch buffers read anywhere (index exprs or bodies)."""
        from .expr import loads_in
        from .tile_ops import AtomicOp, CopyOp, FillOp, ParallelOp

        seen, out = set(), []

        def note(e):
            for ld in loads_in(e):
                b = ld.buffer
                if b.scope == SCALAR and id(b) not in seen:
                    seen.add(id(b))
                    out.append(b)

        for op in self._walk():
            if isinstance(op, CopyOp):
                for e in (*op.src.starts, *op.dst.starts):
                    note(e)
            elif isinstance(op, FillOp):
                note(op.value)
            elif isinstance(op, AtomicOp):
                for e in op.dst.starts:
                    note(e)
            elif isinstance(op, ParallelOp):
                for _, idx, val in op.stores:
                    for e in (*idx, val):
                        note(e)
        return out

    def _validate(self):
        if not self.grid_axes:
            raise TraceError(f"{self.name}: no T.Kernel context was entered.")
        reads = {id(b) for b in self.read_globals()}
        reads |= {id(b) for b in self.scalar_reads()}
        writes = {id(b) for b in self.written_globals()}
        for p in self.params:
            if id(p) not in reads and id(p) not in writes:
                # unused params are allowed (kernel libraries) but flagged
                self.annotations.extra.setdefault("unused_params", []).append(p.name)

    def __repr__(self):
        g = "x".join(str(e) for _, e in self.grid_axes)
        return f"TileProgram({self.name}, grid={g}, {len(self.ops)} top ops)"


# ---------------------------------------------------------------------------
# prim_func decorator
# ---------------------------------------------------------------------------


def prim_func(fn: Callable) -> TileProgram:
    """Trace ``fn`` into a TileProgram.

    Parameters must be annotated with :class:`Tensor` instances.  The body is
    executed exactly once with symbolic values.
    """
    sig = inspect.signature(fn)
    params: List[TileBuffer] = []
    kwargs = {}
    for pname, p in sig.parameters.items():
        ann = p.annotation
        if isinstance(ann, str):
            raise TraceError(
                f"{fn.__name__}: parameter {pname!r} has a postponed annotation "
                f"({ann!r}); a @T.prim_func needs its T.Tensor objects (drop "
                "'from __future__ import annotations' in its module)"
            )
        if not isinstance(ann, Tensor):
            raise TraceError(
                f"{fn.__name__}: parameter {pname!r} must be annotated with "
                f"T.Tensor(shape, dtype); got {ann!r}"
            )
        scope = SCALAR if isinstance(ann, ScalarTensor) else GLOBAL
        buf = TileBuffer(ann.shape, ann.dtype, scope, name=pname)
        params.append(buf)
        kwargs[pname] = buf

    builder = ProgramBuilder(fn.__name__)
    _BUILDERS.append(builder)
    try:
        fn(**kwargs)
    finally:
        _BUILDERS.pop()

    try:
        src = inspect.getsource(fn)
        nlines = len([l for l in src.splitlines() if l.strip() and not l.strip().startswith("#")])
    except (OSError, TypeError):
        nlines = 0

    return TileProgram(
        fn.__name__,
        params,
        builder.grid_axes,
        builder.threads,
        builder.ops,
        builder.allocs,
        builder.annotations,
        source_lines=nlines,
    )


# ---------------------------------------------------------------------------
# Kernel context and loops
# ---------------------------------------------------------------------------


class Kernel:
    """``with T.Kernel(n0, n1, ..., threads=...) as (b0, b1, ...):``

    Declares the launch grid: the CUDA backend launches one thread block a
    cell of the parallel grid, ``threads`` threads a block (128 when not
    given; at most 1024).
    """

    def __init__(self, *dims: int, threads: Optional[int] = None):
        if not dims:
            raise TraceError("T.Kernel needs at least one grid dimension")
        self.dims = [int(d) for d in dims]
        if any(d <= 0 for d in self.dims):
            raise TraceError(f"Grid dims must be positive, got {self.dims}")
        if threads is not None and not 0 < int(threads) <= 1024:
            raise TraceError(f"threads must be in [1, 1024] (a CUDA block), got {threads}")
        self.threads = threads

    def __enter__(self):
        b = _builder()
        if b.kernel_entered:
            raise TraceError("Only one T.Kernel context per program is supported")
        b.kernel_entered = True
        b.threads = self.threads
        names = "xyzuvw"
        vars_ = []
        for i, d in enumerate(self.dims):
            v = VarExpr(f"b{names[i]}", extent=d)
            b.grid_axes.append((v, d))
            vars_.append(v)
        return vars_[0] if len(vars_) == 1 else tuple(vars_)

    def __exit__(self, exc_type, exc, tb):
        return False


class _LoopIter:
    """Common machinery for Pipelined/serial/unroll loop tracing: yields one
    symbolic index, body ops are collected into the loop op."""

    def __init__(self, op, var: VarExpr):
        self.op = op
        self.var = var

    def __iter__(self):
        b = _builder()
        b.record(self.op)
        b.push_ops(self.op.body)
        try:
            yield self.var
        finally:
            b.pop_ops()


def Pipelined(
    extent: int,
    num_stages: int = 2,
    order: Optional[Sequence[int]] = None,
    stage: Optional[Sequence[int]] = None,
) -> _LoopIter:
    """Software-pipelined loop (paper §4.4).

    ``num_stages`` is the multi-buffering depth; ``order``/``stage`` allow an
    explicitly user-defined pipeline as in the paper.  The grid plan makes
    this loop the innermost (``arbitrary``) axis; the CUDA backend runs it
    as a serial loop inside each block.
    """
    extent = int(extent)
    if extent <= 0:
        raise TraceError(f"T.Pipelined extent must be positive, got {extent}")
    if num_stages < 1:
        raise TraceError("num_stages must be >= 1")
    var = VarExpr(f"k{next(_name_counter)}", extent=extent)
    return _LoopIter(PipelinedOp(var, extent, num_stages, [], order, stage), var)


def serial(extent: int) -> _LoopIter:
    var = VarExpr(f"s{next(_name_counter)}", extent=int(extent))
    return _LoopIter(SerialOp(var, int(extent), unroll=False, body=[]), var)


def unroll(extent: int) -> _LoopIter:
    var = VarExpr(f"u{next(_name_counter)}", extent=int(extent))
    return _LoopIter(SerialOp(var, int(extent), unroll=True, body=[]), var)


class _ParallelRecorder:
    def __init__(self, op: ParallelOp):
        self.op = op

    def record_store(self, buffer: TileBuffer, idx: Tuple[Expr, ...], value: Expr):
        if buffer.scope == GLOBAL:
            raise TraceError(
                f"Elementwise store to global buffer {buffer.name}; stage "
                "through shared/fragment and T.copy instead."
            )
        if buffer.scope == SCALAR:
            raise TraceError(
                f"Scalar-prefetch buffer {buffer.name} is read-only."
            )
        self.op.stores.append((buffer, idx, value))


class Parallel:
    """``for i, j in T.Parallel(e0, e1):`` — elementwise iteration space.

    The body may only read/write shared+fragment buffers with scalar
    expressions; thread binding and vectorization are inferred (Fig. 8).
    """

    def __init__(self, *extents: int):
        if not extents:
            raise TraceError("T.Parallel needs at least one extent")
        self.extents = tuple(int(e) for e in extents)

    def __iter__(self):
        b = _builder()
        axes = tuple(
            VarExpr(f"p{next(_name_counter)}", extent=e) for e in self.extents
        )
        op = ParallelOp(axes, self.extents, [])
        b.record(op)
        rec = _ParallelRecorder(op)
        b._parallel_stack.append(rec)
        try:
            yield axes[0] if len(axes) == 1 else axes
        finally:
            b._parallel_stack.pop()


# ---------------------------------------------------------------------------
# Allocation
# ---------------------------------------------------------------------------


def _alloc(shape, dtype, scope, name=None) -> TileBuffer:
    b = _builder()
    if isinstance(shape, int):
        shape = (shape,)
    buf = TileBuffer(tuple(shape), dtype, scope, name=name)
    b.allocs.append(buf)
    return buf


def alloc_shared(shape, dtype: str = "float32", name: Optional[str] = None) -> TileBuffer:
    """Allocate a tile in the block's shared memory."""
    return _alloc(shape, dtype, SHARED, name)


def alloc_fragment(shape, dtype: str = "float32", name: Optional[str] = None) -> TileBuffer:
    """Allocate a block-level accumulator (in shared memory on the CUDA
    backend today; the Fragment layout describes its (warp tile, slot)
    partitioning — see layout.py)."""
    return _alloc(shape, dtype, FRAGMENT, name)


alloc_local = alloc_fragment


# ---------------------------------------------------------------------------
# Dataflow operators
# ---------------------------------------------------------------------------


def copy(src, dst):
    s, d = resolve_copy_regions(as_region(src), as_region(dst))
    _builder().record(CopyOp(s, d))


def gemm(
    a: TileBuffer,
    b: TileBuffer,
    c: TileBuffer,
    transpose_A: bool = False,
    transpose_B: bool = False,
    policy: Optional[str] = None,
    clear_accum: bool = False,
):
    for x, nm in ((a, "A"), (b, "B"), (c, "C")):
        if not isinstance(x, TileBuffer):
            raise TraceError(f"T.gemm operand {nm} must be a whole tile buffer")
        if x.scope == GLOBAL:
            raise TraceError(
                f"T.gemm operand {nm} ({x.name}) is global; stage through "
                "shared/fragment first (dataflow must be explicit)."
            )
    am, ak = (a.shape[-2], a.shape[-1]) if not transpose_A else (a.shape[-1], a.shape[-2])
    bk, bn = (b.shape[-2], b.shape[-1]) if not transpose_B else (b.shape[-1], b.shape[-2])
    if ak != bk:
        raise TraceError(f"T.gemm: contraction mismatch K={ak} vs {bk}")
    if (c.shape[-2], c.shape[-1]) != (am, bn):
        raise TraceError(
            f"T.gemm: accumulator shape {c.shape} != ({am}, {bn})"
        )
    if clear_accum:
        _builder().record(FillOp(c, ConstExpr(0.0, "float32")))
    _builder().record(
        GemmOp(a, b, c, transpose_A, transpose_B, policy, m=am, n=bn, k=ak)
    )


def fill(buffer: TileBuffer, value):
    _builder().record(FillOp(buffer, wrap(value)))


def clear(buffer: TileBuffer):
    fill(buffer, 0.0 if buffer.dtype.startswith(("float", "bf")) else 0)


def _reduce(kind, src, dst, dim, clear):
    if not isinstance(src, TileBuffer) or not isinstance(dst, TileBuffer):
        raise TraceError("T.reduce operands must be whole buffers")
    if dim < 0:
        dim += src.ndim
    expect = tuple(s for i, s in enumerate(src.shape) if i != dim)
    if tuple(dst.shape) != expect and not (expect == () and dst.size == 1):
        raise TraceError(
            f"T.reduce_{kind}: dst shape {dst.shape} != {expect} "
            f"(src {src.shape} minus axis {dim})"
        )
    _builder().record(ReduceOp(kind, src, dst, dim, clear))


def reduce_sum(src, dst, dim: int = -1, clear: bool = True):
    _reduce("sum", src, dst, dim, clear)


def reduce_max(src, dst, dim: int = -1, clear: bool = True):
    _reduce("max", src, dst, dim, clear)


def reduce_min(src, dst, dim: int = -1, clear: bool = True):
    _reduce("min", src, dst, dim, clear)


def reduce_absmax(src, dst, dim: int = -1, clear: bool = True):
    _reduce("absmax", src, dst, dim, clear)


def cumsum(src, dst, dim: int = -1, reverse: bool = False):
    if dim < 0:
        dim += src.ndim
    _builder().record(CumsumOp(src, dst, dim, reverse))


def _atomic(kind: str, dst, src):
    from .tile_ops import _resolve_against

    dres = _resolve_against(as_region(dst), as_region(src))
    _builder().record(AtomicOp(kind, dres, src))


def atomic_add(dst, src):
    """``dst += src`` element by element, ``dst`` a region of a global
    tensor that blocks of the grid may share."""
    _atomic("add", dst, src)


def atomic_max(dst, src):
    """``dst = torch.maximum(dst, src)`` element by element, as
    ``atomic_add``."""
    _atomic("max", dst, src)


def atomic_min(dst, src):
    """``dst = torch.minimum(dst, src)`` element by element, as
    ``atomic_add``."""
    _atomic("min", dst, src)


def call_tile_lib(fn: Callable, output: TileBuffer, *inputs: TileBuffer, name=None):
    """Tile-library escape hatch (the analogue of T.call_extern/T.ptx):
    ``fn`` maps the input tiles, torch tensors, to the output tile."""
    _builder().record(CustomOp(fn, tuple(inputs), output, name or fn.__name__))


# ---------------------------------------------------------------------------
# Scheduling annotations
# ---------------------------------------------------------------------------


def annotate_layout(mapping: Dict[TileBuffer, Any]):
    b = _builder()
    for buf, layout in mapping.items():
        b.annotations.layouts[buf.name] = layout


def use_swizzle(factor: int = 8):
    """Rasterization swizzle over the parallel grid: panels of ``factor``
    rows of blocks, for L2 reuse (schedule.swizzle_decode)."""
    _builder().annotations.swizzle = int(factor)


def import_source(*_args, **_kw):
    """GPU-only source injection; recorded as a no-op for source compat."""
    _builder().annotations.extra.setdefault("import_source", True)


# ---------------------------------------------------------------------------
# Scalar math / expression helpers
# ---------------------------------------------------------------------------


def _unary(op):
    def f(x):
        return UnaryExpr(op, wrap(x))

    return f


exp = _unary("exp")
exp2 = _unary("exp2")
log = _unary("log")
log2 = _unary("log2")
sqrt = _unary("sqrt")
rsqrt = _unary("rsqrt")
abs = _unary("abs")  # noqa: A001 - mirrors T.abs
tanh = _unary("tanh")
sigmoid = _unary("sigmoid")
floor = _unary("floor")
ceil = _unary("ceil")


def maximum(a, b):
    return BinExpr("max", wrap(a), wrap(b))


def minimum(a, b):
    return BinExpr("min", wrap(a), wrap(b))


def if_then_else(cond, a, b):
    return WhereExpr(wrap(cond), wrap(a), wrap(b))


def cast(x, dtype: str):
    return CastExpr(wrap(x), canonical_dtype(dtype))


def float32(x):
    return cast(x, "float32")


def float16(x):
    return cast(x, "float16")


def bfloat16(x):
    return cast(x, "bfloat16")


def int32(x):
    return cast(x, "int32")


def infinity(dtype: str = "float32"):
    return ConstExpr(float("inf"), canonical_dtype(dtype))


def ceildiv(a, b):
    if isinstance(a, int) and isinstance(b, int):
        return -(-a // b)
    return (wrap(a) + (wrap(b) - 1)) // b
