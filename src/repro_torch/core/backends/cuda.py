"""CUDA backend: a lowered tile program as CUDA C++ for ``sm_90a``.

The counterpart of the JAX package's ``backends/pallas_tpu.py``
(``emit_pallas``, repro/core/backends/pallas_tpu.py:59).  It reads the
:class:`LoweredModule` and writes one kernel by hand's rules, as text:

* one thread block a cell of the parallel grid, ``T.Kernel(threads=)``
  threads a block (128 when not given).  The parallel grid ids are decoded
  from ``blockIdx.x`` (``bx`` fastest) through the grid plan's own
  ``env_builder``, so a ``T.use_swizzle`` panel raster is decoded with
  ``schedule.swizzle_decode``'s arithmetic;
* the pipelined axis is a serial loop inside the block: PRE runs once
  before it and POST once after it (no ``k == 0`` / ``k == last`` guards);
* every ``shared`` and ``fragment`` buffer lives in dynamic shared memory at
  the offset the shared-memory plan (``schedule.plan_vmem``) gives it (two
  buffers whose live ranges do not meet may share bytes); the bytes
  requested at launch are the plan's, and a plan over the card's budget
  raises :class:`ScheduleError` instead of launching.  A plan made with
  ``Schedule(workspace=True)`` may put its largest buffers in a per-block
  global workspace instead: one more kernel operand, block ``b``'s part at
  ``b * workspace_bytes``, allocated at each launch, each buffer at its
  offset there; ``wmma`` reaches it through generic pointers and the same
  barriers order its accesses (``__syncthreads()`` orders a block's global
  accesses as its shared ones);
* each tile op is a block-strided loop over its elements (a copy moves
  16-byte vectors where its rows allow), with ``__syncthreads()`` wherever a
  later op touches bytes an earlier one wrote or read;
* ``T.gemm`` accumulates in fp32: 16-bit operands into an fp32 tile
  (``schedule.tensor_core_gemm``) go through ``wmma`` m16n16k16, each warp
  a group of 16 x 16 accumulator tiles, loaded from and stored back to
  shared memory each call, or held in the warp's registers for the whole
  pipelined loop when no other op of the loop touches the accumulator;
  everything else runs a loop on the CUDA cores.

Block tables (``T.ScalarTensor``, the TPU's scalar prefetch) are ``int32``
device operands of the kernel, read straight from global memory wherever an
index expression loads them: a copy's region start (``KPages[bh, Tables[bz,
k], 0, 0]``, the paged gather and the table-directed store), a mask, a
``T.minimum`` or ``T.if_then_else`` of entries.  Each thread reads the entry
itself; the block's table row is not staged in shared memory (a decode
block reads one entry a pipelined step, from L1 after the first thread).

Outputs are allocated by the wrapper: a pure output zero-filled, an in-out
one (a window the lowering marks ``aliased``, such as a page pool the
prefill writes through its table) a copy of its input, so pages no block
writes keep their contents and the caller's tensor is never written; the
kernel returns them in ``out_params`` order, as the reference interpreter
does.

Index arithmetic keeps Python's floor semantics (``//`` and ``%`` of a
possibly negative operand go through floor helpers); float16 / bfloat16
values are computed in fp32 and rounded to nearest even where their type
says so, as torch's ``.to()`` does.  The source is built with ``nvcc``
through ``kernels/build.py`` (its ``NVCC_FLAGS``, a plain C entry point,
ctypes) at the first call, into ``kernels/_build/``.

Every op of the T language is taken; nothing falls back to the reference
interpreter, and nothing runs on the host between launches:

* ``T.call_tile_lib`` (``CustomOp``): its torch function is rewritten into
  the T language's own ops before emission (``tile_lib.lower_tile_lib``, on
  a copy of the program that ``analyze`` then plans);
* ``T.atomic_add`` / ``_max`` / ``_min`` (``AtomicOp``): one atomic an
  element into the in-out window (``atomicAdd``; max and min by
  ``atomicCAS`` on the bit pattern for floats, NaN winning as in
  ``torch.maximum``);
* ``T.cumsum`` (``CumsumOp``): a thread a line, accumulated in fp32 (fp64,
  int64 for their types) and each prefix rounded to the source's type;
* a batched ``T.gemm``: the leading dims, broadcast as ``torch.matmul``'s,
  loop over the 2-D paths (``wmma`` or the CUDA cores).
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, List, Optional, Set, Tuple

import torch

from ..buffer import GLOBAL, SCALAR, TileBuffer, torch_dtype
from ..errors import LoweringError, ScheduleError
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
from ..lowering.module import CompiledKernel, LoweredInfo, LoweredModule
from ..schedule import WORKSPACE, tensor_core_gemm
from ..tile_ops import (
    AtomicOp,
    CopyOp,
    CumsumOp,
    FillOp,
    GemmOp,
    ParallelOp,
    PipelinedOp,
    ReduceOp,
    ResolvedRegion,
    SerialOp,
    TileOp,
)
from ..lowering import analyze
from . import register_backend
from .tile_lib import lower_tile_lib

DEFAULT_THREADS = 128

_CTYPE = {
    "float32": "float", "float64": "double", "bfloat16": "__nv_bfloat16",
    "float16": "__half", "int8": "signed char", "uint8": "unsigned char",
    "int16": "short", "int32": "int", "uint32": "unsigned int",
    "int64": "long long", "bool": "bool",
}
_FLOATS = ("float32", "float64", "bfloat16", "float16")
_WEAK_INT, _WEAK_FLOAT = "int", "float"  # Python numbers: they take the other side's type

_PRELUDE = r"""#include <cuda_runtime.h>
#include <cuda_fp16.h>
#include <cuda_bf16.h>
#include <mma.h>
#include <math.h>
#include <limits.h>

// Python's floor division and modulo (C's / and % truncate)
__device__ __forceinline__ int tl_floordiv(int a, int b) {
  int q = a / b;
  return (a % b != 0 && ((a < 0) != (b < 0))) ? q - 1 : q;
}
__device__ __forceinline__ int tl_mod(int a, int b) {
  int r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? r + b : r;
}
__device__ __forceinline__ float tl_fmod(float a, float b) { return a - b * floorf(a / b); }
// a 16-bit float value: computed in fp32, rounded to nearest even
__device__ __forceinline__ float tl_rbf16(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }
__device__ __forceinline__ float tl_rf16(float x) { return __half2float(__float2half_rn(x)); }
"""

# torch.maximum / torch.minimum as atomics on a float type: compare-and-swap
# on the bit pattern (16-bit types on their 16 bits), a NaN on either side
# winning as in torch
_CAS_ATOMICS = r"""
template <bool Max, typename F> __device__ __forceinline__ bool tl_takes(F cur, F v) {
  return (v != v && cur == cur) || (Max ? v > cur : v < cur);
}
template <bool Max> __device__ void tl_atomic_ext(float* p, float v) {
  unsigned int* a = reinterpret_cast<unsigned int*>(p);
  unsigned int old = *a, seen;
  do {
    seen = old;
    if (!tl_takes<Max>(__uint_as_float(seen), v)) return;
    old = atomicCAS(a, seen, __float_as_uint(v));
  } while (old != seen);
}
template <bool Max> __device__ void tl_atomic_ext(__half* p, float v) {
  unsigned short* a = reinterpret_cast<unsigned short*>(p);
  const __half h = __float2half_rn(v);
  unsigned short old = *a, seen;
  do {
    seen = old;
    if (!tl_takes<Max>(__half2float(__ushort_as_half(seen)), __half2float(h))) return;
    old = atomicCAS(a, seen, __half_as_ushort(h));
  } while (old != seen);
}
template <bool Max> __device__ void tl_atomic_ext(__nv_bfloat16* p, float v) {
  unsigned short* a = reinterpret_cast<unsigned short*>(p);
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  unsigned short old = *a, seen;
  do {
    seen = old;
    if (!tl_takes<Max>(__bfloat162float(__ushort_as_bfloat16(seen)), __bfloat162float(h))) return;
    old = atomicCAS(a, seen, __bfloat16_as_ushort(h));
  } while (old != seen);
}
"""
# the types an atomic takes: add by atomicAdd, max / min by atomicMax /
# atomicMin on int32 and by tl_atomic_ext on the floats
_ATOMIC_TYPES = ("float32", "float16", "bfloat16", "int32")


def _in_memory(buf: TileBuffer) -> bool:
    """A kernel operand in device memory (a tensor or a block table), laid
    out row-major at its own shape; the other buffers are the block's own,
    at the plan's offsets in shared memory or in the block's workspace
    (tracked by the barriers alike)."""
    return buf.scope in (GLOBAL, SCALAR)


def _is_float(dt: str) -> bool:
    return dt in _FLOATS or dt == _WEAK_FLOAT


def _is_int(dt: str) -> bool:
    return dt == _WEAK_INT or dt.startswith(("int", "uint"))


def _promote(a: str, b: str) -> str:
    """The result type of a binary op, as torch's promotion with Python
    numbers taking the tensor's type."""
    if a == b:
        return a
    if a == "bool":
        return b if b not in (_WEAK_INT,) else "int32"
    if b == "bool":
        return _promote(b, a)
    if _is_float(a) or _is_float(b):
        fa, fb = _is_float(a), _is_float(b)
        if fa and fb:
            if a == _WEAK_FLOAT:
                return b
            if b == _WEAK_FLOAT:
                return a
            if "float64" in (a, b):
                return "float64"
            return "float32"  # fp32 with a 16-bit float, or bf16 with fp16
        f = a if fa else b
        return "float32" if f == _WEAK_FLOAT else f
    if a == _WEAK_INT:
        return b
    if b == _WEAK_INT:
        return a
    return "int64" if "int64" in (a, b) else "int32"


def _compute_type(dt: str) -> str:
    """The C type a value of ``dt`` is computed in."""
    if dt == "float64":
        return "double"
    if _is_float(dt):
        return "float"
    if dt == "bool":
        return "bool"
    return "long long" if dt == "int64" else "int"


def _round(code: str, dt: str) -> str:
    """A computed value of a 16-bit float type rounded to that type."""
    if dt == "bfloat16":
        return f"tl_rbf16({code})"
    if dt == "float16":
        return f"tl_rf16({code})"
    return code


def _load(ptr: str, off: str, dt: str) -> str:
    if dt == "bfloat16":
        return f"__bfloat162float({ptr}[{off}])"
    if dt == "float16":
        return f"__half2float({ptr}[{off}])"
    return f"{ptr}[{off}]"


def _store_value(code: str, dt: str) -> str:
    """``code`` (a computed value) converted for a store into ``dt``."""
    if dt == "bfloat16":
        return f"__float2bfloat16_rn({code})"
    if dt == "float16":
        return f"__float2half_rn({code})"
    if dt == "bool":
        return f"(({code}) != 0)"
    return f"({_CTYPE[dt]})({code})"


def _float_literal(v: float) -> str:
    if math.isinf(v):
        return "INFINITY" if v > 0 else "(-INFINITY)"
    if math.isnan(v):
        return "NAN"
    text = repr(float(v))
    return f"{text}f" if ("." in text or "e" in text) else f"{text}.0f"


def _nonneg(e: Expr) -> bool:
    """Whether ``e`` is provably >= 0: grid, loop and parallel indices are,
    and sums, products, quotients and remainders of such values."""
    if isinstance(e, ConstExpr):
        return not isinstance(e.value, bool) and e.value >= 0
    if isinstance(e, VarExpr):
        return True
    if isinstance(e, BinExpr) and e.op in ("add", "mul", "floordiv", "mod", "max"):
        return _nonneg(e.lhs) and _nonneg(e.rhs)
    if isinstance(e, CastExpr):
        return _nonneg(e.operand)
    return False


class _Source:
    """Accumulates C++ lines at an indent."""

    def __init__(self):
        self.lines: List[str] = []
        self.depth = 0

    def __call__(self, line: str = ""):
        self.lines.append("  " * self.depth + line if line else "")

    def open(self, line: str):
        self(line + " {")
        self.depth += 1

    def close(self):
        self.depth -= 1
        self("}")

    def text(self) -> str:
        return "\n".join(self.lines) + "\n"


class _Emitter:
    """One program's kernel text."""

    def __init__(self, module: LoweredModule):
        self.m = module
        self.program = module.program
        self.threads = int(self.program.threads or DEFAULT_THREADS)
        self.src = _Source()
        self.var_names: Dict[str, str] = {}
        self.plan = {b.name: b for b in module.vmem.buffers}
        self.workspace_bytes = module.vmem.workspace_bytes
        self.ptr: Dict[str, str] = {}
        for i, p in enumerate(self.program.params):
            self.ptr[p.name] = f"g{i}"
        for i, b in enumerate(self.program.allocs):
            self.ptr[b.name] = f"s{i}"
        # hazards since the last barrier: block buffers written / read
        self.written: Set[str] = set()
        self.read: Set[str] = set()
        self.tmp = 0
        # accumulators held in registers over the pipelined loop: buffer
        # name -> fragment array
        self.promoted: Dict[str, str] = {}
        self.cas_atomics = False  # tl_atomic_ext called: its helpers go in the prelude

    # -- names ------------------------------------------------------------
    def var(self, name: str) -> str:
        if name not in self.var_names:
            self.var_names[name] = f"v{len(self.var_names)}"
        return self.var_names[name]

    def fresh(self, stem: str) -> str:
        self.tmp += 1
        return f"_{stem}{self.tmp}"

    # -- buffers ------------------------------------------------------------
    def strides(self, buf: TileBuffer) -> Tuple[int, ...]:
        shape = buf.shape if _in_memory(buf) else self.plan[buf.name].physical_shape
        out, acc = [], 1
        for s in reversed(shape):
            out.append(acc)
            acc *= s
        return tuple(reversed(out))

    def offset(self, buf: TileBuffer, coords: List[str]) -> str:
        wide = _in_memory(buf)
        terms = []
        for c, st in zip(coords, self.strides(buf)):
            if c == "0":
                continue
            c = f"(long long)({c})" if wide else f"({c})"
            terms.append(c if st == 1 else f"{c} * {st}{'LL' if wide else ''}")
        return " + ".join(terms) or "0"

    # -- expressions ----------------------------------------------------------
    def expr(self, e: Expr) -> Tuple[str, str]:
        """``(C code, type)`` of an expression; 16-bit float types are
        computed in fp32 and rounded where produced."""
        if isinstance(e, ConstExpr):
            v = e.value
            if isinstance(v, bool):
                return ("true" if v else "false"), "bool"
            if isinstance(v, int):
                return str(v), _WEAK_INT
            return _float_literal(v), _WEAK_FLOAT
        if isinstance(e, VarExpr):
            return self.var(e.name), _WEAK_INT
        if isinstance(e, LoadExpr):
            buf = e.buffer
            coords = [self.int_expr(i) for i in e.indices]
            return _load(self.ptr[buf.name], self.offset(buf, coords), buf.dtype), buf.dtype
        if isinstance(e, CastExpr):
            code, dt = self.expr(e.operand)
            tgt = e.target_dtype
            if tgt == "bool":
                return f"(({code}) != 0)", "bool"
            return _round(f"({_compute_type(tgt)})({code})", tgt), tgt
        if isinstance(e, WhereExpr):
            c, _ = self.expr(e.cond)
            (a, ta), (b, tb) = self.expr(e.then), self.expr(e.otherwise)
            t = _promote(ta, tb)
            ct = _compute_type(t)
            return f"(({c}) ? ({ct})({a}) : ({ct})({b}))", t
        if isinstance(e, UnaryExpr):
            return self.unary(e)
        if isinstance(e, BinExpr):
            return self.binary(e)
        raise LoweringError(f"cuda backend: unknown expression {e!r}")

    def int_expr(self, e: Expr) -> str:
        code, dt = self.expr(e)
        if not (_is_int(dt) or dt == "bool"):
            raise LoweringError(f"cuda backend: index {e!r} is not an integer ({dt})")
        return code

    def unary(self, e: UnaryExpr) -> Tuple[str, str]:
        code, dt = self.expr(e.operand)
        if e.op == "neg":
            return f"(-({code}))", dt
        if e.op == "abs" and _is_int(dt):
            return f"abs({code})", dt
        t = "float32" if dt in (_WEAK_INT, _WEAK_FLOAT) or _is_int(dt) or dt == "bool" else dt
        d = t == "float64"
        fns = {
            "exp": "exp" if d else "expf", "exp2": "exp2" if d else "exp2f",
            "log": "log" if d else "logf", "log2": "log2" if d else "log2f",
            "abs": "fabs" if d else "fabsf", "sqrt": "sqrt" if d else "sqrtf",
            "tanh": "tanh" if d else "tanhf", "floor": "floor" if d else "floorf",
            "ceil": "ceil" if d else "ceilf",
        }
        x = f"({_compute_type(t)})({code})"
        if e.op in fns:
            out = f"{fns[e.op]}({x})"
        elif e.op == "rsqrt":
            out = f"(1.0f / sqrtf({x}))" if not d else f"(1.0 / sqrt({x}))"
        elif e.op == "sigmoid":
            out = f"(1.0f / (1.0f + expf(-{x})))" if not d else f"(1.0 / (1.0 + exp(-{x})))"
        else:
            raise LoweringError(f"cuda backend: unknown unary op {e.op!r}")
        return _round(out, t), t

    def binary(self, e: BinExpr) -> Tuple[str, str]:
        (a, ta), (b, tb) = self.expr(e.lhs), self.expr(e.rhs)
        op = e.op
        if op in ("lt", "le", "gt", "ge", "eq", "ne"):
            sym = {"lt": "<", "le": "<=", "gt": ">", "ge": ">=", "eq": "==", "ne": "!="}[op]
            ct = _compute_type(_promote(ta, tb))
            return f"(({ct})({a}) {sym} ({ct})({b}))", "bool"
        if op in ("bitand", "bitor", "bitxor") and ta == tb == "bool":
            sym = {"bitand": "&&", "bitor": "||", "bitxor": "!="}[op]
            return f"(({a}) {sym} ({b}))", "bool"
        if op in ("shr", "shl", "bitand", "bitor", "bitxor"):
            sym = {"shr": ">>", "shl": "<<", "bitand": "&", "bitor": "|", "bitxor": "^"}[op]
            t = ta if op in ("shr", "shl") else _promote(ta, tb)
            if t == _WEAK_INT:
                t = "int32"
            return f"(({a}) {sym} ({b}))", t
        t = _promote(ta, tb)
        if op == "div" and not _is_float(t):
            t = "float32"  # true division of integers
        ct = _compute_type(t)
        x = a if _compute_type(ta) == ct else f"({ct})({a})"
        y = b if _compute_type(tb) == ct else f"({ct})({b})"
        if op in ("add", "sub", "mul", "div"):
            sym = {"add": "+", "sub": "-", "mul": "*", "div": "/"}[op]
            out = f"({x} {sym} {y})"
        elif op in ("floordiv", "mod"):
            if _is_float(t):
                out = f"floorf({x} / {y})" if op == "floordiv" else f"tl_fmod({x}, {y})"
            elif _nonneg(e.lhs) and _nonneg(e.rhs):
                out = f"({x} {'/' if op == 'floordiv' else '%'} {y})"
            else:
                out = f"tl_{'floordiv' if op == 'floordiv' else 'mod'}({x}, {y})"
        elif op in ("max", "min"):
            if _is_float(t):
                out = f"{'fmaxf' if op == 'max' else 'fminf'}({x}, {y})"
            else:
                out = f"{op}({x}, {y})"
        elif op == "pow":
            out = f"powf({x}, {y})" if _is_float(t) else f"(int)powf({x}, {y})"
        else:
            raise LoweringError(f"cuda backend: unknown binary op {op!r}")
        return _round(out, t), t

    # -- barriers -----------------------------------------------------------
    def touch(self, reads: List[TileBuffer], writes: List[TileBuffer]):
        """Emit a barrier when this op reads or writes a block buffer (shared
        or workspace) an earlier op wrote since the last one, or writes one
        read since."""
        r = {b.name for b in reads if not _in_memory(b)}
        w = {b.name for b in writes if not _in_memory(b)}
        if self.meet(r | w, self.written) or self.meet(w, self.read):
            self.barrier()
        self.read |= r
        self.written |= w

    def meet(self, names: Set[str], others: Set[str]) -> bool:
        """Whether a buffer of ``names`` shares bytes with one of ``others``
        (itself, or a buffer the plan placed over it in the same space)."""
        span = lambda n: (self.plan[n].space, self.plan[n].offset,  # noqa: E731
                          self.plan[n].offset + self.plan[n].bytes)
        return any(x == y and a < d and c < b
                   for (x, a, b) in map(span, names) for (y, c, d) in map(span, others))

    def barrier(self):
        self.src("__syncthreads();")
        self.written.clear()
        self.read.clear()

    # -- block-strided loops --------------------------------------------------
    def strided(self, shape: Tuple[int, ...], body) -> None:
        """``for`` each element of a box of ``shape``, threads striding:
        ``body(coords)`` emits the statements for one element."""
        n = math.prod(shape)
        e = self.fresh("e")
        self.src.open(f"for (int {e} = threadIdx.x; {e} < {n}; {e} += {self.threads})")
        body(self.unravel(e, shape))
        self.src.close()

    def unravel(self, e: str, shape: Tuple[int, ...]) -> List[str]:
        """Constants holding the coordinates of flat index ``e`` in a
        row-major box of ``shape``."""
        coords, inner = [], 1
        for d, size in reversed(list(enumerate(shape))):
            q = f"{e} / {inner}" if inner > 1 else e
            coords.append("0" if size == 1 else q if d == 0 else f"({q}) % {size}")
            inner *= size
        names = []
        for c in reversed(coords):
            name = self.fresh("i")
            self.src(f"const int {name} = {c};")
            names.append(name)
        return names

    # -- ops ----------------------------------------------------------------
    def ops(self, ops: List[TileOp]):
        for op in ops:
            self.op(op)

    def op(self, op: TileOp):
        if isinstance(op, CopyOp):
            self.copy(op)
        elif isinstance(op, FillOp):
            self.touch([], [op.buffer])
            code, _ = self.expr(op.value)
            buf = op.buffer
            self.strided(buf.shape, lambda c: self.src(
                f"{self.ptr[buf.name]}[{self.offset(buf, c)}] = "
                f"{_store_value(code, buf.dtype)};"))
        elif isinstance(op, ParallelOp):
            self.parallel(op)
        elif isinstance(op, ReduceOp):
            self.reduce(op)
        elif isinstance(op, GemmOp):
            self.gemm(op)
        elif isinstance(op, SerialOp):
            self.loop(op.var, op.extent, op.body)
        elif isinstance(op, PipelinedOp):
            raise LoweringError("cuda backend: a nested T.Pipelined loop")
        elif isinstance(op, AtomicOp):
            self.atomic(op)
        elif isinstance(op, CumsumOp):
            self.cumsum(op)
        else:
            raise LoweringError(f"cuda backend: unhandled op {op!r}")

    def loop(self, var: VarExpr, extent: int, body: List[TileOp]):
        if self.written or self.read:
            self.barrier()
        v = self.var(var.name)
        self.src.open(f"for (int {v} = 0; {v} < {extent}; ++{v})")
        self.ops(body)
        self.barrier()  # the next iteration overwrites what this one read
        self.src.close()

    def region_coords(self, region: ResolvedRegion, starts: List[str], tile: List[str]):
        out, it = [], iter(tile)
        for s, collapsed in zip(starts, region.collapsed):
            out.append(s if collapsed else (next(it) if s == "0" else f"{s} + {next(it)}"))
        return out

    def starts(self, region: ResolvedRegion, side: str) -> List[str]:
        """A region's starts, each a literal or a constant bound here."""
        names = []
        for e in region.starts:
            code = self.int_expr(e)
            if code.lstrip("-").isdigit():
                names.append(code)
            else:
                n = self.fresh(f"o{side}")
                self.src(f"const int {n} = {code};")
                names.append(n)
        return names

    def copy(self, op: CopyOp):
        src, dst = op.src, op.dst
        self.touch([src.buffer], [dst.buffer])
        starts = {"s": self.starts(src, "s"), "d": self.starts(dst, "d")}
        tile = src.tile_shape
        vec = self.vector_width(op, tile)
        sp, dp = self.ptr[src.buffer.name], self.ptr[dst.buffer.name]
        same = src.buffer.dtype == dst.buffer.dtype
        if vec > 1:
            box = tile[:-1] + (tile[-1] // vec,)

            def body(c):
                c = c[:-1] + [f"{c[-1]} * {vec}"]
                so = self.offset(src.buffer, self.region_coords(src, starts["s"], c))
                do = self.offset(dst.buffer, self.region_coords(dst, starts["d"], c))
                self.src(f"*reinterpret_cast<uint4*>(&{dp}[{do}]) = "
                         f"*reinterpret_cast<const uint4*>(&{sp}[{so}]);")

            self.strided(box, body)
            return

        def body(c):
            so = self.offset(src.buffer, self.region_coords(src, starts["s"], c))
            do = self.offset(dst.buffer, self.region_coords(dst, starts["d"], c))
            if same:
                self.src(f"{dp}[{do}] = {sp}[{so}];")
            else:
                value = _load(sp, so, src.buffer.dtype)
                self.src(f"{dp}[{do}] = {_store_value(value, dst.buffer.dtype)};")

        self.strided(tile, body)

    def vector_width(self, op: CopyOp, tile) -> int:
        """Elements a thread moves at once: 16 bytes when both sides hold the
        same type and every row of the tile is whole 16-byte vectors at
        16-byte aligned addresses (proved from the starts' affine form)."""
        from ..buffer import dtype_bits
        from ..expr import linear_decompose

        src, dst = op.src, op.dst
        if src.buffer.dtype != dst.buffer.dtype or not tile:
            return 1
        vec = 128 // dtype_bits(src.buffer.dtype)
        if tile[-1] % vec:
            return 1
        for r in (src, dst):
            if r.collapsed[-1]:
                return 1
            if any(st % vec for st in self.strides(r.buffer)[:-1]):
                return 1
            dec = linear_decompose(r.starts[-1])
            if dec is None or any(v % vec for v in dec.values()):
                return 1
            if not _in_memory(r.buffer) and self.plan[r.buffer.name].offset % 16:
                return 1
        return vec

    def parallel(self, op: ParallelOp):
        from ..expr import loads_in

        for buf, idx, val in op.stores:
            for ld in loads_in(val):
                if ld.buffer is buf and list(map(repr, ld.indices)) != list(map(repr, idx)):
                    raise LoweringError(
                        f"cuda backend: a T.Parallel store to {buf.name} reads it at "
                        "another index (threads would race)")
            self.touch(op.buffers_read(), [buf])
            names = [self.var(a.name) for a in op.axes]
            box = tuple(op.extents)

            def body(c, buf=buf, idx=idx, val=val):
                for n, ci in zip(names, c):
                    self.src(f"const int {n} = {ci};")
                code, _ = self.expr(val)
                coords = [self.int_expr(i) for i in idx]
                self.src(f"{self.ptr[buf.name]}[{self.offset(buf, coords)}] = "
                         f"{_store_value(code, buf.dtype)};")

            self.strided(box, body)

    def reduce(self, op: ReduceOp):
        reads = [op.src] + ([] if op.clear else [op.dst])
        self.touch(reads, [op.dst])
        src, dst = op.src, op.dst
        ct = _compute_type(src.dtype)
        fl = _is_float(src.dtype)
        init = {"sum": "0", "prod": "1",
                "max": "(-INFINITY)" if fl else "INT_MIN",
                "min": "INFINITY" if fl else "INT_MAX",
                "absmax": "(-INFINITY)" if fl else "INT_MIN"}[op.kind]

        def comb(a, b):
            if op.kind == "sum":
                return f"{a} + {b}"
            if op.kind == "prod":
                return f"{a} * {b}"
            f = "fmaxf" if fl else "max"
            if op.kind == "min":
                f = "fminf" if fl else "min"
            return f"{f}({a}, {b})"

        kept = tuple(d for i, d in enumerate(src.shape) if i != op.axis)
        n = src.shape[op.axis]

        def body(c):
            acc, r = self.fresh("acc"), self.fresh("r")
            self.src(f"{ct} {acc} = {init};")
            full = list(c[: op.axis]) + [r] + list(c[op.axis:]) if kept else [r]
            self.src.open(f"for (int {r} = 0; {r} < {n}; ++{r})")
            x = _load(self.ptr[src.name], self.offset(src, full), src.dtype)
            if op.kind == "absmax":
                x = f"fabsf({x})" if fl else f"abs({x})"
            self.src(f"{acc} = {_round(comb(acc, x), src.dtype)};")
            self.src.close()
            # a (1,)-shaped destination takes a full reduction
            doff = self.offset(dst, list(c) if kept else ["0"] * dst.ndim)
            value = acc
            if not op.clear:
                value = comb(_load(self.ptr[dst.name], doff, dst.dtype), acc)
            self.src(f"{self.ptr[dst.name]}[{doff}] = {_store_value(value, dst.dtype)};")

        self.strided(kept or (1,), body)

    def atomic(self, op: AtomicOp):
        """``dst op= src`` into the in-out window, one atomic an element:
        blocks of the grid meet there in no order.  ``src`` is read in its
        own row-major order against the region's (the interpreter's
        reshape)."""
        dst, src = op.dst, op.src
        dt = dst.buffer.dtype
        if dst.buffer.scope != GLOBAL or dt not in _ATOMIC_TYPES:
            raise LoweringError(
                f"cuda backend: T.atomic_{op.kind} into {dst.buffer.name} ({dst.buffer.scope} "
                f"{dt}); atomics go to a global tensor of {', '.join(_ATOMIC_TYPES)}")
        if math.prod(dst.sizes) != src.size:
            raise LoweringError(f"cuda backend: T.atomic_{op.kind}: {src.name} {src.shape} "
                                f"into a region of {dst.sizes}")
        self.touch([src], [])
        starts = self.starts(dst, "d")
        n = math.prod(dst.sizes)
        e = self.fresh("e")
        self.src.open(f"for (int {e} = threadIdx.x; {e} < {n}; {e} += {self.threads})")
        dc = [c if s == "0" else f"{s} + {c}" for s, c in zip(starts, self.unravel(e, dst.sizes))]
        value = _load(self.ptr[src.name], self.offset(src, self.unravel(e, src.shape)), src.dtype)
        at = f"&{self.ptr[dst.buffer.name]}[{self.offset(dst.buffer, dc)}]"
        if op.kind == "add":
            self.src(f"atomicAdd({at}, {_store_value(value, dt)});")
        elif _is_float(dt):
            self.cas_atomics = True
            self.src(f"tl_atomic_ext<{'true' if op.kind == 'max' else 'false'}>({at}, "
                     f"(float)({value}));")
        else:
            fn = {"max": "atomicMax", "min": "atomicMin"}[op.kind]
            self.src(f"{fn}({at}, {_store_value(value, dt)});")
        self.src.close()

    def cumsum(self, op: CumsumOp):
        """A scan along ``axis``, forward or reversed: a thread a line,
        accumulated in fp32 (fp64, int64 for their types), each prefix
        rounded to the source's type and stored in the destination's (as
        ``torch.cumsum`` then the interpreter's cast)."""
        src, dst, ax = op.src, op.dst, op.axis
        if src.shape != dst.shape:
            raise LoweringError(f"cuda backend: T.cumsum from {src.shape} into {dst.shape}")
        self.touch([src], [dst])
        kept = tuple(d for i, d in enumerate(src.shape) if i != ax)
        n = src.shape[ax]
        acc_t = ("double" if src.dtype == "float64" else "float" if _is_float(src.dtype)
                 else "long long")

        def body(c):
            acc, r = self.fresh("acc"), self.fresh("r")
            self.src(f"{acc_t} {acc} = 0;")
            self.src.open(f"for (int {r} = {n - 1}; {r} >= 0; --{r})" if op.reverse
                          else f"for (int {r} = 0; {r} < {n}; ++{r})")
            full = list(c[:ax]) + [r] + list(c[ax:]) if kept else [r]
            self.src(f"{acc} += {_load(self.ptr[src.name], self.offset(src, full), src.dtype)};")
            self.src(f"{self.ptr[dst.name]}[{self.offset(dst, full)}] = "
                     f"{_store_value(_round(acc, src.dtype), dst.dtype)};")
            self.src.close()

        self.strided(kept or (1,), body)

    # -- T.gemm --------------------------------------------------------------
    def gemm(self, op: GemmOp):
        a, b, c = op.a, op.b, op.c
        if max(a.ndim, b.ndim, c.ndim) > 2:
            self.touch([a, b, c], [c])
            self.batched(op)
        elif c.name in self.promoted:
            self.touch([a, b], [])
            self.wmma(op, self.promoted[c.name])
        elif self.takes_wmma(op):
            self.touch([a, b, c], [c])
            self.wmma(op)
        else:
            self.touch([a, b, c], [c])
            self.gemm_cuda_cores(op)

    def takes_wmma(self, op: GemmOp) -> bool:
        """A tensor-core GEMM whose every tile (each batch's too) starts at a
        32-byte aligned address, as ``wmma`` loads and stores ask."""
        from ..buffer import dtype_bits

        return tensor_core_gemm(op) and all(
            self.plan[x.name].offset % 32 == 0
            and all(st * dtype_bits(x.dtype) // 8 % 32 == 0 for st in self.strides(x)[:-2])
            for x in (op.a, op.b, op.c))

    def batched(self, op: GemmOp):
        """A batched ``T.gemm``: a loop over the accumulator's leading dims,
        the operands' broadcast as ``torch.matmul``'s (a missing or size-1
        dim reads batch 0), each batch on the 2-D path its operands take."""
        a, b, c = op.a, op.b, op.c
        lead = c.shape[:-2]
        for x in (a, b):
            xl = x.shape[:-2]
            if len(xl) > len(lead) or any(s not in (1, t) for s, t in
                                          zip(xl, lead[len(lead) - len(xl):])):
                raise LoweringError(f"cuda backend: T.gemm {a.shape} @ {b.shape} into "
                                    f"{c.shape}: the batch dims do not broadcast")
        bt = self.fresh("bt")
        self.src.open(f"for (int {bt} = 0; {bt} < {math.prod(lead)}; ++{bt})")
        coords = self.unravel(bt, lead)
        bases = {}
        for x in (a, b, c):
            skip = len(lead) - (x.ndim - 2)
            terms = [f"{coords[skip + d]} * {st}" for d, (s, st) in
                     enumerate(zip(x.shape[:-2], self.strides(x)[:-2])) if s != 1]
            bases[x.name] = f"({self.ptr[x.name]} + {' + '.join(terms) or '0'})"
        if self.takes_wmma(op):
            self.wmma(op, bases=bases)
        else:
            self.gemm_cuda_cores(op, bases)
        self.src.close()

    def mat(self, x: TileBuffer, bases: Optional[Dict[str, str]]) -> Tuple[str, int]:
        """A GEMM operand's matrix: its base pointer (a batch's, in a batched
        GEMM) and its row stride."""
        return (bases or {}).get(x.name, self.ptr[x.name]), self.strides(x)[-2]

    def gemm_cuda_cores(self, op: GemmOp, bases: Optional[Dict[str, str]] = None):
        a, b, c = op.a, op.b, op.c
        (A, lda), (B, ldb), (C, ldc) = (self.mat(x, bases) for x in (a, b, c))
        at = lambda r, k, ld: f"({r}) * {ld} + ({k})"  # noqa: E731

        def body(ij):
            i, j = ij
            acc, kk = self.fresh("acc"), self.fresh("k")
            self.src(f"float {acc} = 0.0f;")
            self.src.open(f"for (int {kk} = 0; {kk} < {op.k}; ++{kk})")
            ao = at(kk, i, lda) if op.transpose_a else at(i, kk, lda)
            bo = at(j, kk, ldb) if op.transpose_b else at(kk, j, ldb)
            self.src(f"{acc} += (float)({_load(A, ao, a.dtype)}) * "
                     f"(float)({_load(B, bo, b.dtype)});")
            self.src.close()
            co = at(i, j, ldc)
            cur = _load(C, co, c.dtype)
            value = _round(f"(float)({cur}) + {_round(acc, c.dtype)}", c.dtype)
            self.src(f"{C}[{co}] = {_store_value(value, c.dtype)};")

        self.strided((op.m, op.n), body)

    def warp_groups(self, m: int, n: int):
        """How the warps split an (m, n) accumulator: groups of gm x gn
        16 x 16 tiles, ``groups_n`` a row of groups, ``per_warp`` groups a
        warp (round-robin; a warp past the last group skips)."""
        tm, tn = m // 16, n // 16
        gm = 2 if tm % 2 == 0 else 1
        gn = 4 if tn % 4 == 0 else (2 if tn % 2 == 0 else 1)
        groups = (tm // gm) * (tn // gn)
        warps = max(1, self.threads // 32)
        return gm, gn, tn // gn, groups, -(-groups // warps), warps

    def each_group(self, m: int, n: int, body):
        """Emit ``body(g)`` for each of this warp's groups ``g`` (an unrolled
        index), with ``_tm`` / ``_tn`` the group's first row and column."""
        gm, gn, groups_n, groups, per_warp, warps = self.warp_groups(m, n)
        s = self.src
        s("#pragma unroll")
        s.open(f"for (int _g = 0; _g < {per_warp}; ++_g)")
        s(f"const int _grp = threadIdx.x / 32 + _g * {warps};")
        s.open(f"if (_grp < {groups})")
        s(f"const int _tm = (_grp / {groups_n}) * {gm * 16}, _tn = (_grp % {groups_n}) * {gn * 16};")
        body(gm, gn)
        s.close()
        s.close()

    def tiles(self, gm: int, gn: int, stmt: str):
        """``stmt`` for every (``_x``, ``_y``) tile of a group, unrolled."""
        s = self.src
        s("#pragma unroll")
        s.open(f"for (int _x = 0; _x < {gm}; ++_x)")
        s("#pragma unroll")
        s.open(f"for (int _y = 0; _y < {gn}; ++_y)")
        s(stmt)
        s.close()
        s.close()

    def c_load(self, frag: str, c: TileBuffer, bases: Optional[Dict[str, str]] = None) -> str:
        C, ldc = self.mat(c, bases)
        return (f"nvcuda::wmma::load_matrix_sync({frag}, {C} + (_tm + _x * 16) * "
                f"{ldc} + _tn + _y * 16, {ldc}, nvcuda::wmma::mem_row_major);")

    def c_store(self, frag: str, c: TileBuffer, bases: Optional[Dict[str, str]] = None) -> str:
        C, ldc = self.mat(c, bases)
        return (f"nvcuda::wmma::store_matrix_sync({C} + (_tm + _x * 16) * "
                f"{ldc} + _tn + _y * 16, {frag}, {ldc}, nvcuda::wmma::mem_row_major);")

    def accumulators(self, frag: str, gm: int, gn: int, per_warp: Optional[int] = None) -> str:
        lead = f"[{per_warp}]" if per_warp is not None else ""
        return (f"nvcuda::wmma::fragment<nvcuda::wmma::accumulator, 16, 16, 16, float> "
                f"{frag}{lead}[{gm}][{gn}];")

    def wmma(self, op: GemmOp, frag: Optional[str] = None,
             bases: Optional[Dict[str, str]] = None):
        """``C += A . B`` on the tensor cores.  Without ``frag`` each warp
        loads its accumulator tiles from shared memory and stores them back;
        with it (an accumulator promoted over the pipelined loop) they stay
        in the warp's registers, ``frag[_g]``.  ``bases``: a batch's
        matrices in a batched GEMM."""
        a, b, c = op.a, op.b, op.c
        et = _CTYPE[a.dtype]
        (A, lda), (B, ldb) = self.mat(a, bases), self.mat(b, bases)
        la = "col_major" if op.transpose_a else "row_major"
        lb = "col_major" if op.transpose_b else "row_major"
        a_tile = (f"{A} + _kk * {lda} + _tm + _x * 16" if op.transpose_a
                  else f"{A} + (_tm + _x * 16) * {lda} + _kk")
        b_tile = (f"{B} + (_tn + _y * 16) * {ldb} + _kk" if op.transpose_b
                  else f"{B} + _kk * {ldb} + _tn + _y * 16")
        s = self.src

        def body(gm, gn):
            acc = f"{frag}[_g]" if frag else "_c"
            if not frag:
                s(self.accumulators("_c", gm, gn))
                self.tiles(gm, gn, self.c_load("_c[_x][_y]", c, bases))
            s.open(f"for (int _kk = 0; _kk < {op.k}; _kk += 16)")
            s(f"nvcuda::wmma::fragment<nvcuda::wmma::matrix_a, 16, 16, 16, {et}, "
              f"nvcuda::wmma::{la}> _a[{gm}];")
            s(f"nvcuda::wmma::fragment<nvcuda::wmma::matrix_b, 16, 16, 16, {et}, "
              f"nvcuda::wmma::{lb}> _b[{gn}];")
            s("#pragma unroll")
            s(f"for (int _x = 0; _x < {gm}; ++_x) "
              f"nvcuda::wmma::load_matrix_sync(_a[_x], {a_tile}, {lda});")
            s("#pragma unroll")
            s(f"for (int _y = 0; _y < {gn}; ++_y) "
              f"nvcuda::wmma::load_matrix_sync(_b[_y], {b_tile}, {ldb});")
            self.tiles(gm, gn, f"nvcuda::wmma::mma_sync({acc}[_x][_y], _a[_x], _b[_y], "
                               f"{acc}[_x][_y]);")
            s.close()
            if not frag:
                self.tiles(gm, gn, self.c_store("_c[_x][_y]", c, bases))

        self.each_group(op.m, op.n, body)

    def promotable(self, body: List[TileOp]) -> List[GemmOp]:
        """The tensor-core GEMMs of a pipelined loop body whose accumulator
        no other op of the body touches: their accumulator tiles can stay in
        registers for the whole loop."""
        gemms = [op for op in body if isinstance(op, GemmOp) and self.takes_wmma(op)
                 and op.c.ndim == 2]
        out, seen = [], set()
        for g in gemms:
            if g.c.name in seen:
                continue
            others = [op for op in body if op is not g and (
                g.c in op.buffers_read() or g.c in op.buffers_written())]
            if all(isinstance(o, GemmOp) and o.c is g.c and (o.m, o.n) == (g.m, g.n)
                   and self.takes_wmma(o) for o in others):
                out.append(g)
                seen.add(g.c.name)
        return out

    def promote(self, gemms: List[GemmOp]):
        """Load each promoted accumulator into its warps' registers (after a
        barrier: PRE wrote it)."""
        for g in gemms:
            self.touch([g.c], [])
        if self.written or self.read:
            self.barrier()
        for g in gemms:
            frag = self.fresh("acc")
            self.promoted[g.c.name] = frag
            gm, gn, _, _, per_warp, _ = self.warp_groups(g.m, g.n)
            self.src(self.accumulators(frag, gm, gn, per_warp))
            self.each_group(g.m, g.n, lambda gm, gn, frag=frag, c=g.c: self.tiles(
                gm, gn, self.c_load(f"{frag}[_g][_x][_y]", c)))

    def demote(self, gemms: List[GemmOp]):
        """Store the promoted accumulators back to shared memory."""
        for g in gemms:
            frag = self.promoted.pop(g.c.name)
            self.each_group(g.m, g.n, lambda gm, gn, frag=frag, c=g.c: self.tiles(
                gm, gn, self.c_store(f"{frag}[_g][_x][_y]", c)))
            self.touch([], [g.c])

    # -- the kernel ---------------------------------------------------------
    def kernel(self, name: str) -> str:
        m, prog = self.m, self.program
        plan = m.grid_plan
        grid = plan.grid
        par = [i for i in range(len(grid)) if i != plan.kdim]
        blocks = math.prod(grid[i] for i in par)
        if blocks >= 2 ** 31:
            raise LoweringError(f"{prog.name}: {blocks} blocks exceed a CUDA grid")
        pipe = m.phases.pipeline
        gids = [VarExpr(pipe.var.name) if i == plan.kdim else VarExpr(f"_grid{i}")
                for i in range(len(grid))]
        env = plan.env_builder(*gids)
        s = self.src
        args = ", ".join(
            f"{'' if p in prog.output_params() else 'const '}{_CTYPE[p.dtype]}* "
            f"__restrict__ {self.ptr[p.name]}" for p in prog.params)
        if self.workspace_bytes:
            args += ", unsigned char* tl_ws"
        s(f'extern "C" __global__ void __launch_bounds__({self.threads}) {name}({args})')
        s.open("")
        s("extern __shared__ __align__(128) unsigned char tl_smem[];")
        if self.workspace_bytes:
            s(f"unsigned char* const tl_block_ws = tl_ws + (size_t)blockIdx.x * "
              f"{self.workspace_bytes}ULL;")
        for b in prog.allocs:
            base = "tl_block_ws" if self.plan[b.name].space == WORKSPACE else "tl_smem"
            s(f"{_CTYPE[b.dtype]}* const {self.ptr[b.name]} = "
              f"reinterpret_cast<{_CTYPE[b.dtype]}*>({base} + {self.plan[b.name].offset});")
        s("int _block = blockIdx.x;")
        for i in reversed(par):
            s(f"const int {self.var(f'_grid{i}')} = _block % {grid[i]}; _block /= {grid[i]};")
        for v, _ in prog.grid_axes:
            code = self.int_expr(env[v.name]) if isinstance(env[v.name], Expr) else str(env[v.name])
            s(f"const int {self.var(v.name)} = {code};  // {v.name}")
        self.ops(m.phases.pre)
        if pipe is not None:
            promoted = self.promotable(pipe.body)
            self.promote(promoted)
            self.loop(pipe.var, pipe.extent, pipe.body)
            self.demote(promoted)
        self.ops(m.phases.post)
        s.close()
        return s.text()


def _blocks(module: LoweredModule) -> int:
    """The launch's blocks: one a cell of the parallel grid."""
    plan = module.grid_plan
    return math.prod(e for i, e in enumerate(plan.grid) if i != plan.kdim)


def emit_source(module: LoweredModule) -> Tuple[str, str, int]:
    """``(source, entry, threads)``: the kernel and its C launch entry (its
    operands' pointers, the workspace's where the plan has one, the
    stream)."""
    prog = module.program
    for p in prog.params:
        if p.dtype not in _CTYPE:
            raise LoweringError(f"cuda backend: {p.name} is {p.dtype}, a type the emitted "
                                f"kernels do not take (one of {', '.join(_CTYPE)})")
    if not module.vmem.ok:
        raise ScheduleError(
            f"{prog.name}: shared-memory budget exceeded —\n{module.vmem.summary()}\n"
            "Reduce block shapes.")
    em = _Emitter(module)
    name = f"tl_{prog.name}"
    body = em.kernel(name)
    blocks = _blocks(module)
    smem = module.vmem.total_bytes
    params = ", ".join(f"void* p{i}" for i in range(len(prog.params)))
    casts = ", ".join(
        f"static_cast<{'' if p in prog.output_params() else 'const '}{_CTYPE[p.dtype]}*>(p{i})"
        for i, p in enumerate(prog.params))
    ws = module.vmem.workspace_bytes
    if ws:
        params += ", void* ws"
        casts += ", static_cast<unsigned char*>(ws)"
    entry = "tl_launch"
    launch = f'''
extern "C" int {entry}({params}, void* stream) {{
  if ({smem} > 48 * 1024) {{
    cudaError_t e = cudaFuncSetAttribute({name}, cudaFuncAttributeMaxDynamicSharedMemorySize, {smem});
    if (e != cudaSuccess) return (int)e;
  }}
  {name}<<<{blocks}, {em.threads}, {smem}, static_cast<cudaStream_t>(stream)>>>({casts});
  return (int)cudaGetLastError();
}}
'''
    header = (f"// {prog.name}: emitted by repro_torch.core.backends.cuda\n"
              f"// grid {blocks} blocks x {em.threads} threads, {smem} bytes of shared memory\n")
    if ws:
        header += (f"// {ws} bytes of global workspace a block: "
                   f"{', '.join(module.vmem.workspace())}\n")
    prelude = _PRELUDE + (_CAS_ATOMICS if em.cas_atomics else "")
    return header + prelude + "\n" + body + launch, entry, em.threads


class CudaKernel(CompiledKernel):
    """A compiled program on the card: ``kernel(*inputs)`` allocates the
    outputs on the inputs' device, as the reference interpreter does (a pure
    output zero-filled, an in-out one of ``aliased`` a copy of its input),
    launches on ``torch.cuda.current_stream()`` and returns them in
    ``out_params`` order.  ``source`` is the emitted text, ``kernel`` its
    ``build.Kernel`` (built at the first call), ``blocks`` and ``threads``
    its launch grid, ``smem_bytes`` and ``workspace_bytes`` the shared
    memory and the global workspace a block (allocated at each launch,
    ``blocks * workspace_bytes`` bytes), ``launches`` the count of launches
    made."""

    def __init__(self, module: LoweredModule, source: str, entry: str, threads: int):
        from ...kernels.build import Kernel

        prog = module.program
        self.source = source
        self.threads = threads
        self.blocks = _blocks(module)
        self.smem_bytes = module.vmem.total_bytes
        self.workspace_bytes = module.vmem.workspace_bytes
        self.launches = 0
        # the in-out outputs: seeded from the input of the same name
        self.aliased = tuple(w.param.name for w in module.out_windows if w.aliased)
        missing = set(self.aliased) - {p.name for p in module.arg_params}
        if missing:
            raise LoweringError(f"{prog.name}: aliased outputs {sorted(missing)} have no input")
        self.kernel = Kernel(f"tl_{prog.name}", entry,
                             [ctypes.c_void_p] * (len(prog.params) + 1 + bool(self.workspace_bytes)),
                             replaces="src/repro/core/backends/pallas_tpu.py:59",
                             text=source)
        info = LoweredInfo(
            grid=module.grid, dimension_semantics=module.dimension_semantics,
            vmem=module.vmem, inference=module.inference, cost=module.cost,
            num_stages=module.num_stages, n_windows_in=len(module.in_windows),
            n_windows_out=len(module.out_windows))
        super().__init__(prog, self._launch, info, module.arg_params, module.out_params,
                         backend="cuda")

    def _launch(self, *arrays):
        from ...kernels.build import check

        prog = self.program
        tensors = {}
        device = None
        for p, t in zip(self.arg_params, arrays):
            if not isinstance(t, torch.Tensor) or not t.is_cuda:
                where = t.device if isinstance(t, torch.Tensor) else type(t).__name__
                raise RuntimeError(
                    f"{prog.name}: compiled for target 'cuda', but {p.name} is on "
                    f"{where}; pass CUDA tensors, or compile with target='reference'")
            if t.dtype != torch_dtype(p.dtype):
                raise LoweringError(f"{prog.name}: {p.name} is {t.dtype}, declared {p.dtype}")
            device = device or t.device
            if t.device != device:
                raise LoweringError(f"{prog.name}: {p.name} is on {t.device}, not {device}")
            t = t.contiguous()
            if t.data_ptr() % 16:
                t = t.clone()
            tensors[p.name] = t
        if device is None:
            raise RuntimeError(f"{prog.name}: a 'cuda' kernel needs CUDA tensors")
        # an in-out output starts as a copy of its input, never the caller's
        outs = [tensors[p.name].clone() if p.name in self.aliased else
                torch.zeros(p.shape, dtype=torch_dtype(p.dtype), device=device)
                for p in self.out_params]
        tensors.update({p.name: o for p, o in zip(self.out_params, outs)})
        ptrs = [tensors[p.name].data_ptr() for p in prog.params]
        if self.workspace_bytes:  # never read before the block writes it
            ws = torch.empty(self.blocks * self.workspace_bytes, dtype=torch.uint8, device=device)
            ptrs.append(ws.data_ptr())
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream().cuda_stream
            rc = self.kernel.function()(*ptrs, stream)
        check(rc, prog.name)
        self.launches += 1
        return outs[0] if len(outs) == 1 else tuple(outs)


@register_backend("cuda")
def emit_cuda(module: LoweredModule) -> CompiledKernel:
    program = lower_tile_lib(module.program)
    if program is not module.program:  # the rewritten copy's own plan
        module = analyze(program, module.schedule)
    source, entry, threads = emit_source(module)
    return CudaKernel(module, source, entry, threads)
