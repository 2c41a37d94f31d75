"""``T.call_tile_lib`` as device code: a tile-library function written in
torch, rewritten into the T language's own ops before the CUDA backend
emits its program.

The counterpart of the JAX package's Pallas backend, which runs a tile-library
function's ``jnp`` ops inside the kernel (repro/core/backends/pallas_tpu.py:418).
A CUDA kernel cannot call torch, so :func:`lower_tile_lib` traces each
``CustomOp``'s ``fn`` once over fake tensors of its input tiles' shapes and
dtypes (``make_fx``, decomposed to core aten, softmax included) and replays
the graph symbolically, each value a map from an element's index to an
``Expr``:

* elementwise ops (arithmetic, shifts and masks, comparisons, ``where``,
  casts, ``exp`` / ``tanh`` / ``rsqrt`` and the other unary functions)
  become ``BinExpr`` / ``UnaryExpr`` / ``CastExpr`` / ``WhereExpr`` trees,
  each tensor operand cast to the type torch computes the op in;
* views and reshapes, ``unsqueeze``, ``permute`` and ``cat`` (so
  ``stack``) become index maps, never copies; a gather (``index.Tensor``)
  substitutes its index values;
* a captured constant tensor (nf4's 16-entry codebook) of at most
  ``MAX_TABLE`` elements is read through a balanced select tree on its flat
  index;
* a reduction along one axis (``amax``, ``amin``, ``sum``) becomes a
  ``ReduceOp`` into a scratch fragment, its operand first stored to a
  scratch fragment of its own unless it is an input tile read as it is
  (a 16-bit sum accumulates in fp32, as torch's).

The op becomes one ``T.Parallel`` over its output tile, after the scratch
ops.  The rewrite runs on a copy of the program before ``analyze``, so the
scratch fragments enter the shared-memory plan like any other buffer.  An
aten op outside this set raises :class:`LoweringError` naming the op and the
``CustomOp``, at compile time: the function never runs on the host.  The
reference interpreter keeps calling ``fn`` itself.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import torch

from ..buffer import FRAGMENT, TileBuffer, torch_dtype
from ..errors import LoweringError
from ..expr import BinExpr, CastExpr, ConstExpr, Expr, LoadExpr, UnaryExpr, VarExpr, WhereExpr
from ..tile_ops import CustomOp, ParallelOp, PipelinedOp, ReduceOp, SerialOp, TileOp

MAX_TABLE = 256  # elements of a captured constant read through a select tree

Index = List[Expr]


def _name(dt: torch.dtype) -> str:
    return str(dt).removeprefix("torch.")


@dataclasses.dataclass
class _Tile:
    """A traced value: its shape, its dtype and ``at(index) -> Expr``, the
    element at an index; ``buffer`` where it is an input tile as it is."""

    shape: Tuple[int, ...]
    dtype: str
    at: Callable[[Index], Expr]
    buffer: Optional[TileBuffer] = None


# -- index arithmetic that skips the trivial steps ----------------------------

def _add(e: Expr, k) -> Expr:
    if isinstance(k, int) and k == 0:
        return e
    return BinExpr("add", e, k if isinstance(k, Expr) else ConstExpr(k))


def _mul(e: Expr, k: int) -> Expr:
    return e if k == 1 else BinExpr("mul", e, ConstExpr(k))


def _div(e: Expr, k: int) -> Expr:
    return e if k == 1 else BinExpr("floordiv", e, ConstExpr(k))


def _mod(e: Expr, k: int) -> Expr:
    return BinExpr("mod", e, ConstExpr(k))


def _clamp(e: Expr, lo: Optional[int], hi: Optional[int]) -> Expr:
    if hi is not None:
        e = BinExpr("min", e, ConstExpr(hi))
    if lo is not None:
        e = BinExpr("max", e, ConstExpr(lo))
    return e


def _flat(idx: Index, shape: Sequence[int]) -> Expr:
    """Row-major flat index of ``idx`` in ``shape``."""
    out: Optional[Expr] = None
    stride = 1
    for i, s in reversed(list(zip(idx, shape))):
        if s != 1:
            term = _mul(i, stride)
            out = term if out is None else BinExpr("add", term, out)
        stride *= s
    return out if out is not None else ConstExpr(0)


def _reshape(src: Sequence[int], dst: Sequence[int]) -> Callable[[Index], Index]:
    """The source index of a reshape's element: the shapes' non-unit dims
    split into runs of equal products, each run's index flattened over the
    destination dims and unflattened over the source ones."""
    a = [d for d, s in enumerate(src) if s != 1]
    b = [d for d, s in enumerate(dst) if s != 1]
    runs, i, j = [], 0, 0
    while i < len(a):
        ga, gb = [a[i]], [b[j]]
        pa, pb = src[a[i]], dst[b[j]]
        i, j = i + 1, j + 1
        while pa != pb:
            if pa < pb:
                ga.append(a[i])
                pa *= src[a[i]]
                i += 1
            else:
                gb.append(b[j])
                pb *= dst[b[j]]
                j += 1
        runs.append((ga, gb))

    def index(idx: Index) -> Index:
        out: Index = [ConstExpr(0)] * len(src)
        for ga, gb in runs:
            if len(ga) == 1 and len(gb) == 1:
                out[ga[0]] = idx[gb[0]]
                continue
            flat = _flat([idx[d] for d in gb], [dst[d] for d in gb])
            inner = math.prod(src[d] for d in ga)
            for n, d in enumerate(ga):
                inner //= src[d]
                q = _div(flat, inner)
                out[d] = q if n == 0 else _mod(q, src[d])
        return out

    return index


def _table(values: List, flat: Expr) -> Expr:
    """``values[flat]`` as a balanced tree of selects."""

    def tree(lo: int, hi: int) -> Expr:
        if hi - lo == 1:
            return ConstExpr(values[lo])
        mid = (lo + hi) // 2
        return WhereExpr(BinExpr("lt", flat, ConstExpr(mid)), tree(lo, mid), tree(mid, hi))

    return tree(0, len(values))


def _broadcast(t: _Tile, shape: Sequence[int], idx: Index) -> Expr:
    """The element of ``t`` broadcast to ``shape`` at ``idx``."""
    off = len(shape) - len(t.shape)
    return t.at([ConstExpr(0) if s == 1 else idx[off + d] for d, s in enumerate(t.shape)])


aten = torch.ops.aten
_BINARY = {
    aten.add: "add", aten.sub: "sub", aten.mul: "mul", aten.div: "div",
    aten.maximum: "max", aten.minimum: "min", aten.pow: "pow", aten.remainder: "mod",
    aten.floor_divide: "floordiv", aten.bitwise_and: "bitand", aten.bitwise_or: "bitor",
    aten.bitwise_xor: "bitxor", aten.__rshift__: "shr", aten.__lshift__: "shl",
    aten.bitwise_right_shift: "shr", aten.bitwise_left_shift: "shl",
}
_COMPARE = {aten.lt: "lt", aten.le: "le", aten.gt: "gt", aten.ge: "ge", aten.eq: "eq",
            aten.ne: "ne"}
_UNARY = {aten.neg: "neg", aten.exp: "exp", aten.exp2: "exp2", aten.log: "log",
          aten.log2: "log2", aten.abs: "abs", aten.sqrt: "sqrt", aten.rsqrt: "rsqrt",
          aten.sigmoid: "sigmoid", aten.tanh: "tanh", aten.floor: "floor", aten.ceil: "ceil"}
_REDUCE = {aten.amax: "max", aten.amin: "min", aten.sum: "sum"}
_IDENTITY = {aten.clone, aten.alias}
_VIEWS = {aten.view, aten._unsafe_view, aten.reshape}


class _Rewrite:
    """One ``CustomOp`` as T ops: ``ops`` (scratch stores and reductions,
    then the output's ``T.Parallel``) over ``scratch`` fragments."""

    def __init__(self, op: CustomOp, counter: Iterator):
        self.op = op
        self.counter = counter
        self.ops: List[TileOp] = []
        self.scratch: List[TileBuffer] = []
        gm = self.trace()
        env: Dict = {}
        inputs = iter(op.inputs)
        out = None
        for node in gm.graph.nodes:
            if node.op == "placeholder":
                buf = next(inputs)
                env[node] = _Tile(buf.shape, buf.dtype,
                                  lambda idx, buf=buf: LoadExpr(buf, tuple(idx)), buf)
            elif node.op == "get_attr":
                env[node] = self.constant(getattr(gm, node.target))
            elif node.op == "call_function":
                args = torch.fx.node.map_arg(node.args, lambda n: env[n])
                kwargs = torch.fx.node.map_arg(node.kwargs, lambda n: env[n])
                env[node] = self.call(node, args, kwargs)
            elif node.op == "output":
                res = node.args[0]
                if isinstance(res, (tuple, list)):
                    if len(res) != 1:
                        raise LoweringError(
                            f"custom op {op.name}: returns {len(res)} values, a tile expected")
                    res = res[0]
                out = env[res]
        want = (tuple(op.output.shape), op.output.dtype)
        if (tuple(out.shape), out.dtype) != want:
            raise LoweringError(f"custom op {op.name}: produced {tuple(out.shape)} {out.dtype}, "
                                f"expected {want[0]} {want[1]}")
        self.store(op.output, out)

    # -- tracing --------------------------------------------------------------
    def trace(self):
        from torch._decomp import core_aten_decompositions, get_decompositions
        from torch.fx.experimental.proxy_tensor import make_fx

        table = {**core_aten_decompositions(),
                 **get_decompositions([aten._softmax, aten._log_softmax])}
        args = [torch.empty(b.shape, dtype=torch_dtype(b.dtype)) for b in self.op.inputs]
        try:
            return make_fx(self.op.fn, decomposition_table=table, tracing_mode="fake",
                           _allow_non_fake_inputs=True)(*args)
        except Exception as e:  # any failure of the user's function while traced
            raise LoweringError(
                f"custom op {self.op.name}: its function does not trace to aten ops "
                f"over fake tiles ({type(e).__name__}: {e})") from e

    def unsupported(self, what: str):
        raise LoweringError(
            f"custom op {self.op.name} (T.call_tile_lib): {what} has no T-language "
            "form on the cuda backend")

    # -- scratch ----------------------------------------------------------------
    def fresh(self, stem: str) -> str:
        return f"_{self.op.name}_{stem}{next(self.counter)}"

    def store(self, buf: TileBuffer, t: _Tile):
        axes = tuple(VarExpr(self.fresh("i"), e) for e in buf.shape)
        val = t.at(list(axes)[: len(t.shape)])
        if t.dtype != buf.dtype:
            val = CastExpr(val, buf.dtype)
        self.ops.append(ParallelOp(axes, tuple(buf.shape), [(buf, axes, val)]))

    def materialize(self, t: _Tile, dtype: str) -> TileBuffer:
        if t.buffer is not None and t.dtype == dtype:
            return t.buffer
        buf = TileBuffer(t.shape or (1,), dtype, FRAGMENT, name=self.fresh("t"))
        self.scratch.append(buf)
        self.store(buf, t)
        return buf

    def reduce(self, kind: str, x: _Tile, dim: int) -> _Tile:
        """``x`` reduced along ``dim`` (dropped), in the accumulating type."""
        acc = x.dtype
        if kind == "sum" and x.dtype in ("bfloat16", "float16"):
            acc = "float32"
        src = self.materialize(x, acc)
        kept = x.shape[:dim] + x.shape[dim + 1:]
        dst = TileBuffer(kept or (1,), acc, FRAGMENT, name=self.fresh("r"))
        self.scratch.append(dst)
        self.ops.append(ReduceOp(kind, src, dst, dim))
        return _Tile(kept, acc, lambda idx: LoadExpr(dst, tuple(idx) if kept else (ConstExpr(0),)))

    # -- constants ----------------------------------------------------------------
    def constant(self, value: torch.Tensor) -> _Tile:
        if value.numel() > MAX_TABLE:
            self.unsupported(f"a captured constant of {value.numel()} elements "
                             f"(tables up to {MAX_TABLE})")
        shape, dtype = tuple(value.shape), _name(value.dtype)
        values = value.detach().cpu().flatten().tolist()
        return _Tile(shape, dtype, lambda idx: CastExpr(_table(values, _flat(idx, shape)), dtype))

    # -- one aten op ----------------------------------------------------------------
    def call(self, node, args, kwargs) -> _Tile:
        """The value of one aten call, or an unsupported raise."""
        target = node.target
        packet = getattr(target, "overloadpacket", None)
        val = node.meta.get("val")
        if packet is None or not isinstance(val, torch.Tensor):
            self.unsupported(f"{target}")
        shape, dtype = tuple(val.shape), _name(val.dtype)

        def operand(x, ct: str, out_shape=shape):
            """``x`` (a tile or a Python number) at an output index, cast to ``ct``."""
            if isinstance(x, _Tile):
                def at(idx):
                    e = _broadcast(x, out_shape, idx)
                    return e if x.dtype == ct else CastExpr(e, ct)
                return at
            if isinstance(x, (bool, int, float)):
                c = ConstExpr(x)
                return lambda idx: c
            self.unsupported(f"{target} on an operand of type {type(x).__name__}")

        def tile(at) -> _Tile:
            return _Tile(shape, dtype, at)

        if packet in _BINARY or packet in _COMPARE:
            a, b = args[0], args[1]
            if kwargs.get("rounding_mode") is not None:
                self.unsupported(f"{target} with rounding_mode={kwargs['rounding_mode']!r}")
            op = _BINARY.get(packet) or _COMPARE[packet]
            ct = _compare_type(a, b) if packet in _COMPARE else dtype
            fa, fb = operand(a, ct), operand(b, ct)
            alpha = kwargs.get("alpha", 1)
            if alpha != 1:
                fb0 = fb
                fb = lambda idx: BinExpr("mul", fb0(idx), ConstExpr(alpha))  # noqa: E731
            return tile(lambda idx: BinExpr(op, fa(idx), fb(idx)))
        if packet in _UNARY:
            fx = operand(args[0], dtype)
            return tile(lambda idx: UnaryExpr(_UNARY[packet], fx(idx)))
        if packet is aten.where:
            fc, fa, fb = operand(args[0], "bool"), operand(args[1], dtype), operand(args[2], dtype)
            return tile(lambda idx: WhereExpr(fc(idx), fa(idx), fb(idx)))
        if packet is aten._to_copy or target is torch.ops.prims.convert_element_type.default:
            return tile(operand(args[0], dtype))
        if packet in _IDENTITY:
            return args[0]
        if packet in _VIEWS:
            x = args[0]
            index = _reshape(x.shape, shape)
            return tile(lambda idx: x.at(index(idx)))
        if packet is aten.unsqueeze:
            x, d = args[0], args[1] % len(shape)
            return tile(lambda idx: x.at(idx[:d] + idx[d + 1:]))
        if packet is aten.permute:
            x = args[0]
            dims = [d % len(x.shape) for d in args[1]]

            def permuted(idx):
                src: Index = [ConstExpr(0)] * len(dims)
                for i, d in enumerate(dims):
                    src[d] = idx[i]
                return x.at(src)

            return tile(permuted)
        if packet is aten.cat:
            pieces = [p for p in args[0] if p.shape != (0,)]
            d = (args[1] if len(args) > 1 else kwargs.get("dim", 0)) % len(shape)
            starts = list(itertools.accumulate([0] + [p.shape[d] for p in pieces]))
            parts = [operand(p, dtype, p.shape) for p in pieces]

            def joined(idx):
                out = None
                for k in reversed(range(len(pieces))):
                    size, off = pieces[k].shape[d], starts[k]
                    # the index inside piece k, kept in range where it is not
                    # the piece chosen (the interpreter evaluates every branch)
                    local = (ConstExpr(0) if size == 1 else
                             _clamp(_add(idx[d], -off), 0 if k else None,
                                    size - 1 if k < len(pieces) - 1 else None))
                    e = parts[k](idx[:d] + [local] + idx[d + 1:])
                    out = e if out is None else WhereExpr(
                        BinExpr("lt", idx[d], ConstExpr(starts[k + 1])), e, out)
                return out

            return tile(joined)
        if packet is aten.index:
            x, indices = args[0], list(args[1])
            where = [k for k, i in enumerate(indices) if i is not None]
            if len(where) != 1 or not isinstance(indices[where[0]], _Tile):
                self.unsupported(f"{target} with {len(where)} index tensors (one expected)")
            p, ix = where[0], indices[where[0]]
            k = len(ix.shape)
            fi = operand(ix, ix.dtype, ix.shape)

            def gathered(idx):
                return x.at(idx[:p] + [fi(idx[p:p + k])] + idx[p + k:])

            return tile(gathered)
        if packet in _REDUCE:
            return self.reduction(packet, args, kwargs, shape, dtype)
        self.unsupported(f"{target}")

    def reduction(self, packet, args, kwargs, shape, dtype) -> _Tile:
        x = args[0]
        dims = args[1] if len(args) > 1 else kwargs.get("dim")
        dims = [dims] if isinstance(dims, int) else list(dims or range(len(x.shape)))
        if len(dims) != 1:
            self.unsupported(f"{packet} over {len(dims)} axes (one expected)")
        d = dims[0] % len(x.shape)
        keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
        red = self.reduce(_REDUCE[packet], x, d)

        def at(idx):
            e = red.at(idx[:d] + idx[d + 1:] if keep else idx)
            return e if red.dtype == dtype else CastExpr(e, dtype)

        return _Tile(shape, dtype, at)


def _compare_type(a, b) -> str:
    """The type torch compares two operands in (a Python number takes the
    tensor's type unless its kind is wider)."""
    tiles = [x for x in (a, b) if isinstance(x, _Tile)]
    dt = torch_dtype(tiles[0].dtype)
    for t in tiles[1:]:
        dt = torch.promote_types(dt, torch_dtype(t.dtype))
    for x in (a, b):
        if isinstance(x, float) and not dt.is_floating_point:
            dt = torch.float32
        elif isinstance(x, int) and not isinstance(x, bool) and dt == torch.bool:
            dt = torch.int64
    return _name(dt)


def lower_tile_lib(program):
    """``program`` with every ``CustomOp`` rewritten into T ops (a copy;
    the program itself when it has none)."""
    from ..program import TileProgram

    if not any(isinstance(op, CustomOp) for op in program._walk()):
        return program
    counter = itertools.count()
    scratch: List[TileBuffer] = []

    def walk(ops: List[TileOp]) -> List[TileOp]:
        out: List[TileOp] = []
        for op in ops:
            if isinstance(op, CustomOp):
                rw = _Rewrite(op, counter)
                out.extend(rw.ops)
                scratch.extend(rw.scratch)
            elif isinstance(op, (PipelinedOp, SerialOp)):
                out.append(dataclasses.replace(op, body=walk(op.body)))
            else:
                out.append(op)
        return out

    ops = walk(program.ops)
    annotations = dataclasses.replace(program.annotations, extra={})
    return TileProgram(program.name, program.params, program.grid_axes, program.threads, ops,
                       [*program.allocs, *scratch], annotations, program.source_lines)
