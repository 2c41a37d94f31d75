"""Symbolic scalar/index expression trees for the tile language.

The Python-embedded frontend (program.py) executes user kernels once with
symbolic objects; every arithmetic interaction builds one of the ``Expr``
nodes below.  Two evaluators consume them:

* ``evaluate`` — vectorized evaluation against an environment mapping
  variable names to (broadcastable) torch tensors or Python ints.  Used by
  the reference interpreter (backends/reference.py) and by window index
  maps.  The CUDA backend (backends/cuda.py) prints the same trees as C++.
* ``static_eval`` — partial evaluation to a Python int when every leaf is a
  constant (used for shape/divisibility checks at trace time).

Expressions are deliberately small and closed: constants, variables, binary
arithmetic, unary math, comparisons, select, buffer loads and dtype casts.
This is the same role TVM's ``PrimExpr`` plays under TileLang.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

import torch

from .errors import TraceError

# ---------------------------------------------------------------------------
# Node definitions
# ---------------------------------------------------------------------------


class Expr:
    """Base class: supports Python arithmetic to build trees."""

    dtype: Optional[str] = None  # optional dtype hint ("float32", ...)

    # -- arithmetic ---------------------------------------------------------
    def __add__(self, o):
        return BinExpr("add", self, wrap(o))

    def __radd__(self, o):
        return BinExpr("add", wrap(o), self)

    def __sub__(self, o):
        return BinExpr("sub", self, wrap(o))

    def __rsub__(self, o):
        return BinExpr("sub", wrap(o), self)

    def __mul__(self, o):
        return BinExpr("mul", self, wrap(o))

    def __rmul__(self, o):
        return BinExpr("mul", wrap(o), self)

    def __truediv__(self, o):
        return BinExpr("div", self, wrap(o))

    def __rtruediv__(self, o):
        return BinExpr("div", wrap(o), self)

    def __floordiv__(self, o):
        return BinExpr("floordiv", self, wrap(o))

    def __rfloordiv__(self, o):
        return BinExpr("floordiv", wrap(o), self)

    def __mod__(self, o):
        return BinExpr("mod", self, wrap(o))

    def __rmod__(self, o):
        return BinExpr("mod", wrap(o), self)

    def __neg__(self):
        return UnaryExpr("neg", self)

    def __pow__(self, o):
        return BinExpr("pow", self, wrap(o))

    # -- bitwise (dequantization kernels) ------------------------------------
    def __rshift__(self, o):
        return BinExpr("shr", self, wrap(o))

    def __lshift__(self, o):
        return BinExpr("shl", self, wrap(o))

    def __and__(self, o):
        return BinExpr("bitand", self, wrap(o))

    def __or__(self, o):
        return BinExpr("bitor", self, wrap(o))

    def __xor__(self, o):
        return BinExpr("bitxor", self, wrap(o))

    # -- comparisons ----------------------------------------------------------
    def __lt__(self, o):
        return BinExpr("lt", self, wrap(o))

    def __le__(self, o):
        return BinExpr("le", self, wrap(o))

    def __gt__(self, o):
        return BinExpr("gt", self, wrap(o))

    def __ge__(self, o):
        return BinExpr("ge", self, wrap(o))

    def eq(self, o):  # cannot override __eq__ safely (hashing)
        return BinExpr("eq", self, wrap(o))

    def ne(self, o):
        return BinExpr("ne", self, wrap(o))

    def astype(self, dtype: str) -> "Expr":
        return CastExpr(self, dtype)

    # -- trace hygiene --------------------------------------------------------
    def __bool__(self):
        raise TraceError(
            "A symbolic tile expression was used in Python control flow "
            "(if/while). Use T.if_then_else / masks instead."
        )

    def __iter__(self):
        raise TraceError("Tile expressions are not iterable.")

    def __hash__(self):  # identity hash; nodes are immutable-by-convention
        return id(self)


@dataclasses.dataclass(eq=False)
class ConstExpr(Expr):
    value: Any
    dtype: Optional[str] = None

    def __repr__(self):
        return f"{self.value}"


@dataclasses.dataclass(eq=False)
class VarExpr(Expr):
    """A named symbolic variable: grid index, loop index, parallel index."""

    name: str
    extent: Optional[int] = None  # range [0, extent) when known

    def __repr__(self):
        return self.name


@dataclasses.dataclass(eq=False)
class BinExpr(Expr):
    op: str
    lhs: Expr
    rhs: Expr

    def __repr__(self):
        return f"({self.lhs} {self.op} {self.rhs})"


@dataclasses.dataclass(eq=False)
class UnaryExpr(Expr):
    op: str
    operand: Expr

    def __repr__(self):
        return f"{self.op}({self.operand})"


@dataclasses.dataclass(eq=False)
class CastExpr(Expr):
    operand: Expr
    target_dtype: str

    def __repr__(self):
        return f"cast<{self.target_dtype}>({self.operand})"


@dataclasses.dataclass(eq=False)
class WhereExpr(Expr):
    cond: Expr
    then: Expr
    otherwise: Expr

    def __repr__(self):
        return f"where({self.cond}, {self.then}, {self.otherwise})"


@dataclasses.dataclass(eq=False)
class LoadExpr(Expr):
    """Read of ``buffer[idx...]`` inside an elementwise (T.Parallel) body."""

    buffer: Any  # TileBuffer; Any to avoid circular import
    indices: Tuple[Expr, ...]

    def __repr__(self):
        idx = ", ".join(map(repr, self.indices))
        return f"{self.buffer.name}[{idx}]"


def wrap(v) -> Expr:
    if isinstance(v, Expr):
        return v
    if isinstance(v, bool):
        return ConstExpr(v, "bool")
    if isinstance(v, int):
        return ConstExpr(v, "int32")
    if isinstance(v, float):
        return ConstExpr(v, "float32")
    raise TraceError(f"Cannot use value of type {type(v)} in a tile expression.")


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------

def _tensor(x):
    """A Python number as a tensor (float32 for floats, as JAX's weak
    scalars land); a tensor unchanged."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, dtype=torch.float32 if isinstance(x, float) else None)


def _extremum(py, tfn, clamp_kw):
    def f(a, b):
        ta, tb = isinstance(a, torch.Tensor), isinstance(b, torch.Tensor)
        if not ta and not tb:
            return py(a, b)
        if not tb:
            return torch.clamp(a, **{clamp_kw: b})
        if not ta:
            return torch.clamp(b, **{clamp_kw: a})
        return tfn(a, b)

    return f


def _floordiv(a, b):
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        return torch.div(_tensor(a), b, rounding_mode="floor")
    return a // b


def _unary_t(fn):
    return lambda a: fn(_tensor(a))


_BIN_IMPL: Dict[str, Callable[[Any, Any], Any]] = dict(
    add=lambda a, b: a + b,
    sub=lambda a, b: a - b,
    mul=lambda a, b: a * b,
    div=lambda a, b: a / b,
    floordiv=_floordiv,
    mod=lambda a, b: a % b,  # Python's sign rule, as torch.remainder
    pow=lambda a, b: a**b,
    shr=lambda a, b: a >> b,
    shl=lambda a, b: a << b,
    bitand=lambda a, b: a & b,
    bitor=lambda a, b: a | b,
    bitxor=lambda a, b: a ^ b,
    lt=lambda a, b: a < b,
    le=lambda a, b: a <= b,
    gt=lambda a, b: a > b,
    ge=lambda a, b: a >= b,
    eq=lambda a, b: a == b,
    ne=lambda a, b: a != b,
    max=_extremum(max, torch.maximum, "min"),
    min=_extremum(min, torch.minimum, "max"),
)
_UNARY_IMPL: Dict[str, Callable[[Any], Any]] = dict(
    neg=lambda a: -a,
    exp=_unary_t(torch.exp),
    exp2=_unary_t(torch.exp2),
    log=_unary_t(torch.log),
    log2=_unary_t(torch.log2),
    abs=_unary_t(torch.abs),
    sqrt=_unary_t(torch.sqrt),
    rsqrt=_unary_t(torch.rsqrt),
    sigmoid=_unary_t(torch.sigmoid),
    tanh=_unary_t(torch.tanh),
    floor=_unary_t(torch.floor),
    ceil=_unary_t(torch.ceil),
)


def evaluate(e: Expr, env: Dict[str, Any], load_fn: Callable) -> Any:
    """Vectorized evaluation.

    ``env`` maps variable names to values (ints or tensors shaped to
    broadcast over the surrounding iteration space).  ``load_fn(buffer,
    idx_values, idx_exprs)`` materializes a ``LoadExpr`` (tensor indexing in
    the reference interpreter; index maps refuse loads but of scalar
    tables).
    """
    from .buffer import torch_dtype

    def rec(node: Expr):
        if isinstance(node, ConstExpr):
            return node.value
        if isinstance(node, VarExpr):
            if node.name not in env:
                raise TraceError(f"Unbound variable {node.name!r} during evaluation.")
            return env[node.name]
        if isinstance(node, BinExpr):
            return _BIN_IMPL[node.op](rec(node.lhs), rec(node.rhs))
        if isinstance(node, UnaryExpr):
            return _UNARY_IMPL[node.op](rec(node.operand))
        if isinstance(node, CastExpr):
            return torch.as_tensor(rec(node.operand)).to(torch_dtype(node.target_dtype))
        if isinstance(node, WhereExpr):
            cond = rec(node.cond)
            if not isinstance(cond, torch.Tensor):
                return rec(node.then) if cond else rec(node.otherwise)
            return torch.where(cond, rec(node.then), rec(node.otherwise))
        if isinstance(node, LoadExpr):
            idx_values = tuple(rec(i) for i in node.indices)
            return load_fn(node.buffer, idx_values, node.indices)
        raise TraceError(f"Unknown expression node {node!r}")

    return rec(e)


def static_eval(e: Expr) -> Optional[int]:
    """Constant-fold to a Python number, or ``None`` if symbolic."""
    if isinstance(e, ConstExpr):
        return e.value
    if isinstance(e, BinExpr):
        a, b = static_eval(e.lhs), static_eval(e.rhs)
        if a is None or b is None:
            return None
        _PY = {
            "add": lambda x, y: x + y,
            "sub": lambda x, y: x - y,
            "mul": lambda x, y: x * y,
            "floordiv": lambda x, y: x // y,
            "mod": lambda x, y: x % y,
        }
        fn = _PY.get(e.op)
        return None if fn is None else fn(a, b)
    if isinstance(e, UnaryExpr) and e.op == "neg":
        a = static_eval(e.operand)
        return None if a is None else -a
    return None


def free_vars(e: Expr) -> set:
    """Names of all variables referenced by ``e`` (including inside loads)."""
    out: set = set()

    def rec(node: Expr):
        if isinstance(node, VarExpr):
            out.add(node.name)
        elif isinstance(node, BinExpr):
            rec(node.lhs)
            rec(node.rhs)
        elif isinstance(node, (UnaryExpr,)):
            rec(node.operand)
        elif isinstance(node, CastExpr):
            rec(node.operand)
        elif isinstance(node, WhereExpr):
            rec(node.cond)
            rec(node.then)
            rec(node.otherwise)
        elif isinstance(node, LoadExpr):
            for i in node.indices:
                rec(i)

    rec(e)
    return out


def loads_in(e: Expr) -> list:
    """All LoadExpr nodes in ``e`` (pre-order)."""
    out: list = []

    def rec(node: Expr):
        if isinstance(node, LoadExpr):
            out.append(node)
            for i in node.indices:
                rec(i)
        elif isinstance(node, BinExpr):
            rec(node.lhs)
            rec(node.rhs)
        elif isinstance(node, UnaryExpr):
            rec(node.operand)
        elif isinstance(node, CastExpr):
            rec(node.operand)
        elif isinstance(node, WhereExpr):
            rec(node.cond)
            rec(node.then)
            rec(node.otherwise)

    rec(e)
    return out


# ---------------------------------------------------------------------------
# Affine analysis helpers (used by window index-map derivation)
# ---------------------------------------------------------------------------


def linear_decompose(e: Expr) -> Optional[Dict[str, int]]:
    """Decompose ``e`` as ``sum_i coeff_i * var_i + const`` if possible.

    Returns ``{var_name: coeff, "": const}`` or ``None`` when non-affine.
    """
    if isinstance(e, ConstExpr):
        if isinstance(e.value, bool) or not isinstance(e.value, int):
            return None
        return {"": e.value}
    if isinstance(e, VarExpr):
        return {e.name: 1, "": 0}
    if isinstance(e, UnaryExpr) and e.op == "neg":
        sub = linear_decompose(e.operand)
        if sub is None:
            return None
        return {k: -v for k, v in sub.items()}
    if isinstance(e, BinExpr):
        if e.op in ("add", "sub"):
            a, b = linear_decompose(e.lhs), linear_decompose(e.rhs)
            if a is None or b is None:
                return None
            sign = 1 if e.op == "add" else -1
            out = dict(a)
            out.setdefault("", 0)
            for k, v in b.items():
                out[k] = out.get(k, 0) + sign * v
            return out
        if e.op == "mul":
            a, b = linear_decompose(e.lhs), linear_decompose(e.rhs)
            if a is None or b is None:
                return None
            a_const = set(a) <= {""}
            b_const = set(b) <= {""}
            if not (a_const or b_const):
                return None
            const = a[""] if a_const else b[""]
            other = b if a_const else a
            return {k: v * const for k, v in other.items()}
    return None
