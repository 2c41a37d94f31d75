"""Layout & Fragment algebra (paper §4.1), on the card's geometry.

TileLang models index translation with a composable ``Layout`` abstraction: a
function ``f : K^n -> K^m`` from logical indices to memory coordinates,
expressed algebraically over ``IterVar``-like symbolic variables.  ``Fragment``
extends it to ``f : K^n -> K^2`` mapping a logical element to *(partition,
local slot)*.

The algebra is the JAX package's (``repro.core.layout``), unchanged: the same
``repeat`` / ``repeat_on_thread`` / ``replicate`` combinators as the paper's
Fig. 6.  Only the geometry below is the H100's instead of the TPU's: a warp
of 32 lanes, 32 four-byte shared-memory banks, and the tensor-core tile
(``mma.sync`` m16n8k16) in place of the TPU's 128-lane vregs and 128 x 128
MXU.

The inference pass (infer.py) consumes Layouts to report the tensor-core
alignment of each GEMM and the vector width of each elementwise op; the
scheduler (schedule.py) uses a Layout transform over grid coordinates to
realize ``T.use_swizzle``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from .errors import LayoutError
from .expr import (
    BinExpr,
    ConstExpr,
    Expr,
    VarExpr,
    linear_decompose,
    static_eval,
    wrap,
)

# ---------------------------------------------------------------------------
# The card's geometry (H100, sm_90a), stated once.  A warp is 32 lanes;
# shared memory is 32 banks of 4 bytes; the tensor-core tile is mma.sync's
# m16n8k16 for 16-bit operands (k is 256 bits of the operand: 8 for tf32,
# 32 for int8); a vectorized shared-memory access moves 16 bytes.
# ---------------------------------------------------------------------------
WARP = 32
BANKS = 32
BANK_BYTES = 4
MMA = (16, 8, 16)  # (m, n, k) of one tensor-core instruction
VECTOR_BYTES = 16


def mma_k(dtype: str) -> int:
    """The contraction depth of one tensor-core instruction on ``dtype``."""
    from .buffer import dtype_bits

    return 256 // dtype_bits(dtype)


def vector_elems(dtype: str) -> int:
    """Elements of ``dtype`` in one 16-byte vectorized access."""
    from .buffer import dtype_bits

    return max(1, VECTOR_BYTES * 8 // dtype_bits(dtype))


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


# ---------------------------------------------------------------------------
# Layout
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IterVar:
    """An iteration variable with a known extent (paper: IterVar with range)."""

    var: VarExpr
    extent: int

    @staticmethod
    def make(name: str, extent: int) -> "IterVar":
        return IterVar(VarExpr(name, extent=int(extent)), int(extent))


class Layout:
    """An algebraic index map ``f : K^n -> K^m``.

    ``iter_vars`` bind the n input dimensions; ``forward_index`` is a tuple of
    m expressions over those variables.
    """

    def __init__(self, iter_vars: Sequence[IterVar], forward_index: Sequence[Expr]):
        self.iter_vars: Tuple[IterVar, ...] = tuple(iter_vars)
        self.forward_index: Tuple[Expr, ...] = tuple(forward_index)

    # -- basic properties ----------------------------------------------------
    @property
    def in_shape(self) -> Tuple[int, ...]:
        return tuple(iv.extent for iv in self.iter_vars)

    @property
    def in_rank(self) -> int:
        return len(self.iter_vars)

    @property
    def out_rank(self) -> int:
        return len(self.forward_index)

    def out_shape(self) -> Tuple[int, ...]:
        """Bounding extents of each output coordinate (affine bound analysis).

        For affine expressions we evaluate the max over the input box exactly
        from coefficient signs; non-affine expressions fall back to corner
        sampling of the input box.
        """
        shape = []
        for e in self.forward_index:
            dec = linear_decompose(e)
            if dec is not None:
                hi = dec.get("", 0)
                for iv in self.iter_vars:
                    c = dec.get(iv.var.name, 0)
                    if c > 0:
                        hi += c * (iv.extent - 1)
                shape.append(hi + 1)
            else:
                shape.append(self._sample_max(e) + 1)
        return tuple(int(s) for s in shape)

    def _sample_max(self, e: Expr) -> int:
        import itertools as _it

        best = 0
        corners = [(0, iv.extent - 1) for iv in self.iter_vars]
        for pt in _it.product(*corners):
            env = {iv.var.name: v for iv, v in zip(self.iter_vars, pt)}
            val = _substitute_eval(e, env)
            if val is None:
                raise LayoutError(f"Cannot bound non-affine layout expr {e!r}")
            best = max(best, int(val))
        return best

    # -- application -----------------------------------------------------------
    def __call__(self, *indices):
        """Apply the map to indices (ints, Exprs, or tensors)."""
        if len(indices) != self.in_rank:
            raise LayoutError(
                f"Layout expects {self.in_rank} indices, got {len(indices)}"
            )
        env = {iv.var.name: idx for iv, idx in zip(self.iter_vars, indices)}
        return tuple(_substitute(e, env) for e in self.forward_index)

    def map_concrete(self, *indices: int) -> Tuple[int, ...]:
        env = {iv.var.name: int(i) for iv, i in zip(self.iter_vars, indices)}
        out = []
        for e in self.forward_index:
            v = _substitute_eval(e, env)
            if v is None:
                raise LayoutError(f"Layout expr {e!r} not evaluable at {indices}")
            out.append(int(v))
        return tuple(out)

    # -- composition (paper: "composable and stackable") -----------------------
    def compose(self, inner: "Layout") -> "Layout":
        """``self ∘ inner``: first apply ``inner``, feed its outputs to ``self``."""
        if inner.out_rank != self.in_rank:
            raise LayoutError(
                f"Cannot compose: inner produces {inner.out_rank} coords, outer "
                f"consumes {self.in_rank}"
            )
        env = {
            iv.var.name: e
            for iv, e in zip(self.iter_vars, inner.forward_index)
        }
        fwd = tuple(_substitute(e, env) for e in self.forward_index)
        return type(self)(inner.iter_vars, fwd)

    def __repr__(self):
        ivs = ", ".join(f"{iv.var.name}<{iv.extent}>" for iv in self.iter_vars)
        fwd = ", ".join(map(repr, self.forward_index))
        return f"{type(self).__name__}([{ivs}] -> ({fwd}))"

    # -- bijectivity check (padding layouts are non-bijective; Fig. 5c) -------
    def is_bijective(self) -> bool:

        in_size = 1
        for iv in self.iter_vars:
            in_size *= iv.extent
        if in_size > 1 << 16:  # only check small layouts exactly
            raise LayoutError("Bijectivity check too large; use structural info")
        seen = set()
        import itertools as _it

        for pt in _it.product(*(range(iv.extent) for iv in self.iter_vars)):
            out = self.map_concrete(*pt)
            if out in seen:
                return False
            seen.add(out)
        out_size = 1
        for s in self.out_shape():
            out_size *= s
        return len(seen) == out_size


# -- substitution helpers ----------------------------------------------------


def _substitute(e: Expr, env: Dict[str, object]):
    """Substitute variables; returns an Expr when env values are Exprs, or a
    numeric value when everything folds."""
    from .expr import CastExpr, LoadExpr, UnaryExpr, WhereExpr

    def rec(node):
        if isinstance(node, ConstExpr):
            return node
        if isinstance(node, VarExpr):
            if node.name in env:
                v = env[node.name]
                return v if isinstance(v, Expr) else wrap(v)
            return node
        if isinstance(node, BinExpr):
            return BinExpr(node.op, rec(node.lhs), rec(node.rhs))
        if isinstance(node, UnaryExpr):
            return UnaryExpr(node.op, rec(node.operand))
        if isinstance(node, CastExpr):
            return CastExpr(rec(node.operand), node.target_dtype)
        if isinstance(node, WhereExpr):
            return WhereExpr(rec(node.cond), rec(node.then), rec(node.otherwise))
        if isinstance(node, LoadExpr):
            return LoadExpr(node.buffer, tuple(rec(i) for i in node.indices))
        raise LayoutError(f"Unknown node {node!r}")

    out = rec(e)
    sv = static_eval(out)
    return sv if sv is not None else out


def _substitute_eval(e: Expr, env: Dict[str, int]) -> Optional[int]:
    out = _substitute(e, env)
    if isinstance(out, Expr):
        return static_eval(out)
    return out


# ---------------------------------------------------------------------------
# Common layout constructors
# ---------------------------------------------------------------------------


def row_major(shape: Sequence[int]) -> Layout:
    """Standard C-order linearization ``(i0,..,ik) -> i0*s0 + ... + ik``."""
    ivs = [IterVar.make(f"i{d}", s) for d, s in enumerate(shape)]
    stride = 1
    strides = []
    for s in reversed(shape):
        strides.append(stride)
        stride *= int(s)
    strides = list(reversed(strides))
    expr: Expr = ConstExpr(0)
    for iv, st in zip(ivs, strides):
        expr = expr + iv.var * st
    return Layout(ivs, (expr,))


def strided(shape: Sequence[int], strides: Sequence[int]) -> Layout:
    ivs = [IterVar.make(f"i{d}", s) for d, s in enumerate(shape)]
    expr: Expr = ConstExpr(0)
    for iv, st in zip(ivs, strides):
        expr = expr + iv.var * int(st)
    return Layout(ivs, (expr,))


def padded(shape: Sequence[int], pad_to: Sequence[int]) -> Layout:
    """Non-bijective padding layout (paper Fig. 5c): logical (i,j) land in a
    padded physical box (a shared tile whose rows are padded to whole
    16-byte vectors)."""
    if len(shape) != len(pad_to):
        raise LayoutError("padded: rank mismatch")
    ivs = [IterVar.make(f"i{d}", s) for d, s in enumerate(shape)]
    fwd = tuple(iv.var + 0 for iv in ivs)  # identity coords in a padded box
    lay = Layout(ivs, fwd)
    lay._padded_shape = tuple(int(p) for p in pad_to)  # type: ignore[attr-defined]
    orig_out_shape = lay.out_shape

    def out_shape():
        return lay._padded_shape  # type: ignore[attr-defined]

    lay.out_shape = out_shape  # type: ignore[assignment]
    del orig_out_shape
    return lay


def tiled_2d(shape: Tuple[int, int], tile: Tuple[int, int]) -> Layout:
    """(i, j) -> (i//ti, j//tj, i%ti, j%tj): blocked storage."""
    (M, N), (ti, tj) = shape, tile
    i, j = IterVar.make("i", M), IterVar.make("j", N)
    fwd = (i.var // ti, j.var // tj, i.var % ti, j.var % tj)
    return Layout([i, j], fwd)


def swizzle_2d(shape: Tuple[int, int], bank_words: int = 0) -> Layout:
    """XOR-swizzled row-major layout.

    On the card this kills shared-memory bank conflicts (32 banks of 4
    bytes); the paper's ``T.annotate_layout``/``make_swizzle_layout`` request
    it explicitly.  The CUDA backend stores every shared tile row-major
    today, so an annotated swizzle is recorded by inference only.
    """
    M, N = shape
    i, j = IterVar.make("i", M), IterVar.make("j", N)
    fwd = (i.var, (j.var ^ (i.var % max(1, N))) % N if bank_words == 0 else (j.var ^ (i.var // bank_words)) % N)
    return Layout([i, j], fwd)


# ---------------------------------------------------------------------------
# Fragment: f : K^n -> (partition, local)
# ---------------------------------------------------------------------------


class Fragment(Layout):
    """A Layout whose two outputs are *(partition, local_index)*.

    GPU reading: partition = thread (or warp tile) within the block, local =
    register slot.  ``replication`` counts how many partitions
    hold a copy of the same logical element (paper Fig. 7 — bias broadcast).
    """

    def __init__(self, iter_vars, forward_index, replication: int = 1):
        if len(tuple(forward_index)) != 2:
            raise LayoutError("Fragment must produce exactly (partition, local)")
        super().__init__(iter_vars, forward_index)
        self.replication = int(replication)

    # -- the paper's four extension primitives (Fig. 6) ------------------------
    def repeat(self, n: int, axis: int = 0) -> "Fragment":
        """Tile the fragment n× along a logical axis; new elements land in the
        *same partitions* with new local slots (single warp consuming more
        rows; Fig. 6c top)."""
        ivs, subst, new_var = self._extend_axis(n, axis)
        part, local = (
            _substitute(self.forward_index[0], subst),
            _substitute(self.forward_index[1], subst),
        )
        locals_per = self._local_extent()
        local = wrap(local) + new_var * locals_per
        return Fragment(ivs, (wrap(part), local), self.replication)

    def repeat_on_thread(self, n: int, axis: int = 0) -> "Fragment":
        """Tile n× along an axis onto *new partitions* (more warps; local slots
        unchanged)."""
        ivs, subst, new_var = self._extend_axis(n, axis)
        part, local = (
            _substitute(self.forward_index[0], subst),
            _substitute(self.forward_index[1], subst),
        )
        parts_per = self._partition_extent()
        part = wrap(part) + new_var * parts_per
        return Fragment(ivs, (part, wrap(local)), self.replication)

    def replicate(self, n: int) -> "Fragment":
        """Replicate the whole fragment across n partition groups: every
        logical element now lives in n partitions (broadcast operands)."""
        rep = IterVar.make(f"_rep{len(self.iter_vars)}", n)
        parts_per = self._partition_extent()
        part = wrap(self.forward_index[0]) + rep.var * parts_per
        return Fragment(
            tuple(self.iter_vars) + (rep,),
            (part, self.forward_index[1]),
            self.replication * n,
        )

    def condense(self) -> "Fragment":
        """Drop replication (inverse of replicate); keeps partition group 0."""
        if self.replication == 1:
            return self
        ivs = self.iter_vars[:-1]
        env = {self.iter_vars[-1].var.name: 0}
        fwd = tuple(wrap(_substitute(e, env)) for e in self.forward_index)
        return Fragment(ivs, fwd, 1)

    # -- helpers ---------------------------------------------------------------
    def _extend_axis(self, n, axis):
        if axis >= self.in_rank:
            raise LayoutError(f"repeat axis {axis} out of range")
        old = self.iter_vars[axis]
        new_outer = IterVar.make(f"_o{axis}_{n}", n)
        merged = IterVar.make(old.var.name, old.extent * n)
        # merged index m decomposes as m = new_outer*old.extent + old
        subst = {old.var.name: merged.var % old.extent}
        ivs = list(self.iter_vars)
        ivs[axis] = merged
        new_var = merged.var // old.extent
        return tuple(ivs), subst, new_var

    def _partition_extent(self) -> int:
        return int(self.out_shape()[0])

    def _local_extent(self) -> int:
        return int(self.out_shape()[1])

    def threads(self) -> int:  # paper naming
        return self._partition_extent()

    def locals_per_thread(self) -> int:
        return self._local_extent()


def warp_fragment(shape: Tuple[int, int]) -> Fragment:
    """Base fragment of a 2-D tile (the counterpart of the JAX package's
    ``vreg_fragment``): map a logical tile onto (warp tile, slot), a warp
    tile being one tensor-core tile's 16 rows by one warp's 32 lanes.  Warp
    tiles are raster-ordered over the logical tile."""
    sub = MMA[0]
    M, N = shape
    pn = round_up(N, WARP)
    tiles_n = pn // WARP
    i, j = IterVar.make("i", M), IterVar.make("j", N)
    tile_id = (i.var // sub) * tiles_n + (j.var // WARP)
    slot = (i.var % sub) * WARP + (j.var % WARP)
    return Fragment([i, j], (tile_id, slot))
