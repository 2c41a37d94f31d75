"""Tile buffers and memory scopes.

TileLang's hallmark is *explicit placement* of buffers in the memory
hierarchy.  On the card the scopes map as:

=================  =======================  ==================================
TileLang scope     GPU realization          the CUDA backend today
=================  =======================  ==================================
``global``         HBM/DRAM                 HBM (the kernel's pointer args)
``shared``         SMEM (per-block SRAM)    dynamic shared memory
``fragment``       register file per block  dynamic shared memory too (one
                                            block-strided loop a tile op)
``scalar``         (block tables, lengths)  HBM, read element by element
=================  =======================  ==================================

Indexing a buffer returns either a :class:`Region` (corner/slice selection,
used as ``T.copy`` operands) or, inside a ``T.Parallel`` elementwise body, a
:class:`LoadExpr` scalar node.  Assignment inside ``T.Parallel`` records an
elementwise-store op on the current kernel context.
"""
from __future__ import annotations

import dataclasses
import math
import itertools
from typing import Optional, Sequence, Tuple

import torch

from .errors import TraceError
from .expr import ConstExpr, Expr, LoadExpr, static_eval, wrap

GLOBAL = "global"
SHARED = "shared"
FRAGMENT = "fragment"
# Scalar-prefetch params (T.ScalarTensor): small integer tensors whose
# elements *index expressions* — window starts included — may read.  This is
# how data-dependent gathers (paged attention block tables) stay inside the
# declarative window model.
SCALAR = "scalar"

_SCOPES = (GLOBAL, SHARED, FRAGMENT, SCALAR)

_counter = itertools.count()

_DTYPE_BITS = {
    "float32": 32,
    "bfloat16": 16,
    "float16": 16,
    "float64": 64,
    "int8": 8,
    "uint8": 8,
    "int16": 16,
    "int32": 32,
    "uint32": 32,
    "int64": 64,
    "bool": 8,
    "float8_e4m3fn": 8,
    "float8_e5m2": 8,
}

_DTYPE_ALIASES = {
    "fp32": "float32",
    "f32": "float32",
    "bf16": "bfloat16",
    "fp16": "float16",
    "f16": "float16",
    "fp64": "float64",
    "i8": "int8",
    "u8": "uint8",
    "i32": "int32",
    "i64": "int64",
}


def torch_dtype(dtype: str) -> torch.dtype:
    """The torch dtype of a tile dtype name."""
    return getattr(torch, canonical_dtype(dtype))


def canonical_dtype(dtype: str) -> str:
    d = _DTYPE_ALIASES.get(dtype, dtype)
    if d not in _DTYPE_BITS:
        raise TraceError(f"Unsupported tile dtype {dtype!r}")
    return d


def dtype_bits(dtype: str) -> int:
    return _DTYPE_BITS[canonical_dtype(dtype)]


@dataclasses.dataclass(frozen=True)
class AxisSel:
    """Selection along one buffer axis.

    ``kind`` is one of:
      * ``"corner"``  — scalar start index; extent taken from the peer buffer
      * ``"collapse"``— scalar index selecting a single element (axis dropped)
      * ``"slice"``   — explicit [start, start+size) window
      * ``"full"``    — the whole axis
    """

    kind: str
    start: Expr
    size: Optional[int] = None  # static size for "slice"/"full"


class Region:
    """A rectangular sub-region of a buffer, as produced by indexing."""

    def __init__(self, buffer: "TileBuffer", sels: Tuple[AxisSel, ...]):
        self.buffer = buffer
        self.sels = sels

    def __repr__(self):
        return f"Region({self.buffer.name}, {self.sels})"


class TileBuffer:
    """A shaped, typed buffer living in one of the three memory scopes."""

    def __init__(
        self,
        shape: Sequence[int],
        dtype: str,
        scope: str,
        name: Optional[str] = None,
    ):
        if scope not in _SCOPES:
            raise TraceError(f"Unknown buffer scope {scope!r}")
        self.shape: Tuple[int, ...] = tuple(int(s) for s in shape)
        if any(s <= 0 for s in self.shape):
            raise TraceError(f"Buffer shape must be positive, got {self.shape}")
        self.dtype = canonical_dtype(dtype)
        self.scope = scope
        self.name = name or f"{scope[0]}buf{next(_counter)}"

    # ------------------------------------------------------------------
    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def nbytes(self) -> int:
        return self.size * dtype_bits(self.dtype) // 8

    def __repr__(self):
        return f"TileBuffer({self.name}: {self.scope} {self.dtype}{list(self.shape)})"

    # ------------------------------------------------------------------
    # Indexing.  Two modes:
    #   * inside a T.Parallel body -> scalar LoadExpr / elementwise store
    #   * otherwise                -> Region (T.copy operand)
    # ------------------------------------------------------------------
    def _normalize_idx(self, idx) -> Tuple:
        if not isinstance(idx, tuple):
            idx = (idx,)
        if len(idx) > self.ndim:
            raise TraceError(
                f"{self.name}: {len(idx)} indices for {self.ndim}-d buffer"
            )
        # pad with full-axis selections
        idx = idx + (slice(None),) * (self.ndim - len(idx))
        return idx

    def __getitem__(self, idx):
        from . import program  # circular-safe: resolved at call time

        idx = self._normalize_idx(idx)
        if self.scope == SCALAR:
            # Scalar-prefetch buffers are read element-wise wherever an index
            # expression is legal: copy-region starts (-> data-dependent
            # window index maps) and T.Parallel bodies alike.
            exprs = []
            for i in idx:
                if isinstance(i, slice):
                    raise TraceError(
                        f"{self.name}: scalar-prefetch buffers must be indexed "
                        "element-wise (no slices)."
                    )
                exprs.append(wrap(i))
            if len(exprs) != self.ndim:
                raise TraceError(
                    f"{self.name}: scalar-prefetch load needs all {self.ndim} "
                    f"indices, got {len(exprs)}"
                )
            return LoadExpr(self, tuple(exprs))
        ctx = program.current_parallel_context()
        if ctx is not None and self.scope != GLOBAL:
            # Elementwise scalar load
            exprs = []
            for axis, i in enumerate(idx):
                if isinstance(i, slice):
                    if i.start is None and i.stop is None:
                        raise TraceError(
                            f"{self.name}: slices are not allowed in elementwise "
                            "bodies; index every axis with scalar expressions."
                        )
                    raise TraceError("Partial slices unsupported in T.Parallel body")
                exprs.append(wrap(i))
            return LoadExpr(self, tuple(exprs))
        # Region mode
        sels = []
        for axis, i in enumerate(idx):
            if isinstance(i, slice):
                if i.step not in (None, 1):
                    raise TraceError("Strided slices are not supported")
                if i.start is None and i.stop is None:
                    sels.append(
                        AxisSel("full", ConstExpr(0), self.shape[axis])
                    )
                else:
                    start = wrap(i.start if i.start is not None else 0)
                    if i.stop is None:
                        raise TraceError("Open-ended slices unsupported")
                    stop = wrap(i.stop)
                    size = _static_extent(start, stop)
                    sels.append(AxisSel("slice", start, size))
            else:
                # scalar: corner vs collapse resolved later against the peer
                sels.append(AxisSel("corner", wrap(i), None))
        return Region(self, tuple(sels))

    def __setitem__(self, idx, value):
        from . import program

        ctx = program.current_parallel_context()
        if ctx is None:
            raise TraceError(
                f"Assignment to {self.name}[...] outside a T.Parallel body; "
                "use T.copy / T.fill for region writes."
            )
        idx = self._normalize_idx(idx)
        exprs = []
        for i in idx:
            if isinstance(i, slice):
                raise TraceError("Slices unsupported on the LHS of elementwise stores")
            exprs.append(wrap(i))
        ctx.record_store(self, tuple(exprs), wrap(value))

    # convenience: whole-buffer region
    def full_region(self) -> Region:
        return Region(
            self,
            tuple(AxisSel("full", ConstExpr(0), s) for s in self.shape),
        )


def _static_extent(start: Expr, stop: Expr) -> int:
    """Extent of ``stop - start``; must be statically known."""
    from .expr import BinExpr

    diff = BinExpr("sub", stop, start)
    val = static_eval(diff)
    if val is None:
        # Common symbolic pattern: k*c : (k+1)*c  -> extent c.
        val = _symbolic_extent(start, stop)
    if val is None:
        raise TraceError(
            f"Slice extent must be static; got [{start} : {stop}]"
        )
    if val <= 0:
        raise TraceError(f"Slice extent must be positive, got {val}")
    return int(val)


def _symbolic_extent(start: Expr, stop: Expr) -> Optional[int]:
    """Recognize ``e*c : (e+1)*c`` and ``e : e+c`` patterns."""
    from .expr import BinExpr, linear_decompose

    ds, dp = linear_decompose(start), linear_decompose(stop)
    if ds is None or dp is None:
        return None
    names = set(ds) | set(dp)
    diff = {}
    for n in names:
        diff[n] = dp.get(n, 0) - ds.get(n, 0)
    if any(v != 0 for k, v in diff.items() if k != ""):
        return None
    return diff.get("", None)
