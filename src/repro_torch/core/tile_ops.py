"""Tile operator IR nodes (paper §3.2, Fig. 4).

Every tile operator implements the paper's two interfaces:

* ``infer_layout(layout_map, level)`` — contribute layout constraints at a
  given priority level (GEMM is strictest; elementwise conforms last).
* lowering — per-op handling in each backend (``backends/reference.py``,
  ``backends/cuda.py``).

Ops are *pure descriptions*; they never touch device state at trace time.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from .buffer import FRAGMENT, GLOBAL, SHARED, AxisSel, Region, TileBuffer
from .errors import LoweringError, TraceError
from .expr import ConstExpr, Expr, VarExpr, static_eval

# Layout-inference priority levels (paper §4.2: strict ops bind layouts first)
LEVEL_STRICT = 0  # tensor-core GEMM
LEVEL_COMMON = 1  # copy / reduce
LEVEL_FLEX = 2  # elementwise / fill


# ---------------------------------------------------------------------------
# Resolved regions
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ResolvedRegion:
    """A Region with concrete extents: per-axis (start expr, size, collapsed)."""

    buffer: TileBuffer
    starts: Tuple[Expr, ...]
    sizes: Tuple[int, ...]
    collapsed: Tuple[bool, ...]  # axis dropped in the logical tile view

    @property
    def tile_shape(self) -> Tuple[int, ...]:
        return tuple(s for s, c in zip(self.sizes, self.collapsed) if not c)

    def __repr__(self):
        parts = []
        for st, sz, col in zip(self.starts, self.sizes, self.collapsed):
            parts.append(f"{st}+:{sz}" + ("↓" if col else ""))
        return f"{self.buffer.name}[{', '.join(parts)}]"


def as_region(x) -> Region:
    if isinstance(x, Region):
        return x
    if isinstance(x, TileBuffer):
        return x.full_region()
    raise TraceError(f"Expected a buffer or region, got {type(x)}")


def resolve_copy_regions(src: Region, dst: Region) -> Tuple[ResolvedRegion, ResolvedRegion]:
    """Infer extents for ``T.copy`` operands (TileLang semantics).

    Scalar ("corner") selections either *collapse* an axis (when the peer has
    fewer axes) or denote a tile *corner* whose extent comes from the peer.
    """
    s_res = _resolve_against(src, dst)
    d_res = _resolve_against(dst, src)
    if s_res.tile_shape != d_res.tile_shape:
        raise TraceError(
            f"copy: tile shapes differ {s_res.tile_shape} vs {d_res.tile_shape} "
            f"({s_res} -> {d_res})"
        )
    return s_res, d_res


def _peer_tile_shape(peer: Region) -> Optional[Tuple[int, ...]]:
    """Tile shape of the peer if determinable without our help."""
    sizes = []
    for sel in peer.sels:
        if sel.kind in ("full", "slice"):
            sizes.append(sel.size)
        elif sel.kind == "corner":
            return None  # peer needs us to resolve
    return tuple(sizes)


def _resolve_against(r: Region, peer: Region) -> ResolvedRegion:
    n_scalar = sum(1 for s in r.sels if s.kind == "corner")
    n_sized = len(r.sels) - n_scalar
    peer_shape = _peer_tile_shape(peer)

    starts: List[Expr] = []
    sizes: List[int] = []
    collapsed: List[bool] = []

    if peer_shape is not None and n_sized == len(peer_shape):
        # All scalar sels collapse; sized sels must match the peer tile.
        it = iter(peer_shape)
        for axis, sel in enumerate(r.sels):
            if sel.kind == "corner":
                starts.append(sel.start)
                sizes.append(1)
                collapsed.append(True)
            else:
                expect = next(it)
                if sel.size != expect:
                    raise TraceError(
                        f"copy: extent mismatch on {r.buffer.name} axis {axis}: "
                        f"{sel.size} vs peer {expect}"
                    )
                starts.append(sel.start)
                sizes.append(sel.size)
                collapsed.append(False)
    elif peer_shape is not None and len(r.sels) >= len(peer_shape):
        # Right-align: the trailing len(peer) axes resolve positionally
        # (corner -> take peer extent); all leading axes must be scalar and
        # collapse.  This covers e.g. Q[bz, by, bx*bm, 0] -> (block_M, dim).
        lead = len(r.sels) - len(peer_shape)
        for axis in range(lead):
            sel = r.sels[axis]
            if sel.kind != "corner":
                raise TraceError(
                    f"copy: cannot align {r.buffer.name} axis {axis} (sized) "
                    f"with lower-rank peer {peer.buffer.name}"
                )
            starts.append(sel.start)
            sizes.append(1)
            collapsed.append(True)
        for off, (sel, psz) in enumerate(zip(r.sels[lead:], peer_shape)):
            starts.append(sel.start)
            if sel.kind == "corner":
                sizes.append(int(psz))
                collapsed.append(False)
            else:
                if sel.size != psz:
                    raise TraceError(
                        f"copy: extent mismatch on {r.buffer.name} axis "
                        f"{lead + off}: {sel.size} vs peer {psz}"
                    )
                sizes.append(sel.size)
                collapsed.append(False)
    elif peer_shape is None and n_scalar == 0:
        # We are fully sized; peer will resolve against us.
        for sel in r.sels:
            starts.append(sel.start)
            sizes.append(sel.size)
            collapsed.append(False)
    else:
        raise TraceError(
            f"copy: cannot infer extents for {r.buffer.name} "
            f"({len(r.sels)} axes, {n_scalar} scalar) against peer "
            f"{peer.buffer.name} ({len(peer.sels)} axes)"
        )
    # Bounds sanity for static corners
    for axis, (st, sz) in enumerate(zip(starts, sizes)):
        sv = static_eval(st)
        if sv is not None and sv + sz > r.buffer.shape[axis]:
            raise TraceError(
                f"copy: region [{sv}, {sv + sz}) exceeds {r.buffer.name} axis "
                f"{axis} extent {r.buffer.shape[axis]}"
            )
    return ResolvedRegion(r.buffer, tuple(starts), tuple(sizes), tuple(collapsed))


# ---------------------------------------------------------------------------
# Op base
# ---------------------------------------------------------------------------


class TileOp:
    """Base tile operator."""

    def buffers_read(self) -> List[TileBuffer]:
        return []

    def buffers_written(self) -> List[TileBuffer]:
        return []

    def infer_layout(self, layout_map: Dict[str, Any], level: int) -> None:
        """Contribute layout constraints at ``level`` (see infer.py)."""

    @property
    def priority(self) -> int:
        return LEVEL_FLEX


@dataclasses.dataclass
class CopyOp(TileOp):
    """``T.copy`` — parallel data movement between any two scopes."""

    src: ResolvedRegion
    dst: ResolvedRegion

    def buffers_read(self):
        return [self.src.buffer]

    def buffers_written(self):
        return [self.dst.buffer]

    @property
    def priority(self):
        return LEVEL_COMMON

    @property
    def kind(self) -> str:
        return f"{self.src.buffer.scope}->{self.dst.buffer.scope}"

    def __repr__(self):
        return f"Copy({self.src} -> {self.dst})"


@dataclasses.dataclass
class GemmOp(TileOp):
    """``T.gemm`` — tile matmul (fp32 accumulation on the CUDA cores today).

    ``accumulate`` is always true (TileLang semantics: C += A@B; use
    T.clear to reset).  ``policy`` is advisory (the warp policy, recorded).
    """

    a: TileBuffer
    b: TileBuffer
    c: TileBuffer
    transpose_a: bool = False
    transpose_b: bool = False
    policy: Optional[str] = None
    # m/n/k extents of the tile contraction, resolved at trace time:
    m: int = 0
    n: int = 0
    k: int = 0

    def buffers_read(self):
        return [self.a, self.b, self.c]

    def buffers_written(self):
        return [self.c]

    @property
    def priority(self):
        return LEVEL_STRICT

    def __repr__(self):
        ta = "T" if self.transpose_a else ""
        tb = "T" if self.transpose_b else ""
        return (
            f"Gemm({self.a.name}{ta} @ {self.b.name}{tb} -> {self.c.name} "
            f"[{self.m}x{self.n}x{self.k}])"
        )


@dataclasses.dataclass
class FillOp(TileOp):
    """``T.fill`` / ``T.clear``."""

    buffer: TileBuffer
    value: Expr

    def buffers_written(self):
        return [self.buffer]

    def __repr__(self):
        return f"Fill({self.buffer.name} = {self.value})"


@dataclasses.dataclass
class ReduceOp(TileOp):
    """``T.reduce_{sum,max,min,...}`` over one axis of a tile."""

    kind: str  # sum|max|min|prod|absmax
    src: TileBuffer
    dst: TileBuffer
    axis: int
    clear: bool = True  # False: combine with dst's current contents

    def buffers_read(self):
        return [self.src] + ([] if self.clear else [self.dst])

    def buffers_written(self):
        return [self.dst]

    @property
    def priority(self):
        return LEVEL_COMMON

    def __repr__(self):
        return f"Reduce[{self.kind}]({self.src.name} axis={self.axis} -> {self.dst.name})"


@dataclasses.dataclass
class CumsumOp(TileOp):
    """``T.cumsum`` along an axis (linear-attention intra-chunk scans)."""

    src: TileBuffer
    dst: TileBuffer
    axis: int
    reverse: bool = False

    def buffers_read(self):
        return [self.src]

    def buffers_written(self):
        return [self.dst]


@dataclasses.dataclass
class ParallelOp(TileOp):
    """``T.Parallel`` elementwise body: a list of stores over an iteration box.

    Each store is ``(buffer, idx_exprs, value_expr)``.  Thread binding /
    vectorization for this op is *inferred*, never written by the user
    (paper §4.2, Fig. 8).
    """

    axes: Tuple[VarExpr, ...]
    extents: Tuple[int, ...]
    stores: List[Tuple[TileBuffer, Tuple[Expr, ...], Expr]] = dataclasses.field(
        default_factory=list
    )

    def buffers_read(self):
        from .expr import loads_in

        out = []
        for _, idx, val in self.stores:
            for e in (*idx, val):
                for ld in loads_in(e):
                    out.append(ld.buffer)
        return out

    def buffers_written(self):
        return [b for b, _, _ in self.stores]

    def __repr__(self):
        axes = ", ".join(f"{a.name}<{e}>" for a, e in zip(self.axes, self.extents))
        return f"Parallel[{axes}]({len(self.stores)} stores)"


@dataclasses.dataclass
class PipelinedOp(TileOp):
    """``T.Pipelined`` loop: the software-pipeline region (paper §4.4).

    The grid plan makes it the innermost (``arbitrary``) axis; the CUDA
    backend runs it as a serial loop inside each block.  ``num_stages`` and
    explicit ``order``/``stage`` hints are recorded as scheduling metadata
    (multi-buffering depth); the backend stages one copy of each tile today.
    """

    var: VarExpr
    extent: int
    num_stages: int
    body: List[TileOp] = dataclasses.field(default_factory=list)
    order: Optional[Sequence[int]] = None
    stage: Optional[Sequence[int]] = None

    def buffers_read(self):
        out = []
        for op in self.body:
            out.extend(op.buffers_read())
        return out

    def buffers_written(self):
        out = []
        for op in self.body:
            out.extend(op.buffers_written())
        return out

    def __repr__(self):
        return (
            f"Pipelined({self.var.name} < {self.extent}, stages={self.num_stages}, "
            f"{len(self.body)} ops)"
        )


@dataclasses.dataclass
class SerialOp(TileOp):
    """``T.serial`` / ``T.unroll`` — an in-kernel loop, unrolled at lowering."""

    var: VarExpr
    extent: int
    unroll: bool
    body: List[TileOp] = dataclasses.field(default_factory=list)

    def buffers_read(self):
        out = []
        for op in self.body:
            out.extend(op.buffers_read())
        return out

    def buffers_written(self):
        out = []
        for op in self.body:
            out.extend(op.buffers_written())
        return out


@dataclasses.dataclass
class AtomicOp(TileOp):
    """``T.atomic_{add,max,min}`` into a global region (an in-out window:
    the reference interpreter reads, combines and writes it back; the CUDA
    backend issues one atomic an element)."""

    kind: str
    dst: ResolvedRegion
    src: TileBuffer

    def buffers_read(self):
        return [self.src, self.dst.buffer]

    def buffers_written(self):
        return [self.dst.buffer]


@dataclasses.dataclass
class CustomOp(TileOp):
    """``T.call_tile_lib`` — Tile Library escape hatch (paper §4.3).

    The paper injects C++/PTX via ``T.import_source``/``T.call_extern``/
    ``T.ptx``; here ``fn`` is a function on torch tensors that consumes and
    produces whole tiles (the reference interpreter calls it; the CUDA
    backend rewrites it into T ops, ``backends/tile_lib.py``).
    """

    fn: Callable[..., Any]
    inputs: Tuple[TileBuffer, ...]
    output: TileBuffer
    name: str = "custom"

    def buffers_read(self):
        return list(self.inputs)

    def buffers_written(self):
        return [self.output]
