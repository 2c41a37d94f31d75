"""Window extraction pass: copies that become operand windows.

Every ``global -> onchip`` copy becomes an input window and every
``onchip -> global`` copy (or global atomic) an output window.  Windows are
target-neutral: the CUDA backend turns them into block-strided loads and
stores, the reference backend into slices.

A param that is *both* read through input windows and written through a
**table-directed** output window (the paged-KV pool of the chunked-prefill
kernel: prior pages gathered through the block table, the chunk's pages
written back through it) is marked ``aliased`` — the backends then treat
it as an in-out operand (the caller's tensor, written in place), so pages no
grid cell writes keep their previous contents.  The kernel contract is
that the read and write page sets of one launch are disjoint; the lowering
cannot verify this for data-dependent tables, so the aliasing is granted
only when the store's starts actually load a scalar-prefetch buffer —
statically-indexed read+write of one param remains a lowering error.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from ..buffer import FRAGMENT, GLOBAL, SHARED, TileBuffer
from ..errors import LoweringError
from ..tile_ops import AtomicOp, CopyOp, ResolvedRegion, SerialOp, TileOp
from .phases import LOOP, POST, PRE, Phases


@dataclasses.dataclass
class Window:
    """One operand window: a block of a global tensor that a grid cell reads
    or writes."""

    param: TileBuffer  # the global buffer
    onchip: Optional[TileBuffer]  # dst for inputs; src for outputs (may be None for atomics)
    region: ResolvedRegion  # region on the global side
    phase: str
    is_output: bool
    aliased: bool = False  # in-out (atomic RMW)

    @property
    def block_shape(self) -> Tuple[int, ...]:
        return tuple(self.region.sizes)


def _is_onchip(buf: TileBuffer) -> bool:
    return buf.scope in (SHARED, FRAGMENT)


def collect_windows(program, phases: Phases):
    """Find all global<->onchip copies; returns (in_windows, out_windows,
    window_backed: dst name -> window idx, store_ops)."""
    in_windows: List[Window] = []
    out_windows: List[Window] = []
    fed_by: Dict[str, Window] = {}
    stores: List[Tuple[TileOp, str, Window]] = []  # (op, phase, out window)

    def scan(ops: List[TileOp], phase: str):
        for op in ops:
            if isinstance(op, SerialOp):
                scan(op.body, phase)
            elif isinstance(op, CopyOp):
                s, d = op.src.buffer, op.dst.buffer
                if s.scope == GLOBAL and _is_onchip(d):
                    if d.name in fed_by:
                        raise LoweringError(
                            f"{program.name}: buffer {d.name} fed by two "
                            "global copies; each shared tile must have one "
                            "producer copy."
                        )
                    if any(c for c in op.dst.collapsed) or op.dst.tile_shape != tuple(
                        op.dst.buffer.shape
                    ):
                        raise LoweringError(
                            f"{program.name}: global->onchip copy must fill the "
                            f"whole destination tile ({op})"
                        )
                    w = Window(s, d, op.src, phase, is_output=False)
                    in_windows.append(w)
                    fed_by[d.name] = w
                elif _is_onchip(s) and d.scope == GLOBAL:
                    w = _merge_out_window(out_windows, Window(d, s, op.dst, phase, True))
                    stores.append((op, phase, w))
                elif s.scope == GLOBAL and d.scope == GLOBAL:
                    raise LoweringError(
                        f"{program.name}: global->global copy; stage through "
                        "a shared tile."
                    )
            elif isinstance(op, AtomicOp):
                if op.dst.buffer.scope != GLOBAL:
                    continue
                w = _merge_out_window(
                    out_windows, Window(op.dst.buffer, None, op.dst, phase, True, aliased=True)
                )
                w.aliased = True
                stores.append((op, phase, w))

    scan(phases.pre, PRE)
    if phases.pipeline is not None:
        scan(phases.pipeline.body, LOOP)
    scan(phases.post, POST)
    # A written param that is also fed to input windows becomes an in-out
    # operand — but only when the store's placement is data-dependent
    # (scalar-load starts, the paged write path): there the caller owns the
    # disjointness contract and unwritten regions must survive the call.
    # Statically-indexed read+write of one param stays rejected by the
    # backends (the overlap is the user error the old guard caught).
    read_params = {id(w.param) for w in in_windows}
    for w in out_windows:
        if id(w.param) in read_params and _scalar_dependent(w.region):
            w.aliased = True
    return in_windows, out_windows, fed_by, stores


def _scalar_dependent(region: ResolvedRegion) -> bool:
    from ..buffer import SCALAR
    from ..expr import loads_in

    return any(
        ld.buffer.scope == SCALAR for s in region.starts for ld in loads_in(s)
    )


def _merge_out_window(out_windows: List[Window], w: Window) -> Window:
    for existing in out_windows:
        if existing.param is w.param:
            if existing.block_shape != w.block_shape or not _same_starts(
                existing.region, w.region
            ):
                raise LoweringError(
                    f"two stores to {w.param.name} with different windows; "
                    "unify the destination regions."
                )
            return existing
    out_windows.append(w)
    return w


def _same_starts(a: ResolvedRegion, b: ResolvedRegion) -> bool:
    return [repr(s) for s in a.starts] == [repr(s) for s in b.starts]
