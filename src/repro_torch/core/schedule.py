"""Schedule space & shared-memory planning (paper §4: everything that is
*not* dataflow).

The four scheduling axes of the paper map onto the card (the CUDA backend,
backends/cuda.py) as:

=====================  =====================================================
paper axis             realization here
=====================  =====================================================
thread binding         ``T.Kernel(threads=)`` is the CUDA block size; each
                       tile op is a block-strided loop over its elements
memory layout          Layout/Fragment (layout.py/infer.py); every shared
                       and fragment buffer lives in dynamic shared memory,
                       or, with ``Schedule(workspace=True)``, the largest in
                       a per-block global workspace where they do not fit
tensorization          T.gemm -> an fp32-accumulating loop on the CUDA cores
pipeline               T.Pipelined -> a serial loop inside the block; the
                       stage count is recorded, one copy of each tile staged
=====================  =====================================================

``Schedule`` collects the knobs a caller can set without touching the
dataflow; ``plan_vmem`` (the JAX package's name, kept) lays the block's
buffers out in shared memory and validates the footprint against the card's
budget *before* any code is emitted.  There is no interpret mode: a CPU run
asks for ``target="reference"``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Set, Tuple

from .buffer import dtype_bits
from .errors import ScheduleError
from .layout import BANK_BYTES, BANKS, round_up, vector_elems

# The H100's opt-in maximum of dynamic shared memory for one block (227 KiB;
# cudaFuncAttributeMaxDynamicSharedMemorySize), and the alignment of each
# buffer's offset in it (one 16-byte vector).
SMEM_BYTES = 232_448
SMEM_ALIGN = 16
# A block's part of the global workspace starts on a 128-byte line.
WORKSPACE_ALIGN = 128
SHARED, WORKSPACE = "shared", "workspace"  # the two spaces a buffer lives in


@dataclasses.dataclass
class Schedule:
    """User-controllable scheduling knobs for one program."""

    num_stages: Optional[int] = None  # override T.Pipelined's stage count
    grid_swizzle: Optional[int] = None  # override T.use_swizzle
    dimension_semantics: Optional[Tuple[str, ...]] = None  # rarely needed
    smem_limit: int = SMEM_BYTES
    # Opt-in: where the block's shared memory cannot hold its tiles, the
    # largest go to a per-block global workspace (the card's counterpart of
    # the TPU's VMEM budget, which is ~470 times one block's shared memory).
    workspace: bool = False
    # Advisory: collected for the cost model / roofline.
    notes: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class BufferPlan:
    name: str
    scope: str
    logical_shape: Tuple[int, ...]
    physical_shape: Tuple[int, ...]  # rows padded to whole 16-byte vectors
    copies: int  # staging copies (1: the backend stages one tile at a time)
    bytes: int
    offset: int = 0  # byte offset in the block's part of its space
    space: str = SHARED  # dynamic shared memory, or the block's workspace

    @property
    def waste(self) -> float:
        log = math.prod(self.logical_shape) or 1
        phys = math.prod(self.physical_shape)
        return 1.0 - log / phys


@dataclasses.dataclass
class VmemPlan:
    """The block's shared-memory plan (the JAX package's VMEM plan):
    ``total_bytes`` of shared memory, and ``workspace_bytes`` of global
    workspace a block (0 unless the schedule asked for one and the tiles
    did not fit)."""

    buffers: List[BufferPlan]
    total_bytes: int
    limit: int
    workspace_bytes: int = 0

    @property
    def ok(self) -> bool:
        return self.total_bytes <= self.limit

    def workspace(self) -> List[str]:
        """Names of the buffers in the workspace, in allocation order."""
        return [b.name for b in self.buffers if b.space == WORKSPACE]

    def summary(self) -> str:
        lines = [f"shared-memory plan: {self.total_bytes} B / {self.limit} B"]
        if self.workspace_bytes:
            lines.append(f"workspace: {self.workspace_bytes} B a block, holding "
                         f"{', '.join(self.workspace())}")
        for b in self.buffers:
            lines.append(
                f"  {b.name:<16} {b.scope:<8} {str(b.logical_shape):<18} -> "
                f"{str(b.physical_shape):<18} @{b.offset:<7} = {b.bytes/2**10:8.1f} KiB"
                + (f"  (pad waste {b.waste:.0%})" if b.waste > 0 else "")
                + ("  [workspace]" if b.space == WORKSPACE else "")
            )
        return "\n".join(lines)


def tensor_core_gemm(op) -> bool:
    """Whether a ``T.gemm`` runs on the tensor cores (``wmma`` m16n16k16):
    16-bit operands of one type into an fp32 accumulator (2-D, or batched
    over the operands' leading dims), every extent a multiple of 16.  Other
    GEMMs run on the CUDA cores."""
    a, b, c = op.a, op.b, op.c
    return (a.dtype == b.dtype and a.dtype in ("bfloat16", "float16")
            and c.dtype == "float32" and min(a.ndim, b.ndim) >= 2
            and c.ndim == max(a.ndim, b.ndim)
            and op.m % 16 == 0 and op.n % 16 == 0 and op.k % 16 == 0)


def tensor_core_operands(program) -> Set[str]:
    """Names of the buffers a tensor-core GEMM reads or accumulates into."""
    from .tile_ops import GemmOp, PipelinedOp, SerialOp

    out: Set[str] = set()

    def walk(ops):
        for op in ops:
            if isinstance(op, (PipelinedOp, SerialOp)):
                walk(op.body)
            elif isinstance(op, GemmOp) and tensor_core_gemm(op):
                out.update((op.a.name, op.b.name, op.c.name))

    walk(program.ops)
    return out


def physical_tile_shape(shape: Tuple[int, ...], dtype: str,
                        tensor_core: bool = False) -> Tuple[int, ...]:
    """Pad the minor dim to whole 16-byte vectors (shared memory needs no
    other tiling).  A tensor-core operand whose rows are whole 128-byte bank
    lines gets one vector more a row, so the 8 rows a ``wmma`` load reads at
    once fall in different banks."""
    if not shape:
        return shape
    s = list(shape)
    s[-1] = round_up(s[-1], vector_elems(dtype))
    if tensor_core and len(s) == 2 and (s[-1] * dtype_bits(dtype) // 8) % (BANKS * BANK_BYTES) == 0:
        s[-1] += vector_elems(dtype)
    return tuple(s)


def live_ranges(program) -> Dict[str, Tuple[int, int]]:
    """Each buffer's live range over the program's top-level ops: the first
    and the last op that reads or writes it.  A loop is one op, so a buffer
    that a loop touches is live for the whole loop."""
    out: Dict[str, Tuple[int, int]] = {}
    for i, op in enumerate(program.ops):
        for b in (*op.buffers_read(), *op.buffers_written()):
            lo, hi = out.get(b.name, (i, i))
            out[b.name] = (min(lo, i), max(hi, i))
    return out


def _lay_out(plans: List[BufferPlan], live: Dict[str, Tuple[int, int]], whole) -> int:
    """Set each plan's offset, in order: the lowest 16-byte aligned offset
    free of every buffer placed before it whose live range meets its own.
    Returns the bytes the buffers span."""
    placed: List[BufferPlan] = []
    for p in plans:
        lo, hi = live.get(p.name, whole)
        taken = sorted((q.offset, q.offset + q.bytes) for q in placed
                       if live.get(q.name, whole)[0] <= hi and lo <= live.get(q.name, whole)[1])
        offset = 0
        for start, end in taken:
            if start >= offset + p.bytes:
                break
            if end > offset:
                offset = round_up(end, SMEM_ALIGN)
        p.offset = offset
        placed.append(p)
    return max((q.offset + q.bytes for q in placed), default=0)


def plan_vmem(program, schedule: Schedule, check: bool = True) -> VmemPlan:
    """Lay out every ``shared`` and ``fragment`` buffer of a traced program
    in one block's dynamic shared memory (rows as ``physical_tile_shape``
    pads them): each at a 16-byte aligned offset, one copy each (the CUDA
    backend stages one tile at a time; a ring that honours ``num_stages``
    would multiply the loop's windows).

    Buffers are placed in allocation order, each at the lowest offset free
    of every buffer placed before it whose live range (:func:`live_ranges`)
    meets its own: a buffer dead before another is first touched shares its
    bytes (a quantized stage's unpack scratch, used before the pipelined
    loop, under the loop's tiles).  Where every range meets every other, as
    in a GEMM or the flash forward, the buffers follow one another.  The
    CUDA backend orders the accesses of two buffers that share bytes by the
    same barriers as those of one buffer.

    With ``schedule.workspace``, while the shared part is over
    ``schedule.smem_limit`` the largest buffer left (the first in allocation
    order among equals) moves to the block's part of a global workspace,
    and the shared part is laid out again; the workspace is laid out by the
    same rule, its size a block rounded up to ``WORKSPACE_ALIGN``.  A plan
    that fits moves nothing.

    ``check=False`` returns the (possibly over-budget) plan instead of
    raising — the pass pipeline uses this so the budget stays a *backend*
    feasibility concern (the reference interpreter has no shared memory).
    """
    tc = tensor_core_operands(program)
    live = live_ranges(program)
    whole = (0, len(program.ops))  # a buffer no op touches
    plans: List[BufferPlan] = []
    for buf in program.allocs:
        phys = physical_tile_shape(buf.shape, buf.dtype, buf.name in tc)
        nbytes = math.prod(phys) * dtype_bits(buf.dtype) // 8
        plans.append(BufferPlan(buf.name, buf.scope, buf.shape, phys, 1, nbytes))
    moved: List[BufferPlan] = []
    while True:
        shared = [p for p in plans if p.space == SHARED]
        total = round_up(_lay_out(shared, live, whole), SMEM_ALIGN)
        if total <= schedule.smem_limit or not schedule.workspace or not shared:
            break
        largest = max(shared, key=lambda p: p.bytes)  # the first of equals
        largest.space = WORKSPACE
        moved.append(largest)
    ws = round_up(_lay_out([p for p in plans if p.space == WORKSPACE], live, whole),
                  WORKSPACE_ALIGN) if moved else 0
    plan = VmemPlan(plans, total, schedule.smem_limit, ws)
    if check and not plan.ok:
        raise ScheduleError(
            f"{program.name}: shared-memory budget exceeded —\n{plan.summary()}\n"
            "Reduce block shapes."
        )
    return plan


# ---------------------------------------------------------------------------
# Grid swizzling (T.use_swizzle): reorder the sequential grid walk.
# ---------------------------------------------------------------------------


def swizzle_decode(flat, g0: int, g1: int, factor: int):
    """Decode a flattened 2-D grid step into (i0, i1) with panel rasterization.

    Walks ``factor`` consecutive i0 values per i1 before advancing i1 —
    consecutive blocks then reuse the same operand-1 tile from L2 (the
    paper's thread-block swizzle).  The CUDA backend emits this arithmetic
    to decode ``blockIdx.x``.

    Works on ints and integer tensors alike.
    """
    panel = factor * g1
    group = flat // panel
    rem = flat % panel
    if isinstance(flat, int):
        # Last (possibly ragged) panel: clamp the panel height.
        rows = min(factor, g0 - group * factor)
        i0 = group * factor + rem % rows
        i1 = rem // rows
        return i0, i1
    # Traced path: require g0 % factor == 0 (checked by caller).
    i0 = group * factor + rem % factor
    i1 = rem // factor
    return i0, i1


def validate_swizzle(g0: int, g1: int, factor: int):
    if factor <= 0:
        raise ScheduleError(f"swizzle factor must be positive, got {factor}")
    if g0 % factor != 0:
        raise ScheduleError(
            f"use_swizzle({factor}): leading grid extent {g0} must be a "
            f"multiple of the factor (the backend decodes the flattened axis "
            f"with uniform panels)"
        )
