"""Cost-estimation pass (feeds the roofline): FLOPs and HBM bytes of a
lowered program, judged against the H100's peaks."""
from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

from ..buffer import dtype_bits
from ..tile_ops import CumsumOp, GemmOp, ParallelOp, ReduceOp, SerialOp, TileOp
from .phases import LOOP, Phases
from .windows import Window


def _h100(key: str) -> float:
    """A peak of the card, as ``roofline.analysis.HW_H100`` states it once
    (imported at call time: the roofline imports the kernels, whose
    program modules import this package)."""
    from ...roofline.analysis import HW_H100

    return HW_H100[key]


@dataclasses.dataclass
class KernelCost:
    flops: int
    hbm_bytes: int
    grid: Tuple[int, ...]
    vmem_bytes: int  # the block's shared-memory plan (the JAX field name)

    def compute_seconds(self, peak_flops: Optional[float] = None) -> float:
        return self.flops / (peak_flops or _h100("peak_flops_bf16"))

    def memory_seconds(self, hbm_bw: Optional[float] = None) -> float:
        return self.hbm_bytes / (hbm_bw or _h100("hbm_bw"))

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / max(self.hbm_bytes, 1)

    def bound(self, peak_flops: Optional[float] = None,
              hbm_bw: Optional[float] = None) -> str:
        return (
            "compute" if self.compute_seconds(peak_flops) >= self.memory_seconds(hbm_bw)
            else "memory"
        )


def estimate_cost(
    program,
    phases: Phases,
    grid: Tuple[int, ...],
    in_windows: List[Window],
    out_windows: List[Window],
    vmem,
) -> KernelCost:
    total_steps = math.prod(grid)
    pipe = phases.pipeline
    cells = total_steps // (pipe.extent if pipe is not None else 1)

    flops = 0

    def op_flops(op: TileOp) -> int:
        if isinstance(op, GemmOp):
            return 2 * op.m * op.n * op.k
        if isinstance(op, ParallelOp):
            return math.prod(op.extents) * max(1, len(op.stores)) * 2
        if isinstance(op, (ReduceOp,)):
            return op.src.size
        if isinstance(op, CumsumOp):
            return op.src.size
        if isinstance(op, SerialOp):
            return op.extent * sum(op_flops(o) for o in op.body)
        return 0

    for op in phases.pre + phases.post:
        flops += cells * op_flops(op)
    if pipe is not None:
        for op in pipe.body:
            flops += total_steps * op_flops(op)

    hbm = 0
    for w in in_windows:
        steps = total_steps if w.phase == LOOP else cells
        hbm += steps * math.prod(w.block_shape) * dtype_bits(w.param.dtype) // 8
    for w in out_windows:
        steps = total_steps if w.phase == LOOP else cells
        hbm += steps * math.prod(w.block_shape) * dtype_bits(w.param.dtype) // 8

    return KernelCost(flops=flops, hbm_bytes=hbm, grid=tuple(grid), vmem_bytes=vmem.total_bytes)
