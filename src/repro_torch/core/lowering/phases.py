"""Phase classification pass (DESIGN.md §3.1).

A kernel body has at most one top-level ``T.Pipelined`` loop; everything
before it runs once per grid cell at k==0 (PRE), everything after at k==last
(POST).  The phase tag decides both window placement (LOOP windows advance
with the reduction axis).  The CUDA backend runs PRE once before the
pipelined loop and POST once after it, inside each block.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

from ..errors import LoweringError
from ..tile_ops import PipelinedOp, TileOp

PRE, LOOP, POST = "pre", "loop", "post"


@dataclasses.dataclass
class Phases:
    pre: List[TileOp]
    pipeline: Optional[PipelinedOp]
    post: List[TileOp]


def split_phases(program) -> Phases:
    pre: List[TileOp] = []
    pipe: Optional[PipelinedOp] = None
    post: List[TileOp] = []
    for op in program.ops:
        if isinstance(op, PipelinedOp):
            if pipe is not None:
                raise LoweringError(
                    f"{program.name}: multiple T.Pipelined loops at kernel top "
                    "level; fuse them or split the kernel (one grid pipeline "
                    "per kernel)."
                )
            pipe = op
        elif pipe is None:
            pre.append(op)
        else:
            post.append(op)
    return Phases(pre, pipe, post)
