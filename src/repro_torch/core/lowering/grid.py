"""Grid planning pass: kernel axes -> launch grid + scalar environment.

Kernel axes are reversed so the first-declared axis (``bx``) is the
fastest-varying parallel dimension (CUDA blockIdx.x convention), and the
pipelined axis is innermost overall so accumulators stay resident.  An
active ``T.use_swizzle`` flattens a 2-D parallel grid into one panel-raster
axis (see schedule.swizzle_decode).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Optional, Tuple

from ..schedule import Schedule, swizzle_decode, validate_swizzle
from .phases import Phases


@dataclasses.dataclass
class GridPlan:
    grid: Tuple[int, ...]
    env_builder: Callable[..., Dict[str, Any]]
    kdim: Optional[int]  # grid position of the pipelined ("arbitrary") axis
    dimension_semantics: Tuple[str, ...]


def plan_grid(program, phases: Phases, schedule: Schedule) -> GridPlan:
    kernel_axes = program.grid_axes  # declaration order
    n = len(kernel_axes)
    swz = schedule.grid_swizzle
    if swz is None:
        swz = program.annotations.swizzle

    pipe = phases.pipeline
    kext = pipe.extent if pipe is not None else None
    kname = pipe.var.name if pipe is not None else None

    if swz is not None and n == 2:
        (v0, e0), (v1, e1) = kernel_axes
        # v1 (by) slower, v0 (bx) faster in raster;
        # flatten to one axis and decode with panel swizzling.  Clamp the
        # panel height to a divisor of the row extent (traced decode needs
        # uniform panels).
        factor = min(swz, e1)
        if e1 % factor != 0:
            factor = math.gcd(e1, factor) or 1
        validate_swizzle(e1, e0, factor)
        grid = (e1 * e0,) + ((kext,) if kext else ())
        sem = ("arbitrary",) * len(grid)

        def env_builder(*gids):
            flat = gids[0]
            i1, i0 = swizzle_decode(flat, e1, e0, factor)
            env = {v1.name: i1, v0.name: i0}
            if kname is not None:
                env[kname] = gids[1]
            return env

        kdim = 1 if kext else None
        return _with_override(grid, env_builder, kdim, sem, schedule)

    grid = tuple(e for _, e in reversed(kernel_axes)) + ((kext,) if kext else ())
    sem = ("parallel",) * n + (("arbitrary",) if kext else ())

    def env_builder(*gids):
        env = {}
        for i, (v, _) in enumerate(kernel_axes):
            env[v.name] = gids[n - 1 - i]
        if kname is not None:
            env[kname] = gids[n]
        return env

    kdim = n if kext else None
    return _with_override(grid, env_builder, kdim, sem, schedule)


def _with_override(grid, env_builder, kdim, sem, schedule: Schedule) -> GridPlan:
    if schedule.dimension_semantics is not None:
        sem = tuple(schedule.dimension_semantics)
    return GridPlan(grid, env_builder, kdim, sem)
