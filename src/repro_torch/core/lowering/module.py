"""The ``LoweredModule`` analysis artifact and the compiled-kernel wrapper.

A ``LoweredModule`` is everything the pass pipeline knows about one
``(TileProgram, Schedule)`` pair — phases, windows, grid plan, shared-memory plan,
parameter ordering, layout inference and cost — with **no target code**.
Backends (``core.backends``) consume it to emit a :class:`CompiledKernel`;
an autotuner can score it without emitting code (DESIGN.md §3).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..buffer import TileBuffer
from ..errors import LoweringError
from ..infer import InferenceResult
from ..schedule import Schedule, VmemPlan
from .cost import KernelCost
from .grid import GridPlan
from .phases import Phases
from .windows import Window


@dataclasses.dataclass
class LoweredInfo:
    """Backend-independent summary attached to every compiled kernel."""

    grid: Tuple[int, ...]
    dimension_semantics: Tuple[str, ...]
    vmem: VmemPlan
    inference: InferenceResult
    cost: KernelCost
    num_stages: int
    n_windows_in: int
    n_windows_out: int


@dataclasses.dataclass
class LoweredModule:
    """Single analysis artifact produced by the pass pipeline.

    Fields are filled pass by pass (in PIPELINE order); ``None`` means the
    corresponding pass has not run yet.  The artifact is cached per
    (program fingerprint, schedule key) and may therefore be shared between
    structurally identical programs — backends must only depend on the
    structure, never on Python object identity of the originating trace.
    """

    program: Any
    schedule: Schedule
    # -- split_phases ------------------------------------------------------
    phases: Optional[Phases] = None
    # -- infer_layouts -----------------------------------------------------
    inference: Optional[InferenceResult] = None
    # -- collect_windows ---------------------------------------------------
    in_windows: List[Window] = dataclasses.field(default_factory=list)
    out_windows: List[Window] = dataclasses.field(default_factory=list)
    fed_by: Dict[str, Window] = dataclasses.field(default_factory=dict)
    stores: List[Tuple] = dataclasses.field(default_factory=list)
    # -- plan_grid ---------------------------------------------------------
    grid_plan: Optional[GridPlan] = None
    # -- plan_stages -------------------------------------------------------
    num_stages: int = 1
    # -- plan_vmem ---------------------------------------------------------
    vmem: Optional[VmemPlan] = None
    # -- plan_params -------------------------------------------------------
    scratch_bufs: List[TileBuffer] = dataclasses.field(default_factory=list)
    scratch_pos: Dict[str, int] = dataclasses.field(default_factory=dict)
    arg_params: List[TileBuffer] = dataclasses.field(default_factory=list)
    out_params: List[TileBuffer] = dataclasses.field(default_factory=list)
    # scalar-prefetch params (declaration order); a subset of arg_params
    scalar_params: List[TileBuffer] = dataclasses.field(default_factory=list)
    # operand index into arg_params per input window; None when the window
    # reads a written global.
    window_param_idx: List[Optional[int]] = dataclasses.field(default_factory=list)
    window_of: Dict[str, int] = dataclasses.field(default_factory=dict)
    out_window_of: Dict[int, int] = dataclasses.field(default_factory=dict)
    # -- estimate_cost -----------------------------------------------------
    cost: Optional[KernelCost] = None
    # -- verify ------------------------------------------------------------
    # runtime obligations (verify.Obligation): checks the static verifier
    # could not prove because they depend on runtime scalars (table-directed
    # windows); the dispatch guard in kernels/ops.py discharges them.
    obligations: List[Any] = dataclasses.field(default_factory=list)

    # ---------------------------------------------------------------------
    @property
    def grid(self) -> Tuple[int, ...]:
        return self.grid_plan.grid if self.grid_plan is not None else ()

    @property
    def dimension_semantics(self) -> Tuple[str, ...]:
        return (
            tuple(self.grid_plan.dimension_semantics)
            if self.grid_plan is not None
            else ()
        )

    def info(self) -> LoweredInfo:
        return LoweredInfo(
            grid=self.grid,
            dimension_semantics=self.dimension_semantics,
            vmem=self.vmem,
            inference=self.inference,
            cost=self.cost,
            num_stages=self.num_stages,
            n_windows_in=len(self.in_windows),
            n_windows_out=len(self.out_windows),
        )

    def summary(self) -> str:
        lines = [
            f"LoweredModule({self.program.name})",
            f"  grid={self.grid} semantics={self.dimension_semantics}",
            f"  windows: {len(self.in_windows)} in / {len(self.out_windows)} out, "
            f"scratch={len(self.scratch_bufs)}, stages={self.num_stages}",
        ]
        if self.cost is not None:
            lines.append(
                f"  cost: {self.cost.flops/1e9:.2f} GFLOP, "
                f"{self.cost.hbm_bytes/2**20:.1f} MiB HBM, "
                f"AI={self.cost.arithmetic_intensity:.1f} ({self.cost.bound()}-bound)"
            )
        if self.vmem is not None:
            lines.append("  " + self.vmem.summary().replace("\n", "\n  "))
        return "\n".join(lines)


class CompiledKernel:
    """Callable wrapper: ``kernel(*input_arrays) -> output(s)``.

    Inputs are the program's read-only global params (in declaration order)
    followed by any in-out (atomic) params; outputs are the written globals
    in declaration order.
    """

    def __init__(self, program, fn: Callable, info: LoweredInfo,
                 arg_params: List[TileBuffer], out_params: List[TileBuffer],
                 backend: str = "?"):
        self.program = program
        self._fn = fn
        self.info = info
        self.arg_params = arg_params
        self.out_params = out_params
        self.backend = backend
        self.__name__ = program.name

    def __call__(self, *arrays):
        if len(arrays) != len(self.arg_params):
            raise LoweringError(
                f"{self.program.name}: expected {len(self.arg_params)} arrays "
                f"({[p.name for p in self.arg_params]}), got {len(arrays)}"
            )
        for arr, p in zip(arrays, self.arg_params):
            if tuple(arr.shape) != p.shape:
                raise LoweringError(
                    f"{self.program.name}: arg {p.name} shape {arr.shape} != "
                    f"declared {p.shape}"
                )
        out = self._fn(*arrays)
        return out
