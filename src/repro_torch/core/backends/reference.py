"""Reference interpreter backend: an independent oracle for the lowering.

Walks every grid cell sequentially and interprets the traced ops over torch
tensors (the JAX package's ``backends/reference.py`` on torch) — no emitted
code, no windows as such, no pipelining.  Tiny shapes only; its entire value
is being *structurally unrelated* to the CUDA emission (backends/cuda.py) so
the parity suite can cross-check them, on the CPU or on the card (it runs
on the inputs' device).

Two registered targets share the interpreter:

* ``reference`` — the oracle.  Region starts and scalar-load indices are
  always bounds-checked: a negative index would wrap to the *end* of a
  buffer, so a corrupt block-table entry would otherwise produce plausible
  garbage instead of an error.
* ``sanitize`` — the oracle under instrumentation: pure outputs are
  poison-filled and tracked per element, duplicate writes from distinct
  grid cells, reads of never-written output regions, non-finite values
  escaping into outputs (with the op that introduced them), and
  vectorized-store bounds are all reported as :class:`SanitizeError`.
"""
from __future__ import annotations

import itertools
from typing import Any, Dict, Optional

import torch

from ..buffer import GLOBAL, SCALAR, TileBuffer, torch_dtype
from ..errors import LoweringError, SanitizeError
from ..expr import Expr, VarExpr, evaluate, loads_in
from ..lowering.indexing import no_loads
from ..lowering.module import CompiledKernel, LoweredInfo, LoweredModule
from ..tile_ops import (
    AtomicOp,
    CopyOp,
    CumsumOp,
    CustomOp,
    FillOp,
    GemmOp,
    ParallelOp,
    ReduceOp,
    ResolvedRegion,
    SerialOp,
    TileOp,
)
from . import register_backend


def _check_region_starts(buffer: TileBuffer, starts, sizes, what: str):
    """Loud out-of-bounds error (always on): negative starts would wrap,
    over-large ones would be cut short — both silent."""
    for ax, (c, sz) in enumerate(zip(starts, sizes)):
        if c < 0 or c + sz > buffer.shape[ax]:
            raise SanitizeError(
                f"{what} out of bounds: {buffer.name} axis {ax} start {c} "
                f"block {sz} exceeds extent {buffer.shape[ax]}"
            )


def _check_scalar_index(buffer: TileBuffer, idx_values):
    for ax, v in enumerate(idx_values):
        if not isinstance(v, torch.Tensor) or v.numel() == 1:
            c = int(v)
            if c < 0 or c >= buffer.shape[ax]:
                raise SanitizeError(
                    f"scalar load out of bounds: {buffer.name} axis {ax} "
                    f"index {c} not in [0, {buffer.shape[ax]})"
                )


def _floating(t: torch.Tensor) -> bool:
    return t.dtype.is_floating_point


class _Sanitizer:
    """Per-invocation instrumentation state for the ``sanitize`` target.

    ``writer[name]`` maps every element of a written global to the grid
    cell that last wrote it (-1 = never written).  Duplicate writes are
    judged at *cell* granularity: one cell may rewrite its own region
    (pipelined accumulation), two different cells may not — except the
    serving page-0 convention, where table-directed stores park dead rows
    on reserved page 0 (a sanctioned garbage sink).
    """

    def __init__(self, module: LoweredModule):
        self.module = module
        self.cell = -1
        self.writer: Dict[str, torch.Tensor] = {}
        self.pure: set = set()
        self.taint: Dict[str, str] = {}
        aliased = {w.param.name for w in module.out_windows if w.aliased}
        for p in module.out_params:
            self.writer[p.name] = torch.full(p.shape, -1, dtype=torch.int64)
            if p.name not in aliased:
                self.pure.add(p.name)

    @staticmethod
    def _slices(starts, sizes):
        return tuple(slice(c, c + sz) for c, sz in zip(starts, sizes))

    @staticmethod
    def _page0_sink(region: ResolvedRegion, starts) -> bool:
        """A table-directed store whose dynamic axis landed on 0: the
        serving stack points every dead row at reserved page 0, so
        cross-cell duplicates there are sanctioned."""
        for ax, e in enumerate(region.starts):
            if any(ld.buffer.scope == SCALAR for ld in loads_in(e)):
                if starts[ax] == 0:
                    return True
        return False

    def _mark(self, name: str, where, what: str):
        mask = self.writer[name]
        prev = mask[where]
        clash = prev[(prev >= 0) & (prev != self.cell)]
        if clash.numel():
            raise SanitizeError(
                f"duplicate write: cells {int(clash.flatten()[0])} and {self.cell} "
                f"both write {what} — a lost write on parallel grids"
            )
        mask[where] = self.cell

    def on_region_write(self, region: ResolvedRegion, starts, op: TileOp):
        name = region.buffer.name
        if name not in self.writer or self._page0_sink(region, starts):
            return
        sl = self._slices(starts, region.sizes)
        self._mark(name, sl, f"{name}{list(sl)} ({op.__class__.__name__})")

    def on_full_write(self, buf: TileBuffer):
        if buf.name in self.writer:
            self._mark(buf.name, (...,), f"all of {buf.name}")

    def on_scatter_write(self, buf: TileBuffer, idx_vals):
        if buf.name in self.writer:
            idx = tuple(torch.as_tensor(v, dtype=torch.int64).cpu() for v in idx_vals)
            self._mark(buf.name, idx, f"scatter into {buf.name}")

    def on_region_read(self, region: ResolvedRegion, starts):
        if region.buffer.name not in self.pure:
            return
        mask = self.writer[region.buffer.name]
        sl = self._slices(starts, region.sizes)
        if (mask[sl] < 0).any():
            raise SanitizeError(
                f"read of uninitialized output region "
                f"{region.buffer.name}{list(sl)} (never written)"
            )

    def note_value(self, buf: TileBuffer, val: torch.Tensor, op: TileOp):
        if buf.name not in self.writer or buf.name in self.taint:
            return
        if _floating(val) and not bool(torch.isfinite(val).all()):
            self.taint[buf.name] = f"{op.__class__.__name__} at cell {self.cell}"

    def check_parallel_indices(self, buf: TileBuffer, idx_vals):
        for ax, v in enumerate(idx_vals):
            t = torch.as_tensor(v)
            lo, hi = int(t.min()), int(t.max())
            if lo < 0 or hi >= buf.shape[ax]:
                raise SanitizeError(
                    f"vectorized store out of bounds: {buf.name} axis {ax} "
                    f"indices span [{lo}, {hi}], extent {buf.shape[ax]}"
                )

    def finalize(self, globals_: Dict[str, Any]):
        for name in sorted(self.writer):
            val = globals_[name]
            if name in self.pure and (self.writer[name] < 0).any():
                n = int((self.writer[name] < 0).sum())
                raise SanitizeError(
                    f"output {name}: {n} element(s) never written "
                    "(poisoned values would escape to the caller)"
                )
            if _floating(val) and not bool(torch.isfinite(val).all()):
                origin = self.taint.get(name, "unknown op")
                raise SanitizeError(
                    f"output {name} contains non-finite values "
                    f"(first introduced by {origin})"
                )


def _poison(shape, dtype: torch.dtype, device) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.full(shape, float("nan"), dtype=dtype, device=device)
    return torch.full(shape, torch.iinfo(dtype).min, dtype=dtype, device=device)


def _emit(module: LoweredModule, sanitize: bool) -> CompiledKernel:
    program = module.program
    phases = module.phases
    pipe = phases.pipeline
    arg_params, out_params = module.arg_params, module.out_params
    kernel_axes = program.grid_axes

    def fn(*arrays):
        tensors = [torch.as_tensor(a) for a in arrays]
        device = tensors[0].device if tensors else torch.device("cpu")
        globals_: Dict[str, Any] = {}
        for p, a in zip(arg_params, tensors):
            # a copy: in-out params are written in place, never the caller's
            globals_[p.name] = a.to(device=device, dtype=torch_dtype(p.dtype), copy=True)
        san = _Sanitizer(module) if sanitize else None
        for p in out_params:
            # In-out (aliased) params are already seeded from arg_params —
            # regions no grid cell writes must keep the caller's contents
            # (paged-KV pool semantics); pure outputs start at zero (or at
            # poison under the sanitizer, so an unwritten element can never
            # masquerade as a legitimate zero).
            if p.name not in globals_:
                dt = torch_dtype(p.dtype)
                globals_[p.name] = (_poison(p.shape, dt, device) if sanitize
                                    else torch.zeros(p.shape, dtype=dt, device=device))

        for cell_id, cell in enumerate(itertools.product(*[range(e) for _, e in kernel_axes])):
            if san is not None:
                san.cell = cell_id
            env0 = {v.name: idx for (v, _), idx in zip(kernel_axes, cell)}
            tiles: Dict[str, Any] = {}

            def run(ops, extra):
                for op in ops:
                    _ref_op(op, globals_, tiles, {**env0, **extra}, device, san)

            run(phases.pre, {})
            if pipe is not None:
                for k in range(pipe.extent):
                    run(pipe.body, {pipe.var.name: k})
            run(phases.post, {})
        if san is not None:
            san.finalize(globals_)
        outs = [globals_[p.name] for p in out_params]
        return outs[0] if len(outs) == 1 else tuple(outs)

    backend = "sanitize" if sanitize else "reference"
    info = LoweredInfo(
        grid=tuple(e for _, e in kernel_axes),
        dimension_semantics=(backend,),
        vmem=module.vmem,
        inference=module.inference,
        cost=module.cost,
        num_stages=1,
        n_windows_in=len(module.in_windows),
        n_windows_out=len(module.out_windows),
    )
    return CompiledKernel(program, fn, info, arg_params, out_params, backend=backend)


@register_backend("reference")
def emit_reference(module: LoweredModule) -> CompiledKernel:
    return _emit(module, sanitize=False)


@register_backend("sanitize")
def emit_sanitize(module: LoweredModule) -> CompiledKernel:
    return _emit(module, sanitize=True)


def _index(v, device):
    """An index value for tensor indexing: a Python int, or an int64
    tensor on ``device``."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.int64)
    return int(v)


def _ref_op(op: TileOp, globals_: Dict, tiles: Dict, env: Dict, device,
            san: Optional[_Sanitizer] = None):
    def scalar_load(buffer, idx_values, idx_exprs):
        """Index-expression loads: only scalar-prefetch params are legal."""
        if buffer.scope != SCALAR:
            return no_loads(buffer, idx_values, idx_exprs)
        _check_scalar_index(buffer, idx_values)
        return globals_[buffer.name][tuple(_index(v, device) for v in idx_values)]

    def ev(e: Expr, extra=None, load_fn=None):
        en = dict(env)
        if extra:
            en.update(extra)
        return evaluate(e, en, load_fn if load_fn is not None else scalar_load)

    def get(buf: TileBuffer):
        if buf.scope in (GLOBAL, SCALAR):
            return globals_[buf.name]
        if buf.name not in tiles:
            tiles[buf.name] = torch.zeros(buf.shape, dtype=torch_dtype(buf.dtype),
                                          device=device)
        return tiles[buf.name]

    def put(buf: TileBuffer, val):
        val = torch.broadcast_to(torch.as_tensor(val, device=device), buf.shape)
        val = val.to(torch_dtype(buf.dtype)).clone()
        if buf.scope == GLOBAL:
            if san is not None:
                san.on_full_write(buf)
                san.note_value(buf, val, op)
            globals_[buf.name] = val
        else:
            tiles[buf.name] = val

    def starts_of(region: ResolvedRegion, what: str):
        starts = [int(ev(s)) for s in region.starts]
        _check_region_starts(region.buffer, starts, region.sizes, what)
        return starts

    def region_read(region: ResolvedRegion):
        base = get(region.buffer)
        starts = starts_of(region, "region read")
        if san is not None and region.buffer.scope == GLOBAL:
            san.on_region_read(region, starts)
        val = base[tuple(slice(c, c + sz) for c, sz in zip(starts, region.sizes))]
        keep = tuple(i for i, c in enumerate(region.collapsed) if not c)
        return val.reshape(tuple(region.sizes[i] for i in keep))

    def region_write(region: ResolvedRegion, val):
        base = get(region.buffer)
        starts = starts_of(region, "region write")
        upd = val.reshape(region.sizes).to(base.dtype)
        if san is not None and region.buffer.scope == GLOBAL:
            san.on_region_write(region, starts, op)
            san.note_value(region.buffer, upd, op)
        base[tuple(slice(c, c + sz) for c, sz in zip(starts, region.sizes))] = upd

    if isinstance(op, CopyOp):
        region_write(op.dst, region_read(op.src).to(torch_dtype(op.dst.buffer.dtype)))
    elif isinstance(op, FillOp):
        put(op.buffer, torch.full(op.buffer.shape, float(ev(op.value)),
                                  dtype=torch_dtype(op.buffer.dtype), device=device))
    elif isinstance(op, GemmOp):
        a, b = get(op.a), get(op.b)
        if op.transpose_a:
            a = a.transpose(-1, -2)
        if op.transpose_b:
            b = b.transpose(-1, -2)
        acc = get(op.c)
        prod = torch.matmul(a.float(), b.float())  # fp32 accumulation
        put(op.c, acc + prod.to(acc.dtype))
    elif isinstance(op, ReduceOp):
        src = get(op.src)
        fns = {
            "sum": lambda x: x.sum(dim=op.axis),
            "max": lambda x: x.amax(dim=op.axis),
            "min": lambda x: x.amin(dim=op.axis),
            "prod": lambda x: x.prod(dim=op.axis),
            "absmax": lambda x: x.abs().amax(dim=op.axis),
        }
        val = fns[op.kind](src)
        if not op.clear:
            comb = {"sum": torch.add, "max": torch.maximum, "min": torch.minimum,
                    "prod": torch.mul, "absmax": torch.maximum}[op.kind]
            dst = get(op.dst)
            val = comb(dst, val.reshape(dst.shape).to(dst.dtype))
        put(op.dst, val.reshape(op.dst.shape))
    elif isinstance(op, CumsumOp):
        src = get(op.src)
        if op.reverse:
            src = torch.flip(src, dims=(op.axis,))
        val = torch.cumsum(src, dim=op.axis)
        if op.reverse:
            val = torch.flip(val, dims=(op.axis,))
        put(op.dst, val)
    elif isinstance(op, ParallelOp):
        nax = len(op.axes)
        iotas = {}
        for i, (v, e) in enumerate(zip(op.axes, op.extents)):
            shape = [1] * nax
            shape[i] = e
            iotas[v.name] = torch.arange(e, dtype=torch.int64, device=device).reshape(shape)

        def load_fn(buffer, idx_values, idx_exprs):
            if buffer.scope == SCALAR:
                _check_scalar_index(buffer, idx_values)
            return get(buffer)[tuple(_index(v, device) for v in idx_values)]

        for buf, idx_exprs, val_expr in op.stores:
            val = ev(val_expr, extra=iotas, load_fn=load_fn)
            direct = (
                len(idx_exprs) == nax
                and all(isinstance(e, VarExpr) and e.name == op.axes[i].name
                        for i, e in enumerate(idx_exprs))
                and tuple(buf.shape) == op.extents
            )
            if direct:
                put(buf, torch.broadcast_to(torch.as_tensor(val, device=device), op.extents))
                continue
            idx_vals = tuple(_index(ev(e, extra=iotas, load_fn=load_fn), device)
                             for e in idx_exprs)
            if san is not None:
                san.check_parallel_indices(buf, idx_vals)
            cur = get(buf)
            # the iteration box broadcast over every index and the value
            idx_b = torch.broadcast_tensors(
                *[torch.as_tensor(v, device=device) for v in idx_vals],
                torch.zeros(op.extents, dtype=torch.int64, device=device))[:-1]
            val_b = torch.broadcast_to(torch.as_tensor(val, device=device).to(cur.dtype),
                                       idx_b[0].shape)
            new = cur.clone()
            new[idx_b] = val_b
            if buf.scope == GLOBAL:
                if san is not None:
                    san.on_scatter_write(buf, idx_b)
                    san.note_value(buf, new, op)
                globals_[buf.name] = new
            else:
                tiles[buf.name] = new
    elif isinstance(op, CustomOp):
        put(op.output, op.fn(*[get(b) for b in op.inputs]))
    elif isinstance(op, AtomicOp):
        base = get(op.dst.buffer)
        starts = starts_of(op.dst, "atomic update")
        sl = tuple(slice(c, c + sz) for c, sz in zip(starts, op.dst.sizes))
        cur = base[sl]
        val = get(op.src).reshape(op.dst.sizes).to(cur.dtype)
        comb = {"add": torch.add, "max": torch.maximum, "min": torch.minimum}[op.kind]
        base[sl] = comb(cur, val)
    elif isinstance(op, SerialOp):
        for i in range(op.extent):
            for o in op.body:
                _ref_op(o, globals_, tiles, {**env, op.var.name: i}, device, san)
    else:
        raise LoweringError(f"reference: unhandled op {op!r}")
