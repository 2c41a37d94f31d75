"""Index-map derivation: a window's block indices from the grid ids."""
from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional

from ..buffer import SCALAR
from ..errors import LoweringError
from ..expr import Expr, evaluate, linear_decompose


def make_index_map(
    region,
    env_builder: Callable[..., Dict[str, Any]],
    scalar_params: Optional[List] = None,
):
    """Build ``index_map(*grid_ids) -> block indices`` for one window.

    Affine starts with size-divisible coefficients fold statically; otherwise
    we fall back to a runtime floordiv (correct when the region is aligned —
    the TileLang contract for unmasked copies).

    ``scalar_params`` (when non-empty) is the declaration-ordered list of
    scalar-prefetch buffers: the index map then accepts their tables as
    trailing arguments and resolves ``LoadExpr`` starts against them — the data-dependent gather of
    paged attention block tables.  The same derivation serves input *and*
    output windows: a store whose starts load a block table becomes a
    table-directed output window (the chunked-prefill kernel writing the
    chunk's K/V pages), paired with an in-out alias so unwritten pages keep
    their previous contents.
    """
    starts, sizes = region.starts, region.sizes
    scalar_names = [p.name for p in (scalar_params or [])]

    def fold(e: Expr, size: int):
        if size == 1:
            return ("expr", e)
        dec = linear_decompose(e)
        if dec is not None and all(v % size == 0 for v in dec.values()):
            folded = {k: v // size for k, v in dec.items()}
            return ("affine", folded)
        return ("div", e)

    plans = [fold(e, s) for e, s in zip(starts, sizes)]

    def index_map(*args):
        if scalar_names:
            n = len(scalar_names)
            grid_ids, scalar_refs = args[:-n], args[-n:]
            by_name = dict(zip(scalar_names, scalar_refs))

            def load_fn(buffer, idx_values, idx_exprs):
                ref = by_name.get(buffer.name)
                if ref is None or buffer.scope != SCALAR:
                    raise LoweringError(
                        f"index expression loads {buffer.name}, which is not "
                        "a scalar-prefetch param"
                    )
                return ref[tuple(idx_values)]

        else:
            grid_ids = args
            load_fn = no_loads
        env = env_builder(*grid_ids)

        def ev(e: Expr):
            return evaluate(e, env, load_fn=load_fn)

        out = []
        for (kind, payload), size in zip(plans, sizes):
            if kind == "expr":
                out.append(ev(payload))
            elif kind == "affine":
                acc = payload.get("", 0)
                for name, coeff in payload.items():
                    if name == "":
                        continue
                    if coeff:
                        acc = acc + coeff * env[name]
                out.append(acc)
            else:
                out.append(ev(payload) // size)
        return tuple(out)

    return index_map


def no_loads(buffer, idx_values, idx_exprs):
    raise LoweringError("Buffer loads are not allowed in index expressions")
