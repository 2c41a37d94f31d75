"""Sharding rules: the port of ``repro.distributed.sharding`` on DTensor.

Rules (Megatron-style TP on `model`, pure DP over `pod`×`data`), the
reference's table unchanged:

====================================  =======================================
param                                 spec
====================================  =======================================
embedding (V, D)                      (model, None)        vocab-sharded
unembed   (D, V)                      (None, model)
attn wq/wk/wv (D, H*hd)               (None, model)        column-parallel
attn wo (H*hd, D)                     (model, None)        row-parallel
mlp w_gate/w_up (D, F)                (None, model)
mlp w_down (F, D)                     (model, None)
moe experts (E, D, F)                 (model, None, None)  EP when E%model==0
                                      (None, None, model)  else TP-in-expert
mamba w_z/w_x (D, Di)                 (None, model)
mamba out_proj (Di, D)                (model, None)
norms / scalars / small projections   replicated
====================================  =======================================

ZeRO-1: optimizer state (fp32 masters + moments) additionally shards its
largest replicated axis over the data(+pod) axes when divisible.

Activations: batch over (pod, data); the residual stream between layers is
additionally sequence-sharded over `model` (sequence parallelism).

A spec (:class:`Spec`, JAX's ``PartitionSpec``) is a tuple with one entry a
dimension: an axis name, a tuple of names, or None.  The rules read a mesh
through ``mesh_dim_names`` and ``size(dim)``, so they take a
``launch.mesh.MeshSpec`` (no process group) or a ``DeviceMesh``.
:func:`to_placements` turns a spec into DTensor ``Shard``/``Replicate``
placements, and :func:`constrain` (``with_sharding_constraint``) is a
``redistribute``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Tuple

import torch
from torch.distributed.tensor import DTensor, Placement, Replicate, Shard, distribute_tensor
from torch.distributed.tensor.experimental import local_map


class Spec(tuple):
    """One entry a dimension (``PartitionSpec``); a leaf of a spec tree."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"Spec{tuple.__repr__(self)}"


def axis_names(mesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names or ())


def mesh_axis_size(mesh, name: str) -> int:
    names = axis_names(mesh)
    return mesh.size(names.index(name)) if name in names else 1


def axes_size(mesh, ax) -> int:
    """The size of an entry: 1 for None, the product over a tuple."""
    if ax is None:
        return 1
    return math.prod(mesh_axis_size(mesh, a) for a in (ax if isinstance(ax, tuple) else (ax,)))


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in axis_names(mesh))


def _divisible(dim: int, size: int) -> bool:
    return size > 0 and dim % size == 0


# ---------------------------------------------------------------------------
# trees of dicts and lists, with specs as leaves
# ---------------------------------------------------------------------------


def tree_map_with_path(fn: Callable, tree, path: Tuple[str, ...] = ()):
    """``fn("a/b/0", leaf)`` over a tree of dicts and lists (a ``Spec`` is
    a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (str(k),)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, Spec):
        return [tree_map_with_path(fn, v, path + (str(i),)) for i, v in enumerate(tree)]
    return fn("/".join(path), tree)


def tree_map2(fn: Callable, a, b):
    """``fn(x, y)`` over two trees of one structure (``a``'s leaves may be
    specs)."""
    if isinstance(a, dict):
        return {k: tree_map2(fn, v, b[k]) for k, v in a.items()}
    if isinstance(a, (list, tuple)) and not isinstance(a, Spec):
        return [tree_map2(fn, x, y) for x, y in zip(a, b)]
    return fn(a, b)


def spec_leaves(tree, path: Tuple[str, ...] = ()) -> Dict[str, Any]:
    """``{"a/b/0": leaf}`` of a tree (a ``Spec`` is a leaf)."""
    out: Dict[str, Any] = {}
    tree_map_with_path(lambda p, x: out.__setitem__(p, x), tree)
    return out


# ---------------------------------------------------------------------------
# parameters and optimizer state
# ---------------------------------------------------------------------------


def param_spec(path: str, shape: Tuple[int, ...], cfg, mesh) -> Spec:
    """Sharding rule for a single parameter (path = '/'-joined tree keys).

    Stacked layer params carry a leading L axis -> the rule applies to the
    trailing dims and the layer axis stays unsharded.
    """
    tp = mesh_axis_size(mesh, "model")
    name = path.split("/")[-1]
    parent = path.split("/")[-2] if "/" in path else ""

    def spec(*trailing):
        lead = (None,) * (len(shape) - len(trailing))
        # drop shardings that don't divide
        fixed = []
        for dim, ax in zip(shape[len(shape) - len(trailing):], trailing):
            if ax is None:
                fixed.append(None)
            else:
                fixed.append(ax if _divisible(dim, tp) else None)
        return Spec(*lead, *fixed)

    if name == "embedding":
        return spec("model", None)
    if name == "unembed":
        return spec(None, "model")
    if name in ("enc_pos", "dec_pos"):
        return Spec(*(None,) * len(shape))
    if name in ("wq", "wk", "wv", "w_q", "w_kpe", "w_dkv", "w_uk", "w_uv"):
        return spec(None, "model")
    if name in ("wo", "w_o"):
        return spec("model", None)
    if name in ("bq", "bk", "bv"):
        return spec("model")
    if name in ("w_gate", "w_up") and parent != "moe":
        return spec(None, "model")
    if name == "w_down" and parent != "moe":
        return spec("model", None)
    if parent == "moe" or (cfg.moe and name in ("w_gate", "w_up", "w_down") and len(shape) >= 3):
        # expert weights (.., E, D, F) / (.., E, F, D)
        e = shape[-3]
        if name == "router":
            return Spec(*(None,) * len(shape))
        if _divisible(e, tp):
            return spec("model", None, None)  # EP
        # TP inside the expert FFN
        if name in ("w_gate", "w_up"):
            return spec(None, None, "model")
        return spec(None, "model", None)
    if name == "router":
        return Spec(*(None,) * len(shape))
    if name in ("w_z", "w_x"):
        return spec(None, "model")
    if name == "out_proj":
        return spec("model", None)
    if name in ("w_B", "w_C", "w_dt"):
        return spec(None, "model")
    # norms, conv, scalars, biases: replicate
    return Spec(*(None,) * len(shape))


def param_specs(params_shapes, cfg, mesh):
    """A tree of ``Spec`` matching a tree of tensors (fake or real)."""
    return tree_map_with_path(
        lambda path, leaf: param_spec(path, tuple(leaf.shape), cfg, mesh), params_shapes)


def zero1_specs(opt_shapes, params_specs, mesh):
    """ZeRO-1: shard fp32 masters/moments over the data(+pod) axes on the
    first axis that is unsharded and divisible."""
    dp = dp_axes(mesh)
    dp_size = math.prod(mesh_axis_size(mesh, a) for a in dp) if dp else 1

    def rule(spec: Spec, leaf):
        if not hasattr(leaf, "shape") or len(leaf.shape) == 0:
            return Spec()
        spec_t = tuple(spec) + (None,) * (len(leaf.shape) - len(spec))
        out = list(spec_t)
        for i, (dim, ax) in enumerate(zip(leaf.shape, spec_t)):
            if ax is None and _divisible(dim, dp_size):
                out[i] = dp if len(dp) > 1 else dp[0]
                break
        return Spec(*out)

    def map_state(state_tree):
        return tree_map2(rule, params_specs, state_tree)

    return {
        "master": map_state(opt_shapes["master"]),
        "m": map_state(opt_shapes["m"]),
        "v": map_state(opt_shapes["v"]),
        "step": Spec(),
    }


# ---------------------------------------------------------------------------
# Activation constraints
# ---------------------------------------------------------------------------


def batch_spec(mesh, batch: int) -> Spec:
    """Shard the batch dim over (pod, data) when divisible, else replicate."""
    dp = dp_axes(mesh)
    size = math.prod(mesh_axis_size(mesh, a) for a in dp) if dp else 1
    if dp and _divisible(batch, size):
        return Spec(dp if len(dp) > 1 else dp[0])
    # try data alone (e.g. batch 32 on (2,16,16): 32 % 32 == 0 though)
    if "data" in axis_names(mesh) and _divisible(batch, mesh_axis_size(mesh, "data")):
        return Spec("data")
    return Spec(None)


def tokens_spec(mesh, batch: int, extra_dims: int = 1) -> Spec:
    b = batch_spec(mesh, batch)
    return Spec(*tuple(b), *(None,) * extra_dims)


def residual_spec(mesh, batch: int, seq: int) -> Spec:
    """(B, S, D) residual-stream constraint: batch over dp, sequence over
    `model` (sequence parallelism) when divisible."""
    b = batch_spec(mesh, batch)
    seq_ax = "model" if _divisible(seq, mesh_axis_size(mesh, "model")) else None
    return Spec(*tuple(b), seq_ax, None)


# ---------------------------------------------------------------------------
# DTensor placement
# ---------------------------------------------------------------------------


def to_placements(spec, mesh) -> Tuple:
    """DTensor placements of ``spec`` on ``mesh``: for each mesh axis,
    ``Shard(d)`` where dimension ``d`` names it (alone or in a tuple, whose
    order is the mesh's), else ``Replicate()``; on an axis of size 1 the two
    are the same, and ``Replicate()`` is taken (DTensor refuses some views
    of a dimension of size 1 that is "sharded")."""
    out = []
    for i, name in enumerate(axis_names(mesh)):
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims and mesh.size(i) > 1 else Replicate())
    return tuple(out)


def constrain(x, mesh, spec):
    """``with_sharding_constraint``: a DTensor redistributed to ``spec``;
    a plain tensor (no mesh) unchanged."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, to_placements(spec, mesh))


def place(t: torch.Tensor, mesh, spec) -> DTensor:
    """A tensor that every rank holds whole, as a DTensor of ``spec`` on
    ``mesh``: each rank keeps its own shard (nothing is sent)."""
    if isinstance(t, DTensor):
        return t.redistribute(mesh, to_placements(spec, mesh))
    return distribute_tensor(t, mesh, to_placements(spec, mesh), src_data_rank=None)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A mesh and a spec: where a leaf lives (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: Spec


def named(mesh, specs):
    """A tree of ``NamedSharding`` from a tree of specs."""
    return tree_map_with_path(lambda _, s: NamedSharding(mesh, s), specs)


def place_tree(tree, shardings):
    """Every leaf of ``tree`` placed by the matching ``NamedSharding``."""
    return tree_map2(lambda sh, t: place(t, sh.mesh, sh.spec), shardings, tree)


def pin(t):
    """``t`` unchanged, but the gradient flowing back into it is first
    redistributed to ``t``'s own placements: DTensor's backward of a view
    (merging attention heads) cannot take the shard a row-parallel product
    hands back when the heads do not divide the mesh."""
    if not isinstance(t, DTensor):
        return t
    return DTensor.from_local(t.to_local(grad_placements=t.placements), t.device_mesh,
                              t.placements, run_check=False, shape=t.shape,
                              stride=t.stride())


class _ContiguousGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, grad):
        # a copy: a DTensor's ``contiguous()`` reads its global strides,
        # which need not describe its local shard
        return grad.clone(memory_format=torch.contiguous_format)


def contiguous_grad(t):
    """``t`` unchanged, its gradient made contiguous on the way back: a
    DTensor's reshape runs the local ``view``, which a transposed gradient
    cannot take (the plain path's reshape copies instead)."""
    return _ContiguousGrad.apply(t) if isinstance(t, DTensor) else t


def local(t):
    """The tensor a rank holds: a DTensor's local shard, else ``t``."""
    return t.to_local() if isinstance(t, DTensor) else t


def local_call(fn, args, in_placements, out_placements, mesh, in_grad_placements=None):
    """``fn`` on each rank's shards of ``args`` (``local_map``): every
    DTensor argument is first redistributed to its entry of
    ``in_placements`` (None for an argument that is not a tensor); the
    outputs come back as DTensors of ``out_placements``.  For the ops
    DTensor has no rule for, placed as the reference's hints place them.
    ``in_grad_placements`` says how a gradient of each input is spread
    (default: as the input), e.g. ``Partial`` where every rank adds to a
    replicated input."""
    if all(isinstance(p, Placement) for p in out_placements):  # one output
        out_placements = list(out_placements)
    return local_map(fn, out_placements=out_placements, in_placements=in_placements,
                     in_grad_placements=in_grad_placements, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def shard_offset(mesh, placements, size: int, dim: int) -> int:
    """Where this rank's shard starts along ``dim`` (of global ``size``) for
    ``placements`` on ``mesh``: shards are even (the callers check)."""
    coord = mesh.get_coordinate()
    index, parts = 0, 1
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            index, parts = index * mesh.size(i) + coord[i], parts * mesh.size(i)
    return index * (size // parts)
