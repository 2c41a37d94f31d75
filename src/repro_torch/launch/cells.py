"""The assigned (architecture × input-shape) grid, 10 archs × 4 shapes: the
port of ``repro.launch.cells`` on DTensor.

``input_specs`` gives every model input's shape and dtype, the ``*_shapes``
functions the parameters', train state's and cache's as fake tensors (no
memory: ``FakeTensorMode`` around the CPU ``init``), and ``make_*_step``
build the function each cell runs:

* ``train_4k``                -> train_step (loss + grads + AdamW/ZeRO-1)
* ``prefill_32k``             -> forward (inference prefill)
* ``decode_32k`` / ``long_500k`` -> serve_step (one token against a KV/state
                                   cache of the cell's seq_len)

A step runs on DTensors placed by ``distributed.sharding``'s specs.  Plain
tensors a step makes itself (positions, masks) join them as replicated
(``implicit_replication``); the ops DTensor has no rule for (the attention
kernels, the MoE's dispatch, the SSD, the cache's decode) run through
``local_map`` on each rank's shards.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication

from ..distributed import sharding as shd
from ..models import encdec, lm
from ..models import layers as L
from ..models.config import ModelConfig
from ..optim import AdamWConfig, init_opt_state

Spec = shd.Spec


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    kind: str  # train | prefill | decode
    seq: int
    batch: int


SHAPES: Dict[str, Cell] = {
    "train_4k": Cell("train_4k", "train", 4096, 256),
    "prefill_32k": Cell("prefill_32k", "prefill", 32768, 32),
    "decode_32k": Cell("decode_32k", "decode", 32768, 128),
    "long_500k": Cell("long_500k", "decode", 524288, 1),
}


@dataclasses.dataclass(frozen=True)
class ShapeDtype:
    """An input's shape and dtype (``jax.ShapeDtypeStruct``)."""

    shape: Tuple[int, ...]
    dtype: torch.dtype


def supported(cfg: ModelConfig, cell: Cell) -> Tuple[bool, str]:
    """long_500k needs sub-quadratic attention (skip for full-attention
    archs per the assignment, recorded in DESIGN.md)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, "full quadratic attention at 524288 tokens (per spec: skip)"
    return True, ""


# ---------------------------------------------------------------------------
# shape-only state construction (fake tensors: no allocation)
# ---------------------------------------------------------------------------


def _module(cfg: ModelConfig):
    return encdec if cfg.is_encoder_decoder else lm


def params_shapes(cfg: ModelConfig, mode: Optional[FakeTensorMode] = None):
    """The parameters as fake tensors (shapes and dtypes, no storage)."""
    with mode or FakeTensorMode():
        return _module(cfg).init(cfg, 0, device="cpu")


def train_state_shapes(cfg: ModelConfig, mode: Optional[FakeTensorMode] = None):
    mode = mode or FakeTensorMode()
    p = params_shapes(cfg, mode)
    with mode:
        return {"params": p, "opt": init_opt_state(p)}


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int,
                 mode: Optional[FakeTensorMode] = None):
    """The decode cache (the reference's default, contiguous layout)."""
    with mode or FakeTensorMode():
        if cfg.is_encoder_decoder:
            return encdec.init_cache(cfg, batch, max_len, device="cpu")
        return lm.init_cache(cfg, batch, max_len, layout="contiguous", device="cpu")


def input_specs(cfg: ModelConfig, cell: Cell) -> Dict[str, ShapeDtype]:
    """Data inputs for the cell's step function."""
    b, s = cell.batch, cell.seq
    tok = ShapeDtype((b, s), torch.int32)
    out: Dict[str, Any] = {}
    if cell.kind in ("train", "prefill"):
        out["tokens"] = tok
        if cell.kind == "train":
            out["labels"] = tok
        if cfg.is_encoder_decoder:
            out["frames"] = ShapeDtype((b, cfg.frontend_seq, cfg.d_model),
                                       L.dtype_of(cfg))
        elif cfg.frontend != "none":
            out["prefix_embeds"] = ShapeDtype((b, cfg.frontend_seq, cfg.d_model),
                                              L.dtype_of(cfg))
    else:  # decode: one new token against a seq-long cache
        out["token"] = ShapeDtype((b,), torch.int32)
        out["pos"] = ShapeDtype((), torch.int32)
    return out


# ---------------------------------------------------------------------------
# sharding rules for the data/cache side
# ---------------------------------------------------------------------------


def data_specs(cfg: ModelConfig, cell: Cell, mesh):
    bspec = shd.batch_spec(mesh, cell.batch)
    out: Dict[str, Spec] = {}
    if cell.kind in ("train", "prefill"):
        out["tokens"] = Spec(*tuple(bspec), None)
        if cell.kind == "train":
            out["labels"] = Spec(*tuple(bspec), None)
        if cfg.is_encoder_decoder:
            out["frames"] = Spec(*tuple(bspec), None, None)
        elif cfg.frontend != "none":
            out["prefix_embeds"] = Spec(*tuple(bspec), None, None)
    else:
        out["token"] = bspec
        out["pos"] = Spec()
    return out


# the reference's cache paths name a leaf by its module: the port's
# contiguous ``Cache.kv`` keys map onto them
_CACHE_GROUP = {"k": "kv", "v": "kv", "c_kv": "mla", "k_pe": "mla",
                "ssm": "ssm", "conv": "ssm"}


def _cache_rule(names, shape, mesh, batch: int) -> Spec:
    tp = shd.mesh_axis_size(mesh, "model")
    bspec = shd.batch_spec(mesh, batch)
    b_ax = tuple(bspec)[0] if len(tuple(bspec)) else None
    nd = len(shape)
    base = [None] * nd

    def set_from_right(offset_from_right, axis_name):
        base[nd - offset_from_right] = axis_name

    if "kv" in names or "self" in names:  # attention K/V (.., B, H, S, hd)
        set_from_right(4, b_ax)
        if shape[nd - 3] % tp == 0:
            set_from_right(3, "model")  # head-sharded
        elif shape[nd - 2] % tp == 0:
            set_from_right(2, "model")  # split-KV over sequence
    elif "mla" in names:  # (.., B, S, 1, R)
        set_from_right(4, b_ax)
        if shape[nd - 1] % tp == 0:
            set_from_right(1, "model")
    elif names[-1] == "ssm" or "ssm" in names and shape and nd >= 4:
        # (.., B, H, N, P)
        if nd >= 4:
            set_from_right(4, b_ax)
            if shape[nd - 3] % tp == 0:
                set_from_right(3, "model")
    elif "conv" in names:  # (.., B, W, C)
        if nd >= 3:
            set_from_right(3, b_ax)
            if shape[nd - 1] % tp == 0:
                set_from_right(1, "model")
    # guard divisibility on the batch axis
    for i, ax in enumerate(base):
        if ax is not None and ax != "model" and shape[i] % shd.axes_size(mesh, ax):
            base[i] = None
    return Spec(*base)


def cache_specs(cfg: ModelConfig, cache, mesh, batch: int):
    """Per-leaf cache sharding: batch over dp; heads (or failing that, the
    sequence axis) over `model`; SSM heads over `model`; MLA latent rank
    over `model`.  ``cache`` is an ``lm.Cache`` (its ``kv`` tree: the
    result mirrors it) or the encoder-decoder's dict."""
    if isinstance(cache, lm.Cache):
        # the reference stacks a layer leaf over the layers after the prefix
        # only when their windows agree (lm.py:359); else each layer's is
        # its own, and the rule reads a per-layer shape
        n_prefix = lm.num_prefix_layers(cfg)
        stacks = (len(set(lm.static_windows(cfg)[n_prefix:])) <= 1
                  and cfg.num_layers - n_prefix > 1 and n_prefix == 0)

        def rule(path, leaf):
            key = path.split("/")[0]
            names, shape = [_CACHE_GROUP[key], key], tuple(leaf.shape)
            if "/" in path or stacks:  # a strip of one layer, or as stacked
                return _cache_rule(names, shape, mesh, batch)
            return Spec(None, *_cache_rule(names, shape[1:], mesh, batch))

        return shd.tree_map_with_path(rule, cache.kv)
    return shd.tree_map_with_path(
        lambda path, leaf: _cache_rule(path.split("/"), tuple(leaf.shape), mesh, batch),
        cache)


# ---------------------------------------------------------------------------
# interior sharding hints (see models.layers.shard_hints)
# ---------------------------------------------------------------------------


class Constraint:
    """A hint: ``spec_of(shape)`` gives the spec (or None: leave it), and
    calling it on a DTensor redistributes it there (``constrain``)."""

    def __init__(self, mesh, spec_of: Callable):
        self.mesh, self.spec_of = mesh, spec_of

    def __call__(self, x):
        spec = self.spec_of(tuple(x.shape))
        return x if spec is None else shd.constrain(x, self.mesh, spec)


def make_hints(cfg: ModelConfig, mesh, cell: Cell):
    """Activation constraints DTensor's propagation would not choose:

    * attention: shard heads over `model` when divisible; otherwise shard
      the q sequence axis (bounds the S^2 score tensor — flash-style
      partitioning) and keep K/V replicated on `model`.
    * MoE expert buffers: EP over `model` when E divides, else shard the
      capacity axis over the data axes (TP stays inside the expert FFN).

    * train and prefill: "attn_in" and the port's "block_in" gather the
      sequence of a block's input once, before its projections, and
      "block_out" SP-constrains attention/FFN outputs to the residual spec
      (the reference adds "attn_in" and "block_out" at its ``opt_level >=
      1`` only; DTensor needs them at every level, so the port has no
      ``opt_level``).
    """
    tp = shd.mesh_axis_size(mesh, "model")
    bspec = shd.batch_spec(mesh, cell.batch)
    b_ax = tuple(bspec)[0] if len(tuple(bspec)) else None

    def div(n, ax):
        return n % shd.axes_size(mesh, ax) == 0

    hooks = {}
    if cfg.attends:
        def attn_q(shape):  # (B, H, S, hd)
            b, h, s, _ = shape
            if div(h, "model") and h >= tp:
                return Spec(b_ax if div(b, b_ax) else None, "model", None, None)
            if div(s, "model"):
                return Spec(b_ax if div(b, b_ax) else None, None, "model", None)
            return None

        def attn_kv(shape):
            b, h, s, _ = shape
            if div(h, "model") and h >= tp:
                return Spec(b_ax if div(b, b_ax) else None, "model", None, None)
            # replicated K/V on model when q is sequence-sharded
            return Spec(b_ax if div(b, b_ax) else None, None, None, None)

        hooks["attn_q"] = Constraint(mesh, attn_q)
        hooks["attn_kv"] = Constraint(mesh, attn_kv)
    if cfg.moe and cfg.moe.num_experts:
        def moe_expert(shape):  # (G, E, cap, D): groups over data, EP over model
            gdim, e = shape[0], shape[1]
            dp = shd.dp_axes(mesh)
            dp_ax = dp if len(dp) > 1 else (dp[0] if dp else None)
            g_ax = dp_ax if (dp_ax is not None and div(gdim, dp_ax)) else None
            e_ax = "model" if (div(e, "model") and e >= tp) else None
            return Spec(g_ax, e_ax, None, None)

        hooks["moe_expert"] = Constraint(mesh, moe_expert)

    if cell.kind in ("train", "prefill"):
        def gathered(shape):  # (B, S, D) whole along the sequence
            if len(shape) != 3:
                return None
            b = shape[0]
            return Spec(b_ax if div(b, b_ax) else None, None, None)

        # DTensor cannot take a product with an operand whose batch and
        # sequence are both sharded (the residual's sequence parallelism),
        # in the forward or in the backward: so every block input
        # (attention: "attn_in"; the MLP, the MoE and the SSM: the port's
        # "block_in"), the unembedding's and, after the sequence fallback,
        # the attention's output ahead of its projection (the port's
        # "attn_out") gather the sequence first, and
        # every block output reduce-scatters into the residual's spec
        # ("block_out"), whose gradient comes back gathered; GSPMD chooses
        # this on its own
        hooks["attn_in"] = Constraint(mesh, gathered)
        hooks["block_in"] = Constraint(mesh, gathered)
        hooks["attn_out"] = Constraint(mesh, gathered)
        res = shd.residual_spec(mesh, cell.batch, cell.seq)

        def block_out(shape):  # (B, S, D) — match the residual (SP) spec
            if len(shape) != 3:
                return None
            b, s, _ = shape
            sp = tuple(res)
            if not div(b, sp[0]) or (sp[1] == "model" and s % tp):
                return None
            return res

        hooks["block_out"] = Constraint(mesh, block_out)
    return hooks


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def place_inputs(batch: Dict[str, Any], mesh, specs: Dict[str, Spec]):
    """A step's inputs (numpy, tensors every rank holds whole, or DTensors)
    as DTensors of their data specs."""
    out = {}
    for k, v in batch.items():
        t = v if isinstance(v, torch.Tensor) else torch.as_tensor(v)
        out[k] = shd.place(t, mesh, specs[k])
    return out


def _whole(metrics):
    """Metrics as plain tensors: a DTensor's whole value (a partial sum is
    reduced here)."""
    return {k: v.full_tensor() if isinstance(v, DTensor) else v
            for k, v in metrics.items()}


def _on_mesh(cfg: ModelConfig, mesh, cell: Cell):
    """What a step on ``mesh`` runs under: a context (implicit replication
    and the hints), the residual (SP) constraint, and the data specs."""
    res_spec = shd.residual_spec(mesh, cell.batch, cell.seq)
    hints = make_hints(cfg, mesh, cell)

    @contextlib.contextmanager
    def context():
        with implicit_replication(), L.shard_hints(**hints):
            yield

    return context, lambda x: shd.constrain(x, mesh, res_spec), data_specs(cfg, cell, mesh)


def make_grad_step(cfg: ModelConfig, mesh, cell: Cell,
                   logits_chunk: int = 256) -> Callable:
    """``grad_step(params, batch) -> (loss, parts, grads)`` on DTensors:
    ``launch.train.loss_and_grads`` under the hints, the loss and its parts
    whole, the gradients as DTensors in the parameters' leaf order."""
    from .train import loss_and_grads

    context, constrain, dspecs = _on_mesh(cfg, mesh, cell)

    def grad_step(params, batch):
        inputs = place_inputs(batch, mesh, dspecs)
        with context():
            loss, parts, grads = loss_and_grads(cfg, params, inputs, logits_chunk,
                                                residual_constraint=constrain)
        whole = _whole({"loss": loss.detach(), **{k: v.detach() for k, v in parts.items()}})
        return whole.pop("loss"), whole, grads

    return grad_step


def make_train_step(cfg: ModelConfig, mesh, cell: Cell,
                    adamw: Optional[AdamWConfig] = None,
                    logits_chunk: int = 256) -> Callable:
    """``train_step(state, batch) -> (state, metrics)`` on DTensors: the
    state placed by ``param_specs`` / ``zero1_specs``, the batch by
    ``data_specs`` (here, from whole inputs), ``launch.train``'s step (loss
    with per-layer recompute, gradients, AdamW in place) under the hints
    and the residual (SP) constraint between layers.  ``metrics`` come
    back whole.  (The reference's ``opt_level`` 1 also pins ZeRO-1's bf16
    cast before the parameters' gather; the port's AdamW writes each
    parameter in place in its own placement, so there is nothing to pin.)"""
    from .train import make_train_step as make_step

    context, constrain, dspecs = _on_mesh(cfg, mesh, cell)
    step = make_step(cfg, adamw or AdamWConfig(), logits_chunk=logits_chunk,
                     residual_constraint=constrain)

    def train_step(state, batch):
        inputs = place_inputs(batch, mesh, dspecs)
        with context():
            state, metrics = step(state, inputs)
        return state, _whole(metrics)

    return train_step


def make_prefill_step(cfg: ModelConfig, mesh, cell: Cell) -> Callable:
    context, constrain, dspecs = _on_mesh(cfg, mesh, cell)

    def prefill_step(params, batch):
        inputs = place_inputs(batch, mesh, dspecs)
        with torch.no_grad(), context():
            if cfg.is_encoder_decoder:
                enc = encdec.encode(params, cfg, inputs["frames"])
                # the last position's logits alone, as XLA keeps of the
                # reference's full logits when the step returns only them
                x = encdec.decode_hidden(params, cfg, inputs["tokens"], enc)
                x = L._hint("block_in", x[:, -1:])
                return L.unembed(params["embed"], x, cfg)[:, 0].float()
            x, _ = lm.hidden_forward(
                params, cfg, inputs["tokens"],
                prefix_embeds=inputs.get("prefix_embeds"),
                residual_constraint=constrain)
            # prefill emits only the last-position logits (next-token)
            x = L._hint("block_in", x)
            return lm._logits_of(params, cfg, x[:, -1:])[:, 0]

    return prefill_step


def make_serve_step(cfg: ModelConfig, mesh, cell: Cell) -> Callable:
    """One decode step against the cache (written in place)."""
    dspecs = data_specs(cfg, cell, mesh)

    def inputs(token, pos):
        placed = place_inputs({"token": token, "pos": pos}, mesh, dspecs)
        return placed["token"], placed["pos"]

    if cfg.is_encoder_decoder:
        def serve_step(params, cache, cross, token, pos):
            token, pos = inputs(token, pos)
            with torch.no_grad(), implicit_replication():
                return encdec.decode_step(params, cfg, cache, token, pos, cross)
        return serve_step

    def serve_step(params, cache, token, pos):
        token, pos = inputs(token, pos)
        with torch.no_grad(), implicit_replication():
            pos = pos.expand(token.shape[0])  # the port's decode takes (B,)
            return lm.decode_step(params, cfg, cache, token, pos)

    return serve_step
