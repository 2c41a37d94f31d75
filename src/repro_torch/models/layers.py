"""Model layers of the dense GQA decoder, the MLA + MoE decoder and the
Mamba-2 SSM (plain functions over parameter dicts), the port's counterpart
of the serving and training subset of ``repro.models.layers``: GQA and
multi-head latent attention over paged pools and over contiguous per-slot
strips, full-sequence GQA attention, the dense MLP, the capacity-dispatched
mixture of experts, and the Mamba-2 layer, full sequence (through the SSD
kernels) and one token at a time (the recurrence).

Parameters are plain dicts of tensors with the reference's tree layout.
Paged KV pools and contiguous strips are updated **in place**: where the
reference returned new pools (``.at[...].set`` on donated buffers), these
functions write into the pools they are given and return only the layer's
output.  The contiguous layers call the plain functions of ``kernels.ref``
directly, as the reference's call ``ref.*`` (no Pallas kernel serves the
strips): they never pass through ``kernels.ops``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed import sharding as shd
from ..kernels import ops, ref
from .config import ModelConfig

Params = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


# Leaves the reference keeps in fp32 whatever the model's dtype: the MoE
# router (layers.py:753) and the SSM's per-head a_log, d_skip and dt_bias
# (layers.py:865-867).  ``lm.init`` and ``convert.params_from_numpy`` both
# take a leaf's dtype from :func:`leaf_dtype`.
FP32_LEAVES = frozenset({"router", "a_log", "d_skip", "dt_bias"})


def leaf_dtype(name: str, cfg: ModelConfig) -> torch.dtype:
    """The dtype of the parameter leaf called ``name`` under ``cfg``."""
    return torch.float32 if name in FP32_LEAVES else dtype_of(cfg)


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------


def _dense_init(gen: torch.Generator, shape, dtype, scale=None):
    """N(0, 1) * scale drawn in fp32, then cast: the shapes and distribution
    of ``layers._dense_init`` (layers.py:61), with ``scale`` defaulting to
    1/sqrt(fan_in) = 1/sqrt(shape[-2]).  The numbers differ from JAX's for
    the same seed; tests that compare the two convert JAX's parameters."""
    scale = scale if scale is not None else 1.0 / math.sqrt(shape[-2])
    w = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Sharding hints (layers.py:25-55): the step functions install activation
# constraints that apply while their step runs on DTensors (``cells.
# make_hints``): attention heads or, failing that, the query sequence over
# `model`; the MoE's expert buffers; the residual stream around a block.
# With no hints installed a hint is the identity, and a plain tensor passes
# every hint unchanged.
# ---------------------------------------------------------------------------

_HINT_STACK: list = []


@contextlib.contextmanager
def shard_hints(**hooks):
    """hooks: name -> fn(x) -> x (``cells.Constraint``: a redistribute)."""
    _HINT_STACK.append(hooks)
    try:
        yield
    finally:
        _HINT_STACK.pop()


def _hint(name: str, x):
    for h in reversed(_HINT_STACK):
        if name in h and h[name] is not None:
            return h[name](x)
    return x


def hint_spec(name: str, shape):
    """The spec the innermost hook ``name`` gives a tensor of ``shape``, or
    None: where the port runs an op without a DTensor rule through
    ``local_map``, this is its placement (the reference's constraint)."""
    for h in reversed(_HINT_STACK):
        if name in h and h[name] is not None:
            return h[name].spec_of(tuple(shape))
    return None


# ---------------------------------------------------------------------------
# Norm / embeddings / rope
# ---------------------------------------------------------------------------


def rmsnorm(x, weight, eps=1e-6):
    return ops.rmsnorm(x, weight, eps)


def init_embedding(gen, cfg: ModelConfig) -> Params:
    dt = dtype_of(cfg)
    p = {"embedding": _dense_init(gen, (cfg.vocab_size, cfg.d_model), dt, 1.0)}
    if not cfg.tie_embeddings:
        p["unembed"] = _dense_init(gen, (cfg.d_model, cfg.vocab_size), dt)
    return p


def embed(params: Params, tokens):
    if isinstance(params["embedding"], DTensor):
        return _embed_sharded(params["embedding"], tokens)
    return params["embedding"][tokens.long()]


def _embed_sharded(table, tokens):
    """:func:`embed` on a DTensor table, each rank on its shards
    (``local_map``; torch 2.11's DTensor rule for the lookup's backward,
    an ``index_put``, fails): the tokens' batch over
    the data axes as they come, a vocabulary shard (``embedding``'s spec)
    read where it holds a token, the rows summed over the shards
    (``Partial``) where the vocabulary is split."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tp = tuple(p if p == Shard(0) else Replicate() for p in tokens.placements)
    wp = tuple(p if p == Shard(0) else Replicate() for p in table.placements)
    split = Shard(0) in wp
    outp = tuple(Partial() if w == Shard(0) else t for t, w in zip(tp, wp))
    wgrad = tuple(Partial() if t == Shard(0) else w for t, w in zip(tp, wp))
    v0 = shd.shard_offset(mesh, wp, table.shape[0], 0)

    def run(w, ids):
        if not split:
            return w[ids.long()]
        ids = ids.long() - v0
        mine = (ids >= 0) & (ids < w.shape[0])
        return w[torch.where(mine, ids, 0)] * mine[..., None].to(w.dtype)

    return shd.local_call(run, (table, tokens), (wp, tp), outp, mesh,
                          in_grad_placements=(wgrad, tp))


def unembed(params: Params, x, cfg: ModelConfig):
    """Logits in fp32 (the reference's einsum runs on fp32 casts)."""
    w = params.get("unembed")
    if w is None:
        w = params["embedding"].T
    return x.float() @ w.float()


def rope_freqs(head_dim: int, theta: float, fraction: float = 1.0,
               device=None):
    rot = int(head_dim * fraction) // 2 * 2
    inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                        device=device) / rot))
    return inv, rot


def apply_rope(x, positions, theta: float, fraction: float = 1.0):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S).  Rotates
    interleaved pairs (``0::2`` with ``1::2``), as layers.py:104."""
    d = x.shape[-1]
    inv, rot = rope_freqs(d, theta, fraction, x.device)
    ang = positions[..., :, None].float() * inv  # (..., S, rot/2)
    if x.ndim == ang.ndim + 1:  # head axis present
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr = x[..., :rot].float()
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    r1 = x1 * cos - x2 * sin
    r2 = x1 * sin + x2 * cos
    out = torch.stack([r1, r2], dim=-1).reshape(*x1.shape[:-1], rot)
    if rot < d:
        out = torch.cat([out, x[..., rot:].float()], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention over paged KV pools
# ---------------------------------------------------------------------------


def init_attention(gen, cfg: ModelConfig) -> Params:
    d, h, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = dtype_of(cfg)
    p = {
        "wq": _dense_init(gen, (d, h * hd), dt),
        "wk": _dense_init(gen, (d, hkv * hd), dt),
        "wv": _dense_init(gen, (d, hkv * hd), dt),
        "wo": _dense_init(gen, (h * hd, d), dt),
    }
    if cfg.qkv_bias:
        for name, n in (("bq", h * hd), ("bk", hkv * hd), ("bv", hkv * hd)):
            p[name] = torch.zeros((n,), dtype=dt, device=gen.device)
    return p


def _qkv(params, x, cfg: ModelConfig):
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    return (
        split_heads(q, b, s, h, hd),
        split_heads(k, b, s, hkv, hd),
        split_heads(v, b, s, hkv, hd),
    )


def merge_heads(t, b: int, s: int):
    """(B, H, S, D) -> (B, S, H * D), the inverse of :func:`split_heads`.
    A DTensor is copied contiguous first (its reshape runs the local
    ``view``), and its gradient comes back contiguous and in its own
    placements (``sharding.pin``)."""
    t = t.transpose(1, 2)
    if isinstance(t, DTensor):
        t = t.clone(memory_format=torch.contiguous_format)
        return shd.pin(shd.contiguous_grad(t).reshape(b, s, -1))
    return t.reshape(b, s, -1)


def split_heads(t, *shape):
    """``t.reshape(*shape)``, its last dim split into (heads, width).  A
    DTensor whose shard of that dim does not hold whole heads (q heads that
    do not divide `model`: ``make_hints``' sequence fallback follows) is
    gathered along it first, as GSPMD would; DTensor refuses the view.  Its
    gradient is made contiguous on the way back."""
    if not isinstance(t, DTensor):
        return t.reshape(*shape)
    dim = t.ndim - 1
    parts = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements)
                      if p == Shard(dim))
    if shape[-2] % parts:
        t = t.redistribute(t.device_mesh, [Replicate() if p == Shard(dim) else p
                                           for p in t.placements])
    # the heads' gradient comes back transposed (attention takes (B, H, S, D)
    # views), which the reshape's backward, a DTensor view, cannot take
    return shd.contiguous_grad(t.reshape(*shape))


def attention_full(params, x, cfg: ModelConfig, positions, window=None,
                   rope_fraction=1.0):
    """Full-sequence causal attention, training and prefill (layers.py:158):
    the rotated (B, S, H, D) projections go to ``ops.attention`` as (B, H,
    S, D) views, and the output comes back through the same transpose; q
    and the output pass the ``attn_q`` hint, K and V ``attn_kv``."""
    b, s, _ = x.shape
    q, k, v = _qkv(params, x, cfg)
    q = apply_rope(q, positions, cfg.rope_theta, rope_fraction)
    k = apply_rope(k, positions, cfg.rope_theta, rope_fraction)
    out = ops.attention(
        _hint("attn_q", q.transpose(1, 2)), _hint("attn_kv", k.transpose(1, 2)),
        _hint("attn_kv", v.transpose(1, 2)), causal=True,
        window=window, logit_soft_cap=cfg.logit_soft_cap,
    )
    out = merge_heads(_hint("attn_q", out), b, s)
    out = _hint("attn_out", out)
    return out.to(x.dtype) @ params["wo"]


def _require_fp_cache(cfg: ModelConfig, layout: str):
    """The contiguous strips store the model's dtype only (layers.py:178)."""
    if cfg.kv_dtype is not None:
        raise ValueError(
            f"kv_dtype={cfg.kv_dtype!r} requires a paged cache layout; "
            f"the {layout} cache stores {cfg.dtype} only")


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, device,
                  window=None):
    """One layer's contiguous strips ``k``/``v`` (batch, Hkv, size, D),
    ``size`` = min(max_len, window) for a windowed layer (a ring buffer),
    else ``max_len`` (layers.py:186); zero-filled."""
    _require_fp_cache(cfg, "contiguous")
    size = min(max_len, window) if window else max_len
    shape = (batch, cfg.num_kv_heads, size, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype_of(cfg), device=device),
            "v": torch.zeros(shape, dtype=dtype_of(cfg), device=device)}


def init_paged_kv_cache(cfg: ModelConfig, num_blocks: int, page_size: int,
                        device, layers: Optional[int] = None):
    """Page pools ``(kv_heads, num_blocks, page_size, head_dim)``, stacked
    over ``layers`` in front when given (layers.py:195).  Zero-filled like
    ``jnp.zeros``: the reserved page 0 is written by idle slots and dead
    chunk tails and must hold finite values.

    With ``cfg.kv_dtype`` set ("int8"/"int4") the pools hold packed int8
    bytes ``(..., head_dim // pack)`` plus per-token scales
    ``k_scale_pages``/``v_scale_pages`` ``(..., page_size, 1)`` in the
    model's dtype.  The scale leaves keep the page axis at ``ndim - 3``, so
    ``lm.copy_pages`` (COW) treats them like any other ``*_pages`` leaf."""
    lead = (layers,) if layers is not None else ()
    dt = dtype_of(cfg)
    if cfg.kv_dtype is not None:
        pack = ref.KV_PACK[cfg.kv_dtype]
        pshape = lead + (cfg.num_kv_heads, num_blocks, page_size,
                         cfg.head_dim // pack)
        sshape = lead + (cfg.num_kv_heads, num_blocks, page_size, 1)
        return {
            "k_pages": torch.zeros(pshape, dtype=torch.int8, device=device),
            "v_pages": torch.zeros(pshape, dtype=torch.int8, device=device),
            "k_scale_pages": torch.zeros(sshape, dtype=dt, device=device),
            "v_scale_pages": torch.zeros(sshape, dtype=dt, device=device),
        }
    shape = lead + (cfg.num_kv_heads, num_blocks, page_size, cfg.head_dim)
    return {
        "k_pages": torch.zeros(shape, dtype=dt, device=device),
        "v_pages": torch.zeros(shape, dtype=dt, device=device),
    }


def decode_append_index(pos, tables, page_size: int, num_pages: int
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Where each slot's decode KV append lands: ``(pages, offsets)``, one
    per slot.

    The reference looks the page up with ``take_along_axis`` (an
    out-of-range logical page gathers INT_MIN) and scatters with
    ``.at[].set`` (an out-of-range page is dropped).  Torch indexing raises
    (or device-asserts) instead, and dropping rows would need their count on
    the host, a device sync in every decode step.  So such a row is sent to
    the reserved sink page 0, which no live position reads: every other page
    ends as the reference leaves it.  Every other slot writes exactly as the
    reference, dead ones included: a dead slot's table row is page 0."""
    max_pages = tables.shape[1]
    pos = pos.long()
    logical = pos // page_size
    in_table = (logical >= 0) & (logical < max_pages)
    phys = torch.gather(tables.long(), 1,
                        logical.clamp(0, max_pages - 1)[:, None])[:, 0]
    ok = in_table & (phys >= 0) & (phys < num_pages)
    return torch.where(ok, phys, 0), pos % page_size


def attention_decode_paged(params, x, cfg: ModelConfig, cache, pos, tables,
                           window=None, rope_fraction=1.0, append=None):
    """One-token decode against a paged KV pool (layers.py:224).

    ``tables`` is the (B, max_pages) int32 block table (padded with page 0);
    ``pos`` (B,) the absolute position per slot.  The new K/V are scattered
    into the page holding ``pos`` **in place** in the pools of ``cache``
    (``append``: a precomputed :func:`decode_append_index`), then the query
    attends over the slot's pages with a ragged length mask.  With
    ``cfg.kv_dtype`` the appended row is quantized per (head, slot) and its
    packed bytes and scale land in the four pools (layers.py:244-262).
    Returns the attention output projection (B, 1, d)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg)  # (b, 1, ...)
    posv = pos[:, None]
    q = apply_rope(q, posv, cfg.rope_theta, rope_fraction)
    k = apply_rope(k, posv, cfg.rope_theta, rope_fraction)
    kp, vp = cache["k_pages"], cache["v_pages"]
    if append is None:
        append = decode_append_index(pos, tables, kp.shape[2], kp.shape[1])
    phys, off = append
    # (b, 1, hkv, hd) -> (hkv, b, hd) rows into their pages
    k_rows, v_rows = k[:, 0].transpose(0, 1), v[:, 0].transpose(0, 1)
    if cfg.kv_dtype is not None:
        ksp, vsp = cache["k_scale_pages"], cache["v_scale_pages"]
        kq, ks = ref.quantize_rows(k_rows, cfg.kv_dtype)
        vq, vs = ref.quantize_rows(v_rows, cfg.kv_dtype)
        for pool, new in ((kp, kq), (vp, vq), (ksp, ks), (vsp, vs)):
            pool[:, phys, off] = new.to(pool.dtype)
        out = ops.paged_attention_quant(
            q[:, 0], kp, vp, ksp, vsp, tables, (pos + 1).to(torch.int32),
            fmt=cfg.kv_dtype, window=window,
            logit_soft_cap=cfg.logit_soft_cap,
        )
    else:
        kp[:, phys, off] = k_rows.to(kp.dtype)
        vp[:, phys, off] = v_rows.to(vp.dtype)
        out = ops.paged_attention(
            q[:, 0], kp, vp, tables, (pos + 1).to(torch.int32), window=window,
            logit_soft_cap=cfg.logit_soft_cap,
        )
    out = out.reshape(b, 1, h * hd)
    return out.to(x.dtype) @ params["wo"]


def attention_prefill_paged(params, x, cfg: ModelConfig, cache, pos, tables,
                            lens, window=None, rope_fraction=1.0, plain=False):
    """Chunk-wide prefill against a paged KV pool (layers.py:280).

    ``x`` is a (B, C, d) block of prompt tokens per slot; ``pos`` (B,) each
    slot's chunk start, ``lens`` (B,) the live tokens within the chunk
    (0 = slot not prefilling).  The chunk's K/V land in the pool pages in
    place (inside the CUDA kernel, or by the plain path's masked scatter)
    and every chunk query attends prior pages plus the chunk causally.  With
    ``cfg.kv_dtype`` the chunk is quantized and attended as its dequantized
    round trip, and its packed bytes and scales land in the four pools.
    ``plain`` sends the attention to the plain version (the speculative
    verify's chunks, ``lm.verify_step``)."""
    b, c, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg)  # (b, c, ...)
    posmat = pos[:, None] + torch.arange(c, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posmat, cfg.rope_theta, rope_fraction)
    k = apply_rope(k, posmat, cfg.rope_theta, rope_fraction)
    qkv = (q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    starts, lens = pos.to(torch.int32), lens.to(torch.int32)
    if cfg.kv_dtype is not None:  # layers.py:299-310
        out = ops.prefill_attention_quant(
            *qkv, cache["k_pages"], cache["v_pages"], cache["k_scale_pages"],
            cache["v_scale_pages"], tables, starts, lens, fmt=cfg.kv_dtype,
            window=window, logit_soft_cap=cfg.logit_soft_cap, plain=plain,
        )[0]
    else:
        out = ops.prefill_attention(
            *qkv, cache["k_pages"], cache["v_pages"], tables, starts, lens,
            window=window, logit_soft_cap=cfg.logit_soft_cap, plain=plain,
        )[0]
    out = out.transpose(1, 2).reshape(b, c, h * hd)
    return out.to(x.dtype) @ params["wo"]


def attention_prefill(params, x, cfg: ModelConfig, cache, pos, lens,
                      window=None, rope_fraction=1.0):
    """Chunk-wide prefill against one layer's contiguous strips (ring
    buffers for windowed layers), layers.py:322: the same contract as
    :func:`attention_prefill_paged`, the prior context read from the strip
    **before** the chunk overwrites any ring entry (queries early in the
    chunk still see context its tail evicts), through ``ref.prefill_attention``.
    The chunk is then written in place as a gather-select over the strip's
    entries: entry r takes the latest live chunk token mapping to it, so a
    chunk longer than a ring keeps its last ``size`` tokens, and a chunk may
    start at any position."""
    b, c, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg)
    lens = lens.to(torch.int32)
    ar = torch.arange(c, dtype=torch.int32, device=x.device)
    posmat = pos[:, None] + ar
    q = apply_rope(q, posmat, cfg.rope_theta, rope_fraction)
    k = apply_rope(k, posmat, cfg.rope_theta, rope_fraction)
    ks, vs = cache["k"], cache["v"]
    size = ks.shape[2]
    r = torch.arange(size, dtype=torch.int32, device=x.device)[None, :]  # (1, S)
    if window:
        # ring entry r holds the latest position p < pos with p % size == r
        sm1 = pos[:, None] - 1
        p = sm1 - torch.remainder(sm1 - r, size)
        ctx_pos = torch.where((pos[:, None] > 0) & (p >= 0), p, -1)
    else:
        ctx_pos = torch.where(r < pos[:, None], r, -1)
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)  # (B, Hkv, C, D)
    out = ref.prefill_attention(
        q.transpose(1, 2), kt, vt, ks, vs, ctx_pos, posmat, lens,
        window=window, logit_soft_cap=cfg.logit_soft_cap)
    out = out.transpose(1, 2).reshape(b, c, h * hd)
    rel = r - pos[:, None]  # (B, S)
    if window:
        base = torch.remainder(rel, size)  # ring: chunk index == base mod size
        cidx = base + torch.div(lens[:, None] - 1 - base, size,
                                rounding_mode="floor") * size
    else:
        cidx = rel
    sel = ((cidx >= 0) & (cidx < lens[:, None]))[:, None, :, None]
    cg = cidx.clamp(0, c - 1).long()[:, None, :, None].expand(-1, ks.shape[1], -1, hd)
    ks.copy_(torch.where(sel, kt.to(ks.dtype).gather(2, cg), ks))
    vs.copy_(torch.where(sel, vt.to(vs.dtype).gather(2, cg), vs))
    return out.to(x.dtype) @ params["wo"]


def attention_decode(params, x, cfg: ModelConfig, cache, pos, window=None,
                     rope_fraction=1.0):
    """One-token decode against one layer's contiguous strips
    (layers.py:375): slot b's K/V land at ``pos % size`` of a ring (a
    windowed layer), else at ``min(pos, size - 1)``, in place, then its
    query attends its first ``min(pos + 1, size)`` entries through
    ``ref.attention`` (a ring holds exactly the window)."""
    b = x.shape[0]
    h, hd = cfg.num_heads, cfg.head_dim
    q, k, v = _qkv(params, x, cfg)  # (b, 1, ...)
    posv = pos[:, None]
    q = apply_rope(q, posv, cfg.rope_theta, rope_fraction)
    k = apply_rope(k, posv, cfg.rope_theta, rope_fraction)
    ks, vs = cache["k"], cache["v"]
    size = ks.shape[2]
    if isinstance(ks, DTensor):
        out = _decode_sharded(q.transpose(1, 2), k[:, 0], v[:, 0], ks, vs, pos,
                              window, cfg.logit_soft_cap)
        return merge_heads(out, b, 1).to(x.dtype) @ params["wo"]
    slot = (torch.remainder(pos, size) if window
            else pos.clamp(max=size - 1)).long()
    rows = torch.arange(b, device=x.device)
    ks[rows, :, slot] = k[:, 0].to(ks.dtype)
    vs[rows, :, slot] = v[:, 0].to(vs.dtype)
    out = ref.attention(q.transpose(1, 2), ks, vs, causal=False,
                        kv_len=(pos + 1).clamp(max=size),
                        logit_soft_cap=cfg.logit_soft_cap)
    out = out.transpose(1, 2).reshape(b, 1, h * hd)
    return out.to(x.dtype) @ params["wo"]


def _decode_sharded(q, k_new, v_new, ks, vs, pos, window, soft_cap):
    """:func:`attention_decode`'s write and attention on strips that are
    DTensors, each rank on its shards (``local_map``; DTensor has no rule
    for the write), placed as ``cells.cache_specs`` places them: batch over
    the data axes, kv heads over `model`, or failing that the strip's
    positions (split-KV).  A rank writes the new row only where it holds
    its slot, and scores its own keys into a partial softmax state (the
    sum of values weighted by ``exp(s - m)``, their weight ``l`` and the
    running max ``m``); the states of the split-KV ranks are gathered and
    merged.  ``q`` (B, H, 1, D), ``k_new``/``v_new`` (B, Hkv, D)."""
    mesh = ks.device_mesh
    sp = ks.placements
    b, hq, _, d = q.shape
    hkv, size = ks.shape[1], ks.shape[2]
    scale = 1.0 / math.sqrt(d)
    qp = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in sp)
    posp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in sp)
    # a partial state (1, B, H, 1, .): one a split-KV rank, stacked in front
    statep = tuple(Shard(0) if p == Shard(2) else
                   (Shard(p.dim + 1) if p in (Shard(0), Shard(1)) else Replicate())
                   for p in sp)
    o_seq = shd.shard_offset(mesh, sp, size, 2)

    def run(ql, kn, vn, ksl, vsl, posl):
        n = ksl.shape[2]
        slot = (torch.remainder(posl, size) if window
                else posl.clamp(max=size - 1)).long() - o_seq
        mine = ((slot >= 0) & (slot < n))[:, None, None]
        rows = torch.arange(ksl.shape[0], device=ksl.device)
        at = slot.clamp(0, n - 1)
        ksl[rows, :, at] = torch.where(mine, kn.to(ksl.dtype), ksl[rows, :, at])
        vsl[rows, :, at] = torch.where(mine, vn.to(vsl.dtype), vsl[rows, :, at])
        group = ql.shape[1] // ksl.shape[1]
        kf = ksl.float().repeat_interleave(group, dim=1)
        vf = vsl.float().repeat_interleave(group, dim=1)
        sc = torch.einsum("bhqd,bhkd->bhqk", ql.float(), kf) * scale
        if soft_cap is not None:
            sc = soft_cap * torch.tanh(sc / soft_cap)
        live = (posl + 1).clamp(max=size)
        keys = o_seq + torch.arange(n, device=ksl.device)
        sc = sc.masked_fill(~(keys[None, :] < live[:, None])[:, None, None, :],
                            float("-inf"))
        m = sc.amax(dim=-1)
        e = torch.exp(sc - torch.where(torch.isinf(m), 0.0, m)[..., None])
        acc = torch.einsum("bhqk,bhkd->bhqd", e, vf)
        return acc[None], e.sum(dim=-1)[None], m[None]

    acc, l, m = shd.local_call(run, (q, k_new, v_new, ks, vs, pos),
                               (qp, qp, qp, sp, sp, posp), (statep, statep, statep),
                               mesh)
    whole = tuple(Replicate() if p == Shard(0) else p for p in statep)
    acc, l, m = (t.redistribute(mesh, whole) for t in (acc, l, m))
    w = torch.exp(m - m.amax(dim=0, keepdim=True))
    out = (acc * w[..., None]).sum(dim=0) / (l * w).sum(dim=0)[..., None]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# MLA attention (DeepSeek-V2) over latent page pools and strips
# ---------------------------------------------------------------------------


def init_mla(gen, cfg: ModelConfig) -> Params:
    """layers.py:411: the latent down-projection ``w_dkv``, the rope key
    ``w_kpe``, the up-projections ``w_uk``/``w_uv`` (absorbed into the query
    and the output at serving time), ``w_o``, a full-rank ``w_q`` and the
    latent's norm."""
    m = cfg.mla
    d, h = cfg.d_model, cfg.num_heads
    dt = dtype_of(cfg)
    qd = h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
    return {
        "w_dkv": _dense_init(gen, (d, m.kv_lora_rank), dt),
        "w_kpe": _dense_init(gen, (d, m.qk_rope_head_dim), dt),
        "w_uk": _dense_init(gen, (m.kv_lora_rank, h * m.qk_nope_head_dim), dt),
        "w_uv": _dense_init(gen, (m.kv_lora_rank, h * m.v_head_dim), dt),
        "w_o": _dense_init(gen, (h * m.v_head_dim, d), dt),
        "w_q": _dense_init(gen, (d, qd), dt),
        "kv_norm": torch.ones((m.kv_lora_rank,), dtype=dt, device=gen.device),
    }


def mla_full(params, x, cfg: ModelConfig, positions):
    """Full-sequence MLA, training and prefill (layers.py:428): the latent
    expanded into per-head keys (``w_uk``'s nope columns beside the shared
    rotated rope key) and values (``w_uv``), causal attention of the
    rotated queries through ``ops.attention`` on (B, H, S, D) views of the
    (B, S, H, D) projections (on a card the flash kernel, at key width nope
    + rope and value width ``v_head_dim``), then ``w_o``."""
    m = cfg.mla
    b, s, _ = x.shape
    h, dn, dr = cfg.num_heads, m.qk_nope_head_dim, m.qk_rope_head_dim
    q = split_heads(x @ params["w_q"], b, s, h, dn + dr)
    q_pe = apply_rope(q[..., dn:], positions, cfg.rope_theta)
    c_kv = rmsnorm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(x @ params["w_kpe"], positions, cfg.rope_theta)
    k_nope = split_heads(c_kv @ params["w_uk"], b, s, h, dn)
    v = split_heads(c_kv @ params["w_uv"], b, s, h, m.v_head_dim)
    q = torch.cat([q[..., :dn], q_pe], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None, :].expand(b, s, h, dr)], dim=-1)
    out = ops.attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                        causal=True, sm_scale=_mla_scale(cfg))
    out = merge_heads(out, b, s)
    return _hint("attn_out", out).to(x.dtype) @ params["w_o"]


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    """One layer's contiguous latent strips (layers.py:459): ``c_kv``
    (batch, max_len, 1, rank) and ``k_pe`` (batch, max_len, 1, rope_dim),
    zero-filled; a window only masks scores (no ring)."""
    _require_fp_cache(cfg, "contiguous latent")
    m = cfg.mla
    dt = dtype_of(cfg)
    return {
        "c_kv": torch.zeros((batch, max_len, 1, m.kv_lora_rank), dtype=dt,
                            device=device),
        "k_pe": torch.zeros((batch, max_len, 1, m.qk_rope_head_dim), dtype=dt,
                            device=device),
    }


def init_mla_paged_cache(cfg: ModelConfig, num_blocks: int, page_size: int,
                         device, layers: Optional[int] = None):
    """Latent page pools (layers.py:468): the latent is shared by every
    query head, so pages carry no head axis: ``ckv_pages`` (num_blocks,
    page_size, rank) and ``kpe_pages`` (num_blocks, page_size, rope_dim),
    stacked over ``layers`` in front when given, zero-filled.  With
    ``cfg.kv_dtype`` both hold packed int8 bytes (last axis divided by the
    pack factor) plus ``ckv_scale_pages``/``kpe_scale_pages`` (..., page_size,
    1) in the model's dtype; every leaf keeps its page axis at ``ndim - 3``."""
    m = cfg.mla
    lead = (layers,) if layers is not None else ()
    dt = dtype_of(cfg)
    if cfg.kv_dtype is not None:
        pack = ref.KV_PACK[cfg.kv_dtype]
        page = lead + (num_blocks, page_size)
        return {
            "ckv_pages": torch.zeros(page + (m.kv_lora_rank // pack,),
                                     dtype=torch.int8, device=device),
            "kpe_pages": torch.zeros(page + (m.qk_rope_head_dim // pack,),
                                     dtype=torch.int8, device=device),
            "ckv_scale_pages": torch.zeros(page + (1,), dtype=dt, device=device),
            "kpe_scale_pages": torch.zeros(page + (1,), dtype=dt, device=device),
        }
    page = lead + (num_blocks, page_size)
    return {
        "ckv_pages": torch.zeros(page + (m.kv_lora_rank,), dtype=dt, device=device),
        "kpe_pages": torch.zeros(page + (m.qk_rope_head_dim,), dtype=dt,
                                 device=device),
    }


def _mla_scale(cfg: ModelConfig) -> float:
    m = cfg.mla
    return 1.0 / math.sqrt(m.qk_nope_head_dim + m.qk_rope_head_dim)


def _mla_absorbed_q(params, q_nope, cfg: ModelConfig):
    """Absorb W_uk into the queries (layers.py:494): latent-space scoring,
    in fp32."""
    m = cfg.mla
    w_uk = params["w_uk"].reshape(m.kv_lora_rank, cfg.num_heads,
                                  m.qk_nope_head_dim)
    return torch.einsum("...hn,rhn->...hr", q_nope.float(), w_uk.float())


def _mla_out_proj(params, out_lat, x_dtype, cfg: ModelConfig):
    """Expand latent outputs through W_uv in fp32, cast to the activations'
    dtype, then project with W_o (layers.py:503)."""
    m = cfg.mla
    w_uv = params["w_uv"].reshape(m.kv_lora_rank, cfg.num_heads, m.v_head_dim)
    out = torch.einsum("...hr,rhv->...hv", out_lat.float(), w_uv.float())
    out = out.reshape(*out.shape[:-2], cfg.num_heads * m.v_head_dim)
    return out.to(x_dtype) @ params["w_o"]


def _mla_decode_qkv(params, x, cfg: ModelConfig, posv):
    """Single-token MLA projections (layers.py:539): ``q_nope`` (B, H,
    nope), rotated ``q_pe`` (B, H, rope), the token's latent ``c_kv`` (B, R)
    and rotated rope key ``k_pe`` (B, 1, rope)."""
    m = cfg.mla
    b = x.shape[0]
    h = cfg.num_heads
    q = (x @ params["w_q"]).reshape(b, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe.reshape(b, 1, h, m.qk_rope_head_dim), posv,
                      cfg.rope_theta).reshape(b, h, m.qk_rope_head_dim)
    c_kv = rmsnorm(x[:, 0] @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope((x[:, 0] @ params["w_kpe"]).reshape(b, 1, -1), posv,
                      cfg.rope_theta)
    return q_nope, q_pe, c_kv, k_pe


def mla_decode(params, x, cfg: ModelConfig, cache, pos, window=None):
    """One-token MLA decode against one layer's contiguous latent strips
    (layers.py:514): the token's latent and rope entries land at ``pos``
    (clamped to the strip, as JAX's ``dynamic_update_slice`` clamps), in
    place, then the absorbed queries attend the strip under a length mask
    through ``ref.mla_masked``.  Returns the output projection (B, 1, d)."""
    q_nope, q_pe, c_kv, k_pe = _mla_decode_qkv(params, x, cfg, pos[:, None])
    ckv, kpe = cache["c_kv"], cache["k_pe"]
    at = pos.clamp(max=ckv.shape[1] - 1).long()
    _write_latent(ckv, at, c_kv)
    _write_latent(kpe, at, k_pe[:, 0])
    dt = dtype_of(cfg)
    out = ref.mla_masked(
        _mla_absorbed_q(params, q_nope, cfg).to(dt), q_pe.to(dt), ckv[:, :, 0],
        kpe[:, :, 0], pos + 1, _mla_scale(cfg), window=window,
        logit_soft_cap=cfg.logit_soft_cap)
    return _mla_out_proj(params, out, x.dtype, cfg)[:, None]


def _write_latent(strip, at, new):
    """``strip[b, at[b], 0] = new[b]`` in place, ``strip`` (B, S, 1, W).  A
    DTensor strip (``cells.cache_specs``: batch over the data axes, the
    latent width over `model`, the positions whole) is written on each
    rank's shards (``local_map``): DTensor has no rule for an in-place write
    that would change its placement."""
    if not isinstance(strip, DTensor):
        strip[torch.arange(strip.shape[0], device=strip.device), at, 0] = new.to(strip.dtype)
        return
    sp = strip.placements
    if Shard(1) in sp or Shard(2) in sp:
        raise ValueError(f"a latent strip sharded along its positions: {sp}")
    newp = tuple(Shard(0) if p == Shard(0) else Shard(1) if p == Shard(3) else Replicate()
                 for p in sp)
    atp = tuple(Shard(0) if p == Shard(0) else Replicate() for p in sp)

    def run(sl, al, nl):
        sl[torch.arange(sl.shape[0], device=sl.device), al, 0] = nl.to(sl.dtype)
        return nl

    shd.local_call(run, (strip, at, new), (sp, atp, newp), newp, strip.device_mesh)


def mla_decode_paged(params, x, cfg: ModelConfig, cache, pos, tables,
                     window=None, append=None):
    """One-token MLA decode against the latent page pools (layers.py:563).

    The token's latent and rope entries are scattered **in place** into the
    page holding ``pos`` (``append``: a precomputed
    :func:`decode_append_index`; a write JAX drops lands in the sink page 0),
    then the absorbed queries attend the slot's pages under a ragged length
    mask.  With ``cfg.kv_dtype`` both entries are quantized per token and
    their packed bytes and scales land in the four pools.  Returns the
    output projection (B, 1, d)."""
    q_nope, q_pe, c_kv, k_pe = _mla_decode_qkv(params, x, cfg, pos[:, None])
    ckv, kpe = cache["ckv_pages"], cache["kpe_pages"]
    if append is None:
        append = decode_append_index(pos, tables, ckv.shape[1], ckv.shape[0])
    phys, off = append
    dt = dtype_of(cfg)
    q_lat = _mla_absorbed_q(params, q_nope, cfg).to(dt)
    lens = (pos + 1).to(torch.int32)
    kw = dict(sm_scale=_mla_scale(cfg), window=window,
              logit_soft_cap=cfg.logit_soft_cap)
    if cfg.kv_dtype is not None:
        cs_pool, ps_pool = cache["ckv_scale_pages"], cache["kpe_scale_pages"]
        cq, cs = ref.quantize_rows(c_kv, cfg.kv_dtype)
        pq, ps = ref.quantize_rows(k_pe[:, 0], cfg.kv_dtype)
        for pool, new in ((ckv, cq), (kpe, pq), (cs_pool, cs), (ps_pool, ps)):
            pool[phys, off] = new.to(pool.dtype)
        out = ops.mla_paged_quant(q_lat, q_pe.to(dt), ckv, kpe, cs_pool,
                                  ps_pool, tables, lens, fmt=cfg.kv_dtype, **kw)
    else:
        ckv[phys, off] = c_kv.to(ckv.dtype)
        kpe[phys, off] = k_pe[:, 0].to(kpe.dtype)
        out = ops.mla_paged(q_lat, q_pe.to(dt), ckv, kpe, tables, lens, **kw)
    return _mla_out_proj(params, out, x.dtype, cfg)[:, None]


def _mla_prefill_qkv(params, x, cfg: ModelConfig, posmat):
    """Chunk-wide MLA projections (layers.py:612): absorbed ``q_lat`` (B, H,
    C, R) in fp32, rotated ``q_pe`` (B, H, C, rope), the chunk's latents
    ``c_kv`` (B, C, R) and rope keys ``k_pe`` (B, C, rope)."""
    m = cfg.mla
    b, c, _ = x.shape
    h = cfg.num_heads
    q = (x @ params["w_q"]).reshape(b, c, h,
                                    m.qk_nope_head_dim + m.qk_rope_head_dim)
    q_nope, q_pe = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_pe = apply_rope(q_pe, posmat, cfg.rope_theta)
    c_kv = rmsnorm(x @ params["w_dkv"], params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(x @ params["w_kpe"], posmat, cfg.rope_theta)
    q_lat = _mla_absorbed_q(params, q_nope, cfg)
    return q_lat.transpose(1, 2), q_pe.transpose(1, 2), c_kv, k_pe


def mla_prefill_paged(params, x, cfg: ModelConfig, cache, pos, tables, lens,
                      window=None, plain=False):
    """Chunk-wide MLA prefill against the latent page pools (layers.py:635):
    the chunk's latents land in the pages holding ``[pos, pos + lens)`` in
    place (inside the CUDA kernel, or by the plain path's masked scatter) and
    every chunk query attends prior pages plus the chunk causally, in latent
    space.  With ``cfg.kv_dtype`` the chunk is quantized and attended as its
    dequantized round trip; ``plain`` sends the attention to the plain
    version.  Returns the output projection (B, C, d)."""
    c = x.shape[1]
    posmat = pos[:, None] + torch.arange(c, dtype=torch.int32, device=x.device)
    q_lat, q_pe, c_kv, k_pe = _mla_prefill_qkv(params, x, cfg, posmat)
    dt = dtype_of(cfg)
    args = (q_lat.to(dt), q_pe.to(dt), c_kv, k_pe, cache["ckv_pages"],
            cache["kpe_pages"])
    starts, lens = pos.to(torch.int32), lens.to(torch.int32)
    kw = dict(sm_scale=_mla_scale(cfg), window=window,
              logit_soft_cap=cfg.logit_soft_cap, plain=plain)
    if cfg.kv_dtype is not None:
        out = ops.mla_prefill_quant(
            *args, cache["ckv_scale_pages"], cache["kpe_scale_pages"], tables,
            starts, lens, fmt=cfg.kv_dtype, **kw)[0]
    else:
        out = ops.mla_prefill(*args, tables, starts, lens, **kw)[0]
    return _mla_out_proj(params, out.transpose(1, 2), x.dtype, cfg)


def mla_prefill(params, x, cfg: ModelConfig, cache, pos, lens, window=None):
    """Chunk-wide MLA prefill against one layer's contiguous latent strips
    (layers.py:673), the latent twin of :func:`attention_prefill`: prior
    context from the strip through ``ref.mla_prefill``, then the chunk
    written in place as a gather-select (the strip stays full length; a
    window only masks scores).  Returns the output projection (B, C, d)."""
    c = x.shape[1]
    lens = lens.to(torch.int32)
    posmat = pos[:, None] + torch.arange(c, dtype=torch.int32, device=x.device)
    q_lat, q_pe, c_kv, k_pe = _mla_prefill_qkv(params, x, cfg, posmat)
    ckv, kpe = cache["c_kv"], cache["k_pe"]
    r = torch.arange(ckv.shape[1], dtype=torch.int32, device=x.device)[None, :]
    dt = dtype_of(cfg)
    out = ref.mla_prefill(
        q_lat.to(dt), q_pe.to(dt), c_kv, k_pe, ckv[:, :, 0], kpe[:, :, 0],
        torch.where(r < pos[:, None], r, -1), posmat, lens,
        sm_scale=_mla_scale(cfg), window=window,
        logit_soft_cap=cfg.logit_soft_cap)
    rel = r - pos[:, None]  # (B, S)
    sel = ((rel >= 0) & (rel < lens[:, None]))[:, :, None, None]
    cg = rel.clamp(0, c - 1).long()[:, :, None]
    for strip, new in ((ckv, c_kv), (kpe, k_pe)):
        idx = cg.expand(-1, -1, new.shape[-1])
        strip.copy_(torch.where(sel, new.to(strip.dtype).gather(1, idx)[:, :, None],
                                strip))
    return _mla_out_proj(params, out.transpose(1, 2), x.dtype, cfg)


# ---------------------------------------------------------------------------
# MLP (dense)
# ---------------------------------------------------------------------------


def init_mlp(gen, cfg: ModelConfig, d_ff=None) -> Params:
    d_ff = d_ff or cfg.d_ff
    dt = dtype_of(cfg)
    d = cfg.d_model
    if cfg.act in ("silu", "geglu"):
        return {
            "w_gate": _dense_init(gen, (d, d_ff), dt),
            "w_up": _dense_init(gen, (d, d_ff), dt),
            "w_down": _dense_init(gen, (d_ff, d), dt),
        }
    return {
        "w_up": _dense_init(gen, (d, d_ff), dt),
        "w_down": _dense_init(gen, (d_ff, d), dt),
    }


def mlp(params: Params, x, cfg: ModelConfig):
    """SiLU- or GELU-gated MLP (layers.py:732); GELU is the tanh
    approximation, jax.nn.gelu's default."""
    if "w_gate" in params:
        g = x @ params["w_gate"]
        u = x @ params["w_up"]
        act = F.gelu(g, approximate="tanh") if cfg.act == "geglu" else F.silu(g)
        h = act * u
    else:
        h = F.gelu(x @ params["w_up"], approximate="tanh")
    return h @ params["w_down"]


# ---------------------------------------------------------------------------
# MoE: GShard-style capacity dispatch
# ---------------------------------------------------------------------------


def init_moe(gen, cfg: ModelConfig) -> Params:
    """layers.py:748: an fp32 router (whatever the model's dtype), expert
    SiLU-gated MLPs stacked over experts, and the shared experts' MLP."""
    mo = cfg.moe
    d, fe, e = cfg.d_model, mo.d_ff_expert, mo.num_experts
    dt = dtype_of(cfg)
    p = {
        "router": _dense_init(gen, (d, e), leaf_dtype("router", cfg)),
        "w_gate": _dense_init(gen, (e, d, fe), dt),
        "w_up": _dense_init(gen, (e, d, fe), dt),
        "w_down": _dense_init(gen, (e, fe, d), dt),
    }
    if mo.num_shared_experts:
        p["shared"] = init_mlp(gen, cfg, d_ff=mo.num_shared_experts * fe)
    return p


def _moe_groups(t: int, batch: int) -> int:
    """Dispatch-group count (layers.py:764): the largest of 16, 8, 4, 2 that
    divides the token count, else 1."""
    for g in (16, 8, 4, 2):
        if t % g == 0 and t // g >= 1:
            return g
    return 1


def top_k(x, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values, largest
    first, ties broken toward the lower index (a stable descending sort)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe(params: Params, x, cfg: ModelConfig):
    """Capacity-based top-k routing with grouped dispatch (layers.py:773).
    Returns ``(output, aux_loss)``.  Its forward runs inside a named range
    ("moe"), so that a profile can sum the dispatch's device time.

    The tokens split into G groups (:func:`_moe_groups`); each group routes
    through the fp32 router, keeps its top k experts per token (gates
    renormalised), and places each (token, choice) at its position in the
    expert's queue, counted over (token, choice) in token-major order.  A
    choice at or past the capacity ``int(capacity_factor * tokens_per_group
    * k / E)`` (at least 1) is dropped: it still lands in the expert's last
    slot, as a zero row, and its gate is zeroed.  The expert products run
    over every expert's (group, capacity) buffer, and the shared experts'
    MLP is added on all tokens.  All shapes are static and nothing waits for
    the host: the dispatch is a ``scatter_add_`` (each slot takes one
    nonzero row, so the sum is exact) and the combine a ``gather``."""
    with torch.profiler.record_function("moe"):
        return _moe(params, x, cfg)


def _moe(params: Params, x, cfg: ModelConfig):
    mo = cfg.moe
    b, s, d = x.shape
    t = b * s
    e, k = mo.num_experts, mo.experts_per_token
    g = _moe_groups(t, b)
    tg = t // g
    cap = max(1, int(mo.capacity_factor * tg * k / e))
    xg = x.reshape(g, tg, d)
    experts = torch.arange(e, device=x.device)
    weights = (params["w_gate"], params["w_up"], params["w_down"])
    if isinstance(x, DTensor):
        probs, gate_vals, gate_idx = _route_sharded(xg, params["router"], k, e, cap)
        out = _dispatch_sharded(xg, gate_vals, gate_idx, weights, e, cap)
    else:
        probs, gate_vals, gate_idx = _route(xg, params["router"], k)
        out = _dispatch(xg, gate_vals, gate_idx, *weights, e, cap)
    out = out.reshape(t, d)
    if "shared" in params:
        out = out + mlp(params["shared"], x.reshape(t, d), cfg)
    # load-balance auxiliary loss (Switch-style)
    density = (gate_idx[..., 0, None] == experts).float().mean(dim=(0, 1))
    aux = (density * probs.mean(dim=(0, 1))).sum() * e * mo.router_aux_weight
    return out.reshape(b, s, d).to(x.dtype), aux


def _route(xg, router, k: int):
    """The fp32 router over ``xg`` (G, tg, d): the probabilities, and each
    token's top ``k`` gates (renormalised) and experts."""
    logits = xg.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)  # (G, tg, k)
    return probs, gate_vals / gate_vals.sum(dim=-1, keepdim=True), gate_idx


def _moe_groups_placement(xg, e: int, cap: int):
    """The ``moe_expert`` hint's (G, E, cap, d) spec, and the groups'
    placement it gives the tokens (G over the data axes when they divide)."""
    g, _, d = xg.shape
    spec = hint_spec("moe_expert", (g, e, cap, d)) or shd.Spec(None, None, None, None)
    return spec, shd.to_placements(shd.Spec(spec[0], None, None), xg.device_mesh)


def _route_sharded(xg, router, k: int, e: int, cap: int):
    """:func:`_route` on DTensors, each rank on its groups (``local_map``:
    DTensor cannot carry the gradient of top-k's selection back through
    the router's product): every `model` rank routes its groups whole, so
    only the router's gradient is a partial sum, over the data axes."""
    mesh = xg.device_mesh
    _, xp = _moe_groups_placement(xg, e, cap)
    whole = (Replicate(),) * mesh.ndim
    rgrad = tuple(Partial() if p == Shard(0) else Replicate() for p in xp)
    return shd.local_call(lambda xl, rl: _route(xl, rl, k), (xg, router), (xp, whole),
                          (xp, xp, xp), mesh, in_grad_placements=(xp, rgrad))


def _dispatch(xg, gate_vals, gate_idx, w_gate, w_up, w_down, e: int, cap: int,
              e0: int = 0):
    """The capacity dispatch, the expert products and the combine of
    :func:`moe` over ``xg`` (G, tg, d), for the experts ``[e0, e0 +
    w_gate.shape[0])`` of ``e``: a choice of another expert is dropped as a
    zero row (expert parallelism: the ranks' outputs sum to the whole)."""
    g, tg, d = xg.shape
    k = gate_idx.shape[-1]
    e_loc = w_gate.shape[0]
    # position of each (token, choice) within its expert's queue, per group
    experts = torch.arange(e, device=xg.device)
    idx = gate_idx.reshape(g, tg * k)
    flat = (idx[..., None] == experts).long()  # (G, tg*k, E)
    pos = ((flat.cumsum(dim=1) - flat) * flat).sum(dim=-1)  # (G, tg*k)
    keep = (pos < cap).to(xg.dtype)
    if e_loc != e:  # this rank's experts only
        mine = (idx >= e0) & (idx < e0 + e_loc)
        keep = keep * mine.to(keep.dtype)
        idx = torch.where(mine, idx - e0, 0)
    dest = idx * cap + pos.clamp(0, cap - 1)
    dest = dest[..., None].expand(g, tg * k, d)
    updates = (xg[:, :, None, :] * keep.reshape(g, tg, k, 1)).reshape(g, tg * k, d)
    expert_in = torch.zeros((g, e_loc * cap, d), dtype=xg.dtype, device=xg.device)
    expert_in = expert_in.scatter_add_(1, dest, updates).reshape(g, e_loc, cap, d)
    h = (F.silu(torch.einsum("gecd,edf->gecf", expert_in, w_gate))
         * torch.einsum("gecd,edf->gecf", expert_in, w_up))
    expert_out = torch.einsum("gecf,efd->gecd", h, w_down)
    gathered = torch.gather(expert_out.reshape(g, e_loc * cap, d), 1, dest)
    wts = (gate_vals.reshape(g, tg * k) * keep)[..., None].to(gathered.dtype)
    return (gathered * wts).reshape(g, tg, k, d).sum(dim=2)


def _dispatch_sharded(xg, gate_vals, gate_idx, weights, e: int, cap: int):
    """:func:`_dispatch` on DTensors: DTensor has no rule for its scatter,
    so each rank runs it on its shards (``local_map``), placed as the
    reference's ``moe_expert`` hint places the (G, E, cap, d) buffers:
    groups over the data axes when they divide, experts over `model`
    (expert parallelism) when E divides; with experts whole, the expert
    weights keep their tensor-parallel shards (F over `model`).  Where a
    rank holds a share of the experts or of F, its output, and the
    gradients of its tokens and gates, are partial sums."""
    mesh = xg.device_mesh
    spec, xp = _moe_groups_placement(xg, e, cap)
    ep = shd.to_placements(shd.Spec(spec[1], None, None), mesh)
    wps = ([], [], [])
    for i, p in enumerate(ep):
        tp = weights[0].placements[i] == Shard(2) and weights[2].placements[i] == Shard(1)
        for wp, sharded in zip(wps, (Shard(2), Shard(2), Shard(1))):
            wp.append(p if p == Shard(0) else (sharded if tp else Replicate()))
    wps = tuple(tuple(wp) for wp in wps)
    split = [wps[0][i] != Replicate() for i in range(mesh.ndim)]
    outp = tuple(Partial() if split[i] else p for i, p in enumerate(xp))
    wgrad = tuple(tuple(Partial() if xp[i] == Shard(0) else p for i, p in enumerate(wp))
                  for wp in wps)
    e0 = shd.shard_offset(mesh, ep, e, 0)

    def run(xl, vl, il, wg, wu, wd):
        return _dispatch(xl, vl, il, wg, wu, wd, e, cap, e0)

    # pinned: the partial gradients of the tokens and gates are summed here,
    # before they reach the routing's backward (DTensor cannot take a
    # partial sum through top-k's)
    xg, gate_vals = (shd.pin(t.redistribute(mesh, xp)) for t in (xg, gate_vals))
    return shd.local_call(run, (xg, gate_vals, gate_idx, *weights),
                          (xp, xp, xp, *wps), outp, mesh,
                          in_grad_placements=(outp, outp, xp, *wgrad))


# ---------------------------------------------------------------------------
# Mamba-2 (SSD) layer
# ---------------------------------------------------------------------------


def init_mamba2(gen, cfg: ModelConfig) -> Params:
    """layers.py:848: separate projections (z, x, B, C, dt), the depthwise
    causal conv, fp32 per-head ``a_log``/``d_skip``/``dt_bias``, the gated
    norm's weight and the output projection."""
    sm = cfg.ssm
    d = cfg.d_model
    di, nh, n = sm.d_inner(d), sm.num_heads(d), sm.state_dim
    conv_dim = di + 2 * n
    dt, dev = dtype_of(cfg), gen.device
    conv_w = torch.randn((sm.conv_width, conv_dim), generator=gen, device=dev,
                         dtype=torch.float32) * 0.1
    return {
        "w_z": _dense_init(gen, (d, di), dt),
        "w_x": _dense_init(gen, (d, di), dt),
        "w_B": _dense_init(gen, (d, n), dt),
        "w_C": _dense_init(gen, (d, n), dt),
        "w_dt": _dense_init(gen, (d, nh), dt),
        "conv_w": conv_w.to(dt),
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=dev),
        "a_log": torch.zeros((nh,), dtype=leaf_dtype("a_log", cfg), device=dev),
        "d_skip": torch.ones((nh,), dtype=leaf_dtype("d_skip", cfg), device=dev),
        "dt_bias": torch.zeros((nh,), dtype=leaf_dtype("dt_bias", cfg), device=dev),
        "norm_w": torch.ones((di,), dtype=dt, device=dev),
        "out_proj": _dense_init(gen, (di, d), dt),
    }


def _mamba_proj(params, x):
    """layers.py:873: (z, x, B, C, dt), each ``x @ w``."""
    return tuple(x @ params[k] for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _causal_conv(x, w, b):
    """x (B, S, C); the depthwise causal conv of width W as the reference
    writes it (layers.py:882): a sum of shifted products, then SiLU."""
    width, s = w.shape[0], x.shape[1]
    pad = F.pad(x, (0, 0, width - 1, 0))
    out = pad[:, 0:s, :] * w[0][None, None, :]
    for i in range(1, width):
        out = out + pad[:, i:i + s, :] * w[i][None, None, :]
    return F.silu(out + b)


def mamba2_ssd_inputs(params, x, cfg: ModelConfig):
    """The first half of :func:`mamba2_full` (layers.py:892-916): the
    projections, the causal conv and the softplus of dt.  Returns ``(z, xh,
    Ch, Bh, dth, chunk)``: ``xh`` (B, H, S, P) a transposed view; ``Ch`` and
    ``Bh`` (B, H, S, N) the conv's C and B broadcast over the H heads as
    ``expand``ed views (head stride 0, no copy: autograd sums their
    gradient over the heads); ``dth`` (B, H, S) fp32; and the chunk, 128 or
    ``gcd(S, 128)`` for a sequence 128 does not divide."""
    sm = cfg.ssm
    b, s, d = x.shape
    di, nh, n = sm.d_inner(d), sm.num_heads(d), sm.state_dim
    z, xin, bm, cm, dt = _mamba_proj(params, x)
    conv_out = _causal_conv(torch.cat([xin, bm, cm], dim=-1), params["conv_w"],
                            params["conv_b"])
    xin, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (b, s, nh)
    xh = shd.contiguous_grad(xin.reshape(b, s, nh, sm.head_dim)).transpose(1, 2)
    bh = bm[:, None].expand(b, nh, s, n)
    ch = cm[:, None].expand(b, nh, s, n)
    chunk = min(sm.chunk, s)
    if s % chunk:
        chunk = math.gcd(s, chunk) or 1
    return z, xh, ch, bh, shd.contiguous_grad(dt).transpose(1, 2), chunk


def mamba2_full(params: Params, x, cfg: ModelConfig):
    """Full-sequence Mamba-2 layer (layers.py:892): the SSD through the
    chunk_state and chunk_scan kernels, the D skip, the SiLU(z)-gated RMS
    norm and the output projection, with the reference's roundings
    (``xh * dt`` rounded to the model dtype before the SSD, the SSD's output
    in the model dtype, the skip and the gate in fp32)."""
    b, s, _ = x.shape
    z, xh, ch, bh, dth, chunk = mamba2_ssd_inputs(params, x, cfg)
    xdt = xh * dth[..., None].to(xh.dtype)
    ssd = _ssd_sharded if isinstance(xdt, DTensor) else _ssd_batched
    y = ssd(ch, bh, xdt, dth, params["a_log"], chunk)
    y = y + params["d_skip"][None, :, None, None] * xh
    y = y.transpose(1, 2).reshape(b, s, -1)
    y = rmsnorm(y * F.silu(z), params["norm_w"], cfg.norm_eps)
    return y.to(x.dtype) @ params["out_proj"]


def ssd_operands(c, bm, x, dt, a_log, chunk: int):
    """The SSD kernels' operands (layers.py:923-933): ``c``/``bm`` (..., S,
    N), ``x`` (..., S, P) as (..., S / chunk, chunk, .) views, and the
    per-chunk cumulative decay dA_cum (..., S / chunk, chunk) fp32 from
    ``dt`` (..., H, S) and the per-head ``a_log`` (H,)."""
    s = c.shape[-2]
    nc = s // chunk
    rs = lambda t: t.reshape(*t.shape[:-2], nc, chunk, t.shape[-1])  # noqa: E731
    da = dt * (-torch.exp(a_log))[:, None]
    da_cum = torch.cumsum(da.reshape(*da.shape[:-1], nc, chunk), dim=-1)
    return rs(c), rs(bm), rs(x), da_cum


def _ssd_batched(c, bm, x, dt, a_log, chunk: int):
    """SSD with per-head a_log (layers.py:923): the two kernels (through
    their autograd functions) around the plain inter-chunk recurrence.
    Returns (..., S, P) in x's dtype."""
    cc, bb, xx, da_cum = ssd_operands(c, bm, x, dt, a_log, chunk)
    states = ops.chunk_state(bb, xx, da_cum)
    incoming = ref.state_recurrence(states, da_cum[..., -1])
    y = ops.chunk_scan(cc, bb, xx, da_cum, incoming)
    return y.reshape(x.shape).to(x.dtype)


def _ssd_sharded(c, bm, x, dt, a_log, chunk: int):
    """:func:`_ssd_batched` on DTensors: DTensor has no rule for the SSD
    kernels, so each rank runs them on its shards (``local_map``).  The SSD
    is independent across the batch and the heads, so every operand takes
    the batch and head shards ``x`` arrives with (the reference places no
    hint here; a head shard follows the column-parallel ``w_x``), and
    anything else whole; ``a_log`` (H,) follows the heads, and its
    gradient is a partial sum over the batch shards."""
    mesh = x.device_mesh
    xp = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in x.placements)
    for d in (0, 1):
        if x.shape[d] % math.prod(mesh.size(i) for i, p in enumerate(xp) if p == Shard(d)):
            xp = tuple(Replicate() if p == Shard(d) else p for p in xp)
    dtp = xp  # (B, H, S)
    ap = tuple(Shard(0) if p == Shard(1) else Replicate() for p in xp)
    agrad = tuple(Partial() if p == Shard(0) else ap[i] for i, p in enumerate(xp))
    return shd.local_call(
        lambda cl, bl, xl, dl, al: _ssd_batched(cl, bl, xl, dl, al, chunk),
        (c, bm, x, dt, a_log), (xp, xp, xp, dtp, ap), xp, mesh,
        in_grad_placements=(xp, xp, xp, dtp, agrad))


def init_mamba2_cache(cfg: ModelConfig, batch: int, device,
                      layers: Optional[int] = None) -> Params:
    """layers.py:938: the recurrent state ``ssm`` (batch, H, N, P) fp32 and
    the conv window ``conv`` (batch, W - 1, conv_dim) in the model dtype,
    stacked over ``layers`` in front when given."""
    sm = cfg.ssm
    d = cfg.d_model
    lead = (layers,) if layers is not None else ()
    conv_dim = sm.d_inner(d) + 2 * sm.state_dim
    return {
        "ssm": torch.zeros(lead + (batch, sm.num_heads(d), sm.state_dim,
                                   sm.head_dim), dtype=torch.float32,
                           device=device),
        "conv": torch.zeros(lead + (batch, sm.conv_width - 1, conv_dim),
                            dtype=dtype_of(cfg), device=device),
    }


def mamba2_decode(params: Params, x, cfg: ModelConfig, cache):
    """One token of the SSM recurrence (layers.py:949): h = exp(dt A) h +
    dt B^T x, y = C h.  ``x`` (B, 1, d); ``cache`` holds ``ssm`` and
    ``conv`` of one layer.  Returns ``(out, {"ssm", "conv"})``, the new
    state as new tensors (the caller decides where it lands)."""
    sm = cfg.ssm
    b, _, d = x.shape
    di, nh, n = sm.d_inner(d), sm.num_heads(d), sm.state_dim
    z, xin, bm, cm, dt = (t[:, 0] for t in _mamba_proj(params, x))
    window = torch.cat([cache["conv"], torch.cat([xin, bm, cm], dim=-1)[:, None]],
                       dim=1)
    conv_out = F.silu((window * params["conv_w"][None]).sum(dim=1)
                      + params["conv_b"])
    xin, bm, cm = torch.split(conv_out, [di, n, n], dim=-1)
    dt = F.softplus(dt.float() + params["dt_bias"])  # (b, nh)
    xh = xin.reshape(b, nh, sm.head_dim).float()
    step = _ssm_step_sharded if isinstance(cache["ssm"], DTensor) else _ssm_step
    y, h = step(xh, dt, bm, cm, cache["ssm"], params["a_log"], params["d_skip"])
    y = y.reshape(b, 1, di)
    y = rmsnorm(y * F.silu(z[:, None]).float(), params["norm_w"], cfg.norm_eps)
    out = y.to(x.dtype) @ params["out_proj"]
    return out, {"ssm": h, "conv": window[:, 1:]}


def _ssm_step(xh, dt, bm, cm, state, a_log, d_skip):
    """One token of the recurrence on (B, H, P) ``xh``, (B, H) ``dt``, (B,
    N) ``bm``/``cm`` and the (B, H, N, P) ``state``: ``(y, new state)``."""
    decay = torch.exp(dt * (-torch.exp(a_log))[None])  # (b, nh)
    # the reference's einsums as one broadcast product (the outer product
    # B^T (x dt)) and one batched product (C h): fewer host ops a token
    upd = bm.float()[:, None, :, None] * (xh * dt[..., None])[:, :, None, :]
    h = state * decay[..., None, None] + upd
    y = torch.matmul(cm.float()[:, None, None, :], h)[:, :, 0]  # (b, nh, P)
    return y + d_skip[None, :, None] * xh, h


def _ssm_step_sharded(xh, dt, bm, cm, state, a_log, d_skip):
    """:func:`_ssm_step` on DTensors, each rank on its shards (``local_map``:
    DTensor has no rule for its broadcast batched product), placed as the
    state (``cells.cache_specs``): batch over the data axes, heads over
    `model`; B and C whole on `model`."""
    mesh = state.device_mesh
    sp = tuple(p if p in (Shard(0), Shard(1)) else Replicate() for p in state.placements)
    bp = tuple(p if p == Shard(0) else Replicate() for p in sp)
    hp = tuple(Shard(0) if p == Shard(1) else Replicate() for p in sp)
    return shd.local_call(_ssm_step, (xh, dt, bm, cm, state, a_log, d_skip),
                          (sp, sp, bp, bp, sp, hp, hp), (sp, sp), mesh)
