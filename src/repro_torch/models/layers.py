"""Model layers of the dense GQA decoder (plain functions over parameter
dicts), the port's counterpart of the dense subset of ``repro.models.layers``.

Parameters are plain dicts of tensors with the reference's tree layout.
Paged KV pools are updated **in place**: where the reference returned new
pools (``.at[...].set`` on donated buffers), these functions write into the
pools they are given and return only the layer's output.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops, ref
from .config import ModelConfig

Params = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return DTYPES[cfg.dtype]


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
    return params["embedding"][tokens.long()]


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
        q.reshape(b, s, h, hd),
        k.reshape(b, s, hkv, hd),
        v.reshape(b, s, hkv, hd),
    )


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
                            lens, window=None, rope_fraction=1.0):
    """Chunk-wide prefill against a paged KV pool (layers.py:280).

    ``x`` is a (B, C, d) block of prompt tokens per slot; ``pos`` (B,) each
    slot's chunk start, ``lens`` (B,) the live tokens within the chunk
    (0 = slot not prefilling).  The chunk's K/V land in the pool pages in
    place (inside the CUDA kernel, or by the plain path's masked scatter)
    and every chunk query attends prior pages plus the chunk causally.  With
    ``cfg.kv_dtype`` the chunk is quantized and attended as its dequantized
    round trip, and its packed bytes and scales land in the four pools."""
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
            window=window, logit_soft_cap=cfg.logit_soft_cap,
        )[0]
    else:
        out = ops.prefill_attention(
            *qkv, cache["k_pages"], cache["v_pages"], tables, starts, lens,
            window=window, logit_soft_cap=cfg.logit_soft_cap,
        )[0]
    out = out.transpose(1, 2).reshape(b, c, h * hd)
    return out.to(x.dtype) @ params["wo"]


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
