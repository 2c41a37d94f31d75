"""Plain PyTorch versions of the kernels on the serving path.

Counterparts of ``repro.kernels.ref``: ``paged_attention`` (ref.py:286),
``prefill_attention`` (:343) and ``rmsnorm`` (:664), op for op.  They are
the oracles the CUDA kernels are held against on the card, and the path
every CPU tensor takes.  Scores, softmax and the P.V product run in fp32
whatever the input dtype; the result is cast back to ``out_dtype`` (default:
the query's dtype).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

_NEG = torch.finfo(torch.float32).min


def paged_attention(
    q: torch.Tensor,  # (B, Hq, D) one query token per slot
    k_pages: torch.Tensor,  # (Hkv, P, page_size, D) physical page pool
    v_pages: torch.Tensor,  # (Hkv, P, page_size, D)
    block_tables: torch.Tensor,  # (B, max_pages) int32 physical page ids
    seq_lens: torch.Tensor,  # (B,) int32 live length per slot (0 = empty)
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    out_dtype=None,
) -> torch.Tensor:
    b, hq, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    assert hq % hkv == 0
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    tables = block_tables.long()

    def gathered(pages):  # (Hkv, B, max_pages, ps, D) -> (B, Hkv, S, D)
        return pages[:, tables].transpose(0, 1).reshape(b, hkv, -1, d)

    k = gathered(k_pages).float()
    v = gathered(v_pages).float()
    s_total = k.shape[2]
    qg = q.reshape(b, hkv, group, d).float()
    # scale first, then cap: the order of attention()'s _attn_block
    scores = torch.einsum("bhgd,bhsd->bhgs", qg, k) * sm_scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
    ki = torch.arange(s_total, dtype=torch.int32, device=q.device)
    lens = seq_lens.to(torch.int32)
    mask = ki[None, :] < lens[:, None]  # (B, S)
    if window is not None:
        mask = mask & (ki[None, :] >= (lens[:, None] - window))
    mask4 = mask[:, None, None, :]
    # masked, empty-row-safe softmax (slots with len 0 emit zeros)
    scores = torch.where(mask4, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m) * mask4
    den = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    p = e / den
    out = torch.einsum("bhgs,bhsd->bhgd", p, v)
    return out.reshape(b, hq, d).to(out_dtype or q.dtype)


def prefill_attention(
    q: torch.Tensor,  # (B, Hq, C, D) chunk queries
    k_new: torch.Tensor,  # (B, Hkv, C, D) the chunk's own keys
    v_new: torch.Tensor,  # (B, Hkv, C, D)
    k_ctx: torch.Tensor,  # (B, Hkv, S, D) prior context keys
    v_ctx: torch.Tensor,  # (B, Hkv, S, D)
    ctx_pos: torch.Tensor,  # (B, S) int32 absolute position per ctx entry; -1 = dead
    q_pos: torch.Tensor,  # (B, C) int32 absolute position per query
    chunk_lens: torch.Tensor,  # (B,) live tokens in the chunk (0 = inactive slot)
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
    logit_soft_cap: Optional[float] = None,
    out_dtype=None,
) -> torch.Tensor:
    """Masked two-part attention: ``softmax([scores_ctx ; scores_new])``.

    Context validity, causality and windowing derive from ``ctx_pos``.
    Query rows past ``chunk_lens`` still attend whatever keys their causal
    window allows (garbage the callers discard); a row with no valid key at
    all emits zeros, not NaN.
    """
    b, hq, c, d = q.shape
    hkv = k_new.shape[1]
    assert hq % hkv == 0
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    qg = q.reshape(b, hkv, group, c, d).float()

    def scores_of(k):
        s = torch.einsum("bhgcd,bhsd->bhgcs", qg, k.float()) * sm_scale
        if logit_soft_cap is not None:
            s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
        return s

    s_ctx = scores_of(k_ctx)  # (B, Hkv, G, C, S)
    s_new = scores_of(k_new)  # (B, Hkv, G, C, C)
    qp = q_pos.to(torch.int32)
    cp = ctx_pos.to(torch.int32)
    lens = chunk_lens.to(torch.int32)
    m_ctx = (cp[:, None, :] >= 0) & (cp[:, None, :] <= qp[:, :, None])
    ci = torch.arange(c, dtype=torch.int32, device=q.device)
    m_new = (ci[None, None, :] <= ci[None, :, None]) & (
        ci[None, None, :] < lens[:, None, None]
    )
    if window is not None:
        m_ctx = m_ctx & ((qp[:, :, None] - cp[:, None, :]) < window)
        m_new = m_new & ((ci[None, :, None] - ci[None, None, :]) < window)
    mask = torch.cat(
        [m_ctx.expand(b, c, s_ctx.shape[-1]), m_new.expand(b, c, c)], dim=-1
    )[:, None, None]  # (B, 1, 1, C, S+C)
    scores = torch.cat([s_ctx, s_new], dim=-1)
    scores = torch.where(mask, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m) * mask
    den = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    p = e / den
    v_all = torch.cat([v_ctx.float(), v_new.float()], dim=2)
    out = torch.einsum("bhgcs,bhsd->bhgcd", p, v_all)
    return out.reshape(b, hq, c, d).to(out_dtype or q.dtype)


def paged_prefill_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                            start_lens, chunk_lens, *, sm_scale=None,
                            window: Optional[int] = None, logit_soft_cap=None):
    """The plain chunked-prefill path over a paged pool: the XLA branch of
    ``repro.kernels.ops.prefill_attention`` (ops.py:312-340).

    Scatters the chunk's K/V into the pools **in place** through the block
    table (the logical page clamped to ``max_pages - 1``, the dead chunk tail
    sent to the reserved page 0), then runs :func:`prefill_attention` over
    the gathered pages.  Returns ``(out, k_pages, v_pages)`` with the pools
    the same tensors as given.  A page id outside the pool is dropped, as
    XLA drops an out-of-range scatter (a torch index would raise instead).
    """
    b, hq, chunk, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    max_pages = block_tables.shape[1]
    tables = block_tables.long()
    ar = torch.arange(chunk, dtype=torch.int32, device=q.device)
    pos = start_lens.to(torch.int32)[:, None] + ar
    logical = torch.clamp(pos // page_size, 0, max_pages - 1)
    phys = torch.gather(tables, 1, logical.long())  # (B, C)
    valid = ar[None, :] < chunk_lens.to(torch.int32)[:, None]
    phys = torch.where(valid, phys, 0)  # dead tail -> reserved garbage page
    off = (pos % page_size).long()
    keep = (phys >= 0) & (phys < num_pages)
    k_pages[:, phys[keep], off[keep]] = k_new.transpose(0, 1)[:, keep].to(k_pages.dtype)
    v_pages[:, phys[keep], off[keep]] = v_new.transpose(0, 1)[:, keep].to(v_pages.dtype)

    def gathered(pages):  # (Hkv, B, max_pages, ps, D) -> (B, Hkv, S, D)
        return pages[:, tables].transpose(0, 1).reshape(b, hkv, -1, d)

    si = torch.arange(max_pages * page_size, dtype=torch.int32, device=q.device)
    ctx_pos = torch.where(si[None, :] < start_lens.to(torch.int32)[:, None],
                          si[None, :], -1)
    out = prefill_attention(
        q, k_new, v_new, gathered(k_pages), gathered(v_pages), ctx_pos, pos,
        chunk_lens, sm_scale=sm_scale, window=window,
        logit_soft_cap=logit_soft_cap,
    )
    return out, k_pages, v_pages


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
