"""Plain PyTorch versions of the port's kernels.

Counterparts of ``repro.kernels.ref``: ``paged_attention`` (ref.py:286),
``prefill_attention`` (:343), ``rmsnorm`` (:664), the KV quantization
primitives with ``paged_attention_quant`` (:115-172) and the latent (MLA)
oracles ``mla_paged`` (:454), ``mla_prefill`` (:480) and
``mla_paged_quant`` (:174), the contiguous ``attention`` (:235), the
flash-attention kernel's plain version, the Mamba-2 SSD pieces
``chunk_state`` (:585), ``chunk_scan`` (:596), ``state_recurrence`` (:619)
and ``ssd`` (:638), and the kernel library's ``matmul`` (:21), weight
unpacking with ``dequant_matmul`` (:31-104) and contiguous ``mla`` (:549),
op for op.  They are
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


# ---------------------------------------------------------------------------
# GEMM and the weight-only dequantized GEMM (the kernel library)
# ---------------------------------------------------------------------------


def matmul(a: torch.Tensor, b: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """``a`` (M, K) @ ``b`` (K, N) with fp32 products and sums, rounded
    once to ``out_dtype`` (ref.py:21)."""
    return torch.matmul(a.float(), b.float()).to(out_dtype)


# bitsandbytes' NF4 codebook (ref.py:34), index = the 4-bit code
NF4_CODEBOOK = torch.tensor([
    -1.0, -0.6961928009986877, -0.5250730514526367, -0.39491748809814453,
    -0.28444138169288635, -0.18477343022823334, -0.09105003625154495, 0.0,
    0.07958029955625534, 0.16093020141124725, 0.24611230194568634, 0.33791524171829224,
    0.44070982933044434, 0.5626170039176941, 0.7229568362236023, 1.0,
], dtype=torch.float32)
# codes a packed int8 byte holds, by weight format
WEIGHT_PACK = {"int4": 2, "int2": 4, "nf4": 2, "int8": 1}


def _crumbs(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., K // pack) int8 -> (..., K) int32 fields of ``bits`` bits,
    lowest bits first, each masked after the (arithmetic) shift."""
    b = packed.to(torch.int32)
    mask = (1 << bits) - 1
    parts = [(b >> (bits * i)) & mask for i in range(8 // bits)]
    return torch.stack(parts, dim=-1).reshape(*packed.shape[:-1], -1)


def unpack_int2(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//4) int8 -> (..., K) int8 values in [-2, 1] (ref.py:54)."""
    vals = _crumbs(packed, 2)
    return torch.where(vals >= 2, vals - 4, vals).to(torch.int8)


def unpack_nf4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2) int8 -> (..., K) float32 codebook values (ref.py:63)."""
    return NF4_CODEBOOK.to(packed.device)[_crumbs(packed, 4).long()]


def dequant_weight(b_packed: torch.Tensor, fmt: str) -> torch.Tensor:
    """The (N, K) fp32 weight a packed (N, K // pack) int8 matrix holds."""
    if fmt == "int4":
        return unpack_int4(b_packed).float()
    if fmt == "int2":
        return unpack_int2(b_packed).float()
    if fmt == "nf4":
        return unpack_nf4(b_packed)
    if fmt == "int8":
        return b_packed.float()
    raise ValueError(f"unknown dequant format {fmt}")


def dequant_matmul(a: torch.Tensor, b_packed: torch.Tensor, fmt: str = "int4",
                   scales: Optional[torch.Tensor] = None, group_size: int = 128,
                   out_dtype=torch.float32) -> torch.Tensor:
    """``a`` (M, K) @ dequant(``b_packed``)[N, K]^T -> (M, N) (ref.py:71):
    B stored N-major with the K axis packed, ``scales`` (N, K // group)
    per-group; the weight, its scaling and the product in fp32."""
    w = dequant_weight(b_packed, fmt)
    if scales is not None:
        n, k = w.shape
        w = (w.reshape(n, k // group_size, group_size)
             * scales.float()[..., None]).reshape(n, k)
    return torch.matmul(a.float(), w.t()).to(out_dtype)


def page_ids(block_tables: torch.Tensor, num_pages: int) -> torch.Tensor:
    """Block-table entries as gather indices into a pool of ``num_pages``,
    clamped into it as JAX's out-of-range gather clamps.  The dispatch guard
    rules such an entry out; with guards off (an injected table corruption
    the invariant auditor must catch after the tick) the plain paths read a
    real page where torch indexing would raise."""
    return block_tables.long().clamp(0, num_pages - 1)


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
    tables = page_ids(block_tables, k_pages.shape[1])

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


def _chunk_scatter_index(start_lens, chunk_lens, block_tables, chunk: int,
                         page_size: int, num_pages: int):
    """Where the plain path scatters each chunk position: ``(phys, off,
    pos)``.  The logical page is clamped to ``max_pages - 1`` and the dead
    chunk tail goes to the reserved page 0 (ops.py:312-326).  A page id
    outside the pool, whose write XLA drops, lands in page 0 too, as the
    decode append's does: dropping it would take a boolean index, a host
    sync on a card.  Only page 0's bytes differ, and nothing reads them."""
    max_pages = block_tables.shape[1]
    ar = torch.arange(chunk, dtype=torch.int32, device=block_tables.device)
    pos = start_lens.to(torch.int32)[:, None] + ar
    logical = torch.clamp(pos // page_size, 0, max_pages - 1)
    phys = torch.gather(block_tables.long(), 1, logical.long())  # (B, C)
    valid = ar[None, :] < chunk_lens.to(torch.int32)[:, None]
    valid &= (phys >= 0) & (phys < num_pages)
    return torch.where(valid, phys, 0), (pos % page_size).long(), pos


def _context_positions(start_lens, s_total: int):
    """(B, S) absolute position of each gathered page row; -1 past the
    slot's prior tokens."""
    si = torch.arange(s_total, dtype=torch.int32, device=start_lens.device)
    return torch.where(si[None, :] < start_lens.to(torch.int32)[:, None],
                       si[None, :], -1)


def paged_prefill_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                            start_lens, chunk_lens, *, sm_scale=None,
                            window: Optional[int] = None, logit_soft_cap=None):
    """The plain chunked-prefill path over a paged pool: the XLA branch of
    ``repro.kernels.ops.prefill_attention`` (ops.py:312-340).

    Scatters the chunk's K/V into the pools **in place** through the block
    table (the logical page clamped to ``max_pages - 1``, the dead chunk tail
    sent to the reserved page 0), then runs :func:`prefill_attention` over
    the gathered pages.  Returns ``(out, k_pages, v_pages)`` with the pools
    the same tensors as given.  A page id outside the pool lands in page 0,
    where XLA drops it (:func:`_chunk_scatter_index`).
    """
    b, hq, chunk, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    phys, off, pos = _chunk_scatter_index(
        start_lens, chunk_lens, block_tables, chunk, page_size, num_pages)
    k_pages[:, phys, off] = k_new.transpose(0, 1).to(k_pages.dtype)
    v_pages[:, phys, off] = v_new.transpose(0, 1).to(v_pages.dtype)
    tables = page_ids(block_tables, num_pages)

    def gathered(pages):  # (Hkv, B, max_pages, ps, D) -> (B, Hkv, S, D)
        return pages[:, tables].transpose(0, 1).reshape(b, hkv, -1, d)

    kg, vg = gathered(k_pages), gathered(v_pages)
    out = prefill_attention(
        q, k_new, v_new, kg, vg, _context_positions(start_lens, kg.shape[2]),
        pos, chunk_lens, sm_scale=sm_scale, window=window,
        logit_soft_cap=logit_soft_cap,
    )
    return out, k_pages, v_pages


# ---------------------------------------------------------------------------
# KV-cache quantization: symmetric per-row (per-token) scales, packed along
# the feature axis.  A quantized page pool holds packed int8 bytes
# (..., D // pack) plus a (..., 1) scale column in the model's dtype.
# ---------------------------------------------------------------------------

KV_QMAX = {"int8": 127.0, "int4": 7.0}
KV_PACK = {"int8": 1, "int4": 2}


def pack_int4(vals: torch.Tensor) -> torch.Tensor:
    """(..., K) int8 in [-8, 7] -> (..., K//2) int8, low nibble first."""
    lo = vals[..., 0::2].to(torch.int32) & 0xF
    hi = vals[..., 1::2].to(torch.int32) & 0xF
    return (lo | (hi << 4)).to(torch.uint8).view(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """(..., K//2) int8 -> (..., K) int8 values in [-8, 7]."""
    b = packed.to(torch.int32)
    vals = torch.stack([b & 0xF, (b >> 4) & 0xF], dim=-1)
    vals = vals.reshape(*packed.shape[:-1], -1)
    return torch.where(vals >= 8, vals - 16, vals).to(torch.int8)


def quantize_rows(x: torch.Tensor, fmt: str = "int8"):
    """Symmetric per-row quantization over the last axis: ``(packed,
    scales)``, packed int8 data (last axis divided by the pack factor) and
    (..., 1) scales in ``x``'s dtype.  The codes are ``round(x / scale)``
    with the fp32 scale (half to even, as ``jnp.round``); all-zero rows get
    scale 1 so they dequantize to exact zeros."""
    qmax = KV_QMAX[fmt]
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.where(amax > 0, amax / qmax, torch.ones_like(amax))
    q = torch.clamp(torch.round(xf / scale), -qmax, qmax).to(torch.int8)
    if fmt == "int4":
        q = pack_int4(q)
    return q, scale.to(x.dtype)


def dequantize_rows(packed: torch.Tensor, scales: torch.Tensor,
                    fmt: str = "int8") -> torch.Tensor:
    """Inverse of :func:`quantize_rows` -> float32."""
    vals = unpack_int4(packed) if fmt == "int4" else packed
    return vals.float() * scales.float()


def paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                          block_tables, seq_lens, fmt: str = "int8",
                          sm_scale: Optional[float] = None,
                          window: Optional[int] = None,
                          logit_soft_cap: Optional[float] = None,
                          out_dtype=None) -> torch.Tensor:
    """Quantized paged decode: dequantize the pools (packed (Hkv, P, ps,
    D // pack) int8 plus (Hkv, P, ps, 1) scales), round to the query's
    dtype, then :func:`paged_attention` (ref.py:151)."""
    kf = dequantize_rows(k_pages, k_scales, fmt).to(q.dtype)
    vf = dequantize_rows(v_pages, v_scales, fmt).to(q.dtype)
    return paged_attention(q, kf, vf, block_tables, seq_lens,
                           sm_scale=sm_scale, window=window,
                           logit_soft_cap=logit_soft_cap, out_dtype=out_dtype)


def paged_prefill_attention_quant(q, k_q, v_q, k_s, v_s, k_pages, v_pages,
                                  k_scales, v_scales, block_tables,
                                  start_lens, chunk_lens, *, fmt="int8",
                                  sm_scale=None, window: Optional[int] = None,
                                  logit_soft_cap=None):
    """The plain quantized chunked-prefill path over paged pools: the XLA
    branch of ``repro.kernels.ops.prefill_attention_quant`` (ops.py:416-447).

    The chunk arrives quantized: ``k_q``/``v_q`` (B, Hkv, C, D // pack) int8
    and ``k_s``/``v_s`` (B, Hkv, C, 1) scales.  Its packed bytes and scales
    are scattered into the four pools **in place** (the scatter of
    :func:`paged_prefill_attention`), then every chunk query attends the
    dequantized gather of its prior pages plus the chunk's own dequantized
    round trip, all rounded to the query's dtype.  Returns ``(out, k_pages,
    v_pages, k_scales, v_scales)``, the pools being the tensors given."""
    b, hq, chunk, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    phys, off, pos = _chunk_scatter_index(
        start_lens, chunk_lens, block_tables, chunk, page_size, num_pages)
    for pool, new in ((k_pages, k_q), (v_pages, v_q), (k_scales, k_s),
                      (v_scales, v_s)):
        pool[:, phys, off] = new.transpose(0, 1).to(pool.dtype)
    tables = page_ids(block_tables, num_pages)

    def gathered(pages, scales):  # (Hkv, B, max_pages, ps, D) -> (B, Hkv, S, D)
        g = dequantize_rows(pages[:, tables], scales[:, tables], fmt).to(q.dtype)
        return g.transpose(0, 1).reshape(b, hkv, -1, d)

    kg, vg = gathered(k_pages, k_scales), gathered(v_pages, v_scales)
    out = prefill_attention(
        q, dequantize_rows(k_q, k_s, fmt).to(q.dtype),
        dequantize_rows(v_q, v_s, fmt).to(q.dtype), kg, vg,
        _context_positions(start_lens, kg.shape[2]), pos, chunk_lens,
        sm_scale=sm_scale, window=window, logit_soft_cap=logit_soft_cap,
    )
    return out, k_pages, v_pages, k_scales, v_scales


# ---------------------------------------------------------------------------
# Multi-head latent attention (MLA): every query head attends one shared
# latent (R) plus a rotary part (Dpe); V is the latent itself.  Pools carry
# no head axis: (P, page_size, R) and (P, page_size, Dpe).
# ---------------------------------------------------------------------------


def mla_masked(q_lat, q_pe, c_kv, k_pe, kv_len, sm_scale: float,
               window: Optional[int] = None,
               logit_soft_cap: Optional[float] = None) -> torch.Tensor:
    """Latent decode attention under a length mask (ref.py:422): scores
    ``q_lat.c_kv + q_pe.k_pe`` in fp32, scaled then capped, and the float32
    latent output (B, H, R).  A slot with no live key emits zeros, as the
    kernels' safe_div does (the reference's XLA softmax would give NaN
    there; decode never asks, its lengths are at least 1)."""
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), c_kv.float())
              + torch.einsum("bhp,bsp->bhs", q_pe.float(), k_pe.float())) * sm_scale
    if logit_soft_cap is not None:
        scores = logit_soft_cap * torch.tanh(scores / logit_soft_cap)
    lens = torch.as_tensor(kv_len, dtype=torch.int32, device=scores.device)
    lens = lens.expand(scores.shape[0])
    ki = torch.arange(c_kv.shape[1], dtype=torch.int32, device=scores.device)
    mask = ki[None, None, :] < lens[:, None, None]
    if window is not None:
        mask = mask & (ki[None, None, :] >= (lens[:, None, None] - window))
    scores = torch.where(mask, scores, _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m) * mask
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return torch.einsum("bhs,bsr->bhr", p, c_kv.float())


def mla(q: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor,
        k_pe: torch.Tensor, sm_scale: Optional[float] = None,
        out_dtype=None) -> torch.Tensor:
    """Contiguous MLA decode (ref.py:549): ``q`` (B, Hq, D) and ``q_pe``
    (B, Hq, Dpe) against ``kv`` (B, S, Hkv, D) and ``k_pe`` (B, S, Hkv,
    Dpe), Hq / Hkv query heads a latent head; scores and softmax in fp32,
    scale 1 / sqrt(D + Dpe) by default, V the latent itself."""
    b, hq, d = q.shape
    hkv = kv.shape[2]
    group = hq // hkv
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d + q_pe.shape[-1])
    qg = q.reshape(b, hkv, group, d).float()
    qpeg = q_pe.reshape(b, hkv, group, -1).float()
    kvf = kv.float()
    scores = torch.einsum("bhgd,bshd->bhgs", qg, kvf)
    scores += torch.einsum("bhgp,bshp->bhgs", qpeg, k_pe.float())
    p = torch.softmax(scores * sm_scale, dim=-1)
    out = torch.einsum("bhgs,bshd->bhgd", p, kvf)
    return out.reshape(b, hq, d).to(out_dtype or q.dtype)


def mla_paged(q_lat, q_pe, ckv_pages, kpe_pages, block_tables, seq_lens,
              sm_scale: Optional[float] = None, window: Optional[int] = None,
              logit_soft_cap: Optional[float] = None,
              out_dtype=None) -> torch.Tensor:
    """Paged MLA decode (ref.py:454): ``q_lat`` (B, H, R) and ``q_pe`` (B,
    H, Dpe) against the latent and rope pages of each slot's table row,
    gathered into logical order, then :func:`mla_masked`."""
    b, _, r = q_lat.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(r + q_pe.shape[-1])
    tables = page_ids(block_tables, ckv_pages.shape[0])
    ckv = ckv_pages[tables].reshape(b, -1, r)
    kpe = kpe_pages[tables].reshape(b, -1, kpe_pages.shape[-1])
    out = mla_masked(q_lat, q_pe, ckv, kpe, seq_lens, sm_scale, window=window,
                     logit_soft_cap=logit_soft_cap)
    return out.to(out_dtype or q_lat.dtype)


def mla_paged_quant(q_lat, q_pe, ckv_pages, kpe_pages, ckv_scales, kpe_scales,
                    block_tables, seq_lens, fmt: str = "int8",
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None,
                    logit_soft_cap: Optional[float] = None,
                    out_dtype=None) -> torch.Tensor:
    """Quantized paged MLA decode (ref.py:174): both pools packed ((P, ps,
    R // pack) and (P, ps, Dpe // pack) int8) with their own (P, ps, 1)
    scales, dequantized and rounded to the query's dtype, then
    :func:`mla_paged`."""
    ckv = dequantize_rows(ckv_pages, ckv_scales, fmt).to(q_lat.dtype)
    kpe = dequantize_rows(kpe_pages, kpe_scales, fmt).to(q_lat.dtype)
    return mla_paged(q_lat, q_pe, ckv, kpe, block_tables, seq_lens,
                     sm_scale=sm_scale, window=window,
                     logit_soft_cap=logit_soft_cap, out_dtype=out_dtype)


def mla_prefill(q_lat, q_pe, ckv_new, kpe_new, ckv_ctx, kpe_ctx, ctx_pos,
                q_pos, chunk_lens, sm_scale: Optional[float] = None,
                window: Optional[int] = None,
                logit_soft_cap: Optional[float] = None,
                out_dtype=None) -> torch.Tensor:
    """MLA chunked-prefill oracle (ref.py:480): ``q_lat``/``q_pe`` (B, H,
    C, ·) attend ``softmax([scores_ctx ; scores_new])`` over the prior
    latents ``ckv_ctx``/``kpe_ctx`` (B, S, ·) and the chunk's own
    ``ckv_new``/``kpe_new`` (B, C, ·), the latent as V.  The masks are
    :func:`prefill_attention`'s: context validity, causality and the window
    from ``ctx_pos``/``q_pos``, the chunk causal and ragged on
    ``chunk_lens``; a row with no valid key emits zeros."""
    b, h, c, r = q_lat.shape
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(r + q_pe.shape[-1])
    qf, qpef = q_lat.float(), q_pe.float()

    def scores_of(kv, pe):
        s = (torch.einsum("bhcr,bsr->bhcs", qf, kv.float())
             + torch.einsum("bhcp,bsp->bhcs", qpef, pe.float())) * sm_scale
        if logit_soft_cap is not None:
            s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
        return s

    s_ctx = scores_of(ckv_ctx, kpe_ctx)  # (B, H, C, S)
    s_new = scores_of(ckv_new, kpe_new)  # (B, H, C, C)
    qp = q_pos.to(torch.int32)
    cp = ctx_pos.to(torch.int32)
    lens = chunk_lens.to(torch.int32)
    m_ctx = (cp[:, None, :] >= 0) & (cp[:, None, :] <= qp[:, :, None])
    ci = torch.arange(c, dtype=torch.int32, device=q_lat.device)
    m_new = (ci[None, None, :] <= ci[None, :, None]) & (
        ci[None, None, :] < lens[:, None, None])
    if window is not None:
        m_ctx = m_ctx & ((qp[:, :, None] - cp[:, None, :]) < window)
        m_new = m_new & ((ci[None, :, None] - ci[None, None, :]) < window)
    mask = torch.cat([m_ctx.expand(b, c, s_ctx.shape[-1]),
                      m_new.expand(b, c, c)], dim=-1)[:, None]  # (B, 1, C, S+C)
    scores = torch.where(mask, torch.cat([s_ctx, s_new], dim=-1), _NEG)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m) * mask
    p = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    v_all = torch.cat([ckv_ctx.float(), ckv_new.float()], dim=1)
    out = torch.einsum("bhcs,bsr->bhcr", p, v_all)
    return out.to(out_dtype or q_lat.dtype)


def paged_mla_prefill(q_lat, q_pe, ckv_new, kpe_new, ckv_pages, kpe_pages,
                      block_tables, start_lens, chunk_lens, *, sm_scale=None,
                      window: Optional[int] = None, logit_soft_cap=None):
    """The plain MLA chunked-prefill path over the latent pools: the XLA
    branch of ``repro.kernels.ops.mla_prefill`` (ops.py:545-566).

    Scatters the chunk's latent and rope rows into the pools **in place**
    (the logical page clamped to ``max_pages - 1``, the dead chunk tail sent
    to page 0), then :func:`mla_prefill` over the gathered pages.  Returns
    ``(out (B, H, C, R), ckv_pages, kpe_pages)``, the pools as given."""
    b, h, chunk, r = q_lat.shape
    num_pages, page_size, _ = ckv_pages.shape
    phys, off, pos = _chunk_scatter_index(
        start_lens, chunk_lens, block_tables, chunk, page_size, num_pages)
    ckv_pages[phys, off] = ckv_new.to(ckv_pages.dtype)
    kpe_pages[phys, off] = kpe_new.to(kpe_pages.dtype)
    tables = page_ids(block_tables, num_pages)
    ckv_ctx = ckv_pages[tables].reshape(b, -1, r)
    kpe_ctx = kpe_pages[tables].reshape(b, -1, kpe_pages.shape[-1])
    out = mla_prefill(
        q_lat, q_pe, ckv_new, kpe_new, ckv_ctx, kpe_ctx,
        _context_positions(start_lens, ckv_ctx.shape[1]), pos, chunk_lens,
        sm_scale=sm_scale, window=window, logit_soft_cap=logit_soft_cap)
    return out, ckv_pages, kpe_pages


def paged_mla_prefill_quant(q_lat, q_pe, ckv_q, kpe_q, ckv_s, kpe_s,
                            ckv_pages, kpe_pages, ckv_scales, kpe_scales,
                            block_tables, start_lens, chunk_lens, *,
                            fmt="int8", sm_scale=None,
                            window: Optional[int] = None,
                            logit_soft_cap=None):
    """The plain quantized MLA chunked-prefill path: the XLA branch of
    ``repro.kernels.ops.mla_prefill_quant`` (ops.py:651-681).

    The chunk arrives quantized: ``ckv_q`` (B, C, R // pack) and ``kpe_q``
    (B, C, Dpe // pack) int8 with their (B, C, 1) scales.  Packed bytes and
    scales are scattered into the four pools **in place**, then every chunk
    query attends the dequantized gather of its prior pages plus the chunk's
    own dequantized round trip, all rounded to the query's dtype.  Returns
    ``(out, ckv_pages, kpe_pages, ckv_scales, kpe_scales)``."""
    b, h, chunk, r = q_lat.shape
    num_pages, page_size, _ = ckv_pages.shape
    phys, off, pos = _chunk_scatter_index(
        start_lens, chunk_lens, block_tables, chunk, page_size, num_pages)
    for pool, new in ((ckv_pages, ckv_q), (kpe_pages, kpe_q),
                      (ckv_scales, ckv_s), (kpe_scales, kpe_s)):
        pool[phys, off] = new.to(pool.dtype)
    tables = page_ids(block_tables, num_pages)

    def gathered(pages, scales):  # (B, max_pages, ps, .) -> (B, S, .)
        g = dequantize_rows(pages[tables], scales[tables], fmt).to(q_lat.dtype)
        return g.reshape(b, -1, g.shape[-1])

    ckv_ctx = gathered(ckv_pages, ckv_scales)
    out = mla_prefill(
        q_lat, q_pe, dequantize_rows(ckv_q, ckv_s, fmt).to(q_lat.dtype),
        dequantize_rows(kpe_q, kpe_s, fmt).to(q_lat.dtype), ckv_ctx,
        gathered(kpe_pages, kpe_scales),
        _context_positions(start_lens, ckv_ctx.shape[1]), pos, chunk_lens,
        sm_scale=sm_scale, window=window, logit_soft_cap=logit_soft_cap)
    return out, ckv_pages, kpe_pages, ckv_scales, kpe_scales


# ---------------------------------------------------------------------------
# Contiguous attention (MHA / GQA, optional causal): the plain version of the
# flash-attention kernel, and what the reference differentiates in training
# ---------------------------------------------------------------------------


def _attn_block(q, k, v, q_offset, causal, sm_scale, logit_soft_cap, kv_len,
                window):
    """Attention for a block of queries at absolute offset ``q_offset``
    (ref.py:202): fp32 scores, scaled then capped, masked to -inf, and a
    plain softmax.  A query row with no live key gives NaN, as the
    reference's does (the flash kernel emits zeros there)."""
    sq, sk = q.shape[2], k.shape[2]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    if logit_soft_cap is not None:
        s = logit_soft_cap * torch.tanh(s / logit_soft_cap)
    mask = None
    qi = torch.arange(sq, device=q.device)[:, None] + q_offset
    ki = torch.arange(sk, device=q.device)[None, :]
    if causal:
        mask = qi >= ki
    if window is not None:
        wmask = (qi - ki) < window
        mask = wmask if mask is None else (mask & wmask)
    if kv_len is not None:
        lens = torch.as_tensor(kv_len, device=q.device)
        lmask = (ki < lens[:, None])[:, None, None, :]
        s = s.masked_fill(~lmask, float("-inf"))
    if mask is not None:
        s = s.masked_fill(~mask[None, None], float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float())


# query-chunk size above which the S^2 scores are streamed a chunk of queries
# at a time (bounds peak memory for long-context prefill)
CHUNKED_THRESHOLD = 8192
Q_CHUNK = 512


def attention(
    q: torch.Tensor,  # (B, Hq, Sq, D)
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,  # (B, Hkv, Sk, Dv)
    causal: bool = False,
    sm_scale: Optional[float] = None,
    logit_soft_cap: Optional[float] = None,
    kv_len: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    out_dtype=None,
    q_chunk: Optional[int] = None,
) -> torch.Tensor:
    """Contiguous attention (ref.py:235), the flash kernel's plain version.

    Causal masks align the queries to the suffix of the keys (query ``i``
    sits at position ``i + Sk - Sq``); ``window`` keeps keys less than
    ``window`` positions back; ``kv_len`` (B,) masks keys past each row's
    length.  GQA repeats each K/V head over its group.  Above
    ``CHUNKED_THRESHOLD`` queries (or with ``q_chunk``) the queries are
    streamed in chunks.  The result is cast to ``out_dtype`` (default: q's)."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    if hq != hkv:
        assert hq % hkv == 0
        rep = hq // hkv
        k = torch.repeat_interleave(k, rep, dim=1)
        v = torch.repeat_interleave(v, rep, dim=1)
    off = sk - sq  # query absolute offset (suffix convention)
    chunk = q_chunk or (Q_CHUNK if sq >= CHUNKED_THRESHOLD else None)
    if chunk is not None and sq % chunk == 0 and sq > chunk:
        out = torch.cat([
            _attn_block(q[:, :, i:i + chunk], k, v, i + off, causal, sm_scale,
                        logit_soft_cap, kv_len, window)
            for i in range(0, sq, chunk)], dim=2)
    else:
        out = _attn_block(q, k, v, off, causal, sm_scale, logit_soft_cap,
                          kv_len, window)
    return out.to(out_dtype or q.dtype)


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunked linear attention (ref.py:579-657)
# ---------------------------------------------------------------------------
# Every function takes any number of leading (batch) dimensions: the port
# keeps batch and head apart, (B, H, ...), where the reference folds them
# into one (B * H, ...); the arithmetic is the same per (batch, head) row.


def chunk_cumsum(dt: torch.Tensor, a_log: torch.Tensor):
    """dt (B, H, L), a_log (H,) -> (dA_cum, dA), the per-chunk cumulative
    decay and the per-step decay (ref.py:579)."""
    da = dt * (-torch.exp(a_log))[None, :, None]
    return torch.cumsum(da, dim=-1), da


def chunk_state(b_mat: torch.Tensor, x: torch.Tensor,
                da_cum: torch.Tensor) -> torch.Tensor:
    """Per-chunk state S = sum_l exp(dA_last - dA_l) B_l^T x_l (ref.py:585):
    b_mat (..., C, L, N), x (..., C, L, P), da_cum (..., C, L) ->
    (..., C, N, P) fp32."""
    decay = torch.exp(da_cum[..., -1:] - da_cum)
    bw = b_mat.float() * decay[..., None]
    return torch.einsum("...cln,...clp->...cnp", bw, x.float())


def chunk_scan(c_mat: torch.Tensor, b_mat: torch.Tensor, x: torch.Tensor,
               da_cum: torch.Tensor, prev_states: torch.Tensor) -> torch.Tensor:
    """Within-chunk scan plus the carried state's contribution (ref.py:596):
    c_mat, b_mat (..., C, L, N), x (..., C, L, P), da_cum (..., C, L),
    prev_states (..., C, N, P) -> (..., C, L, P) in x's dtype.  The decay
    exp(dA_l - dA_m) is taken only where l >= m (the select comes before the
    exp): above the diagonal the exponent is positive and may overflow to
    inf, and inf * 0 would give NaN."""
    cf, bf, xf = c_mat.float(), b_mat.float(), x.float()
    n = x.shape[-2]
    y_inter = (torch.einsum("...cln,...cnp->...clp", cf, prev_states.float())
               * torch.exp(da_cum)[..., None])
    seg = da_cum[..., :, None] - da_cum[..., None, :]  # dA_l - dA_m
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    att = (torch.einsum("...cln,...cmn->...clm", cf, bf)
           * torch.exp(torch.where(mask, seg, 0.0)))
    att = torch.where(mask, att, 0.0)
    y_intra = torch.einsum("...clm,...cmp->...clp", att, xf)
    return (y_inter + y_intra).to(x.dtype)


def state_recurrence(states: torch.Tensor, da_chunk: torch.Tensor) -> torch.Tensor:
    """Carry states across chunks, S'_c = exp(dA_chunk_c) S'_{c-1} + S_c
    (ref.py:619, the reference's ``lax.scan``): ``states`` (..., C, N, P)
    per-chunk local states, ``da_chunk`` (..., C) each chunk's total decay.
    Returns the *incoming* state of each chunk, (..., C, N, P) fp32.  A loop
    over the chunks, differentiable; it stays plain PyTorch on every
    device."""
    carry = torch.zeros_like(states[..., 0, :, :], dtype=torch.float32)
    incoming = []
    for c in range(states.shape[-3]):
        incoming.append(carry)
        carry = carry * torch.exp(da_chunk[..., c])[..., None, None] + states[..., c, :, :]
    return torch.stack(incoming, dim=-3)


def ssd(c_mat: torch.Tensor, b_mat: torch.Tensor, x: torch.Tensor,
        dt: torch.Tensor, a_log, chunk: int = 64) -> torch.Tensor:
    """The full SSD pass, the plain composition of the two kernels
    (ref.py:638): c_mat, b_mat (B, S, N), x (B, S, P), dt (B, S), a_log a
    scalar (or broadcastable to dt) -> (B, S, P)."""
    bsz, s, _ = c_mat.shape
    p = x.shape[-1]
    nc = s // chunk
    rs = lambda t: t.reshape(bsz, nc, chunk, *t.shape[2:])  # noqa: E731
    da = dt * (-torch.exp(torch.as_tensor(a_log, dtype=torch.float32,
                                          device=dt.device)))
    da_cum = torch.cumsum(da.reshape(bsz, nc, chunk), dim=-1)
    states = chunk_state(rs(b_mat), rs(x), da_cum)
    incoming = state_recurrence(states, da_cum[..., -1])
    y = chunk_scan(rs(c_mat), rs(b_mat), rs(x), da_cum, incoming)
    return y.reshape(bsz, s, p)


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
