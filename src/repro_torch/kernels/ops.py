"""Public kernel API: dispatch between the hand-written CUDA kernels and the
plain PyTorch path, plus the host-side dispatch guard.

Counterpart of ``repro.kernels.ops``: the serving and training paths
(attention of every kind, and the Mamba-2 SSD's chunk_state and
chunk_scan) and the kernel library (``matmul``, ``dequant_matmul``, the
contiguous FlashMLA ``mla``).
The routing rules are the reference's, kept as explicit rules:

* a soft-capped model takes the plain path (ops.py:247, :353), because no
  kernel caps its scores; contiguous attention also sends a window or a
  ``kv_len`` there (ops.py:219-225);
* chunked prefill, GQA or MLA, fp or quantized, takes the kernel only when
  ``chunk % page_size == 0`` and the chunk spans at most ``max_pages`` pages
  (ops.py:290, :392, :529, :628), and its caller did not ask for the plain
  version (``plain=True``: the speculative verify, whose chunks start at any
  position, ``lm.verify_step``; ``PLAIN_PREFILL`` counts those calls);
* otherwise the kernel wrapper runs: it launches the CUDA kernel for CUDA
  tensors (or raises), and uses the kernel's plain version for CPU tensors.

The device of the tensors is the only other rule: there is no backend knob,
so a CUDA tensor on the kernels' path always reaches its kernel.  Nor are
there the reference's TPU schedule knobs (``block_m/n/k``, ``num_stages``,
``block_h``): each hand-written CUDA kernel picks its own tiles.  The knobs
live with the tile-DSL compiler's programs (``matmul_program``'s blocks,
``tune_matmul``, ``core.autotune``), which no call here compiles.  Unlike the reference's ``dequant_matmul``
(ops.py:709-713), a scale layout the kernel cannot take raises rather than
taking the plain path.

Nothing here catches a build or launch error to fall back.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..core.errors import GuardError
from . import chunk_scan as _csc
from . import chunk_state as _cst
from . import dequant_matmul as _dq
from . import flash_attention as _fa
from . import matmul as _mm
from . import mla as _mla
from . import mla_paged as _mp
from . import mla_paged_quant as _mpq
from . import mla_prefill as _mf
from . import mla_prefill_quant as _mfq
from . import paged_attention as _pa
from . import paged_attention_quant as _paq
from . import prefill_attention as _pf
from . import prefill_attention_quant as _pfq
from . import ref

# the hand-written kernels, by name: those of the serving and training
# paths, then the kernel library's
KERNELS = {"paged_attention": _pa.KERNEL, "prefill_attention": _pf.KERNEL,
           "paged_attention_quant": _paq.KERNEL,
           "prefill_attention_quant": _pfq.KERNEL,
           "mla_paged": _mp.KERNEL, "mla_prefill": _mf.KERNEL,
           "mla_paged_quant": _mpq.KERNEL, "mla_prefill_quant": _mfq.KERNEL,
           "flash_attention": _fa.KERNEL, "chunk_state": _cst.KERNEL,
           "chunk_scan": _csc.KERNEL, "matmul": _mm.KERNEL,
           "dequant_matmul": _dq.KERNEL, "mla": _mla.KERNEL}

# chunked-prefill calls their caller sent to the plain version (the
# speculative verify), by entry point; a caller resets and reads them as it
# does the kernels' launch counts
PLAIN_PREFILL = {"prefill_attention": 0, "prefill_attention_quant": 0,
                 "mla_prefill": 0, "mla_prefill_quant": 0}


def guard_dispatch(tables, num_pages, page_size, work):
    """Discharge the kernels' runtime obligations for one paged dispatch,
    before any page is read or written (``repro.kernels.ops.guard_dispatch``,
    ops.py:60, verbatim).

    ``tables`` is the (rows, max_pages) block table, ``num_pages`` the pool
    extent on the page axis (page 0 reserved as the garbage sink), and
    ``work`` an iterable of ``(row, read_end, write_begin, write_end)``
    token positions: the row will read KV for positions ``[0, read_end)``
    and write positions ``[write_begin, write_end)``.

    Checks (host-side, O(tokens) ints): capacity; ``table_in_range`` (every
    entry backing a live position lies in ``[1, num_pages)``);
    ``table_writes_disjoint`` (no page written by two rows, twice within a
    row, or by one row while live in another).  All violations are raised
    as one :class:`GuardError` so a batch dispatcher can fail exactly the
    offending rows and keep the rest.
    """
    tb = np.asarray(tables)
    max_pages = tb.shape[1]
    capacity = max_pages * page_size
    violations = []
    live: dict = {}  # row -> np entries backing positions [0, read_end)
    writes: dict = {}  # row -> np entries written in [write_begin, write_end)
    for row, read_end, wbeg, wend in work:
        if read_end > capacity or wend > capacity:
            violations.append(
                (row, "table_in_range",
                 f"length {max(read_end, wend)} exceeds page capacity "
                 f"{capacity} ({max_pages} pages x {page_size})")
            )
            continue
        n_live = -(-int(read_end) // page_size)
        entries = tb[row, :n_live].astype(np.int64)
        bad = np.flatnonzero((entries < 1) | (entries >= num_pages))
        if bad.size:
            j = int(bad[0])
            violations.append(
                (row, "table_in_range",
                 f"entry {j} is page {int(entries[j])}, not in "
                 f"[1, {num_pages}) (page 0 is the reserved sink)")
            )
            continue
        live[row] = entries
        if wend > wbeg:
            pbeg, pend = int(wbeg) // page_size, -(-int(wend) // page_size)
            writes[row] = tb[row, pbeg:pend].astype(np.int64)

    writer_of: dict = {}  # page -> first writer row
    bad_rows = set()
    for row, pages in writes.items():
        for pg in pages.tolist():
            other = writer_of.get(pg)
            if other is not None and (other != row or
                                      pages.tolist().count(pg) > 1):
                for r in {row, other} - bad_rows:
                    violations.append(
                        (r, "table_writes_disjoint",
                         f"page {pg} written by rows {other} and {row}")
                    )
                bad_rows.update({row, other})
            else:
                writer_of[pg] = row
    for row, pages in writes.items():
        if row in bad_rows:
            continue
        pset = set(pages.tolist())
        for other, lv in live.items():
            if other == row:
                continue
            shared = pset.intersection(lv.tolist())
            if shared:
                violations.append(
                    (row, "table_writes_disjoint",
                     f"page {sorted(shared)[0]} written by row {row} while "
                     f"live in row {other}")
                )
                bad_rows.add(row)
                break
    if violations:
        raise GuardError(violations)


def attention(q, k, v, *, causal: bool = False, sm_scale=None, **xla_kw):
    """Contiguous GQA attention (ops.py:211): ``q`` (B, Hq, Sq, Dk) over
    ``k`` (B, Hkv, Sk, Dk) and ``v`` (B, Hkv, Sk, Dv) -> (B, Hq, Sq, Dv),
    differentiable.  Dv differs from Dk for MLA's expanded heads
    (``layers.mla_full``); the reference's Pallas route takes one head_dim
    only, its XLA route (``ref.attention``) any Dv.

    A window, ``kv_len`` or a soft cap takes the plain version, as the
    reference routes them to ``ref.attention``; so does a CPU tensor.  A CUDA
    tensor otherwise takes the flash kernel through
    :class:`~.flash_attention.FlashAttentionFn`.  ``out_dtype`` casts the
    result on both routes, and ``q_chunk`` streams only the plain one.
    DTensors on a mesh take :func:`sharded_attention`."""
    if isinstance(q, DTensor):
        return sharded_attention(q, k, v, causal=causal, sm_scale=sm_scale, **xla_kw)
    if (not q.is_cuda
            or xla_kw.get("window") is not None
            or xla_kw.get("kv_len") is not None
            or xla_kw.get("logit_soft_cap") is not None):
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale, **xla_kw)
    out = _fa.FlashAttentionFn.apply(q, k, v, causal, sm_scale)
    out_dtype = xla_kw.get("out_dtype")
    return out if out_dtype is None else out.to(out_dtype)


def _even(mesh, placements, shape, dim) -> bool:
    parts = math.prod(mesh.size(i) for i, p in enumerate(placements) if p == Shard(dim))
    return shape[dim] % parts == 0


def _attention_layout(mesh, q_placements, q_shape, hkv: int):
    """How :func:`sharded_attention` spreads (q, k/v, k/v's gradient) over
    ``mesh``, from the placements q arrives with (the ``attn_q`` hint's):
    q keeps a batch (0), head (1) or sequence (2) shard that is even, and
    anything else is replicated.  K/V follow a batch shard, and a head
    shard when their heads divide as q's do; otherwise each rank holds
    them whole, and the gradient each rank computes for them is a partial
    sum (``Partial``): its own heads' or query rows' share."""
    hq = q_shape[1]
    qp = [p if isinstance(p, Shard) and p.dim < 3 else Replicate() for p in q_placements]
    for d in (0, 1, 2):
        if not _even(mesh, qp, q_shape, d):
            qp = [Replicate() if p == Shard(d) else p for p in qp]
    parts = math.prod(mesh.size(i) for i, p in enumerate(qp) if p == Shard(1))
    follow = hkv % parts == 0
    if not follow:  # each rank's q heads must stay within whole kv groups
        hl, g = hq // parts, hq // hkv
        if not (g % hl == 0 or hl % g == 0):
            qp = [Replicate() if p == Shard(1) else p for p in qp]
            follow = True
    kp, gp = [], []
    for p in qp:
        if p == Shard(0) or (p == Shard(1) and follow):
            kp.append(p)
            gp.append(p)
        else:
            kp.append(Replicate())
            gp.append(Replicate() if p == Replicate() else Partial())
    return tuple(qp), tuple(kp), tuple(gp)


def sharded_attention(q, k, v, *, causal: bool = False, sm_scale=None, **xla_kw):
    """:func:`attention` of DTensors: each rank runs the kernel (or, on the
    CPU, the plain version) on its own shard through ``local_map``; DTensor
    has no rule for the ctypes kernel.  Batch and head shards are
    independent.  A rank holding query rows ``[o, o + n)`` of a sequence
    shard (``make_hints``' fallback when the heads do not divide) sees, for
    a causal mask, only keys ``[0, o + n + Sk - Sq)``: the kernels align a
    causal mask to the end of the keys, so K/V are cut there first.  A rank
    holding a block of q heads whose K/V are whole picks their kv heads."""
    from ..distributed import sharding as shd

    mesh = q.device_mesh
    whole = [Replicate()] * mesh.ndim
    k, v = (t if isinstance(t, DTensor) else
            DTensor.from_local(t, mesh, whole, run_check=False) for t in (k, v))
    hq, sq, hkv, sk = q.shape[1], q.shape[2], k.shape[1], k.shape[2]
    qp, kp, gp = _attention_layout(mesh, q.placements, tuple(q.shape), hkv)
    h0 = shd.shard_offset(mesh, qp, hq, 1)
    o = shd.shard_offset(mesh, qp, sq, 2)
    heads_split = Shard(1) in qp and kp[qp.index(Shard(1))] != Shard(1)

    def run(ql, kl, vl):
        if heads_split:
            g = hq // hkv
            k0, k1 = h0 // g, (h0 + ql.shape[1] - 1) // g + 1
            kl, vl = kl[:, k0:k1], vl[:, k0:k1]
        if Shard(2) in qp and causal:
            cut = o + ql.shape[2] + sk - sq
            kl, vl = kl[:, :, :cut], vl[:, :, :cut]
        return attention(ql, kl, vl, causal=causal, sm_scale=sm_scale, **xla_kw)

    return shd.local_call(run, (q, k, v), (qp, kp, kp), qp, mesh,
                          in_grad_placements=(qp, gp, gp))


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    sm_scale=None, window: Optional[int] = None,
                    logit_soft_cap=None):
    """Single-token decode attention over a paged KV pool (shapes in
    kernels/paged_attention.py)."""
    if logit_soft_cap is not None:
        return ref.paged_attention(
            q, k_pages, v_pages, block_tables, seq_lens, sm_scale=sm_scale,
            window=window, logit_soft_cap=logit_soft_cap,
        )
    return _pa.paged_attention(q, k_pages, v_pages, block_tables, seq_lens,
                               sm_scale=sm_scale, window=window)


def prefill_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                      start_lens, chunk_lens, *, sm_scale=None,
                      window: Optional[int] = None, logit_soft_cap=None,
                      plain: bool = False):
    """Chunked-prefill attention over a paged KV pool.

    ``q``/``k_new``/``v_new`` are the chunk's (B, H*, C, D) projections;
    ``start_lens`` (B,) counts prior resident tokens (the chunk's write
    offset) and ``chunk_lens`` (B,) the live tokens within the chunk.
    Returns ``(out, k_pages, v_pages)``: the chunk's K/V are written into the
    given pools in place, through the block table.  ``plain`` takes the
    plain version whatever the shape.
    """
    if _prefill_takes_kernel("prefill_attention", plain, q.shape[2],
                             k_pages.shape[2], block_tables.shape[1],
                             logit_soft_cap):
        return _pf.prefill_attention(
            q, k_new, v_new, k_pages, v_pages, block_tables, start_lens,
            chunk_lens, sm_scale=sm_scale, window=window)
    return ref.paged_prefill_attention(
        q, k_new, v_new, k_pages, v_pages, block_tables, start_lens,
        chunk_lens, sm_scale=sm_scale, window=window,
        logit_soft_cap=logit_soft_cap)


def _prefill_takes_kernel(name, plain, chunk, page_size, max_pages,
                          logit_soft_cap) -> bool:
    """The reference's rule for a chunked prefill's kernel, unless the
    caller asked for the plain version (counted in ``PLAIN_PREFILL``)."""
    if plain:
        PLAIN_PREFILL[name] += 1
        return False
    return (logit_soft_cap is None and chunk % page_size == 0
            and chunk // page_size <= max_pages)


def paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                          block_tables, seq_lens, *, fmt: str = "int8",
                          sm_scale=None, window: Optional[int] = None,
                          logit_soft_cap=None):
    """Quantized paged decode (ops.py:343): packed int8 / int4 pools plus
    per-token scale columns (shapes in kernels/paged_attention_quant.py)."""
    if logit_soft_cap is not None:
        return ref.paged_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_lens,
            fmt=fmt, sm_scale=sm_scale, window=window,
            logit_soft_cap=logit_soft_cap)
    return _paq.paged_attention_quant(
        q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_lens,
        fmt=fmt, sm_scale=sm_scale, window=window)


def prefill_attention_quant(q, k_new, v_new, k_pages, v_pages, k_scales,
                            v_scales, block_tables, start_lens, chunk_lens, *,
                            fmt: str = "int8", sm_scale=None,
                            window: Optional[int] = None, logit_soft_cap=None,
                            plain: bool = False):
    """Quantized chunked prefill (ops.py:373): the chunk's fp K/V are
    quantized per token here, the write-time quantization point, with scales
    in the scale pools' dtype; then the kernel (or the plain path) attends
    the dequantized round trip and writes packed bytes plus scales into the
    four pools in place.  Returns ``(out, k_pages, v_pages, k_scales,
    v_scales)``."""
    kq, ks = ref.quantize_rows(k_new, fmt)
    vq, vs = ref.quantize_rows(v_new, fmt)
    ks, vs = ks.to(k_scales.dtype), vs.to(v_scales.dtype)
    args = (q, kq, vq, ks, vs, k_pages, v_pages, k_scales, v_scales,
            block_tables, start_lens, chunk_lens)
    if _prefill_takes_kernel("prefill_attention_quant", plain, q.shape[2],
                             k_pages.shape[2], block_tables.shape[1],
                             logit_soft_cap):
        return _pfq.prefill_attention_quant(*args, fmt=fmt, sm_scale=sm_scale,
                                            window=window)
    return ref.paged_prefill_attention_quant(
        *args, fmt=fmt, sm_scale=sm_scale, window=window,
        logit_soft_cap=logit_soft_cap)


def mla_paged(q_lat, q_pe, ckv_pages, kpe_pages, block_tables, seq_lens, *,
              sm_scale=None, window: Optional[int] = None,
              logit_soft_cap=None):
    """Paged MLA decode (ops.py:472): latent queries (B, H, R) and rope
    queries (B, H, Dpe) against the latent and rope pools (shapes in
    kernels/mla_paged.py)."""
    if logit_soft_cap is not None:
        return ref.mla_paged(q_lat, q_pe, ckv_pages, kpe_pages, block_tables,
                             seq_lens, sm_scale=sm_scale, window=window,
                             logit_soft_cap=logit_soft_cap)
    return _mp.mla_paged(q_lat, q_pe, ckv_pages, kpe_pages, block_tables,
                         seq_lens, sm_scale=sm_scale, window=window)


def mla_prefill(q_lat, q_pe, ckv_new, kpe_new, ckv_pages, kpe_pages,
                block_tables, start_lens, chunk_lens, *, sm_scale=None,
                window: Optional[int] = None, logit_soft_cap=None,
                plain: bool = False):
    """MLA chunked prefill over the latent pools (ops.py:506): ``q_lat``/
    ``q_pe`` (B, H, C, .), the chunk's ``ckv_new``/``kpe_new`` (B, C, .).
    Returns ``(out (B, H, C, R), ckv_pages, kpe_pages)``: the chunk's latents
    are written into the given pools in place, through the block table."""
    args = (q_lat, q_pe, ckv_new, kpe_new, ckv_pages, kpe_pages, block_tables,
            start_lens, chunk_lens)
    if _prefill_takes_kernel("mla_prefill", plain, q_lat.shape[2],
                             ckv_pages.shape[1], block_tables.shape[1],
                             logit_soft_cap):
        return _mf.mla_prefill(*args, sm_scale=sm_scale, window=window)
    return ref.paged_mla_prefill(*args, sm_scale=sm_scale, window=window,
                                 logit_soft_cap=logit_soft_cap)


def mla_paged_quant(q_lat, q_pe, ckv_pages, kpe_pages, ckv_scales, kpe_scales,
                    block_tables, seq_lens, *, fmt: str = "int8",
                    sm_scale=None, window: Optional[int] = None,
                    logit_soft_cap=None):
    """Quantized paged MLA decode (ops.py:575): packed latent and rope pools
    with a per-token scale pool each (shapes in kernels/mla_paged_quant.py)."""
    args = (q_lat, q_pe, ckv_pages, kpe_pages, ckv_scales, kpe_scales,
            block_tables, seq_lens)
    if logit_soft_cap is not None:
        return ref.mla_paged_quant(*args, fmt=fmt, sm_scale=sm_scale,
                                   window=window, logit_soft_cap=logit_soft_cap)
    return _mpq.mla_paged_quant(*args, fmt=fmt, sm_scale=sm_scale, window=window)


def mla_prefill_quant(q_lat, q_pe, ckv_new, kpe_new, ckv_pages, kpe_pages,
                      ckv_scales, kpe_scales, block_tables, start_lens,
                      chunk_lens, *, fmt: str = "int8", sm_scale=None,
                      window: Optional[int] = None, logit_soft_cap=None,
                      plain: bool = False):
    """Quantized MLA chunked prefill (ops.py:611): the chunk's latent and
    rope rows are quantized per token here, the write-time quantization
    point, with scales in the scale pools' dtype; then the kernel (or the
    plain path) attends the dequantized round trip and writes packed bytes
    plus both scales into the four pools in place.  Returns ``(out,
    ckv_pages, kpe_pages, ckv_scales, kpe_scales)``."""
    cq, cs = ref.quantize_rows(ckv_new, fmt)
    pq, ps = ref.quantize_rows(kpe_new, fmt)
    args = (q_lat, q_pe, cq, pq, cs.to(ckv_scales.dtype), ps.to(kpe_scales.dtype),
            ckv_pages, kpe_pages, ckv_scales, kpe_scales, block_tables,
            start_lens, chunk_lens)
    if _prefill_takes_kernel("mla_prefill_quant", plain, q_lat.shape[2],
                             ckv_pages.shape[1], block_tables.shape[1],
                             logit_soft_cap):
        return _mfq.mla_prefill_quant(*args, fmt=fmt, sm_scale=sm_scale,
                                      window=window)
    return ref.paged_mla_prefill_quant(*args, fmt=fmt, sm_scale=sm_scale,
                                       window=window,
                                       logit_soft_cap=logit_soft_cap)


def chunk_state(b_mat, x, da_cum):
    """Mamba-2 per-chunk states (ops.py:731): ``b_mat`` (..., C, L, N),
    ``x`` (..., C, L, P), ``da_cum`` (..., C, L) -> (..., C, N, P) fp32,
    differentiable, through :class:`~.chunk_state.ChunkStateFn` (the kernel
    for CUDA tensors, its plain version for CPU ones)."""
    return _cst.ChunkStateFn.apply(b_mat, x, da_cum.float())


def chunk_scan(c_mat, b_mat, x, da_cum, prev_states):
    """Mamba-2 within-chunk scan plus the carried states (ops.py:744):
    ``c_mat``/``b_mat`` (..., C, L, N), ``x`` (..., C, L, P), ``da_cum``
    (..., C, L), ``prev_states`` (..., C, N, P) -> (..., C, L, P) in x's
    dtype, differentiable, through :class:`~.chunk_scan.ChunkScanFn`."""
    return _csc.ChunkScanFn.apply(c_mat, b_mat, x, da_cum.float(),
                                  prev_states.float())


def ssd(c_mat, b_mat, x, dt, a_log, *, chunk: int = 64):
    """The full SSD pass composed from the two kernels and the plain
    inter-chunk recurrence (ops.py:759): ``c_mat``/``b_mat`` (B, S, N),
    ``x`` (B, S, P), ``dt`` (B, S), ``a_log`` a scalar -> (B, S, P) in x's
    dtype."""
    bsz, s, _ = c_mat.shape
    p = x.shape[-1]
    nc = s // chunk
    rs = lambda t: t.reshape(bsz, nc, chunk, *t.shape[2:])  # noqa: E731
    da = dt * (-torch.exp(torch.as_tensor(a_log, dtype=torch.float32,
                                          device=dt.device)))
    da_cum = torch.cumsum(da.reshape(bsz, nc, chunk), dim=-1)
    states = chunk_state(rs(b_mat), rs(x), da_cum)
    incoming = ref.state_recurrence(states, da_cum[..., -1])
    y = chunk_scan(rs(c_mat), rs(b_mat), rs(x), da_cum, incoming)
    return y.reshape(bsz, s, p).to(x.dtype)


def rmsnorm(x, weight, eps: float = 1e-6):
    return ref.rmsnorm(x, weight, eps)


# ---------------------------------------------------------------------------
# the kernel library (ops.py:184, :450, :689)
# ---------------------------------------------------------------------------


def matmul(a, b, *, out_dtype=None):
    """GEMM (ops.py:184): ``a`` (M, K) @ ``b`` (K, N) with fp32
    accumulation -> (M, N) of ``out_dtype`` (default ``a``'s dtype)."""
    return _mm.matmul(a, b, out_dtype=out_dtype)


def dequant_matmul(a, b_packed, *, fmt: str = "int4", scales=None, out_dtype=None):
    """Weight-only quantized GEMM (ops.py:689): ``a`` (M, K) @
    dequant(``b_packed``)^T with B stored (N, K // pack) int8 in ``fmt``
    (int4, int2, nf4 or int8) and optional (N, K // group) ``scales`` ->
    (M, N) of ``out_dtype`` (default ``a``'s dtype)."""
    return _dq.dequant_matmul(a, b_packed, fmt, scales, out_dtype)


def mla(q, q_pe, kv, k_pe, *, sm_scale=None):
    """Contiguous FlashMLA decode (ops.py:450): ``q`` (B, Hq, D), ``q_pe``
    (B, Hq, Dpe) over ``kv`` (B, S, Hkv, D) and ``k_pe`` (B, S, Hkv, Dpe)
    -> (B, Hq, D)."""
    return _mla.mla(q, q_pe, kv, k_pe, sm_scale=sm_scale)
