"""Contiguous MLA decode (FlashMLA): the wrapper around ``csrc/mla.cu``.

Counterpart of ``repro.kernels.mla.mla_program`` (repro/kernels/mla.py:33,
the paper's Fig. 18): latent queries ``q`` (B, Hq, D) and rotary queries
``q_pe`` (B, Hq, Dpe) against a contiguous latent cache ``kv`` (B, S, Hkv,
D) and ``k_pe`` (B, S, Hkv, Dpe), Hq / Hkv heads a latent head, V the
latent itself; fp32, bf16 or fp16.  The plain version is ``ref.mla``; this
wrapper takes it for CPU tensors only.  For a CUDA tensor it launches the
kernel or raises, on one of two paths (:func:`tensor_core_path`):

* ``wgmma``, bf16 / fp16 at D 512 with D + Dpe a multiple of 64 up to
  ``TC_MAX_DK`` (the paper's shapes, deepseek-v2-lite's heads): 64 heads of
  a latent head a block, a TMA producer and two consumer warpgroups over
  tiles of ``TC_KEYS`` keys, P as the 16-bit pair hi + lo (``csrc/mla.cu``
  has the design); counted in ``KERNEL.tc_launches``;
* CUDA cores, everything else: up to 16 heads of a latent head a block
  (``mla_paged.head_block``: 128 heads x 512 fp32 accumulators do not fit
  one block).

Both read Q and the cache through their own 16-byte loads or TMA, so every
tensor must be 16-byte aligned.

The same module holds the TPU programs themselves: the tile programs that
the port's compiler (``repro_torch.core``) compiles with ``target="cuda"``
or runs with ``target="reference"``: ``mla_program`` (the paper's Fig. 18,
repro/kernels/mla.py:33), the paged decode ``mla_paged_program`` (:110), the
chunked prefill ``mla_prefill_program`` (:180) and their quantized twins
``mla_paged_quant_program`` (:301) and ``mla_prefill_quant_program`` (:374),
with the JAX module's ``PARITY_CASES`` and ``parity_inputs``.  The prefills
pack their queries chunk-major with the heads (row ``i * heads + h``).  At
deepseek-v2-lite-16B's serving width a prefill block's tiles outgrow the
card's shared memory; compiled with ``Schedule(workspace=True)`` the largest
go to a per-block global workspace (``core.schedule.plan_vmem``).

:func:`fig18_plain` is the plain version of Fig. 18's own arithmetic (the
max taken per tile of keys, P rounded to the program's dtype before P.V),
the gate of the emitted FlashMLA at bf16: ``ref.mla`` keeps P in fp32.

No ``from __future__ import annotations`` here: the tracer reads the
``T.Tensor`` annotation objects of a ``@T.prim_func``.
"""

import ctypes
import math
from typing import Optional

import torch

from ..core import TileProgram
from ..core import lang as T
from . import attention_core as AC
from . import ref
from .build import Kernel, check
from .matmul import DTYPES
from .mla_paged import head_block

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla", "mla_launch", [_I, _I, _P, _P, _P, _P, _P, *([_I] * 7), ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:33",
)
TC_RANK = 512  # the latent width the wgmma kernel is built for
TC_KEYS = 32  # keys a tile of its walk
TC_MAX_DK = 832  # the widest D + Dpe whose Q and two key stages fit shared memory


def tensor_core_path(dtype: torch.dtype, d: int, pe: int) -> bool:
    """Whether a launch takes the wgmma kernel (``csrc/mla.cu``'s
    ``tc_takes``): 16-bit elements at latent width 512 with D + Dpe a
    multiple of 64 (the 64-column TMA boxes) up to ``TC_MAX_DK``.  Batch,
    heads, latent heads and sequence length do not matter."""
    return (dtype in (torch.bfloat16, torch.float16) and d == TC_RANK and pe > 0
            and (d + pe) % 64 == 0 and d + pe <= TC_MAX_DK)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"mla kernel: {msg}")


def mla(q: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor, *,
        sm_scale: Optional[float] = None) -> torch.Tensor:
    """-> (B, Hq, D) in ``q``'s dtype; ``sm_scale`` defaults to
    1 / sqrt(D + Dpe)."""
    if not q.is_cuda:
        return ref.mla(q, q_pe, kv, k_pe, sm_scale=sm_scale)
    _require(q.dim() == 3 and q_pe.dim() == 3 and kv.dim() == 4 and k_pe.dim() == 4,
             "q, q_pe (B, Hq, .) and kv, k_pe (B, S, Hkv, .)")
    b, hq, d = q.shape
    pe = q_pe.shape[-1]
    s, hkv = kv.shape[1], kv.shape[2]
    _require(tuple(q_pe.shape) == (b, hq, pe) and tuple(kv.shape) == (b, s, hkv, d)
             and tuple(k_pe.shape) == (b, s, hkv, pe),
             f"shapes q {tuple(q.shape)}, q_pe {tuple(q_pe.shape)}, kv {tuple(kv.shape)}, "
             f"k_pe {tuple(k_pe.shape)}")
    _require(hkv >= 1 and hq % hkv == 0, f"{hq} query heads over {hkv} latent heads")
    _require(s >= 1 and 1 <= b <= 65535, f"batch {b}, seq {s}")
    for name, t in (("q_pe", q_pe), ("kv", kv), ("k_pe", k_pe)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        _require(t.dtype == q.dtype, f"{name} is {t.dtype}, q {q.dtype}")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32, bfloat16 or float16)")
    vec = 16 // q.element_size()
    _require(d % vec == 0 and pe % vec == 0,
             f"D {d} and Dpe {pe} must be multiples of 16 bytes' worth of elements")
    q, q_pe, kv, k_pe = (t.contiguous() for t in (q, q_pe, kv, k_pe))
    _require(all(t.data_ptr() % 16 == 0 for t in (q, q_pe, kv, k_pe)),
             "q, q_pe, kv and k_pe must be 16-byte aligned")
    tc = tensor_core_path(q.dtype, d, pe)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d + pe)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), q_pe.data_ptr(), kv.data_ptr(),
            k_pe.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, pe, head_block(hq // hkv),
            scale, stream)
    check(rc, "mla")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out


LOG2E = 1.44269504  # the programs' exp2 scaling (log2(e))


def fig18_plain(q: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor, *,
                block_N: int = 128, sm_scale: Optional[float] = None) -> torch.Tensor:
    """The plain version of :func:`mla_program`'s own arithmetic, at its
    ``block_N``: for each tile of keys the scores ``q.kv^T + q_pe.k_pe^T``
    in fp32, the max taken over that tile alone (``running_max=False``),
    the old accumulator rescaled from the previous tile's max, ``l``
    summing the fp32 probabilities, and P rounded to the program's dtype
    (``q``'s, the ``S_shared`` stage) before P.V in fp32; the output divided
    by ``l`` and rounded to ``q``'s dtype.  Vectorized over batch and heads,
    one loop over the key tiles.  Shapes as :func:`mla`."""
    b, hq, d = q.shape
    pe = q_pe.shape[-1]
    s, hkv = kv.shape[1], kv.shape[2]
    if s % block_N:
        raise ValueError("seqlen_kv must divide block_N")
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(d + pe)) * LOG2E
    qf = q.float().reshape(b, hkv, hq // hkv, d)
    qpf = q_pe.float().reshape(b, hkv, hq // hkv, pe)
    acc = torch.zeros_like(qf)
    total = torch.zeros(qf.shape[:-1], dtype=torch.float32, device=q.device)
    prev = torch.full_like(total, -math.inf)
    for k0 in range(0, s, block_N):
        kt = kv[:, k0:k0 + block_N].float().transpose(1, 2)  # (B, Hkv, N, D)
        pt = k_pe[:, k0:k0 + block_N].float().transpose(1, 2)
        sc = qf @ kt.transpose(-1, -2) + qpf @ pt.transpose(-1, -2)
        cur = sc.amax(-1)
        alpha = torch.exp2(prev.clamp_min(AC.NEG_CLAMP) * scale - cur * scale)
        p = torch.exp2(sc * scale - cur[..., None] * scale)
        total = total * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + p.to(q.dtype).float() @ kt
        prev = cur
    return (acc / total[..., None]).reshape(b, hq, d).to(q.dtype)


def mla_program(
    batch: int,
    heads: int,
    kv_head_num: int,
    seqlen_kv: int,
    dim: int,
    pe_dim: int,
    block_N: int = 128,
    block_H: int = 64,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
    swizzle: Optional[int] = None,
) -> TileProgram:
    if seqlen_kv % block_N:
        raise ValueError("seqlen_kv must divide block_N")
    kv_group_num = heads // kv_head_num
    VALID_BLOCK_H = min(block_H, kv_group_num)
    if heads % VALID_BLOCK_H:
        raise ValueError("the valid head block must divide heads")
    scale = (
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(dim + pe_dim)
    ) * 1.44269504  # log2(e)

    @T.prim_func
    def FlashMLA(
        Q: T.Tensor((batch, heads, dim), dtype),
        Q_pe: T.Tensor((batch, heads, pe_dim), dtype),
        KV: T.Tensor((batch, seqlen_kv, kv_head_num, dim), dtype),
        K_pe: T.Tensor((batch, seqlen_kv, kv_head_num, pe_dim), dtype),
        Output: T.Tensor((batch, heads, dim), dtype),
    ):
        with T.Kernel(batch, heads // VALID_BLOCK_H, threads=256) as (bx, by):
            Q_shared = T.alloc_shared((VALID_BLOCK_H, dim), dtype)
            S_shared = T.alloc_shared((VALID_BLOCK_H, block_N), dtype)
            Q_pe_shared = T.alloc_shared((VALID_BLOCK_H, pe_dim), dtype)
            KV_shared = T.alloc_shared((block_N, dim), dtype)
            K_pe_shared = T.alloc_shared((block_N, pe_dim), dtype)
            acc_s = T.alloc_fragment((VALID_BLOCK_H, block_N), accum_dtype)
            # the paper's Fig. 18 formulation: per-block max (not running),
            # probabilities staged through shared memory for the P·V GEMM
            ons = AC.OnlineSoftmax(VALID_BLOCK_H, dim, scale, accum_dtype,
                                   running_max=False, clamp_current=False,
                                   shared_scores=S_shared)

            cur_kv_head = by // (kv_group_num // VALID_BLOCK_H)
            if swizzle:
                T.use_swizzle(swizzle)

            T.copy(Q[bx, by * VALID_BLOCK_H : (by + 1) * VALID_BLOCK_H, :], Q_shared)
            T.copy(
                Q_pe[bx, by * VALID_BLOCK_H : (by + 1) * VALID_BLOCK_H, :], Q_pe_shared
            )

            def load_kv(k):
                T.copy(
                    KV[bx, k * block_N : (k + 1) * block_N, cur_kv_head, :], KV_shared
                )
                T.copy(
                    K_pe[bx, k * block_N : (k + 1) * block_N, cur_kv_head, :],
                    K_pe_shared,
                )
                return KV_shared, KV_shared  # V is the latent itself

            AC.attend(
                ons, acc_s, block_N, T.ceildiv(seqlen_kv, block_N), load_kv,
                lambda s, ks, k: AC.scores(
                    s, Q_shared, ks, extra=[(Q_pe_shared, K_pe_shared)]
                ),
                num_stages=num_stages,
            )
            ons.finalize(Output[bx, by * VALID_BLOCK_H : (by + 1) * VALID_BLOCK_H, :])

    return FlashMLA


def mla_paged_program(
    slots: int,
    heads: int,
    dim: int,
    pe_dim: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    block_H: int = 64,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> TileProgram:
    """Paged MLA decode: one latent query row block per slot, latent+rope
    pages gathered through the block table (an int32 operand), ragged mask
    against each slot's live length (optionally sliding-window limited).
    The latent is shared by every query head, so there is no kv-head grid
    axis — the pool is ``(num_pages, page_size, dim)``."""
    bh = min(block_H, heads)
    if heads % bh:
        raise ValueError("the head block must divide heads")
    scale = (
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(dim + pe_dim)
    ) * 1.44269504  # log2(e)

    @T.prim_func
    def PagedMLA(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Lens: T.ScalarTensor((slots,), "int32"),
        Q: T.Tensor((slots, heads, dim), dtype),
        Q_pe: T.Tensor((slots, heads, pe_dim), dtype),
        KVPages: T.Tensor((num_pages, page_size, dim), dtype),
        KPePages: T.Tensor((num_pages, page_size, pe_dim), dtype),
        Output: T.Tensor((slots, heads, dim), dtype),
    ):
        with T.Kernel(heads // bh, slots) as (by, bz):
            Q_shared = T.alloc_shared((bh, dim), dtype)
            Q_pe_shared = T.alloc_shared((bh, pe_dim), dtype)
            KV_shared = T.alloc_shared((page_size, dim), dtype)
            K_pe_shared = T.alloc_shared((page_size, pe_dim), dtype)
            acc_s = T.alloc_fragment((bh, page_size), accum_dtype)
            # safe_div: empty slots (len 0) divide by the floor -> zeros
            ons = AC.OnlineSoftmax(bh, dim, scale, accum_dtype, safe_div=True)

            T.copy(Q[bz, by * bh, 0], Q_shared)
            T.copy(Q_pe[bz, by * bh, 0], Q_pe_shared)

            def load_kv(k):
                # the paged gather: page index loaded from the block table
                T.copy(KVPages[Tables[bz, k], 0, 0], KV_shared)
                T.copy(KPePages[Tables[bz, k], 0, 0], K_pe_shared)
                return KV_shared, KV_shared  # V is the latent itself

            def mask(k):
                return AC.ragged(Lens[bz], lambda j: k * page_size + j, window)

            AC.attend(
                ons, acc_s, page_size, max_pages, load_kv,
                lambda s, ks, k: AC.scores(
                    s, Q_shared, ks, extra=[(Q_pe_shared, K_pe_shared)]
                ),
                mask, num_stages=num_stages,
            )
            ons.finalize(Output[bz, by * bh, 0])

    return PagedMLA


def mla_prefill_program(
    slots: int,
    heads: int,
    dim: int,
    pe_dim: int,
    chunk: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> TileProgram:
    """MLA chunked prefill: a (slots, chunk) block of prompt latents attends
    prior latent pages (gathered through the block table) plus itself
    causally, and writes its own latent/rope pages from inside the kernel.

    Queries are packed chunk-major with their head — row ``i * heads + h``
    is chunk position ``i`` of head ``h`` — so each grid cell attends a
    ``(page_size * heads, dim)`` query tile (the prefill_attention packing
    with the whole head count as the group).  Same contract as
    prefill_attention.py: ``chunk % page_size == 0``, live ``Starts``
    page-aligned, dead chunk pages land in the reserved garbage page 0.
    """
    if chunk % page_size:
        raise ValueError("chunk must be a multiple of page_size")
    cpp = chunk // page_size  # chunk pages written per slot
    rows = page_size * heads  # query rows per grid cell (chunk-major packed)
    scale = (
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(dim + pe_dim)
    ) * 1.44269504  # log2(e)

    @T.prim_func
    def PrefillMLA(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Starts: T.ScalarTensor((slots,), "int32"),  # prior tokens (page-aligned)
        Lens: T.ScalarTensor((slots,), "int32"),  # live tokens in the chunk
        Q: T.Tensor((slots, chunk * heads, dim), dtype),
        Q_pe: T.Tensor((slots, chunk * heads, pe_dim), dtype),
        CKV: T.Tensor((slots, chunk, dim), dtype),  # the chunk's own latents
        KPE: T.Tensor((slots, chunk, pe_dim), dtype),
        KVPages: T.Tensor((num_pages, page_size, dim), dtype),
        KPePages: T.Tensor((num_pages, page_size, pe_dim), dtype),
        Output: T.Tensor((slots, chunk * heads, dim), dtype),
    ):
        with T.Kernel(cpp, slots) as (bq, bz):
            Q_shared = T.alloc_shared((rows, dim), dtype)
            Q_pe_shared = T.alloc_shared((rows, pe_dim), dtype)
            Kc_shared = T.alloc_shared((chunk, dim), dtype)
            Pc_shared = T.alloc_shared((chunk, pe_dim), dtype)
            Kp_shared = T.alloc_shared((page_size, dim), dtype)
            Pp_shared = T.alloc_shared((page_size, pe_dim), dtype)
            acc_s = T.alloc_fragment((rows, page_size), accum_dtype)
            acc_c = T.alloc_fragment((rows, chunk), accum_dtype)
            # safe_div: rows past Lens are fully masked -> zeros, not nan
            ons = AC.OnlineSoftmax(rows, dim, scale, accum_dtype,
                                   safe_div=True)

            T.copy(Q[bz, bq * rows, 0], Q_shared)
            T.copy(Q_pe[bz, bq * rows, 0], Q_pe_shared)
            T.copy(CKV[bz, 0, 0], Kc_shared)
            T.copy(KPE[bz, 0, 0], Pc_shared)

            # ---- prior latents, gathered through the block table ---------
            def load_prior(kp):
                T.copy(KVPages[Tables[bz, kp], 0, 0], Kp_shared)
                T.copy(KPePages[Tables[bz, kp], 0, 0], Pp_shared)
                return Kp_shared, Kp_shared  # V is the latent itself

            q_pos = lambda r: Starts[bz] + bq * page_size + r // heads

            def prior_mask(kp):
                k_pos = lambda j: kp * page_size + j
                m = AC.ragged(Starts[bz], k_pos)
                if window is not None:
                    m = AC.both(m, AC.banded(q_pos, k_pos, window))
                return m

            AC.attend(
                ons, acc_s, page_size, max_pages, load_prior,
                lambda s, ks, kp: AC.scores(
                    s, Q_shared, ks, extra=[(Q_pe_shared, Pp_shared)]
                ),
                prior_mask, num_stages=num_stages,
            )

            # ---- the chunk itself (latents straight from the CKV/KPE
            # inputs — never read back through the pages we are writing) ---
            AC.scores(acc_c, Q_shared, Kc_shared, extra=[(Q_pe_shared, Pc_shared)])
            in_pos = lambda r: bq * page_size + r // heads
            cmask = AC.both(
                AC.causal(in_pos, lambda j: j),
                AC.ragged(Lens[bz], lambda j: j),
            )
            if window is not None:
                cmask = AC.both(cmask, AC.banded(in_pos, lambda j: j, window))
            ons.update(acc_c, chunk, Kc_shared, cmask)

            ons.finalize(Output[bz, bq * rows, 0])

            # ---- the paged write: this cell's chunk page, placed through
            # the block table (a table-directed store), same
            # self-defense as prefill_attention.py: dead chunk pages land
            # in the reserved garbage page 0, table index clamped ----------
            live_page = (bq * page_size) < Lens[bz]
            tidx = T.minimum(Starts[bz] // page_size + bq, max_pages - 1)
            dst_page = T.if_then_else(live_page, Tables[bz, tidx], 0)
            T.copy(
                Kc_shared[bq * page_size : bq * page_size + page_size, :],
                KVPages[dst_page, 0, 0],
            )
            T.copy(
                Pc_shared[bq * page_size : bq * page_size + page_size, :],
                KPePages[dst_page, 0, 0],
            )

    return PrefillMLA


def mla_paged_quant_program(
    slots: int,
    heads: int,
    dim: int,
    pe_dim: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    block_H: int = 64,
    fmt: str = "int8",
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> TileProgram:
    """Quantized paged MLA decode: latent *and* rope pools stored packed
    int8 with per-token scales, dequantized inline through the
    :class:`attention_core.DequantStage` composition point.  V is the
    dequantized latent — exactly the fp kernel with ``load_kv`` swapped."""
    bh = min(block_H, heads)
    if heads % bh:
        raise ValueError("the head block must divide heads")
    pack = AC.KV_PACK[fmt]
    scale = (
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(dim + pe_dim)
    ) * 1.44269504  # log2(e)

    @T.prim_func
    def PagedMLAQuant(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Lens: T.ScalarTensor((slots,), "int32"),
        Q: T.Tensor((slots, heads, dim), dtype),
        Q_pe: T.Tensor((slots, heads, pe_dim), dtype),
        KVPages: T.Tensor((num_pages, page_size, dim // pack), "int8"),
        KPePages: T.Tensor((num_pages, page_size, pe_dim // pack), "int8"),
        KVScales: T.Tensor((num_pages, page_size, 1), dtype),
        KPeScales: T.Tensor((num_pages, page_size, 1), dtype),
        Output: T.Tensor((slots, heads, dim), dtype),
    ):
        with T.Kernel(heads // bh, slots) as (by, bz):
            Q_shared = T.alloc_shared((bh, dim), dtype)
            Q_pe_shared = T.alloc_shared((bh, pe_dim), dtype)
            kvq = AC.DequantStage(page_size, dim, fmt, dtype)
            peq = AC.DequantStage(page_size, pe_dim, fmt, dtype)
            acc_s = T.alloc_fragment((bh, page_size), accum_dtype)
            ons = AC.OnlineSoftmax(bh, dim, scale, accum_dtype, safe_div=True)

            T.copy(Q[bz, by * bh, 0], Q_shared)
            T.copy(Q_pe[bz, by * bh, 0], Q_pe_shared)

            def load_kv(k):
                kv = kvq.load(KVPages[Tables[bz, k], 0, 0],
                              KVScales[Tables[bz, k], 0, 0])
                peq.load(KPePages[Tables[bz, k], 0, 0],
                         KPeScales[Tables[bz, k], 0, 0])
                return kv, kv  # V is the dequantized latent itself

            def mask(k):
                return AC.ragged(Lens[bz], lambda j: k * page_size + j, window)

            AC.attend(
                ons, acc_s, page_size, max_pages, load_kv,
                lambda s, ks, k: AC.scores(
                    s, Q_shared, ks, extra=[(Q_pe_shared, peq.out)]
                ),
                mask, num_stages=num_stages,
            )
            ons.finalize(Output[bz, by * bh, 0])

    return PagedMLAQuant


def mla_prefill_quant_program(
    slots: int,
    heads: int,
    dim: int,
    pe_dim: int,
    chunk: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    fmt: str = "int8",
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
    window: Optional[int] = None,
) -> TileProgram:
    """Quantized MLA chunked prefill: the chunk's latents/rope arrive
    pre-quantized (ops.py packs them), attend as the dequantized roundtrip,
    and the packed bytes + scales are written into the pools exactly as
    staged — the prefill_attention_quant composition with MLA's score
    split and the latent as V."""
    if chunk % page_size:
        raise ValueError("chunk must be a multiple of page_size")
    cpp = chunk // page_size
    rows = page_size * heads
    pack = AC.KV_PACK[fmt]
    scale = (
        sm_scale if sm_scale is not None else 1.0 / math.sqrt(dim + pe_dim)
    ) * 1.44269504  # log2(e)

    @T.prim_func
    def PrefillMLAQuant(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Starts: T.ScalarTensor((slots,), "int32"),  # prior tokens (page-aligned)
        Lens: T.ScalarTensor((slots,), "int32"),  # live tokens in the chunk
        Q: T.Tensor((slots, chunk * heads, dim), dtype),
        Q_pe: T.Tensor((slots, chunk * heads, pe_dim), dtype),
        CKV: T.Tensor((slots, chunk, dim // pack), "int8"),
        KPE: T.Tensor((slots, chunk, pe_dim // pack), "int8"),
        CKVScale: T.Tensor((slots, chunk, 1), dtype),
        KPEScale: T.Tensor((slots, chunk, 1), dtype),
        KVPages: T.Tensor((num_pages, page_size, dim // pack), "int8"),
        KPePages: T.Tensor((num_pages, page_size, pe_dim // pack), "int8"),
        KVScales: T.Tensor((num_pages, page_size, 1), dtype),
        KPeScales: T.Tensor((num_pages, page_size, 1), dtype),
        Output: T.Tensor((slots, chunk * heads, dim), dtype),
    ):
        with T.Kernel(cpp, slots) as (bq, bz):
            Q_shared = T.alloc_shared((rows, dim), dtype)
            Q_pe_shared = T.alloc_shared((rows, pe_dim), dtype)
            kc = AC.DequantStage(chunk, dim, fmt, dtype)
            pc = AC.DequantStage(chunk, pe_dim, fmt, dtype)
            kpq = AC.DequantStage(page_size, dim, fmt, dtype)
            ppq = AC.DequantStage(page_size, pe_dim, fmt, dtype)
            acc_s = T.alloc_fragment((rows, page_size), accum_dtype)
            acc_c = T.alloc_fragment((rows, chunk), accum_dtype)
            ons = AC.OnlineSoftmax(rows, dim, scale, accum_dtype,
                                   safe_div=True)

            T.copy(Q[bz, bq * rows, 0], Q_shared)
            T.copy(Q_pe[bz, bq * rows, 0], Q_pe_shared)
            Kc = kc.load(CKV[bz, 0, 0], CKVScale[bz, 0, 0])
            Pc = pc.load(KPE[bz, 0, 0], KPEScale[bz, 0, 0])

            # ---- prior latents: paged gather + inline dequant ------------
            def load_prior(kp):
                ks = kpq.load(KVPages[Tables[bz, kp], 0, 0],
                              KVScales[Tables[bz, kp], 0, 0])
                ppq.load(KPePages[Tables[bz, kp], 0, 0],
                         KPeScales[Tables[bz, kp], 0, 0])
                return ks, ks  # V is the dequantized latent itself

            q_pos = lambda r: Starts[bz] + bq * page_size + r // heads

            def prior_mask(kp):
                k_pos = lambda j: kp * page_size + j
                m = AC.ragged(Starts[bz], k_pos)
                if window is not None:
                    m = AC.both(m, AC.banded(q_pos, k_pos, window))
                return m

            AC.attend(
                ons, acc_s, page_size, max_pages, load_prior,
                lambda s, ks, kp: AC.scores(
                    s, Q_shared, ks, extra=[(Q_pe_shared, ppq.out)]
                ),
                prior_mask, num_stages=num_stages,
            )

            # ---- the chunk itself (dequantized roundtrip) ----------------
            AC.scores(acc_c, Q_shared, Kc, extra=[(Q_pe_shared, Pc)])
            in_pos = lambda r: bq * page_size + r // heads
            cmask = AC.both(
                AC.causal(in_pos, lambda j: j),
                AC.ragged(Lens[bz], lambda j: j),
            )
            if window is not None:
                cmask = AC.both(cmask, AC.banded(in_pos, lambda j: j, window))
            ons.update(acc_c, chunk, Kc, cmask)

            ons.finalize(Output[bz, bq * rows, 0])

            # ---- the paged write: packed bytes + scales as staged --------
            live_page = (bq * page_size) < Lens[bz]
            tidx = T.minimum(Starts[bz] // page_size + bq, max_pages - 1)
            dst_page = T.if_then_else(live_page, Tables[bz, tidx], 0)
            T.copy(
                kc.packed_rows(bq * page_size, bq * page_size + page_size),
                KVPages[dst_page, 0, 0],
            )
            T.copy(
                pc.packed_rows(bq * page_size, bq * page_size + page_size),
                KPePages[dst_page, 0, 0],
            )
            T.copy(
                kc.scale_shared[bq * page_size : bq * page_size + page_size, :],
                KVScales[dst_page, 0, 0],
            )
            T.copy(
                pc.scale_shared[bq * page_size : bq * page_size + page_size, :],
                KPeScales[dst_page, 0, 0],
            )

    return PrefillMLAQuant


# Tiny-shape configs of the backend-parity suite (the JAX module's):
# the contiguous Fig. 18 kernel, the paged decode
# kernel (ragged lens through a block table) and the chunked-prefill kernel
# (multi-page chunk, in-kernel page writes).  The paged cases take their
# inputs from the override below — tables must hold valid page ids.  The
# _quant cases store both latent and rope pools packed (int8 / int4).
PARITY_CASES = [
    (
        "mla",
        dict(batch=1, heads=4, kv_head_num=1, seqlen_kv=32, dim=16, pe_dim=8,
             block_N=16, block_H=2),
    ),
    (
        "mla_paged",
        dict(slots=3, heads=4, dim=16, pe_dim=8, page_size=16, max_pages=2,
             num_pages=8, block_H=2),
    ),
    (
        "mla_paged_windowed",
        dict(slots=3, heads=4, dim=16, pe_dim=8, page_size=16, max_pages=2,
             num_pages=8, block_H=2, window=12),
    ),
    (
        "mla_prefill",
        dict(slots=2, heads=2, dim=16, pe_dim=8, chunk=32, page_size=16,
             max_pages=4, num_pages=10),
    ),
    (
        "mla_prefill_windowed",
        dict(slots=2, heads=2, dim=16, pe_dim=8, chunk=32, page_size=16,
             max_pages=4, num_pages=10, window=20),
    ),
    (
        "mla_paged_quant_int8",
        dict(slots=3, heads=4, dim=16, pe_dim=8, page_size=16, max_pages=2,
             num_pages=8, block_H=2, fmt="int8"),
    ),
    (
        "mla_paged_quant_int4",
        dict(slots=2, heads=4, dim=16, pe_dim=8, page_size=16, max_pages=2,
             num_pages=8, block_H=2, fmt="int4"),
    ),
    (
        "mla_prefill_quant_int8",
        dict(slots=2, heads=2, dim=16, pe_dim=8, chunk=32, page_size=16,
             max_pages=4, num_pages=10, fmt="int8"),
    ),
    (
        "mla_prefill_quant_int4",
        dict(slots=2, heads=2, dim=16, pe_dim=8, chunk=32, page_size=16,
             max_pages=4, num_pages=10, fmt="int4"),
    ),
]


def parity_programs():
    for name, cfg in PARITY_CASES:
        if name == "mla":
            yield name, mla_program(**cfg)
        elif name.startswith("mla_paged_quant"):
            yield name, mla_paged_quant_program(**cfg)
        elif name.startswith("mla_paged"):
            yield name, mla_paged_program(**cfg)
        elif name.startswith("mla_prefill_quant"):
            yield name, mla_prefill_quant_program(**cfg)
        else:
            yield name, mla_prefill_program(**cfg)


def parity_inputs(name, program, rng):
    """Valid inputs for the paged parity cases: block tables drawn without
    replacement (each physical page owned by one slot), ragged lens, and —
    for the prefill kernel — page-aligned starts leaving room for the
    chunk's own pages (the serving engine's chunk contract)."""
    if name == "mla":
        return None
    cfg = dict(PARITY_CASES)[name]
    slots, mp, np_ = cfg["slots"], cfg["max_pages"], cfg["num_pages"]
    ps = cfg["page_size"]
    pages = rng.permutation(np_ - 1)[: slots * mp] + 1  # page 0 reserved
    pages = pages.reshape(slots, mp).astype("int32")
    if name.startswith("mla_paged"):
        lens = rng.integers(1, mp * ps + 1, size=slots).astype("int32")
        scalars = [pages, lens]
        nskip = 2
    else:
        chunk = cfg["chunk"]
        cpp = chunk // ps
        starts = (rng.integers(0, mp - cpp + 1, size=slots) * ps).astype("int32")
        # ragged within the last chunk page only (fully-dead chunk pages all
        # write the shared garbage page 0, whose final contents depend on
        # backend grid-walk order — same reasoning as prefill_attention.py)
        lens = rng.integers(chunk - ps + 1, chunk + 1, size=slots).astype("int32")
        scalars = [pages, starts, lens]
        nskip = 3

    def fill(p):
        if str(p.dtype).startswith("int"):
            return rng.integers(-128, 128, size=p.shape).astype(p.dtype)
        if p.name.endswith(("Scale", "Scales")):
            return rng.uniform(0.05, 0.2, size=p.shape).astype(p.dtype)
        return rng.standard_normal(p.shape).astype(p.dtype)

    args = list(scalars)
    for p in program.input_params()[nskip:]:
        args.append(fill(p))
    # in-out page pools ride after the pure inputs (aliased operands)
    for p in program.output_params():
        if p.name in ("KVPages", "KPePages", "KVScales", "KPeScales"):
            args.append(fill(p))
    return args
