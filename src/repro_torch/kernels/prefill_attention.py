"""Chunked-prefill attention: the wrapper around ``csrc/prefill_attention.cu``.

Counterpart of ``repro.kernels.prefill_attention.prefill_attention_program``
(repro/kernels/prefill_attention.py:44): a chunk of C prompt tokens per slot
attends its prior pages through the block table plus itself causally, and
the chunk's K/V land in the pool pages **in place** (the reference returned
updated copies of the pools; here the given pools are written).  The plain
version is ``ref.paged_prefill_attention``; this wrapper takes it for CPU
tensors only.  For a CUDA tensor it launches the kernel or raises.

The kernel has three paths, picked from dtype and shape alone
(:func:`tensor_core_path`).  bf16 at head dim 64 or 128, with 64 keys a
whole number of pages and at most 16384 table entries a slot, runs on the
tensor cores by mma.sync; bf16 at head dim 256 (gemma-7b) where the chunk's
C x G query rows are 64 or 128 (C a multiple of 64) and pages of 8-32 rows
tile its 32-key tiles runs by wgmma fed by TMA, one block a (kv head, slot)
holding the whole chunk (:func:`wgmma_fits`).  Both read q and write the output through their
(B, Hq, C, D) strides, so the transposed views the prefill layer hands over
cost no copy (``KERNEL.tc_launches`` counts those launches).  The rest runs on CUDA cores
over q packed chunk-major with its GQA group, a copy each way.  A block
holds one chunk page of a kv head's GQA group; where those rows do not fit
a block (more than 128 on the tensor cores, more than the H100's 227 KB of
shared memory on the CUDA cores: chatglm3-6b's group of 16 at page 16 is
256 rows), the group is split over :func:`head_split` blocks, the first of
which writes the chunk's pages.

Kernel contract (the serving engine's chunk contract): ``chunk %
page_size == 0``, ``chunk // page_size <= max_pages``, every live slot's
start page-aligned, and pools that started zeroed (several blocks write the
sink page 0 at once).  Past a slot's live length the kernel writes whole
pages where the plain version sends dead positions to page 0, so pool bytes
past ``chunk_lens`` differ between the two.

The same module holds the TPU program itself and its quantized twin,
``prefill_attention_program`` and ``prefill_attention_quant_program``
(repro/kernels/prefill_attention.py:44 and :157), the tile programs that the
port's compiler (``repro_torch.core``) compiles with ``target="cuda"`` or
runs with ``target="reference"``, with their ``PARITY_CASES`` and
``parity_inputs`` (:296 onwards).  They take Q packed chunk-major,
``(slots, kv_heads, chunk * group, head_dim)`` (:func:`packed_queries` with
one part a group), and write the chunk's K/V (packed bytes and scales, for
the twin) into the pools through the block table: in-out operands whose
pages no block writes keep their contents.  A chunk page with no live token
goes to the reserved page 0, and the table index is clamped to the row.
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
from .flash_attention import (MAX_SMEM, WG_D, WG_ROWS, core_smem_bytes, kernel_layout,
                              wgmma_smem_bytes)
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
TC_HEAD_DIMS = (64, 128)  # mma.sync's head dims
TC_KEYS = 64  # keys a tile on the mma.sync path
TC_MAX_ROWS = 128  # query rows a block there (8 warps of 16)
TC_MAX_PAGES = 16384  # table entries a block copies into shared memory
# the wgmma walk's key tiles, which reach the source as macros (an even count
# of stages; 64 x 2 read 4-5% slower, tools/d256_wgmma_ablation.py)
WG_KEYS, WG_STAGES = 32, 4
WG_BLOCK_ROWS = (WG_ROWS, 2 * WG_ROWS)  # a wgmma block's C x G query rows
WG_MIN_PAGE = 8  # a page's TMA box: whole 1024-byte swizzle atoms
KERNEL = Kernel(
    "prefill_attention", "prefill_attention_launch",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, *([ctypes.c_longlong] * 6), _I,
     _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P, _I],
    replaces="src/repro/kernels/prefill_attention.py:44",
    defines={"WG_KEYS": WG_KEYS, "WG_STAGES": WG_STAGES},
)


def mma_fits(page_size: int, max_pages: int) -> bool:
    """The mma.sync path's shape rule at head dim 64 or 128: pages tile its
    64-key tiles and a table row fits shared memory.  Any GQA group fits,
    split over blocks by :func:`head_split`, and the chunk does not
    matter."""
    return TC_KEYS % page_size == 0 and max_pages <= TC_MAX_PAGES


def wgmma_fits(page_size: int, group: int, chunk: int, max_pages: int) -> bool:
    """The wgmma path's shape rule at head dim 256 (``wg_takes`` in
    csrc/prefill_attention.cu): the chunk's C x G query rows one or two
    64-row tiles, each one head's 64 positions (a 64-row TMA box of q at
    one head, so C a multiple of 64), pages of a power of two from 8 rows
    up to a key tile (``WG_KEYS``), and the table row beside the ring in
    shared memory."""
    rows = chunk * group
    return (rows in WG_BLOCK_ROWS and chunk % WG_ROWS == 0
            and WG_MIN_PAGE <= page_size <= WG_KEYS
            and page_size & (page_size - 1) == 0 and chunk % page_size == 0
            and wgmma_smem_bytes(rows // WG_ROWS, WG_KEYS, WG_STAGES, 4 * max_pages) <= MAX_SMEM)


def tensor_core_path(dtype: torch.dtype, head_dim: int, page_size: int,
                     group: int, max_pages: int, chunk: int) -> bool:
    """Whether a launch of ``chunk`` positions takes a tensor-core kernel:
    bf16 at D 64 or 128 where :func:`mma_fits` (mma.sync), or at D 256
    where :func:`wgmma_fits` (wgmma).  Slots, starts and lengths do not
    matter."""
    if dtype != torch.bfloat16:
        return False
    if head_dim == WG_D:
        return wgmma_fits(page_size, group, chunk, max_pages)
    return head_dim in TC_HEAD_DIMS and mma_fits(page_size, max_pages)


def head_split(tc: bool, group: int, page_size: int, head_dim: int,
               name: str = "prefill_attention") -> int:
    """Blocks a kv head's GQA group is split over: the fewest, dividing the
    group, whose page of query rows fits a block (``TC_MAX_ROWS`` on the
    tensor cores, ``MAX_SMEM`` bytes on the CUDA cores).  Raises a
    ``ValueError`` naming the bytes where even one head's page does not
    fit, before any CUDA call."""
    for hs in range(1, group + 1):
        if group % hs:
            continue
        rows = page_size * (group // hs)
        if rows <= TC_MAX_ROWS if tc else (
                core_smem_bytes(rows, page_size, head_dim) <= MAX_SMEM):
            return hs
    need = core_smem_bytes(page_size, page_size, head_dim)
    raise ValueError(
        f"{name} kernel: one head's page of {page_size} rows at head_dim "
        f"{head_dim} needs {need} bytes of shared memory, over the block's "
        f"{MAX_SMEM}")


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"prefill_attention kernel: {msg}")


def prefill_attention(q, k_new, v_new, k_pages, v_pages, block_tables,
                      start_lens, chunk_lens, *, sm_scale: Optional[float] = None,
                      window: Optional[int] = None):
    """``q`` (B, Hq, C, D), ``k_new``/``v_new`` (B, Hkv, C, D), pools
    (Hkv, P, page_size, D), ``block_tables`` (B, max_pages) int32,
    ``start_lens``/``chunk_lens`` (B,) int32.  Returns ``(out (B, Hq, C, D),
    k_pages, v_pages)``, the pools being the tensors given, updated."""
    if not q.is_cuda:
        return ref.paged_prefill_attention(
            q, k_new, v_new, k_pages, v_pages, block_tables, start_lens,
            chunk_lens, sm_scale=sm_scale, window=window)
    b, hq, chunk, d = q.shape
    hkv, num_pages, page_size, d2 = k_pages.shape
    max_pages = block_tables.shape[1]
    group = hq // hkv
    for name, t in (("k_new", k_new), ("v_new", v_new), ("k_pages", k_pages),
                    ("v_pages", v_pages), ("block_tables", block_tables),
                    ("start_lens", start_lens), ("chunk_lens", chunk_lens)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
    _require(window is None or window > 0, f"window {window} must be positive")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    for t in (k_new, v_new, k_pages, v_pages):
        _require(t.dtype == q.dtype, "q, chunk K/V and pools share one dtype")
    _require(hq % hkv == 0 and d2 == d and v_pages.shape == k_pages.shape,
             f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)}")
    _require(tuple(k_new.shape) == (b, hkv, chunk, d)
             and v_new.shape == k_new.shape, "k_new/v_new must be (B, Hkv, C, D)")
    _require(chunk % page_size == 0 and chunk // page_size <= max_pages,
             f"chunk {chunk} must be a multiple of page_size {page_size} "
             f"spanning at most max_pages {max_pages}")
    for name, t in (("block_tables", block_tables), ("start_lens", start_lens),
                    ("chunk_lens", chunk_lens)):
        _require(t.dtype == torch.int32, f"{name} must be int32")
    _require(k_pages.is_contiguous() and v_pages.is_contiguous()
             and block_tables.is_contiguous(), "pools and tables must be contiguous")
    tc = tensor_core_path(q.dtype, d, page_size, group, max_pages, chunk)
    hs = head_split(tc, group, page_size, d)  # 1 on the wgmma path: C x G <= 128
    qp = packed_queries(q, hkv, hs, tc)
    kn, vn = k_new.contiguous(), v_new.contiguous()
    starts, lens = start_lens.contiguous(), chunk_lens.contiguous()
    out = torch.empty_like(qp)  # qp's strides: a (B, C, H, D) layout stays so
    strides = [s for t in (qp, out) for s in t.stride()[:3]] if tc else [0] * 6
    vec = 16 // q.element_size()
    _require(d % vec == 0 and 0 < page_size <= 32
             and page_size & (page_size - 1) == 0,
             f"head_dim {d} must be a multiple of {vec} and page_size "
             f"{page_size} a power of two <= 32")
    for name, t in (("q", qp), ("k_new", kn), ("v_new", vn), ("k_pages", k_pages),
                    ("v_pages", v_pages)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), qp.data_ptr(), kn.data_ptr(), vn.data_ptr(),
            k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
            starts.data_ptr(), lens.data_ptr(), out.data_ptr(), *strides, b, hkv, group,
            chunk, d, page_size, max_pages, num_pages,
            window if window is not None else 0, scale, stream, hs,
        )
    check(rc, "prefill_attention")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return unpacked_output(out, q.shape, hkv, hs, tc), k_pages, v_pages


def packed_queries(q, hkv: int, hs: int, tc: bool):
    """q as the kernel reads it: the tensor cores take (B, Hq, C, D) through
    its strides; the CUDA cores take it packed chunk-major with each part of
    a GQA group, (B, Hkv * hs, C * G / hs, D), row = i * G / hs + g."""
    if tc:
        return kernel_layout(q)
    b, hq, chunk, d = q.shape
    return q.reshape(b, hkv, hs, hq // (hkv * hs), chunk, d).transpose(3, 4).contiguous()


def unpacked_output(out, shape, hkv: int, hs: int, tc: bool):
    """The kernel's output back as (B, Hq, C, D): undoes
    :func:`packed_queries`."""
    if tc:
        return out
    b, hq, chunk, d = shape
    sub = hq // (hkv * hs)
    return out.reshape(b, hkv, hs, chunk, sub, d).transpose(3, 4).reshape(b, hq, chunk, d)


# ---------------------------------------------------------------------------
# The tile programs (repro/kernels/prefill_attention.py:44 and :157): grid
# (kv_head, chunk page, slot), the prior-KV page axis pipelined and gathered
# through the block table, then the chunk itself (causal, ragged against
# ``Lens``), then the paged write of this cell's chunk page through the
# table.  Contract: ``chunk % page_size == 0`` and every live slot's
# ``Starts`` page-aligned; chunk pages with no live token write page 0 and
# the table index is clamped, so an idle slot never clobbers a live page.
# ---------------------------------------------------------------------------


def prefill_attention_program(
    slots: int,
    heads: int,
    kv_heads: int,
    head_dim: int,
    chunk: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    window: Optional[int] = None,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
) -> TileProgram:
    if heads % kv_heads:
        raise ValueError("GQA requires heads % kv_heads == 0")
    if chunk % page_size:
        raise ValueError("chunk must be a multiple of page_size")
    group = heads // kv_heads
    cpp = chunk // page_size  # chunk pages: K/V pages written per slot
    rows = page_size * group  # query rows per grid cell (chunk-major packed)
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)) * 1.44269504  # log2(e)

    @T.prim_func
    def PrefillAttn(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Starts: T.ScalarTensor((slots,), "int32"),  # prior tokens (page-aligned)
        Lens: T.ScalarTensor((slots,), "int32"),  # live tokens in the chunk
        Q: T.Tensor((slots, kv_heads, chunk * group, head_dim), dtype),
        K: T.Tensor((slots, kv_heads, chunk, head_dim), dtype),
        V: T.Tensor((slots, kv_heads, chunk, head_dim), dtype),
        KPages: T.Tensor((kv_heads, num_pages, page_size, head_dim), dtype),
        VPages: T.Tensor((kv_heads, num_pages, page_size, head_dim), dtype),
        Output: T.Tensor((slots, kv_heads, chunk * group, head_dim), dtype),
    ):
        with T.Kernel(kv_heads, cpp, slots) as (bh, bq, bz):
            Q_shared = T.alloc_shared((rows, head_dim), dtype)
            Kc_shared = T.alloc_shared((chunk, head_dim), dtype)
            Vc_shared = T.alloc_shared((chunk, head_dim), dtype)
            Kp_shared = T.alloc_shared((page_size, head_dim), dtype)
            Vp_shared = T.alloc_shared((page_size, head_dim), dtype)
            acc_s = T.alloc_fragment((rows, page_size), accum_dtype)
            acc_c = T.alloc_fragment((rows, chunk), accum_dtype)
            # safe_div: rows past Lens are fully masked -> zeros, not nan
            ons = AC.OnlineSoftmax(rows, head_dim, scale, accum_dtype,
                                   safe_div=True)

            T.copy(Q[bz, bh, bq * rows, 0], Q_shared)
            T.copy(K[bz, bh, 0, 0], Kc_shared)
            T.copy(V[bz, bh, 0, 0], Vc_shared)

            # the absolute position of query row r (chunk-major packing)
            q_pos = lambda r: Starts[bz] + bq * page_size + r // group  # noqa: E731

            # prior KV, gathered through the block table
            def load_prior(kp):
                T.copy(KPages[bh, Tables[bz, kp], 0, 0], Kp_shared)
                T.copy(VPages[bh, Tables[bz, kp], 0, 0], Vp_shared)
                return Kp_shared, Vp_shared

            def prior_mask(kp):
                # prior positions [0, Starts) are live; the chunk's own
                # pages and table padding are masked
                k_pos = lambda j: kp * page_size + j  # noqa: E731
                m = AC.ragged(Starts[bz], k_pos)
                if window is not None:
                    m = AC.both(m, AC.banded(q_pos, k_pos, window))
                return m

            AC.attend(
                ons, acc_s, page_size, max_pages, load_prior,
                lambda s, ks, k: AC.scores(s, Q_shared, ks), prior_mask,
                num_stages=num_stages,
            )

            # the chunk itself, keys straight from K/V (never read back
            # through the pages being written): causal, ragged against Lens
            AC.scores(acc_c, Q_shared, Kc_shared)
            in_pos = lambda r: bq * page_size + r // group  # noqa: E731
            cmask = AC.both(
                AC.causal(in_pos, lambda j: j),
                AC.ragged(Lens[bz], lambda j: j),
            )
            if window is not None:
                cmask = AC.both(cmask, AC.banded(in_pos, lambda j: j, window))
            ons.update(acc_c, chunk, Vc_shared, cmask)

            ons.finalize(Output[bz, bh, bq * rows, 0])

            # the paged write of this cell's chunk page through the table:
            # a page with no live token lands in page 0, the index clamped
            live_page = (bq * page_size) < Lens[bz]
            tidx = T.minimum(Starts[bz] // page_size + bq, max_pages - 1)
            dst_page = T.if_then_else(live_page, Tables[bz, tidx], 0)
            T.copy(
                Kc_shared[bq * page_size : bq * page_size + page_size, :],
                KPages[bh, dst_page, 0, 0],
            )
            T.copy(
                Vc_shared[bq * page_size : bq * page_size + page_size, :],
                VPages[bh, dst_page, 0, 0],
            )

    return PrefillAttn


def prefill_attention_quant_program(
    slots: int,
    heads: int,
    kv_heads: int,
    head_dim: int,
    chunk: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    fmt: str = "int8",
    window: Optional[int] = None,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
) -> TileProgram:
    """The fp program with both KV paths routed through
    :class:`attention_core.DequantStage`.  The chunk arrives quantized
    (packed int8 and a scale a token); its staged bytes and scales are
    copied as they are into the four pools through the table, and the
    chunk's own attention reads their dequantized round trip.  Prior pages
    dequantize a page at a time, as in the quantized decode."""
    if heads % kv_heads:
        raise ValueError("GQA requires heads % kv_heads == 0")
    if chunk % page_size:
        raise ValueError("chunk must be a multiple of page_size")
    group = heads // kv_heads
    cpp = chunk // page_size
    rows = page_size * group
    pack = AC.KV_PACK[fmt]
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)) * 1.44269504  # log2(e)

    @T.prim_func
    def PrefillAttnQuant(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Starts: T.ScalarTensor((slots,), "int32"),  # prior tokens (page-aligned)
        Lens: T.ScalarTensor((slots,), "int32"),  # live tokens in the chunk
        Q: T.Tensor((slots, kv_heads, chunk * group, head_dim), dtype),
        K: T.Tensor((slots, kv_heads, chunk, head_dim // pack), "int8"),
        V: T.Tensor((slots, kv_heads, chunk, head_dim // pack), "int8"),
        KScale: T.Tensor((slots, kv_heads, chunk, 1), dtype),
        VScale: T.Tensor((slots, kv_heads, chunk, 1), dtype),
        KPages: T.Tensor((kv_heads, num_pages, page_size, head_dim // pack), "int8"),
        VPages: T.Tensor((kv_heads, num_pages, page_size, head_dim // pack), "int8"),
        KScales: T.Tensor((kv_heads, num_pages, page_size, 1), dtype),
        VScales: T.Tensor((kv_heads, num_pages, page_size, 1), dtype),
        Output: T.Tensor((slots, kv_heads, chunk * group, head_dim), dtype),
    ):
        with T.Kernel(kv_heads, cpp, slots) as (bh, bq, bz):
            Q_shared = T.alloc_shared((rows, head_dim), dtype)
            kc = AC.DequantStage(chunk, head_dim, fmt, dtype)
            vc = AC.DequantStage(chunk, head_dim, fmt, dtype)
            kp = AC.DequantStage(page_size, head_dim, fmt, dtype)
            vp = AC.DequantStage(page_size, head_dim, fmt, dtype)
            acc_s = T.alloc_fragment((rows, page_size), accum_dtype)
            acc_c = T.alloc_fragment((rows, chunk), accum_dtype)
            # safe_div: rows past Lens are fully masked -> zeros, not nan
            ons = AC.OnlineSoftmax(rows, head_dim, scale, accum_dtype,
                                   safe_div=True)

            T.copy(Q[bz, bh, bq * rows, 0], Q_shared)
            # stage and dequantize the chunk once (the round trip every
            # later decode step reads back from the pages)
            Kc = kc.load(K[bz, bh, 0, 0], KScale[bz, bh, 0, 0])
            Vc = vc.load(V[bz, bh, 0, 0], VScale[bz, bh, 0, 0])

            q_pos = lambda r: Starts[bz] + bq * page_size + r // group  # noqa: E731

            # prior KV: paged gather + inline dequant
            def load_prior(kpg):
                ks = kp.load(KPages[bh, Tables[bz, kpg], 0, 0],
                             KScales[bh, Tables[bz, kpg], 0, 0])
                vs = vp.load(VPages[bh, Tables[bz, kpg], 0, 0],
                             VScales[bh, Tables[bz, kpg], 0, 0])
                return ks, vs

            def prior_mask(kpg):
                k_pos = lambda j: kpg * page_size + j  # noqa: E731
                m = AC.ragged(Starts[bz], k_pos)
                if window is not None:
                    m = AC.both(m, AC.banded(q_pos, k_pos, window))
                return m

            AC.attend(
                ons, acc_s, page_size, max_pages, load_prior,
                lambda s, ks, k: AC.scores(s, Q_shared, ks), prior_mask,
                num_stages=num_stages,
            )

            # the chunk itself (its dequantized round trip)
            AC.scores(acc_c, Q_shared, Kc)
            in_pos = lambda r: bq * page_size + r // group  # noqa: E731
            cmask = AC.both(
                AC.causal(in_pos, lambda j: j),
                AC.ragged(Lens[bz], lambda j: j),
            )
            if window is not None:
                cmask = AC.both(cmask, AC.banded(in_pos, lambda j: j, window))
            ons.update(acc_c, chunk, Vc, cmask)

            ons.finalize(Output[bz, bh, bq * rows, 0])

            # the paged write: packed bytes and scales as they were staged
            # (dead chunk pages land in page 0, as in the fp program)
            live_page = (bq * page_size) < Lens[bz]
            tidx = T.minimum(Starts[bz] // page_size + bq, max_pages - 1)
            dst_page = T.if_then_else(live_page, Tables[bz, tidx], 0)
            T.copy(
                kc.packed_rows(bq * page_size, bq * page_size + page_size),
                KPages[bh, dst_page, 0, 0],
            )
            T.copy(
                vc.packed_rows(bq * page_size, bq * page_size + page_size),
                VPages[bh, dst_page, 0, 0],
            )
            T.copy(
                kc.scale_shared[bq * page_size : bq * page_size + page_size, :],
                KScales[bh, dst_page, 0, 0],
            )
            T.copy(
                vc.scale_shared[bq * page_size : bq * page_size + page_size, :],
                VScales[bh, dst_page, 0, 0],
            )

    return PrefillAttnQuant


# Tiny-shape configs of the backend-parity suite: MQA, a multi-page chunk
# under GQA, a sliding window, and the quantized twin in int8 and int4.
PARITY_CASES = [
    (
        "prefill_attention_mqa",
        dict(slots=2, heads=2, kv_heads=1, head_dim=16, chunk=16,
             page_size=16, max_pages=4, num_pages=8),
    ),
    (
        "prefill_attention_gqa_multipage",
        dict(slots=2, heads=4, kv_heads=2, head_dim=16, chunk=32,
             page_size=16, max_pages=4, num_pages=8),
    ),
    (
        "prefill_attention_windowed",
        dict(slots=2, heads=2, kv_heads=2, head_dim=16, chunk=16,
             page_size=16, max_pages=4, num_pages=8, window=20),
    ),
    (
        "prefill_attention_quant_int8",
        dict(slots=2, heads=4, kv_heads=2, head_dim=16, chunk=32,
             page_size=16, max_pages=4, num_pages=8, fmt="int8"),
    ),
    (
        "prefill_attention_quant_int4",
        dict(slots=2, heads=2, kv_heads=1, head_dim=16, chunk=16,
             page_size=16, max_pages=4, num_pages=8, fmt="int4"),
    ),
]


def parity_programs():
    for name, cfg in PARITY_CASES:
        maker = prefill_attention_quant_program if "quant" in name else prefill_attention_program
        yield name, maker(**cfg)


def parity_inputs(name, program, rng):
    """Valid numpy inputs of a parity case: distinct pages a slot,
    page-aligned starts that leave room for the chunk's pages, and live
    lengths ragged within the last chunk page only (every chunk page live:
    a fully dead page writes the shared page 0, whose last contents depend
    on the order the cells run).  The in-out pools ride after the pure
    inputs."""
    cfg = dict(PARITY_CASES)[name]
    slots, mp, np_ = cfg["slots"], cfg["max_pages"], cfg["num_pages"]
    ps, chunk = cfg["page_size"], cfg["chunk"]
    cpp = chunk // ps
    pages = rng.permutation(np_)[: slots * mp].reshape(slots, mp).astype("int32")
    prior_pages = rng.integers(0, mp - cpp + 1, size=slots)
    starts = (prior_pages * ps).astype("int32")
    lens = rng.integers(chunk - ps + 1, chunk + 1, size=slots).astype("int32")

    def fill(p):
        if str(p.dtype).startswith("int"):
            return rng.integers(-128, 128, size=p.shape).astype(p.dtype)
        if p.name.endswith(("Scale", "Scales")):
            return rng.uniform(0.05, 0.2, size=p.shape).astype(p.dtype)
        return rng.standard_normal(p.shape).astype(p.dtype)

    args = [pages, starts, lens]
    for p in program.input_params()[3:]:
        args.append(fill(p))
    for p in program.output_params():
        if p.name in ("KPages", "VPages", "KScales", "VScales"):
            args.append(fill(p))
    return args
