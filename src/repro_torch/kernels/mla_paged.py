"""Paged MLA decode: the wrapper around ``csrc/mla_paged.cu``.

Counterpart of ``repro.kernels.mla.mla_paged_program``
(repro/kernels/mla.py:110): one latent query token per slot, every head
scoring ``q_lat . ckv + q_pe . kpe`` against the slot's latent and rope
pages (pools with no head axis), the latent as V, under a ragged live-length
mask and an optional sliding window, with safe_div.  The plain version is
``ref.mla_paged``; this wrapper takes it for CPU tensors only.  For a CUDA
tensor it launches the kernel or raises.

The kernel splits each slot's keys across blocks (split-KV) and merges the
partial softmax states in a second pass, as the GQA decode does: the split
count comes from static shapes and the card's SM count alone
(``paged_attention.decode_splits``), never from ``seq_lens``.  bf16 at a
latent width of 512 scores on the tensor cores (:func:`tensor_core_path`,
``KERNEL.tc_launches``); fp32 and other widths on CUDA cores, over the same
split grid.  :func:`split_decode` rehearses the kernel's arithmetic in plain
PyTorch.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import ref
from .build import Kernel, check
from .paged_attention import DTYPES, LOG2E, decode_splits, fold_splits, mask_live, sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla_paged", "mla_paged_launch",
    [_I, _I] + [_P] * 9 + [_I] * 11 + [ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:110",
)
# query heads a decode block holds: all 16 at full width, so each latent
# page is read once per slot (and split)
MAX_HEAD_BLOCK = 16
TC_RANK = 512  # the latent width the MLA tensor-core kernels are built for
TC_KEYS = 32  # keys a tile there: pages nest in it


def head_block(heads: int) -> int:
    """The largest divisor of ``heads`` up to MAX_HEAD_BLOCK."""
    return max(d for d in range(1, min(heads, MAX_HEAD_BLOCK) + 1)
               if heads % d == 0)


def tensor_core_path(dtype: torch.dtype, r: int, pe: int, page_size: int) -> bool:
    """Whether a launch of an MLA paged kernel (the decode, the chunked
    prefill, or their quantized twins) takes its tensor-core path: bf16 at
    latent width 512 with R + Dpe a multiple of 64 (four column quarters of
    16-wide steps), and pages of 1 to 32 positions, a power of two, that
    nest in the 32-key tiles.  Heads, slots, chunks and lengths do not
    matter."""
    return (dtype == torch.bfloat16 and r == TC_RANK and pe > 0
            and (r + pe) % 64 == 0 and 1 <= page_size <= TC_KEYS
            and page_size & (page_size - 1) == 0)


def split_grid(slots: int, heads: int, max_pages: int, page_size: int,
               sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the decode grid (heads / head_block, slots,
    splits): the GQA decode's rule with the head blocks in the kv heads'
    place.  At deepseek-v2-lite-16B's serving shape (slots 8, 16 heads in
    one block, 64 pages of 16) 16 splits of 64 keys, 128 blocks."""
    return decode_splits(slots, heads // head_block(heads), max_pages, page_size, sms)


def requirer(kernel: str):
    def require(cond: bool, msg: str):
        if not cond:
            raise ValueError(f"{kernel} kernel: {msg}")
    return require


def check_latent(require, q_lat, q_pe, tensors, block_tables, page_size: int,
                 row_bytes, window):
    """What every MLA kernel needs of its arguments: one device, float32 or
    bfloat16 queries, int32 tables, contiguous pools (those read with
    16-byte vector loads 16-byte aligned; scale pools are read a scale at a
    time), a page a power of two <= 32 and rows (``row_bytes`` of each pool)
    a multiple of 16 bytes."""
    for name, t in tensors:
        require(t.device == q_lat.device,
                f"{name} is on {t.device}, q_lat on {q_lat.device}")
    require(q_lat.dtype in DTYPES and q_pe.dtype == q_lat.dtype,
            f"dtype {q_lat.dtype} / {q_pe.dtype} (float32 or bfloat16, one of them)")
    require(block_tables.dtype == torch.int32, "block_tables must be int32")
    require(window is None or window > 0, f"window {window} must be positive")
    require(0 < page_size <= 32 and page_size & (page_size - 1) == 0,
            f"page_size {page_size} must be a power of two <= 32")
    require(all(n % 16 == 0 for n in row_bytes),
            f"latent and rope rows ({row_bytes} bytes) must be multiples of 16 bytes")
    for name, t in tensors:
        if name.endswith("pages"):
            require(t.is_contiguous(), f"{name} must be contiguous")
            require("scale" in name or t.data_ptr() % 16 == 0,
                    f"{name} must be 16-byte aligned")


def decode_launch(require, q_lat, q_pe, block_tables, seq_lens, num_pages: int,
                  page_size: int, window, sm_scale):
    """What a decode launch of either entry point computes before the call:
    contiguous queries, the output, and the C call's arguments from the
    block table to sm_scale (the scalars, the output, the fp32 scratch of
    the partial states and the split grid)."""
    b, h, r = q_lat.shape
    pe = q_pe.shape[-1]
    require(tuple(q_pe.shape) == (b, h, pe),
            f"q_pe {tuple(q_pe.shape)} against q_lat {tuple(q_lat.shape)}")
    require(seq_lens.dtype == torch.int32 and tuple(seq_lens.shape) == (b,)
            and block_tables.shape[0] == b,
            "one table row and one int32 length per slot")
    q, qp = q_lat.contiguous(), q_pe.contiguous()
    tables, lens = block_tables.contiguous(), seq_lens.contiguous()
    max_pages = tables.shape[1]
    splits, split_keys = split_grid(b, h, max_pages, page_size,
                                    sm_count(q.device.index or 0))
    require(b <= 65535 and splits <= 65535, f"{b} slots x {splits} splits")
    out = torch.empty_like(q)
    # the partial states: O unnormalised, then m and l (fp32 scratch)
    o_part = torch.empty((b, h, splits, r), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((2, b, h, splits), dtype=torch.float32, device=q.device)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(r + pe)
    args = (tables.data_ptr(), lens.data_ptr(), out.data_ptr(), o_part.data_ptr(),
            ml_part.data_ptr(), b, h, head_block(h), r, pe, page_size, max_pages,
            num_pages, window if window is not None else 0, splits, split_keys, scale)
    return q, qp, out, args


def mla_paged(q_lat, q_pe, ckv_pages, kpe_pages, block_tables, seq_lens, *,
              sm_scale: Optional[float] = None,
              window: Optional[int] = None) -> torch.Tensor:
    """``q_lat`` (B, H, R), ``q_pe`` (B, H, Dpe); pools ``ckv_pages`` (P,
    page_size, R) and ``kpe_pages`` (P, page_size, Dpe) of q's dtype;
    ``block_tables`` (B, max_pages) int32; ``seq_lens`` (B,) int32 ->
    (B, H, R)."""
    if not q_lat.is_cuda:
        return ref.mla_paged(q_lat, q_pe, ckv_pages, kpe_pages, block_tables,
                             seq_lens, sm_scale=sm_scale, window=window)
    require = requirer("mla_paged")
    r = q_lat.shape[-1]
    num_pages, page_size, _ = ckv_pages.shape
    pe = q_pe.shape[-1]
    isz = q_lat.element_size()
    check_latent(require, q_lat, q_pe,
                 (("q_pe", q_pe), ("ckv_pages", ckv_pages),
                  ("kpe_pages", kpe_pages), ("block_tables", block_tables),
                  ("seq_lens", seq_lens)),
                 block_tables, page_size, (r * isz, pe * isz), window)
    require(ckv_pages.dtype == q_lat.dtype and kpe_pages.dtype == q_lat.dtype,
            "pools and queries must share one dtype")
    require(tuple(ckv_pages.shape) == (num_pages, page_size, r)
            and tuple(kpe_pages.shape) == (num_pages, page_size, pe),
            f"pools {tuple(ckv_pages.shape)} / {tuple(kpe_pages.shape)} against "
            f"q_lat {tuple(q_lat.shape)}, q_pe {tuple(q_pe.shape)}")
    q, qp, out, args = decode_launch(require, q_lat, q_pe, block_tables, seq_lens,
                                     num_pages, page_size, window, sm_scale)
    tc = tensor_core_path(q.dtype, r, pe, page_size)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), qp.data_ptr(),
            ckv_pages.data_ptr(), kpe_pages.data_ptr(), *args, stream)
    check(rc, "mla_paged")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out


def split_decode(q_lat, q_pe, ckv_pages, kpe_pages, block_tables, seq_lens,
                 splits: int, split_keys: int, *, sm_scale: Optional[float] = None,
                 window: Optional[int] = None, pair: bool = False,
                 rescale: bool = True) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch (a rehearsal, not a
    path): fp32 scores ``q_lat . ckv + q_pe . kpe`` scaled into the log2
    domain under the live-length mask and the window, then
    ``paged_attention.fold_splits`` over the kernel's 32-key tiles with the
    latent as V, rounded once.  ``pair`` multiplies P as the tensor-core
    kernel's bf16 pair hi + lo; ``rescale=False`` is the faulty merge that
    sums the splits as they stand.  For the quantized twin, pass the pools
    dequantized and rounded to q's dtype (what the kernel attends)."""
    b, _, r = q_lat.shape
    pe = q_pe.shape[-1]
    qscale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(r + pe)) * LOG2E
    tables = block_tables.long()
    ckv = ckv_pages[tables].reshape(b, -1, r).float()
    kpe = kpe_pages[tables].reshape(b, -1, pe).float()
    scores = (torch.einsum("bhr,bsr->bhs", q_lat.float(), ckv)
              + torch.einsum("bhp,bsp->bhs", q_pe.float(), kpe)) * qscale
    scores = mask_live(scores, seq_lens, window)
    out = fold_splits(scores, ckv, splits, split_keys, TC_KEYS, pair=pair, rescale=rescale)
    return out.to(q_lat.dtype)
