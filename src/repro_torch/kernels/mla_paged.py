"""Paged MLA decode: the wrapper around ``csrc/mla_paged.cu``.

Counterpart of ``repro.kernels.mla.mla_paged_program``
(repro/kernels/mla.py:110): one latent query token per slot, every head
scoring ``q_lat . ckv + q_pe . kpe`` against the slot's latent and rope
pages (pools with no head axis), the latent as V, under a ragged live-length
mask and an optional sliding window, with safe_div.  The plain version is
``ref.mla_paged``; this wrapper takes it for CPU tensors only.  For a CUDA
tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla_paged", "mla_paged_launch",
    [_I] + [_P] * 7 + [_I] * 9 + [ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:110",
)
# query heads a decode block holds: all 16 at full width, so each latent
# page is read once per slot
MAX_HEAD_BLOCK = 16


def head_block(heads: int) -> int:
    """The largest divisor of ``heads`` up to MAX_HEAD_BLOCK."""
    return max(d for d in range(1, min(heads, MAX_HEAD_BLOCK) + 1)
               if heads % d == 0)


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
    b, h, r = q_lat.shape
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
    require(tuple(q_pe.shape) == (b, h, pe)
            and tuple(ckv_pages.shape) == (num_pages, page_size, r)
            and tuple(kpe_pages.shape) == (num_pages, page_size, pe),
            f"shapes q_lat {tuple(q_lat.shape)}, q_pe {tuple(q_pe.shape)}, "
            f"pools {tuple(ckv_pages.shape)} / {tuple(kpe_pages.shape)}")
    require(seq_lens.dtype == torch.int32 and tuple(seq_lens.shape) == (b,)
            and block_tables.shape[0] == b,
            "one table row and one int32 length per slot")
    q, qp = q_lat.contiguous(), q_pe.contiguous()
    tables, lens = block_tables.contiguous(), seq_lens.contiguous()
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(r + pe)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], q.data_ptr(), qp.data_ptr(), ckv_pages.data_ptr(),
            kpe_pages.data_ptr(), tables.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, head_block(h), r, pe, page_size,
            tables.shape[1], num_pages, window if window is not None else 0,
            scale, stream)
    check(rc, "mla_paged")
    KERNEL.launches += 1
    return out
