"""Paged-attention decode: the wrapper around ``csrc/paged_attention.cu``.

Counterpart of ``repro.kernels.paged_attention.paged_attention_program``
(repro/kernels/paged_attention.py:32): single-token GQA decode over a paged
KV pool with a ragged live-length mask, an optional sliding window and
safe_div (empty slots emit zeros).  The plain version is
``ref.paged_attention``; this wrapper takes it for CPU tensors only.  For a
CUDA tensor it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "paged_attention", "paged_attention_launch",
    [_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _P],
    replaces="src/repro/kernels/paged_attention.py:32",
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """``q`` (B, Hq, D), pools (Hkv, P, page_size, D), ``block_tables``
    (B, max_pages) int32, ``seq_lens`` (B,) int32 -> (B, Hq, D)."""
    if not q.is_cuda:
        return ref.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens, sm_scale=sm_scale, window=window)
    b, hq, d = q.shape
    hkv, num_pages, page_size, d2 = k_pages.shape
    max_pages = block_tables.shape[1]
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
    _require(window is None or window > 0, f"window {window} must be positive")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _require(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
             "pools and q must share one dtype")
    _require(v_pages.shape == k_pages.shape and d2 == d and hq % hkv == 0,
             f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)}")
    _require(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32,
             "block_tables and seq_lens must be int32")
    _require(tuple(seq_lens.shape) == (b,) and block_tables.shape[0] == b,
             "one table row and one length per slot")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    vec = 16 // q.element_size()
    _require(d % vec == 0 and 0 < page_size <= 32
             and page_size & (page_size - 1) == 0,
             f"head_dim {d} must be a multiple of {vec} and page_size "
             f"{page_size} a power of two <= 32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), b, hq, hkv, d, page_size, max_pages, num_pages,
            window if window is not None else 0, scale, stream,
        )
    check(rc, "paged_attention")
    KERNEL.launches += 1
    return out
