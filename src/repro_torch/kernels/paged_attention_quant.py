"""Quantized paged-attention decode: the wrapper around the quantized entry
point of ``csrc/paged_attention.cu``.

Counterpart of ``repro.kernels.paged_attention.paged_attention_quant_program``
(repro/kernels/paged_attention.py:93): the decode kernel of
``paged_attention.py`` over packed int8 / int4 K/V pools plus per-token
scale columns, each value dequantized to the query's dtype (rounded once,
as the TPU kernel does) on its way into shared memory.  The plain version
is ``ref.paged_attention_quant``; this wrapper takes it for CPU tensors
only.  For a CUDA tensor it launches the kernel or raises.

The kernel's grid and routes are ``paged_attention.py``'s
(:func:`.paged_attention.route`): split-KV from static shapes, then the
merge.  bf16 at head dim 256 (gemma-7b's) takes the bulk-copy walk
(``KERNEL.walk_launches``): each page's packed K and V rows and their scale
columns come into shared memory by ``cp.async.bulk``, and each value is
dequantized in registers, code x scale in fp32 rounded once to bf16, as the
plain version rounds it; a scale column is one 16-byte copy at pages of 8
or more, so smaller pages keep the older routes.  bf16 at head dim 64 or 128
runs on the tensor cores, each 64-key tile's packed rows staged by cp.async
and dequantized into the bf16 tile (``KERNEL.tc_launches``); fp32 and other
head dims on CUDA cores.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .paged_attention import (DTYPES, MAX_SMEM, ROUTES, WALK_DEFINES, route,
                              split_scratch, walk_smem_bytes)

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "paged_attention_quant", "paged_attention_quant_launch",
    [_I, _I, _I] + [_P] * 10 + [_I] * 10 + [ctypes.c_float, _P],
    replaces="src/repro/kernels/paged_attention.py:93",
    source="paged_attention",
    defines=WALK_DEFINES,
)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention_quant kernel: {msg}")


def paged_attention_quant(q, k_pages, v_pages, k_scales, v_scales,
                          block_tables, seq_lens, *, fmt: str = "int8",
                          sm_scale: Optional[float] = None,
                          window: Optional[int] = None) -> torch.Tensor:
    """``q`` (B, Hq, D); packed pools (Hkv, P, page_size, D // pack) int8;
    scales (Hkv, P, page_size, 1) of q's dtype; ``block_tables``
    (B, max_pages) int32; ``seq_lens`` (B,) int32 -> (B, Hq, D)."""
    if not q.is_cuda:
        return ref.paged_attention_quant(
            q, k_pages, v_pages, k_scales, v_scales, block_tables, seq_lens,
            fmt=fmt, sm_scale=sm_scale, window=window)
    _require(fmt in ref.KV_PACK, f"format {fmt!r} (int8 or int4)")
    pack = ref.KV_PACK[fmt]
    b, hq, d = q.shape
    hkv, num_pages, page_size, dp = k_pages.shape
    max_pages = block_tables.shape[1]
    tensors = (("k_pages", k_pages), ("v_pages", v_pages),
               ("k_scales", k_scales), ("v_scales", v_scales),
               ("block_tables", block_tables), ("seq_lens", seq_lens))
    for name, t in tensors:
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(q.is_contiguous(), "q must be contiguous")
    _require(window is None or window > 0, f"window {window} must be positive")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _require(k_pages.dtype == torch.int8 and v_pages.dtype == torch.int8,
             "packed pools must be int8")
    _require(k_scales.dtype == q.dtype and v_scales.dtype == q.dtype,
             "scale pools and q must share one dtype")
    _require(v_pages.shape == k_pages.shape and dp * pack == d
             and hq % hkv == 0,
             f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)} ({fmt})")
    _require(tuple(k_scales.shape) == (hkv, num_pages, page_size, 1)
             and v_scales.shape == k_scales.shape, "scales (Hkv, P, ps, 1)")
    _require(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32,
             "block_tables and seq_lens must be int32")
    _require(tuple(seq_lens.shape) == (b,) and block_tables.shape[0] == b,
             "one table row and one length per slot")
    _require(dp % 16 == 0 and 0 < page_size <= 32
             and page_size & (page_size - 1) == 0,
             f"a packed row ({dp} bytes) must be a multiple of 16 bytes and "
             f"page_size {page_size} a power of two <= 32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    tc = route(q.dtype, d, hq // hkv, page_size)
    if tc == ROUTES["walk"]:
        for name, t in (("k_scales", k_scales), ("v_scales", v_scales)):
            _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned (the walk "
                     "copies a page's scale column whole)")
        _require(walk_smem_bytes(d, hq // hkv, page_size, pack) <= MAX_SMEM,
                 "the walk's shared memory at this shape")
    splits, split_keys, o_part, ml_part = split_scratch(
        q, hkv, max_pages, page_size, walk=tc == ROUTES["walk"])
    _require(b <= 65535 and splits <= 65535, f"{b} slots x {splits} splits")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], tc, pack, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), seq_lens.data_ptr(), out.data_ptr(),
            o_part.data_ptr(), ml_part.data_ptr(), b, hq, hkv, d, page_size,
            max_pages, num_pages, window if window is not None else 0, splits,
            split_keys, scale, stream,
        )
    check(rc, "paged_attention_quant")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc == ROUTES["mma.sync"])
    KERNEL.walk_launches += int(tc == ROUTES["walk"])
    return out
