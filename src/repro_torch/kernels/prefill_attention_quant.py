"""Quantized chunked-prefill attention: the wrapper around the quantized
entry point of ``csrc/prefill_attention.cu``.

Counterpart of
``repro.kernels.prefill_attention.prefill_attention_quant_program``
(repro/kernels/prefill_attention.py:157).  The chunk arrives quantized
(``kernels.ops`` quantizes it in plain torch, as the reference does at
ops.py:392): packed int8 / int4 K/V plus per-token scales.  The kernel
attends the prior pages dequantized, then the chunk's own dequantized round
trip, and writes the chunk's packed bytes and scales into the four pools
**in place** through the block table.  The plain version is
``ref.paged_prefill_attention_quant``; this wrapper takes it for CPU tensors
only.  For a CUDA tensor it launches the kernel or raises.

The kernel has two paths, picked from dtype and shape alone
(:func:`tensor_core_path`): bf16 at the fp kernel's tensor-core shapes runs
its tensor-core walk with a loader that dequantizes each staged tile of
packed bytes into bf16, and reads q and writes the output through their
(B, Hq, C, D) strides (no copy; ``KERNEL.tc_launches`` counts those
launches); the rest runs on CUDA cores over q packed chunk-major with its
GQA group, a copy each way.

The kernel contract is the fp kernel's (``prefill_attention.py``): ``chunk
% page_size == 0``, ``chunk // page_size <= max_pages``, page-aligned starts
and zeroed pools; past a slot's live length the kernel writes whole pages
(bytes and scales of the same rows), where the plain version sends dead
positions to page 0.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from . import prefill_attention as _fp
from .build import Kernel, check
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "prefill_attention_quant", "prefill_attention_quant_launch",
    [_I, _I, _I] + [_P] * 13 + [ctypes.c_longlong] * 6 + [_I] * 9 + [ctypes.c_float, _P, _I],
    replaces="src/repro/kernels/prefill_attention.py:157",
    source="prefill_attention",
    defines=_fp.KERNEL.defines,
)
# table entries a block copies into shared memory beside the ring and the
# staging area (38 KB at int8, D 128, two key groups)
TC_MAX_PAGES = 8192


def tensor_core_path(dtype: torch.dtype, head_dim: int, page_size: int,
                     group: int, max_pages: int) -> bool:
    """Whether a launch takes the tensor-core kernel: the fp kernel's
    mma.sync rule (bf16, head dim 64 or 128, pages that tile its 64-key
    tiles; any GQA group, split over blocks by ``head_split``), int8 or
    int4 alike, with a table row that fits shared memory beside the staging
    area.  Head dim 256 keeps the CUDA-core body (the quantized twin has no
    wgmma walk).  Slots, chunk, starts and lengths do not matter."""
    return (dtype == torch.bfloat16 and head_dim in _fp.TC_HEAD_DIMS
            and _fp.mma_fits(page_size, max_pages) and max_pages <= TC_MAX_PAGES)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"prefill_attention_quant kernel: {msg}")


def prefill_attention_quant(q, k_q, v_q, k_s, v_s, k_pages, v_pages,
                            k_scales, v_scales, block_tables, start_lens,
                            chunk_lens, *, fmt: str = "int8",
                            sm_scale: Optional[float] = None,
                            window: Optional[int] = None):
    """``q`` (B, Hq, C, D); the quantized chunk ``k_q``/``v_q`` (B, Hkv, C,
    D // pack) int8 with scales ``k_s``/``v_s`` (B, Hkv, C, 1); packed
    pools (Hkv, P, page_size, D // pack) int8 and scale pools (Hkv, P,
    page_size, 1) of q's dtype; ``block_tables`` (B, max_pages) int32;
    ``start_lens``/``chunk_lens`` (B,) int32.  Returns ``(out (B, Hq, C, D),
    k_pages, v_pages, k_scales, v_scales)``, the pools being the tensors
    given, updated."""
    if not q.is_cuda:
        return ref.paged_prefill_attention_quant(
            q, k_q, v_q, k_s, v_s, k_pages, v_pages, k_scales, v_scales,
            block_tables, start_lens, chunk_lens, fmt=fmt, sm_scale=sm_scale,
            window=window)
    _require(fmt in ref.KV_PACK, f"format {fmt!r} (int8 or int4)")
    pack = ref.KV_PACK[fmt]
    b, hq, chunk, d = q.shape
    hkv, num_pages, page_size, dp = k_pages.shape
    max_pages = block_tables.shape[1]
    group = hq // hkv
    tensors = (("k_q", k_q), ("v_q", v_q), ("k_s", k_s), ("v_s", v_s),
               ("k_pages", k_pages), ("v_pages", v_pages),
               ("k_scales", k_scales), ("v_scales", v_scales),
               ("block_tables", block_tables), ("start_lens", start_lens),
               ("chunk_lens", chunk_lens))
    for name, t in tensors:
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
    _require(window is None or window > 0, f"window {window} must be positive")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    for t in (k_q, v_q, k_pages, v_pages):
        _require(t.dtype == torch.int8, "packed chunk and pools must be int8")
    for t in (k_s, v_s, k_scales, v_scales):
        _require(t.dtype == q.dtype, "scales and q must share one dtype")
    _require(hq % hkv == 0 and dp * pack == d and v_pages.shape == k_pages.shape,
             f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)} ({fmt})")
    _require(tuple(k_scales.shape) == (hkv, num_pages, page_size, 1)
             and v_scales.shape == k_scales.shape, "scale pools (Hkv, P, ps, 1)")
    _require(tuple(k_q.shape) == (b, hkv, chunk, dp) and v_q.shape == k_q.shape,
             "k_q/v_q must be (B, Hkv, C, D // pack)")
    _require(tuple(k_s.shape) == (b, hkv, chunk, 1) and v_s.shape == k_s.shape,
             "k_s/v_s must be (B, Hkv, C, 1)")
    _require(chunk % page_size == 0 and chunk // page_size <= max_pages,
             f"chunk {chunk} must be a multiple of page_size {page_size} "
             f"spanning at most max_pages {max_pages}")
    for name, t in (("block_tables", block_tables), ("start_lens", start_lens),
                    ("chunk_lens", chunk_lens)):
        _require(t.dtype == torch.int32, f"{name} must be int32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("k_scales", k_scales), ("v_scales", v_scales),
                    ("block_tables", block_tables)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(dp % 16 == 0 and 0 < page_size <= 32
             and page_size & (page_size - 1) == 0,
             f"a packed row ({dp} bytes) must be a multiple of 16 bytes and "
             f"page_size {page_size} a power of two <= 32")
    tc = tensor_core_path(q.dtype, d, page_size, group, max_pages)
    hs = _fp.head_split(tc, group, page_size, d, "prefill_attention_quant")
    qp = _fp.packed_queries(q, hkv, hs, tc)
    kq, vq, ks, vs = (t.contiguous() for t in (k_q, v_q, k_s, v_s))
    starts, lens = start_lens.contiguous(), chunk_lens.contiguous()
    for name, t in (("q", qp), ("k_q", kq), ("v_q", vq), ("k_pages", k_pages),
                    ("v_pages", v_pages)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    out = torch.empty_like(qp)  # qp's strides: a (B, C, H, D) layout stays so
    strides = [s for t in (qp, out) for s in t.stride()[:3]] if tc else [0] * 6
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), pack, qp.data_ptr(), kq.data_ptr(), vq.data_ptr(),
            ks.data_ptr(), vs.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), k_scales.data_ptr(), v_scales.data_ptr(),
            block_tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            out.data_ptr(), *strides, b, hkv, group, chunk, d, page_size, max_pages,
            num_pages, window if window is not None else 0, scale, stream, hs,
        )
    check(rc, "prefill_attention_quant")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    out = _fp.unpacked_output(out, q.shape, hkv, hs, tc)
    return out, k_pages, v_pages, k_scales, v_scales
