"""Chunked-prefill attention: the wrapper around ``csrc/prefill_attention.cu``.

Counterpart of ``repro.kernels.prefill_attention.prefill_attention_program``
(repro/kernels/prefill_attention.py:44): a chunk of C prompt tokens per slot
attends its prior pages through the block table plus itself causally, and
the chunk's K/V land in the pool pages **in place** (the reference returned
updated copies of the pools; here the given pools are written).  The plain
version is ``ref.paged_prefill_attention``; this wrapper takes it for CPU
tensors only.  For a CUDA tensor it launches the kernel or raises.

The kernel has two paths, picked from dtype and shape alone
(:func:`tensor_core_path`).  bf16 at head dim 64 or 128, with 64 keys a
whole number of pages and at most 16384 table entries a slot, runs on the
tensor cores, which read q and write the output through their (B, Hq, C, D)
strides, so the transposed views the prefill layer hands over cost no copy
(``KERNEL.tc_launches`` counts those launches).  The rest runs on CUDA cores
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
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .flash_attention import MAX_SMEM, core_smem_bytes, kernel_layout
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "prefill_attention", "prefill_attention_launch",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, *([ctypes.c_longlong] * 6), _I,
     _I, _I, _I, _I, _I, _I, _I, _I, ctypes.c_float, _P, _I],
    replaces="src/repro/kernels/prefill_attention.py:44",
)
TC_HEAD_DIMS = (64, 128)
TC_KEYS = 64  # keys a tile on the tensor-core path
TC_MAX_ROWS = 128  # query rows a block there (8 warps of 16)
TC_MAX_PAGES = 16384  # table entries a block copies into shared memory


def tensor_core_path(dtype: torch.dtype, head_dim: int, page_size: int,
                     group: int, max_pages: int) -> bool:
    """Whether a launch takes the tensor-core kernel: bf16 at a head dim it
    is built for, pages that tile its 64-key tiles, and a table row that
    fits shared memory.  Any GQA group fits, split over blocks by
    :func:`head_split`.  Slots, chunk, starts and lengths do not matter."""
    del group  # a page's rows of any group fit, split over blocks
    return (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            and TC_KEYS % page_size == 0 and max_pages <= TC_MAX_PAGES)


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
    tc = tensor_core_path(q.dtype, d, page_size, group, max_pages)
    hs = head_split(tc, group, page_size, d)
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
