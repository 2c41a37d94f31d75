"""MLA chunked prefill: the wrapper around ``csrc/mla_prefill.cu``.

Counterpart of ``repro.kernels.mla.mla_prefill_program``
(repro/kernels/mla.py:180): a (slots, chunk) block of absorbed queries
attends the prior latent and rope pages through the block table plus the
chunk's own latents causally, the latent as V, and the chunk's latent and
rope rows are written into the pools **in place** from inside the kernel.
The plain version is ``ref.paged_mla_prefill``; this wrapper takes it for
CPU tensors only.  For a CUDA tensor it launches the kernel or raises.

The kernel has two paths, picked from dtype and shape alone
(:func:`tensor_core_path`): bf16 at a latent width of 512 (deepseek-v2-lite-
16B's serving shape) runs on the tensor cores, 64 query rows a block
(``KERNEL.tc_launches`` counts those launches); fp32 and every other shape
run on CUDA cores, :func:`row_block` rows a block.

The kernel contract is the TPU kernel's: ``chunk % page_size == 0``,
``chunk // page_size <= max_pages``, page-aligned starts and zeroed pools;
past a slot's live length it writes whole pages, where the plain version
sends dead positions to page 0.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .mla_paged import TC_KEYS, check_latent, requirer, tensor_core_path  # noqa: F401 (TC_KEYS: its tile)
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla_prefill", "mla_prefill_launch",
    [_I, _I] + [_P] * 10 + [_I] * 10 + [ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:180",
)
# query rows a CUDA-core block holds (chunk-major: position x head): 32 at
# full width, two positions of 16 heads, keeps Q, one key tile and the fp32
# accumulator within a block's shared memory
MAX_ROW_BLOCK = 32


def row_block(page_size: int, heads: int) -> int:
    """The largest divisor of ``page_size * heads`` up to MAX_ROW_BLOCK."""
    rows = page_size * heads
    return max(d for d in range(1, min(rows, MAX_ROW_BLOCK) + 1) if rows % d == 0)


def check_chunk(require, q_lat, q_pe, new, block_tables, start_lens,
                chunk_lens, page_size: int):
    """Shapes and types of a prefill launch's queries, chunk and scalars."""
    b, h, chunk, r = q_lat.shape
    max_pages = block_tables.shape[1]
    require(tuple(q_pe.shape[:3]) == (b, h, chunk),
            f"q_pe {tuple(q_pe.shape)} against q_lat {tuple(q_lat.shape)}")
    for name, t in new:
        require(tuple(t.shape[:2]) == (b, chunk), f"{name} must be (B, C, .)")
    require(chunk % page_size == 0 and chunk // page_size <= max_pages,
            f"chunk {chunk} must be a multiple of page_size {page_size} "
            f"spanning at most max_pages {max_pages}")
    for name, t in (("start_lens", start_lens), ("chunk_lens", chunk_lens)):
        require(t.dtype == torch.int32 and tuple(t.shape) == (b,),
                f"{name} must be (B,) int32")
    require(block_tables.shape[0] == b, "one table row per slot")


def launch_args(q_lat, q_pe, block_tables, start_lens, chunk_lens):
    """Contiguous queries and scalars, and the output to fill."""
    q, qp = q_lat.contiguous(), q_pe.contiguous()
    scalars = [t.contiguous() for t in (block_tables, start_lens, chunk_lens)]
    return q, qp, scalars, torch.empty_like(q)


def mla_prefill(q_lat, q_pe, ckv_new, kpe_new, ckv_pages, kpe_pages,
                block_tables, start_lens, chunk_lens, *,
                sm_scale: Optional[float] = None,
                window: Optional[int] = None):
    """``q_lat`` (B, H, C, R), ``q_pe`` (B, H, C, Dpe); the chunk's
    ``ckv_new`` (B, C, R) and ``kpe_new`` (B, C, Dpe); pools (P, page_size,
    R) and (P, page_size, Dpe) of q's dtype; ``block_tables`` (B,
    max_pages) int32; ``start_lens``/``chunk_lens`` (B,) int32.  Returns
    ``(out (B, H, C, R), ckv_pages, kpe_pages)``, the pools updated."""
    if not q_lat.is_cuda:
        return ref.paged_mla_prefill(
            q_lat, q_pe, ckv_new, kpe_new, ckv_pages, kpe_pages, block_tables,
            start_lens, chunk_lens, sm_scale=sm_scale, window=window)
    require = requirer("mla_prefill")
    b, h, chunk, r = q_lat.shape
    num_pages, page_size, _ = ckv_pages.shape
    pe = q_pe.shape[-1]
    isz = q_lat.element_size()
    ckv, kpe = ckv_new.contiguous(), kpe_new.contiguous()
    check_latent(require, q_lat, q_pe,
                 (("q_pe", q_pe), ("ckv_new", ckv), ("kpe_new", kpe),
                  ("ckv_pages", ckv_pages), ("kpe_pages", kpe_pages),
                  ("block_tables", block_tables), ("start_lens", start_lens),
                  ("chunk_lens", chunk_lens)),
                 block_tables, page_size, (r * isz, pe * isz), window)
    check_chunk(require, q_lat, q_pe, (("ckv_new", ckv), ("kpe_new", kpe)),
                block_tables, start_lens, chunk_lens, page_size)
    require(all(t.dtype == q_lat.dtype for t in (ckv, kpe, ckv_pages, kpe_pages)),
            "chunk, pools and queries must share one dtype")
    require(ckv.shape[2] == r and kpe.shape[2] == pe
            and tuple(ckv_pages.shape) == (num_pages, page_size, r)
            and tuple(kpe_pages.shape) == (num_pages, page_size, pe),
            f"pools {tuple(ckv_pages.shape)} / {tuple(kpe_pages.shape)}")
    require(ckv.data_ptr() % 16 == 0 and kpe.data_ptr() % 16 == 0,
            "the chunk's latents must be 16-byte aligned")
    q, qp, (tables, starts, lens), out = launch_args(
        q_lat, q_pe, block_tables, start_lens, chunk_lens)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(r + pe)
    tc = tensor_core_path(q.dtype, r, pe, page_size)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), qp.data_ptr(), ckv.data_ptr(),
            kpe.data_ptr(), ckv_pages.data_ptr(), kpe_pages.data_ptr(),
            tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, chunk, r, pe, page_size,
            row_block(page_size, h), tables.shape[1], num_pages,
            window if window is not None else 0, scale, stream)
    check(rc, "mla_prefill")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out, ckv_pages, kpe_pages
