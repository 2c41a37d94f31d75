"""Quantized MLA chunked prefill: the wrapper around the quantized entry
point of ``csrc/mla_prefill.cu``.

Counterpart of ``repro.kernels.mla.mla_prefill_quant_program``
(repro/kernels/mla.py:374).  The chunk arrives quantized (``kernels.ops``
quantizes it in plain torch, as the reference does at ops.py:626): packed
int8 / int4 latent and rope rows plus a per-token scale each.  The kernel
attends the prior pages dequantized page by page, then the chunk's own
dequantized round trip, and writes the chunk's packed bytes and both scales
into the four pools **in place** through the block table.  The plain
version is ``ref.paged_mla_prefill_quant``; this wrapper takes it for CPU
tensors only.  For a CUDA tensor it launches the kernel or raises.

The kernel's paths (bf16 at latent width 512 on the tensor cores, the
prior pages and the chunk dequantized into the bf16 key tile on their way
in, ``KERNEL.tc_launches`` counting them; the rest on CUDA cores) and its
contract are ``mla_prefill.py``'s.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .mla_paged import check_latent, requirer
from .mla_prefill import check_chunk, launch_args, row_block, tensor_core_path
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla_prefill_quant", "mla_prefill_quant_launch",
    [_I, _I, _I] + [_P] * 14 + [_I] * 10 + [ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:374",
    source="mla_prefill",
)


def mla_prefill_quant(q_lat, q_pe, ckv_q, kpe_q, ckv_s, kpe_s, ckv_pages,
                      kpe_pages, ckv_scales, kpe_scales, block_tables,
                      start_lens, chunk_lens, *, fmt: str = "int8",
                      sm_scale: Optional[float] = None,
                      window: Optional[int] = None):
    """``q_lat`` (B, H, C, R), ``q_pe`` (B, H, C, Dpe); the quantized chunk
    ``ckv_q`` (B, C, R // pack) and ``kpe_q`` (B, C, Dpe // pack) int8 with
    scales ``ckv_s``/``kpe_s`` (B, C, 1); packed pools (P, page_size,
    · // pack) int8 and scale pools (P, page_size, 1) of q's dtype;
    ``block_tables`` (B, max_pages) int32; ``start_lens``/``chunk_lens``
    (B,) int32.  Returns ``(out (B, H, C, R), ckv_pages, kpe_pages,
    ckv_scales, kpe_scales)``, the pools updated."""
    if not q_lat.is_cuda:
        return ref.paged_mla_prefill_quant(
            q_lat, q_pe, ckv_q, kpe_q, ckv_s, kpe_s, ckv_pages, kpe_pages,
            ckv_scales, kpe_scales, block_tables, start_lens, chunk_lens,
            fmt=fmt, sm_scale=sm_scale, window=window)
    require = requirer("mla_prefill_quant")
    require(fmt in ref.KV_PACK, f"format {fmt!r} (int8 or int4)")
    pack = ref.KV_PACK[fmt]
    b, h, chunk, r = q_lat.shape
    num_pages, page_size, _ = ckv_pages.shape
    pe = q_pe.shape[-1]
    new = [t.contiguous() for t in (ckv_q, kpe_q, ckv_s, kpe_s)]
    check_latent(require, q_lat, q_pe,
                 (("q_pe", q_pe), ("ckv_q", new[0]), ("kpe_q", new[1]),
                  ("ckv_s", new[2]), ("kpe_s", new[3]),
                  ("ckv_pages", ckv_pages), ("kpe_pages", kpe_pages),
                  ("ckv_scale_pages", ckv_scales),
                  ("kpe_scale_pages", kpe_scales),
                  ("block_tables", block_tables), ("start_lens", start_lens),
                  ("chunk_lens", chunk_lens)),
                 block_tables, page_size, (r // pack, pe // pack), window)
    check_chunk(require, q_lat, q_pe, zip(("ckv_q", "kpe_q", "ckv_s", "kpe_s"), new),
                block_tables, start_lens, chunk_lens, page_size)
    require(all(t.dtype == torch.int8 for t in (*new[:2], ckv_pages, kpe_pages)),
            "packed chunk and pools must be int8")
    require(all(t.dtype == q_lat.dtype for t in (*new[2:], ckv_scales, kpe_scales)),
            "scales and queries must share one dtype")
    require(new[0].shape[2] * pack == r and new[1].shape[2] * pack == pe
            and new[2].shape[2] == 1 and new[3].shape[2] == 1
            and tuple(ckv_pages.shape) == (num_pages, page_size, r // pack)
            and tuple(kpe_pages.shape) == (num_pages, page_size, pe // pack)
            and tuple(ckv_scales.shape) == (num_pages, page_size, 1)
            and kpe_scales.shape == ckv_scales.shape,
            f"pools {tuple(ckv_pages.shape)} / {tuple(kpe_pages.shape)} ({fmt})")
    require(new[0].data_ptr() % 16 == 0 and new[1].data_ptr() % 16 == 0,
            "the chunk's packed rows must be 16-byte aligned")
    q, qp, (tables, starts, lens), out = launch_args(
        q_lat, q_pe, block_tables, start_lens, chunk_lens)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(r + pe)
    tc = tensor_core_path(q.dtype, r, pe, page_size)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), pack, q.data_ptr(), qp.data_ptr(),
            *(t.data_ptr() for t in new), ckv_pages.data_ptr(),
            kpe_pages.data_ptr(), ckv_scales.data_ptr(), kpe_scales.data_ptr(),
            tables.data_ptr(), starts.data_ptr(), lens.data_ptr(),
            out.data_ptr(), b, h, chunk, r, pe, page_size,
            row_block(page_size, h), tables.shape[1], num_pages,
            window if window is not None else 0, scale, stream)
    check(rc, "mla_prefill_quant")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out, ckv_pages, kpe_pages, ckv_scales, kpe_scales
