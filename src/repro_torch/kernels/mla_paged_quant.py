"""Quantized paged MLA decode: the wrapper around the quantized entry point
of ``csrc/mla_paged.cu``.

Counterpart of ``repro.kernels.mla.mla_paged_quant_program``
(repro/kernels/mla.py:301): the decode kernel of ``mla_paged.py`` over
packed int8 / int4 latent and rope pools, each with its own per-token scale
pool; a page's latent columns are dequantized with the latent scale and its
rope columns with the rope scale on their way into shared memory, each value
rounded once to the query's dtype as the TPU kernel does.  The plain version
is ``ref.mla_paged_quant``; this wrapper takes it for CPU tensors only.  For
a CUDA tensor it launches the kernel or raises.

The kernel's grid (split-KV from static shapes, then the merge) and paths
(bf16 at latent width 512 on the tensor cores, each packed tile staged and
dequantized into the bf16 tile, ``KERNEL.tc_launches`` counting them; the
rest on CUDA cores) are ``mla_paged.py``'s.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .mla_paged import check_latent, decode_launch, requirer, tensor_core_path
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla_paged_quant", "mla_paged_quant_launch",
    [_I, _I, _I] + [_P] * 11 + [_I] * 11 + [ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:301",
    source="mla_paged",
)


def mla_paged_quant(q_lat, q_pe, ckv_pages, kpe_pages, ckv_scales, kpe_scales,
                    block_tables, seq_lens, *, fmt: str = "int8",
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """``q_lat`` (B, H, R), ``q_pe`` (B, H, Dpe); packed pools (P,
    page_size, R // pack) and (P, page_size, Dpe // pack) int8 with scales
    (P, page_size, 1) of q's dtype; ``block_tables`` (B, max_pages) int32;
    ``seq_lens`` (B,) int32 -> (B, H, R)."""
    if not q_lat.is_cuda:
        return ref.mla_paged_quant(
            q_lat, q_pe, ckv_pages, kpe_pages, ckv_scales, kpe_scales,
            block_tables, seq_lens, fmt=fmt, sm_scale=sm_scale, window=window)
    require = requirer("mla_paged_quant")
    require(fmt in ref.KV_PACK, f"format {fmt!r} (int8 or int4)")
    pack = ref.KV_PACK[fmt]
    r = q_lat.shape[-1]
    num_pages, page_size, rp = ckv_pages.shape
    pe = q_pe.shape[-1]
    check_latent(require, q_lat, q_pe,
                 (("q_pe", q_pe), ("ckv_pages", ckv_pages),
                  ("kpe_pages", kpe_pages), ("ckv_scale_pages", ckv_scales),
                  ("kpe_scale_pages", kpe_scales),
                  ("block_tables", block_tables), ("seq_lens", seq_lens)),
                 block_tables, page_size, (r // pack, pe // pack), window)
    require(ckv_pages.dtype == torch.int8 and kpe_pages.dtype == torch.int8,
            "packed pools must be int8")
    require(ckv_scales.dtype == q_lat.dtype and kpe_scales.dtype == q_lat.dtype,
            "scale pools and queries must share one dtype")
    require(rp * pack == r and pe % pack == 0
            and tuple(kpe_pages.shape) == (num_pages, page_size, pe // pack),
            f"pools {tuple(ckv_pages.shape)} / {tuple(kpe_pages.shape)} ({fmt}) against "
            f"q_lat {tuple(q_lat.shape)}, q_pe {tuple(q_pe.shape)}")
    require(tuple(ckv_scales.shape) == (num_pages, page_size, 1)
            and kpe_scales.shape == ckv_scales.shape, "scales (P, ps, 1)")
    q, qp, out, args = decode_launch(require, q_lat, q_pe, block_tables, seq_lens,
                                     num_pages, page_size, window, sm_scale)
    tc = tensor_core_path(q.dtype, r, pe, page_size)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), pack, q.data_ptr(), qp.data_ptr(),
            ckv_pages.data_ptr(), kpe_pages.data_ptr(), ckv_scales.data_ptr(),
            kpe_scales.data_ptr(), *args, stream)
    check(rc, "mla_paged_quant")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out
