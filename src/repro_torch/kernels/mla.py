"""Contiguous MLA decode (FlashMLA): the wrapper around ``csrc/mla.cu``.

Counterpart of ``repro.kernels.mla.mla_program`` (repro/kernels/mla.py:33,
the paper's Fig. 18): latent queries ``q`` (B, Hq, D) and rotary queries
``q_pe`` (B, Hq, Dpe) against a contiguous latent cache ``kv`` (B, S, Hkv,
D) and ``k_pe`` (B, S, Hkv, Dpe), Hq / Hkv heads a latent head, V the
latent itself; fp32, bf16 or fp16.  The plain version is ``ref.mla``; this
wrapper takes it for CPU tensors only.  For a CUDA tensor it launches the
kernel or raises, on one of two paths (:func:`tensor_core_path`):

* ``wgmma``, bf16 / fp16 at D 512 with D + Dpe a multiple of 64 up to
  ``TC_MAX_DK`` (the paper's shapes, deepseek-v2-lite's heads): 64 heads of
  a latent head a block, a TMA producer and two consumer warpgroups over
  tiles of ``TC_KEYS`` keys, P as the 16-bit pair hi + lo (``csrc/mla.cu``
  has the design); counted in ``KERNEL.tc_launches``;
* CUDA cores, everything else: up to 16 heads of a latent head a block
  (``mla_paged.head_block``: 128 heads x 512 fp32 accumulators do not fit
  one block).

Both read Q and the cache through their own 16-byte loads or TMA, so every
tensor must be 16-byte aligned.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .matmul import DTYPES
from .mla_paged import head_block

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "mla", "mla_launch", [_I, _I, _P, _P, _P, _P, _P, *([_I] * 7), ctypes.c_float, _P],
    replaces="src/repro/kernels/mla.py:33",
)
TC_RANK = 512  # the latent width the wgmma kernel is built for
TC_KEYS = 32  # keys a tile of its walk
TC_MAX_DK = 832  # the widest D + Dpe whose Q and two key stages fit shared memory


def tensor_core_path(dtype: torch.dtype, d: int, pe: int) -> bool:
    """Whether a launch takes the wgmma kernel (``csrc/mla.cu``'s
    ``tc_takes``): 16-bit elements at latent width 512 with D + Dpe a
    multiple of 64 (the 64-column TMA boxes) up to ``TC_MAX_DK``.  Batch,
    heads, latent heads and sequence length do not matter."""
    return (dtype in (torch.bfloat16, torch.float16) and d == TC_RANK and pe > 0
            and (d + pe) % 64 == 0 and d + pe <= TC_MAX_DK)


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"mla kernel: {msg}")


def mla(q: torch.Tensor, q_pe: torch.Tensor, kv: torch.Tensor, k_pe: torch.Tensor, *,
        sm_scale: Optional[float] = None) -> torch.Tensor:
    """-> (B, Hq, D) in ``q``'s dtype; ``sm_scale`` defaults to
    1 / sqrt(D + Dpe)."""
    if not q.is_cuda:
        return ref.mla(q, q_pe, kv, k_pe, sm_scale=sm_scale)
    _require(q.dim() == 3 and q_pe.dim() == 3 and kv.dim() == 4 and k_pe.dim() == 4,
             "q, q_pe (B, Hq, .) and kv, k_pe (B, S, Hkv, .)")
    b, hq, d = q.shape
    pe = q_pe.shape[-1]
    s, hkv = kv.shape[1], kv.shape[2]
    _require(tuple(q_pe.shape) == (b, hq, pe) and tuple(kv.shape) == (b, s, hkv, d)
             and tuple(k_pe.shape) == (b, s, hkv, pe),
             f"shapes q {tuple(q.shape)}, q_pe {tuple(q_pe.shape)}, kv {tuple(kv.shape)}, "
             f"k_pe {tuple(k_pe.shape)}")
    _require(hkv >= 1 and hq % hkv == 0, f"{hq} query heads over {hkv} latent heads")
    _require(s >= 1 and 1 <= b <= 65535, f"batch {b}, seq {s}")
    for name, t in (("q_pe", q_pe), ("kv", kv), ("k_pe", k_pe)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        _require(t.dtype == q.dtype, f"{name} is {t.dtype}, q {q.dtype}")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32, bfloat16 or float16)")
    vec = 16 // q.element_size()
    _require(d % vec == 0 and pe % vec == 0,
             f"D {d} and Dpe {pe} must be multiples of 16 bytes' worth of elements")
    q, q_pe, kv, k_pe = (t.contiguous() for t in (q, q_pe, kv, k_pe))
    _require(all(t.data_ptr() % 16 == 0 for t in (q, q_pe, kv, k_pe)),
             "q, q_pe, kv and k_pe must be 16-byte aligned")
    tc = tensor_core_path(q.dtype, d, pe)
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d + pe)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), q_pe.data_ptr(), kv.data_ptr(),
            k_pe.data_ptr(), out.data_ptr(), b, hq, hkv, s, d, pe, head_block(hq // hkv),
            scale, stream)
    check(rc, "mla")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out
