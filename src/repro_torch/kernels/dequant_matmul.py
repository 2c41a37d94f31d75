"""The kernel library's weight-only dequantized GEMM: the wrapper around
``csrc/dequant_matmul.cu``.

Counterpart of ``repro.kernels.dequant_matmul.dequant_matmul_program``
(repro/kernels/dequant_matmul.py:25, the paper's Fig. 15/17):
``A (M, K) . dequant(B)^T -> (M, N)`` with B stored (N, K / pack) int8 in
int8, int4, int2 or nf4 (low bits first) and optional per-group scales
(N, K / group).  Activations fp32, bf16, fp16 or int8.  The plain version
is ``ref.dequant_matmul``; this wrapper takes it for CPU tensors only.  For
a CUDA tensor it launches the kernel or raises; in particular a scale group
the kernel cannot take (one that does not divide K, or that the pack factor
does not divide) raises, where the reference's ``ops.dequant_matmul`` would
quietly take its plain path.

With 16-bit activations the kernel multiplies, as the TPU kernel does, the
weight cast to the activation type and scaled in it; the plain version
keeps both in fp32 (csrc/dequant_matmul.cu says where that rounds).
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import Kernel, check
from .matmul import DTYPES as OUT_DTYPES
from .matmul import MAX_ROWS

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "dequant_matmul", "dequant_matmul_launch",
    [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    replaces="src/repro/kernels/dequant_matmul.py:25",
)
DTYPES = {**OUT_DTYPES, torch.int8: 3}
FORMATS = {"int8": 0, "int4": 1, "int2": 2, "nf4": 3}


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"dequant_matmul kernel: {msg}")


def scale_group(k: int, scales) -> int:
    """The K extent one scale covers: K over the scales' columns."""
    return k // scales.shape[1] if scales is not None else 128


def takes_tensor_cores(dtype, fmt: str, k: int, scaled: bool, *tensors) -> bool:
    """Whether the tensor-core kernel takes these operands: 16-bit
    activations, or int8 ones with integer codes and no scales (exact in
    fp16); K and K / pack multiples of 16; 16-byte aligned data."""
    pack = ref.WEIGHT_PACK[fmt]
    if dtype == torch.int8:
        ok = fmt != "nf4" and not scaled
    else:
        ok = dtype in (torch.bfloat16, torch.float16)
    return (ok and k % 16 == 0 and (k // pack) % 16 == 0
            and all(t.data_ptr() % 16 == 0 for t in tensors))


def dequant_matmul(a: torch.Tensor, b_packed: torch.Tensor, fmt: str = "int4",
                   scales=None, out_dtype=None) -> torch.Tensor:
    """``a`` (M, K), ``b_packed`` (N, K // pack) int8, ``scales`` None or
    (N, K // group) -> (M, N) of ``out_dtype`` (default: ``a``'s dtype)."""
    out_dtype = out_dtype or a.dtype
    if not a.is_cuda:
        return ref.dequant_matmul(a, b_packed, fmt, scales,
                                  scale_group(a.shape[1], scales), out_dtype)
    _require(fmt in FORMATS, f"format {fmt!r} (one of {sorted(FORMATS)})")
    pack = ref.WEIGHT_PACK[fmt]
    _require(a.dim() == 2 and b_packed.dim() == 2, "a and b_packed must be 2-D")
    m, k = a.shape
    n = b_packed.shape[0]
    _require(k % pack == 0 and b_packed.shape[1] == k // pack,
             f"b_packed {tuple(b_packed.shape)} for K {k} in {fmt} ({pack} a byte)")
    _require(a.dtype in DTYPES, f"activation dtype {a.dtype}")
    _require(b_packed.dtype == torch.int8, f"b_packed dtype {b_packed.dtype} (int8)")
    _require(out_dtype in OUT_DTYPES,
             f"out_dtype {out_dtype} (float32, bfloat16 or float16)")
    _require(min(m, n, k) >= 1 and m <= MAX_ROWS and max(n, k) < 2 ** 31,
             f"M, N, K = {m}, {n}, {k}")
    tensors = [("b_packed", b_packed)] + ([("scales", scales)] if scales is not None else [])
    for name, t in tensors:
        _require(t.device == a.device, f"{name} is on {t.device}, a on {a.device}")
    group = 0
    if scales is not None:
        _require(scales.dim() == 2 and scales.shape[0] == n and scales.shape[1] >= 1,
                 f"scales {tuple(scales.shape)} for N {n}")
        _require(scales.dtype.is_floating_point, f"scales dtype {scales.dtype}")
        group = k // scales.shape[1]
        _require(group * scales.shape[1] == k and group % pack == 0,
                 f"{scales.shape[1]} scale groups over K {k}: a group must divide K "
                 f"and be a multiple of {fmt}'s {pack} codes a byte")
        sdt = a.dtype if a.dtype in (torch.bfloat16, torch.float16) else torch.float32
        scales = scales.to(sdt).contiguous()
    a, b_packed = a.contiguous(), b_packed.contiguous()
    # the kernel writes float32 or the activations' own 16-bit type; any
    # other output type is its float32 result rounded once more here
    kernel_out = out_dtype if out_dtype in (torch.float32, a.dtype) else torch.float32
    out = torch.empty((m, n), dtype=kernel_out, device=a.device)
    tc = takes_tensor_cores(a.dtype, fmt, k, scales is not None, a, b_packed)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[a.dtype], OUT_DTYPES[kernel_out], FORMATS[fmt], a.data_ptr(),
            b_packed.data_ptr(), scales.data_ptr() if scales is not None else None,
            out.data_ptr(), m, n, k, group, int(tc), stream)
    check(rc, "dequant_matmul")
    KERNEL.launches += 1
    return out if kernel_out == out_dtype else out.to(out_dtype)
