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

The same module holds ``dequant_matmul_program`` itself, the tile program
that the port's compiler (``repro_torch.core``) compiles with
``target="cuda"`` or runs with ``target="reference"``, and its
``PARITY_CASES``.  The CUDA backend takes the int8, int4 and int2 formats;
nf4's codebook lookup is a ``T.call_tile_lib`` (a torch function over
``ref.NF4_CODEBOOK``), which only the reference interpreter runs yet.
The program sets its function's ``__annotations__`` itself, so the
``T.Tensor`` objects reach the tracer under the ``annotations`` import.
"""
from __future__ import annotations

import ctypes

import torch

from ..core import TileProgram
from ..core import lang as T
from ..core.buffer import torch_dtype
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


# ---------------------------------------------------------------------------
# The tile program (repro/kernels/dequant_matmul.py:25, the paper's Fig.
# 15/17): the packed weight tile streams through a shared window, is
# unpacked to the compute dtype inside the kernel by shift / mask arithmetic
# over its int8 bytes, then meets the activations in T.gemm.
# ---------------------------------------------------------------------------


def dequant_matmul_program(
    M: int,
    N: int,
    K: int,
    fmt: str = "int4",
    in_dtype: str = "float32",
    out_dtype: str = "float32",
    accum_dtype: str = "float32",
    block_M: int = 64,
    block_N: int = 64,
    block_K: int = 64,
    num_stages: int = 2,
    with_scales: bool = False,
) -> TileProgram:
    """C^T[N, M] = dequant(B)[N, K] @ A[M, K]^T  (the paper's transposed layout)."""
    if fmt not in ref.WEIGHT_PACK:
        raise ValueError(f"unknown quant format {fmt}")
    pack = ref.WEIGHT_PACK[fmt]
    if block_K % pack:
        raise ValueError("block_K must be a multiple of the pack factor")
    storage_dtype = "int8"
    if M % block_M or N % block_N or K % block_K:
        raise ValueError("blocks must divide problem shape")

    params = dict(
        A=T.Tensor((M, K), in_dtype),
        B=T.Tensor((N, K // pack), storage_dtype),
        Ct=T.Tensor((N, M), out_dtype),
    )
    if with_scales:
        params["Scales"] = T.Tensor((N, K // block_K), in_dtype)

    def body(A, B, Ct, Scales=None):
        with T.Kernel(T.ceildiv(N, block_N), T.ceildiv(M, block_M), threads=128) as (bx, by):
            A_shared = T.alloc_shared((block_M, block_K), in_dtype)
            B_shared = T.alloc_shared((block_N, block_K // pack), storage_dtype)
            B_local = T.alloc_fragment((block_N, block_K // pack), storage_dtype)
            B_dequant = T.alloc_fragment((block_N, block_K), in_dtype)
            Ct_local = T.alloc_fragment((block_N, block_M), accum_dtype)
            if with_scales:
                S_shared = T.alloc_shared((block_N, 1), in_dtype)

            T.clear(Ct_local)
            for k in T.Pipelined(T.ceildiv(K, block_K), num_stages=num_stages):
                T.copy(A[by * block_M, k * block_K], A_shared)
                T.copy(B[bx * block_N, k * (block_K // pack)], B_shared)
                if with_scales:
                    T.copy(Scales[bx * block_N, k], S_shared)
                T.copy(B_shared, B_local)
                if fmt == "int4":
                    for i, j in T.Parallel(block_N, block_K):
                        v = (B_local[i, j // 2] >> ((j % 2) * 4)) & 15
                        v = T.if_then_else(v >= 8, v - 16, v)
                        B_dequant[i, j] = T.cast(v, in_dtype)
                elif fmt == "int2":
                    for i, j in T.Parallel(block_N, block_K):
                        v = (B_local[i, j // 4] >> ((j % 4) * 2)) & 3
                        v = T.if_then_else(v >= 2, v - 4, v)
                        B_dequant[i, j] = T.cast(v, in_dtype)
                elif fmt == "int8":
                    for i, j in T.Parallel(block_N, block_K):
                        B_dequant[i, j] = T.cast(B_local[i, j], in_dtype)
                else:  # nf4: the codebook through the tile-library escape hatch

                    def _nf4_decode(packed):
                        # (block_N, block_K // 2) int8 -> (block_N, block_K)
                        # codebook values, low nibble first
                        return ref.unpack_nf4(packed).to(torch_dtype(in_dtype))

                    T.call_tile_lib(_nf4_decode, B_dequant, B_local, name="nf4_decode")
                if with_scales:
                    for i, j in T.Parallel(block_N, block_K):
                        B_dequant[i, j] = B_dequant[i, j] * S_shared[i, 0]
                T.gemm(B_dequant, A_shared, Ct_local, transpose_B=True)
            T.copy(Ct_local, Ct[bx * block_N, by * block_M])

    # a prim_func with the right signature (scales optional)
    if with_scales:

        def fn(A: params["A"], B: params["B"], Ct: params["Ct"], Scales: params["Scales"]):
            body(A, B, Ct, Scales)

    else:

        def fn(A: params["A"], B: params["B"], Ct: params["Ct"]):
            body(A, B, Ct)

    fn.__name__ = f"dequant_matmul_{fmt}"
    fn.__annotations__ = dict(params)
    return T.prim_func(fn)


# Tiny-shape configs of the backend-parity suite (the JAX module's): int4
# the two-way sub-byte unpack, int8 the straight cast, int2 the four-way
# unpack, nf4 the codebook through T.call_tile_lib; the odd-K int4 case
# (K 48: 3 K-blocks) a K no multiple of block_K * pack.
PARITY_CASES = [
    (
        "dequant_matmul_int4",
        dict(M=16, N=16, K=32, fmt="int4", block_M=16, block_N=16, block_K=16),
    ),
    (
        "dequant_matmul_int4_oddk",
        dict(M=16, N=16, K=48, fmt="int4", block_M=16, block_N=16, block_K=16),
    ),
    (
        "dequant_matmul_int8",
        dict(M=16, N=16, K=32, fmt="int8", block_M=16, block_N=16, block_K=16),
    ),
    (
        "dequant_matmul_int2",
        dict(M=16, N=16, K=32, fmt="int2", block_M=16, block_N=16, block_K=16),
    ),
    (
        "dequant_matmul_nf4",
        dict(M=16, N=16, K=32, fmt="nf4", block_M=16, block_N=16, block_K=16),
    ),
]


def parity_programs():
    for name, cfg in PARITY_CASES:
        yield name, dequant_matmul_program(**cfg)
