"""The kernel library's GEMM: the wrapper around ``csrc/matmul.cu``.

Counterpart of ``repro.kernels.matmul.matmul_program`` (repro/kernels/
matmul.py:15, the paper's Fig. 16): ``C = A . B`` for A (M, K) and B (K, N)
of one type (fp32, bf16 or fp16), fp32 accumulation, C rounded once to
``out_dtype``.  Any M, N, K.  The plain version is ``ref.matmul``; this
wrapper takes it for CPU tensors only.  For a CUDA tensor it launches the
kernel or raises, on one of three routes (:func:`route`): bf16 / fp16
operands with K and N multiples of 8 and 16-byte aligned data take the
tensor cores, ``wgmma`` fed by TMA from M = ``WGMMA_MIN_M`` (17) up and
``mma.sync`` below it (the GEMVs, M <= 16); everything else the kernel's
CUDA-core GEMM (fp32 FMAs, no TF32).  ``KERNEL.tc_launches`` counts the
``wgmma`` launches.

The same module holds ``matmul_program`` itself, the tile program that the
port's compiler (``repro_torch.core``) compiles with ``target="cuda"`` or
runs with ``target="reference"``, its ``PARITY_CASES``, and the cost-model
autotuner's ``default_configs`` and ``tune_matmul`` (repro/kernels/matmul.py:71-97).
"""

import ctypes
from typing import Optional

import torch

from ..core import TileProgram, autotune, grid_configs
from ..core import lang as T
from . import ref
from .build import Kernel, check

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "matmul", "matmul_launch", [_I, _I, _P, _P, _P, _I, _I, _I, _I, _P],
    replaces="src/repro/kernels/matmul.py:15",
)
# the kernel library's element types (the port's attention kernels take
# only float32 and bfloat16)
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
# the grid's row axis: ceil(M / 128) blocks at most 65535
MAX_ROWS = 65535 * 128


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"matmul kernel: {msg}")


def takes_tensor_cores(dtype, k: int, n: int, *tensors) -> bool:
    """Whether the tensor-core kernels take these operands: 16-bit
    elements, K and N multiples of 8 (16-byte rows) and 16-byte aligned
    data."""
    return (dtype in (torch.bfloat16, torch.float16) and k % 8 == 0
            and n % 8 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors))


WGMMA_MIN_M = 17  # M <= 16 (the GEMVs) stays on mma.sync's 16-row tiles
ROUTES = {"cuda": 0, "mma": 1, "wgmma": 2}


def route(dtype, m: int, k: int, n: int, *tensors) -> str:
    """The kernel's route for these operands: ``wgmma`` (16-bit, M >=
    WGMMA_MIN_M), ``mma`` (16-bit, M below it) or ``cuda`` (fp32, K or N not
    a multiple of 8, or unaligned data)."""
    if not takes_tensor_cores(dtype, k, n, *tensors):
        return "cuda"
    return "wgmma" if m >= WGMMA_MIN_M else "mma"


def matmul(a: torch.Tensor, b: torch.Tensor, *, out_dtype=None) -> torch.Tensor:
    """``a`` (M, K) @ ``b`` (K, N) -> (M, N) of ``out_dtype`` (default:
    ``a``'s dtype)."""
    out_dtype = out_dtype or a.dtype
    if not a.is_cuda:
        return ref.matmul(a, b, out_dtype)
    _require(a.dim() == 2 and b.dim() == 2 and a.shape[1] == b.shape[0],
             f"shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    _require(b.device == a.device, f"b is on {b.device}, a on {a.device}")
    _require(a.dtype in DTYPES and b.dtype == a.dtype,
             f"dtypes {a.dtype} / {b.dtype} (one of float32, bfloat16, float16)")
    _require(out_dtype in DTYPES, f"out_dtype {out_dtype}")
    m, k = a.shape
    n = b.shape[1]
    _require(min(m, n, k) >= 1 and m <= MAX_ROWS and max(n, k) < 2 ** 31,
             f"M, N, K = {m}, {n}, {k}")
    a, b = a.contiguous(), b.contiguous()
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    path = route(a.dtype, m, k, n, a, b)
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(DTYPES[a.dtype], DTYPES[out_dtype], a.data_ptr(),
                               b.data_ptr(), out.data_ptr(), m, n, k, ROUTES[path], stream)
    check(rc, "matmul")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(path == "wgmma")
    return out


# ---------------------------------------------------------------------------
# The tile program (repro/kernels/matmul.py:15, the paper's Fig. 16 almost
# verbatim): tiles of A and B stream through shared windows inside a
# pipelined reduction loop, accumulating into a fragment; scheduling (block
# shapes, stages, swizzle) arrives via the factory arguments.
# ---------------------------------------------------------------------------


def matmul_program(
    M: int,
    N: int,
    K: int,
    in_dtype: str = "float32",
    out_dtype: str = "float32",
    accum_dtype: str = "float32",
    block_M: int = 128,
    block_N: int = 128,
    block_K: int = 64,
    num_stages: int = 2,
    swizzle: Optional[int] = None,
) -> TileProgram:
    if M % block_M or N % block_N or K % block_K:
        raise ValueError(
            f"matmul {M}x{N}x{K}: blocks ({block_M},{block_N},{block_K}) must divide"
        )

    @T.prim_func
    def Matmul(
        A: T.Tensor((M, K), in_dtype),
        B: T.Tensor((K, N), in_dtype),
        C: T.Tensor((M, N), out_dtype),
    ):
        with T.Kernel(T.ceildiv(N, block_N), T.ceildiv(M, block_M), threads=128) as (bx, by):
            A_shared = T.alloc_shared((block_M, block_K), in_dtype)
            B_shared = T.alloc_shared((block_K, block_N), in_dtype)
            C_local = T.alloc_fragment((block_M, block_N), accum_dtype)
            if swizzle:
                T.use_swizzle(swizzle)
            T.clear(C_local)
            for k in T.Pipelined(T.ceildiv(K, block_K), num_stages=num_stages):
                T.copy(A[by * block_M, k * block_K], A_shared)
                T.copy(B[k * block_K, bx * block_N], B_shared)
                T.gemm(A_shared, B_shared, C_local)
            T.copy(C_local, C[by * block_M, bx * block_N])

    return Matmul


# Tiny-shape configs of the backend-parity suite; the swizzled case covers
# the flattened grid path (the CUDA backend's decode of blockIdx.x).
PARITY_CASES = [
    ("matmul_f32", dict(M=32, N=32, K=32, block_M=16, block_N=16, block_K=16)),
    (
        "matmul_swizzled",
        dict(M=32, N=32, K=32, block_M=16, block_N=16, block_K=16, swizzle=2),
    ),
]


def parity_programs():
    for name, cfg in PARITY_CASES:
        yield name, matmul_program(**cfg)


def default_configs(M: int, N: int, K: int):
    """Candidate schedules for the cost-model autotuner (the JAX module's)."""
    bms = [b for b in (256, 128, 64, 32) if M % b == 0]
    bns = [b for b in (256, 128, 64, 32) if N % b == 0]
    bks = [b for b in (512, 256, 128, 64, 32) if K % b == 0]
    return grid_configs(
        block_M=bms or [M],
        block_N=bns or [N],
        block_K=bks or [K],
        num_stages=[2, 3],
    )


def tune_matmul(M, N, K, in_dtype="bfloat16", out_dtype="bfloat16", schedule=None):
    """``matmul_program`` at the blocks the cost model scores best on the
    card, compiled for it: ``(kernel, winner)``."""

    def build(**cfg):
        return matmul_program(M, N, K, in_dtype, out_dtype, "float32", **cfg)

    return autotune(
        build,
        [c for c in default_configs(M, N, K)
         if M % c["block_M"] == 0 and N % c["block_N"] == 0 and K % c["block_K"] == 0],
        schedule=schedule,
        cache_key=("matmul", M, N, K, in_dtype),
    )
