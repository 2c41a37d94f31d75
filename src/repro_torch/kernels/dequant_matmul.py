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

Two routes (:func:`route`): ``wgmma``, the warp-specialised walk of
``csrc/dequant_wgmma.cuh`` (16-bit activations in every format; int8 ones
with integer codes and no scales; K and K / pack multiples of 16; 16-byte
aligned data), from M = 1 up, a block of 64 weight rows by
:func:`block_rows` activation rows (:func:`grid`, :func:`tile_plan`); and
the CUDA cores for everything else.  ``KERNEL.tc_launches`` counts the
``wgmma`` launches.  The walk's tile constants are stated here once and
reach the source as ``-D`` macros (``KERNEL.defines``).

The same module holds ``dequant_matmul_program`` itself, the tile program
that the port's compiler (``repro_torch.core``) compiles with
``target="cuda"`` or runs with ``target="reference"``, and its
``PARITY_CASES``.  The CUDA backend takes every format: nf4's codebook
lookup, a ``T.call_tile_lib`` (a torch function over
``ref.NF4_CODEBOOK``), is rewritten into T ops by
``core/backends/tile_lib.py`` before it emits.
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

# The wgmma walk's tile constants (csrc/dequant_wgmma.cuh's Plan), passed to
# the source as -D macros: the activation bytes a stage at most, the ring's
# bytes, the stages at most, the ladder of activation rows a block (powers of
# two), and the consumer warpgroups a block at BM <= 64 (the decode's warps)
# and above.  The ring holds six 36 KB stages at BM 256.
ACT_STAGE = 16384
RING = 221184
MAX_STAGES = 16
MIN_BM, MAX_BM = 8, 256
CONSUMERS_SMALL, CONSUMERS_LARGE = 4, 2
WEIGHT_ROW = 128  # weight bytes a row a stage at most: one 128-byte swizzle span
ROWS = 64  # weight rows a block: one warpgroup product's M
MAX_SMEM = 232448  # the most shared memory a block may take (H100)
S8_MAX_K = 1 << 17  # int8 activations: the int32 sums of codes scaled up to 64x stay exact
DEFINES = {"DQ_ACT_STAGE": ACT_STAGE, "DQ_RING": RING, "DQ_MAX_STAGES": MAX_STAGES,
           "DQ_MIN_BM": MIN_BM, "DQ_MAX_BM": MAX_BM, "DQ_CONSUMERS_SMALL": CONSUMERS_SMALL,
           "DQ_CONSUMERS_LARGE": CONSUMERS_LARGE}
KERNEL = Kernel(
    "dequant_matmul", "dequant_matmul_launch",
    [_I, _I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    replaces="src/repro/kernels/dequant_matmul.py:25",
    defines=DEFINES,
)
DTYPES = {**OUT_DTYPES, torch.int8: 3}
FORMATS = {"int8": 0, "int4": 1, "int2": 2, "nf4": 3}
ROUTES = {"cuda": 0, "wgmma": 1}  # the C entry point's route argument


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"dequant_matmul kernel: {msg}")


def scale_group(k: int, scales) -> int:
    """The K extent one scale covers: K over the scales' columns."""
    return k // scales.shape[1] if scales is not None else 128


def route(dtype, fmt: str, k: int, scaled: bool, *tensors) -> str:
    """``wgmma`` for 16-bit activations, or int8 ones with integer codes, no
    scales and K at most S8_MAX_K; K and K / pack multiples of 16 (TMA's
    16-byte rows, the walk's whole products); 16-byte aligned data.
    ``cuda`` (the CUDA cores) otherwise."""
    pack = ref.WEIGHT_PACK[fmt]
    if dtype == torch.int8:
        ok = fmt != "nf4" and not scaled and k <= S8_MAX_K
    else:
        ok = dtype in (torch.bfloat16, torch.float16)
    ok = (ok and k % 16 == 0 and (k // pack) % 16 == 0
          and all(t.data_ptr() % 16 == 0 for t in tensors))
    return "wgmma" if ok else "cuda"


def block_rows(m: int) -> int:
    """Activation rows a block (the product's N): the smallest power of two
    from MIN_BM that holds M, MAX_BM above it."""
    bm = MIN_BM
    while bm < m and bm < MAX_BM:
        bm *= 2
    return bm


def grid(m: int, n: int) -> tuple:
    """The walk's grid: (weight-row blocks, activation-row blocks).  At M <=
    MAX_BM one activation block, so each weight tile is decoded once."""
    return -(-n // ROWS), -(-m // block_rows(m))


def _pow2_floor(x: int) -> int:
    p = 1
    while 2 * p <= x:
        p *= 2
    return p


def tile_plan(bm: int, act_bytes: int, pack: int) -> dict:
    """A walk block's tiles (dequant_wgmma.cuh's Plan, the same rule): its
    consumer warpgroups and threads (the producer's warpgroup first), k a
    stage ``bk`` (WEIGHT_ROW weight bytes a row at most, ACT_STAGE
    activation bytes at most, one 128-byte activation box at least), weight
    bytes a row a stage ``wb`` (one TMA box), the stage's bytes, the ring's stages (a multiple of the consumers, so that
    each stage serves one consumer, and twice them at least: a stage is
    released at its consumer's next stage), the products a stage and a
    register group, and the block's dynamic shared memory."""
    consumers = CONSUMERS_SMALL if bm <= 64 else CONSUMERS_LARGE
    kstep = 16 if act_bytes == 2 else 32
    kbox = 128 // act_bytes
    bk = max(kbox, min(WEIGHT_ROW * pack, _pow2_floor(ACT_STAGE // (bm * act_bytes))))
    wb = bk // pack
    stage = bm * bk * act_bytes + ROWS * wb
    stages = max(2 * consumers, min(MAX_STAGES, RING // stage) // consumers * consumers)
    steps = bk // kstep
    chunk = 4 if steps >= 8 else steps // 2
    return dict(consumers=consumers, threads=(consumers + 1) * 128, bk=bk, wb=wb,
                boxes=bk // kbox, stage=stage, stages=stages, steps=steps, chunk=chunk,
                chunks=steps // chunk, smem=stages * stage + 1024)


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
    path = route(a.dtype, fmt, k, scales is not None, a, b_packed)
    if path == "wgmma":
        smem = tile_plan(block_rows(m), a.element_size(), pack)["smem"]
        _require(smem <= MAX_SMEM, f"the walk's shared memory at this shape ({smem} bytes)")
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[a.dtype], OUT_DTYPES[kernel_out], FORMATS[fmt], a.data_ptr(),
            b_packed.data_ptr(), scales.data_ptr() if scales is not None else None,
            out.data_ptr(), m, n, k, group, ROUTES[path], stream)
    check(rc, "dequant_matmul")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(path == "wgmma")
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
