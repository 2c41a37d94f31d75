"""Mamba-2 SSD linear attention as tile programs (the paper's Table 4,
Fig. 12): the port of ``repro.kernels.linear_attention``
(repro/kernels/linear_attention.py:21-122), which the port's compiler
(``repro_torch.core``) compiles with ``target="cuda"`` or runs with
``target="reference"``.

Two programs, the chunk decomposition of Mamba-2 that the paper
benchmarks:

* ``chunk_state``: per-chunk local state  S_c = sum_l exp(dA_L - dA_l) B_l^T x_l
* ``chunk_scan``:  y_l = exp(dA_l) C_l . S_prev  +  sum_{m<=l} (C_l.B_m) exp(dA_l - dA_m) x_m

Each grid cell owns one (batch, chunk) pair; ``batch`` is the flattened
(batch, head) axis: the programs have no head broadcast, so a caller whose
C and B are shared across heads materialises them per head.  The
inter-chunk recurrence runs outside (``ref.state_recurrence``).

The hand-written kernels of rows 11 and 12 are ``kernels/chunk_state.py``
and ``kernels/chunk_scan.py`` (``csrc/linear_attention.cu``); no model path
runs these programs.

No ``from __future__ import annotations`` here: the tracer reads the
``T.Tensor`` annotation objects of a ``@T.prim_func``.
"""
from ..core import TileProgram
from ..core import lang as T


def chunk_state_program(
    batch: int,
    nchunks: int,
    chunk_l: int,
    dstate: int,
    headdim: int,
    dtype: str = "float32",
    accum_dtype: str = "float32",
) -> TileProgram:
    @T.prim_func
    def ChunkState(
        B: T.Tensor((batch, nchunks, chunk_l, dstate), dtype),
        X: T.Tensor((batch, nchunks, chunk_l, headdim), dtype),
        dA: T.Tensor((batch, nchunks, chunk_l), accum_dtype),
        States: T.Tensor((batch, nchunks, dstate, headdim), accum_dtype),
    ):
        with T.Kernel(nchunks, batch, threads=128) as (bc, bz):
            B_shared = T.alloc_shared((chunk_l, dstate), dtype)
            X_shared = T.alloc_shared((chunk_l, headdim), dtype)
            dA_shared = T.alloc_shared((chunk_l,), accum_dtype)
            B_scaled = T.alloc_fragment((chunk_l, dstate), accum_dtype)
            S_local = T.alloc_fragment((dstate, headdim), accum_dtype)

            T.copy(B[bz, bc, 0, 0], B_shared)
            T.copy(X[bz, bc, 0, 0], X_shared)
            T.copy(dA[bz, bc, 0], dA_shared)
            for l, n in T.Parallel(chunk_l, dstate):
                B_scaled[l, n] = B_shared[l, n] * T.exp(
                    dA_shared[chunk_l - 1] - dA_shared[l]
                )
            T.clear(S_local)
            T.gemm(B_scaled, X_shared, S_local, transpose_A=True)
            T.copy(S_local, States[bz, bc, 0, 0])

    return ChunkState


def chunk_scan_program(
    batch: int,
    nchunks: int,
    chunk_l: int,
    dstate: int,
    headdim: int,
    dtype: str = "float32",
    accum_dtype: str = "float32",
) -> TileProgram:
    @T.prim_func
    def ChunkScan(
        C: T.Tensor((batch, nchunks, chunk_l, dstate), dtype),
        B: T.Tensor((batch, nchunks, chunk_l, dstate), dtype),
        X: T.Tensor((batch, nchunks, chunk_l, headdim), dtype),
        dA: T.Tensor((batch, nchunks, chunk_l), accum_dtype),
        PrevStates: T.Tensor((batch, nchunks, dstate, headdim), accum_dtype),
        Y: T.Tensor((batch, nchunks, chunk_l, headdim), dtype),
    ):
        with T.Kernel(nchunks, batch, threads=128) as (bc, bz):
            C_shared = T.alloc_shared((chunk_l, dstate), dtype)
            B_shared = T.alloc_shared((chunk_l, dstate), dtype)
            X_shared = T.alloc_shared((chunk_l, headdim), dtype)
            dA_shared = T.alloc_shared((chunk_l,), accum_dtype)
            S_shared = T.alloc_shared((dstate, headdim), accum_dtype)
            att = T.alloc_fragment((chunk_l, chunk_l), accum_dtype)
            y_acc = T.alloc_fragment((chunk_l, headdim), accum_dtype)
            c_f32 = T.alloc_fragment((chunk_l, dstate), accum_dtype)

            T.copy(C[bz, bc, 0, 0], C_shared)
            T.copy(B[bz, bc, 0, 0], B_shared)
            T.copy(X[bz, bc, 0, 0], X_shared)
            T.copy(dA[bz, bc, 0], dA_shared)
            T.copy(PrevStates[bz, bc, 0, 0], S_shared)

            # intra-chunk decay attention: att = tril((C B^T) * exp(dA_l - dA_m))
            T.clear(att)
            T.gemm(C_shared, B_shared, att, transpose_B=True)
            for i, j in T.Parallel(chunk_l, chunk_l):
                att[i, j] = T.if_then_else(
                    i >= j,
                    att[i, j] * T.exp(dA_shared[i] - dA_shared[j]),
                    0.0,
                )
            # y = att @ X  +  exp(dA_l) * (C @ S_prev)
            T.clear(y_acc)
            T.gemm(att, X_shared, y_acc)
            T.copy(C_shared, c_f32)
            for i, j in T.Parallel(chunk_l, dstate):
                c_f32[i, j] = c_f32[i, j] * T.exp(dA_shared[i])
            T.gemm(c_f32, S_shared, y_acc)
            T.copy(y_acc, Y[bz, bc, 0, 0])

    return ChunkScan


# Tiny-shape configs of the backend-parity suite (the JAX module's).
PARITY_CASES = [
    ("chunk_state", (chunk_state_program,
                     dict(batch=1, nchunks=2, chunk_l=16, dstate=16, headdim=16))),
    ("chunk_scan", (chunk_scan_program,
                    dict(batch=1, nchunks=2, chunk_l=16, dstate=16, headdim=16))),
]


def parity_programs():
    for name, (factory, cfg) in PARITY_CASES:
        yield name, factory(**cfg)
