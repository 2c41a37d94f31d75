"""Mamba-2 SSD chunk scan: the wrapper around ``csrc/linear_attention.cu``
(``chunk_scan_launch``) and its autograd function.

Counterpart of ``repro.kernels.linear_attention.chunk_scan_program``
(repro/kernels/linear_attention.py:58): per (batch, head, chunk), y =
tril(C B^T * exp(dA_l - dA_m)) X + exp(dA_l) C S_prev, scores and sums in
fp32, rounded once to X's dtype.  The plain version is ``ref.chunk_scan``;
:func:`chunk_scan` takes it for CPU tensors only.  For a CUDA tensor it
launches the kernel or raises.

Leading dimensions, strides and the head-broadcast (``expand``ed) C and B
are taken as in :mod:`.chunk_state`.

The kernel has two paths, picked from dtype, shapes and strides alone
(:func:`tensor_core_path`).  bf16 with L, N and P multiples of 16 (L and N
at most 128) and 16-byte aligned rows runs on the tensor cores
(``KERNEL.tc_launches`` counts those launches): C B^T in fp32 from bf16
fragments, the decayed scores and the carried state each multiplied as
three bf16 terms hi + mid + lo (fp32's precision: a pair is not enough
where a row's signed products cancel).  Where C and B are broadcast over
the heads (head stride
0), one block computes C B^T once for a group of heads (:func:`head_group`).
The rest (fp32, hymba's P 50 / N 16) runs on CUDA cores in fp32.  The rule
and the grouping are :mod:`.chunk_state`'s, whose kernel has the same
tensor-core path.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import Kernel, check
from .chunk_state import (MAX_BLOCKS, MAX_CHUNK, check_common, five_d, head_group,
                          recompute_grads, require, rows_aligned, strides,
                          tensor_core_path)
from .paged_attention import DTYPES, sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = Kernel(
    "chunk_scan", "chunk_scan_launch",
    [_I, _I, _I, _P, _P, _P, _P, _P, _P, *([_L] * 23), _I, _I, _I, _I, _I, _I, _P],
    replaces="src/repro/kernels/linear_attention.py:58",
    source="linear_attention",
)
def chunk_scan(c_mat: torch.Tensor, b_mat: torch.Tensor, x: torch.Tensor,
               da_cum: torch.Tensor, prev_states: torch.Tensor) -> torch.Tensor:
    """``c_mat``, ``b_mat`` (..., C, L, N) and ``x`` (..., C, L, P) of one
    dtype, ``da_cum`` (..., C, L) and ``prev_states`` (..., C, N, P) fp32 ->
    y (..., C, L, P) in x's dtype; ``...`` is (bsz,) or (B, H)."""
    if not x.is_cuda:
        return ref.chunk_scan(c_mat, b_mat, x, da_cum, prev_states)
    name = "chunk_scan"
    lead = tuple(c_mat.shape[:-3])
    check_common(name, lead, {"c_mat": (c_mat, 3), "b_mat": (b_mat, 3),
                              "x": (x, 3), "da_cum": (da_cum, 2),
                              "prev_states": (prev_states, 3)},
                 dtype=x.dtype)
    nc, length, n = c_mat.shape[-3:]
    p = x.shape[-1]
    require(tuple(b_mat.shape) == tuple(c_mat.shape)
            and tuple(x.shape[-3:-1]) == (nc, length)
            and tuple(da_cum.shape[-2:]) == (nc, length)
            and tuple(prev_states.shape[-3:]) == (nc, n, p), name,
            f"shapes c_mat {tuple(c_mat.shape)}, b_mat {tuple(b_mat.shape)}, "
            f"x {tuple(x.shape)}, da_cum {tuple(da_cum.shape)}, prev_states "
            f"{tuple(prev_states.shape)}")
    require(c_mat.dtype == b_mat.dtype == x.dtype, name,
            "c_mat, b_mat and x share one dtype")
    require(da_cum.dtype == prev_states.dtype == torch.float32, name,
            "da_cum and prev_states are float32")
    require(0 < length <= MAX_CHUNK, name,
            f"chunk of {length} rows (at most {MAX_CHUNK})")
    require(n > 0 and p > 0 and nc > 0, name, "an empty dimension")
    c5, b5, x5, da5, s5 = (five_d(t, len(lead))
                           for t in (c_mat, b_mat, x, da_cum, prev_states))
    batch, heads = c5.shape[:2]
    require(batch * heads * nc <= MAX_BLOCKS, name, "grid too large")
    y = torch.empty(lead + (nc, length, p), dtype=x.dtype, device=x.device)
    y5 = five_d(y, len(lead))
    tc = tensor_core_path(x.dtype, length, n, p, rows_aligned(c5, b5, x5, s5))
    hg = (head_group(batch, heads, nc, p, sm_count(x.device.index or 0),
                     c5.stride(1) == 0 and b5.stride(1) == 0) if tc else 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[x.dtype], int(tc), hg, c5.data_ptr(), b5.data_ptr(), x5.data_ptr(),
            da5.data_ptr(), s5.data_ptr(), y5.data_ptr(), *strides(c5, 4),
            *strides(b5, 4), *strides(x5, 4), *strides(da5, 3),
            *strides(s5, 4), *strides(y5, 4), batch, heads, nc, length, n, p,
            stream)
    check(rc, name)
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return y


class ChunkScanFn(torch.autograd.Function):
    """chunk_scan with a gradient: the forward is the kernel, the backward
    recomputes ``ref.chunk_scan`` under autograd and launches nothing (the
    reference's gradient is XLA's autodiff of the same plain path)."""

    @staticmethod
    def forward(ctx, c_mat, b_mat, x, da_cum, prev_states):
        ctx.save_for_backward(c_mat, b_mat, x, da_cum, prev_states)
        return chunk_scan(c_mat, b_mat, x, da_cum, prev_states)

    @staticmethod
    def backward(ctx, dout):
        with torch.profiler.record_function("chunk_scan.backward"):
            return recompute_grads(ctx, ref.chunk_scan, dout)
