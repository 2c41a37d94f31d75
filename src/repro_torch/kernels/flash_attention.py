"""Contiguous flash attention: the wrapper around ``csrc/flash_attention.cu``
and its autograd function.

Counterpart of ``repro.kernels.flash_attention.flash_attention_program``
(repro/kernels/flash_attention.py:25): GQA attention of Q (B, Hq, Sq, D)
over K/V (B, Hkv, Sk, D), causal (queries aligned to the suffix of the keys)
or not, fp32 scores and accumulation, the output in the input dtype.  The
plain version is ``ref.attention``; :func:`flash_attention` takes it for CPU
tensors only.  For a CUDA tensor it launches the kernel or raises.

The kernel has two paths, picked from dtype and shape alone
(:func:`tensor_core_path`): bf16 at head dim 64 or 128 runs on the tensor
cores (``KERNEL.tc_launches`` counts those launches), fp32 and any other
head dim on CUDA cores.

The kernel takes any Sq and Sk (no block-divisibility contract) and reads
Q, K, V and writes the output through their strides, so the transposed
views that ``layers.attention_full`` hands it cost no copy; a tensor whose
rows are not 16-byte aligned, or whose last dimension is strided, is made
contiguous first.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import ref
from .build import Kernel, check
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = Kernel(
    "flash_attention", "flash_attention_launch",
    [_I, _I, _P, _P, _P, _P, *([_L] * 12), _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _P],
    replaces="src/repro/kernels/flash_attention.py:25",
)
_MAX_GRID_YZ = 65535
TC_HEAD_DIMS = (64, 128)


def tensor_core_path(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a launch takes the tensor-core kernel: bf16 at a head dim it
    is built for.  Sequence lengths, heads and strides do not matter."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"flash_attention kernel: {msg}")


def _rows_aligned(t: torch.Tensor) -> bool:
    """Unit stride along D, and every row start 16-byte aligned."""
    vec = 16 // t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(s % vec == 0 for s, n in zip(t.stride()[:-1], t.shape[:-1])
                    if n > 1))


def kernel_layout(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself when its rows suit the kernels' 16-byte copies (unit
    stride along D, every row start 16-byte aligned), else a copy that does."""
    if _rows_aligned(t):
        return t
    t = t.contiguous()
    return t if _rows_aligned(t) else t.clone()


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """``q`` (B, Hq, Sq, D), ``k``/``v`` (B, Hkv, Sk, D), Hq a multiple of
    Hkv -> (B, Hq, Sq, D) in q's dtype.  ``causal`` lets query ``i`` see
    keys ``j <= i + Sk - Sq``.  A query row with no key to see emits zeros
    (the plain version's softmax gives NaN there)."""
    if not q.is_cuda:
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale)
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k and v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        _require(t.dtype == q.dtype, "q, k and v share one dtype")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _require(tuple(k.shape) == (b, hkv, sk, d) and v.shape == k.shape,
             f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _require(hkv > 0 and hq % hkv == 0, f"{hq} q heads over {hkv} kv heads")
    _require(sq > 0 and sk > 0, f"empty sequence (Sq {sq}, Sk {sk})")
    vec = 16 // q.element_size()
    _require(d % vec == 0, f"head_dim {d} must be a multiple of {vec}")
    _require(hq <= _MAX_GRID_YZ and b <= _MAX_GRID_YZ,
             f"{hq} heads x batch {b} exceed the grid")
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    out = torch.empty_like(q)  # q's strides: a (B, S, H, D) layout stays so
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    tc = tensor_core_path(q.dtype, d)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), *strides, b, hq, hkv, sq, sk, d,
            int(causal), scale, stream)
    check(rc, "flash_attention")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention with a gradient: the forward is the kernel, the
    backward recomputes the attention through the plain version
    (``ref.attention``) under autograd and returns its dQ, dK and dV.

    The reference has no backward kernel and no ``custom_vjp``: its
    training step takes ``jax.value_and_grad`` of the loss, and the gradient
    of its attention is XLA's autodiff of the oracle ``ref.attention``
    (ref.py:235).  Recomputing that oracle here gives the same gradient;
    a hand-written backward kernel (flash backward with the saved
    log-sum-exp) is later work (ROADMAP).  The recompute launches no
    kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, sm_scale: Optional[float]):
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.sm_scale = causal, sm_scale
        return flash_attention(q, k, v, causal=causal, sm_scale=sm_scale)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        # a named range, so that a profile can sum the recompute's device time
        with torch.profiler.record_function("flash_attention.backward"):
            with torch.enable_grad():
                inputs = [t.detach().requires_grad_(True) for t in (q, k, v)]
                out = ref.attention(*inputs, causal=ctx.causal,
                                    sm_scale=ctx.sm_scale)
            dq, dk, dv = torch.autograd.grad(out, inputs, dout)
        return dq, dk, dv, None, None
