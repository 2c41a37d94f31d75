"""Mamba-2 SSD chunk state: the wrapper around ``csrc/linear_attention.cu``
(``chunk_state_launch``) and its autograd function.

Counterpart of ``repro.kernels.linear_attention.chunk_state_program``
(repro/kernels/linear_attention.py:21): per (batch, head, chunk), the local
state S = sum_l exp(dA_last - dA_l) B_l^T x_l, fp32.  The plain version is
``ref.chunk_state``; :func:`chunk_state` takes it for CPU tensors only.  For
a CUDA tensor it launches the kernel or raises.

Inputs carry one or two leading dimensions: (bsz, C, L, .) as the
reference's (heads folded into the batch), or (B, H, C, L, .) as the port's
Mamba-2 layer hands them, where B may be an ``expand``ed view with head
stride 0 (the kernel reads it through its strides, no copy).  A tensor
whose last dimension is strided is made contiguous first.

The kernel has two paths, picked from dtype, shapes and strides alone
(:func:`tensor_core_path`, the rule chunk_scan shares).  bf16 with L, N and
P multiples of 16 (L and N at most 128) and 16-byte aligned rows runs on the
tensor cores (``KERNEL.tc_launches`` counts those launches): S = B^T Xd,
the decay put on X, Xd = exp(dA_last - dA_l) X_l formed in fp32 and
multiplied as the bf16 pair hi + lo, summed in fp32.  Where B is broadcast
over the heads (head stride 0) one block stages it once for a group of
heads (:func:`head_group`).  The rest (fp32, hymba's P 50) runs on CUDA
cores in fp32.
"""
from __future__ import annotations

import ctypes

import torch

from . import ref
from .build import Kernel, check
from .paged_attention import DTYPES, sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
KERNEL = Kernel(
    "chunk_state", "chunk_state_launch",
    [_I, _I, _I, _P, _P, _P, _P, *([_L] * 15), _I, _I, _I, _I, _I, _I, _P],
    replaces="src/repro/kernels/linear_attention.py:21",
    source="linear_attention",
)
MAX_CHUNK = 128  # rows of a chunk the kernels take
MAX_BLOCKS = (1 << 31) - 1
TC_MAX_N = 128  # state width the tensor-core blocks hold in shared memory
TC_P_TILE = 64  # columns of P a tensor-core block
STATE_BLOCKS_PER_SM = 2  # tensor-core chunk_state blocks an SM holds (107 KB each)


def tensor_core_path(dtype: torch.dtype, length: int, n: int, p: int,
                     aligned: bool = True) -> bool:
    """Whether a launch takes the tensor-core kernels (chunk_state's and
    chunk_scan's): bf16, chunks of L rows and state and head widths N and P
    that their 16-row tiles take (L and N within their shared memory), with
    rows their 16-byte copies can read (``aligned``: :func:`rows_aligned`
    of the operands)."""
    return (dtype == torch.bfloat16 and length % 16 == 0 and 0 < length <= MAX_CHUNK
            and n % 16 == 0 and 0 < n <= TC_MAX_N and p % 16 == 0 and p > 0 and aligned)


def rows_aligned(*views: torch.Tensor) -> bool:
    """Every view starts on 16 bytes and steps 16-byte multiples along its
    batch, head, chunk and row dimensions (the 5-d views handed over)."""
    for t in views:
        vec = 16 // t.element_size()
        if t.data_ptr() % 16 or any(st % vec for st in t.stride()[:4]):
            return False
    return True


def head_group(batch: int, heads: int, nchunks: int, p: int, sms: int,
               broadcast: bool, per_sm: int = 1) -> int:
    """Heads a tensor-core block takes, sharing what is broadcast over the
    heads (the scan's C B^T, the state's staged B): where it is broadcast,
    as many as leave enough groups for the grid (batch x chunks x groups x P
    tiles) to fill the card's ``sms`` once with ``per_sm`` blocks each;
    otherwise 1.  At mamba2-2.7B's training shapes on 132 SMs: 40 heads, 2
    groups, 128 blocks for the scan (one an SM); 20 heads, 4 groups, 256
    blocks for the state (two an SM)."""
    if not broadcast:
        return 1
    tiles = batch * nchunks * -(-p // TC_P_TILE)
    groups = max(1, min(heads, per_sm * sms // tiles))
    return -(-heads // groups)


def require(cond: bool, name: str, msg: str):
    if not cond:
        raise ValueError(f"{name} kernel: {msg}")


def five_d(t: torch.Tensor, lead: int) -> torch.Tensor:
    """``t`` with (batch, head) in front: a single folded batch dimension
    (``lead`` 1) gains a head dimension of 1.  The last dimension is made
    contiguous where it is strided."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t.unsqueeze(1) if lead == 1 else t


def strides(t: torch.Tensor, n: int):
    return list(t.stride()[:n])


def check_common(name: str, lead, tensors, *, dtype):
    """Device, dtype and leading-shape checks shared by the two wrappers;
    ``tensors`` maps names to (tensor, trailing rank)."""
    ref_t = next(iter(tensors.values()))[0]
    require(len(lead) in (1, 2), name,
            f"leading dimensions {tuple(lead)}: (bsz,) or (batch, heads)")
    for tname, (t, trailing) in tensors.items():
        require(t.device == ref_t.device, name,
                f"{tname} is on {t.device}, not {ref_t.device}")
        require(t.dim() == len(lead) + trailing and tuple(t.shape[:len(lead)]) == tuple(lead),
                name, f"{tname} has shape {tuple(t.shape)}, leading dims {tuple(lead)}")
    require(dtype in DTYPES, name, f"dtype {dtype} (float32 or bfloat16)")


def chunk_state(b_mat: torch.Tensor, x: torch.Tensor,
                da_cum: torch.Tensor) -> torch.Tensor:
    """``b_mat`` (..., C, L, N), ``x`` (..., C, L, P) of one dtype, ``da_cum``
    (..., C, L) fp32 -> states (..., C, N, P) fp32; ``...`` is (bsz,) or
    (B, H)."""
    if not x.is_cuda:
        return ref.chunk_state(b_mat, x, da_cum)
    lead = tuple(b_mat.shape[:-3])
    check_common("chunk_state", lead, {"b_mat": (b_mat, 3), "x": (x, 3),
                                       "da_cum": (da_cum, 2)},
                 dtype=x.dtype)
    nc, length, n = b_mat.shape[-3:]
    p = x.shape[-1]
    require(tuple(x.shape[-3:-1]) == (nc, length)
            and tuple(da_cum.shape[-2:]) == (nc, length), "chunk_state",
            f"shapes b_mat {tuple(b_mat.shape)}, x {tuple(x.shape)}, "
            f"da_cum {tuple(da_cum.shape)}")
    require(b_mat.dtype == x.dtype, "chunk_state", "b_mat and x share one dtype")
    require(da_cum.dtype == torch.float32, "chunk_state", "da_cum is float32")
    require(0 < length <= MAX_CHUNK, "chunk_state",
            f"chunk of {length} rows (at most {MAX_CHUNK})")
    require(n > 0 and p > 0 and nc > 0, "chunk_state", "an empty dimension")
    bm5, x5, da5 = (five_d(t, len(lead)) for t in (b_mat, x, da_cum))
    batch, heads = bm5.shape[:2]
    require(batch * heads * nc <= MAX_BLOCKS, "chunk_state", "grid too large")
    out = torch.empty(lead + (nc, n, p), dtype=torch.float32, device=x.device)
    out5 = five_d(out, len(lead))
    tc = tensor_core_path(x.dtype, length, n, p, rows_aligned(bm5, x5))
    hg = (head_group(batch, heads, nc, p, sm_count(x.device.index or 0),
                     bm5.stride(1) == 0, per_sm=STATE_BLOCKS_PER_SM) if tc else 1)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[x.dtype], int(tc), hg, bm5.data_ptr(), x5.data_ptr(), da5.data_ptr(),
            out5.data_ptr(), *strides(bm5, 4), *strides(x5, 4),
            *strides(da5, 3), *strides(out5, 4), batch, heads, nc, length, n,
            p, stream)
    check(rc, "chunk_state")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out


def recompute_grads(ctx, plain, dout):
    """The gradient of an autograd function whose forward is a kernel: the
    saved inputs go through the plain version under autograd, and its
    gradients are returned for the inputs that need one."""
    inputs = [t.detach().requires_grad_(need)
              for t, need in zip(ctx.saved_tensors, ctx.needs_input_grad)]
    with torch.enable_grad():
        out = plain(*inputs)
    wanted = [t for t in inputs if t.requires_grad]
    grads = iter(torch.autograd.grad(out, wanted, dout) if wanted else ())
    return tuple(next(grads) if t.requires_grad else None for t in inputs)


class ChunkStateFn(torch.autograd.Function):
    """chunk_state with a gradient: the forward is the kernel, the backward
    recomputes ``ref.chunk_state`` under autograd and launches nothing.

    The reference has no backward kernel and no ``custom_vjp``: its
    gradient is XLA's autodiff of the plain path, which this recompute
    gives.  A backward kernel is later work (ROADMAP)."""

    @staticmethod
    def forward(ctx, b_mat, x, da_cum):
        ctx.save_for_backward(b_mat, x, da_cum)
        return chunk_state(b_mat, x, da_cum)

    @staticmethod
    def backward(ctx, dout):
        # a named range, so that a profile can sum the recompute's device time
        with torch.profiler.record_function("chunk_state.backward"):
            return recompute_grads(ctx, ref.chunk_state, dout)
