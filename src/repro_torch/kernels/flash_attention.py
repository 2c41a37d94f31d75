"""Contiguous flash attention: the wrapper around ``csrc/flash_attention.cu``
and its autograd function.

Counterpart of ``repro.kernels.flash_attention.flash_attention_program``
(repro/kernels/flash_attention.py:25): GQA attention of Q (B, Hq, Sq, Dk)
over K (B, Hkv, Sk, Dk) and V (B, Hkv, Sk, Dv), causal (queries aligned to
the suffix of the keys) or not, fp32 scores and accumulation, the output
(B, Hq, Sq, Dv) in the input dtype.  Dv differs from Dk for MLA's expanded
heads (``layers.mla_full``: keys of nope + rope columns, narrower values),
which the TPU program, with one head_dim, does not take.  The plain version
is ``ref.attention``; :func:`flash_attention` takes it for CPU tensors only.
For a CUDA tensor it launches the kernel or raises.

The kernel has three paths, picked from dtype and widths alone
(:func:`tensor_core_path`): bf16 at a (Dk, Dv) pair of ``TC_PAIRS`` runs on
the tensor cores, by mma.sync at ``MMA_PAIRS`` and by wgmma fed by TMA at
``WGMMA_PAIRS`` (gemma-7b's 256; ``KERNEL.tc_launches`` counts both), fp32
and any other pair on CUDA cores; a pair none takes raises
(:func:`check_widths`).

The kernel takes any Sq and Sk (no block-divisibility contract) and reads
Q, K, V and writes the output through their strides, so the transposed
views that ``layers.attention_full`` hands it cost no copy; a tensor whose
rows are not 16-byte aligned, or whose last dimension is strided, is made
contiguous first.

The same module holds ``flash_attention_program`` itself, the tile program
that the port's compiler (``repro_torch.core``) compiles with
``target="cuda"`` or runs with ``target="reference"``, and its
``PARITY_CASES``.
"""

import ctypes
import math
from typing import Optional

import torch

from ..core import TileProgram
from ..core import lang as T
from . import attention_core as AC
from . import ref
from .build import Kernel, check
from .paged_attention import DTYPES

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_MAX_GRID_YZ = 65535
# (Dk, Dv) pairs of the tensor-core kernels: on mma.sync GQA's head dims and
# MLA's expanded heads at deepseek-v2-lite's widths (128 nope + 64 rope over
# 128); on wgmma gemma-7b's 256 (``flash_attention_kernel_wg``)
MMA_PAIRS = ((64, 64), (128, 128), (192, 128))
WGMMA_PAIRS = ((256, 256),)
TC_PAIRS = MMA_PAIRS + WGMMA_PAIRS
TC_HEAD_DIMS = tuple(dk for dk, dv in TC_PAIRS if dk == dv)
MAX_SMEM = 232448  # a block's shared memory on the H100 (227 KB)
_CORE_THREADS, _CORE_VECTORS = 256, 4  # the CUDA-core block, ac::MAXV
# The warpgroup walk at head width 256 (csrc/hopper_attention.cuh): 64 query
# rows a consumer warpgroup, keys a tile in stages of [K | V], 256 wide; the
# flash kernel instantiates it at WG_KEYS x WG_STAGES (64 x 2 beat 32 x 4 by
# 6%, tools/d256_wgmma_ablation.py), which reach its source as macros (the
# prefill at its own).
WG_D, WG_ROWS = 256, 64
WG_KEYS, WG_STAGES = 64, 2
KERNEL = Kernel(
    "flash_attention", "flash_attention_launch",
    [_I, _I, _P, _P, _P, _P, *([_L] * 12), _I, _I, _I, _I, _I, _I, _I, _I,
     ctypes.c_float, _P],
    replaces="src/repro/kernels/flash_attention.py:25",
    defines={"WG_KEYS": WG_KEYS, "WG_STAGES": WG_STAGES},
)


def wgmma_smem_bytes(q_tiles: int, keys: int, stages: int, extra: int = 0) -> int:
    """Shared memory of a warpgroup attention block (``ha::Layout::bytes``):
    ``q_tiles`` query tiles of 64 x 256 bf16, ``stages`` stages of [K | V]
    tiles of ``keys`` keys, a 128-byte place for the mbarriers, ``extra``
    bytes the kernel keeps beside them (the prefill's table entries), and
    1024 bytes to align the base to a swizzle atom."""
    ring = stages * 2 * keys * WG_D * 2
    return q_tiles * WG_ROWS * WG_D * 2 + ring + 128 + extra + 1024


def tensor_core_path(dtype: torch.dtype, dk: int, dv: Optional[int] = None) -> bool:
    """Whether a launch takes a tensor-core kernel: bf16 at a (Dk, Dv) pair
    one is built for (``dv`` defaults to ``dk``): mma.sync at
    ``MMA_PAIRS``, wgmma at ``WGMMA_PAIRS``.  Sequence lengths, heads and
    strides do not matter."""
    return dtype == torch.bfloat16 and (dk, dk if dv is None else dv) in TC_PAIRS


def core_smem_bytes(rows: int, cols: int, dk: int, dv: Optional[int] = None) -> int:
    """Shared memory of a CUDA-core attention block of ``rows`` query rows
    and ``cols`` keys a tile (``ac::Smem::bytes`` in
    csrc/attention_core.cuh: Q and a K tile padded to Dk + 4 floats, a V
    tile and the accumulator Dv wide (``dv`` defaults to ``dk``), the
    scores, three carries)."""
    dv = dk if dv is None else dv
    return 4 * (rows * (dk + 4) + cols * (dk + 4) + cols * dv + rows * cols
                + rows * dv + 3 * rows)


def check_widths(dtype: torch.dtype, dk: int, dv: int):
    """Raise a ``ValueError`` unless one of the kernel's paths takes
    (``dk``, ``dv``) in ``dtype``: the tensor-core pairs, or on the CUDA
    cores widths of whole 16-byte vectors whose key tile (halved from 32
    keys) fits a thread's vectors and whose block (halved from 64 query
    rows, to 8 at least) fits the shared memory, as ``launch`` in
    csrc/flash_attention.cu picks them."""
    vec = 16 * 8 // torch.finfo(dtype).bits
    _require(dk > 0 and dv > 0 and dk % vec == 0 and dv % vec == 0,
             f"head dims (Dk {dk}, Dv {dv}) must be multiples of {vec}")
    if tensor_core_path(dtype, dk, dv):
        return
    fits = lambda c: c * max(dk, dv) // vec <= _CORE_VECTORS * _CORE_THREADS  # noqa: E731
    cols = 32
    while cols > 1 and not fits(cols):
        cols //= 2
    _require(fits(cols), f"a key row of Dk {dk} / Dv {dv} exceeds a block's loads")
    rows = 64
    while rows > 8 and core_smem_bytes(rows, cols, dk, dv) > MAX_SMEM:
        rows //= 2
    need = core_smem_bytes(rows, cols, dk, dv)
    _require(need <= MAX_SMEM, f"Dk {dk} / Dv {dv} need {need} bytes of shared "
             f"memory a block, over the card's {MAX_SMEM}")


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


def _empty_out(q: torch.Tensor, dv: int) -> torch.Tensor:
    """An output (B, Hq, Sq, dv) for ``q`` whose dimensions lie in memory in
    q's order (a (B, S, H, D) layout stays so), Dv contiguous."""
    order = sorted(range(3), key=lambda i: -q.stride(i))  # outermost first
    out = torch.empty([q.shape[i] for i in order] + [dv], dtype=q.dtype,
                      device=q.device)
    return out.permute(*[order.index(i) for i in range(3)], 3)


def flash_attention(q, k, v, *, causal: bool = False,
                    sm_scale: Optional[float] = None) -> torch.Tensor:
    """``q`` (B, Hq, Sq, Dk), ``k`` (B, Hkv, Sk, Dk), ``v`` (B, Hkv, Sk,
    Dv), Hq a multiple of Hkv -> (B, Hq, Sq, Dv) in q's dtype, laid out in
    q's order.  ``causal`` lets query ``i`` see keys ``j <= i + Sk - Sq``;
    the scale defaults to ``1 / sqrt(Dk)``.  A query row with no key to see
    emits zeros (the plain version's softmax gives NaN there)."""
    if not q.is_cuda:
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale)
    _require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
             "q, k and v must be (B, H, S, D)")
    b, hq, sq, d = q.shape
    hkv, sk, dv = k.shape[1], k.shape[2], v.shape[3]
    for name, t in (("k", k), ("v", v)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
        _require(t.dtype == q.dtype, "q, k and v share one dtype")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _require(tuple(k.shape) == (b, hkv, sk, d) and tuple(v.shape) == (b, hkv, sk, dv),
             f"shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}")
    _require(hkv > 0 and hq % hkv == 0, f"{hq} q heads over {hkv} kv heads")
    _require(sq > 0 and sk > 0, f"empty sequence (Sq {sq}, Sk {sk})")
    check_widths(q.dtype, d, dv)
    _require(hq <= _MAX_GRID_YZ and b <= _MAX_GRID_YZ,
             f"{hq} heads x batch {b} exceed the grid")
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    out = _empty_out(q, dv)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    tc = tensor_core_path(q.dtype, d, dv)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(), *strides, b, hq, hkv, sq, sk, d,
            int(causal), dv, scale, stream)
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


# ---------------------------------------------------------------------------
# The tile program (repro/kernels/flash_attention.py:25, paper Table 3 /
# Fig. 12): online-softmax attention with the KV sequence streamed through
# the pipelined loop, composed from the shared attention core
# (attention_core.py): a contiguous KV source, per-head Q blocks (GQA through
# the head index), and a causal mask.  The m/l running statistics live in
# fragment buffers.
# ---------------------------------------------------------------------------


def flash_attention_program(
    batch: int,
    heads: int,
    kv_heads: int,
    seq_q: int,
    seq_kv: int,
    head_dim: int,
    causal: bool = False,
    block_M: int = 128,
    block_N: int = 128,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
) -> TileProgram:
    if seq_q % block_M or seq_kv % block_N:
        raise ValueError("sequence lengths must be divisible by block sizes")
    if heads % kv_heads:
        raise ValueError("GQA requires heads % kv_heads == 0")
    group = heads // kv_heads
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)) * 1.44269504  # log2(e)

    @T.prim_func
    def FlashAttn(
        Q: T.Tensor((batch, heads, seq_q, head_dim), dtype),
        K: T.Tensor((batch, kv_heads, seq_kv, head_dim), dtype),
        V: T.Tensor((batch, kv_heads, seq_kv, head_dim), dtype),
        Output: T.Tensor((batch, heads, seq_q, head_dim), dtype),
    ):
        with T.Kernel(T.ceildiv(seq_q, block_M), heads, batch, threads=256) as (bx, by, bz):
            Q_shared = T.alloc_shared((block_M, head_dim), dtype)
            K_shared = T.alloc_shared((block_N, head_dim), dtype)
            V_shared = T.alloc_shared((block_N, head_dim), dtype)
            acc_s = T.alloc_fragment((block_M, block_N), accum_dtype)
            ons = AC.OnlineSoftmax(block_M, head_dim, scale, accum_dtype)

            kv_head = by // group
            T.copy(Q[bz, by, bx * block_M, 0], Q_shared)

            def load_kv(k):
                T.copy(K[bz, kv_head, k * block_N, 0], K_shared)
                T.copy(V[bz, kv_head, k * block_N, 0], V_shared)
                return K_shared, V_shared

            def mask(k):
                if not causal:
                    return None
                return AC.causal(
                    lambda i: (bx * block_M + i) + (seq_kv - seq_q),
                    lambda j: k * block_N + j,
                )

            AC.attend(
                ons, acc_s, block_N, T.ceildiv(seq_kv, block_N), load_kv,
                lambda s, ks, k: AC.scores(s, Q_shared, ks), mask,
                num_stages=num_stages,
            )
            ons.finalize(Output[bz, by, bx * block_M, 0])

    return FlashAttn


# Tiny-shape configs of the backend-parity suite; covers GQA (heads !=
# kv_heads) and the causal masked-elementwise path.
PARITY_CASES = [
    (
        "flash_attention_gqa",
        dict(batch=1, heads=2, kv_heads=1, seq_q=16, seq_kv=32, head_dim=16,
             block_M=16, block_N=16),
    ),
    (
        "flash_attention_causal",
        dict(batch=1, heads=1, kv_heads=1, seq_q=32, seq_kv=32, head_dim=16,
             causal=True, block_M=16, block_N=16),
    ),
]


def parity_programs():
    for name, cfg in PARITY_CASES:
        yield name, flash_attention_program(**cfg)
