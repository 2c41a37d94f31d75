"""Paged-attention decode: the wrapper around ``csrc/paged_attention.cu``.

Counterpart of ``repro.kernels.paged_attention.paged_attention_program``
(repro/kernels/paged_attention.py:32): single-token GQA decode over a paged
KV pool with a ragged live-length mask, an optional sliding window and
safe_div (empty slots emit zeros).  The plain version is
``ref.paged_attention``; this wrapper takes it for CPU tensors only.  For a
CUDA tensor it launches the kernel or raises.

The kernel splits each slot's keys across blocks (split-KV) and merges the
partial softmax states in a second pass.  The split count comes from static
shapes and the card's SM count alone (:func:`decode_splits`), never from
``seq_lens``: the wrapper reads no length on the host, so a decode step
makes no host sync and keeps one grid whatever the lengths.  bf16 at head
dim 64 or 128 scores on the tensor cores (:func:`tensor_core_path`,
``KERNEL.tc_launches``); the rest on CUDA cores, over the same split grid.
:func:`split_decode` rehearses the kernel's arithmetic in plain PyTorch.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from . import ref
from .build import Kernel, check

_P = ctypes.c_void_p
_I = ctypes.c_int
KERNEL = Kernel(
    "paged_attention", "paged_attention_launch",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     _I, _I, ctypes.c_float, _P],
    replaces="src/repro/kernels/paged_attention.py:32",
)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_KEYS = 64  # keys a tile; a split holds whole tiles
TC_HEAD_DIMS = (64, 128)
TC_MAX_GROUP = 64  # query heads a kv head on the tensor cores: 4 warps of 16 rows
NEG_CLAMP = -2.0 ** 20  # the kernels' floor of the running max (attention_core.cuh)
LOG2E = math.log2(math.e)


def decode_splits(slots: int, kv_heads: int, max_pages: int, page_size: int,
                  sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the decode grid (kv_heads, slots, splits),
    from static shapes and the card's SM count only.  Each (slot, kv head)
    splits its table's keys into whole 64-key tiles, as many splits as one
    wave of ``sms`` blocks asks for, but no more than one a tile: at
    qwen2-1.5B's serving shape (slots 8, Hkv 2, 64 pages of 16) 16 splits of
    64 keys, 256 blocks on 132 SMs."""
    tiles = max(1, -(-max_pages * page_size // SPLIT_KEYS))
    want = -(-sms // max(1, slots * kv_heads))  # splits that fill one wave
    per = max(1, tiles // want)  # tiles a split
    return -(-tiles // per), per * SPLIT_KEYS


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def tensor_core_path(dtype: torch.dtype, head_dim: int, group: int) -> bool:
    """Whether a launch scores on the tensor cores: bf16 at a head dim the
    kernel is built for, with the GQA group in the block's 64 rows.  Slots,
    pages and lengths do not matter."""
    return (dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS
            and group <= TC_MAX_GROUP)


def split_scratch(q: torch.Tensor, kv_heads: int, max_pages: int, page_size: int):
    """(splits, split_keys, o_part, ml_part) of a decode launch for ``q``
    (slots, Hq, D) on its card: :func:`decode_splits`' grid and the fp32
    scratch its split blocks leave their partial states in, O unnormalised
    (slots, Hq, splits, D), then m and l (2, slots, Hq, splits)."""
    b, hq, d = q.shape
    splits, split_keys = decode_splits(b, kv_heads, max_pages, page_size,
                                       sm_count(q.device.index or 0))
    o_part = torch.empty((b, hq, splits, d), dtype=torch.float32, device=q.device)
    ml_part = torch.empty((2, b, hq, splits), dtype=torch.float32, device=q.device)
    return splits, split_keys, o_part, ml_part


def _require(cond: bool, msg: str):
    if not cond:
        raise ValueError(f"paged_attention kernel: {msg}")


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens, *,
                    sm_scale: Optional[float] = None,
                    window: Optional[int] = None) -> torch.Tensor:
    """``q`` (B, Hq, D), pools (Hkv, P, page_size, D), ``block_tables``
    (B, max_pages) int32, ``seq_lens`` (B,) int32 -> (B, Hq, D)."""
    if not q.is_cuda:
        return ref.paged_attention(q, k_pages, v_pages, block_tables,
                                   seq_lens, sm_scale=sm_scale, window=window)
    b, hq, d = q.shape
    hkv, num_pages, page_size, d2 = k_pages.shape
    max_pages = block_tables.shape[1]
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
    _require(window is None or window > 0, f"window {window} must be positive")
    _require(q.dtype in DTYPES, f"dtype {q.dtype} (float32 or bfloat16)")
    _require(k_pages.dtype == q.dtype and v_pages.dtype == q.dtype,
             "pools and q must share one dtype")
    _require(v_pages.shape == k_pages.shape and d2 == d and hq % hkv == 0,
             f"shapes q {tuple(q.shape)}, pools {tuple(k_pages.shape)}")
    _require(block_tables.dtype == torch.int32 and seq_lens.dtype == torch.int32,
             "block_tables and seq_lens must be int32")
    _require(tuple(seq_lens.shape) == (b,) and block_tables.shape[0] == b,
             "one table row and one length per slot")
    for name, t in (("q", q), ("k_pages", k_pages), ("v_pages", v_pages),
                    ("block_tables", block_tables), ("seq_lens", seq_lens)):
        _require(t.is_contiguous(), f"{name} must be contiguous")
    vec = 16 // q.element_size()
    _require(d % vec == 0 and 0 < page_size <= 32
             and page_size & (page_size - 1) == 0,
             f"head_dim {d} must be a multiple of {vec} and page_size "
             f"{page_size} a power of two <= 32")
    for name, t in (("k_pages", k_pages), ("v_pages", v_pages)):
        _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    splits, split_keys, o_part, ml_part = split_scratch(q, hkv, max_pages, page_size)
    _require(b <= 65535 and splits <= 65535, f"{b} slots x {splits} splits")
    tc = tensor_core_path(q.dtype, d, hq // hkv)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], int(tc), q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), b, hq, hkv, d,
            page_size, max_pages, num_pages, window if window is not None else 0,
            splits, split_keys, scale, stream,
        )
    check(rc, "paged_attention")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc)
    return out


def split_decode(q, k_pages, v_pages, block_tables, seq_lens, splits: int,
                 split_keys: int, *, sm_scale: Optional[float] = None,
                 window: Optional[int] = None, pair: bool = False,
                 rescale: bool = True) -> torch.Tensor:
    """The split kernel's arithmetic in plain PyTorch (a rehearsal, not a
    path): fp32 scores scaled into the log2 domain under the live-length
    mask and the window, then :func:`fold_splits` over 64-key tiles,
    rounded once.  ``pair`` multiplies P as the tensor-core kernel's bf16
    pair hi + lo; ``rescale=False`` is the faulty merge that sums the
    splits as they stand."""
    b, hq, d = q.shape
    hkv, _, page_size, _ = k_pages.shape
    group = hq // hkv
    qscale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)) * LOG2E
    tables = block_tables.long()
    k = k_pages[:, tables].transpose(0, 1).reshape(b, hkv, -1, d).float()
    v = v_pages[:, tables].transpose(0, 1).reshape(b, hkv, -1, d).float()
    scores = torch.einsum("bhgd,bhsd->bhgs", q.reshape(b, hkv, group, d).float(), k) * qscale
    scores = mask_live(scores, seq_lens, window)
    out = fold_splits(scores, v, splits, split_keys, SPLIT_KEYS, pair=pair, rescale=rescale)
    return out.reshape(b, hq, d).to(q.dtype)


def mask_live(scores, seq_lens, window: Optional[int]):
    """``scores`` (B, ..., S) with the keys outside [max(0, len - window),
    len) of each slot set to -inf."""
    pos = torch.arange(scores.shape[-1], device=scores.device)
    lens = seq_lens.long()[:, None]
    live = pos[None, :] < lens
    if window is not None:
        live = live & (pos[None, :] >= lens - window)
    live = live.view(live.shape[0], *(1,) * (scores.dim() - 2), -1)  # over the middle axes
    return scores.masked_fill(~live, float("-inf"))


def fold_splits(scores, v, splits: int, split_keys: int, tile: int, *,
                pair: bool = False, rescale: bool = True) -> torch.Tensor:
    """A split-KV decode's arithmetic over log2-domain ``scores`` (..., rows,
    S), -inf where masked, and values ``v`` (..., S, Dv): each split folds
    its ``tile``-key tiles of keys [s * split_keys, (s + 1) * split_keys)
    into an online softmax (exp2, the running max clamped at NEG_CLAMP) and
    leaves O, m and l; the merge rescales the splits to their common max,
    sums them and divides by max(l, 1e-30).  Returns fp32 (..., rows, Dv).
    ``pair`` multiplies P as the tensor-core kernels' bf16 pair hi + lo;
    ``rescale=False`` is the faulty merge that sums the splits as they
    stand."""
    n_keys = scores.shape[-1]
    lead = scores.shape[:-1]
    states = []
    for s in range(splits):
        m = torch.full(lead + (1,), float("-inf"), device=scores.device)
        l = torch.zeros_like(m)
        o = torch.zeros(lead + v.shape[-1:], device=scores.device)
        for t in range(s * split_keys, min((s + 1) * split_keys, n_keys), tile):
            sc = scores[..., t:t + tile]
            m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
            mc = m_new.clamp_min(NEG_CLAMP)
            alpha, p = torch.exp2(m.clamp_min(NEG_CLAMP) - mc), torch.exp2(sc - mc)
            vt = v[..., t:t + tile, :]
            if pair:
                hi = p.bfloat16().float()
                pv = hi @ vt + (p - hi).bfloat16().float() @ vt
            else:
                pv = p @ vt
            l = l * alpha + p.sum(-1, keepdim=True)
            o = o * alpha + pv
            m = m_new
        states.append((o, m.clamp_min(NEG_CLAMP), l))
    mx = torch.stack([m for _, m, _ in states]).amax(0)
    out = torch.zeros_like(states[0][0])
    den = torch.zeros_like(states[0][2])
    for o, m, l in states:
        w = torch.exp2(m - mx) if rescale else torch.ones_like(m)
        out = out + w * o
        den = den + w * l
    return out / den.clamp_min(1e-30)
