"""Paged-attention decode: the wrapper around ``csrc/paged_attention.cu``.

Counterpart of ``repro.kernels.paged_attention.paged_attention_program``
(repro/kernels/paged_attention.py:32): single-token GQA decode over a paged
KV pool with a ragged live-length mask, an optional sliding window and
safe_div (empty slots emit zeros).  The plain version is
``ref.paged_attention``; this wrapper takes it for CPU tensors only.  For a
CUDA tensor it launches the kernel or raises.

The kernel splits each slot's keys across blocks (split-KV) and merges the
partial softmax states in a second pass.  The split count comes from static
shapes and the card's SM count alone, never from ``seq_lens``: the wrapper
reads no length on the host, so a decode step makes no host sync and keeps
one grid whatever the lengths.  A launch takes one of three bodies
(:func:`route`, the C entry point's ``tc`` argument):

* 2, the bulk-copy walk (:func:`walk_path`, ``KERNEL.walk_launches``): bf16
  at head dim 256 with up to ``WALK_MAX_GROUP`` query heads a kv head
  (gemma-7b's MHA), over pages of at least ``WALK_MIN_PAGE`` positions.  A
  producer warp copies whole pages of K and V into a ring of shared memory
  by ``cp.async.bulk`` and every consumer warp scores its share of each
  page on the CUDA cores, on :func:`walk_splits`' finer grid;
* 1, mma.sync (:func:`tensor_core_path`, ``KERNEL.tc_launches``): bf16 at
  head dim 64 or 128, on :func:`decode_splits`' grid;
* 0, the CUDA-core body: fp32 and every other shape, on the same grid.

:func:`split_decode` rehearses the split kernels' arithmetic in plain
PyTorch, :func:`walk_decode` the walk's (its warps' key shares and their
merge).

The same module holds the TPU program itself and its quantized twin,
``paged_attention_program`` and ``paged_attention_quant_program``
(repro/kernels/paged_attention.py:32 and :93), the tile programs that the
port's compiler (``repro_torch.core``) compiles with ``target="cuda"`` or
runs with ``target="reference"``: the KV pages gathered through the block
table (a ``T.ScalarTensor``), every table entry of the pipelined axis read
whatever the slot's length, so padding entries must hold valid page ids.
Their ``PARITY_CASES`` and ``parity_inputs`` are the JAX module's
(:168-230).
"""
import ctypes
import functools
import math
from typing import Optional, Tuple

import torch

from ..core import TileProgram
from ..core import lang as T
from . import attention_core as AC
from . import ref
from .build import Kernel, check

_P = ctypes.c_void_p
_I = ctypes.c_int
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
SPLIT_KEYS = 64  # keys a tile; a split holds whole tiles
TC_HEAD_DIMS = (64, 128)
TC_MAX_GROUP = 64  # query heads a kv head on the tensor cores: 4 warps of 16 rows
# The bulk-copy walk (csrc/decode_walk.cuh): its tile constants, passed to
# the source as -D macros (KERNEL.defines), and the shapes it takes
WALK_STAGES = 4  # pages of K and V in flight a block
WALK_SPLIT_KEYS = 128  # keys a split at most (walk_splits halves it for small grids)
WALK_WARPS = 4  # consumer warps a block, beside the producer warp
WALK_ROUND = 8  # keys the consumer warps score together: WALK_ROUND / WALK_WARPS each
WALK_HEAD_DIMS = (256,)  # any group up to WALK_MAX_GROUP
# a group of 1 only (deepseek-7b's MHA): tools/decode_walk_ablation.py read
# the walk 0.045 ms against mma.sync's 0.070 at its shape, and 0.033 against
# 0.044 at its heads of 64 (H100 80GB HBM3 at 700 W; PERF.md)
WALK_GROUP1_HEAD_DIMS = (64, 128)
WALK_MAX_GROUP = 4  # query rows a warp keeps in registers: q and O, D / 32 each a lane
WALK_MIN_PAGE = 8  # a page's scale column is one 16-byte bulk copy of bf16 at 8 rows
WALK_WAVE_BLOCKS = 2  # walk_splits halves its splits until the grid holds this many blocks an SM
MAX_SMEM = 232448  # the most shared memory a block may take (H100)
NEG_CLAMP = -2.0 ** 20  # the kernels' floor of the running max (attention_core.cuh)
LOG2E = math.log2(math.e)
WALK_DEFINES = {"WALK_STAGES": WALK_STAGES, "WALK_SPLIT_KEYS": WALK_SPLIT_KEYS,
                "WALK_WARPS": WALK_WARPS, "WALK_ROUND": WALK_ROUND}
KERNEL = Kernel(
    "paged_attention", "paged_attention_launch",
    [_I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
     _I, _I, ctypes.c_float, _P],
    replaces="src/repro/kernels/paged_attention.py:32",
    defines=WALK_DEFINES,
)
ROUTES = {"cuda cores": 0, "mma.sync": 1, "walk": 2}  # the C entry point's tc argument


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


def walk_path(dtype: torch.dtype, head_dim: int, group: int, page_size: int) -> bool:
    """Whether a launch takes the bulk-copy walk: bf16 at a head dim of
    ``WALK_HEAD_DIMS`` with at most ``WALK_MAX_GROUP`` query heads a kv head
    (q and O of the group's rows live in a warp's registers), or of
    ``WALK_GROUP1_HEAD_DIMS`` at a group of 1, over pages of at least
    ``WALK_MIN_PAGE`` positions (a page's bf16 scale column, the quantized
    twin's, is then a whole 16-byte bulk copy; both decodes keep one
    route).  Slots and lengths do not matter."""
    if dtype != torch.bfloat16 or page_size < WALK_MIN_PAGE:
        return False
    return ((head_dim in WALK_HEAD_DIMS and group <= WALK_MAX_GROUP)
            or (head_dim in WALK_GROUP1_HEAD_DIMS and group == 1))


def route(dtype: torch.dtype, head_dim: int, group: int, page_size: int) -> int:
    """The body a launch takes, as the C entry point's ``tc`` code
    (``ROUTES``): the walk where :func:`walk_path` takes it, else mma.sync
    where :func:`tensor_core_path` does, else the CUDA cores."""
    if walk_path(dtype, head_dim, group, page_size):
        return ROUTES["walk"]
    return int(tensor_core_path(dtype, head_dim, group))


def walk_splits(slots: int, kv_heads: int, max_pages: int, page_size: int,
                sms: int) -> Tuple[int, int]:
    """(splits, keys a split) of the walk's grid (kv_heads, slots, splits),
    from static shapes and the card's SM count only.  A split holds
    ``WALK_SPLIT_KEYS`` keys (whole pages: 8 of 16 positions), so that a
    long slot's keys stream through many SMs at once while the merge reads
    few partial states; where slots x kv heads x splits would leave fewer
    than ``WALK_WAVE_BLOCKS`` blocks an SM, the split halves (down to one
    page).  At gemma-7b's serving shape (slots 8, Hkv 16, 64 pages of 16) 8
    splits of 128 keys, 1024 blocks on 132 SMs."""
    keys = max_pages * page_size
    split = max(WALK_SPLIT_KEYS, page_size)
    while (split > page_size
           and slots * kv_heads * -(-keys // split) < WALK_WAVE_BLOCKS * sms):
        split //= 2
    return -(-keys // split), split


def walk_smem_bytes(head_dim: int, group: int, page_size: int, pack: int = 0) -> int:
    """Shared memory of a walk block (decode_walk.cuh's Layout): the ring
    of WALK_STAGES stages, each a page of K and of V (bf16 rows, or ``pack``
    1 / 2 packed int8 / int4 rows plus their bf16 scale columns), the full
    and empty mbarriers, the split's table entries and the warps' merge
    area (O, m and l of each warp's rows: the group rounded up to a power of
    two)."""
    rows = 1 << max(0, group - 1).bit_length()
    row_bytes = head_dim * 2 if pack == 0 else head_dim // pack
    scale_bytes = 0 if pack == 0 else page_size * 2
    stage = 2 * (page_size * row_bytes + scale_bytes)
    bars = 16 * WALK_STAGES
    pages = 4 * (WALK_SPLIT_KEYS // WALK_MIN_PAGE)
    merge = 4 * WALK_WARPS * rows * (head_dim + 2)
    return WALK_STAGES * stage + bars + pages + merge


def split_scratch(q: torch.Tensor, kv_heads: int, max_pages: int, page_size: int,
                  walk: bool = False):
    """(splits, split_keys, o_part, ml_part) of a decode launch for ``q``
    (slots, Hq, D) on its card: the grid (:func:`walk_splits`' for the
    walk, else :func:`decode_splits`') and the fp32 scratch its split
    blocks leave their partial states in, O unnormalised (slots, Hq,
    splits, D), then m and l (2, slots, Hq, splits)."""
    b, hq, d = q.shape
    rule = walk_splits if walk else decode_splits
    splits, split_keys = rule(b, kv_heads, max_pages, page_size,
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
    tc = route(q.dtype, d, hq // hkv, page_size)
    if tc == ROUTES["walk"]:
        _require(walk_smem_bytes(d, hq // hkv, page_size) <= MAX_SMEM,
                 "the walk's shared memory at this shape")
    splits, split_keys, o_part, ml_part = split_scratch(
        q, hkv, max_pages, page_size, walk=tc == ROUTES["walk"])
    _require(b <= 65535 and splits <= 65535, f"{b} slots x {splits} splits")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = KERNEL.function()(
            DTYPES[q.dtype], tc, q.data_ptr(), k_pages.data_ptr(),
            v_pages.data_ptr(), block_tables.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), o_part.data_ptr(), ml_part.data_ptr(), b, hq, hkv, d,
            page_size, max_pages, num_pages, window if window is not None else 0,
            splits, split_keys, scale, stream,
        )
    check(rc, "paged_attention")
    KERNEL.launches += 1
    KERNEL.tc_launches += int(tc == ROUTES["mma.sync"])
    KERNEL.walk_launches += int(tc == ROUTES["walk"])
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
    o, _, l = merge_states(split_states(scores, v, splits, split_keys, tile, pair=pair),
                           rescale=rescale)
    return o / l.clamp_min(1e-30)


def split_states(scores, v, splits: int, split_keys: int, tile: int, *,
                 pair: bool = False, acc_dtype=torch.float32):
    """The partial state (O, m, l) each split of :func:`fold_splits` leaves:
    O unnormalised, m clamped at NEG_CLAMP.  ``acc_dtype`` bfloat16 is the
    fault of a kernel that keeps l and O in bf16 after every tile."""
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
            l = (l * alpha + p.sum(-1, keepdim=True)).to(acc_dtype).float()
            o = (o * alpha + pv).to(acc_dtype).float()
            m = m_new
        states.append((o, m.clamp_min(NEG_CLAMP), l))
    return states


def merge_states(states, rescale: bool = True):
    """Partial states (O, m, l) rescaled to their common max and summed:
    (O, max m, l).  ``rescale=False`` sums them as they stand (a fault)."""
    mx = torch.stack([m for _, m, _ in states]).amax(0)
    out = torch.zeros_like(states[0][0])
    den = torch.zeros_like(states[0][2])
    for o, m, l in states:
        w = torch.exp2(m - mx) if rescale else torch.ones_like(m)
        out = out + w * o
        den = den + w * l
    return out, mx, den


def walk_decode(q, k_pages, v_pages, block_tables, seq_lens, splits: int,
                split_keys: int, *, sm_scale: Optional[float] = None,
                window: Optional[int] = None, warps: int = WALK_WARPS,
                round_keys: int = WALK_ROUND, warp_rescale: bool = True,
                split_rescale: bool = True, acc_dtype=torch.float32) -> torch.Tensor:
    """The bulk-copy walk's arithmetic in plain PyTorch (a rehearsal, not a
    path; bf16 pools, or the quantized twin's dequantized to bf16): q
    prescaled by sm_scale log2e in fp32; in each split, key j of a page
    falls to warp (j % round_keys) // (round_keys // warps), which folds its
    keys in runs of round_keys // warps into its own online softmax; the
    warps' states merge, rescaled to their common max, into the split's
    state; the splits merge as split_merge.cuh does, rounded once.  Keys
    outside [max(0, len - window), len) and pages outside the pool (which
    the kernel does not copy) contribute nothing, their values unread.
    ``warp_rescale`` / ``split_rescale`` False sum the states as they stand,
    ``acc_dtype`` bfloat16 keeps l and O in bf16: three faults."""
    b, hq, d = q.shape
    hkv, num_pages, page_size, _ = k_pages.shape
    group = hq // hkv
    qscale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)) * LOG2E
    tables = block_tables.long()
    inside = ((tables >= 0) & (tables < num_pages)).repeat_interleave(page_size, 1)
    pages = tables.clamp(0, num_pages - 1)
    k = k_pages[:, pages].transpose(0, 1).reshape(b, hkv, -1, d).float()
    v = v_pages[:, pages].transpose(0, 1).reshape(b, hkv, -1, d).float()
    qs = q.reshape(b, hkv, group, d).float() * qscale
    live = mask_live(torch.zeros(b, k.shape[2], device=q.device), seq_lens, window) == 0
    live = live & inside
    scores = torch.einsum("bhgd,bhsd->bhgs", qs, k).masked_fill(
        ~live[:, None, None, :], float("-inf"))
    v = v.masked_fill(~live[:, None, :, None], 0.0)  # a dead key's value is never read
    share = round_keys // warps
    warp_of = torch.arange(scores.shape[-1], device=q.device) % page_size % round_keys // share
    per_warp = []
    for w in range(warps):
        idx = torch.nonzero(warp_of == w).flatten()
        per_warp.append(split_states(scores[..., idx], v[..., idx, :], splits,
                                     split_keys // warps, share, acc_dtype=acc_dtype))
    states = [merge_states([per_warp[w][s] for w in range(warps)], rescale=warp_rescale)
              for s in range(splits)]
    o, _, l = merge_states(states, rescale=split_rescale)
    return (o / l.clamp_min(1e-30)).reshape(b, hq, d).to(q.dtype)


# ---------------------------------------------------------------------------
# The tile programs (repro/kernels/paged_attention.py:32 and :93): grid
# (kv_head, slot), the KV-page axis pipelined, each step's K/V page gathered
# through the block table; the shared online softmax (attention_core.py)
# with GQA group-major Q packing and the ragged mask against ``Lens``.
# ---------------------------------------------------------------------------


def paged_attention_program(
    slots: int,
    heads: int,
    kv_heads: int,
    head_dim: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    window: Optional[int] = None,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
) -> TileProgram:
    if heads % kv_heads:
        raise ValueError("GQA requires heads % kv_heads == 0")
    group = heads // kv_heads
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)) * 1.44269504  # log2(e)

    @T.prim_func
    def PagedAttn(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Lens: T.ScalarTensor((slots,), "int32"),
        Q: T.Tensor((slots, heads, head_dim), dtype),
        KPages: T.Tensor((kv_heads, num_pages, page_size, head_dim), dtype),
        VPages: T.Tensor((kv_heads, num_pages, page_size, head_dim), dtype),
        Output: T.Tensor((slots, heads, head_dim), dtype),
    ):
        with T.Kernel(kv_heads, slots) as (bh, bz):
            Q_shared = T.alloc_shared((group, head_dim), dtype)
            K_shared = T.alloc_shared((page_size, head_dim), dtype)
            V_shared = T.alloc_shared((page_size, head_dim), dtype)
            acc_s = T.alloc_fragment((group, page_size), accum_dtype)
            # safe_div: empty slots (len 0) divide by the floor -> zeros
            ons = AC.OnlineSoftmax(group, head_dim, scale, accum_dtype,
                                   safe_div=True)

            T.copy(Q[bz, bh * group, 0], Q_shared)

            def load_kv(k):
                # the paged gather: page index loaded from the block table
                T.copy(KPages[bh, Tables[bz, k], 0, 0], K_shared)
                T.copy(VPages[bh, Tables[bz, k], 0, 0], V_shared)
                return K_shared, V_shared

            # the slot's live positions are [max(0, len - window), len)
            def mask(k):
                return AC.ragged(Lens[bz], lambda j: k * page_size + j, window)

            AC.attend(
                ons, acc_s, page_size, max_pages, load_kv,
                lambda s, ks, k: AC.scores(s, Q_shared, ks), mask,
                num_stages=num_stages,
            )
            ons.finalize(Output[bz, bh * group, 0])

    return PagedAttn


def paged_attention_quant_program(
    slots: int,
    heads: int,
    kv_heads: int,
    head_dim: int,
    page_size: int,
    max_pages: int,
    num_pages: int,
    fmt: str = "int8",
    window: Optional[int] = None,
    dtype: str = "float32",
    accum_dtype: str = "float32",
    num_stages: int = 2,
    sm_scale: Optional[float] = None,
) -> TileProgram:
    """The fp program with ``load_kv`` routed through
    :class:`attention_core.DequantStage`: pages of packed int8 K/V
    (``head_dim // pack`` bytes a token) and a scale column a token,
    unpacked and scaled between the page copy and the score GEMM."""
    if heads % kv_heads:
        raise ValueError("GQA requires heads % kv_heads == 0")
    group = heads // kv_heads
    pack = AC.KV_PACK[fmt]
    scale = (sm_scale if sm_scale is not None else 1.0 / math.sqrt(head_dim)) * 1.44269504  # log2(e)

    @T.prim_func
    def PagedAttnQuant(
        Tables: T.ScalarTensor((slots, max_pages), "int32"),
        Lens: T.ScalarTensor((slots,), "int32"),
        Q: T.Tensor((slots, heads, head_dim), dtype),
        KPages: T.Tensor((kv_heads, num_pages, page_size, head_dim // pack), "int8"),
        VPages: T.Tensor((kv_heads, num_pages, page_size, head_dim // pack), "int8"),
        KScales: T.Tensor((kv_heads, num_pages, page_size, 1), dtype),
        VScales: T.Tensor((kv_heads, num_pages, page_size, 1), dtype),
        Output: T.Tensor((slots, heads, head_dim), dtype),
    ):
        with T.Kernel(kv_heads, slots) as (bh, bz):
            Q_shared = T.alloc_shared((group, head_dim), dtype)
            kq = AC.DequantStage(page_size, head_dim, fmt, dtype)
            vq = AC.DequantStage(page_size, head_dim, fmt, dtype)
            acc_s = T.alloc_fragment((group, page_size), accum_dtype)
            ons = AC.OnlineSoftmax(group, head_dim, scale, accum_dtype,
                                   safe_div=True)

            T.copy(Q[bz, bh * group, 0], Q_shared)

            def load_kv(k):
                # paged gather + inline dequant (page index from the table)
                ks = kq.load(KPages[bh, Tables[bz, k], 0, 0],
                             KScales[bh, Tables[bz, k], 0, 0])
                vs = vq.load(VPages[bh, Tables[bz, k], 0, 0],
                             VScales[bh, Tables[bz, k], 0, 0])
                return ks, vs

            def mask(k):
                return AC.ragged(Lens[bz], lambda j: k * page_size + j, window)

            AC.attend(
                ons, acc_s, page_size, max_pages, load_kv,
                lambda s, ks, k: AC.scores(s, Q_shared, ks), mask,
                num_stages=num_stages,
            )
            ons.finalize(Output[bz, bh * group, 0])

    return PagedAttnQuant


# Tiny-shape configs of the backend-parity suite: GQA and MQA groupings, a
# sliding window, ragged lengths (parity_inputs below), and the quantized
# twin in int8 and packed int4.
PARITY_CASES = [
    (
        "paged_attention_mqa",
        dict(slots=2, heads=2, kv_heads=1, head_dim=16, page_size=16,
             max_pages=2, num_pages=4),
    ),
    (
        "paged_attention_gqa_ragged",
        dict(slots=3, heads=4, kv_heads=2, head_dim=16, page_size=16,
             max_pages=2, num_pages=8),
    ),
    (
        "paged_attention_windowed",
        dict(slots=2, heads=2, kv_heads=2, head_dim=16, page_size=16,
             max_pages=2, num_pages=4, window=12),
    ),
    (
        "paged_attention_quant_int8",
        dict(slots=3, heads=4, kv_heads=2, head_dim=16, page_size=16,
             max_pages=2, num_pages=8, fmt="int8"),
    ),
    (
        "paged_attention_quant_int4",
        dict(slots=2, heads=2, kv_heads=1, head_dim=16, page_size=16,
             max_pages=2, num_pages=4, fmt="int4"),
    ),
]


def parity_programs():
    for name, cfg in PARITY_CASES:
        maker = paged_attention_quant_program if "quant" in name else paged_attention_program
        yield name, maker(**cfg)


def parity_inputs(name, program, rng):
    """Valid numpy inputs of a parity case: tables drawn without
    replacement (each page owned by one slot), ragged lengths (a partial
    page among them), full-range packed bytes and positive scales for the
    quantized twin."""
    cfg = dict(PARITY_CASES)[name]
    slots, mp, np_ = cfg["slots"], cfg["max_pages"], cfg["num_pages"]
    pages = rng.permutation(np_)[: slots * mp].reshape(slots, mp).astype("int32")
    max_len = mp * cfg["page_size"]
    lens = (rng.integers(1, max_len + 1, size=slots)).astype("int32")
    args = [pages, lens]
    for p in program.input_params()[2:]:
        if str(p.dtype).startswith("int"):
            args.append(rng.integers(-128, 128, size=p.shape).astype(p.dtype))
        elif p.name.endswith("Scales"):
            args.append(rng.uniform(0.05, 0.2, size=p.shape).astype(p.dtype))
        else:
            args.append(rng.standard_normal(p.shape).astype(p.dtype))
    return args
