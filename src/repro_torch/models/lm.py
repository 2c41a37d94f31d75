"""Decoder-only language model: dense GQA, MLA + MoE, GQA + MoE, Mamba-2
SSM, hybrid (GQA attention beside Mamba-2) and frontend (GQA decoder behind
a stubbed patch-embedding prefix) families; the port's counterpart of
``repro.models.lm`` for the serving path, and for the full-sequence forward
and loss of training.

Parameters are a plain dict with the reference's tree layout
(``lm.init``, lm.py:61): ``embed``, ``prefix_layers`` (a list of unstacked
blocks: DeepSeek-V2's first, dense-FFN layer; empty otherwise), ``layers``
with every leaf stacked over the remaining layers in front, and
``final_norm``.  A Python loop over layers takes the place of
``jax.lax.scan``.  The paged pools (or the contiguous strips) live in
:class:`Cache` and are updated **in place** by :func:`decode_step`,
:func:`prefill_step` and :func:`copy_pages`, and so is the recurrent state
(the reference donated them and returned new ones).

Every decoder-only family of the configs runs: ``family == "dense"`` with
GQA attention (``qwen2_1_5b``), ``family == "moe"`` with MLA attention
(``deepseek_v2_lite_16b``) or with GQA attention (``granite_moe_3b_a800m``),
the attention-free ``family == "ssm"`` (``mamba2_2_7b``, over a contiguous
recurrent-state cache), ``family == "hybrid"`` (``hymba_1_5b``: each block
mixes GQA attention and Mamba-2 half and half, over paged pools plus the
recurrent state) and ``family == "vlm"`` (``internvl2_26b``: a GQA decoder
whose training forward takes the stub frontend's ``prefix_embeds``; it
serves text only, as the reference).  The encoder-decoder (``whisper_tiny``)
is ``models.encdec``'s.  The full-sequence forward (:func:`forward`,
:func:`loss_fn`, the MoE's auxiliary loss included) runs every family,
MLA through ``layers.mla_full`` (deepseek-v2-lite's training).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from . import layers as L
from .config import ModelConfig

_PORTED = {("dense", "gqa"), ("moe", "mla"), ("moe", "gqa"), ("ssm", "none"),
           ("hybrid", "gqa"), ("vlm", "gqa")}
BIG_WINDOW = 1 << 30  # "no window" sentinel of layer_windows


def require_supported(cfg: ModelConfig):
    """Raise unless ``cfg`` is a decoder-only model of a ported family and
    attention pair: ``ValueError`` for an encoder-decoder (its functions are
    ``models.encdec``'s), ``NotImplementedError`` for any other pair (MLA
    without MoE naming its ROADMAP Queue 1 item)."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"{cfg.name} is an encoder-decoder model: its parameters, loss and "
            "decode are repro_torch.models.encdec's, not lm's")
    if (cfg.family, cfg.attention) in _PORTED:
        return
    if cfg.attention == "mla":
        raise NotImplementedError(
            f"{cfg.name} (family={cfg.family}, attention=mla) is not ported to "
            "PyTorch yet: ROADMAP Queue 1 item 13 (MLA serving, ported with MoE "
            "only)")
    raise NotImplementedError(
        f"{cfg.name}: family={cfg.family} with attention={cfg.attention} is no "
        "family of the reference's configs")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def _init_block(gen, cfg: ModelConfig, dense_ffn: bool) -> Dict:
    """One block (lm.py:34): attention (GQA or MLA) and its FFN: the MoE,
    or a dense MLP (an MoE model's dense prefix layer widened to the active
    experts' width, lm.py:51-57); or, for the SSM family, its norm and the
    Mamba-2 layer alone; a hybrid block adds the Mamba-2 layer and its norm
    ``norm_m`` beside the attention (lm.py:41-44)."""
    dt = L.dtype_of(cfg)
    ones = lambda: torch.ones((cfg.d_model,), dtype=dt, device=gen.device)  # noqa: E731
    if cfg.family == "ssm":
        return {"norm1": ones(), "mamba": L.init_mamba2(gen, cfg)}
    attn = L.init_mla(gen, cfg) if cfg.attention == "mla" else L.init_attention(gen, cfg)
    p = {"norm1": ones(), "attn": attn}
    if cfg.family == "hybrid":
        p["mamba"] = L.init_mamba2(gen, cfg)
        p["norm_m"] = ones()
    p["norm2"] = ones()
    mo = cfg.moe
    if mo is not None and mo.num_experts and not dense_ffn:
        p["moe"] = L.init_moe(gen, cfg)
    elif cfg.d_ff:
        p["mlp"] = L.init_mlp(gen, cfg)
    else:
        p["mlp"] = L.init_mlp(gen, cfg, d_ff=mo.d_ff_expert * max(
            mo.experts_per_token + mo.num_shared_experts, 1))
    return p


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def stacked(make, n: int) -> Dict:
    """``n`` blocks from ``make()`` with every leaf stacked over them in
    front.  Each block is drawn and copied into preallocated stacked
    leaves, so at full width the peak holds one copy of the weights plus
    one block, not two copies."""
    out = None
    for i in range(n):
        block = make()
        if out is None:
            out = _tree_map(lambda t: t.new_empty((n,) + tuple(t.shape)), block)
        _tree_map(lambda dst, src: dst[i].copy_(src), out, block)
    return out


def unstacked(tree) -> List[Dict]:
    """Each block's parameters, as views from one ``unbind`` of each
    stacked leaf.  For a differentiated forward autograd then joins the
    blocks' gradients into each stacked leaf with one stack (indexing a
    block out, as :func:`layer_params` does, would build a zero-filled
    gradient of the whole stacked leaf for every block)."""
    parts = _tree_map(lambda t: t.unbind(0), tree)
    return [_tree_map(lambda views: views[i], parts)
            for i in range(tree["norm1"].shape[0])]


def num_prefix_layers(cfg: ModelConfig) -> int:
    """Unstacked dense-FFN layers in front (DeepSeek-V2's first layer)."""
    return cfg.moe.first_dense_layers if cfg.moe else 0


def init(cfg: ModelConfig, key: Union[int, torch.Generator] = 0, *,
         device="cuda") -> Dict:
    """Random parameters in the shapes and distribution of ``lm.init``.

    ``key`` is a seed or a ``torch.Generator`` on ``device``.  Weights are
    drawn on the device itself, so a full-width model never passes through
    host memory."""
    require_supported(cfg)
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
        if gen.device.type != dev.type:
            raise ValueError(f"generator is on {gen.device}, device is {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(key))
    params: Dict[str, Any] = {"embed": L.init_embedding(gen, cfg)}
    n_prefix = num_prefix_layers(cfg)
    params["prefix_layers"] = [_init_block(gen, cfg, dense_ffn=True)
                               for _ in range(n_prefix)]
    params["layers"] = stacked(lambda: _init_block(gen, cfg, dense_ffn=False),
                               cfg.num_layers - n_prefix)
    params["final_norm"] = torch.ones((cfg.d_model,), dtype=L.dtype_of(cfg),
                                      device=dev)
    return params


def param_count(params) -> int:
    def count(t):
        if isinstance(t, dict):
            return sum(count(v) for v in t.values())
        if isinstance(t, list):
            return sum(count(v) for v in t)
        return t.numel()
    return count(params)


def layer_params(params, i: int) -> Dict:
    """Stacked layer ``i``'s parameters: views into the stacked leaves."""
    def pick(t):
        return {k: pick(v) for k, v in t.items()} if isinstance(t, dict) else t[i]
    return pick(params["layers"])


def blocks(params) -> List[Dict]:
    """Every layer's parameters in order: the prefix layers, then views
    into the stacked ones."""
    n = params["layers"]["norm1"].shape[0]
    return list(params["prefix_layers"]) + [layer_params(params, i)
                                            for i in range(n)]


def static_windows(cfg: ModelConfig) -> List[Optional[int]]:
    """Python-level per-layer window (None = global attention)."""
    out: List[Optional[int]] = []
    for i in range(cfg.num_layers):
        w = cfg.window_for_layer(i)
        if cfg.family == "hybrid" and i in (0, cfg.num_layers // 2, cfg.num_layers - 1):
            w = None
        out.append(w)
    return out


def layer_windows(cfg: ModelConfig) -> List[int]:
    """Per-layer windows of the full-sequence path, BIG_WINDOW for a global
    layer (lm.py:99)."""
    return [w if w is not None else BIG_WINDOW for w in static_windows(cfg)]


def rope_fraction(cfg: ModelConfig) -> float:
    # ChatGLM's "2d RoPE" rotates half the head dim
    return 0.5 if "chatglm" in cfg.name else 1.0


def _soft_cap(cfg: ModelConfig, logits):
    if cfg.logit_soft_cap:
        logits = cfg.logit_soft_cap * torch.tanh(logits / cfg.logit_soft_cap)
    return logits


# ---------------------------------------------------------------------------
# decode caches
# ---------------------------------------------------------------------------


class Cache:
    """Decode cache, one of two layouts behind one interface (lm.py:268).

    ``layout="paged"``: per-layer page pools stacked over all layers
    (prefix layers included: they share the pools' shapes), plus the (B,
    max_pages) int32 block table.

    For GQA, ``kv`` holds ``k_pages``/``v_pages`` of shape (L, Hkv, P,
    page_size, D) or, with ``cfg.kv_dtype``, packed int8 pools (L, Hkv, P,
    page_size, D // pack) plus ``k_scale_pages``/``v_scale_pages`` (L, Hkv,
    P, page_size, 1).  For MLA it holds the latent and rope pools
    ``ckv_pages`` (L, P, page_size, R) and ``kpe_pages`` (L, P, page_size,
    Dpe), packed with ``ckv_scale_pages``/``kpe_scale_pages`` when
    quantized.  Every pool leaf is named ``*_pages`` and has its page axis
    at ``ndim - 3``, as in the reference.  For the hybrid, ``kv`` also holds
    each layer's recurrent rows under the reference's names, ``ssm`` (L, B,
    H, N, P) fp32 and ``conv`` (L, B, W - 1, conv_dim): one row a slot, not
    paged.  Steps write the pools and rows in place; :meth:`with_tables`
    swaps in a refreshed table (the host-side allocation lives in
    serving/paged_cache.py).

    ``layout="contiguous"``: per-slot strips, no block table.  GQA holds
    ``k``/``v``, a list of one (B, Hkv, size, D) strip a layer, ``size`` the
    layer's window where it has one (a ring, lm.py:341), else ``max_len``:
    strips of two sizes cannot stack, so no strip leaf is stacked (the
    reference stacks only uniform layers, lm.py:359).  MLA holds ``c_kv``
    (B, max_len, 1, R) and ``k_pe`` (B, max_len, 1, Dpe) a layer.  The SSM
    family holds the recurrent state ``ssm`` (L, B, H, N, P) fp32 and the
    conv window ``conv`` (L, B, W - 1, conv_dim), one row per slot; the
    hybrid both the strips and the state.  Steps write them in place.

    ``groups`` lists the reference's layer groups of the paged pools as
    ``(start, stop, stacked)``: its unstacked prefix layers one by one, then
    the rest stacked when their windows agree (lm.py:353-363).
    :func:`gather_pages` walks the pools in that order, so a snapshot's
    leaves have the reference's shapes."""

    def __init__(self, kv: Dict[str, Any], max_len: int, page_size: int,
                 tables: Optional[torch.Tensor], layout: str = "paged",
                 groups: Optional[List[tuple]] = None):
        self.kv = kv
        self.max_len = max_len
        self.page_size = page_size
        self.tables = tables
        self.layout = layout
        self.groups = groups

    def leaves(self) -> List[torch.Tensor]:
        """Every tensor of the cache: stacked leaves, and each layer's strip."""
        return [t for v in self.kv.values()
                for t in (v if isinstance(v, list) else [v])]

    @property
    def device(self) -> torch.device:
        return self.leaves()[0].device

    @property
    def num_pages(self) -> int:
        leaf = next(t for name, t in self.kv.items() if name.endswith("_pages"))
        return leaf.shape[leaf.ndim - 3]

    def layer(self, i: int) -> Dict[str, torch.Tensor]:
        """Layer ``i``'s pools, strips and state: views of stacked leaves (so
        writes land in them) and the layer's own strips."""
        return {k: v[i] for k, v in self.kv.items()}

    def with_tables(self, tables) -> "Cache":
        """Same pools (shared, not copied) under refreshed block tables."""
        return Cache(self.kv, self.max_len, self.page_size, tables, self.layout,
                     self.groups)

    def kv_bytes(self) -> int:
        """Bytes held by every leaf: the KV page pools, scale pools included,
        or the strips, and the recurrent state (lm.py:309)."""
        return sum(t.numel() * t.element_size() for t in self.leaves())


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               layout: str = "paged", page_size: int = 16,
               num_blocks: Optional[int] = None, device="cuda") -> Cache:
    """The decode cache of ``batch`` slots (lm.py:317): paged pools for an
    attention model (with each slot's recurrent rows for the hybrid), or
    ``layout="contiguous"``: per-slot strips (rings for windowed GQA
    layers, latent strips for MLA) and/or the recurrent state.  The
    contiguous strips hold the model's dtype only: a ``cfg.kv_dtype`` raises
    the reference's ``ValueError``."""
    require_supported(cfg)
    if layout not in ("contiguous", "paged"):
        raise ValueError(f"unknown cache layout {layout!r}")
    if layout == "paged" and not cfg.attends:
        # loud, not a silent downgrade: the caller asked for paging and
        # this arch has no attention KV state to page (lm.py:322-330)
        raise ValueError(
            f"layout='paged' needs an attention KV cache; {cfg.name} "
            f"(attention={cfg.attention!r}) keeps only recurrent state — "
            "use layout='contiguous'.")
    dev = resolve_device(device)
    wlist = static_windows(cfg)
    if layout == "contiguous":
        kv: Dict[str, Any] = {}
        if cfg.attention == "gqa":
            strips = [L.init_kv_cache(cfg, batch, max_len, dev, window=w)
                      for w in wlist]
            kv = {k: [st[k] for st in strips] for k in ("k", "v")}
        elif cfg.attention == "mla":
            strips = [L.init_mla_cache(cfg, batch, max_len, dev)
                      for _ in wlist]
            kv = {k: [st[k] for st in strips] for k in ("c_kv", "k_pe")}
        if cfg.family in ("ssm", "hybrid"):
            kv.update(L.init_mamba2_cache(cfg, batch, dev, layers=cfg.num_layers))
        return Cache(kv, max_len, 0, None, layout="contiguous")
    max_pages = -(-max_len // page_size)
    if num_blocks is None:
        num_blocks = batch * max_pages
    init_pools = (L.init_mla_paged_cache if cfg.attention == "mla"
                  else L.init_paged_kv_cache)
    kv = init_pools(cfg, num_blocks, page_size, dev, layers=cfg.num_layers)
    if cfg.family == "hybrid":  # lm.py:349-350: the state beside the pools
        kv.update(L.init_mamba2_cache(cfg, batch, dev, layers=cfg.num_layers))
    tables = torch.zeros((batch, max_pages), dtype=torch.int32, device=dev)
    n_prefix = num_prefix_layers(cfg)
    groups = [(i, i + 1, False) for i in range(n_prefix)]
    rest = cfg.num_layers - n_prefix
    if len(set(wlist[n_prefix:])) <= 1 and rest > 1:
        groups.append((n_prefix, cfg.num_layers, True))
    else:
        groups += [(i, i + 1, False) for i in range(n_prefix, cfg.num_layers)]
    return Cache(kv, max_len, page_size, tables, groups=groups)


def copy_pages(cache: Cache, src, dst) -> Cache:
    """Copy-on-write on the device: duplicate physical pages ``src[i]`` onto
    ``dst[i]`` in every page pool (the ``*_pages`` leaves, lm.py:399), in
    place (lm.py:366).  The shared contents never pass through the host; a
    hybrid's recurrent rows are not pages and stay as they are."""
    src = torch.as_tensor(src, dtype=torch.long, device=cache.tables.device)
    dst = torch.as_tensor(dst, dtype=torch.long, device=cache.tables.device)
    for name, leaf in cache.kv.items():
        if not name.endswith("_pages"):
            continue
        pool = leaf.movedim(leaf.ndim - 3, 0)  # a view: pages leading
        pool[dst] = pool[src]
    return cache


def _pool_leaves(cache: Cache):
    """Every page-pool leaf in the reference's flatten order (lm.py:410):
    for each of ``cache.groups``, the ``*_pages`` leaves by name, each a
    view with its page axis leading: (P, L, ...) for a stacked group, (P,
    ...) for one layer."""
    if cache.layout != "paged":
        raise ValueError("page pools need a paged cache")
    names = sorted(n for n in cache.kv if n.endswith("_pages"))
    for start, stop, stacked in cache.groups:
        for name in names:
            leaf = cache.kv[name][start:stop] if stacked else cache.kv[name][start]
            yield leaf.movedim(leaf.ndim - 3, 0)


def gather_pages(cache: Cache, pages) -> list:
    """Contents of physical ``pages`` from every pool leaf, page axis
    leading: numpy arrays of shape ``(len(pages), *per_page_shape)`` in
    :func:`page_leaf_shapes`' order (lm.py:410), the payload of the
    engine's ``snapshot()``.  numpy has no bfloat16: a bf16 pool's pages
    come back as their raw 16-bit patterns (uint16), as the port's
    checkpoints store them."""
    from ..convert import leaf_to_numpy

    idx = torch.as_tensor(list(pages), dtype=torch.long, device=cache.device)
    return [leaf_to_numpy(pool[idx])[0] for pool in _pool_leaves(cache)]


def scatter_pages(cache: Cache, pages, values) -> Cache:
    """Inverse of :func:`gather_pages` (lm.py:432): write ``values`` (one
    array a pool leaf, page axis leading; a bf16 leaf's as its raw 16-bit
    patterns) into physical ``pages`` of every pool leaf, in place."""
    from ..convert import bits_to_bfloat16

    idx = torch.as_tensor(list(pages), dtype=torch.long, device=cache.device)
    pools = list(_pool_leaves(cache))
    values = list(values)
    if len(values) != len(pools):
        raise ValueError(f"{len(values)} arrays for {len(pools)} page pools")
    for pool, v in zip(pools, values):
        v = (bits_to_bfloat16(v) if v.dtype == np.uint16
             else torch.from_numpy(np.ascontiguousarray(v)))
        pool[idx] = v.to(device=pool.device, dtype=pool.dtype)
    return cache


def page_leaf_shapes(cache: Cache) -> list:
    """``(per_page_shape, dtype_name)`` for every pool leaf in gather order
    (lm.py:456), with the reference's dtype names ("bfloat16", "float32",
    "int8"): the layout fingerprint a snapshot is checked against."""
    return [(tuple(pool.shape[1:]), str(pool.dtype).replace("torch.", ""))
            for pool in _pool_leaves(cache)]


# ---------------------------------------------------------------------------
# decode and chunked prefill
# ---------------------------------------------------------------------------


def _rows(mask, t):
    """A per-slot (B,) mask shaped to broadcast over ``t`` (B, ...)."""
    return mask.reshape(-1, *([1] * (t.dim() - 1)))


def _mamba_decode(p, h, cfg: ModelConfig, state, live, fresh):
    """The Mamba-2 recurrence of one block, one token (lm.py:525-546), its
    output returned.  ``state`` is the layer's ``ssm``/``conv`` rows,
    written in place.  With ``live`` (B,) bool, a slot stepping at ``pos ==
    0`` (``fresh``) starts from zeroed state and a slot not stepping keeps
    its state, as the reference's ``_per_slot`` selects: device-side masks,
    no host sync."""
    st_in = state
    if live is not None:
        st_in = {k: v.masked_fill(_rows(fresh, v), 0) for k, v in state.items()}
    out, new = L.mamba2_decode(p, h, cfg, st_in)
    for k, v in new.items():
        if live is None:
            state[k].copy_(v)
        else:  # written in place: the output aliases the kept state
            torch.where(_rows(live, v), v, state[k], out=state[k])
    return out


def _block(p, x, cfg, attend, recur=None):
    """One block (lm.py:111, :487, :657): attention, then the MoE or the
    MLP.  A hybrid block (``recur``: its Mamba-2 step, on ``rmsnorm(x,
    norm_m)``) adds the mean of the attention and the Mamba-2 outputs
    (lm.py:535-545).  Returns ``(x, aux)``: the MoE's load-balance loss, or
    None without experts."""
    h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
    delta = attend(p["attn"], h)
    if recur is not None:
        delta = 0.5 * (delta + recur(L.rmsnorm(x, p["norm_m"], cfg.norm_eps)))
    x = x + delta
    h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
    if "moe" in p:
        out, aux = L.moe(p["moe"], h2, cfg)
        return x + out, aux
    return x + L.mlp(p["mlp"], h2, cfg), None


def _decode_attention(cfg: ModelConfig, cache: Cache, pools, pos, window, rf,
                      append):
    """One layer's decode attention ``(params, h) -> out`` over its
    ``pools`` (lm.py:503-524): the paged kernels' path, or the contiguous
    strips' plain attention."""
    if cache.layout == "contiguous":
        if cfg.attention == "mla":
            return lambda pa, h: L.mla_decode(pa, h, cfg, pools, pos,
                                              window=window)
        return lambda pa, h: L.attention_decode(
            pa, h, cfg, pools, pos, window=window, rope_fraction=rf)
    if cfg.attention == "mla":
        return lambda pa, h: L.mla_decode_paged(
            pa, h, cfg, pools, pos, cache.tables, window=window, append=append)
    return lambda pa, h: L.attention_decode_paged(
        pa, h, cfg, pools, pos, cache.tables, window=window, rope_fraction=rf,
        append=append)


def decode_step(params, cfg: ModelConfig, cache: Cache, token, pos,
                live=None):
    """One decode step: ``token`` (B,) int32, ``pos`` (B,) int32 ->
    ``(logits (B, V) fp32, cache)``.

    Every slot writes its K/V at ``pos`` through its table row (or into its
    strip), dead ones included (into page 0), as the reference does.  ``live`` marks the slots
    genuinely stepping; positional KV caches never need it (a dead slot's
    write lands beyond its live length), so attention ignores it.
    Recurrent state has no position to hide behind: the SSM and hybrid
    families hold a parked slot's state and zero a slot stepping at ``pos ==
    0`` (:func:`_mamba_decode`).
    """
    pos = torch.as_tensor(pos, dtype=torch.int32, device=cache.device)
    x = L.embed(params["embed"], token[:, None]).to(L.dtype_of(cfg))
    fresh = None
    if live is not None and cfg.family in ("ssm", "hybrid"):
        fresh = live & (pos == 0)
    if not cfg.attends:  # the SSM family's recurrent state alone
        for i, p in enumerate(blocks(params)):
            h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
            x = x + _mamba_decode(p["mamba"], h, cfg, cache.layer(i), live, fresh)
        x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
        return _soft_cap(cfg, L.unembed(params["embed"], x, cfg)[:, 0]), cache
    wlist = static_windows(cfg)
    rf = rope_fraction(cfg)
    append = None
    if cache.layout == "paged":
        append = L.decode_append_index(pos, cache.tables, cache.page_size,
                                       cache.num_pages)
    for i, p in enumerate(blocks(params)):
        pools = cache.layer(i)
        attend = _decode_attention(cfg, cache, pools, pos, wlist[i], rf, append)
        recur = None
        if cfg.family == "hybrid":
            state = {k: pools[k] for k in ("ssm", "conv")}
            recur = lambda hm: _mamba_decode(  # noqa: E731
                p["mamba"], hm, cfg, state, live, fresh)
        x, _ = _block(p, x, cfg, attend, recur)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    logits = L.unembed(params["embed"], x, cfg)[:, 0]
    return _soft_cap(cfg, logits), cache


def decode_loop(params, cfg: ModelConfig, cache: Cache, feed, pos, key,
                live, remaining, *, n_steps: int, sample_fn, eos_id: int,
                max_len: int):
    """Up to ``n_steps`` decode ticks with no host transfer between them:
    the device-resident decode loop of the multi-step window (lm.py:602).

    ``feed`` (B,) is each slot's last known token, ``pos`` (B,) its next
    write position, ``key`` the PRNG key carry (``serving.prng``; None when
    greedy), ``live`` (B,) bool the slots generating, ``remaining`` (B,)
    each slot's token allowance, all device tensors, and they stay on the
    device: ``sample_fn(logits, key, gate) -> (tokens, key)`` samples there
    (``gate``, the any-slot-live flag, leaves the key unadvanced once every
    slot has stopped), and the stop rule is applied with masks, so nothing
    in the loop waits for the host.
    Per iteration, as the per-tick engine's ``_emit_token``: a live slot
    feeds its token, samples the next, advances ``pos`` and burns one
    ``remaining``; it stops when the token equals ``eos_id``, its allowance
    hits zero, or ``pos`` reaches ``max_len`` (lm.py:638-647).  Dead slots
    re-feed their frozen token at their frozen ``pos``: the write lands past
    their live length (or in the sink page 0) and is never read.  All
    ``n_steps`` iterations run, as the reference's ``lax.scan`` does.  The
    recurrent state (SSM, hybrid) is held for dead slots by ``live``
    (:func:`decode_step`).

    Returns ``(tokens (n_steps, B) int32, emitted (n_steps, B) bool, key)``:
    ``emitted[t, b]`` marks a token the host must deliver; rows after the
    last live iteration are all False.  The pools of ``cache`` are written
    in place."""
    toks, emitted = [], []
    for _ in range(n_steps):
        logits, cache = decode_step(params, cfg, cache, feed, pos, live=live)
        tok, key = sample_fn(logits, key, live.any())
        tok = torch.where(live, tok, feed)
        pos = torch.where(live, pos + 1, pos)
        remaining = torch.where(live, remaining - 1, remaining)
        stop = (tok == eos_id) | (remaining <= 0) | (pos >= max_len)
        toks.append(tok)
        emitted.append(live)
        feed, live = tok, live & ~stop
    return torch.stack(toks), torch.stack(emitted), key


def supports_chunked_prefill(cfg: ModelConfig) -> bool:
    """Chunked prefill covers the attention families (lm.py:698)."""
    return cfg.attention in ("gqa", "mla") and cfg.family not in ("ssm", "hybrid")


def _prefill_attention(cfg: ModelConfig, cache: Cache, pools, pos, lens, window,
                       rf, plain):
    """One layer's chunk attention ``(params, h) -> out`` over its ``pools``
    (lm.py:664-686): the paged kernels' path, or the contiguous strips'
    plain attention."""
    if cache.layout == "contiguous":
        if cfg.attention == "mla":
            return lambda pa, h: L.mla_prefill(pa, h, cfg, pools, pos, lens,
                                               window=window)
        return lambda pa, h: L.attention_prefill(
            pa, h, cfg, pools, pos, lens, window=window, rope_fraction=rf)
    if cfg.attention == "mla":
        return lambda pa, h: L.mla_prefill_paged(
            pa, h, cfg, pools, pos, cache.tables, lens, window=window,
            plain=plain)
    return lambda pa, h: L.attention_prefill_paged(
        pa, h, cfg, pools, pos, cache.tables, lens, window=window,
        rope_fraction=rf, plain=plain)


def _prefill_trunk(params, cfg: ModelConfig, cache: Cache, tokens, pos, lens,
                   plain: bool = False):
    """Embed, every block's chunk attention + KV page (or strip) writes,
    final norm (lm.py:706).  Returns ``x (B, C, d)``.  ``plain`` sends every
    paged block's attention to the plain version (``kernels.ops``' ``plain``
    argument); the contiguous strips' attention is plain by construction."""
    if not supports_chunked_prefill(cfg):
        raise NotImplementedError(
            f"chunked prefill supports attention archs (GQA/MLA); {cfg.name} "
            f"(attention={cfg.attention}, family={cfg.family}) replays "
            "prompts through decode_step instead.")
    dev = cache.device
    pos = torch.as_tensor(pos, dtype=torch.int32, device=dev)
    lens = torch.as_tensor(lens, dtype=torch.int32, device=dev)
    x = L.embed(params["embed"], tokens).to(L.dtype_of(cfg))
    wlist = static_windows(cfg)
    rf = rope_fraction(cfg)
    for i, p in enumerate(blocks(params)):
        pools = cache.layer(i)
        attend = _prefill_attention(cfg, cache, pools, pos, lens, wlist[i], rf,
                                    plain)
        x, _ = _block(p, x, cfg, attend)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), lens


def prefill_step(params, cfg: ModelConfig, cache: Cache, tokens, pos, lens):
    """One chunked-prefill step (lm.py:754): a (B, C) block of prompt tokens
    advances every slot with ``lens[b] > 0`` by ``lens[b]`` positions.
    Returns ``(logits (B, V), cache)``, the logits of each slot's last live
    chunk token (idle slots read row 0: garbage the engine ignores)."""
    x, lens = _prefill_trunk(params, cfg, cache, tokens, pos, lens)
    last = torch.clamp(lens - 1, 0, x.shape[1] - 1).long()
    x_last = x[torch.arange(x.shape[0], device=x.device), last]
    logits = L.unembed(params["embed"], x_last, cfg)
    return _soft_cap(cfg, logits), cache


# ---------------------------------------------------------------------------
# speculative decoding
# ---------------------------------------------------------------------------


def verify_step(params, cfg: ModelConfig, cache: Cache, tokens, pos, lens):
    """Speculative verify (lm.py:780): the chunked prefill's trunk (the same
    table-directed KV page writes) with every chunk position unembedded.
    Returns ``(logits (B, C, V) fp32, cache)``; rows of idle slots (``lens
    == 0``) are garbage the caller masks.

    Its attention takes the plain version at every chunk width, by
    construction: a verify chunk (``draft_len + 1`` tokens) starts at any
    position, while the prefill kernels write whole chunk pages from a
    page-aligned start (a width that is a multiple of the page size would
    otherwise reach them and overwrite the slot's earlier tokens in its
    first page).  ``kernels.ops.PLAIN_PREFILL`` counts those calls over
    pages; over contiguous strips the chunk is a gather-select write from
    any position (layers.py:358-371), plain as every contiguous layer."""
    x, _ = _prefill_trunk(params, cfg, cache, tokens, pos, lens, plain=True)
    return _soft_cap(cfg, L.unembed(params["embed"], x, cfg)), cache


def ngram_propose(history, pos, feed, draft_len: int):
    """The self-speculation proposer (lm.py:800): n-gram lookahead over each
    slot's own tokens.  ``history`` (B, H) int32 holds them by position
    (``history[b, pos[b]] == feed[b]``, entries past ``pos`` undefined).
    The most recent earlier occurrence of the slot's (previous, last)
    bigram, else of its last token, proposes the ``draft_len`` tokens that
    followed it; no match (or one too close to the end) repeats ``feed``.
    Proposals are always valid token ids: verify rejects wrong ones."""
    b, h = history.shape
    dev = history.device
    last = feed.to(torch.int32)
    pos = pos.to(torch.int32)
    js = torch.arange(h, dtype=torch.int32, device=dev)[None, :]
    uni = (js < pos[:, None]) & (history == last[:, None])  # strictly past
    before = torch.clamp(pos - 1, 0, h - 1).long()[:, None]
    prev = torch.where(pos > 0, history.gather(1, before)[:, 0],
                       torch.full_like(pos, -1))
    shifted = torch.cat([torch.full((b, 1), -1, dtype=history.dtype, device=dev),
                         history[:, :-1]], dim=1)
    bi = uni & (shifted == prev[:, None])
    none = torch.full_like(js.expand(b, h), -1)
    j_bi = torch.where(bi, js, none).amax(dim=1)
    j_uni = torch.where(uni, js, none).amax(dim=1)
    j = torch.where(j_bi >= 0, j_bi, j_uni)
    cols = j[:, None] + 1 + torch.arange(draft_len, dtype=torch.int32, device=dev)[None, :]
    ok = (j[:, None] >= 0) & (cols <= pos[:, None])
    cand = history.gather(1, torch.clamp(cols, 0, h - 1).long())
    return torch.where(ok, cand, last[:, None])


# Draft proposers by ``ServeConfig.spec_decode`` name (lm.py:842): any
# (history, pos, feed, draft_len) -> (B, draft_len) function qualifies,
# since verify never trusts a proposal.
DRAFT_PROPOSERS = {"ngram": ngram_propose}


def spec_decode_loop(params, cfg: ModelConfig, cache: Cache, feed, pos, key,
                     live, remaining, history, *, n_rounds: int,
                     draft_len: int, propose_fn, sample_fn, accept_fn,
                     eos_id: int, max_len: int, poison=None):
    """``n_rounds`` draft-verify rounds with no host transfer between them
    (lm.py:845): each round proposes ``draft_len`` tokens from the slot's
    own history (``propose_fn``), scores them with the feed token in one
    chunk (:func:`verify_step`), and emits the accepted prefix plus the
    model's own next token.  Accept and rollback are masks: the verify chunk
    writes KV for every position, and a rejected tail is cut by not
    advancing ``pos`` past the accepted prefix (the next round overwrites
    it; the engine trims the unused grow-ahead pages at the boundary).

    ``sample_fn(logits (B, C, V), key, gate) -> (targets (B, C), key)``
    splits the key a fixed number of times a live round
    (``sampling.spec_sample_step``); ``accept_fn(drafts, targets) -> (B, C)
    bool`` is the leading-accept mask (``sampling.spec_accept``).  Greedy
    targets make the stream byte-identical to plain decode.  Per position
    the per-tick stop rule applies: an earlier EOS, the allowance,
    ``max_len``.  ``poison`` (B,) bool, the fault injector's mask (a device
    tensor, or None), overwrites its slots' verify logits with NaN each
    round; a slot whose verify logits hold no finite value, injected or
    not, emits nothing and stops, flagged in ``bad`` for the engine to read
    at the window's one drain.  ``history`` (B, max_len) int32 is updated
    in place with the emitted tokens.

    Returns ``(targets (n, B, C) int32, emitted (n, B, C) bool, bad (n, B)
    bool, key)`` with ``C = draft_len + 1``; the pools of ``cache`` are
    written in place."""
    c = draft_len + 1
    dev = feed.device
    feed = feed.to(torch.int32)
    pos = pos.to(torch.int32)
    remaining = remaining.to(torch.int32)
    idx = torch.arange(c, dtype=torch.int32, device=dev)
    b, h = history.shape
    rows = torch.arange(b, device=dev)[:, None]
    toks, emits, bads = [], [], []
    for _ in range(n_rounds):
        drafts = propose_fn(history, pos, feed, draft_len)
        chunk = torch.cat([feed[:, None], drafts], dim=1)
        lens = torch.where(live, c, 0).to(torch.int32)
        logits, cache = verify_step(params, cfg, cache, chunk, pos, lens)
        if poison is not None:
            logits = torch.where(poison[:, None, None], torch.nan, logits)
        bad = (~torch.isfinite(logits).any(dim=-1)).any(dim=-1) & live
        tgt, key = sample_fn(logits, key, live.any())
        eos_hit = tgt == eos_id
        ieos = eos_hit.to(torch.int32)
        prev_eos = (torch.cumsum(ieos, dim=1) - ieos) > 0
        emit = (accept_fn(drafts, tgt) & ~prev_eos
                & ((pos[:, None] + idx[None, :]) < max_len)
                & (idx[None, :] < remaining[:, None])
                & live[:, None] & ~bad[:, None])
        nem = emit.sum(dim=1, dtype=torch.int32)
        last_tok = tgt.gather(1, torch.clamp(nem - 1, 0, c - 1).long()[:, None])[:, 0]
        feed = torch.where(nem > 0, last_tok, feed)
        # the emitted tokens join the history (a column past its end drops)
        wcols = torch.where(emit, pos[:, None] + 1 + idx[None, :], h)
        wide = torch.cat([history, history[:, :1]], dim=1)
        wide[rows, wcols.long()] = tgt.to(history.dtype)
        history.copy_(wide[:, :h])
        pos = pos + nem
        remaining = remaining - nem
        stop = ((emit & eos_hit).any(dim=1) | (remaining <= 0)
                | (pos >= max_len) | bad)
        live = live & ~stop
        toks.append(tgt)
        emits.append(emit)
        bads.append(bad)
    return torch.stack(toks), torch.stack(emits), torch.stack(bads), key


# ---------------------------------------------------------------------------
# full-sequence forward and loss (training)
# ---------------------------------------------------------------------------


def require_full_forward(cfg: ModelConfig):
    """Raise unless the full-sequence forward runs ``cfg``: every family
    and attention pair that :func:`require_supported` takes."""
    require_supported(cfg)


def training_blocks(params) -> List[Dict]:
    """Every layer's parameters in order, for a differentiated forward: the
    prefix layers, then the stacked ones :func:`unstacked`."""
    return list(params["prefix_layers"]) + unstacked(params["layers"])


def _block_full(p, x, cfg: ModelConfig, positions, window, rope_fraction):
    """One block, full sequence (lm.py:111): GQA attention or MLA
    (``layers.mla_full``, lm.py:131-132) then the MLP or the MoE (a dense
    prefix layer, or experts), or the SSM's Mamba-2 layer alone
    (lm.py:133-134), or the hybrid's mean of the attention and the Mamba-2
    layer on ``rmsnorm(x, norm_m)`` then the MLP (lm.py:135-137).  Returns (x, aux_loss): the
    MoE's load-balance loss (lm.py:141-143), zero without experts.

    ``window`` is the layer's :func:`layer_windows` entry, BIG_WINDOW for a
    global layer of a windowed model: not None, so ``ops.attention`` takes
    the plain version there too, as the reference's rule does
    (repro/kernels/ops.py:218-224)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if cfg.family == "ssm":
        h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
        return x + L.mamba2_full(p["mamba"], h, cfg), aux
    w = None if cfg.sliding_window is None else window
    if cfg.attention == "mla":
        attend = lambda pa, h: L.mla_full(pa, h, cfg, positions)  # noqa: E731
    else:
        attend = lambda pa, h: L.attention_full(  # noqa: E731
            pa, h, cfg, positions, window=w, rope_fraction=rope_fraction)
    recur = None
    if cfg.family == "hybrid":
        recur = lambda hm: L.mamba2_full(p["mamba"], hm, cfg)  # noqa: E731
    x, moe_aux = _block(p, x, cfg, attend, recur)
    return x, aux if moe_aux is None else moe_aux


def hidden_forward(params, cfg: ModelConfig, tokens, prefix_embeds=None,
                   remat: bool = False, residual_constraint=None,
                   unroll: int = 1):
    """Final hidden states (B, S_total, d) and the aux loss (lm.py:154).

    ``prefix_embeds`` (B, P, d) go in front of the token embeddings.
    ``remat`` recomputes each stacked layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` of the scanned body: a layer's kernels (flash
    attention, or chunk_state and chunk_scan) then launch twice a training
    step; a hybrid layer recomputes both halves.  ``residual_constraint``
    and ``unroll`` are the reference's sharding hint and scan unroll factor,
    accepted and ignored (one device, a Python loop)."""
    require_full_forward(cfg)
    del residual_constraint, unroll
    x = L.embed(params["embed"], tokens).to(L.dtype_of(cfg))
    if prefix_embeds is not None:
        x = torch.cat([prefix_embeds.to(x.dtype), x], dim=1)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
    windows = layer_windows(cfg)
    rf = rope_fraction(cfg)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_prefix = len(params["prefix_layers"])
    for i, p in enumerate(training_blocks(params)):
        if remat and i >= n_prefix:
            x, aux = checkpoint(_block_full, p, x, cfg, positions, windows[i],
                                rf, use_reentrant=False)
        else:
            x, aux = _block_full(p, x, cfg, positions, windows[i], rf)
        aux_total = aux_total + aux
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps), aux_total


def _logits_of(params, cfg: ModelConfig, x):
    return _soft_cap(cfg, L.unembed(params["embed"], x, cfg))


def forward(params, cfg: ModelConfig, tokens, prefix_embeds=None,
            remat: bool = False, residual_constraint=None, unroll: int = 1):
    """Returns (logits (B, S_total, V) fp32, aux_loss) (lm.py:209)."""
    x, aux = hidden_forward(params, cfg, tokens, prefix_embeds, remat,
                            residual_constraint, unroll)
    return _logits_of(params, cfg, x), aux


def _ce(params, cfg: ModelConfig, x, labels):
    """Summed next-token NLL over the labels >= 0, and their count."""
    logp = torch.log_softmax(_logits_of(params, cfg, x), dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum().float()


def loss_fn(params, cfg: ModelConfig, tokens, labels, prefix_embeds=None,
            remat: bool = False, residual_constraint=None,
            logits_chunk: int = 0, unroll: int = 1):
    """Causal LM loss; labels < 0 are masked out (lm.py:226).  Returns
    ``(ce + aux, {"ce", "aux"})``.

    ``logits_chunk`` > 0 (dividing the sequence) streams the unembedding and
    log-softmax over sequence chunks, each recomputed in the backward pass,
    so the live logits are (B, chunk, V) instead of (B, S, V)."""
    x, aux = hidden_forward(params, cfg, tokens, prefix_embeds, remat,
                            residual_constraint, unroll)
    if prefix_embeds is not None:
        x = x[:, prefix_embeds.shape[1]:]
    s = x.shape[1]
    if logits_chunk and s % logits_chunk == 0 and s > logits_chunk:
        nll = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, logits_chunk):
            n_i, c_i = checkpoint(_ce, params, cfg, x[:, i:i + logits_chunk],
                                  labels[:, i:i + logits_chunk],
                                  use_reentrant=False)
            nll, cnt = nll + n_i, cnt + c_i
    else:
        nll, cnt = _ce(params, cfg, x, labels)
    ce = nll / torch.clamp(cnt, min=1)
    return ce + aux, {"ce": ce, "aux": aux}
