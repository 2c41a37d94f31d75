"""Encoder-decoder transformer (the whisper-tiny family): the port's
counterpart of ``repro.models.encdec`` (encdec.py:20-238).

The audio conv frontend is a stub, as in the reference: the encoder takes
precomputed frame embeddings (B, T_frames, d_model).  Learned absolute
positions (no RoPE), RMSNorm, GELU MLPs, a causal decoder with
cross-attention.  Parameters are a plain dict with the reference's tree:
``embed``, ``enc_pos``, ``dec_pos``, ``enc_final_norm``, ``final_norm``,
and ``enc_layers`` / ``dec_layers`` with every leaf stacked over the layers
in front; a Python loop over layers takes the place of ``jax.lax.scan``.

Attention follows the reference's routing exactly: the encoder's
self-attention (non-causal) and the teacher-forced decoder's (causal) go
through ``ops.attention``, the flash kernel on a card; cross-attention and
the KV-cache decode go through the plain ``ref.attention``, as the
reference's do (encdec.py:84, :106).  The decode cache is contiguous,
(L, B, Hkv, max_len, D), and :func:`decode_step` writes it **in place** at
``pos`` (the reference returned a new one).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.utils.checkpoint import checkpoint

from ..core.device import resolve_device
from ..kernels import ops, ref
from . import layers as L
from .config import ModelConfig
from .lm import stacked, unstacked

MAX_FRAMES = 1500  # whisper-tiny encoder positions (30 s of audio)


def require_encdec(cfg: ModelConfig):
    if not cfg.is_encoder_decoder:
        raise ValueError(f"{cfg.name} is not an encoder-decoder model: use models.lm")


def max_dec_positions(cfg: ModelConfig) -> int:
    """Rows of the decoder's position table (encdec.py:34-36): whisper's own
    decoder caps at 448, the reference sizes it for its 32k decode cells."""
    return 32768 if cfg.vocab_size > 10000 else 2048


def _attn_proj(params, x, heads, kv_heads, head_dim):
    b, s, _ = x.shape
    q = L.split_heads(x @ params["wq"], b, s, heads, head_dim)
    k = L.split_heads(x @ params["wk"], b, s, kv_heads, head_dim)
    v = L.split_heads(x @ params["wv"], b, s, kv_heads, head_dim)
    return q, k, v


def init(cfg: ModelConfig, key: Union[int, torch.Generator] = 0, *,
         device="cuda") -> Dict:
    """Random parameters in the shapes and distribution of ``encdec.init``
    (encdec.py:30): N(0, 1) token embeddings, N(0, 0.02^2) position tables,
    attention and MLP weights as ``layers.init_attention`` / ``init_mlp``,
    unit norms.  ``key`` is a seed or a ``torch.Generator`` on ``device``."""
    require_encdec(cfg)
    dev = resolve_device(device)
    if isinstance(key, torch.Generator):
        gen = key
        if gen.device.type != dev.type:
            raise ValueError(f"generator is on {gen.device}, device is {dev}")
    else:
        gen = torch.Generator(device=dev).manual_seed(int(key))
    d, dt = cfg.d_model, L.dtype_of(cfg)
    ones = lambda: torch.ones((d,), dtype=dt, device=dev)  # noqa: E731
    params: Dict[str, Any] = {
        "embed": {"embedding": L._dense_init(gen, (cfg.vocab_size, d), dt, 1.0)},
        "enc_pos": L._dense_init(gen, (MAX_FRAMES, d), dt, 0.02),
        "dec_pos": L._dense_init(gen, (max_dec_positions(cfg), d), dt, 0.02),
        "enc_final_norm": ones(),
        "final_norm": ones(),
    }
    params["enc_layers"] = stacked(lambda: {
        "norm1": ones(), "attn": L.init_attention(gen, cfg),
        "norm2": ones(), "mlp": L.init_mlp(gen, cfg)}, cfg.encoder_layers)
    params["dec_layers"] = stacked(lambda: {
        "norm1": ones(), "attn": L.init_attention(gen, cfg),
        "norm_x": ones(), "xattn": L.init_attention(gen, cfg),
        "norm2": ones(), "mlp": L.init_mlp(gen, cfg)}, cfg.num_layers)
    return params


def _self_attn(p, x, cfg: ModelConfig, causal: bool, cache=None, pos=None):
    """Self-attention (encdec.py:73).  With ``cache`` ({"k", "v"} (B, Hkv,
    max_len, D) of one layer): the step's K/V are written at ``pos`` in
    place and the queries attend positions 0..pos through the plain
    ``ref.attention``; strips that are DTensors (a one-token step on a
    mesh) take ``layers._decode_sharded``, each rank writing and scoring its
    own shards.  Without a cache, the sequence attends itself through
    ``ops.attention`` (the flash kernel on a card)."""
    b, s, _ = x.shape
    h, hkv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _attn_proj(p, x, h, hkv, hd)
    if isinstance(cache, dict) and isinstance(cache["k"], DTensor):
        # strips placed on a mesh: each rank writes and scores its own shards
        out = L._decode_sharded(q.transpose(1, 2), k[:, 0], v[:, 0], cache["k"],
                                cache["v"], pos.reshape(1).expand(b), None, None)
    elif cache is not None:
        at = pos.reshape(1).long() + torch.arange(s, device=x.device)
        cache["k"].index_copy_(2, at, k.transpose(1, 2).to(cache["k"].dtype))
        cache["v"].index_copy_(2, at, v.transpose(1, 2).to(cache["v"].dtype))
        out = ref.attention(q.transpose(1, 2), cache["k"], cache["v"], causal=False,
                            kv_len=(pos + 1).to(torch.int32).expand(b))
    else:
        out = ops.attention(L._hint("attn_q", q.transpose(1, 2)),
                            L._hint("attn_kv", k.transpose(1, 2)),
                            L._hint("attn_kv", v.transpose(1, 2)), causal=causal)
        out = L._hint("attn_q", out)
    out = L._hint("attn_out", L.merge_heads(out, b, s))
    return out.to(x.dtype) @ p["wo"]


def _cross_attn(p, x, enc_kv, cfg: ModelConfig):
    """Cross-attention over the precomputed (k, v), each (B, Hkv, T, D),
    through the plain ``ref.attention`` (encdec.py:101)."""
    b, s, _ = x.shape
    h, hd = cfg.num_heads, cfg.head_dim
    q = L.split_heads(x @ p["wq"], b, s, h, hd)
    out = ref.attention(L._hint("attn_q", q.transpose(1, 2)), L._hint("attn_kv", enc_kv[0]),
                        L._hint("attn_kv", enc_kv[1]), causal=False)
    out = L._hint("attn_q", out)
    out = L._hint("attn_out", L.merge_heads(out, b, s))
    return out.to(x.dtype) @ p["wo"]


def encode(params, cfg: ModelConfig, frames, unroll: int = 1):
    """``frames`` (B, T, d_model) precomputed embeddings (the conv frontend
    stub) -> the encoder's output (B, T, d_model) (encdec.py:112).
    ``unroll`` is the reference's scan unroll factor, accepted and ignored."""
    del unroll
    t = frames.shape[1]
    x = frames.to(L.dtype_of(cfg)) + params["enc_pos"][None, :t]
    for p in unstacked(params["enc_layers"]):
        h = L._hint("attn_in", L.rmsnorm(x, p["norm1"], cfg.norm_eps))
        x = x + L._hint("block_out", _self_attn(p["attn"], h, cfg, causal=False))
        h2 = L._hint("block_in", L.rmsnorm(x, p["norm2"], cfg.norm_eps))
        x = x + L._hint("block_out", L.mlp(p["mlp"], h2, cfg))
    return L.rmsnorm(x, params["enc_final_norm"], cfg.norm_eps)


def cross_kv(params, cfg: ModelConfig, enc_out) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every decoder layer's cross K/V from the encoder output (encdec.py:
    128): ``(k, v)``, each (L, B, Hkv, T, D)."""
    b, t, _ = enc_out.shape
    ks, vs = [], []
    for p in unstacked(params["dec_layers"]):
        ks.append(L.split_heads(enc_out @ p["xattn"]["wk"], b, t, cfg.num_kv_heads,
                                cfg.head_dim).transpose(1, 2))
        vs.append(L.split_heads(enc_out @ p["xattn"]["wv"], b, t, cfg.num_kv_heads,
                                cfg.head_dim).transpose(1, 2))
    return torch.stack(ks), torch.stack(vs)


def _dec_layer(p, x, ck, cv, cfg: ModelConfig):
    h = L._hint("attn_in", L.rmsnorm(x, p["norm1"], cfg.norm_eps))
    x = x + L._hint("block_out", _self_attn(p["attn"], h, cfg, causal=True))
    hx = L._hint("attn_in", L.rmsnorm(x, p["norm_x"], cfg.norm_eps))
    x = x + L._hint("block_out", _cross_attn(p["xattn"], hx, (ck, cv), cfg))
    h2 = L._hint("block_in", L.rmsnorm(x, p["norm2"], cfg.norm_eps))
    return x + L._hint("block_out", L.mlp(p["mlp"], h2, cfg))


def decode_hidden(params, cfg: ModelConfig, tokens, enc_out, unroll: int = 1,
                  remat: bool = False):
    """Teacher-forced decoder pass -> final hidden (B, S, d) (encdec.py:
    145).  ``remat`` recomputes each decoder layer in the backward pass
    (``torch.utils.checkpoint``, non-reentrant), as the reference's
    ``jax.checkpoint`` of its scanned body; the encoder is not recomputed,
    as in the reference."""
    del unroll
    s = tokens.shape[1]
    x = L.embed(params["embed"], tokens).to(L.dtype_of(cfg)) + params["dec_pos"][None, :s]
    ck, cv = cross_kv(params, cfg, enc_out)
    for i, p in enumerate(unstacked(params["dec_layers"])):
        if remat:
            x = checkpoint(_dec_layer, p, x, ck[i], cv[i], cfg, use_reentrant=False)
        else:
            x = _dec_layer(p, x, ck[i], cv[i], cfg)
    return L.rmsnorm(x, params["final_norm"], cfg.norm_eps)


def decode_full(params, cfg: ModelConfig, tokens, enc_out, unroll: int = 1):
    """Teacher-forced decoder pass -> logits (B, S, V) fp32 (encdec.py:167)."""
    return L.unembed(params["embed"], decode_hidden(params, cfg, tokens, enc_out,
                                                    unroll), cfg)


def _ce(params, cfg: ModelConfig, x, labels):
    """Summed next-token NLL over the labels >= 0, and their count."""
    logp = torch.log_softmax(L.unembed(params["embed"], x, cfg), dim=-1)
    mask = labels >= 0
    safe = torch.where(mask, labels, 0).long()
    nll = -torch.gather(logp, -1, safe[..., None])[..., 0]
    return (nll * mask).sum(), mask.sum().float()


def loss_fn(params, cfg: ModelConfig, frames, tokens, labels, unroll: int = 1,
            remat: bool = False, logits_chunk: int = 0):
    """Decoder cross-entropy over ``labels`` >= 0 (encdec.py:172).  Returns
    ``(ce, {"ce": ce})``: the reference's model has no auxiliary loss.

    ``logits_chunk`` > 0 (dividing the sequence, and below it) streams the
    unembedding and log-softmax over sequence chunks, each recomputed in the
    backward pass."""
    enc = encode(params, cfg, frames, unroll)
    x = decode_hidden(params, cfg, tokens, enc, unroll, remat)
    s = x.shape[1]
    if logits_chunk and s % logits_chunk == 0 and s > logits_chunk:
        nll = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(0, s, logits_chunk):
            n_i, c_i = checkpoint(_ce, params, cfg, x[:, i:i + logits_chunk],
                                  labels[:, i:i + logits_chunk], use_reentrant=False)
            nll, cnt = nll + n_i, cnt + c_i
    else:
        nll, cnt = _ce(params, cfg, x, labels)
    ce = nll / torch.clamp(cnt, min=1)
    return ce, {"ce": ce}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *, device="cuda"):
    """The decoder's self-attention caches, stacked over its layers
    (encdec.py:206): ``{"self": {"k", "v"}}``, each (L, B, Hkv, max_len, D)
    in the model's dtype.  Cross K/V come from :func:`cross_kv`."""
    require_encdec(cfg)
    dev = resolve_device(device)
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return {"self": {name: torch.zeros(shape, dtype=L.dtype_of(cfg), device=dev)
                     for name in ("k", "v")}}


def _layer_of(t, i: int):
    """Layer ``i`` of a stacked cache leaf, a view.  A DTensor (its layer
    axis whole) is sliced on each rank's shard: DTensor's own select runs
    its propagation on the whole stack, which the dry run's memory tracker
    counts as a step's allocation."""
    if not isinstance(t, DTensor):
        return t[i]
    local = t.to_local()[i]
    placements = [Shard(p.dim - 1) if isinstance(p, Shard) else p for p in t.placements]
    return DTensor.from_local(local, t.device_mesh, placements, run_check=False,
                              shape=t.shape[1:], stride=t.stride()[1:])


def decode_step(params, cfg: ModelConfig, cache, token, pos, cross, unroll: int = 1):
    """One decode step (encdec.py:216): ``token`` (B,) at position ``pos``
    (an int or a 0-d tensor, the same for every row) over ``cross`` =
    :func:`cross_kv`'s (k, v).  Returns ``(logits (B, V) fp32, cache)``, the
    cache written in place."""
    del unroll
    pos = torch.as_tensor(pos, device=token.device).reshape(())
    x = L.embed(params["embed"], token[:, None]).to(L.dtype_of(cfg))
    x = x + params["dec_pos"].index_select(0, pos.reshape(1).long())[None]
    ck, cv = cross
    for i, p in enumerate(unstacked(params["dec_layers"])):
        kv = {name: _layer_of(cache["self"][name], i) for name in ("k", "v")}
        h = L.rmsnorm(x, p["norm1"], cfg.norm_eps)
        x = x + _self_attn(p["attn"], h, cfg, causal=False, cache=kv, pos=pos)
        hx = L.rmsnorm(x, p["norm_x"], cfg.norm_eps)
        x = x + _cross_attn(p["xattn"], hx, (ck[i], cv[i]), cfg)
        h2 = L.rmsnorm(x, p["norm2"], cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h2, cfg)
    x = L.rmsnorm(x, params["final_norm"], cfg.norm_eps)
    return L.unembed(params["embed"], x, cfg)[:, 0], cache
