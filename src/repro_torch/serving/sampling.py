"""Token sampling, batched: greedy, temperature, top-k and top-p (the port of
``repro.serving.sampling``), and the speculative verify's accept rule.

:func:`sample` is the logits -> tokens transform; :func:`sample_step` also
owns the PRNG key carry (``serving.prng``: the reference's threefry key
stream, bit for bit), so sampling runs on the device and only the sampled
token ids cross to the host.  Greedy never splits the key.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import prng


def guarded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax that never returns garbage on poisoned rows: NaNs count as
    ``-inf`` and an all-``-inf`` row deterministically yields id 0 (the
    first maximum, as ``jnp.argmax``), always a valid vocab index."""
    clean = torch.where(torch.isnan(logits),
                        torch.full_like(logits, float("-inf")), logits)
    return clean.argmax(dim=-1).to(torch.int32)


def sample(
    logits: torch.Tensor,  # (B, V) f32
    key: Optional[torch.Tensor],
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> torch.Tensor:
    """Tokens (B,) int32 (sampling.py:27): greedy at ``temperature <= 0``;
    else a categorical draw under ``key`` from ``logits / temperature``,
    cut to the ``top_k`` largest (``top_k`` >= V keeps them all) and to the
    smallest head of the sorted distribution whose mass reaches ``top_p``
    (its index clamped at V - 1).  A row left with no finite logit (fully
    masked, or NaN / Inf upstream) takes ``guarded_argmax`` of its raw
    logits, always a valid vocab index."""
    if temperature <= 0.0:
        return guarded_argmax(logits)
    cut = cut_logits(logits, temperature, top_k, top_p)
    tok = prng.categorical(key, cut).to(torch.int32)
    bad = ~torch.isfinite(cut).any(dim=-1)
    return torch.where(bad, guarded_argmax(logits), tok)


def cut_logits(logits: torch.Tensor, temperature: float,
               top_k: Optional[int] = None,
               top_p: Optional[float] = None) -> torch.Tensor:
    """The logits :func:`sample` draws from: scaled by ``1 / temperature``,
    with ``-inf`` outside the top-k and the top-p head."""
    logits = logits / temperature
    vocab = logits.shape[-1]
    if top_k is not None:
        k = min(int(top_k), vocab)
        kth = torch.sort(logits, dim=-1).values[:, -k][:, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_logits, dim=-1), dim=-1)
        cutoff_idx = torch.clamp((cum < top_p).sum(dim=-1), max=vocab - 1)
        cutoff = torch.gather(sorted_logits, -1, cutoff_idx[:, None])
        logits = logits.masked_fill(logits < cutoff, float("-inf"))
    return logits


def sample_step(
    logits: torch.Tensor,  # (B, V) f32
    key: Optional[torch.Tensor],
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(tokens, new_key)`` (sampling.py:64): the key is split once, the
    first half carried and the second drawn from.  Greedy at ``temperature
    <= 0``: no split, the key passes through untouched.  ``gate`` (a ()
    bool tensor, the multi-step loop's any-slot-live flag) leaves the key
    unadvanced where False, with no host sync."""
    if temperature <= 0.0:
        return guarded_argmax(logits), key
    new_key, sub = prng.split(key)
    if gate is not None:
        new_key = torch.where(gate, new_key, key)
    tok = sample(logits, sub, temperature=temperature, top_k=top_k, top_p=top_p)
    return tok, new_key


def spec_accept(drafts: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The leading-accept mask (B, K + 1) of a verify round (sampling.py:98):
    position 0 (the model's token after the committed feed) always, and
    draft i extends the run while it matched the model's own target at the
    same position; the first mismatch rejects everything after it."""
    acc = (drafts == targets[:, :-1]).to(torch.int32)
    run = torch.cumprod(acc, dim=1).bool()
    ones = torch.ones((drafts.shape[0], 1), dtype=torch.bool, device=drafts.device)
    return torch.cat([ones, run], dim=1)


def spec_sample_step(
    logits: torch.Tensor,  # (B, C, V) f32: a row per verify-chunk position
    key: Optional[torch.Tensor],
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
    gate: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A target token for each verify-chunk position, ``(targets (B, C),
    new_key)`` (sampling.py:124).  A round always splits the key into C + 1
    (the carry, then one a position), whatever the acceptance, so a slot's
    stream depends on the round index alone; ``gate`` False leaves the key
    unadvanced.  Greedy: no split."""
    if temperature <= 0.0:
        return guarded_argmax(logits), key
    c = logits.shape[1]
    keys = prng.split(key, c + 1)
    new_key = keys[0]
    if gate is not None:
        new_key = torch.where(gate, new_key, key)
    cols = [sample(logits[:, i], keys[i + 1], temperature=temperature,
                   top_k=top_k, top_p=top_p) for i in range(c)]
    return torch.stack(cols, dim=1), new_key
