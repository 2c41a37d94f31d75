"""Token sampling, greedy branch (the port of ``repro.serving.sampling``).

:func:`guarded_argmax` and the greedy branch of :func:`sample_step` run on
the device; only the sampled token ids cross to the host.  Temperature
sampling raises: matching the reference's key stream (a JAX threefry
carry) is ROADMAP Queue 1 item 5.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch


def guarded_argmax(logits: torch.Tensor) -> torch.Tensor:
    """argmax that never returns garbage on poisoned rows: NaNs count as
    ``-inf`` and an all-``-inf`` row deterministically yields id 0 (the
    first maximum, as ``jnp.argmax``), always a valid vocab index."""
    clean = torch.where(torch.isnan(logits),
                        torch.full_like(logits, float("-inf")), logits)
    return clean.argmax(dim=-1).to(torch.int32)


def sample_step(
    logits: torch.Tensor,  # (B, V) f32
    generator: Optional[torch.Generator] = None,
    temperature: float = 0.0,
    top_k: Optional[int] = None,
    top_p: Optional[float] = None,
) -> Tuple[torch.Tensor, Optional[torch.Generator]]:
    """``(tokens, generator)``.  Greedy at ``temperature <= 0``: the
    generator passes through untouched."""
    if temperature > 0.0:
        raise NotImplementedError(
            "temperature sampling is not ported yet (ROADMAP Queue 1 item 5: "
            "the reference's threefry key stream)")
    return guarded_argmax(logits), generator
