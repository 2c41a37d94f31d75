"""The reference's PRNG, threefry2x32, in torch integer ops: keys, ``split``,
random bits, ``uniform``, the "low" gumbel and ``categorical``, bit for bit
as jax computes them with ``jax_threefry_partitionable`` on (its default
since jax 0.5, and so under the reference's jax 0.9):

* a key is two 32-bit words, ``key(seed) == [0, seed mod 2**32]``
  (``jax.random.PRNGKey`` with 64-bit types off);
* ``split(key, n)`` hashes the counters ``(0, i)`` for i < n under the key
  (jax/_src/prng.py ``_threefry_split_foldlike``): key i is the hash's two
  words;
* ``random_bits(key, shape)`` hashes the counters ``(i >> 32, i & mask)``
  of the flat index i of each element and returns the two words' XOR
  (``_threefry_random_bits_partitionable``);
* ``uniform`` keeps the bits' top 23 as an fp32 mantissa in [1, 2), minus
  1, then scales to [minval, maxval) and clamps at minval
  (jax/_src/random.py ``_uniform``); ``gumbel`` is ``-log(-log(u))`` with u
  uniform in [tiny, 1) (``_gumbel``, mode "low"); ``categorical`` is the
  argmax of logits plus gumbel noise of the logits' shape.

torch's ``uint32`` lacks most arithmetic, so the 32-bit words live in
``int64`` tensors and are masked after every add, shift and rotate.
Everything runs on the key's device with no host sync, so a key can be a
device-resident carry.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
TINY = torch.finfo(torch.float32).tiny


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``: the words ``[0, seed mod 2**32]``, an
    int64 tensor of shape (2,)."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64, device=device)


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) & MASK) | (x >> (32 - d))


def threefry2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash of the counter words ``(x1, x2)`` under the
    key words ``(k1, k2)``, 20 rounds (jax/_src/prng.py
    ``_threefry2x32_lowering``).  Words are int64 tensors holding uint32
    values; returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ _PARITY)
    a = (x1 + ks[0]) & MASK
    b = (x2 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            a = (a + b) & MASK
            b = _rotl(b, r) ^ a
        a = (a + ks[(i + 1) % 3]) & MASK
        b = (b + ks[(i + 2) % 3] + (i + 1)) & MASK
    return a, b


def _counters(n: int, device):
    """The flat indices 0..n-1 as (high word, low word)."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return i >> 32, i & MASK


def split(k: torch.Tensor, n: int = 2) -> torch.Tensor:
    """``jax.random.split(k, n)``: (n, 2) keys."""
    hi, lo = _counters(n, k.device)
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return torch.stack([a, b], dim=-1)


def random_bits(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits an element of ``shape`` (int64 holding uint32)."""
    hi, lo = _counters(math.prod(shape), k.device)
    a, b = threefry2x32(k[0], k[1], hi, lo)
    return (a ^ b).reshape(tuple(shape))


def uniform(k: torch.Tensor, shape: Sequence[int], minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(k, shape, float32, minval, maxval)``.  The bounds
    and their difference are fp32 values, as jax rounds them, applied as
    scalars (no host-to-device copy)."""
    bits = (random_bits(k, shape) >> 9) | 0x3F800000  # mantissa under exponent 0
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    lo = np.float32(minval)
    span = float(np.float32(maxval) - lo)
    return torch.clamp_min(floats * span + float(lo), float(lo))


def gumbel(k: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.gumbel(k, shape, float32)`` in its default "low" mode."""
    return -torch.log(-torch.log(uniform(k, shape, TINY, 1.0)))


def categorical(k: torch.Tensor, logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical(k, logits, axis=-1)`` for fp32 logits: the
    argmax of logits plus gumbel noise drawn over the logits' whole shape
    (int64 indices)."""
    return (gumbel(k, logits.shape) + logits).argmax(dim=-1)
