"""Parameter bridge: the reference's parameter tree, as numpy, into the port.

    params = params_from_numpy(jax.tree.map(np.asarray, repro_lm.init(cfg, key)),
                               cfg, device="cpu")

The tree keeps its layout (``embed``, ``prefix_layers``, stacked ``layers``
leaves of shape (L, ...), ``final_norm``); each leaf becomes a tensor of the
config's dtype on ``device``.  bfloat16 leaves (``ml_dtypes``) are
reinterpreted bit for bit.  This module imports neither JAX nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .models import lm
from .models.layers import dtype_of


def _tensor(a, dtype, device):
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg, device="cuda"):
    """Convert a numpy parameter tree of ``repro.models.lm.init`` into the
    port's parameters for ``cfg`` on ``device``."""
    lm.require_supported(cfg)
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    if tree.get("prefix_layers"):
        raise ValueError("dense models carry no prefix layers")

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, dt, dev)

    params = conv(tree)
    n = params["layers"]["norm1"].shape[0]
    if n != cfg.num_layers:
        raise ValueError(f"tree has {n} stacked layers, config {cfg.num_layers}")
    return params
