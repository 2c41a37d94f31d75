"""Parameter bridge: the reference's parameter tree, as numpy, into the port,
and the port's trees back to numpy.

    params = params_from_numpy(jax.tree.map(np.asarray, repro_lm.init(cfg, key)),
                               cfg, device="cpu")  # or repro_encdec.init
    arrays = tree_to_numpy({"params": params, "opt": opt_state})

The tree keeps its layout (``embed``, the ``prefix_layers`` list, stacked
``layers`` leaves of shape (L - prefix, ...), ``final_norm``; an
encoder-decoder's ``enc_layers`` and ``dec_layers`` stacked); each leaf
becomes a tensor on ``device`` of the dtype ``layers.leaf_dtype`` gives it,
the rule the port's own ``init`` follows: the config's dtype, except the
leaves the reference keeps in fp32 whatever the model's dtype
(``layers.FP32_LEAVES``: the MoE router, layers.py:753, and the SSM's
a_log, d_skip and dt_bias, layers.py:865-867).  bfloat16 leaves
(``ml_dtypes``) are reinterpreted bit for bit.  This module imports neither
JAX nor ``repro``.
"""
from __future__ import annotations

import numpy as np
import torch

from .core.device import resolve_device
from .models import lm
from .models.layers import leaf_dtype


def _tensor(a, dtype, device):
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device=device, dtype=dtype)


def params_from_numpy(tree, cfg, device="cuda"):
    """Convert a numpy parameter tree of ``repro.models.lm.init`` (or, for an
    encoder-decoder ``cfg``, of ``repro.models.encdec.init``) into the
    port's parameters for ``cfg`` on ``device``."""
    dev = resolve_device(device)

    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _tensor(node, leaf_dtype(key, cfg), dev)

    if cfg.is_encoder_decoder:
        params = conv(tree)
        got = (params["enc_layers"]["norm1"].shape[0],
               params["dec_layers"]["norm1"].shape[0])
        if got != (cfg.encoder_layers, cfg.num_layers):
            raise ValueError(f"tree has {got} encoder and decoder layers, config "
                             f"{(cfg.encoder_layers, cfg.num_layers)}")
        return params
    lm.require_supported(cfg)
    n_prefix = lm.num_prefix_layers(cfg)
    if len(tree.get("prefix_layers") or []) != n_prefix:
        raise ValueError(f"tree has {len(tree.get('prefix_layers') or [])} "
                         f"prefix layers, config {n_prefix}")
    params = conv(tree)
    n = params["layers"]["norm1"].shape[0]
    if n_prefix + n != cfg.num_layers:
        raise ValueError(f"tree has {n_prefix} + {n} layers, config "
                         f"{cfg.num_layers}")
    return params


def leaf_to_numpy(t: torch.Tensor):
    """One tensor on the host as ``(array, dtype name)``.  numpy has no
    bfloat16, so a bf16 tensor comes back as its raw 16-bit patterns
    (uint16) named ``"bfloat16"``; any other dtype as itself."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def bits_to_bfloat16(a: np.ndarray) -> torch.Tensor:
    """The bf16 tensor whose raw 16-bit patterns are ``a`` (any 2-byte
    dtype: uint16, or the reference's ``ml_dtypes.bfloat16``)."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
        torch.bfloat16)


def tree_to_numpy(tree):
    """The port's tree (dicts, lists, tensors) as numpy arrays in the same
    structure, on the host.  bf16 leaves widen to float32, which is exact;
    every other leaf keeps its dtype."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to_numpy(v) for v in tree]
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
