"""Device selection for the port's entry points.

Entry points (``lm.init``, ``ServingEngine``, ``launch/serve.py``) run on the
card by default.  Without a GPU they raise unless the caller asked for the
CPU explicitly: a run never drops to the CPU on its own.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev
