"""AdamW with fp32 master weights: the port of ``repro.optim.adamw``.

Model parameters stay in the compute dtype (bf16 at full width); the
optimizer state holds fp32 master copies plus the Adam moments.  Gradients
arrive in the parameters' dtype and are upcast here; the update accumulates
into the fp32 masters and the parameters are copied back in their own dtype.

The reference donated its train state and returned new trees; here the
update writes the masters, moments and parameters **in place** (under
``torch.no_grad()``), so a full-width step holds one copy of the state.  The
scalars (step, learning rate, grad norm, clip scale) stay on the device: an
update never waits for the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 200
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree of dicts and lists, in the reference's leaf
    order (dict keys sorted, list items in order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def tree_map(fn, tree):
    """``fn`` applied to every tensor of a tree of dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def lr_schedule(cfg: AdamWConfig, step):
    """Linear warmup to ``peak_lr``, then cosine decay to ``min_lr_ratio`` of
    it (adamw.py:35), in fp32; ``step`` a tensor (result on its device) or
    a number."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.total_steps - cfg.warmup_steps, 1)
    frac = torch.clamp((step - cfg.warmup_steps) / decay_steps, 0.0, 1.0)
    cosine = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.peak_lr * torch.where(step < cfg.warmup_steps, warm, cosine)


def init_opt_state(params) -> Dict[str, Any]:
    """fp32 masters (always fresh copies: an fp32 parameter never aliases
    its master, adamw.py:47-49), zero moments and a device int32 step."""
    first = leaves(params)[0]
    return {
        "master": tree_map(lambda p: p.detach().float().clone(), params),
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
    }


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in fp32."""
    total = None
    for x in leaves(tree):
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
@torch.profiler.record_function("adamw_update")
def adamw_update(params, grads, opt_state: Dict[str, Any],
                 cfg: AdamWConfig) -> Tuple[Any, Dict[str, Any], Dict]:
    """One AdamW step (adamw.py:61), in place.  Returns ``(params,
    opt_state, {"lr", "grad_norm"})``: the same trees, updated (a profile
    sees it as the range ``adamw_update``)."""
    step = opt_state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    scale = (torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
             if cfg.grad_clip else 1.0)
    stepf = step.float()
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    for p, g, m, v, w in zip(leaves(params), leaves(grads),
                             leaves(opt_state["m"]), leaves(opt_state["v"]),
                             leaves(opt_state["master"])):
        g = g.float() * scale
        m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
        upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * w
        w.sub_(lr * upd)
        p.copy_(w)
    opt_state["step"] = step
    return params, opt_state, {"lr": lr, "grad_norm": gnorm}
