"""Training entry point of the port: AdamW on the full-sequence loss, with
checkpoint/restart and injected failures, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2_1_5b \
        --reduced --steps 20 --failure-prob 0.1
    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2_2_7b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch hymba_1_5b \
        --reduced --device cpu --steps 20
    PYTHONPATH=src python -m repro_torch.launch.train --arch whisper_tiny \
        --reduced --device cpu --steps 20

The flags are ``repro.launch.train``'s, plus ``--device``; the per-step
line and the ``done:`` line are the reference's, followed by the kernel
launch counts of the run.  An encoder-decoder model trains through
``encdec.loss_fn`` on zero ``frames`` (B, frontend_seq, d_model), a model
with a frontend through ``lm.loss_fn`` on zero ``prefix_embeds`` of that
shape, as the reference feeds them (repro/launch/train.py:111-120).  One
device only: ``--mesh`` other than ``debug`` raises
``NotImplementedError`` (ROADMAP Queue 1 item 17).  MLA + MoE
(``deepseek_v2_lite_16b``) trains through ``layers.mla_full``, its
attention on the flash kernel at key width 192 and value width 128 on a
card:

    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek_v2_lite_16b --reduced --device cpu --steps 20

The default ``--ckpt-dir`` lies under the temporary directory (``TMPDIR``).
"""
from __future__ import annotations

import argparse
import os
import tempfile
import time

import torch

from ..checkpoint import CheckpointManager
from ..configs import get_config
from ..core.device import resolve_device
from ..data import DataConfig, SyntheticTokens, make_loader
from ..distributed.fault import FaultConfig, run_with_recovery
from ..kernels.ops import KERNELS
from ..models import encdec, lm
from ..models.config import ModelConfig
from ..models.layers import DTYPES
from ..optim import AdamWConfig, adamw_update, init_opt_state
from ..optim.adamw import leaves


def make_train_step(cfg: ModelConfig, adamw: AdamWConfig,
                    logits_chunk: int = 0):
    """``train_step(state, batch) -> (state, metrics)``, the single-device
    part of ``cells.make_train_step`` (cells.py:296-326): the loss with
    per-layer recompute (``remat=True``), its gradient with respect to every
    parameter, and one AdamW update, which writes ``state`` in place.

    ``state`` is ``{"params", "opt"}``; ``batch`` holds ``tokens`` and
    ``labels`` (B, S) (numpy or tensors), and ``frames`` (B, T, d) for an
    encoder-decoder ``cfg`` (``encdec.loss_fn``) or optionally
    ``prefix_embeds`` (B, P, d) otherwise (``lm.loss_fn``).  ``metrics`` are
    device scalars ``loss``, the loss's parts (``ce``, and ``aux`` where the
    model has one: the encoder-decoder has none), ``lr`` and ``grad_norm``:
    nothing in a step waits for the host."""

    def train_step(state, batch):
        params = state["params"]
        flat = leaves(params)
        dev = flat[0].device
        for p in flat:
            p.requires_grad_(True)
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        if cfg.is_encoder_decoder:
            frames = torch.as_tensor(batch["frames"], device=dev)
            loss, parts = encdec.loss_fn(params, cfg, frames, tokens, labels,
                                         remat=True, logits_chunk=logits_chunk)
        else:
            prefix = batch.get("prefix_embeds")
            if prefix is not None:
                prefix = torch.as_tensor(prefix, device=dev)
            loss, parts = lm.loss_fn(params, cfg, tokens, labels,
                                     prefix_embeds=prefix, remat=True,
                                     logits_chunk=logits_chunk)
        grads = torch.autograd.grad(loss, flat)  # in the parameters' dtypes
        for p in flat:  # plain tensors again outside the step
            p.requires_grad_(False)
        params, opt, om = adamw_update(params, list(grads), state["opt"], adamw)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return {"params": params, "opt": opt}, metrics

    return train_step


def build_state(cfg: ModelConfig, seed: int, device) -> dict:
    mod = encdec if cfg.is_encoder_decoder else lm
    params = mod.init(cfg, seed, device=device)
    return {"params": params, "opt": init_opt_state(params)}


def frontend_inputs(cfg: ModelConfig, batch: int, device) -> dict:
    """What the stub frontend hands a step (repro/launch/train.py:111-120):
    zero ``frames`` for an encoder-decoder, zero ``prefix_embeds`` for a
    model with a frontend, each (batch, frontend_seq, d_model) in the
    model's dtype; nothing otherwise."""
    if cfg.is_encoder_decoder:
        name = "frames"
    elif cfg.frontend != "none":
        name = "prefix_embeds"
    else:
        return {}
    return {name: torch.zeros((batch, cfg.frontend_seq, cfg.d_model),
                              dtype=DTYPES[cfg.dtype], device=device)}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="use the smoke-scale config (CPU-friendly)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    ap.add_argument("--mesh", default="debug",
                    choices=["debug", "single_pod", "multi_pod"])
    ap.add_argument("--ckpt-dir",
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-interval", type=int, default=25)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--failure-prob", type=float, default=0.0,
                    help="per-step injected failure probability (FT demo)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def main(argv=None):
    args = parser().parse_args(argv)
    if args.mesh != "debug":
        raise NotImplementedError(
            f"--mesh {args.mesh}: meshes over many devices are not ported "
            "yet: ROADMAP Queue 1 item 17 (distributed)")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if not cfg.is_encoder_decoder:
        lm.require_full_forward(cfg)
    device = resolve_device(args.device)

    adamw = AdamWConfig(peak_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                        total_steps=args.steps)
    state = build_state(cfg, args.seed, device)
    step_fn = make_train_step(cfg, adamw, logits_chunk=0)
    data_cfg = DataConfig(batch=args.batch, seq=args.seq,
                          vocab_size=cfg.vocab_size, seed=args.seed)
    dataset = SyntheticTokens(data_cfg)

    def loader_factory(start):
        return make_loader(dataset, start)

    ckpt = CheckpointManager(args.ckpt_dir, interval=args.ckpt_interval)
    fault = FaultConfig(failure_prob=args.failure_prob, seed=args.seed)
    losses = []

    stub = frontend_inputs(cfg, args.batch, device)

    def logged_step(state, batch):
        t0 = time.time()
        state, metrics = step_fn(state, {**batch, **stub})
        losses.append(float(metrics["loss"]))
        n = len(losses)
        if n % args.log_every == 0:
            dt = time.time() - t0
            print(
                f"step {n:5d}  loss {losses[-1]:.4f}  "
                f"lr {float(metrics['lr']):.2e}  "
                f"gnorm {float(metrics['grad_norm']):.3f}  {dt*1e3:.0f} ms"
            )
        return state, metrics

    for k in KERNELS.values():
        k.launches = 0
    result = run_with_recovery(logged_step, state, loader_factory, args.steps,
                               ckpt, fault=fault)
    ckpt.wait()
    print(
        f"done: {result['steps']} steps, {result['restarts']} restarts, "
        f"final loss {float(result['last_metrics']['loss']):.4f}"
    )
    launched = ", ".join(f"{name}={k.launches}" for name, k in KERNELS.items()
                         if k.launches)
    print(f"kernel launches on {device.type}: {launched or 'none'}")
    return result


if __name__ == "__main__":
    main()
