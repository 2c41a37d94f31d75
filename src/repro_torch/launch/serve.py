"""Serving entry point of the port: the continuous-batching engine over a reduced
or full-width model, on the card by default.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b \
        --requests 16 --max-new 32
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b \
        --reduced --device cpu

The flags are ``repro.launch.serve``'s, plus ``--device``; as in the
reference, the KV storage format (int8 / int4 pages) is a ``ServeConfig``
field with no flag.  ``--cache contiguous`` serves any decoder-only model
over per-slot strips (rings for windowed layers, latent strips for MLA) and
the SSM family over its per-slot recurrent state, with no pool, prefix cache
or guard; its attention is the plain version, as the reference's contiguous
layers.  The hybrid serves on the default paged cache (or on strips), its
prompts replayed a token a tick:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2_2_7b \
        --cache contiguous --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b \
        --cache contiguous --reduced --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba_1_5b \
        --reduced --device cpu

GQA + MoE (``granite_moe_3b_a800m``) serves as the dense family does, and
the frontend model (``internvl2_26b``) text only, with no prefix, as the
reference serves it.  An encoder-decoder model (``whisper_tiny``) is
refused with the reference's ``SystemExit``.

Sampling and speculative decoding are the reference's flags:
``--temperature 0.8 --seed 3`` samples under the reference's threefry key
stream (the same tokens as the JAX package on the same weights), and
``--spec-decode ngram --draft-len 4`` drafts 4 tokens a round from each
request's own history and verifies them in one chunk (with ``--sync-every
N``, up to N rounds a dispatch):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b \
        --reduced --device cpu --temperature 0.8 --seed 3 \
        --spec-decode ngram --draft-len 4 --sync-every 4

``--audit`` runs the invariant auditor after every tick (page conservation,
refcounts, radix reachability, slot hygiene; ``serving.faults``) and the
summary counts the clean audits:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2_1_5b \
        --reduced --device cpu --audit --num-blocks 6

The summary line is the reference's (with the window's and speculation's
counts: "k/n drafts accepted (rate)" counts the drafts verify accepted, not
the model's own token each round adds), followed by the kernel launch
counts of the run.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..configs import get_config
from ..core.device import resolve_device
from ..kernels.ops import KERNELS
from ..models import lm
from ..serving import ServeConfig, ServingEngine


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; without a GPU, cuda raises")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cache", choices=["paged", "contiguous"], default="paged",
                    help="KV layout (paged = block pool + block tables)")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="KV pool size in blocks; below slots*max_pages "
                         "oversubscribes memory and exercises preemption")
    ap.add_argument("--prefill", choices=["chunked", "replay"],
                    default="chunked",
                    help="prompt ingestion: chunked fast path (token-budget "
                         "scheduler) or one-token-per-tick replay")
    ap.add_argument("--prefill-chunk", type=int, default=16,
                    help="prompt tokens per chunk-wide forward pass")
    ap.add_argument("--token-budget", type=int, default=None,
                    help="per-tick token budget shared by the decode batch "
                         "and prefill chunks (default slots+prefill_chunk)")
    ap.add_argument("--sync-every", type=int, default=1,
                    help="decode ticks per host dispatch: N > 1 runs up to N "
                         "decode ticks on the device per dispatch once every "
                         "active request is generating")
    ap.add_argument("--spec-decode", choices=["ngram"], default=None,
                    help="speculative decoding: the draft proposer")
    ap.add_argument("--draft-len", type=int, default=4)
    ap.add_argument("--audit", action="store_true",
                    help="run the serving invariant auditor after every "
                         "tick (page conservation, refcounts, radix "
                         "reachability, slot hygiene); raises AuditError "
                         "at the tick the books diverge")
    ap.add_argument("--guards", choices=["on", "off"], default="on",
                    help="block-table range + disjoint-write checks before "
                         "every paged dispatch")
    ap.add_argument("--deadline-ticks", type=int, default=None,
                    help="per-request deadline in engine ticks; expired "
                         "requests exit TIMED_OUT with partial output")
    return ap


def make_engine(args, device, params=None, **serve_kw):
    """The engine of ``args`` with its seeded requests submitted, and the
    parameters it serves (``params`` reuses an earlier engine's;
    ``serve_kw`` are further ServeConfig fields)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.is_encoder_decoder:  # as the reference (repro/launch/serve.py:80-81)
        raise SystemExit("enc-dec serving demo lives in examples/; use an LM arch")
    scfg = ServeConfig(slots=args.slots, max_len=args.max_len,
                       max_new_tokens=args.max_new,
                       temperature=args.temperature, seed=args.seed,
                       cache=args.cache, page_size=args.page_size,
                       num_blocks=args.num_blocks, prefill=args.prefill,
                       prefill_chunk=args.prefill_chunk,
                       token_budget=args.token_budget,
                       sync_every=args.sync_every,
                       spec_decode=args.spec_decode, draft_len=args.draft_len,
                       audit=args.audit, guards=args.guards == "on",
                       **serve_kw)
    if params is None:
        params = lm.init(cfg, args.seed, device=device)
    engine = ServingEngine(cfg, params, scfg, device=device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        prompt = rng.integers(0, cfg.vocab_size, size=args.prompt_len).tolist()
        engine.submit(prompt, deadline_ticks=args.deadline_ticks)
    return engine, params


def main(argv=None):
    args = parser().parse_args(argv)
    device = resolve_device(args.device)
    engine, _ = make_engine(args, device)

    for k in KERNELS.values():
        k.launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.time()
    done = engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    total_tokens = sum(len(r.output) for r in done)
    extra = (
        f", {engine.cache_mode} cache: peak {engine.peak_kv_blocks()} "
        f"blocks, {engine.preemptions} preemptions"
    )
    if engine.sync_every > 1:
        extra += (
            f", {engine.decode_windows} multi-step windows "
            f"({engine.window_fallbacks} fallbacks)"
        )
    if engine.spec_proposer is not None:  # serve.py:118-120
        rate = engine.spec_accepted / max(engine.spec_proposed, 1)
        extra += (
            f", {engine.spec_windows} spec windows: "
            f"{engine.spec_accepted}/{engine.spec_proposed} drafts accepted "
            f"({rate:.2f})"
        )
    ttfts = [r.ttft_ticks for r in done if r.ttft_ticks is not None]
    if ttfts:
        extra += f", mean TTFT {sum(ttfts)/len(ttfts):.1f} ticks"
    if args.audit:  # serve.py:127-128
        extra += f", {engine.audits_run} audits clean"
    not_completed = [r for r in done if r.status != "completed"]
    if not_completed:
        extra += f", {len(not_completed)} not completed (" + ", ".join(
            f"{r.uid}:{r.status}" for r in not_completed[:4]) + ")"
    print(
        f"served {len(done)} requests, {total_tokens} tokens in {dt:.2f}s "
        f"({total_tokens/max(dt,1e-9):.1f} tok/s, {engine.steps_run} engine steps"
        f" [{engine.prefill_mode} prefill]{extra})"
    )
    print("kernel launches on " + device.type + ": " + ", ".join(
        f"{name}={k.launches}" for name, k in KERNELS.items()))
    for r in done[:3]:
        print(f"  req {r.uid}: prompt {r.prompt[:4]}... -> {r.output[:8]}...")
    return done


if __name__ == "__main__":
    main()
