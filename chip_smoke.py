#!/usr/bin/env python3
"""Chip smoke of the PyTorch / H100 port: the quickest proof that the port
builds, runs its kernels and serves on the card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository's ``src/repro_torch``.  It
imports neither JAX nor the JAX package.  Phases (any failure exits non-zero;
no phase is skipped):

1. build the fourteen CUDA kernels (fp and quantized decode, fp and
   quantized chunked prefill, each for GQA and for multi-head latent
   attention, the contiguous flash-attention forward of training, the
   Mamba-2 SSD's chunk_state and chunk_scan, and the kernel library's GEMM,
   weight-only dequantized GEMM and contiguous FlashMLA) from the nine
   sources in ``src/repro_torch/kernels/csrc`` with nvcc (sm_90a, one
   process per source, in parallel) and print the card's name and power
   limit;
2. hold each kernel against its plain PyTorch version on the card, at the
   full-width shapes of its path (qwen2-1.5B: Hq 12, Hkv 2, D 128;
   deepseek-v2-lite-16B: 16 heads over a 512-wide latent plus a 64-wide rope
   part, scaled by 1 / sqrt(192); page 16, slots 8, chunk 64, max_len 1024;
   bf16 plus an fp32 pass; the quantized kernels in int8 and int4),
   including a len-0 slot, a sliding window and a partial chunk (bf16 limit
   in ulps of the plain value, checked against three controls: an
   fp32-accumulating online softmax must pass it, one accumulating in bf16
   and one rounding P once to bf16 must fail it); the split decodes' merge
   without the rescale to the common max must fail it too (fp32 and bf16:
   the GQA decode and its quantized twin, the MLA decode and its quantized
   twin), and their grids (splits of 64 keys from static shapes) are
   printed; every bf16 launch of the flash, fp and quantized GQA
   chunked-prefill and decode kernels, and of the MLA decode, the MLA
   chunked prefill and their quantized twins, must take their tensor-core
   path (``KERNEL.tc_launches``); the
   tensor-core prefills' device cost of a key tile is read from two walks
   (the quantized GQA prefill's in int8), the split decodes' split and
   merge kernels' device us a call (the GQA decode in bf16 and its twin in
   int8; the MLA decode in bf16 and int8) from torch.profiler, and the
   tensor-core chunk_scan's
   cost a head of a block's walk from launches of 80 and 40 heads; time
   kernel, plain version and, as a
   yardstick only, ``scaled_dot_product_attention`` over the gathered (for
   the quantized kernels: gathered and dequantized) pages.  The flash
   kernel is held at qwen2-1.5B's training shapes (batch 8 x seq 1024,
   causal, on the strided views the forward hands it), on a suffix block of
   256 queries over 1024 keys (causal and not), a ragged length (1000) and
   head dim 64, and timed beside SDPA, forward and forward + backward.
   chunk_state and chunk_scan are held on SSD_CASES: the operands of a
   seeded full-width mamba2-2.7B layer at its training shapes (batch 8 x
   seq 1024: deep decay, exp(dA) denormal), the same shapes with shallow
   decay, a chunk of 64, bf16 and fp32 (fp32 within 1e-4 of max(1, max
   |plain|), bf16 within 2 ulps, the scan's
   control with its decayed scores rounded once to bf16 outside them, and
   chunk_state's control with its decayed X rounded once to bf16 outside
   its limit wherever it takes the tensor cores); a growing-dA case's scan
   is gated in fp32 and printed in bf16; every bf16 chunk_state and
   chunk_scan launch at mamba2's shapes must take its tensor-core path,
   fp32 its CUDA-core one; timed beside the bf16 cuBLAS products their
   work reduces to, as a yardstick.  At hymba-1.5B's shapes: the decode
   (8 slots of 2048 tokens, Hq 25 over Hkv 5, D 64: a group of 5) with its
   window of 1024, which drops whole splits, and without, bf16 and fp32,
   under the same limit and controls, every bf16 launch on the tensor
   cores, timed beside SDPA over the gathered pages; chunk_state and
   chunk_scan at its training shapes (batch 8 x seq 1024, 64 heads of P
   50, N 16), every launch on CUDA cores, timed.  At granite-moe-3b-a800m's
   serving shape (8 slots of 1024 tokens, Hq 24 over Hkv 8, D 64: a group
   of 3, the chunked prefill's page groups 48 rows) the decode, the
   chunked prefill and their int8 twins, bf16 and fp32, under the same
   limit and controls, every bf16 launch on the tensor cores, timed.  The
   flash kernel is also held, timed, at the training shapes of phases
   8-10: granite's (B 8, 24 over 8 heads, S 1024, D 64, causal), whisper's
   encoder (B 8, 6 heads, 1500 x 1500 frames, D 64, non-causal: a length
   no 64-row or 64-key tile divides) and decoder (448 causal), and
   internvl2's (B 4, 48 over 8 heads, 256 patch rows + 768 tokens, D 128,
   causal), and at phase 14's deepseek-v2-lite-16B training shape (B 8, 16
   over 16 heads, S 1024, keys 192 wide over values 128, causal: every bf16
   launch on the tensor cores, timed beside SDPA with the kernel SDPA ran
   named).  Then the kernel
   library, driven through ``kernels.ops`` at the paper's kernel
   experiments' full-width shapes (its path: the three kernels' launches are
   counted here): ``matmul`` at Table 2's M0-M7 and V0-V7 in bf16,
   ``dequant_matmul`` at Fig. 15's three shapes for W int8 / int4 / int2 /
   nf4 x A fp16 and W int2 / int4 x A int8 (float32 out), ``mla`` at Fig.
   14's three shapes (128 heads over one latent head, D 512, Dpe 64, bf16),
   plus an fp32 pass of each, the reference's ragged cases (odd K 48, two
   latent heads) and scale groups no K tile matches.  Limits: fp32 within
   FP32_ATOL of max(1, max |plain|); 16-bit GEMMs within 2 units of
   ``lib_units`` (ulps of the output type, at least 2^-12 sqrt(K) rms(a)
   rms(b)), which cuBLAS's product passes; 16-bit dequantized GEMMs within 2
   units more than their control (the plain version on the weight rounded
   to the activations' type, as the kernel multiplies it); MLA within 2
   bf16 ulps with the attention controls; planted faults (a K tile dropped,
   B's bytes read as a K-major matrix, each byte's code order swapped) must
   fail them; every Table 2 M shape must take the GEMM's wgmma path, and
   every bf16 Fig. 14 shape, two latent heads at a ragged length and
   deepseek-v2-lite-16B's 16 heads over one latent head at a ragged length
   FlashMLA's (``KERNEL.tc_launches``); FlashMLA's device cost of a 32-key
   tile is read from its two b64 shapes.  Each is timed (median
   and spread) beside its plain version and ``torch.matmul`` (GEMM), cuBLAS
   fp16 on a weight dequantized beforehand (the paper's Fig. 15 baseline, a
   yardstick) or SDPA with a latent head's heads as its query rows (MLA);
3. serve full-width qwen2-1.5B (bf16, seeded random weights; its serving
   depth cut to 4 of 28 layers to keep the script within half its time
   limit) through ``ServingEngine`` with its defaults (paged KV, chunked prefill,
   prefix cache, guards, greedy): 16 requests of 100-600 prompt tokens, half
   sharing a 256-token prefix, 32 new tokens each; then again with the pool
   at 39% of slots * max_pages (199 blocks), where this workload preempts
   (its scheduling depends only on prompt lengths); then with int8 and with
   int4 KV pages (ticks and TTFT equal to fp's), int8 with the pool at the
   bytes of fp's 199 pages (fewer preemptions than fp there), and int8 with
   the multi-step window ``sync_every=16`` (outputs byte-identical to per-tick
   int8, fewer host dispatches, and no host sync inside a window).  Each run
   resets the kernels' launch counts before it and reads them after; in the
   fp runs every launch of the decode and chunked-prefill kernels, in the
   four quantized runs every launch of the quantized decode and chunked
   prefill, must have taken their tensor-core paths;
4. teacher-forced logits at full width, depth cut to 4 layers: the card's
   bf16 kernel path against the plain path in fp32 on the CPU (error in
   standard deviations of the logits, top-10 and argmax agreement), for fp
   and int8 pages within one limit; int4's reading is printed, not gated,
   and int4 is gated against the CPU run on the card's codes (every page
   row quantized as the card quantized it), which leaves the kernels'
   arithmetic and not the codes' rounding;

12. (between qwen's serving and its phase 4, on the same weights) sampling
   and speculative decoding: the card's threefry key stream (split keys,
   random bits, uniforms) equal to the CPU's bit for bit; ``sample`` at
   temperature 0.8, top-k 50, top-p 0.95 on seeded logits on the card
   against the same logits on the CPU (a token may differ only where the
   perturbed top-2 gap is under 1e-5; such rows are counted); the
   workload's first 8 requests at temperature 0.8 per tick and with
   ``sync_every=4`` (no request queued: equal streams and keys, different
   from greedy's); greedy ngram speculation (draft 4, ``sync_every=4``,
   the spec loop under the no-host-sync check) in fp and int8 pages
   against phase 3's plain runs (equal streams, or at a request's first
   divergence the plain path's top-2 margin within twice the verify-vs-
   decode logit error there, from a one-slot replay; the acceptance, the
   rounds and the verify calls on the plain attention printed); and a
   sampled speculative run served twice under one seed, its streams
   repeated;

then phases 3 and 4 again for full-width deepseek-v2-lite-16B (MLA +
64-expert top-6 MoE, bf16 with an fp32 router, after qwen's parameters are
freed; its serving depth cut to 4 of 27 layers to keep the script within
half its time limit): the same workload in fp, int8 and int4
latent pages and int8 with ``sync_every=16`` under the no-host-sync check
(ticks and mean TTFT equal across the four, window outputs byte-identical
to per-tick int8, every MLA decode and chunked-prefill launch on tensor
cores), and teacher-forced logits at depth 2 (the dense prefix
layer and one MoE layer), with the share of MoE routing choices the card and
the CPU make alike; the limits are qwen's, over the steps whose read token
both route to the same experts (at least half of them), int4 as qwen's;
and phase 12's greedy speculation on its first 8 requests against a plain
run, both at an MoE capacity with no drops (otherwise a verify chunk's
batch and a decode step's drop other tokens, as in the reference);

5. train full-width qwen2-1.5B (28 layers, bf16, seeded) through
   ``make_train_step`` (the loss with per-layer recompute, its gradient,
   AdamW with fp32 masters) for 8 steps at batch 8 x seq 1024 on synthetic
   tokens, resetting the flash kernel's launch count before and reading it
   after (56 a step: each layer's forward and its recompute), with the loss
   falling and every loss and grad norm finite; profile 2 more steps; hold
   one depth-2 step's loss, grad norm and attention-weight gradient cosines
   on the card against the CPU's fp32 plain path and against the card's bf16
   path with the plain attention, with three planted attention faults that
   must fail those limits; and run the training CLI on the reduced model through injected failures
   (at least one restart, the last step reached, a finite loss);
6. full-width mamba2-2.7B (64 layers, d 2560, 80 SSM heads of P 64, state
   128, bf16 with fp32 a_log/d_skip/dt_bias): train it as phase 5 (128
   launches of each SSD kernel a step, every chunk_state and chunk_scan
   launch on tensor cores), with its depth-2 check against the
   CPU's fp32, the card's plain SSD and three planted SSD faults (scan
   without the causal mask, carried state dropped, state decay from the
   first row) that must fail the limits; forward (the kernels) against
   decode_step (the recurrence) at depth 4, and the card's forward against
   the CPU's fp32 one (phase 4's limits; argmax where the top-2 margin
   exceeds twice the error); then serve it, cut to 16 of its 64 layers,
   through the contiguous recurrent-state cache, per tick and with
   ``sync_every=16`` under the no-host-sync check (8 of the workload's
   requests: byte-identical
   outputs, equal ticks and TTFT, fewer dispatches, no SSD launch);
7. full-width hymba-1.5B (32 layers, d 1600, 25 query heads over 5 KV
   heads of 64, a window of 1024 on all but layers 0, 16 and 31, 64 SSM
   heads of P 50 with N 16, d_ff 5504; bf16, seeded): serve 8 of the
   workload's requests over the paged cache, prompts replayed a token a
   tick, per tick and with ``sync_every=16`` under the no-host-sync check
   (byte-identical outputs, equal ticks and TTFT, fewer dispatches; only
   the decode launches, 32 a tick, all on the tensor cores); decode one
   slot over 1088 tokens at depth 4 (layer 1 windowed) with a second slot
   parked, its logits at positions 0-7 and 1024-1087 held against the
   CPU's fp32 forward (phase 4's limits; the parked slot's recurrent rows
   must come back bit-identical); train it 8 steps at batch 8 x seq 1024
   (64 launches of each SSD kernel a step, none on the tensor cores, no
   flash launch: its attention carries a window on every layer, which the
   reference routes to the plain version) plus 2 profiled; and its depth-2
   check against the CPU's fp32 and the card's plain SSD with the three
   planted SSD faults.  Its serving is cut to 4 of its 32 layers to keep
   the script within half its time limit;
8. full-width granite-moe-3b-a800m (32 layers, d 1536, 24 query heads over
   8 KV heads of 64, 40 experts of width 512, top 8, tied embeddings;
   bf16, router fp32, seeded): serve the phase 3 workload at 16 of its 32
   layers with fp and with int8 pages (chunked prefill, prefix cache;
   ticks and TTFT equal across the two; every decode and prefill launch on
   the tensor cores); teacher-forced logits at depth 4, fp and int8 KV,
   against the CPU's fp32 on the card's MoE routing replayed (every step
   held to phase 4's limits, capacity drops included; the CPU on its own
   routing printed); train it 8 steps at batch 8 x seq 1024 through the
   flash kernel (64 launches a step, all on the tensor cores) plus 2
   profiled;
9. full-width whisper-tiny (4 encoder and 4 decoder layers, d 384, 6 heads
   of 64, d_ff 1536 GELU, vocab 51865; bf16, seeded): train it 8 steps at
   batch 8 on 1500 seeded frames and 448 decoder tokens (12 flash launches
   a step, all on the tensor cores: the encoder's 4 non-causal, the
   decoder's 4 causal and their recompute) plus 2 profiled; its
   teacher-forced ``decode_full`` against the CPU's fp32, and a greedy
   ``decode_step`` decode of 64 tokens (the KV cache, plain attention, as
   the reference) against the card's ``decode_full`` of the tokens it
   fed (phase 4's limits; argmax where the top-2 margin exceeds twice the
   error);
10. internvl2-26b at full width (d 6144, 48 query heads over 8 KV heads of
   128, d_ff 16384, vocab 92553, untied) cut to 2 of its 48 layers: a
   teacher-forced forward over 256 seeded patch rows and 128 tokens
   against the CPU's fp32, over the text rows; 2 training steps at batch 4
   of 256 patch rows and 768 tokens through the flash kernel, the loss
   finite and its cross-entropy that of the forward's text rows alone;
11. the dense configs chatglm3-6b (32 query heads over 2 KV heads of 128:
   a GQA group of 16; QKV bias, RoPE over half the head dim), gemma-7b
   (MHA, 16 heads of 256, GeGLU, tied embeddings) and deepseek-7b (MHA, 32
   heads of 128) at full width, cut to 4 of their 28 / 28 / 30 layers,
   seeded random bf16 weights: each serves the workload's first 8 requests
   (fp pages, chunked prefill, prefix cache) at the ticks and mean TTFT
   the scheduler gives them (a one-layer reduced model on the CPU), every
   decode and prefill launch on the tensor cores at D 128 and none at
   gemma's D 256, and holds its teacher-forced logits against the CPU's
   fp32 within phase 4's limits (argmax where the top-2 margin exceeds
   twice the error).  Phase 2 checks and times their kernels at their
   serving shape (chatglm's decode, chunked prefill and its int8 twin;
   gemma's decode and prefill; deepseek-7b's decode and prefill) and the
   flash kernel at gemma's D 256 (B 8, 16 heads, S 1024);
13. the serving engine's fault tolerance on full-width qwen2-1.5B at 4
   layers (seeded random bf16 weights): 12 requests of a 64-token shared
   prefix plus 8-96 own tokens, 16 new tokens each, over 4 slots of 256
   tokens, page 16, chunk 64, ``sync_every=4``, greedy, the auditor after
   every step, a 16-page pool where the fault-free run preempts; a chaos
   pass under the reference's fixed schedule at 4 times its ticks plus two
   more table corruptions (every flavor: an out-of-pool id, page 0, another
   row's page), then a speculative pass (ngram, draft 4) adding a poisoned
   verify: the hit requests FAILED with the reference's error texts, every
   other one completed, every corruption rejected by the dispatch guard
   before any launch, a clean audit every step, the pool empty after
   ``drain`` and ``shutdown``, no CUDA error, no host sync inside a window,
   the completed streams equal the fault-free twin's but at a token whose
   top-2 margin lies within twice the max |diff| of the two paths' logits
   there (a one-slot replay: the recompute's chunked prefill, the verify's
   plain attention); guards off, both in-pool corruption flavors caught by
   the auditor at their tick; the reference's snapshot round trip at page
   16 (the restored pages byte for byte, the warm request's cached tokens,
   admission TTFT and stream); then the contiguous strips (the plain
   attention, no kernel launch) against the paged kernels on qwen2-1.5B and
   on deepseek-v2-lite-16B at an MoE capacity with no drops, 4 layers each,
   phase 3's workload's first 8 requests: equal ticks and mean TTFT, streams
   equal but at such a margin, strips per tick and with ``sync_every=4``
   byte-identical.
14. MLA + MoE training: full-width deepseek-v2-lite-16B at 4 of its 27
   layers (the dense layer 0 and 3 MoE layers; bf16, router fp32,
   seeded) trains 8 AdamW steps at batch 8 x seq 1024 through the flash
   kernel at keys 192 / values 128 (7 launches a step, every one on the
   tensor cores: layer 0 is not recomputed) plus 2 profiled (GEMMs, the
   MoE dispatch, the flash forward, its plain backward, AdamW); the
   depth-2 check (the dense layer and one MoE layer) with every run on the
   kernel path's MoE routing, phase 5's limits and its three planted
   attention faults failing them; the depth-2 teacher-forced forward over
   256 tokens against the CPU's fp32 on the card's routing (phase 4's
   limits); and the reduced training CLI through injected failures.

The last three lines are the card's name and power limit, the kernel table
as one JSON line (each kernel's launches from its own path's run: the
default-pool serving run, fp or int8 for the quantized kernels; the 8
training steps for the flash kernel and mamba2's for the two SSD
kernels (hymba's, granite's and deepseek's training paths' launches are
printed in a ``[launches]`` line); the
library phase for the library's three, whose rows are M7, the (8, 16384,
16384) W int4 x A fp16 row and b128_s8192), and
``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS = 989e12  # dense bf16 tensor-core peak

# main-path shapes: qwen2-1.5B served with slots 8, max_len 1024, chunk 64
SLOTS, MAX_LEN, PAGE, CHUNK = 8, 1024, 16, 64
HQ, HKV, HEAD_DIM = 12, 2, 128


def log(msg: str):
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------


class Timing(float):
    """A device time in ms: the median of its calls, carrying the least
    (``lo``) and the most (``hi``) of them; formatted with a spec it reads
    ``median (min-max)``."""

    def __new__(cls, times):
        self = super().__new__(cls, statistics.median(times))
        self.lo, self.hi, self.calls = min(times), max(times), len(times)
        return self

    def __format__(self, spec):
        if not spec:
            return float.__repr__(self)
        return f"{float(self):{spec}} ({self.lo:{spec}}-{self.hi:{spec}})"


LONG_CALL_MS = 10.0  # a call longer than this is timed LONG_CALL_ITERS times
LONG_CALL_ITERS = 5


def time_ms(torch, fn, iters: int = 20, flush=None) -> Timing:
    """Device time of ``fn``: the median, least and most over ``iters``
    calls (``LONG_CALL_ITERS`` for a call over ``LONG_CALL_MS``), each
    bracketed by CUDA events.  ``flush`` (untimed) runs before each call so
    that the call finds L2 cold, as the serving path does (every layer has
    its own pool).  A device-side sleep ahead of the start event keeps the
    card busy while the host enqueues ``fn``, so the events time the
    device's work and not the host's launch overhead."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    while len(times) < iters:
        if flush is not None:
            flush()
        torch.cuda._sleep(3_000_000)  # ~1.5 ms of device time
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
        if times[0] > LONG_CALL_MS:
            iters = min(iters, LONG_CALL_ITERS)
    return Timing(times)


def bound(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak_flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

# Limits.  fp32: max abs error, the order of fp32 sums and exp2 against exp.
# bf16: both sides score and accumulate in fp32 and round the output once, so
# a sound kernel's element lies within one bf16 ulp of the plain value (the
# two fp32 results may straddle a rounding boundary); the limit is two ulps
# of the plain value, element-wise.  ``accumulation_controls`` shows the limit
# passes a plain fp32-accumulating online softmax and rejects one that keeps
# its running sum and P.V accumulator in bf16, or rounds its probabilities
# once to bf16 before P.V (the tensor-core kernels multiply P as a bf16 pair
# hi + lo instead).
FP32_ATOL = 1e-4
BF16_ULPS = 2.0
NEG_CLAMP = -2.0 ** 20  # the kernels' floor of the running max


def bf16_ulps(torch, got, want, floor: float = 2.0 ** -16) -> float:
    """Largest |got - want| over the elements, in bf16 ulps of ``want``
    (an ulp of at least ``floor``, where fp32 summation order alone moves
    the result)."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8).clamp_min(floor)
    ulp = torch.where(w == 0, torch.full_like(w, floor), ulp)
    return ((got.float() - w).abs() / ulp).max().item()


def online_softmax(torch, q, k, v, mask, acc_dtype, scale=HEAD_DIM ** -0.5,
                   tile=PAGE, p_dtype=None):
    """Attention of ``q`` (..., Sq, D) over ``k`` (..., S, D) and ``v``
    (..., S, Dv) under ``mask`` (..., Sq, S), ``tile`` keys at a time, with
    the running max in fp32 and the running sum and accumulator stored in
    ``acc_dtype`` after every tile: float32 is the kernels' arithmetic,
    bfloat16 the fault of a kernel that accumulates in bf16.  ``p_dtype``
    rounds the probabilities once before P.V (the running sum keeps them
    unrounded): bfloat16 is the usual FlashAttention-2 shortcut that the
    tensor-core kernels avoid with their hi + lo pair."""
    qf = q.float() * scale
    m = torch.full(q.shape[:-1] + (1,), NEG_CLAMP, device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), device=q.device, dtype=acc_dtype)
    acc = torch.zeros(q.shape[:-1] + v.shape[-1:], device=q.device, dtype=acc_dtype)
    for t in range(0, k.shape[-2], tile):
        sc = qf @ k[..., t:t + tile, :].float().transpose(-1, -2)
        sc = sc.masked_fill(~mask[..., t:t + tile], float("-inf"))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(sc - m_new)
        l = (l.float() * alpha + p.sum(-1, keepdim=True)).to(acc_dtype)
        if p_dtype is not None:
            p = p.to(p_dtype).float()
        acc = (acc.float() * alpha + p @ v[..., t:t + tile, :].float()).to(acc_dtype)
        m = m_new
    return (acc.float() / l.float().clamp_min(1e-30)).to(q.dtype)


# (name, accumulator dtype, keys a tile, probabilities' dtype before P.V)
CONTROLS = (("fp32_acc_ulps", "float32", PAGE, None),
            ("bf16_acc_ulps", "bfloat16", PAGE, None),
            ("bf16_p_ulps", "float32", 64, "bfloat16"))


def accumulation_controls(torch, q, k, v, mask, plain, live=None,
                          scale=HEAD_DIM ** -0.5):
    """bf16 ulps from ``plain`` of the CONTROLS over the same gathered
    inputs (``live`` masks the rows compared): an fp32-accumulating online
    softmax, a bf16-accumulating one, and an fp32-accumulating one over
    64-key tiles whose P is rounded once to bf16 before P.V."""
    out = {}
    for name, acc_dtype, tile, p_dtype in CONTROLS:
        got = online_softmax(torch, q, k, v, mask, getattr(torch, acc_dtype), scale,
                             tile, p_dtype and getattr(torch, p_dtype))
        if live is not None:
            got, want = torch.where(live, got, 0), torch.where(live, plain, 0)
        else:
            want = plain
        out[name] = bf16_ulps(torch, got, want)
    return out


def controls_text(r) -> str:
    return (f"controls: fp32-accumulating {r['fp32_acc_ulps']:.2f}, bf16-accumulating "
            f"{r['bf16_acc_ulps']:.2f}, P rounded to bf16 {r['bf16_p_ulps']:.2f}")


def kernel_ok(r) -> bool:
    """A check's result within its limit.  In bf16 the limit must also pass
    the fp32-accumulating control and reject the bf16-accumulating one and
    the one that rounds P to bf16; for the split decodes it must reject the
    merge without the rescale, in either dtype."""
    limit = BF16_ULPS if "ulps" in r else FP32_ATOL
    if r.get("merge_no_rescale", float("inf")) <= limit:
        return False
    if "ulps" not in r:
        return r["err"] <= FP32_ATOL
    return (r["ulps"] <= BF16_ULPS and r["fp32_acc_ulps"] <= BF16_ULPS
            and r["bf16_acc_ulps"] > BF16_ULPS and r["bf16_p_ulps"] > BF16_ULPS)


H100_SMS = 132  # the grid rule's SM count where there is no card (a rehearsal)

# The kernel table's times of the kernels redesigned for the tensor cores
# last (the quantized GQA decode's split grid, chunk_state on mma.sync),
# before that redesign: H100 80GB HBM3 at 700 W, this script's int8 and
# mamba2 training-shape rows.  Printed beside their new times.
EARLIER_MS = {"paged_attention_quant": 0.2243, "chunk_state": 0.5258}
# chunk_state at hymba-1.5B's training shape (HYMBA_SSD_CASE) on the
# 128-row CUDA-core tile, before its 16-row tile: H100 80GB HBM3 at 700 W
HYMBA_EARLIER_MS = {"chunk_state": 0.4152}


# a GQA decode's serving shape: slots, tokens a slot, query heads, KV heads,
# head dim (pages of PAGE)
DecodeShape = collections.namedtuple("DecodeShape", "model slots max_len hq hkv d")


QWEN_DECODE = DecodeShape("qwen2-1.5B", SLOTS, MAX_LEN, HQ, HKV, HEAD_DIM)
# hymba-1.5B: a GQA group of 5 at head dim 64.  Its serving run's shape
# (SLOTS slots of MAX_LEN tokens: its window of 1024, on 29 of its 32
# layers, never binds there) carries phase 7's launches; slots of 2048
# tokens let the window drop whole splits of the longer slots.
HYMBA_SERVE_DECODE = DecodeShape("hymba-1.5B", SLOTS, MAX_LEN, 25, 5, 64)
HYMBA_DECODE = HYMBA_SERVE_DECODE._replace(max_len=2048)
HYMBA_WINDOW = 1024
# granite-moe-3b-a800m: a GQA group of 3 at head dim 64, served as qwen is
# (its serving runs' shape: the decode, and the chunked prefill's 48-row
# page groups of 16 positions x 3 heads)
GRANITE_DECODE = DecodeShape("granite-moe-3b-a800m", SLOTS, MAX_LEN, 24, 8, 64)
# The dense configs of phase 11, at their serving shape: chatglm3-6b's GQA
# group of 16 at D 128 (the chunked prefill's page groups of 256 rows, split
# over two blocks of 8 heads), gemma-7b's MHA at D 256 (off the tensor cores:
# the kernels take D 64 or 128 there) and deepseek-7b's MHA, 32 over 32 at D
# 128 (a group of 1).
CHATGLM_DECODE = DecodeShape("chatglm3-6b", SLOTS, MAX_LEN, 32, 2, 128)
GEMMA_DECODE = DecodeShape("gemma-7b", SLOTS, MAX_LEN, 16, 16, 256)
DEEPSEEK7B_DECODE = DecodeShape("deepseek-7b", SLOTS, MAX_LEN, 32, 32, 128)
GQA_TC_HEAD_DIMS = (64, 128)  # the GQA kernels' tensor-core head dims


def gqa_takes_tensor_cores(dtype, shape) -> bool:
    """Where a GQA decode or chunked-prefill launch at ``shape`` must run on
    the tensor cores: bf16 at D 64 or 128, any GQA group (the prefill splits
    a page's rows past 128 over blocks)."""
    return str(dtype) == "torch.bfloat16" and (shape or QWEN_DECODE).d in GQA_TC_HEAD_DIMS


def decode_grid(torch, PA, dev, shape=QWEN_DECODE):
    """(splits, keys a split) of the decode kernel at ``shape`` on this
    device's SM count."""
    sms = PA.sm_count(dev.index or 0) if dev.type == "cuda" else H100_SMS
    return PA.decode_splits(shape.slots, shape.hkv, shape.max_len // PAGE, PAGE, sms)


def _tables(torch, rng, dev, shape=QWEN_DECODE):
    max_pages = shape.max_len // PAGE
    num_pages = shape.slots * max_pages + 1  # page 0 reserved
    perm = rng.permutation(num_pages - 1) + 1
    tables = perm.reshape(shape.slots, max_pages).astype("int32")
    return torch.as_tensor(tables, device=dev), num_pages


def _quantized(torch, ref, pools, fmt):
    """Each fp pool quantized per row: (packed, scales) pairs."""
    return [ref.quantize_rows(p, fmt) for p in pools]


def check_decode(torch, np, ref, mod, dtype, window, flush, timed, dev,
                 fmt=None, shape=QWEN_DECODE):
    """The decode kernel (``fmt`` None) or its quantized twin (``fmt`` int8
    or int4, pools quantized from the same random values) against its plain
    version, at ``shape``."""
    slots, max_len, hq, hkv, d = (shape.slots, shape.max_len, shape.hq, shape.hkv,
                                  shape.d)
    rng = np.random.default_rng(1)
    tables, num_pages = _tables(torch, rng, dev, shape)
    lens = rng.integers(1, max_len + 1, size=slots).astype("int32")
    lens[2] = 0  # an empty slot emits zeros
    lens[5] = max_len
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((slots, hq, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((hkv, num_pages, PAGE, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((hkv, num_pages, PAGE, d), generator=g, device=dev).to(dtype)
    lens_t = torch.as_tensor(lens, device=dev)
    isz = q.element_size()
    if fmt is None:
        args, kw, row_bytes = (kp, vp), {}, d * isz
        kernel, plain_fn = mod.paged_attention, ref.paged_attention
    else:
        (kq, ks), (vq, vs) = _quantized(torch, ref, (kp, vp), fmt)
        args, kw = (kq, vq, ks, vs), {"fmt": fmt}
        row_bytes = d // ref.KV_PACK[fmt] + isz  # packed row + scale
        kernel, plain_fn = mod.paged_attention_quant, ref.paged_attention_quant
        # what the kernel attends: the pages dequantized to q's dtype
        kp = ref.dequantize_rows(kq, ks, fmt).to(dtype)
        vp = ref.dequantize_rows(vq, vs, fmt).to(dtype)
    run = lambda: kernel(q, *args, tables, lens_t, window=window, **kw)  # noqa: E731
    plain_run = lambda: plain_fn(q, *args, tables, lens_t, window=window, **kw)  # noqa: E731
    before, tc_before = mod.KERNEL.launches, mod.KERNEL.tc_launches
    out, plain = run(), plain_run()
    tc = mod.KERNEL.tc_launches - tc_before
    mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before  # comparisons do not count
    err = (out.float() - plain.float()).abs().max().item()
    assert torch.isfinite(out).all() and out[2].abs().max().item() == 0.0
    res = {"err": err, "tc_launches": tc}
    # the split grid, and the merge's control: the split kernel's arithmetic
    # in plain PyTorch (over the dequantized pages for the quantized twin)
    # with the partial states summed as they stand, not rescaled to their
    # common max, must fail the limit (where there is more than one split:
    # one split's state needs no rescale)
    from repro_torch.kernels import paged_attention as PA

    splits, split_keys = decode_grid(torch, PA, dev, shape)
    res["splits"] = f"{splits} splits of {split_keys} keys, {hkv * slots * splits} blocks"
    if splits > 1:
        faulty = PA.split_decode(q, kp, vp, tables, lens_t, splits, split_keys,
                                 window=window, pair=dtype == torch.bfloat16,
                                 rescale=False)
        res["merge_no_rescale"] = (
            bf16_ulps(torch, faulty, plain) if dtype == torch.bfloat16
            else (faulty.float() - plain.float()).abs().max().item())
    # the slot's pages gathered for one dense call: SDPA and the controls
    kg = kp[:, tables.long()].transpose(0, 1).reshape(slots, hkv, -1, d)
    vg = vp[:, tables.long()].transpose(0, 1).reshape(slots, hkv, -1, d)
    kg = kg.repeat_interleave(hq // hkv, dim=1)
    vg = vg.repeat_interleave(hq // hkv, dim=1)
    ki = torch.arange(max_len, device=dev)
    mask = ki[None, :] < lens_t[:, None]
    if window is not None:
        mask &= ki[None, :] >= (lens_t[:, None] - window)
    mask = mask[:, None, None, :]
    q4 = q[:, :, None, :]
    if dtype == torch.bfloat16:
        res["ulps"] = bf16_ulps(torch, out, plain)
        res.update(accumulation_controls(torch, q4, kg, vg, mask, plain[:, :, None],
                                         scale=d ** -0.5))
    if timed:
        res["ms"] = time_ms(torch, run, flush=flush)
        res["plain_ms"] = time_ms(torch, plain_run, flush=flush)
        mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
        # yardstick: one SDPA call over the gathered pages (gather untimed);
        # no single PyTorch call dequantizes paged KV, so for the quantized
        # kernels it is labelled apart and library_ms stays null
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = time_ms(torch, lambda: sdpa(q4, kg, vg, attn_mask=mask), flush=flush)
        res["library_ms"] = sdpa_ms if fmt is None else None
        if fmt is not None:
            res["sdpa_dequantized_ms"] = sdpa_ms
        eff = lens if window is None else np.minimum(lens, window)
        live = int(eff.sum())
        nbytes = (q.numel() * isz * 2 + 2 * hkv * live * row_bytes
                  + slots * 4 + sum(-(-int(n) // PAGE) for n in eff) * 4)
        flops = 4.0 * hq * d * live
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    return res


def _chunk_starts_lens(np, rng):
    """Page-aligned chunk starts (slot 0 at 0) and live lengths: full
    chunks, a partial final chunk, an idle slot and a one-token chunk."""
    starts = (rng.integers(0, (MAX_LEN - CHUNK) // PAGE + 1, size=SLOTS) * PAGE).astype("int32")
    lens = np.full(SLOTS, CHUNK, "int32")
    starts[0] = 0
    lens[1] = 37  # a partial final chunk
    lens[3] = 0  # an idle slot riding in the batch
    lens[6] = 1
    return starts, lens


def check_pages(torch, tables, starts, lens, num_pages, written, pools, new,
                row_at, chunk_row, pages_at):
    """Each of the ``written`` pool sets holds the chunk's rows ``new`` at
    every live position (``row_at(pool, page, offset)`` against
    ``chunk_row(rows, slot, i)``), and the pages no chunk writes (page 0,
    the sink of both paths, aside) keep the contents of ``pools``."""
    max_pages = MAX_LEN // PAGE
    tb = tables.cpu().numpy()
    touched = {0}
    for b in range(SLOTS):
        for c in range(CHUNK):
            touched.add(int(tb[b, min((int(starts[b]) + c) // PAGE, max_pages - 1)]))
        for c in range(int(lens[b])):
            p = int(starts[b]) + c
            pg, of = int(tb[b, p // PAGE]), p % PAGE
            for pool_set in written:
                for pool, rows in zip(pool_set, new):
                    assert torch.equal(row_at(pool, pg, of), chunk_row(rows, b, c))
    keep = torch.as_tensor([p for p in range(num_pages) if p not in touched],
                           device=tables.device)
    for pool_set in written:
        for pool, orig in zip(pool_set, pools):
            assert torch.equal(pages_at(pool, keep), pages_at(orig, keep))


def prefill_mask(torch, st, ln, window):
    """The chunk's mask over [prior positions ; chunk] (slots, 1, chunk,
    max_len + chunk), and its live rows (slots, 1, chunk, 1)."""
    si = torch.arange(MAX_LEN, device=st.device)
    ci = torch.arange(CHUNK, device=st.device)
    qpos = st[:, None] + ci[None, :]
    m_ctx = (si[None, None, :] < st[:, None, None]).expand(SLOTS, CHUNK, MAX_LEN)
    m_new = (ci[None, None, :] <= ci[None, :, None]) & (ci[None, None, :] < ln[:, None, None])
    if window is not None:
        m_ctx = m_ctx & ((qpos[:, :, None] - si[None, None, :]) < window)
        m_new = m_new & ((ci[None, :, None] - ci[None, None, :]) < window)
    return (torch.cat([m_ctx, m_new], -1)[:, None],
            (ci[None, :] < ln[:, None])[:, None, :, None])


def prefill_work(starts, lens, window):
    """The (query, key) pairs the chunks attend and the prior rows they
    read, counted from this run's starts and lengths."""
    pairs = prior_rows = 0
    for s0, n in zip(starts.tolist(), lens.tolist()):
        prior_rows += s0 - (0 if window is None else max(0, s0 - window + 1))
        for i in range(n):
            pairs += s0 + i + 1 - (0 if window is None else max(0, s0 + i - window + 1))
    return pairs, prior_rows


def check_prefill(torch, np, ref, mod, dtype, window, flush, timed, dev,
                  fmt=None, shape=QWEN_DECODE):
    """The chunked-prefill kernel (``fmt`` None) or its quantized twin
    against its plain version: outputs, and the pages both write; at the
    heads and head dim of ``shape`` (its slots and tokens a slot are the
    main path's SLOTS and MAX_LEN)."""
    assert (shape.slots, shape.max_len) == (SLOTS, MAX_LEN), shape
    hq, hkv, d = shape.hq, shape.hkv, shape.d
    rng = np.random.default_rng(3)
    tables, num_pages = _tables(torch, rng, dev)
    starts, lens = _chunk_starts_lens(np, rng)
    g = torch.Generator(device=dev).manual_seed(4)
    q = torch.randn((SLOTS, hq, CHUNK, d), generator=g, device=dev).to(dtype)
    kn = torch.randn((SLOTS, hkv, CHUNK, d), generator=g, device=dev).to(dtype)
    vn = torch.randn((SLOTS, hkv, CHUNK, d), generator=g, device=dev).to(dtype)
    kp = torch.randn((hkv, num_pages, PAGE, d), generator=g, device=dev).to(dtype)
    vp = torch.randn((hkv, num_pages, PAGE, d), generator=g, device=dev).to(dtype)
    st, ln = torch.as_tensor(starts, device=dev), torch.as_tensor(lens, device=dev)
    isz = q.element_size()
    if fmt is None:
        new, pools, kw = (kn, vn), (kp, vp), {}
        row_bytes = d * isz
        kernel, plain_fn = mod.prefill_attention, ref.paged_prefill_attention
    else:
        (knq, kns), (vnq, vns), (kq, ks), (vq, vs) = _quantized(
            torch, ref, (kn, vn, kp, vp), fmt)
        new, pools, kw = (knq, vnq, kns, vns), (kq, vq, ks, vs), {"fmt": fmt}
        row_bytes = d // ref.KV_PACK[fmt] + isz  # packed row + scale
        kernel = mod.prefill_attention_quant
        plain_fn = ref.paged_prefill_attention_quant
        # what the kernel attends: the chunk and the pages dequantized
        kn, vn, kp, vp = (ref.dequantize_rows(a, b, fmt).to(dtype) for a, b in
                          ((knq, kns), (vnq, vns), (kq, ks), (vq, vs)))
    p1, p2 = [t.clone() for t in pools], [t.clone() for t in pools]
    run = lambda: kernel(q, *new, *p1, tables, st, ln, window=window, **kw)[0]  # noqa: E731
    plain_run = lambda: plain_fn(q, *new, *p2, tables, st, ln, window=window, **kw)[0]  # noqa: E731
    before, tc_before = mod.KERNEL.launches, mod.KERNEL.tc_launches
    out, plain = run(), plain_run()
    tc = mod.KERNEL.tc_launches - tc_before
    mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
    err = (out.float() - plain.float()).abs().max().item()
    assert torch.isfinite(out).all()
    # live positions hold the chunk's K/V (packed bytes and scales) on both
    # paths; pages no chunk writes keep their contents
    check_pages(torch, tables, starts, lens, num_pages, (p1, p2), pools, new,
                lambda pool, pg, of: pool[:, pg, of],
                lambda rows, b, c: rows[b, :, c], lambda pool, idx: pool[:, idx])
    res = {"err": err, "tc_launches": tc}
    # [gathered prior pages ; chunk] for one dense call: SDPA and the controls
    kg = kp[:, tables.long()].transpose(0, 1).reshape(SLOTS, hkv, -1, d)
    vg = vp[:, tables.long()].transpose(0, 1).reshape(SLOTS, hkv, -1, d)
    kall = torch.cat([kg, kn], 2).repeat_interleave(hq // hkv, dim=1)
    vall = torch.cat([vg, vn], 2).repeat_interleave(hq // hkv, dim=1)
    mask, live_rows = prefill_mask(torch, st, ln, window)
    if dtype == torch.bfloat16:
        res["ulps"] = bf16_ulps(torch, out, plain)
        res.update(accumulation_controls(torch, q, kall, vall, mask, plain, live_rows,
                                         scale=d ** -0.5))
    if timed:
        res["ms"] = time_ms(torch, run, flush=flush)
        res["plain_ms"] = time_ms(torch, plain_run, flush=flush)
        mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
        # yardstick: one SDPA call over the gathered inputs (gather untimed)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        sdpa_ms = time_ms(torch, lambda: sdpa(q, kall, vall, attn_mask=mask), flush=flush)
        res["library_ms"] = sdpa_ms if fmt is None else None
        if fmt is not None:
            res["sdpa_dequantized_ms"] = sdpa_ms
        pairs, prior_rows = prefill_work(starts, lens, window)
        live = int(lens.sum())
        nbytes = ((hq * d * live) * isz * 2  # live Q rows in, out
                  + 2 * hkv * row_bytes * (live * 2 + prior_rows))
        flops = 4.0 * hq * d * pairs
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    return res


# ---------------------------------------------------------------------------
# phase 2, MLA: deepseek-v2-lite-16B's full-width latent attention
# ---------------------------------------------------------------------------

# 16 heads over a 512-wide latent plus a 64-wide rope part; the model scales
# scores by 1 / sqrt(nope + rope) = 1 / sqrt(128 + 64), not by the key width
MLA_HEADS, RANK, ROPE = 16, 512, 64
MLA_SCALE = (128 + 64) ** -0.5


def _latent(torch, ref, ckv, kpe, fmt, dtype):
    """The pools a kernel is given and what it attends: fp pools as they
    are, or each quantized per row and dequantized to ``dtype``.  Returns
    (kernel args, attended ckv, attended kpe, bytes a row)."""
    isz = torch.tensor([], dtype=dtype).element_size()
    if fmt is None:
        return (ckv, kpe), ckv, kpe, (RANK + ROPE) * isz
    (cq, cs), (pq, ps) = ref.quantize_rows(ckv, fmt), ref.quantize_rows(kpe, fmt)
    pack = ref.KV_PACK[fmt]
    return ((cq, pq, cs, ps), ref.dequantize_rows(cq, cs, fmt).to(dtype),
            ref.dequantize_rows(pq, ps, fmt).to(dtype),
            (RANK + ROPE) // pack + 2 * isz)  # packed rows + two scales


def _yardstick(torch, res, q, k, v, mask, flush):
    """One SDPA call over keys [ckv | kpe] and values ckv gathered (and
    dequantized) beforehand, untimed: a yardstick, not the same function on
    the same inputs, so library_ms stays null."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    res["sdpa_gathered_ms"] = time_ms(
        torch, lambda: sdpa(q, k, v, attn_mask=mask, scale=MLA_SCALE), flush=flush)
    res["library_ms"] = None


def mla_decode_grid(torch, MP, dev):
    """(splits, keys a split) of the MLA decode kernel at deepseek-v2-lite-
    16B's serving shape on this device's SM count."""
    sms = MP.sm_count(dev.index or 0) if dev.type == "cuda" else H100_SMS
    return MP.split_grid(SLOTS, MLA_HEADS, MAX_LEN // PAGE, PAGE, sms)


def check_mla_decode(torch, np, ref, mod, dtype, window, flush, timed, dev,
                     fmt=None):
    """The paged MLA decode kernel (``fmt`` None) or its quantized twin
    against its plain version, at deepseek-v2-lite-16B's widths, with the
    split grid and the merge's control (as check_decode)."""
    from repro_torch.kernels import mla_paged as MP

    rng = np.random.default_rng(11)
    tables, num_pages = _tables(torch, rng, dev)
    lens = rng.integers(1, MAX_LEN + 1, size=SLOTS).astype("int32")
    lens[2] = 0  # an empty slot emits zeros
    lens[5] = MAX_LEN
    g = torch.Generator(device=dev).manual_seed(12)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, qpe = rand(SLOTS, MLA_HEADS, RANK), rand(SLOTS, MLA_HEADS, ROPE)
    args, ckv, kpe, row_bytes = _latent(
        torch, ref, rand(num_pages, PAGE, RANK), rand(num_pages, PAGE, ROPE), fmt, dtype)
    kw = {"sm_scale": MLA_SCALE, "window": window}
    if fmt is None:
        kernel, plain_fn = mod.mla_paged, ref.mla_paged
    else:
        kernel, plain_fn = mod.mla_paged_quant, ref.mla_paged_quant
        kw["fmt"] = fmt
    lens_t = torch.as_tensor(lens, device=dev)
    run = lambda: kernel(q, qpe, *args, tables, lens_t, **kw)  # noqa: E731
    plain_run = lambda: plain_fn(q, qpe, *args, tables, lens_t, **kw)  # noqa: E731
    before, tc_before = mod.KERNEL.launches, mod.KERNEL.tc_launches
    out, plain = run(), plain_run()
    tc = mod.KERNEL.tc_launches - tc_before
    mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before  # comparisons do not count
    assert torch.isfinite(out).all() and out[2].abs().max().item() == 0.0
    res = {"err": (out.float() - plain.float()).abs().max().item(), "tc_launches": tc}
    # the split grid, and the merge's control: the split kernel's arithmetic
    # in plain PyTorch over what the kernel attends, with the partial states
    # summed as they stand, not rescaled to their common max, must fail the
    # limit
    splits, split_keys = mla_decode_grid(torch, MP, dev)
    res["splits"] = f"{splits} splits of {split_keys} keys, {SLOTS * splits} blocks"
    faulty = MP.split_decode(q, qpe, ckv, kpe, tables, lens_t, splits, split_keys,
                             sm_scale=MLA_SCALE, window=window,
                             pair=dtype == torch.bfloat16, rescale=False)
    res["merge_no_rescale"] = (bf16_ulps(torch, faulty, plain) if dtype == torch.bfloat16
                               else (faulty.float() - plain.float()).abs().max().item())
    # each slot's pages gathered for one dense call: SDPA and the controls
    kg = torch.cat([ckv, kpe], -1)[tables.long()].reshape(SLOTS, 1, -1, RANK + ROPE)
    vg = ckv[tables.long()].reshape(SLOTS, 1, -1, RANK)
    ki = torch.arange(MAX_LEN, device=dev)
    mask = ki[None, :] < lens_t[:, None]
    if window is not None:
        mask &= ki[None, :] >= (lens_t[:, None] - window)
    mask = mask[:, None, None, :]
    q4 = torch.cat([q, qpe], -1)[:, :, None, :]
    if dtype == torch.bfloat16:
        res["ulps"] = bf16_ulps(torch, out, plain)
        res.update(accumulation_controls(torch, q4, kg, vg, mask, plain[:, :, None],
                                         scale=MLA_SCALE))
    if timed:
        res["ms"] = time_ms(torch, run, flush=flush)
        res["plain_ms"] = time_ms(torch, plain_run, flush=flush)
        mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
        _yardstick(torch, res, q4, kg.expand(-1, MLA_HEADS, -1, -1),
                   vg.expand(-1, MLA_HEADS, -1, -1), mask, flush)
        eff = lens if window is None else np.minimum(lens, window)
        live = int(eff.sum())
        isz = q.element_size()
        nbytes = (SLOTS * MLA_HEADS * (2 * RANK + ROPE) * isz  # q_lat, q_pe in; out
                  + live * row_bytes + SLOTS * 4
                  + sum(-(-int(n) // PAGE) for n in eff) * 4)
        flops = 2.0 * MLA_HEADS * (2 * RANK + ROPE) * live
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    return res


def check_mla_prefill(torch, np, ref, mod, dtype, window, flush, timed, dev,
                      fmt=None):
    """The MLA chunked-prefill kernel (``fmt`` None) or its quantized twin
    against its plain version: outputs, and the pages both write."""
    rng = np.random.default_rng(13)
    tables, num_pages = _tables(torch, rng, dev)
    starts, lens = _chunk_starts_lens(np, rng)
    g = torch.Generator(device=dev).manual_seed(14)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    q, qpe = rand(SLOTS, MLA_HEADS, CHUNK, RANK), rand(SLOTS, MLA_HEADS, CHUNK, ROPE)
    new, cn, pn, row_bytes = _latent(torch, ref, rand(SLOTS, CHUNK, RANK),
                                     rand(SLOTS, CHUNK, ROPE), fmt, dtype)
    pools, ckv, kpe, _ = _latent(torch, ref, rand(num_pages, PAGE, RANK),
                                 rand(num_pages, PAGE, ROPE), fmt, dtype)
    kw = {"sm_scale": MLA_SCALE, "window": window}
    if fmt is None:
        kernel, plain_fn = mod.mla_prefill, ref.paged_mla_prefill
    else:
        kernel, plain_fn = mod.mla_prefill_quant, ref.paged_mla_prefill_quant
        kw["fmt"] = fmt
    st, ln = torch.as_tensor(starts, device=dev), torch.as_tensor(lens, device=dev)
    p1, p2 = [t.clone() for t in pools], [t.clone() for t in pools]
    run = lambda: kernel(q, qpe, *new, *p1, tables, st, ln, **kw)[0]  # noqa: E731
    plain_run = lambda: plain_fn(q, qpe, *new, *p2, tables, st, ln, **kw)[0]  # noqa: E731
    before, tc_before = mod.KERNEL.launches, mod.KERNEL.tc_launches
    out, plain = run(), plain_run()
    tc = mod.KERNEL.tc_launches - tc_before
    mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
    assert torch.isfinite(out).all()
    res = {"err": (out.float() - plain.float()).abs().max().item(), "tc_launches": tc}
    # live positions hold the chunk's latent and rope rows (packed bytes and
    # both scales) on both paths; pages no chunk writes keep their contents
    check_pages(torch, tables, starts, lens, num_pages, (p1, p2), pools, new,
                lambda pool, pg, of: pool[pg, of], lambda rows, b, c: rows[b, c],
                lambda pool, idx: pool[idx])
    # [gathered prior pages ; chunk] for one dense call: SDPA and the controls
    kall = torch.cat([torch.cat([ckv, kpe], -1)[tables.long()].reshape(SLOTS, -1, RANK + ROPE),
                      torch.cat([cn, pn], -1)], 1)[:, None]
    vall = torch.cat([ckv[tables.long()].reshape(SLOTS, -1, RANK), cn], 1)[:, None]
    mask, live_rows = prefill_mask(torch, st, ln, window)
    qall = torch.cat([q, qpe], -1)
    if dtype == torch.bfloat16:
        res["ulps"] = bf16_ulps(torch, out, plain)
        res.update(accumulation_controls(torch, qall, kall, vall, mask, plain,
                                         live_rows, scale=MLA_SCALE))
    if timed:
        res["ms"] = time_ms(torch, run, flush=flush)
        res["plain_ms"] = time_ms(torch, plain_run, flush=flush)
        mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
        _yardstick(torch, res, qall, kall.expand(-1, MLA_HEADS, -1, -1),
                   vall.expand(-1, MLA_HEADS, -1, -1), mask, flush)
        pairs, prior_rows = prefill_work(starts, lens, window)
        live = int(lens.sum())
        isz = q.element_size()
        nbytes = (MLA_HEADS * (2 * RANK + ROPE) * isz * live  # live q in, out
                  + row_bytes * (live * 2 + prior_rows))  # chunk in, pages out, prior
        flops = 2.0 * MLA_HEADS * (2 * RANK + ROPE) * pairs
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    return res


# ---------------------------------------------------------------------------
# phase 2, flash attention: qwen2-1.5B's full-sequence training shapes
# ---------------------------------------------------------------------------

TRAIN_BATCH, TRAIN_SEQ = 8, 1024
# whisper-tiny trains at batch 8 on its encoder's 1500 frames and its
# decoder's 448 positions; internvl2-26b at batch 4 on its stub frontend's
# 256 patch rows before 768 text tokens
WHISPER_FRAMES, WHISPER_TOKENS = 1500, 448
VLM_BATCH, VLM_PREFIX, VLM_TEXT = 4, 256, 768
# (label, batch, q heads, kv heads, Sq, Sk, head dim, causal): the training
# forward's shapes first, then a suffix block of queries (causal and not),
# a ragged length and a head dim of 64; then the training shapes of the
# models of phases 8-10: granite (causal, a group of 3 at D 64), whisper's
# encoder (non-causal over 1500 frames, ragged against the 64-row and
# 64-key tiles) and decoder (causal), internvl2 (causal, a group of 6 at D
# 128 over prefix and text); gemma-7b's MHA at D 256 (the CUDA-core body:
# no model of this script trains it, so no run launches it); and
# deepseek-v2-lite's MLA heads (phase 14), whose keys (128 nope + 64 rope)
# are wider than their values: the head dim is then the pair (Dk, Dv), the
# scale 1 / sqrt(Dk)
FLASH_CASES = (
    ("train", TRAIN_BATCH, HQ, HKV, TRAIN_SEQ, TRAIN_SEQ, HEAD_DIM, True),
    ("suffix, causal", TRAIN_BATCH, HQ, HKV, 256, TRAIN_SEQ, HEAD_DIM, True),
    ("suffix, non-causal", TRAIN_BATCH, HQ, HKV, 256, TRAIN_SEQ, HEAD_DIM, False),
    ("ragged", TRAIN_BATCH, HQ, HKV, 1000, 1000, HEAD_DIM, True),
    ("head dim 64", TRAIN_BATCH, HQ, HKV, TRAIN_SEQ, TRAIN_SEQ, 64, True),
    ("granite train", TRAIN_BATCH, 24, 8, TRAIN_SEQ, TRAIN_SEQ, 64, True),
    ("whisper encoder", TRAIN_BATCH, 6, 6, WHISPER_FRAMES, WHISPER_FRAMES, 64, False),
    ("whisper decoder", TRAIN_BATCH, 6, 6, WHISPER_TOKENS, WHISPER_TOKENS, 64, True),
    ("internvl2 train", VLM_BATCH, 48, 8, VLM_PREFIX + VLM_TEXT, VLM_PREFIX + VLM_TEXT,
     128, True),
    ("gemma-7b D 256", TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, 256, True),
    ("deepseek train", TRAIN_BATCH, 16, 16, TRAIN_SEQ, TRAIN_SEQ, (192, 128), True),
)
# the cases timed beside the table's ("train"): the new models' shapes
FLASH_TIMED = ("train", "granite train", "whisper encoder", "whisper decoder",
               "internvl2 train", "gemma-7b D 256", "deepseek train")
# the flash kernel's tensor-core (Dk, Dv) pairs: GQA's head dims and MLA's
FLASH_TC_PAIRS = ((64, 64), (128, 128), (192, 128))


def flash_widths(case):
    """A flash case's key and value widths (Dk, Dv)."""
    d = case[6]
    return d if isinstance(d, tuple) else (d, d)


def flash_inputs(torch, case, dtype, dev, seed=21):
    """Q, K, V of a case as ``attention_full`` and ``mla_full`` hand them
    to the kernel: (B, H, S, D) views of (B, S, H, D) projections, V Dv
    wide."""
    _, b, hq, hkv, sq, sk, _, _ = case
    dk, dv = flash_widths(case)
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
    return (rand(b, sq, hq, dk).transpose(1, 2), rand(b, sk, hkv, dk).transpose(1, 2),
            rand(b, sk, hkv, dv).transpose(1, 2))


def sdpa_kernel(torch, fn) -> str:
    """The device kernel that one call of ``fn`` (an SDPA call) spends the
    most time in, by name: which backend SDPA dispatched to."""
    from torch.autograd import DeviceType

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spent = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            spent[e.name()] = spent.get(e.name(), 0) + e.duration_ns()
    return max(spent, key=spent.get)[:60] if spent else "none"


def flash_pairs(case) -> int:
    """The (query, key) pairs a case's mask keeps: causal queries align to
    the keys' suffix."""
    _, b, hq, _, sq, sk, _, causal = case
    if not causal:
        return b * hq * sq * sk
    return b * hq * sum(max(0, min(sk, i + sk - sq + 1)) for i in range(sq))


def check_flash(torch, np, ref, mod, dtype, case, flush, timed, dev):
    """The flash-attention kernel against its plain version on one case;
    timed: the kernel, the plain version, SDPA, and one forward + backward
    through ``FlashAttentionFn`` against SDPA's."""
    _, b, hq, hkv, sq, sk, _, causal = case
    d, dv = flash_widths(case)
    q, k, v = flash_inputs(torch, case, dtype, dev)
    run = lambda: mod.flash_attention(q, k, v, causal=causal)  # noqa: E731
    plain_run = lambda: ref.attention(q, k, v, causal=causal)  # noqa: E731
    before, tc_before = mod.KERNEL.launches, mod.KERNEL.tc_launches
    out, plain = run(), plain_run()
    tc = mod.KERNEL.tc_launches - tc_before
    # comparison launches do not count
    mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
    assert torch.isfinite(out).all() and out.shape == (b, hq, sq, dv)
    res = {"err": (out.float() - plain.float()).abs().max().item(), "tc_launches": tc}
    if dtype == torch.bfloat16:
        res["ulps"] = bf16_ulps(torch, out, plain)
        qi = torch.arange(sq, device=dev)[:, None] + (sk - sq)
        ki = torch.arange(sk, device=dev)[None, :]
        mask = (ki <= qi) if causal else torch.ones(sq, sk, dtype=torch.bool, device=dev)
        kg, vg = (t.repeat_interleave(hq // hkv, dim=1) for t in (k, v))
        res.update(accumulation_controls(torch, q, kg, vg, mask[None, None], plain,
                                         scale=d ** -0.5))
    if timed:
        sdpa = torch.nn.functional.scaled_dot_product_attention
        res["ms"] = time_ms(torch, run, flush=flush)
        res["plain_ms"] = time_ms(torch, plain_run, flush=flush)
        res["library_ms"] = time_ms(torch, lambda: sdpa(
            q, k, v, is_causal=causal, enable_gqa=True), flush=flush)
        res["library_kernel"] = sdpa_kernel(torch, lambda: sdpa(
            q, k, v, is_causal=causal, enable_gqa=True))
        qg, kg, vg = (t.detach().requires_grad_(True) for t in (q, k, v))
        dout = torch.randn(out.shape, device=dev).to(dtype)

        def fwd_bwd(fn):
            return lambda: torch.autograd.grad(fn(), (qg, kg, vg), dout)

        res["fwd_bwd_ms"] = time_ms(torch, fwd_bwd(
            lambda: mod.FlashAttentionFn.apply(qg, kg, vg, causal, None)), flush=flush)
        res["sdpa_fwd_bwd_ms"] = time_ms(torch, fwd_bwd(
            lambda: sdpa(qg, kg, vg, is_causal=causal, enable_gqa=True)), flush=flush)
        mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
        isz = q.element_size()
        nbytes = (q.numel() + k.numel() + v.numel() + out.numel()) * isz
        flops = 2.0 * (d + dv) * flash_pairs(case)  # Q.K^T, then P.V
        res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
    return res


def tile_cost(torch, PF, FA, flush, dev):
    """What one 64-key tile of the walk costs the two tensor-core kernels:
    the chunked prefill at the main path's shapes with every slot's chunk
    at the same start (0 or 960: 0 or 15 prior tiles before its chunk
    tile), and the flash forward over 256 queries and 256 or 2048 keys,
    non-causal (4 or 32 tiles a block).  Returns, for each, (device us a
    tile, us of the rest of the launch) from the two walks' times."""
    g = torch.Generator(device=dev).manual_seed(23)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    max_pages = MAX_LEN // PAGE
    num_pages = SLOTS * max_pages + 1
    tables = (torch.randperm(num_pages - 1, device=dev, generator=g) + 1).int()
    tables = tables.reshape(SLOTS, max_pages)
    kp, vp = rand(HKV, num_pages, PAGE, HEAD_DIM), rand(HKV, num_pages, PAGE, HEAD_DIM)
    q, kn, vn = (rand(SLOTS, h, CHUNK, HEAD_DIM) for h in (HQ, HKV, HKV))
    lens = torch.full((SLOTS,), CHUNK, dtype=torch.int32, device=dev)
    out = {}
    before = (PF.KERNEL.launches, PF.KERNEL.tc_launches, FA.KERNEL.launches,
              FA.KERNEL.tc_launches)
    ms = []
    for start in (0, MAX_LEN - CHUNK):
        st = torch.full((SLOTS,), start, dtype=torch.int32, device=dev)
        ms.append(time_ms(torch, lambda: PF.prefill_attention(  # noqa: B023
            q, kn, vn, kp, vp, tables, st, lens), flush=flush))
    per = (ms[1] - ms[0]) / ((MAX_LEN - CHUNK) // 64) * 1e3
    out["prefill"] = (per, ms[0] * 1e3 - per)
    ms = []
    qf = rand(TRAIN_BATCH, HQ, 256, HEAD_DIM)
    for sk in (256, 2048):
        k, v = rand(TRAIN_BATCH, HKV, sk, HEAD_DIM), rand(TRAIN_BATCH, HKV, sk, HEAD_DIM)
        ms.append(time_ms(torch, lambda: FA.flash_attention(qf, k, v), flush=flush))  # noqa: B023
    per = (ms[1] - ms[0]) / (2048 // 64 - 256 // 64) * 1e3
    out["flash"] = (per, ms[0] * 1e3 - 4 * per)
    (PF.KERNEL.launches, PF.KERNEL.tc_launches, FA.KERNEL.launches,
     FA.KERNEL.tc_launches) = before
    return out


def mla_tile_cost(torch, MF, flush, dev):
    """What one 32-key tile of the walk costs the tensor-core MLA prefill:
    its launch at deepseek-v2-lite-16B's serving shape (bf16, slots 8,
    chunk 64, 16 heads over R 512 + Dpe 64) with every slot's chunk live
    and at the same start, 0 or 960 (0 or 30 prior tiles before its chunk
    tiles: 2 for the longest block).  Returns (device us a tile, us of the
    rest of the launch) from the two walks' times."""
    g = torch.Generator(device=dev).manual_seed(25)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    max_pages = MAX_LEN // PAGE
    num_pages = SLOTS * max_pages + 1
    tables = (torch.randperm(num_pages - 1, device=dev, generator=g) + 1).int()
    tables = tables.reshape(SLOTS, max_pages)
    q, qpe = rand(SLOTS, MLA_HEADS, CHUNK, RANK), rand(SLOTS, MLA_HEADS, CHUNK, ROPE)
    cn, pn = rand(SLOTS, CHUNK, RANK), rand(SLOTS, CHUNK, ROPE)
    cp, pp = rand(num_pages, PAGE, RANK), rand(num_pages, PAGE, ROPE)
    lens = torch.full((SLOTS,), CHUNK, dtype=torch.int32, device=dev)
    before = (MF.KERNEL.launches, MF.KERNEL.tc_launches)
    ms = []
    for start in (0, MAX_LEN - CHUNK):
        st = torch.full((SLOTS,), start, dtype=torch.int32, device=dev)
        ms.append(time_ms(torch, lambda: MF.mla_prefill(  # noqa: B023
            q, qpe, cn, pn, cp, pp, tables, st, lens, sm_scale=MLA_SCALE), flush=flush))
    assert MF.KERNEL.tc_launches > before[1]
    MF.KERNEL.launches, MF.KERNEL.tc_launches = before
    per = (ms[1] - ms[0]) / ((MAX_LEN - CHUNK) // MF.TC_KEYS) * 1e3
    return per, ms[0] * 1e3 - CHUNK // MF.TC_KEYS * per


def quant_tile_cost(torch, ref, PFQ, flush, dev, fmt="int8"):
    """tile_cost's prefill reading for the quantized twin's tensor-core
    path: the same launches with the pools and the chunk quantized (int8),
    starts 0 and 960.  Returns (device us a 64-key tile, us of the rest of
    the launch)."""
    g = torch.Generator(device=dev).manual_seed(27)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    max_pages = MAX_LEN // PAGE
    num_pages = SLOTS * max_pages + 1
    tables = (torch.randperm(num_pages - 1, device=dev, generator=g) + 1).int()
    tables = tables.reshape(SLOTS, max_pages)
    (kq, ks), (vq, vs) = (ref.quantize_rows(rand(HKV, num_pages, PAGE, HEAD_DIM), fmt)
                          for _ in range(2))
    (knq, kns), (vnq, vns) = (ref.quantize_rows(rand(SLOTS, HKV, CHUNK, HEAD_DIM), fmt)
                              for _ in range(2))
    q = rand(SLOTS, HQ, CHUNK, HEAD_DIM)
    lens = torch.full((SLOTS,), CHUNK, dtype=torch.int32, device=dev)
    before = (PFQ.KERNEL.launches, PFQ.KERNEL.tc_launches)
    ms = []
    for start in (0, MAX_LEN - CHUNK):
        st = torch.full((SLOTS,), start, dtype=torch.int32, device=dev)
        ms.append(time_ms(torch, lambda: PFQ.prefill_attention_quant(  # noqa: B023
            q, knq, vnq, kns, vns, kq, vq, ks, vs, tables, st, lens, fmt=fmt), flush=flush))
    assert PFQ.KERNEL.tc_launches > before[1]
    PFQ.KERNEL.launches, PFQ.KERNEL.tc_launches = before
    per = (ms[1] - ms[0]) / ((MAX_LEN - CHUNK) // 64) * 1e3
    return per, ms[0] * 1e3 - per


def scan_phase_cost(torch, CSC, flush, dev):
    """Where a tensor-core chunk_scan launch's time goes at mamba2-2.7B's
    training shapes (batch 8, 8 chunks of 128, N 128, P 64, bf16, C and B
    broadcast over the heads): the launch with 80 and with 40 heads, both
    in 2 head groups a (batch, chunk) (128 blocks), so a block walks 40 or
    20 heads after its one C B^T.  Returns (device us a head of a block's
    walk, us of the rest of the launch: C and B in, C B^T, the first
    head's operands, the launch)."""
    g = torch.Generator(device=dev).manual_seed(29)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    b, nc, length, n, p = TRAIN_BATCH, TRAIN_SEQ // 128, 128, 128, 64
    before = (CSC.KERNEL.launches, CSC.KERNEL.tc_launches)
    ms = []
    for heads in (80, 40):
        cm, bm = (rand(b, 1, nc, length, n).bfloat16().expand(b, heads, nc, length, n)
                  for _ in range(2))
        x = rand(b, heads, nc, length, p).bfloat16()
        da = torch.cumsum(-0.7 * rand(b, heads, nc, length).abs(), dim=-1)
        prev = rand(b, heads, nc, n, p)
        ms.append(time_ms(torch, lambda: CSC.chunk_scan(cm, bm, x, da, prev),  # noqa: B023
                          flush=flush))
        del cm, bm, x, da, prev
    assert CSC.KERNEL.tc_launches == before[1] + CSC.KERNEL.launches - before[0]
    CSC.KERNEL.launches, CSC.KERNEL.tc_launches = before
    per = (ms[0] - ms[1]) / 20 * 1e3
    return per, ms[1] * 1e3 - 20 * per


def split_cost(torch, run, split_key, flush, calls=20):
    """The device us a call of a split-KV decode's two kernels: the split
    kernel (its name holds ``split_key``) and the merge, from
    torch.profiler's device rows over ``calls`` calls of ``run``, L2
    flushed before each."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    run()  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            flush()
            run()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    return {part: sum(e.self_device_time_total for e in rows if key in e.key) / calls
            for part, key in (("split", split_key), ("merge", "merge_kernel"))}


def decode_cost(torch, np, ref, PA, PAQ, flush, dev, calls=20):
    """Where a bf16 decode launch's device time goes at check_decode's
    inputs (window None): split_cost's reading for the decode and for its
    int8 twin on the same values quantized, {"fp": ..., "int8": ...}."""
    rng = np.random.default_rng(1)
    tables, num_pages = _tables(torch, rng, dev)
    lens = rng.integers(1, MAX_LEN + 1, size=SLOTS).astype("int32")
    lens[2], lens[5] = 0, MAX_LEN
    g = torch.Generator(device=dev).manual_seed(2)
    q = torch.randn((SLOTS, HQ, HEAD_DIM), generator=g, device=dev).bfloat16()
    kp, vp = (torch.randn((HKV, num_pages, PAGE, HEAD_DIM), generator=g, device=dev).bfloat16()
              for _ in range(2))
    lens_t = torch.as_tensor(lens, device=dev)
    (kq, ks), (vq, vs) = _quantized(torch, ref, (kp, vp), "int8")
    before = [(m.KERNEL.launches, m.KERNEL.tc_launches) for m in (PA, PAQ)]
    cost = {"fp": split_cost(torch, lambda: PA.paged_attention(q, kp, vp, tables, lens_t),
                             "paged_attention_kernel", flush, calls),
            "int8": split_cost(torch, lambda: PAQ.paged_attention_quant(
                q, kq, vq, ks, vs, tables, lens_t, fmt="int8"),
                "paged_attention_kernel", flush, calls)}
    assert PA.KERNEL.tc_launches > before[0][1] and PAQ.KERNEL.tc_launches > before[1][1]
    for m, b in zip((PA, PAQ), before):
        m.KERNEL.launches, m.KERNEL.tc_launches = b
    return cost


def mla_decode_cost(torch, np, ref, MP, MPQ, flush, dev, calls=20):
    """decode_cost's reading for the bf16 MLA decode and its int8 twin at
    check_mla_decode's inputs (window None): {"fp": ..., "int8": ...}."""
    rng = np.random.default_rng(11)
    tables, num_pages = _tables(torch, rng, dev)
    lens = rng.integers(1, MAX_LEN + 1, size=SLOTS).astype("int32")
    lens[2], lens[5] = 0, MAX_LEN
    g = torch.Generator(device=dev).manual_seed(12)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    q, qpe = rand(SLOTS, MLA_HEADS, RANK), rand(SLOTS, MLA_HEADS, ROPE)
    ckv, kpe = rand(num_pages, PAGE, RANK), rand(num_pages, PAGE, ROPE)
    lens_t = torch.as_tensor(lens, device=dev)
    kw = {"sm_scale": MLA_SCALE}
    (cq, cs_), (pq, ps_) = ref.quantize_rows(ckv, "int8"), ref.quantize_rows(kpe, "int8")
    before = [(m.KERNEL.launches, m.KERNEL.tc_launches) for m in (MP, MPQ)]
    cost = {"fp": split_cost(torch, lambda: MP.mla_paged(q, qpe, ckv, kpe, tables, lens_t, **kw),
                             "mla_paged_tc_kernel", flush, calls),
            "int8": split_cost(torch, lambda: MPQ.mla_paged_quant(
                q, qpe, cq, pq, cs_, ps_, tables, lens_t, fmt="int8", **kw),
                "mla_paged_tc_kernel", flush, calls)}
    assert MP.KERNEL.tc_launches > before[0][1] and MPQ.KERNEL.tc_launches > before[1][1]
    for m, b in zip((MP, MPQ), before):
        m.KERNEL.launches, m.KERNEL.tc_launches = b
    return cost


# phase 2, SSD: the Mamba-2 chunk kernels at mamba2-2.7B's training shapes
# ---------------------------------------------------------------------------

# (label, arch, batch, seq, decay): the SSD operands of one seeded
# full-width layer of ``arch`` (its projections, causal conv and softplus
# on an input of unit RMS), as ``layers._ssd_batched`` hands them to the
# kernels, so the decay is the model's own ("deep": dt near 0.7 a step,
# dA_cum near -90 by a chunk's end, exp(dA) below fp32's smallest normal);
# "shallow" keeps the shapes but draws C, B and X from N(0, 1) and lets dA
# fall by 0.1 |N(0, 1)| a step (tests/test_kernels.py:367's magnitude, with
# the sign of a decay: Mamba's dA = dt * -exp(a_log) is never positive).
# A chunk of 64 (seq 192: the layer's gcd(192, 128) rule) is checked too,
# and HYMBA_SSD_CASE, hymba-1.5B's training shapes (N 16 and P 50: rows of
# 100 bytes in bf16), by the hybrid's phase 2 checks.  "growing" is that
# test's own sign, dA rising by 0.1 |N(0, 1)| a step, with N(0, 1) carried
# states: the decay factors reach e^10 a chunk and each output sums terms up
# to ~1e7 that cancel, so an element's bf16 ulp can lie below what fp32 sums
# in any order resolve; its bf16 reading is printed beside the plain
# version's own distance from an fp64 evaluation, and only its fp32 pass
# is gated.
SSD_CASES = (
    ("mamba2 training, deep decay", "mamba2_2_7b", TRAIN_BATCH, TRAIN_SEQ, "deep"),
    ("mamba2 training, shallow decay", "mamba2_2_7b", TRAIN_BATCH, TRAIN_SEQ, "shallow"),
    ("chunk 64 (seq 192)", "mamba2_2_7b", 2, 192, "deep"),
    ("mamba2 training, growing dA", "mamba2_2_7b", TRAIN_BATCH, TRAIN_SEQ, "growing"),
)
HYMBA_SSD_CASE = ("hymba training", "hymba_1_5b", TRAIN_BATCH, TRAIN_SEQ, "deep")


def ssd_operands(torch, case, dtype, dev, seed=31):
    """One case's kernel operands: C and B as head-broadcast (``expand``ed,
    head stride 0) views (B, H, nc, L, N), X (B, H, nc, L, P) in ``dtype``,
    dA_cum (B, H, nc, L) fp32, and the carried states (the plain chunk_state
    and state recurrence of them)."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.models import layers as L

    _, arch, b, s, decay = case
    cfg = dataclasses.replace(get_config(arch), dtype=str(dtype)[6:])
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *shape: torch.randn(shape, generator=g, device=dev)  # noqa: E731
    params = L.init_mamba2(g, cfg)
    h = L.rmsnorm(rand(b, s, cfg.d_model).to(dtype),
                  torch.ones(cfg.d_model, dtype=dtype, device=dev), cfg.norm_eps)
    _, xh, ch, bh, dth, chunk = L.mamba2_ssd_inputs(params, h, cfg)
    xdt = xh * dth[..., None].to(xh.dtype)
    cc, bb, xx, da = L.ssd_operands(ch, bh, xdt, dth, params["a_log"], chunk)
    prev = None
    if decay in ("shallow", "growing"):
        one_head = (cc.shape[0], 1) + tuple(cc.shape[2:])
        cc, bb = (rand(*one_head).to(dtype).expand(cc.shape) for _ in range(2))
        xx = rand(*xx.shape).to(dtype)
        step = 0.1 * rand(*da.shape).abs()
        da = torch.cumsum(step if decay == "growing" else -step, dim=-1)
        if decay == "growing":  # recurred states would overflow: N(0, 1)
            prev = rand(*xx.shape[:-2], cc.shape[-1], xx.shape[-1])
    if prev is None:
        prev = ref.state_recurrence(ref.chunk_state(bb, xx, da), da[..., -1])
    return cc, bb, xx, da.contiguous(), prev


def handed_bytes(t) -> int:
    """Bytes of the storage a view reads: a broadcast (stride-0) dimension
    counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        n *= size if stride else 1
    return n * t.element_size()


def scan_variant(torch, c, b, x, da, prev, *, acc=None, scores=None,
                 causal=True):
    """``ref.chunk_scan``'s arithmetic with one thing changed: ``acc`` the
    dtype it computes in (fp64: the value fp32 sums approximate);
    ``scores`` a dtype the decayed scores are rounded to before their
    product with X (bf16: the control a bf16 limit must reject); or
    ``causal=False``, the decay still selected before the exp but the upper
    triangle kept (a planted fault: later rows leak into earlier ones)."""
    acc = acc or torch.float32
    cf, bf, xf, pf, df = (t.to(acc) for t in (c, b, x, prev, da))
    n = x.shape[-2]
    y = torch.einsum("...cln,...cnp->...clp", cf, pf) * torch.exp(df)[..., None]
    seg = df[..., :, None] - df[..., None, :]
    mask = torch.ones((n, n), dtype=torch.bool, device=x.device).tril()
    att = torch.einsum("...cln,...cmn->...clm", cf, bf) * torch.exp(torch.where(mask, seg, 0.0))
    if causal:
        att = torch.where(mask, att, 0.0)
    if scores is not None:
        att = att.to(scores).to(acc)
    return (y + torch.einsum("...clm,...cmp->...clp", att, xf)).to(x.dtype)


def state_variant(torch, b, x, da, xd_dtype):
    """``ref.chunk_state`` with the decay on X, Xd = exp(dA_last - dA_l) X_l
    in fp32, rounded once to ``xd_dtype`` before B^T Xd (bf16: the control
    the tensor-core kernel's pair hi + lo avoids)."""
    decay = torch.exp(da[..., -1:] - da)
    xd = (x.float() * decay[..., None]).to(xd_dtype).float()
    return torch.einsum("...cln,...clp->...cnp", b.float(), xd)


def check_ssd(torch, np, ref, mods, dtype, case, flush, timed, dev):
    """chunk_state and chunk_scan (modules ``mods``) against their plain
    versions on one case's operands.  Returns {kernel: result}; timed: the
    kernel, the plain version and, as a labelled yardstick, the bf16 cuBLAS
    products its work reduces to (B^T X for chunk_state; C B^T, its product
    with X and C S_prev for chunk_scan, per batch, head and chunk, without
    the decay), and the bound from the bytes handed over (a broadcast B or
    C once) and the causal pairs' operations."""
    cst, csc = mods
    cc, bb, xx, da, prev = ssd_operands(torch, case, dtype, dev)
    bsz, heads, nc, length, n = cc.shape
    p = xx.shape[-1]
    runs = {"chunk_state": (cst, lambda: cst.chunk_state(bb, xx, da),
                            lambda: ref.chunk_state(bb, xx, da)),
            "chunk_scan": (csc, lambda: csc.chunk_scan(cc, bb, xx, da, prev),
                           lambda: ref.chunk_scan(cc, bb, xx, da, prev))}
    out = {}
    for name, (mod, run, plain_run) in runs.items():
        before, tc_before = mod.KERNEL.launches, mod.KERNEL.tc_launches
        got, want = run(), plain_run()
        tc = mod.KERNEL.tc_launches - tc_before
        mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before  # comparisons do not count
        assert got.shape == want.shape and got.dtype == want.dtype, name
        assert torch.isfinite(got).all(), name
        res = {"err": (got.float() - want.float()).abs().max().item(),
               "scale": max(1.0, want.float().abs().max().item()),
               "da_min": da.min().item(), "tc_launches": tc}
        if name == "chunk_state" and dtype == torch.bfloat16:
            # the control: Xd = exp(dA_last - dA_l) X_l rounded once to bf16
            # (the kernel multiplies it as the pair hi + lo) must fail the
            # limit wherever the kernel takes the tensor cores
            res["bf16_xd_rel"] = (state_variant(torch, bb, xx, da, torch.bfloat16)
                                  - want).abs().max().item() / res["scale"]
            res["xd_gated"] = ssd_takes_tensor_cores(case, "bfloat16")
        if got.dtype == torch.bfloat16:
            res["ulps"] = bf16_ulps(torch, got, want)
            res["bf16_scores_ulps"] = bf16_ulps(torch, scan_variant(
                torch, cc, bb, xx, da, prev, scores=torch.bfloat16), want)
            # both sides' distance from an fp64 evaluation (printed): two fp32
            # sum orders straddle a bf16 rounding where a row's terms cancel
            f64 = scan_variant(torch, cc, bb, xx, da, prev, acc=torch.float64)
            res["plain_vs_f64_ulps"] = bf16_ulps(torch, want, f64)
            res["kernel_vs_f64_ulps"] = bf16_ulps(torch, got, f64)
            res["gated"] = case[-1] != "growing"
            del f64
        if timed:
            res["ms"] = time_ms(torch, run, flush=flush)
            res["plain_ms"] = time_ms(torch, plain_run, flush=flush)
            pairs = length * (length + 1) // 2
            blocks = bsz * heads * nc
            if name == "chunk_state":
                bt = bb.transpose(-1, -2).contiguous()
                yard = lambda: torch.matmul(bt, xx)  # noqa: E731
                ins = (bb, xx, da)
                flops = 2.0 * blocks * length * n * p
            else:
                c_c, b_t = cc.contiguous(), bb.transpose(-1, -2).contiguous()
                s16 = prev.to(dtype)
                yard = lambda: (torch.matmul(torch.matmul(c_c, b_t), xx),  # noqa: E731
                                torch.matmul(c_c, s16))
                ins = (cc, bb, xx, da, prev)
                flops = 2.0 * blocks * (pairs * n + pairs * p + length * n * p)
            # no single PyTorch call computes the function: the yardstick is
            # labelled apart and library_ms stays null
            res["yardstick_ms"] = time_ms(torch, yard, flush=flush)
            res["library_ms"] = None
            mod.KERNEL.launches, mod.KERNEL.tc_launches = before, tc_before
            nbytes = sum(handed_bytes(t) for t in ins) + got.numel() * got.element_size()
            res["bytes"], res["flops"] = nbytes, flops
            res["bound_ms"], res["bound_by"] = bound(nbytes, flops, BF16_FLOPS)
        out[name] = res
    return out


def ssd_ok(r) -> bool:
    """bf16 outputs within BF16_ULPS of the plain value, with the control
    that rounds the decayed scores once to bf16 outside it (the growing
    case's bf16 reading is printed, not gated: see SSD_CASES); fp32 outputs
    within FP32_ATOL of max(1, max |plain|)."""
    if not r.get("gated", True):
        return True
    if "ulps" in r:
        return r["ulps"] <= BF16_ULPS and r["bf16_scores_ulps"] > BF16_ULPS
    if r.get("xd_gated") and r["bf16_xd_rel"] <= FP32_ATOL:
        return False
    return r["err"] <= FP32_ATOL * r["scale"]


def ssd_takes_tensor_cores(case, dtype) -> bool:
    """Whether chunk_state's and chunk_scan's launches on ``case``'s
    operands must take their tensor-core paths: bf16 at mamba2-2.7B's N 128
    / P 64 (chunks of 128 or 64); hymba-1.5B's P 50 and fp32 stay on CUDA
    cores."""
    return dtype == "bfloat16" and case[1] == "mamba2_2_7b"


# ---------------------------------------------------------------------------
# phase 3: serving
# ---------------------------------------------------------------------------


# Token ids are drawn from qwen2-1.5B's vocabulary whatever the model, and
# folded into a smaller one, so the prompt lengths (drawn from the same
# generator) and with them the schedule stay those of the card's run.
WORKLOAD_VOCAB = 151936


def workload(rng, vocab: int, n: int = 16, shared_len: int = 256):
    """``n`` prompts of 100-600 tokens; every other one is one shared
    ``shared_len``-token prefix plus its own tail (300-600 tokens in all).
    Ids are drawn below WORKLOAD_VOCAB and taken modulo ``vocab``."""
    draw = lambda size: (rng.integers(0, WORKLOAD_VOCAB, size=size) % vocab).tolist()  # noqa: E731
    shared = draw(shared_len)
    prompts = []
    for i in range(n):
        if i % 2 == 0:
            tail = int(rng.integers(300, 601)) - shared_len
            prompts.append(shared + draw(tail))
        else:
            prompts.append(draw(int(rng.integers(100, 601))))
    return prompts


def serve(torch, np, cfg, params, kernels, device, max_new=32, requests=16,
          **serve_kw):
    """One serving run of the workload's first ``requests`` prompts;
    ``serve_kw`` go to ServeConfig."""
    from repro_torch.serving import ServeConfig, ServingEngine

    scfg = ServeConfig(slots=SLOTS, max_len=MAX_LEN, prefill_chunk=CHUNK,
                       max_new_tokens=max_new, page_size=PAGE, **serve_kw)
    engine = ServingEngine(cfg, params, scfg, device=device)
    prompts = workload(np.random.default_rng(0), cfg.vocab_size)[:requests]
    reqs = [engine.submit(p) for p in prompts]
    for k in kernels.values():
        k.launches = k.tc_launches = 0
    if device.type == "cuda":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.run()
    if device.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: k.launches for name, k in kernels.items()}
    return engine, reqs, dt, launches


FP_KERNELS = ("paged_attention", "prefill_attention")
TC_KERNELS = ("prefill_attention", "paged_attention")  # all bf16 launches on tensor cores
QUANT_KERNELS = ("paged_attention_quant", "prefill_attention_quant")
QUANT_TC_KERNELS = QUANT_KERNELS  # all their bf16 launches on tensor cores
MLA_FP_KERNELS = ("mla_paged", "mla_prefill")
MLA_QUANT_KERNELS = ("mla_paged_quant", "mla_prefill_quant")
MLA_TC_KERNELS = MLA_FP_KERNELS + MLA_QUANT_KERNELS  # all bf16 launches at deepseek's widths
FP_BUDGET_BLOCKS = int(0.39 * SLOTS * (MAX_LEN // PAGE))  # 199: fp preempts
# Cuts that keep the whole script within half its 1200 s limit on a slow
# host (a run on an H100 80GB HBM3 at 700 W took 810 s without them, 275 s
# of it serving mamba2):
# qwen2-1.5B served 14 of its 28 layers, deepseek-v2-lite-16B 14 of its 27
# (the dense first layer and 13 MoE layers), and mamba2-2.7B serves the first 8 of the
# workload's 16 requests (one full batch of slots; its prompts replay a
# token a tick, so its ticks follow the longest prompt) over 16 of its 64
# layers: with hymba-1.5B's phase 7 (its 32 layers serve uncut) a slow
# host took 790 s, 120 s of it serving mamba2 at 64 layers, a host-bound
# run whose checks (byte identity, no host sync in a window, no kernel
# launch) do not depend on depth; qwen's host-bound serving runs (111.5 s
# of a slow host's 644 s) were then halved to keep its [time] lines within
# 600 s.  A serving run's ticks and preemptions depend on prompt lengths
# and block counts, not on depth.  With phases 8-10 (granite, whisper,
# internvl2: ~85 s) added, hymba-1.5B's host-bound serving (102-150 s at
# its 32 layers) serves 8 of them; a run so cut read 495 s of [time] lines
# on a host ~1.2x slower than the fastest seen, ~620 s on the slowest,
# so qwen2-1.5B and deepseek-v2-lite-16B serve 7 layers each (49.3 and
# 55.3 s at 14 there), and granite-moe-3b-a800m all of its 32 (47.7 s).
# With phases 11 and 12 (the dense configs, sampling and speculation: 70.1
# s on a host where the whole run read 442.9 s), granite serves 16 of its
# 32 layers (68.2 s at 32 on the slow host) and hymba-1.5B 4 of its 32
# (48.6 s at 8 there).  With phase 13 (fault tolerance and the contiguous
# cache: 17.0 s of a run whose [time] lines read 449.6 s), qwen2-1.5B and
# deepseek-v2-lite-16B serve 4 layers each (deepseek: the dense first layer
# and 3 MoE layers).
QWEN_SERVE_LAYERS = 4
MLA_SERVE_LAYERS = 4
SSM_SERVE_REQUESTS = 8
SSM_SERVE_LAYERS = 16
HYBRID_SERVE_LAYERS = 4
GRANITE_SERVE_LAYERS = 16


@contextlib.contextmanager
def no_host_sync(torch, device):
    """On a card, any operation that makes the host wait for the device
    raises inside the block (torch.cuda.set_sync_debug_mode)."""
    if device.type != "cuda":
        yield
        return
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


@contextlib.contextmanager
def strict_windows(torch, lm, device, name="decode_loop"):
    """Every multi-step window (``lm.decode_loop``, or the speculative
    ``lm.spec_decode_loop``) runs under no_host_sync."""
    loop = getattr(lm, name)

    def strict_loop(*a, **kw):  # a window must never wait for the host
        with no_host_sync(torch, device):
            return loop(*a, **kw)

    setattr(lm, name, strict_loop)
    try:
        yield
    finally:
        setattr(lm, name, loop)


def mean_ttft(reqs) -> float:
    return sum(r.ttft_ticks for r in reqs) / len(reqs)


def make_runner(torch, np, cfg, params, kernels, device, runs):
    """A function serving one labelled run of the workload through its
    path's kernels: it logs the run, checks every request completed, that
    exactly ``path_kernels`` launched (on the CPU: none), once per layer a
    step, and keeps (engine, requests, seconds, launches) in ``runs``."""

    def run(label, path_kernels, tc_kernels=(), **kw):
        engine, reqs, dt, launches = serve(torch, np, cfg, params, kernels,
                                           device, **kw)
        tc = {k: kernels[k].tc_launches for k in tc_kernels}
        toks = sum(len(r.output) for r in reqs)
        if engine.pool is not None:
            memory = (f"{engine.preemptions} preemptions, {engine.pages_shared} "
                      f"pages shared, peak {engine.peak_kv_blocks()} of "
                      f"{engine.pool.num_blocks} blocks of {engine.pool.page_bytes} "
                      f"bytes ({engine.cache.kv_bytes()} KV bytes)")
        else:
            memory = f"{engine.cache.kv_bytes()} bytes of contiguous cache"
        if device.type == "cuda":
            memory += (f", device peak {torch.cuda.max_memory_allocated() / 2**30:.2f}"
                       " GiB allocated")
        log(f"[serve] {cfg.name} {label}: {len(reqs)} requests, {toks} tokens in "
            f"{dt:.2f} s ({toks / dt:.1f} tok/s), {engine.steps_run} ticks, "
            f"{engine.dispatches} dispatches, mean TTFT {mean_ttft(reqs):.2f} "
            f"ticks, {memory}, launches {launches}"
            + (f", of them on tensor cores {tc}" if tc else ""))
        assert all(r.status == "completed" and len(r.output) == 32 for r in reqs), \
            [(r.uid, r.status, r.error) for r in reqs if r.status != "completed"]
        # the run went through its path's kernels and no other (on the CPU,
        # the plain versions: no kernel launches), each once a layer a step
        launched = {k for k, n in launches.items() if n > 0}
        assert launched == set(path_kernels if device.type == "cuda" else ()), launches
        assert all(n % cfg.num_layers == 0 for n in launches.values()), launches
        # every launch of ``tc_kernels`` took its tensor-core path
        assert all(n == launches[k] for k, n in tc.items()), (tc, launches)
        runs[label] = (engine, reqs, dt, launches)
        return engine, reqs

    return run


def serving_phase(torch, np, lm, cfg, params, kernels, device):
    """Phase 3, qwen2-1.5B: the six serving runs and their checks.  Returns
    the runs by label as (engine, requests, seconds, launches)."""
    from repro_torch.serving.paged_cache import blocks_for_bytes

    runs = {}
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    fp, fp_reqs = run("fp, default pool", FP_KERNELS, TC_KERNELS)
    fp_tight, _ = run(f"fp, {FP_BUDGET_BLOCKS} blocks", FP_KERNELS, TC_KERNELS,
                      num_blocks=FP_BUDGET_BLOCKS)
    assert fp.pages_shared > 0 and fp_tight.preemptions > 0
    for fmt in ("int8", "int4"):
        eng, reqs = run(f"{fmt}, default pool", QUANT_KERNELS, QUANT_TC_KERNELS, kv_dtype=fmt)
        same = sum(a.output == b.output for a, b in zip(reqs, fp_reqs))
        toks = sum(len(r.output) for r in reqs)
        match = sum(x == y for a, b in zip(reqs, fp_reqs)
                    for x, y in zip(a.output, b.output))
        log(f"[serve] {fmt} vs fp: {eng.cache.kv_bytes() / fp.cache.kv_bytes():.3f}x "
            f"the KV bytes; tokens equal to fp's {match}/{toks}, requests equal "
            f"{same}/{len(reqs)}")
        assert eng.steps_run == fp.steps_run and mean_ttft(reqs) == mean_ttft(fp_reqs)
    q8, q8_reqs = runs["int8, default pool"][:2]
    nb = blocks_for_bytes(FP_BUDGET_BLOCKS * fp.pool.page_bytes, q8.pool.page_bytes)
    q8_tight, _ = run(f"int8 at the bytes of fp's {FP_BUDGET_BLOCKS} pages "
                      f"({nb} blocks)", QUANT_KERNELS, QUANT_TC_KERNELS, kv_dtype="int8",
                      num_blocks=nb)
    assert q8_tight.preemptions < fp_tight.preemptions
    with strict_windows(torch, lm, device):
        win, win_reqs = run("int8, sync_every=16", QUANT_KERNELS, QUANT_TC_KERNELS,
                            kv_dtype="int8", sync_every=16)
    assert win.decode_windows > 0 and win.dispatches < q8.dispatches
    assert [r.output for r in win_reqs] == [r.output for r in q8_reqs]
    log(f"[serve] int8 sync_every=16: outputs byte-identical to per-tick int8; "
        f"{win.dispatches} dispatches ({win.decode_windows} windows, no host "
        f"sync inside) against {q8.dispatches}")
    return runs


def mla_serving_phase(torch, np, lm, cfg, params, kernels, device):
    """Phase 3, deepseek-v2-lite-16B (MLA + MoE): the qwen workload in fp,
    int8 and int4 latent pages, and int8 with the multi-step window under
    the no-host-sync check.  Ticks and mean TTFT are equal across the four
    (scheduling depends only on the prompt lengths); the window's outputs
    are byte-identical to per-tick int8's with fewer host dispatches."""
    runs = {}
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    fp, fp_reqs = run("fp", MLA_FP_KERNELS, MLA_FP_KERNELS)
    for fmt in ("int8", "int4"):
        eng, reqs = run(fmt, MLA_QUANT_KERNELS, MLA_QUANT_KERNELS, kv_dtype=fmt)
        log(f"[serve] {cfg.name} {fmt} vs fp: "
            f"{eng.cache.kv_bytes() / fp.cache.kv_bytes():.3f}x the KV bytes")
        assert eng.steps_run == fp.steps_run and mean_ttft(reqs) == mean_ttft(fp_reqs)
    q8, q8_reqs = runs["int8"][:2]
    with strict_windows(torch, lm, device):
        win, win_reqs = run("int8, sync_every=16", MLA_QUANT_KERNELS, MLA_QUANT_KERNELS,
                            kv_dtype="int8", sync_every=16)
    assert win.steps_run == fp.steps_run and mean_ttft(win_reqs) == mean_ttft(fp_reqs)
    assert win.decode_windows > 0 and win.dispatches < q8.dispatches
    assert [r.output for r in win_reqs] == [r.output for r in q8_reqs]
    log(f"[serve] {cfg.name} int8 sync_every=16: outputs byte-identical to "
        f"per-tick int8; {win.dispatches} dispatches ({win.decode_windows} "
        f"windows, no host sync inside) against {q8.dispatches}")
    for label, (_, _, _, launches) in runs.items():
        log(f"[serve] {cfg.name} {label}: " + ", ".join(
            f"{k} {n} ({n // cfg.num_layers} steps x {cfg.num_layers} layers)"
            for k, n in launches.items() if n))
    return runs


# ---------------------------------------------------------------------------
# phase 12: sampling and speculative decoding (qwen2-1.5B, deepseek-v2-lite)
# ---------------------------------------------------------------------------

SAMPLE_T, SAMPLE_TOP_K, SAMPLE_TOP_P = 0.8, 50, 0.95
SAMPLE_KEYS = 16  # logits tensors of SLOTS rows drawn from on the card and the CPU
SAMPLE_TIE_GAP = 1e-5  # a perturbed top-2 gap under which the two may pick apart
# the sampled runs serve one batch of slots (no request waits in the queue,
# so the window's key stream is per-tick stepping's, lm.decode_loop)
SAMPLE_REQUESTS = SLOTS
SPEC_DRAFT, SPEC_SYNC = 4, 4
# The sampled runs scale the final norm's weight: with tied N(0, 1)
# embeddings a token's own logit is ~d (1536 for qwen2-1.5B) against the
# others' standard deviation ~sqrt(d), so a draw at temperature 0.8 always
# takes the argmax (greedy's token, which a uniform scale keeps); scaled by
# 0.005 the own logit is ~8 and the draws spread over the vocabulary (at
# 0.02 the runs' 8 streams all still equalled greedy's, H100 80GB HBM3,
# 700 W).
SAMPLE_NORM_SCALE = 0.005


def spread_logits(params):
    """``params`` with the final norm's weight scaled by SAMPLE_NORM_SCALE
    (the other leaves shared)."""
    return {**params, "final_norm": params["final_norm"] * SAMPLE_NORM_SCALE}


def prng_check(torch, device) -> int:
    """The card's threefry against the CPU's, bit for bit: split keys,
    random bits and uniforms for a few keys and shapes.  Returns the 32-bit
    words compared."""
    from repro_torch.serving import prng

    words = 0
    for seed in (0, 3, 2 ** 31 - 1):
        kc, kd = prng.key(seed), prng.key(seed, device)
        pairs = [(prng.split(kc, 7), prng.split(kd, 7))]
        for shape in ((5,), (3, 1000), (SLOTS, WORKLOAD_VOCAB)):
            pairs.append((prng.random_bits(kc, shape), prng.random_bits(kd, shape)))
            pairs.append((prng.uniform(kc, shape).view(torch.int32),
                          prng.uniform(kd, shape).view(torch.int32)))
        for want, got in pairs:
            assert torch.equal(got.cpu(), want), (seed, tuple(want.shape))
            words += want.numel()
    return words


def sample_check(torch, device, keys=SAMPLE_KEYS):
    """``sample`` at SAMPLE_T, top-k SAMPLE_TOP_K and top-p SAMPLE_TOP_P on
    seeded logits on the card against the same logits on the CPU.  A row
    may differ only where the CPU's perturbed logits (cut logits plus the
    key's gumbel noise) have their top two within SAMPLE_TIE_GAP.  Returns
    (rows, rows that differ, rows at such a near-tie)."""
    from repro_torch.serving import prng, sampling

    g = torch.Generator(device=device).manual_seed(13)
    rows = differ = ties = 0
    for k in range(keys):
        logits = torch.randn((SLOTS, WORKLOAD_VOCAB), generator=g, device=device) * 4
        kw = dict(temperature=SAMPLE_T, top_k=SAMPLE_TOP_K, top_p=SAMPLE_TOP_P)
        got = sampling.sample(logits, prng.key(k, device), **kw).cpu()
        cpu = logits.cpu()
        want = sampling.sample(cpu, prng.key(k), **kw)
        cut = sampling.cut_logits(cpu, SAMPLE_T, SAMPLE_TOP_K, SAMPLE_TOP_P)
        top2 = (cut + prng.gumbel(prng.key(k), cut.shape)).topk(2).values
        near = (top2[:, 0] - top2[:, 1]) < SAMPLE_TIE_GAP
        apart = got != want
        assert not (apart & ~near).any(), (k, got, want)
        rows += SLOTS
        differ += int(apart.sum())
        ties += int(near.sum())
    return rows, differ, ties


def replay_logits(torch, np, lm, cfg, params, device, prompt, emitted,
                  layout="paged"):
    """One request replayed alone over a one-slot cache of ``layout``: its
    prompt through the chunked prefill, then its ``emitted`` tokens through
    the decode step.  Returns (the logits at the next position, the cache,
    the last token's position, the last token)."""
    max_pages = MAX_LEN // PAGE
    cache = lm.init_cache(cfg, 1, MAX_LEN, layout=layout, page_size=PAGE,
                          num_blocks=max_pages + 1, device=device)
    if layout == "paged":
        cache = cache.with_tables(torch.arange(1, max_pages + 1, dtype=torch.int32,
                                               device=device)[None])
    dev = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)  # noqa: E731
    for s0 in range(0, len(prompt), CHUNK):
        n = min(CHUNK, len(prompt) - s0)
        toks = np.zeros((1, CHUNK), np.int32)
        toks[0, :n] = prompt[s0:s0 + n]
        logits, cache = lm.prefill_step(params, cfg, cache, dev(toks), dev([s0]), dev([n]))
    pos, last = len(prompt) - 1, prompt[-1]
    for t in emitted:
        pos, last = pos + 1, t
        logits, cache = lm.decode_step(params, cfg, cache, dev([t]), dev([pos]))
    return logits[0].float(), cache, pos, last


def top2_margin(logits) -> float:
    top2 = logits.topk(2).values
    return (top2[0] - top2[1]).item()


def replay_margin(torch, np, lm, cfg, params, device, prompt, emitted):
    """One request replayed alone (replay_logits): its prompt through the
    chunked prefill, then its ``emitted`` tokens but the last through the
    decode kernel.  At the next position, the decode path's logits (the
    prefill's where nothing was emitted) against verify's
    (``lm.verify_step``, the plain attention): the decode path's top-2
    margin and the max |verify - decode| logit difference."""
    dec, cache, pos, last = replay_logits(torch, np, lm, cfg, params, device, prompt,
                                          emitted)
    dev = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=device)  # noqa: E731
    ver, cache = lm.verify_step(params, cfg, cache, dev([[last]]), dev([pos]), dev([1]))
    return top2_margin(dec), (ver[0, 0].float() - dec).abs().max().item()


def spec_divergences(torch, np, lm, cfg, params, device, reqs, plain_reqs):
    """Each request whose speculative stream parts from the plain run's, at
    its first differing token: (uid, index, the plain path's top-2 margin
    there, the verify-vs-decode logit error there, replay_margin)."""
    out = []
    for r, p in zip(reqs, plain_reqs):
        assert r.prompt == p.prompt
        if r.output == p.output:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r.output, p.output)) if a != b)
        out.append((r.uid, i, *replay_margin(torch, np, lm, cfg, params, device,
                                              p.prompt, p.output[:i])))
    return out


def spec_run(torch, np, lm, cfg, params, device, run, label, path, tc, plain_reqs, **kw):
    """One greedy speculative run (ngram, SPEC_DRAFT, SPEC_SYNC) of the
    requests ``plain_reqs`` served, the spec loop under no_host_sync: its
    streams equal the plain run's but at first divergences whose plain
    top-2 margin lies within twice the verify-vs-decode logit error there
    (two paths' argmaxes can part only so).  Logs acceptance, rounds, the
    plain verify calls and the divergences; returns the engine."""
    from repro_torch.kernels import ops

    for name in ops.PLAIN_PREFILL:
        ops.PLAIN_PREFILL[name] = 0
    with strict_windows(torch, lm, device, "spec_decode_loop"):
        eng, reqs = run(label, path, tc, requests=len(plain_reqs), spec_decode="ngram",
                        draft_len=SPEC_DRAFT, sync_every=SPEC_SYNC, **kw)
    plain_calls = {k: n for k, n in ops.PLAIN_PREFILL.items() if n}
    div = spec_divergences(torch, np, lm, cfg, params, device, reqs, plain_reqs)
    same = sum(r.output == p.output for r, p in zip(reqs, plain_reqs))
    log(f"[spec] {cfg.name} {label}: {same}/{len(reqs)} streams equal the plain run's; "
        f"acceptance {eng.spec_accepted}/{eng.spec_proposed} drafts "
        f"({eng.spec_accepted / max(eng.spec_proposed, 1):.3f}), {eng.spec_windows} "
        f"windows, {eng.spec_rounds} rounds ({eng.spec_all_rejected} slot-rounds all "
        f"rejected, {eng.spec_fallbacks} fallbacks), {eng.dispatches} dispatches; verify "
        f"calls on the plain attention {plain_calls}; first divergences {len(div)}"
        + "".join(f" (request {u} at token {i}: plain top-2 margin {m:.4f}, verify vs "
                  f"decode logit error {e:.4f})" for u, i, m, e in div))
    assert eng.spec_windows > 0 and sum(plain_calls.values()) > 0, plain_calls
    assert all(m <= 2 * e for _, _, m, e in div), div
    return eng


def sampled_runs(run, fp_reqs, path, tc, **kw):
    """A run at SAMPLE_T, per tick and with the window (sync_every
    SPEC_SYNC, under no_host_sync): their streams and keys are equal, and
    differ from the greedy run's ``fp_reqs``.  Returns the per-tick
    engine."""
    a, a_reqs = run(f"T {SAMPLE_T}, seed 3", path, tc, requests=SAMPLE_REQUESTS,
                    temperature=SAMPLE_T, seed=3, **kw)
    b, b_reqs = run(f"T {SAMPLE_T}, seed 3, sync_every={SPEC_SYNC}", path, tc,
                    requests=SAMPLE_REQUESTS, temperature=SAMPLE_T, seed=3,
                    sync_every=SPEC_SYNC, **kw)
    outs = [r.output for r in a_reqs]
    assert outs == [r.output for r in b_reqs] and torch_equal(a._key, b._key)
    assert b.decode_windows > 0
    greedy = [r.output for r in fp_reqs[:SAMPLE_REQUESTS]]
    moved = sum(o != g for o, g in zip(outs, greedy))
    log(f"[sample] T {SAMPLE_T}: per-tick and sync_every={SPEC_SYNC} streams and keys "
        f"equal ({b.decode_windows} windows, no host sync inside); {moved}/{len(outs)} "
        f"streams differ from greedy's")
    assert moved > 0
    return a


def torch_equal(a, b) -> bool:
    return bool((a == b).all())


def sampling_spec_phase(torch, np, lm, cfg, params, kernels, device, runs):
    """Phase 12 on qwen2-1.5B (phase 3's weights and greedy runs): the
    card's threefry bits and ``sample`` against the CPU's, the sampled runs
    (sampled_runs, on spread_logits' weights), greedy speculation in fp and
    int8 pages against phase 3's plain runs (spec_run), and a sampled
    speculative run served twice under one seed, its streams repeated."""
    t0 = time.perf_counter()
    words = prng_check(torch, device)
    rows, differ, ties = sample_check(torch, device)
    log(f"[sample] threefry on the card: {words} words (split keys, random bits, "
        f"uniforms) equal the CPU's; sample (T {SAMPLE_T}, top-k {SAMPLE_TOP_K}, top-p "
        f"{SAMPLE_TOP_P}) over {rows} rows of {WORKLOAD_VOCAB} logits: {differ} tokens "
        f"differ from the CPU's, {ties} rows at a perturbed top-2 gap under "
        f"{SAMPLE_TIE_GAP:g}")
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    spread = make_runner(torch, np, cfg, spread_logits(params), kernels, device, runs)
    fp_reqs = runs["fp, default pool"][1]
    sampled_runs(spread, fp_reqs, FP_KERNELS, TC_KERNELS)
    spec_run(torch, np, lm, cfg, params, device, run, "fp, spec", FP_KERNELS, TC_KERNELS,
             fp_reqs)
    spec_run(torch, np, lm, dataclasses.replace(cfg, kv_dtype="int8"), params, device,
             run, "int8, spec", QUANT_KERNELS, QUANT_TC_KERNELS,
             runs["int8, default pool"][1], kv_dtype="int8")
    outs = []
    for i in range(2):
        with strict_windows(torch, lm, device, "spec_decode_loop"):
            eng, reqs = spread(f"T {SAMPLE_T}, seed 5, spec, run {i + 1}", FP_KERNELS,
                               TC_KERNELS, requests=SAMPLE_REQUESTS, temperature=SAMPLE_T,
                               seed=5, spec_decode="ngram", draft_len=SPEC_DRAFT,
                               sync_every=SPEC_SYNC)
        outs.append([r.output for r in reqs])
    assert outs[0] == outs[1] and eng.spec_windows > 0
    log(f"[spec] {cfg.name} T {SAMPLE_T} spec: two runs under seed 5 repeat their "
        f"streams; acceptance {eng.spec_accepted}/{eng.spec_proposed} drafts "
        f"({eng.spec_accepted / max(eng.spec_proposed, 1):.3f}), {eng.spec_rounds} "
        f"rounds")
    log(f"[time] phase 12 ({cfg.name} sampling and speculation): "
        f"{time.perf_counter() - t0:.1f} s")


def moe_no_drops(cfg):
    """``cfg`` with an MoE capacity at which no expert drops a token (a
    group's every token fits each expert), so routing does not follow the
    batch shape: GShard's groups are the batch's, and a verify chunk's
    batch is not a decode step's."""
    mo = cfg.moe
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        mo, capacity_factor=2.0 * mo.num_experts / mo.experts_per_token))


def mla_spec_phase(torch, np, lm, cfg, kernels, device, requests=SAMPLE_REQUESTS):
    """Phase 12 on deepseek-v2-lite-16B: greedy speculation against a plain
    run on the same weights, both at an MoE capacity with no drops
    (moe_no_drops; otherwise the verify chunks and decode steps drop other
    tokens, as in the reference), the workload's first ``requests``."""
    t0 = time.perf_counter()
    cfg = moe_no_drops(cfg)
    params = lm.init(cfg, 0, device=device)
    runs = {}
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    _, plain = run("fp, no MoE drops", MLA_FP_KERNELS, MLA_FP_KERNELS,
                   requests=requests)
    spec_run(torch, np, lm, cfg, params, device, run, "fp, no MoE drops, spec",
             MLA_FP_KERNELS, MLA_FP_KERNELS, plain)
    del params, runs
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[time] phase 12 ({cfg.name} speculation): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 4: teacher-forced logits, card vs CPU
# ---------------------------------------------------------------------------

# Limits of the card's bf16 logits against the CPU's fp32 ones: worst max
# |diff| in standard deviations of the reference logits, about four times
# an H100's reading of 0.039, and the fewest of the reference's top-10
# tokens kept in the card's top 10 at any step (the card kept 9).  The
# argmax must agree at every step for qwen2-1.5B, whose tied embeddings
# keep each step's top-2 margin wide.  deepseek's untied random
# unembedding leaves some margins below twice the step's max |diff|, where
# the two argmaxes may swap within the error the first limit allows; its
# argmax is printed, with each swapped step's margin, and not gated.
TF_STD_LIMIT = 0.15
TOPK, TF_TOP10_MIN = 10, 7


@contextlib.contextmanager
def recorded_routing(layers):
    """Collects every MoE routing decision (the experts each token chose, in
    token order) made inside the block, by wrapping ``layers.top_k``."""
    picks = []
    top_k = layers.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        picks.append(idx.reshape(-1, k).cpu())
        return vals, idx

    layers.top_k = recording
    try:
        yield picks
    finally:
        layers.top_k = top_k


@contextlib.contextmanager
def replayed_routing(layers, picks):
    """Inside the block the i-th MoE routing decision takes the i-th of
    ``picks`` (another run's, as ``recorded_routing`` kept them): the same
    experts in the same order, their gates read from this run's own router
    probabilities.  Every recorded decision must be replayed."""
    top_k = layers.top_k
    calls = iter(picks)

    def replaying(x, k):
        vals, idx = top_k(x, k)
        got = next(calls).to(idx.device).reshape(idx.shape)
        return x.gather(-1, got), got

    layers.top_k = replaying
    try:
        yield
        assert next(calls, None) is None, "fewer routing decisions than recorded"
    finally:
        layers.top_k = top_k


def step_agreement(torch, got, want):
    """One step's logits ``got`` against the reference's ``want``: the max
    |diff| in standard deviations of ``want`` (not of its max: with tied
    embeddings each token's own logit dwarfs the rest), how many of its top
    10 tokens ``got``'s top 10 holds, whether the argmaxes agree (0 or 1),
    and ``want``'s top-2 margin in standard deviations."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    std = want.std()
    err = ((got - want).abs().max() / std).item()
    common = set(got.topk(TOPK).indices.tolist()) & set(want.topk(TOPK).indices.tolist())
    top2 = want.topk(2).values
    return err, len(common), int(got.argmax() == want.argmax()), ((top2[0] - top2[1]) / std).item()


@contextlib.contextmanager
def recorded_codes(ref, codes):
    """Appends every per-row quantization made inside the block (the KV
    pages' codes and scales, ``ref.quantize_rows``) to ``codes``, in call
    order, on the CPU."""
    quantize = ref.quantize_rows

    def recording(x, fmt="int8"):
        packed, scales = quantize(x, fmt)
        codes.append((packed.cpu(), scales.cpu()))
        return packed, scales

    ref.quantize_rows = recording
    try:
        yield
    finally:
        ref.quantize_rows = quantize


@contextlib.contextmanager
def replayed_codes(ref, codes):
    """Inside the block the i-th per-row quantization returns the i-th of
    ``codes`` (another run's, of the same shapes) on the caller's device,
    its scales in the caller's dtype: the run attends the pages the other
    run wrote.  Every recorded quantization must be replayed."""
    quantize = ref.quantize_rows
    calls = iter(codes)

    def replaying(x, fmt="int8"):
        packed, scales = quantize(x, fmt)
        got, got_scales = next(calls)
        assert got.shape == packed.shape and got_scales.shape == scales.shape
        return got.to(packed.device), got_scales.to(scales.device, scales.dtype)

    ref.quantize_rows = replaying
    try:
        yield
        assert next(calls, None) is None, "fewer quantizations than recorded"
    finally:
        ref.quantize_rows = quantize


def teacher_forced(torch, np, lm, cfg4, dev, shared_codes=False, shared_routing=False):
    """Prefill a 100-token prompt in 64-token chunks, then 8 decode steps
    with fed tokens, on the card (bf16, kernels) and on the CPU (fp32, plain
    path, the same weights upcast).  Returns, over the 10 steps, the worst
    max |diff| in units of the reference logits' standard deviation (not of
    their max: with tied embeddings each token's own logit dwarfs the rest),
    the fewest of the reference's top 10 tokens that the card's top 10
    holds, and the steps whose argmax agrees.

    For a mixture of experts it also returns the share of slot 0's (token,
    expert) choices the two runs make alike, and which steps route the token
    whose logits are read to the same experts in every MoE layer: a bf16
    router input can flip a near tie between two experts, which moves that
    token's output by a whole expert's contribution.  The ``*_agree`` keys
    hold the three readings over the steps that route alike (every step
    without experts).

    ``shared_codes`` (quantized KV): also runs the CPU on the card's codes
    (every page row quantized as the card quantized it, codes and bf16
    scales, instead of from its own fp32 values) and returns the two
    comparisons, (own codes, shared codes): the second separates the
    kernels' arithmetic from the codes' rounding, which at int4 moves a
    value by up to half of a row's absmax / 7 wherever the card's bf16 and
    the CPU's fp32 inputs round to different codes.

    ``shared_routing`` (a mixture of experts): likewise also runs the CPU on
    the card's routing (every MoE layer's experts as the card chose them,
    ``replayed_routing``) and returns (own routing, shared routing): the
    second holds every step, capacity drops included, to the limits."""
    from repro_torch.kernels import ref
    from repro_torch.models import layers

    params = lm.init(cfg4, 7, device=dev)

    def to_cpu32(t):
        if isinstance(t, dict):
            return {k: to_cpu32(v) for k, v in t.items()}
        if isinstance(t, list):
            return [to_cpu32(v) for v in t]
        return t.float().cpu()

    cfg32 = dataclasses.replace(cfg4, dtype="float32")
    p32 = to_cpu32(params)
    rng = np.random.default_rng(5)
    prompt = rng.integers(0, cfg4.vocab_size, size=100)
    fed = rng.integers(0, cfg4.vocab_size, size=8)
    codes = []
    with (recorded_codes(ref, codes) if shared_codes else contextlib.nullcontext()), \
            recorded_routing(layers) as picks:
        card = _tf_run(torch, np, lm, layers, cfg4, params, dev, prompt, fed)
    cpu = torch.device("cpu")
    res = _tf_compare(torch, card, _tf_run(torch, np, lm, layers, cfg32, p32, cpu, prompt, fed))
    if not (shared_codes or shared_routing):
        return res
    with (replayed_codes(ref, codes) if shared_codes else contextlib.nullcontext()), \
            (replayed_routing(layers, picks) if shared_routing else contextlib.nullcontext()):
        shared = _tf_run(torch, np, lm, layers, cfg32, p32, cpu, prompt, fed)
    return res, _tf_compare(torch, card, shared)


def _tf_run(torch, np, lm, layers, c, p, d, prompt, fed):
    """One teacher-forced run of config ``c`` with params ``p`` on device
    ``d``: slot 0's logits at each of the 10 steps, and its MoE routing
    (each step's picks and the row of the token whose logits are read)."""
    cache = lm.init_cache(c, 2, 256, page_size=PAGE, num_blocks=40, device=d)
    tb = np.zeros((2, 16), np.int32)
    tb[0] = np.arange(1, 17)
    cache = cache.with_tables(torch.as_tensor(tb, device=d))
    steps, step_routes = [], []
    with recorded_routing(layers) as picks:
        for s0 in (0, 64):
            n = min(64, 100 - s0)
            toks = np.zeros((2, 64), np.int32)
            toks[0, :n] = prompt[s0:s0 + n]
            start = len(picks)
            logits, cache = lm.prefill_step(
                p, c, cache, torch.as_tensor(toks, device=d),
                torch.as_tensor([s0, 0], dtype=torch.int32, device=d),
                torch.as_tensor([n, 0], dtype=torch.int32, device=d))
            steps.append(logits[0].float().cpu())
            # slot 0's rows (tokens 0..63), the read one last live
            step_routes.append(([x[:64] for x in picks[start:]], n - 1))
        for i, t in enumerate(fed):
            start = len(picks)
            logits, cache = lm.decode_step(
                p, c, cache, torch.as_tensor([int(t), 0], dtype=torch.int32, device=d),
                torch.as_tensor([100 + i, 0], dtype=torch.int32, device=d))
            steps.append(logits[0].float().cpu())
            step_routes.append(([x[:1] for x in picks[start:]], 0))
    return steps, step_routes


def _tf_compare(torch, card, cpu):
    """teacher_forced's readings of the card's run against the CPU's."""
    res = {"err": 0.0, "top10": TOPK, "argmax": 0, "steps": len(cpu[0]),
           "swaps": [], "err_agree": 0.0, "top10_agree": TOPK,
           "argmax_agree": 0, "agree_steps": 0, "route_share": 1.0}
    same = total = 0
    for step, (got, want, (rg, read), (rw, _)) in enumerate(
            zip(card[0], cpu[0], card[1], cpu[1])):
        err, common, hit, margin = step_agreement(torch, got, want)
        if not hit:  # the step, its reference top-2 margin and its error, in std
            res["swaps"].append((step, margin, err))
        agree = True
        for a, b in zip(rg, rw):  # one pick per MoE layer
            for row_a, row_b in zip(a.tolist(), b.tolist()):
                same += len(set(row_a) & set(row_b))
                total += len(row_a)
            agree &= set(a[read].tolist()) == set(b[read].tolist())
        res["err"] = max(res["err"], err)
        res["top10"] = min(res["top10"], common)
        res["argmax"] += hit
        if agree:
            res["agree_steps"] += 1
            res["err_agree"] = max(res["err_agree"], err)
            res["top10_agree"] = min(res["top10_agree"], common)
            res["argmax_agree"] += hit
    if total:
        res["route_share"] = same / total
    return res


def teacher_forced_ok(r, argmax: bool = True) -> bool:
    """The limits over the steps that route alike, which must be at least
    half of them (all of them without experts); the argmax at every such
    step when ``argmax``."""
    return (r["err_agree"] <= TF_STD_LIMIT and r["top10_agree"] >= TF_TOP10_MIN
            and (not argmax or r["argmax_agree"] == r["agree_steps"])
            and 2 * r["agree_steps"] >= r["steps"])


def log_teacher_forced(label, tf, gated, seconds):
    routing = ""
    if tf["route_share"] < 1.0 or tf["agree_steps"] < tf["steps"]:
        routing = (f"; routing: {tf['route_share']:.4f} of slot 0's (token, "
                   f"expert) choices alike, the read token routed alike at "
                   f"{tf['agree_steps']}/{tf['steps']} steps, over which worst "
                   f"{tf['err_agree']:.3e} std, top-{TOPK} kept {tf['top10_agree']}, "
                   f"argmax {tf['argmax_agree']}/{tf['agree_steps']}")
    log(f"[e2e] {label}, card bf16 vs CPU fp32, {tf['steps']} steps: worst "
        f"max|diff| {tf['err']:.3e} standard deviations of the logits (limit "
        f"{TF_STD_LIMIT:g}), fewest top-{TOPK} tokens kept {tf['top10']} (limit "
        f"{TF_TOP10_MIN}), argmax agrees at {tf['argmax']}/{tf['steps']} steps"
        + "".join(f" (step {i}: top-2 margin {m:.3e} std, max|diff| {e:.3e} std)"
                  for i, m, e in tf["swaps"])
        + f"{routing}{'' if gated else ' (printed, not gated)'}, {seconds:.1f} s")


# ---------------------------------------------------------------------------
# phase 5: training
# ---------------------------------------------------------------------------

TRAIN_STEPS = 8
TRAIN_FLASH = ("flash_attention",)  # the kernel of the attention models' training
# Limits of the depth-2 check, one training step's loss and gradients.  The
# kernel path against the card's own bf16 path with the plain attention (the
# same arithmetic but the kernel): the loss within 0.02 nats, the grad norm
# within 5%.  Against the CPU's fp32 plain path: the grad norm within 5%, and
# the loss within 1e-4 of itself, not within 0.02 nats: random tied N(0, 1)
# embeddings put the depth-2 loss near 1139 nats, where bf16 rounding alone
# (the plain-attention control) moved it 0.039 nats on an H100 (the kernel
# path 0.032), twice a 0.02-nat limit; 1e-4 of the loss is three times that
# control's 3.5e-5.  The embedding's self-score dominates that loss and the
# global grad norm, so attention moves them little: the cosine of each
# attention weight's gradient (``layers/attn/*``) with the CPU's is what
# notices a wrong attention, and its least must reach TRAIN_ATTN_COS_MIN.
# The planted faults of TRAIN_FAULTS are run in the kernel's place on every
# check and must each fail the limits.  On an H100 the kernel path read
# 0.999932 (1 - cos 6.8e-5) and the faults 0.371, -0.047 and 0.99689 (3.1e-3,
# the last key tile dropped); 0.9995 (5e-4) sits between, about 7x from each.
TRAIN_LOSS_NATS, TRAIN_LOSS_REL, TRAIN_GNORM_RATIO = 0.02, 1e-4, 0.05
TRAIN_ATTN_COS_MIN = 0.9995
TRAIN_FAULTS = ("non-causal", "kv heads swapped", "last key tile dropped")


def train_steps(torch, cfg, device, steps, batch, seq, profile_steps=0, extra=None):
    """``steps`` AdamW steps of ``make_train_step`` on ``SyntheticTokens``
    (seed 0) from seeded parameters, each ended by a device sync; then, with
    ``profile_steps``, that many more under ``torch.profiler``.  ``extra``
    (the stub frontend's ``frames`` or ``prefix_embeds``) joins every
    batch.  The logits stay unchunked (``logits_chunk`` 0, as the reference
    CLI): at full width they fit.  Returns the losses, grad norms, step
    seconds (the batch drawn beforehand), every kernel's launches over the
    first ``steps`` (those that launched), the peak memory on a card, the
    profile and the final state."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.launch.train import build_state, make_train_step
    from repro_torch.optim import AdamWConfig

    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    state = build_state(cfg, 0, device)
    step_fn = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=steps))
    data = SyntheticTokens(DataConfig(batch=batch, seq=seq,
                                      vocab_size=cfg.vocab_size, seed=0))

    def step(i):
        nonlocal state
        inputs = {**data.batch_at(i), **(extra or {})}
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step_fn(state, inputs)
        loss, gnorm = m["loss"].item(), m["grad_norm"].item()
        if cuda:
            torch.cuda.synchronize()
        return loss, gnorm, time.perf_counter() - t0

    for k in KERNELS.values():
        k.launches = k.tc_launches = 0
    res = {"losses": [], "gnorms": [], "seconds": []}
    for i in range(steps):
        loss, gnorm, dt = step(i)
        res["losses"].append(loss)
        res["gnorms"].append(gnorm)
        res["seconds"].append(dt)
    res["launches"] = {name: k.launches for name, k in KERNELS.items() if k.launches}
    res["tc_launches"] = {name: k.tc_launches for name, k in KERNELS.items()
                          if k.tc_launches}
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30 if cuda else 0.0
    if profile_steps:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            for i in range(steps, steps + profile_steps):
                step(i)
            res["profile_wall"] = time.perf_counter() - t0
        res["profile"] = step_breakdown(torch, prof.profiler.kineto_results.events())
    res["state"] = state
    return res


# device kernels by name: the port's kernels, the matrix products (cuBLAS's
# nvjet / cutlass / gemm kernels), everything else
def _kernel_group(name: str) -> str:
    for kernel in ("flash_attention", "chunk_state", "chunk_scan"):
        if f"{kernel}_kernel" in name:
            return f"{kernel} kernel"
    if any(t in name.lower() for t in ("gemm", "nvjet", "cutlass", "xmma")):
        return "GEMMs"
    return "other kernels"


# the ranges the port annotates (torch.profiler.record_function); of the
# MoE's forward (and its recompute) the kernels other than GEMMs are its
# dispatch
RANGES = ("flash_attention.backward", "chunk_state.backward",
          "chunk_scan.backward", "adamw_update", "moe")


def step_breakdown(torch, events):
    """Device time (ms) of a profiled window, from the profiler's raw events
    (``kineto_results.events()``: its event tree, over the 10^5 host ops of
    a step, takes tens of seconds to build): busy in all, by kernel group,
    and, overlapping those groups, the kernels launched inside the annotated
    ranges (the kernels' plain recompute in the backward, the AdamW
    update, the MoE's forward and recompute, of which "MoE dispatch" are
    the kernels other than GEMMs).  A kernel is inside a range when the
    host op that launched it starts within the range on the range's
    thread.  A range also shows on
    the device's timeline as an annotation of its own span: it is not a
    kernel and is left out of the sums."""
    import bisect

    from torch.autograd import DeviceType

    ops, spans, kernels = {}, {}, []
    for e in events:
        if e.device_type() == DeviceType.CPU:
            if e.linked_correlation_id() == 0:  # a host op, not a runtime call
                ops[e.correlation_id()] = (e.start_thread_id(), e.start_ns())
            if e.name() in RANGES:
                spans.setdefault((e.name(), e.start_thread_id()), []).append(
                    (e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA and e.name() not in RANGES:
            kernels.append((e.name(), e.duration_ns() / 1e6, e.linked_correlation_id()))
    out = {"device busy": sum((ms for _, ms, _ in kernels), 0.0)}
    by_name = {}
    for name, ms, _ in kernels:
        g = _kernel_group(name)
        out[g] = out.get(g, 0.0) + ms
        n, total = by_name.get(name, (0, 0.0))
        by_name[name] = (n + 1, total + ms)
    for key, v in spans.items():
        v.sort()
        out["inside " + key[0]] = 0.0
    if any(name == "moe" for name, _ in spans):
        out["MoE dispatch"] = 0.0
    starts = {key: [a for a, _ in v] for key, v in spans.items()}
    for kname, ms, corr in kernels:
        if corr not in ops:
            continue
        thread, t = ops[corr]
        for name in RANGES:
            st = starts.get((name, thread))
            i = -1 if st is None else bisect.bisect_right(st, t) - 1
            if i >= 0 and t <= spans[(name, thread)][i][1]:
                out["inside " + name] += ms
                if name == "moe" and _kernel_group(kname) != "GEMMs":
                    out["MoE dispatch"] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    out["top"] = [(name[:80], n, ms) for name, (n, ms) in top]
    return out


@contextlib.contextmanager
def attention_as(ops, fn):
    """Inside the block, ``ops.attention`` is ``fn`` on every device (the
    plain version, a control of what bf16 alone moves, or a planted
    fault)."""
    attention = ops.attention
    ops.attention = fn
    try:
        yield
    finally:
        ops.attention = attention


def planted_fault(torch, ref, fault):
    """The plain attention with a fault the depth-2 check must catch: the
    causal mask dropped, the two groups' K/V heads exchanged, or the last
    32 keys (half the tensor-core kernel's 64-key tile) masked off for
    every query."""
    def attention(q, k, v, *, causal=False, **kw):
        if fault == "non-causal":
            causal = False
        elif fault == "kv heads swapped":
            k, v = k.flip(1), v.flip(1)
        else:
            assert fault == "last key tile dropped", fault
            kw["kv_len"] = torch.full((q.shape[0],), k.shape[2] - 32, device=q.device)
        return ref.attention(q, k, v, causal=causal, **kw)
    return attention


def depth2_controls(torch, cfg2):
    """The depth-2 check's runs after the CPU's and the card's: the card's
    bf16 path with the plain version of the family's kernels (what bf16
    alone moves), then each planted fault in the kernels' place, as
    (label, context-manager factory)."""
    from repro_torch.kernels import ops, ref

    if cfg2.family in ("ssm", "hybrid"):
        return (("card bf16, plain SSD",
                 lambda: ssd_as(ops, ref.chunk_state, ref.chunk_scan)),
                *((f"fault: {f}", lambda f=f: ssd_as(ops, *ssd_fault(torch, ref, f)))
                  for f in SSM_FAULTS))
    return (("card bf16, plain attention", lambda: attention_as(ops, ref.attention)),
            *((f"fault: {f}", lambda f=f: attention_as(ops, planted_fault(torch, ref, f)))
              for f in TRAIN_FAULTS))


def train_card_vs_cpu(torch, np, lm, cfg2, dev, batch=2, seq=256, shared_routing=False):
    """One loss and gradient at depth 2, full width: the card's bf16 kernel
    path against the plain path in fp32 on the CPU (the same seeded
    parameters upcast); as a control of what bf16 alone moves, the card's
    bf16 path with the plain version of its kernels; and, as controls the
    limits must reject, each planted fault in the kernels' place
    (:func:`depth2_controls`).  Returns each run's loss, global gradient norm
    and least gradient cosine with the CPU's over the kernels' layer leaves
    (``layers/attn/*``, or ``layers/mamba/*`` for the SSM), and the kernel
    path's per-leaf cosines.

    ``shared_routing`` (a mixture of experts): the kernel path runs first
    and every other run takes its MoE routing (``replayed_routing``), so
    that a near tie between two experts, which a bf16 router input can
    flip, moves no run by a whole expert's contribution."""
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import layers
    from repro_torch.optim import global_norm
    from repro_torch.optim.adamw import leaves

    params = lm.init(cfg2, 7, device=dev)
    names = leaf_names(params)
    b = SyntheticTokens(DataConfig(batch=batch, seq=seq,
                                   vocab_size=cfg2.vocab_size, seed=1)).batch_at(0)
    cpu = torch.device("cpu")
    prefix = "layers/mamba/" if cfg2.family in ("ssm", "hybrid") else "layers/attn/"
    order = [("cpu fp32", None), ("card bf16", None), *depth2_controls(torch, cfg2)]
    if shared_routing:
        order[:2] = order[1::-1]
    runs, waiting, ref_grads, picks, seconds = {}, [], None, [], []
    for label, control in order:
        t0 = time.perf_counter()
        on_cpu = label == "cpu fp32"
        c = dataclasses.replace(cfg2, dtype="float32") if on_cpu else cfg2
        p = _tree_to(torch, params, cpu, torch.float32) if on_cpu else params
        d = cpu if on_cpu else dev
        flat = leaves(p)
        for t in flat:
            t.requires_grad_(True)
        if not shared_routing:
            routing = contextlib.nullcontext()
        elif label == "card bf16":
            routing = recorded_routing(layers)
        else:
            routing = replayed_routing(layers, picks)
        with routing as recorded, \
                contextlib.nullcontext() if control is None else control():
            loss, _ = lm.loss_fn(p, c, torch.as_tensor(b["tokens"], device=d),
                                 torch.as_tensor(b["labels"], device=d), remat=True)
            grads = torch.autograd.grad(loss, flat)
        if shared_routing and label == "card bf16":
            picks = recorded
        for t in flat:
            t.requires_grad_(False)
        gnorm = global_norm(grads).item()
        grads = [g.float().to(dev) for g in grads]  # the cosines on the card
        if on_cpu:
            ref_grads = grads
        waiting.append((label, loss.detach().item(), gnorm, grads))
        seconds.append(f"{label} {time.perf_counter() - t0:.1f}")
        if ref_grads is None:
            continue
        for lab, lo, gn, gs in waiting:
            cos = {name: torch.nn.functional.cosine_similarity(
                a.double().flatten(), w.double().flatten(), dim=0).item()
                   for name, a, w in zip(names, gs, ref_grads)}
            if lab == "card bf16":
                runs["cosines"] = cos
            runs[lab] = (lo, gn, min(c for n, c in cos.items() if n.startswith(prefix)))
        waiting = []
    log("[train] depth-2 runs' seconds: " + ", ".join(seconds))
    return runs


def leaf_names(tree, path=""):
    """Path names of a tree's leaves in ``optim.adamw.leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in leaf_names(v, f"{path}/{i}")]
    return [path.lstrip("/")]


def _tree_to(torch, tree, device, dtype):
    if isinstance(tree, dict):
        return {k: _tree_to(torch, v, device, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(torch, v, device, dtype) for v in tree]
    return tree.detach().to(device=device, dtype=dtype)


def depth2_limits(r):
    """The depth-2 limits of a run set: the plain control's label, the loss
    limit against the CPU's (nats), the cosine limit and its name."""
    if "card bf16, plain SSD" in r:
        return ("card bf16, plain SSD", SSM_LOSS_CPU_NATS, SSM_COS_MIN,
                "mamba grad cosine")
    return ("card bf16, plain attention", TRAIN_LOSS_REL * abs(r["cpu fp32"][0]),
            TRAIN_ATTN_COS_MIN, "attn grad cosine")


def train_limits_failed(r, label="card bf16"):
    """The depth-2 limits that run ``label`` (the kernel path, or a planted
    fault in its place) fails.  A NaN reading fails every limit it enters."""
    (loss, gnorm, cos), (loss32, gnorm32, _) = r[label], r["cpu fp32"]
    plain_label, loss_cpu, cos_min, cos_name = depth2_limits(r)
    plain, gplain, _ = r[plain_label]
    checks = {"loss vs card plain": abs(loss - plain) <= TRAIN_LOSS_NATS,
              "grad norm vs card plain": abs(gnorm / gplain - 1) <= TRAIN_GNORM_RATIO,
              "loss vs CPU": abs(loss - loss32) <= loss_cpu,
              "grad norm vs CPU": abs(gnorm / gnorm32 - 1) <= TRAIN_GNORM_RATIO,
              cos_name: cos >= cos_min}
    return [name for name, ok in checks.items() if not ok]


def train_card_vs_cpu_ok(r, label="card bf16") -> bool:
    return not train_limits_failed(r, label)


def recovery_run(torch, device, ckpt_dir, steps=20, failure_prob="0.1", seed="0",
                 arch="qwen2_1_5b"):
    """The training CLI on reduced ``arch`` with injected failures (this
    seed's FaultInjector fails some steps): restarts from its checkpoints
    and reaches its last step.  Returns the CLI's result and the flash
    kernel's launches."""
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.launch import train

    res = train.main(["--arch", arch, "--reduced", "--steps", str(steps),
                      "--failure-prob", failure_prob, "--seed", seed,
                      "--device", device.type, "--ckpt-dir", str(ckpt_dir)])
    return res, KERNEL.launches


# ---------------------------------------------------------------------------
# phase 2, the kernel library: the paper's kernel experiments at full width
# ---------------------------------------------------------------------------

# Table 2 / Fig. 13, copied from benchmarks/bench_gemm.py:17-28: (M, N, K),
# bf16 in and out, fp32 accumulation
GEMM_SHAPES = {
    "M0": (4096, 1024, 8192), "M1": (4096, 8192, 8192),
    "M2": (4096, 28672, 8192), "M3": (4096, 8192, 28672),
    "M4": (8192, 1024, 8192), "M5": (8192, 8192, 8192),
    "M6": (8192, 28672, 8192), "M7": (8192, 8192, 28672),
    "V0": (1, 16384, 16384), "V1": (1, 43008, 14336),
    "V2": (1, 14336, 14336), "V3": (1, 57344, 14336),
    "V4": (1, 14336, 57344), "V5": (1, 9216, 9216),
    "V6": (1, 36864, 9216), "V7": (1, 9216, 36864),
}
# Fig. 15, copied from benchmarks/bench_dequant.py:19-23: (M, N, K)
DEQUANT_SHAPES = {
    "m1_n16384_k16384": (8, 16384, 16384),
    "m1_n8192_k28672": (8, 8192, 28672),
    "m256_n8192_k8192": (256, 8192, 8192),
}
# bench_dequant.py:42: (weight format, activations); int8 activations write
# float32, as the paper's program does, fp16 ones the library's default fp16
DEQUANT_ROWS = (("int8", "float16"), ("int4", "float16"), ("int2", "float16"),
                ("nf4", "float16"), ("int2", "int8"), ("int4", "int8"))
# Fig. 14, copied from benchmarks/bench_mla.py:17-21: (batch, heads,
# kv_heads, seqlen_kv, dim, pe_dim), bf16
MLA_SHAPES = {
    "b64_s1024": (64, 128, 1, 1024, 512, 64),
    "b64_s4096": (64, 128, 1, 4096, 512, 64),
    "b128_s8192": (128, 128, 1, 8192, 512, 64),
}
INT8_OPS = 1979e12  # dense int8 tensor-core peak
# the row of each kernel that goes into the result line
LIBRARY_ROWS = {"matmul": "M7 bfloat16", "dequant_matmul": "m1_n16384_k16384 int4 x float16",
                "mla": "b128_s8192 bfloat16"}
LIBRARY_KERNELS = tuple(LIBRARY_ROWS)
# the library cases that must take FlashMLA's wgmma path
MLA_WGMMA = (*(f"{k} bfloat16" for k in MLA_SHAPES), "Hkv 2 ragged bfloat16",
             "16 heads ragged bfloat16")
K_TILE = 32  # the K tile the GEMM's planted fault drops


def ragged_cases():
    """Beyond the paper's shapes: one fp32 pass a kernel (CUDA cores), the
    reference's ragged cases (odd K 48, tests/test_kernels.py:165; two latent
    heads, :123-128) and scale groups no K tile of the kernel matches."""
    return {
        "matmul": [("fp32 M0", (4096, 1024, 8192), "float32"),
                   ("odd K", (1000, 1000, 48), "bfloat16"),
                   ("ragged, CUDA cores", (37, 100, 57), "bfloat16")],
        "dequant_matmul": [("fp32 m256", (256, 8192, 8192), "int4", "float32", None),
                           ("odd K", (8, 1024, 48), "int4", "float16", None),
                           ("group 96", (64, 4096, 12288), "int4", "float16", 96),
                           ("group 32 bf16", (8, 4096, 4096), "nf4", "bfloat16", 32),
                           ("group 128 M 5", (5, 4104, 8192), "int2", "float16", 128),
                           ("group 48 int8", (8, 1024, 1536), "int2", "int8", 48)],
        "mla": [("fp32 b64_s1024", (64, 128, 1, 1024, 512, 64), "float32"),
                ("Hkv 2", (1, 32, 2, 128, 64, 32), "bfloat16"),
                ("Hkv 2 ragged", (4, 128, 2, 1000, 512, 64), "bfloat16"),
                # deepseek-v2-lite-16B's contiguous decode: a partial head group
                ("16 heads ragged", (8, 16, 1, 777, 512, 64), "bfloat16")],
    }


def reduced_ragged():
    """ragged_cases() at the CPU's sizes."""
    return {
        "matmul": [("fp32", (64, 32, 256), "float32"), ("odd K", (16, 24, 48), "bfloat16")],
        "dequant_matmul": [("fp32", (16, 32, 128), "int4", "float32", None),
                           ("group 96", (8, 16, 384), "int4", "float16", 96),
                           ("group 48 int8", (8, 16, 192), "int2", "int8", 48)],
        "mla": [("fp32", (2, 16, 1, 64, 64, 16), "float32"),
                ("Hkv 2", (1, 32, 2, 40, 64, 32), "bfloat16")],
    }


GEMM_FLOOR = 2.0 ** -12  # the least ulp lib_units counts, in units of sigma


def lib_units(torch, got, want, sigma: float) -> float:
    """Largest |got - want| over the elements in ulps of ``want`` in the
    16-bit output type (8 significant bits for bf16, 11 for fp16), an ulp
    counted as at least ``GEMM_FLOOR * sigma``.  ``sigma``, sqrt(K) rms(a)
    rms(b), is the size of a typical output; an element much smaller is the
    difference of large fp32 partial sums, which the order and rounding of
    the sums alone move: tensor cores truncate their fp32 sums, which over
    the K / 16 = 1792 steps of K = 28672 adds up to ~2^-13 sigma.  The
    cuBLAS controls pass in these units."""
    bits = 8 if got.dtype == torch.bfloat16 else 11
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - bits)
    ulp = ulp.clamp_min(sigma * GEMM_FLOOR)
    return ((got.float() - w).abs() / ulp).max().item()


def rel_err(torch, got, want) -> float:
    """Max abs error over max(1, max |want|): fp32 results."""
    w = want.float()
    return ((got.float() - w).abs().max() / w.abs().max().clamp_min(1.0)).item()


def rms(torch, t) -> float:
    return (torch.linalg.vector_norm(t, dtype=torch.float32) / t.numel() ** 0.5).item()


def library_ok(r) -> bool:
    """Within its limit, each planted fault beyond it; for the 16-bit GEMMs
    the cuBLAS control within it too; for bf16 MLA the attention controls
    (an fp32-accumulating online softmax passes; a bf16-accumulating one,
    and one that rounds P to bf16, fail)."""
    ok = r["err"] <= r["limit"] and all(f > r["limit"] for f in r.get("faults", {}).values())
    if "cublas_units" in r:
        ok = ok and r["cublas_units"] <= r["limit"]
    if "fp32_acc_ulps" in r:
        ok = ok and (r["fp32_acc_ulps"] <= BF16_ULPS and r["bf16_acc_ulps"] > BF16_ULPS
                     and r["bf16_p_ulps"] > BF16_ULPS)
    return ok


def check_gemm(torch, ops, ref, label, shape, dtype, flush, timed, dev, seed=41):
    """ops.matmul against ref.matmul: bf16 within 2 units (lib_units) of
    the plain value, with cuBLAS's bf16 product as the control; fp32 within
    FP32_ATOL of max(1, max |plain|).  The planted fault drops the first
    K tile."""
    m, n, k = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    a = torch.randn((m, k), generator=g, device=dev).to(dt)
    b = torch.randn((k, n), generator=g, device=dev).to(dt)
    tc_before = ops.KERNELS["matmul"].tc_launches
    out = ops.matmul(a, b)  # the library's path: counted
    plain = ref.matmul(a, b, dt)
    res = {"kernel": "matmul", "label": f"{label} {dtype}", "shape": shape, "dtype": dt,
           "max_abs_err": (out.float() - plain.float()).abs().max().item(),
           "wgmma_launches": ops.KERNELS["matmul"].tc_launches - tc_before}
    if dt == torch.float32:
        res.update(err=rel_err(torch, out, plain), limit=FP32_ATOL, metric="of max(1, max|plain|)")
    else:
        sigma = k ** 0.5 * rms(torch, a) * rms(torch, b)
        res.update(err=lib_units(torch, out, plain, sigma), limit=BF16_ULPS,
                   metric="units (lib_units)",
                   cublas_units=lib_units(torch, torch.matmul(a, b), plain, sigma))
        # B's row-major (K, N) bytes read as a K-major (N, K) matrix: the
        # descriptor fault the wgmma path's transpose-B bit guards against
        k_major = ref.matmul(a, b.reshape(n, k).t(), dt)
        res["faults"] = {"B read as K-major": lib_units(torch, k_major, plain, sigma)}
        del k_major
        if k > K_TILE:
            dropped = ref.matmul(a[:, K_TILE:], b[K_TILE:], dt)
            res["faults"]["first K tile dropped"] = lib_units(torch, dropped, plain, sigma)
            del dropped
    del out, plain
    if timed:
        mm = ops.KERNELS["matmul"]
        counts = mm.launches, mm.tc_launches
        res["ms"] = time_ms(torch, lambda: ops.matmul(a, b), flush=flush)
        mm.launches, mm.tc_launches = counts
        res["plain_ms"] = time_ms(torch, lambda: ref.matmul(a, b, dt), flush=flush)
        res["library_ms"] = time_ms(torch, lambda: torch.matmul(a, b), flush=flush)
        isz = a.element_size()
        res["bound_ms"], res["bound_by"] = bound((m * k + k * n + m * n) * isz,
                                                 2.0 * m * n * k, BF16_FLOPS)
    return res


def nibbles_swapped(torch, packed, fmt):
    """The planted fault: each byte's codes read in the opposite order."""
    b = packed.to(torch.int32) & 0xFF
    if fmt in ("int4", "nf4"):
        b = ((b & 0xF) << 4) | (b >> 4)
    else:  # int2: four crumbs reversed
        b = ((b & 3) << 6) | ((b & 0xC) << 2) | ((b >> 2) & 0xC) | (b >> 6)
    return b.to(torch.uint8).view(torch.int8)


def rounded_weight(torch, ref, packed, fmt, scales, group, dtype):
    """The control's weight: each code cast to the activations' 16-bit type
    and scaled in it, as the kernel (and the TPU kernel) multiplies it."""
    w = ref.dequant_weight(packed, fmt).to(dtype)
    if scales is not None:
        n, k = w.shape
        w = (w.float().reshape(n, k // group, group)
             * scales.to(dtype).float()[..., None]).to(dtype).reshape(n, k)
    return w


def check_dequant(torch, ops, ref, label, shape, fmt, adtype, group, flush, timed, dev,
                  seed=43):
    """ops.dequant_matmul against ref.dequant_matmul (weights in fp32).
    16-bit activations: the kernel multiplies each weight rounded to their
    type, as the TPU kernel does, so the control is the plain version on
    the weight rounded so; the limit is 2 units (lib_units) more than the
    control's own reading, and cuBLAS's product on that weight must pass
    it too; the kernel's distance from the control is printed.  int8 activations (float32 out): within FP32_ATOL of max(1,
    max |plain|) (integer sums below 2^24: both exact).  The planted fault
    swaps each byte's code order."""
    m, n, k = shape
    pack = ref.WEIGHT_PACK[fmt]
    dt = getattr(torch, adtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    if dt == torch.int8:
        a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
    else:
        a = torch.randn((m, k), generator=g, device=dev).to(dt)
    bq = torch.randint(-128, 128, (n, k // pack), generator=g, device=dev, dtype=torch.int8)
    sdt = dt if dt in (torch.bfloat16, torch.float16) else torch.float32
    scales = None if group is None else (
        torch.rand((n, k // group), generator=g, device=dev) * 0.1 + 0.01).to(sdt)
    grp = group or 128
    out_dt = torch.float32 if dt in (torch.int8, torch.float32) else dt
    out = ops.dequant_matmul(a, bq, fmt=fmt, scales=scales, out_dtype=out_dt)  # counted
    plain = ref.dequant_matmul(a, bq, fmt, scales, grp, out_dt)
    res = {"kernel": "dequant_matmul", "label": f"{label} {fmt} x {adtype}", "shape": shape,
           "dtype": dt,
           "max_abs_err": (out.float() - plain.float()).abs().max().item()}
    swapped = None
    if fmt != "int8":
        swapped = ref.dequant_matmul(a, nibbles_swapped(torch, bq, fmt), fmt, scales, grp, out_dt)
    if out_dt == torch.float32:
        res.update(err=rel_err(torch, out, plain), limit=FP32_ATOL, metric="of max(1, max|plain|)")
        if swapped is not None:
            res["faults"] = {"code order swapped": rel_err(torch, swapped, plain)}
    else:
        w = ref.dequant_weight(bq, fmt)
        if scales is not None:
            w = (w.reshape(n, k // grp, grp) * scales.float()[..., None]).reshape(n, k)
        sigma = k ** 0.5 * rms(torch, a) * rms(torch, w)
        del w
        wr = rounded_weight(torch, ref, bq, fmt, scales, grp, dt)
        control = torch.matmul(a.float(), wr.float().t()).to(out_dt)
        # the same rounded weight through cuBLAS's tensor cores
        res["cublas_units"] = lib_units(torch, torch.matmul(a, wr.t()), plain, sigma)
        del wr
        res["control_units"] = lib_units(torch, control, plain, sigma)
        res["vs_control_units"] = lib_units(torch, out, control, sigma)
        res.update(err=lib_units(torch, out, plain, sigma),
                   limit=BF16_ULPS + res["control_units"], metric="units (lib_units)")
        if swapped is not None:
            res["faults"] = {"code order swapped": lib_units(torch, swapped, plain, sigma)}
    del out, plain, swapped
    if timed:
        kern = ops.KERNELS["dequant_matmul"]
        n_before = kern.launches
        res["ms"] = time_ms(torch, lambda: ops.dequant_matmul(
            a, bq, fmt=fmt, scales=scales, out_dtype=out_dt), flush=flush)
        kern.launches = n_before
        res["plain_ms"] = time_ms(torch, lambda: ref.dequant_matmul(
            a, bq, fmt, scales, grp, out_dt), flush=flush)
        # the paper's baseline, a yardstick only: cuBLAS's fp16 product on
        # activations and a weight converted to fp16 beforehand
        a16, w16 = a.half(), ref.dequant_weight(bq, fmt).half()
        res["yardstick_ms"] = time_ms(torch, lambda: torch.matmul(a16, w16.t()), flush=flush)
        res["library_ms"] = None  # no PyTorch call dequantizes packed codes
        res["yardstick_bound_ms"] = (m * k + n * k + m * n) * 2 / HBM_BYTES_PER_S * 1e3
        del a16, w16
        osz = torch.empty((), dtype=out_dt).element_size()
        nbytes = m * k * a.element_size() + n * k // pack + m * n * osz
        if scales is not None:
            nbytes += scales.numel() * scales.element_size()
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, 2.0 * m * n * k, INT8_OPS if dt == torch.int8 else BF16_FLOPS)
    return res


def check_lib_mla(torch, ops, ref, label, shape, dtype, flush, timed, dev, seed=47):
    """ops.mla against ref.mla: bf16 within 2 bf16 ulps of the plain value
    (bf16_ulps), with phase 2's attention controls over the heads of each
    latent head as query rows; fp32 within FP32_ATOL."""
    b, h, hkv, s, d, pe = shape
    dt = getattr(torch, dtype)
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
    q_pe = torch.randn((b, h, pe), generator=g, device=dev).to(dt)
    kv = torch.randn((b, s, hkv, d), generator=g, device=dev).to(dt)
    k_pe = torch.randn((b, s, hkv, pe), generator=g, device=dev).to(dt)
    scale = (d + pe) ** -0.5
    tc_before = ops.KERNELS["mla"].tc_launches
    out = ops.mla(q, q_pe, kv, k_pe)  # counted
    plain = ref.mla(q, q_pe, kv, k_pe)
    err = (out.float() - plain.float()).abs().max().item()
    res = {"kernel": "mla", "label": f"{label} {dtype}", "shape": shape, "max_abs_err": err,
           "wgmma_launches": ops.KERNELS["mla"].tc_launches - tc_before}
    group = h // hkv
    # the heads of a latent head as the query rows of one attention head
    qg = torch.cat([q, q_pe], -1).reshape(b, hkv, group, d + pe)
    kg = torch.cat([kv, k_pe], -1).transpose(1, 2)  # (B, Hkv, S, D + Dpe)
    vg = kv.transpose(1, 2)
    if dt == torch.float32:
        res.update(err=err, limit=FP32_ATOL, metric="max abs")
    else:
        res.update(err=bf16_ulps(torch, out, plain), limit=BF16_ULPS, metric="bf16 ulps")
        mask = torch.ones((1, 1, 1, s), dtype=torch.bool, device=dev)
        res.update(accumulation_controls(torch, qg, kg, vg, mask,
                                         plain.reshape(b, hkv, group, d), scale=scale))
    del out, plain
    if timed:
        kern = ops.KERNELS["mla"]
        counts = kern.launches, kern.tc_launches
        res["ms"] = time_ms(torch, lambda: ops.mla(q, q_pe, kv, k_pe), flush=flush)
        kern.launches, kern.tc_launches = counts
        res["plain_ms"] = time_ms(torch, lambda: ref.mla(q, q_pe, kv, k_pe), flush=flush)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qg4, kg4, vg4 = qg.contiguous(), kg.contiguous(), vg.contiguous()
        res["library_ms"] = time_ms(torch, lambda: sdpa(qg4, kg4, vg4, scale=scale),
                                    flush=flush)
        isz = q.element_size()
        nbytes = (b * s * hkv * (d + pe) + b * h * (d + pe) + b * h * d) * isz
        res["bound_ms"], res["bound_by"] = bound(nbytes, 2.0 * b * h * s * (2 * d + pe),
                                                 BF16_FLOPS)
    return res


def library_phase(torch, ref, flush, device, gemm=None, dequant=None, mla=None,
                  ragged=None, timed=True):
    """The kernel library driven through ``ops`` at the paper's shapes
    (GEMM_SHAPES, DEQUANT_SHAPES x DEQUANT_ROWS, MLA_SHAPES) and on
    ``ragged`` (ragged_cases()): each result held against its plain
    version, timed beside it and a library call or yardstick.  The three
    kernels' launch counts are set to 0 first and read at the end: each
    case's first call through ``ops`` is the path's run; the timing's
    launches are taken back.  Returns (results, launches)."""
    from repro_torch.kernels import ops

    gemm = GEMM_SHAPES if gemm is None else gemm
    dequant = DEQUANT_SHAPES if dequant is None else dequant
    mla = MLA_SHAPES if mla is None else mla
    ragged = ragged_cases() if ragged is None else ragged
    for name in LIBRARY_KERNELS:
        ops.KERNELS[name].launches = 0
    out = []
    for label, shape in gemm.items():
        out.append(check_gemm(torch, ops, ref, label, shape, "bfloat16", flush, timed, device))
    for label, shape, dtype in ragged["matmul"]:
        out.append(check_gemm(torch, ops, ref, label, shape, dtype, flush, False, device))
    for label, shape in dequant.items():
        for fmt, adtype in DEQUANT_ROWS:
            out.append(check_dequant(torch, ops, ref, label, shape, fmt, adtype, None, flush,
                                     timed, device))
    for label, shape, fmt, adtype, group in ragged["dequant_matmul"]:
        out.append(check_dequant(torch, ops, ref, label, shape, fmt, adtype, group, flush,
                                 False, device))
    for label, shape in mla.items():
        out.append(check_lib_mla(torch, ops, ref, label, shape, "bfloat16", flush, timed,
                                 device))
    for label, shape, dtype in ragged["mla"]:
        out.append(check_lib_mla(torch, ops, ref, label, shape, dtype, flush, False, device))
    launches = {name: ops.KERNELS[name].launches for name in LIBRARY_KERNELS}
    return out, launches


def log_library(r):
    """One line a library case: its reading against its limit, the
    controls and faults, and its times."""
    text = (f"[kernel] {r['kernel']} {r['label']} {tuple(r['shape'])}: {r['err']:.3g} "
            f"{r['metric']} (limit {r['limit']:.3g}), max abs err {r['max_abs_err']:.3e}")
    if "cublas_units" in r:
        text += f"; control cuBLAS {str(r['dtype'])[6:]} {r['cublas_units']:.3g}"
    if "control_units" in r:
        text += (f"; control (weight rounded to the activations' type) {r['control_units']:.3g}"
                 f", kernel vs control {r['vs_control_units']:.3g}")
    if "fp32_acc_ulps" in r:
        text += f"; {controls_text(r)}"
    for fault, v in r.get("faults", {}).items():
        text += f"; fault '{fault}' {v:.3g}"
    if "ms" in r:
        text += f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
        if r["kernel"] == "dequant_matmul":
            text += (f"cuBLAS fp16 on a weight dequantized beforehand (yardstick) "
                     f"{r['yardstick_ms']:.4f} ms (its bound {r['yardstick_bound_ms']:.4f}), "
                     f"speedup over it {r['yardstick_ms'] / r['ms']:.2f}x, ")
        elif r["kernel"] == "mla":
            text += f"sdpa (a latent head's heads as query rows) {r['library_ms']:.4f} ms, "
        else:
            text += (f"torch.matmul {r['library_ms']:.4f} ms (kernel / torch.matmul "
                     f"{r['ms'] / r['library_ms']:.2f}x), ")
        text += f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
    if r.get("wgmma_launches"):
        text += " [wgmma]"
    log(text)


def wgmma_gate(lib):
    """Every Table 2 M shape on the GEMM's wgmma path and every MLA_WGMMA
    case on FlashMLA's, one launch each: returns the two maps of label to
    launches, raises if a case is missing or took another path."""
    gemm = {r["label"]: r["wgmma_launches"] for r in lib
            if r["kernel"] == "matmul" and r["label"].startswith("M")}
    mla = {r["label"]: r["wgmma_launches"] for r in lib
           if r["kernel"] == "mla" and r["label"] in MLA_WGMMA}
    if sorted(gemm) != [f"M{i} bfloat16" for i in range(8)] or set(gemm.values()) != {1}:
        raise AssertionError(f"a Table 2 M shape missed the wgmma path: {gemm}")
    if sorted(mla) != sorted(MLA_WGMMA) or set(mla.values()) != {1}:
        raise AssertionError(f"a FlashMLA case missed the wgmma path: {mla}")
    return gemm, mla


def lib_mla_tile_cost(lib, keys: int):
    """FlashMLA's device cost of one key tile of a block's walk, from its
    two b64 launches (s 1024 and 4096; 128 blocks, one wave on 132 SMs):
    (us a tile, us of the rest of the launch, TFLOP/s an SM).  A tile's
    tensor work is 64 rows x keys x 2 (D + Dpe + 2 D): P.V runs twice, hi
    and lo."""
    ms = {r["label"]: r["ms"] for r in lib if r["kernel"] == "mla" and "ms" in r}
    lo, hi = ms["b64_s1024 bfloat16"], ms["b64_s4096 bfloat16"]
    _, _, _, s_lo, d, pe = MLA_SHAPES["b64_s1024"]
    s_hi = MLA_SHAPES["b64_s4096"][3]
    per = (hi - lo) / ((s_hi - s_lo) // keys) * 1e3
    flops = 64 * keys * 2 * (d + pe + 2 * d)
    return per, lo * 1e3 - s_lo // keys * per, flops / (per * 1e-6) / 1e12


# ---------------------------------------------------------------------------
# phase 2, driven
# ---------------------------------------------------------------------------


def kernel_phase(torch, np, ref, flush, device):
    """Every kernel against its plain version, bf16 and fp32, with and
    without a window; the quantized kernels in int8 and int4; the decode
    also at hymba-1.5B's shapes (its serving run's and a window that binds,
    timed in bf16 with its window and without); the GQA decode and chunked
    prefill and their int8 twins at granite-moe-3b-a800m's serving shape
    (GRANITE_DECODE, timed); the flash kernel on FLASH_CASES (timed on
    FLASH_TIMED); chunk_state and chunk_scan on SSD_CASES and at hymba's
    training shape (HYMBA_SSD_CASE, timed).  Returns the timed results of
    qwen2-1.5B's shapes and SSD_CASES[0] by kernel name (the quantized
    kernels' int8 run; int4's timing and the other models' shapes are
    logged)."""
    from repro_torch.kernels import chunk_scan as CSC
    from repro_torch.kernels import chunk_state as CST
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import mla_paged as MP
    from repro_torch.kernels import mla_paged_quant as MPQ
    from repro_torch.kernels import mla_prefill as MF
    from repro_torch.kernels import mla_prefill_quant as MFQ
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_attention_quant as PAQ
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import prefill_attention_quant as PFQ

    table = {}
    quant = ("int8", "int4")
    # (kernel, check, module, formats, windows, decode shape: None for
    # qwen2-1.5B's, whose bf16 run without a window is the table's row)
    cases = (("paged_attention", check_decode, PA, (None,), (None, 256), None),
             ("paged_attention", check_decode, PA, (None,), (HYMBA_WINDOW, None),
              HYMBA_SERVE_DECODE),
             ("paged_attention", check_decode, PA, (None,), (HYMBA_WINDOW, None),
              HYMBA_DECODE),
             ("paged_attention", check_decode, PA, (None,), (None,), GRANITE_DECODE),
             ("prefill_attention", check_prefill, PF, (None,), (None, 96), None),
             ("prefill_attention", check_prefill, PF, (None,), (None,), GRANITE_DECODE),
             ("paged_attention_quant", check_decode, PAQ, quant, (None, 256), None),
             ("prefill_attention_quant", check_prefill, PFQ, quant, (None, 96), None),
             ("paged_attention_quant", check_decode, PAQ, ("int8",), (None,),
              GRANITE_DECODE),
             ("prefill_attention_quant", check_prefill, PFQ, ("int8",), (None,),
              GRANITE_DECODE),
             *((k, chk, mod, (None,), (None,), shape)
               for shape in (CHATGLM_DECODE, GEMMA_DECODE, DEEPSEEK7B_DECODE)
               for k, chk, mod in (("paged_attention", check_decode, PA),
                                   ("prefill_attention", check_prefill, PF))),
             ("prefill_attention_quant", check_prefill, PFQ, ("int8",), (None,),
              CHATGLM_DECODE),
             ("mla_paged", check_mla_decode, MP, (None,), (None, 256), None),
             ("mla_prefill", check_mla_prefill, MF, (None,), (None, 96), None),
             ("mla_paged_quant", check_mla_decode, MPQ, quant, (None, 256), None),
             ("mla_prefill_quant", check_mla_prefill, MFQ, quant, (None, 96), None))
    for name, check, mod, fmts, windows, shape in cases:
        kw = {} if shape is None else {"shape": shape}
        at = ("" if shape is None else
              f" at {shape.model}'s shape (slots {shape.slots}, max_len {shape.max_len}, "
              f"Hq {shape.hq}, Hkv {shape.hkv}, D {shape.d})")
        for fmt in fmts:
            for dtype in (torch.bfloat16, torch.float32):
                for window in windows:
                    timed = dtype == torch.bfloat16 and (window is None or shape is not None)
                    r = check(torch, np, ref, mod, dtype, window, flush, timed,
                              device, fmt=fmt, **kw)
                    log(f"[kernel] {name}{'' if fmt is None else ' ' + fmt} "
                        f"{str(dtype)[6:]} window={window}{at}"
                        f"{' (tensor cores)' if r.get('tc_launches') else ' (CUDA cores)'}: "
                        f"max abs err {r['err']:.3e}, "
                        f"{attention_limit_text(name, fmt, r, timed)}")
                    if not kernel_ok(r):
                        raise AssertionError(f"{name} {fmt}{at} disagrees with its plain "
                                             "version")
                    # bf16 on the tensor-core path (the GQA kernels at D 64 or
                    # 128), fp32 off it
                    want_tc = (dtype == torch.bfloat16 if name.startswith("mla")
                               else gqa_takes_tensor_cores(dtype, shape))
                    if (name in TC_KERNELS + MLA_TC_KERNELS + QUANT_TC_KERNELS
                            and r["tc_launches"] != int(want_tc)):
                        raise AssertionError(f"{name} {str(dtype)[6:]}{at}: "
                                             f"{r['tc_launches']} tensor-core launches")
                    if timed and fmt in (None, "int8") and shape is None:
                        table[name] = r
    for case in FLASH_CASES:
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16 and case[0] in FLASH_TIMED
            r = check_flash(torch, np, ref, FA, dtype, case, flush, timed, device)
            if "ulps" in r:
                limit = (f"{r['ulps']:.2f} bf16 ulps of the plain value (limit "
                         f"{BF16_ULPS:g}; {controls_text(r)})")
            else:
                limit = f"limit {FP32_ATOL:.0e}"
            if timed:
                limit += (f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                          f"sdpa {r['library_ms']:.4f} ms ({r['library_kernel']}), bound "
                          f"{r['bound_ms']:.4f} ms ({r['bound_by']}); forward + backward: "
                          f"FlashAttentionFn {r['fwd_bwd_ms']:.4f} ms, sdpa "
                          f"{r['sdpa_fwd_bwd_ms']:.4f} ms")
                if case[0] == "train":
                    table["flash_attention"] = r
            _, b, hq, hkv, sq, sk, _, causal = case
            d, dv = flash_widths(case)
            log(f"[kernel] flash_attention {case[0]} {str(dtype)[6:]} (B {b}, Hq {hq}, "
                f"Hkv {hkv}, Sq {sq}, Sk {sk}, D {d}{'' if dv == d else f', Dv {dv}'}, "
                f"causal={causal}){' (tensor cores)' if r['tc_launches'] else ''}: max abs "
                f"err {r['err']:.3e}, {limit}")
            if not kernel_ok(r):
                raise AssertionError(f"flash_attention {case[0]} disagrees with its "
                                     "plain version")
            want_tc = dtype == torch.bfloat16 and (d, dv) in FLASH_TC_PAIRS
            if r["tc_launches"] != int(want_tc):
                raise AssertionError(f"flash_attention {case[0]} {str(dtype)[6:]}: "
                                     f"{r['tc_launches']} tensor-core launches")
    cost = tile_cost(torch, PF, FA, flush, device)
    log("[kernel] tile cost (device us a 64-key tile of the walk; us of the rest of the "
        f"launch): prefill_attention {cost['prefill'][0]:.2f}; {cost['prefill'][1]:.2f} "
        f"(slots {SLOTS}, chunk {CHUNK}: {HKV * (CHUNK // PAGE) * SLOTS} blocks of 2 key "
        f"groups), flash_attention {cost['flash'][0]:.2f}; {cost['flash'][1]:.2f} (B "
        f"{TRAIN_BATCH} x Hq {HQ} x 256 queries: {TRAIN_BATCH * HQ * 2} blocks)")
    per, rest = mla_tile_cost(torch, MF, flush, device)
    log("[kernel] tile cost (device us a 32-key tile of the walk; us of the rest of the "
        f"launch): mla_prefill {per:.2f}; {rest:.2f} (slots {SLOTS}, chunk {CHUNK}, starts "
        f"0 and {MAX_LEN - CHUNK}: {PAGE * MLA_HEADS // 64 * (CHUNK // PAGE) * SLOTS} blocks "
        "of 16 warps)")
    per, rest = quant_tile_cost(torch, ref, PFQ, flush, device)
    log("[kernel] tile cost (device us a 64-key tile of the walk; us of the rest of the "
        f"launch): prefill_attention_quant int8 {per:.2f}; {rest:.2f} (slots {SLOTS}, chunk "
        f"{CHUNK}, starts 0 and {MAX_LEN - CHUNK}: {HKV * (CHUNK // PAGE) * SLOTS} blocks of 2 "
        "key groups, packed tiles staged and dequantized)")
    cost = decode_cost(torch, np, ref, PA, PAQ, flush, device)
    log(f"[kernel] decode cost (device us a call, torch.profiler, {SLOTS * HKV} (slot, kv "
        f"head) pairs x {decode_grid(torch, PA, device)[0]} splits): split kernel "
        f"{cost['fp']['split']:.2f}, merge kernel {cost['fp']['merge']:.2f}; int8 twin "
        f"split kernel {cost['int8']['split']:.2f}, merge kernel {cost['int8']['merge']:.2f}")
    cost = mla_decode_cost(torch, np, ref, MP, MPQ, flush, device)
    log(f"[kernel] MLA decode cost (device us a call, torch.profiler, {SLOTS} slots x "
        f"{mla_decode_grid(torch, MP, device)[0]} splits of {MLA_HEADS} heads): bf16 split "
        f"kernel {cost['fp']['split']:.2f}, merge kernel {cost['fp']['merge']:.2f}; int8 "
        f"split kernel {cost['int8']['split']:.2f}, merge kernel {cost['int8']['merge']:.2f}")
    per, rest = scan_phase_cost(torch, CSC, flush, device)
    log("[kernel] phase cost (chunk_scan on tensor cores, mamba2-2.7B training shapes, 128 "
        f"blocks): device us a head of a block's walk {per:.2f}; us of the rest of the launch "
        f"(C and B in, C B^T once, the first head's operands) {rest:.2f}")
    for case in (*SSD_CASES, HYMBA_SSD_CASE):
        for dtype in (torch.bfloat16, torch.float32):
            timed = dtype == torch.bfloat16 and case in (SSD_CASES[0], HYMBA_SSD_CASE)
            rs = check_ssd_case(torch, np, ref, (CST, CSC), dtype, case, flush, timed,
                                device, earlier=(HYMBA_EARLIER_MS if case is HYMBA_SSD_CASE
                                                 else EARLIER_MS))
            if timed and case is SSD_CASES[0]:
                table.update(rs)
    return table


def attention_limit_text(name, fmt, r, timed, earlier=EARLIER_MS) -> str:
    """An attention check's reading against its limit, its controls, the
    split grid, and when ``timed`` its times and bound."""
    if "ulps" in r:
        limit = (f"{r['ulps']:.2f} bf16 ulps of the plain value (limit "
                 f"{BF16_ULPS:g}; {controls_text(r)})")
    else:
        limit = f"limit {FP32_ATOL:.0e}"
    if "merge_no_rescale" in r:
        limit += (f"; {r['splits']}; control: merge without the rescale "
                  f"{r['merge_no_rescale']:.3g}")
    elif "splits" in r:
        limit += f"; {r['splits']} (no merge to control)"
    if timed:
        if "sdpa_gathered_ms" in r:
            lib = (f"sdpa over pages gathered{'' if fmt is None else ' and dequantized'} "
                   f"(yardstick) {r['sdpa_gathered_ms']:.4f} ms")
        elif fmt is None:
            lib = (f"sdpa {r['library_ms']:.4f} ms (kernel / sdpa "
                   f"{r['ms'] / r['library_ms']:.2f}x)")
        else:
            lib = (f"sdpa over dequantized pages (yardstick) "
                   f"{r['sdpa_dequantized_ms']:.4f} ms")
        limit += (f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"{lib}, bound {r['bound_ms']:.4f} ms ({r['bound_by']})"
                  + (f", before the redesign {earlier[name]} ms"
                     if name in earlier else ""))
    return limit


def check_ssd_case(torch, np, ref, mods, dtype, case, flush, timed, dev, earlier=()):
    """chunk_state and chunk_scan on ``case`` (check_ssd): logs each
    reading, holds it to its limit and each launch to the path
    ``ssd_takes_tensor_cores`` gives it.  Returns {kernel: result}."""
    rs = check_ssd(torch, np, ref, mods, dtype, case, flush, timed, dev)
    _, arch, b, s, decay = case
    for name, r in rs.items():
        if "ulps" in r:
            limit = (f"{r['ulps']:.2f} bf16 ulps of the plain value ("
                     + (f"limit {BF16_ULPS:g}" if r["gated"] else "printed, not gated")
                     + f"; from an fp64 evaluation: the plain version "
                     f"{r['plain_vs_f64_ulps']:.2f}, the kernel "
                     f"{r['kernel_vs_f64_ulps']:.2f}; control with bf16 scores "
                     f"{r['bf16_scores_ulps']:.2f})")
        else:
            limit = (f"{r['err'] / r['scale']:.2e} of max(1, max|plain|) "
                     f"{r['scale']:.3g} (limit {FP32_ATOL:.0e})")
            if "bf16_xd_rel" in r:
                limit += (f"; control with Xd rounded once to bf16 "
                          f"{r['bf16_xd_rel']:.2e}"
                          + ("" if r["xd_gated"] else " (printed, not gated)"))
        if timed:
            limit += (f"; kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                      f"bf16 cuBLAS products (yardstick) {r['yardstick_ms']:.4f} ms, "
                      f"bound {r['bound_ms']:.4f} ms ({r['bound_by']}: "
                      f"{r['bytes'] / 1e6:.1f} MB handed over, broadcast B/C "
                      f"once; {r['flops'] / 1e9:.2f} GFLOP over causal pairs)"
                      + (f", before the redesign {earlier[name]} ms"
                         if name in earlier else ""))
        log(f"[kernel] {name} {case[0]} {str(dtype)[6:]} ({arch}, batch {b} x "
            f"seq {s}, min dA_cum {r['da_min']:.1f})"
            f"{' (tensor cores)' if r['tc_launches'] else ''}: max abs err "
            f"{r['err']:.3e}, {limit}")
        if not ssd_ok(r):
            raise AssertionError(f"{name} {case[0]} disagrees with its plain "
                                 "version")
        want_tc = ssd_takes_tensor_cores(case, str(dtype)[6:])
        if r["tc_launches"] != int(want_tc):
            raise AssertionError(f"{name} {case[0]} {str(dtype)[6:]}: "
                                 f"{r['tc_launches']} tensor-core launches, "
                                 f"expected {int(want_tc)}")
    return rs


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--only", choices=["kernels"], default=None,
                    help="kernels: stop after the kernel phase (a short first "
                         "check)")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources are missing under {SRC}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.configs import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels.build import build_all
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.models import lm

    assert "jax" not in sys.modules and "repro" not in sys.modules
    device = torch.device("cuda")
    card = gpu_line()
    log(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.device_count()} device(s)")

    # ---- phase 1: build ---------------------------------------------------
    t0 = time.perf_counter()
    build_log: dict = {}
    build_all(list(KERNELS.values()), log=build_log)
    log(f"[build] {len(KERNELS)} kernels from {len(build_log)} source(s) compiled in "
        f"{time.perf_counter() - t0:.1f} s (one nvcc a source, in parallel; each library is "
        f"keyed by every csrc/*.cuh, so a header edit rebuilds all of them)")
    for name, text in build_log.items():
        fn = ""
        for line in text.splitlines():  # ptxas -v: one block per function
            if "Function properties for" in line:
                fn = line.split("Function properties for")[-1].strip()
            elif "spill" in line:
                spill = line.strip()
            elif "Used" in line and "registers" in line:
                log(f"[build] {name} {fn}: {line.split(':', 1)[-1].strip()}; {spill}")
        serialized = text.count("(C7514)") + text.count("(C7515)")
        if serialized:  # ptxas waits after every wgmma of a function
            log(f"[build] {name}: {serialized} wgmma serialization notes (C7514 / C7515)")

    # ---- phase 2: kernels vs plain versions -------------------------------
    t0 = time.perf_counter()
    flush_buf = torch.empty(64 << 20, dtype=torch.uint8, device=device)
    table = kernel_phase(torch, np, ref, flush_buf.zero_, device)
    log(f"[time] phase 2 (kernels vs plain versions): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lib, lib_launches = library_phase(torch, ref, flush_buf.zero_, device)
    del flush_buf
    for r in lib:
        log_library(r)
        if not library_ok(r):
            raise AssertionError(f"{r['kernel']} {r['label']} fails its limit or a fault "
                                 "passes it")
        if r["label"] == LIBRARY_ROWS[r["kernel"]]:
            table[r["kernel"]] = r
    gemm_wgmma, mla_wgmma = wgmma_gate(lib)
    log(f"[launches] Table 2's M shapes on wgmma: {json.dumps(gemm_wgmma)}")
    log(f"[launches] FlashMLA's cases on wgmma: {json.dumps(mla_wgmma)}")
    from repro_torch.kernels import mla as lib_mla
    per, rest, rate = lib_mla_tile_cost(lib, lib_mla.TC_KEYS)
    log(f"[kernel] tile cost (device us a {lib_mla.TC_KEYS}-key tile of the walk; us of the "
        f"rest of the launch): mla (FlashMLA, wgmma) {per:.3f}; {rest:.2f} (b64, s 1024 and "
        f"4096: 128 blocks of 64 heads, one wave; the pair's tensor work {rate:.2f} TFLOP/s "
        f"an SM, {rate / (BF16_FLOPS / 132e12):.0%} of its share of the dense peak)")
    log(f"[launches] the library's path: {json.dumps(lib_launches)}")
    if not all(lib_launches.values()):
        raise AssertionError(f"a library kernel was not launched on its path: {lib_launches}")
    log(f"[time] phase 2, the kernel library ({len(lib)} cases): "
        f"{time.perf_counter() - t0:.1f} s")
    if args.only == "kernels":
        log(json.dumps({"kernels_checked": sorted(table)}))
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    cfg = get_config("qwen2_1_5b")
    main_launches = serving_phases(torch, np, lm, cfg, KERNELS, device)
    main_launches["flash_attention"] = training_phase(torch, np, lm, cfg, device)
    torch.cuda.empty_cache()
    main_launches.update(ssm_phase(torch, np, lm, device))
    torch.cuda.empty_cache()
    hybrid_phase(torch, np, lm, device)
    torch.cuda.empty_cache()
    granite_phase(torch, np, lm, device)
    torch.cuda.empty_cache()
    whisper_phase(torch, np, device)
    torch.cuda.empty_cache()
    vlm_phase(torch, np, lm, device)
    torch.cuda.empty_cache()
    dense_phase(torch, np, lm, device)
    torch.cuda.empty_cache()
    fault_phase(torch, np, lm, device)
    torch.cuda.empty_cache()
    mla_training_phase(torch, np, lm, device)
    main_launches.update(lib_launches)

    # ---- result lines --------------------------------------------------
    rows = []
    for name, k in KERNELS.items():
        r = table[name]  # the quantized kernels: their int8 timing
        rows.append({
            "name": name, "route": "cuda",
            "source": str(k.source.relative_to(ROOT)), "replaces": k.replaces,
            "launches": main_launches[name], "max_abs_err": r.get("max_abs_err", r["err"]),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    log(card)
    log(json.dumps({"kernels": rows}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def serving_phases(torch, np, lm, cfg, KERNELS, device):
    """Phases 3 and 4 for qwen2-1.5B, then for deepseek-v2-lite-16B.
    Returns each serving kernel's launches on its own path's run."""
    # ---- phase 3: serve full-width qwen2-1.5B at QWEN_SERVE_LAYERS --------
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    served = dataclasses.replace(cfg, num_layers=QWEN_SERVE_LAYERS)
    params = lm.init(served, 0, device=device)
    torch.cuda.synchronize()
    log(f"[serve] {cfg.name}, {served.num_layers} of its {cfg.num_layers} layers: "
        f"{lm.param_count(params) / 1e9:.3f} B params ({cfg.dtype}) initialised on "
        f"the card in {time.perf_counter() - t0:.1f} s")
    runs = serving_phase(torch, np, lm, served, params, KERNELS, device)
    # each kernel's launches on its own path's run
    main_launches = {**runs["fp, default pool"][3],
                     **{k: runs["int8, default pool"][3][k] for k in QUANT_KERNELS}}
    log(f"[time] phase 3 ({cfg.name} serving): {time.perf_counter() - t0:.1f} s")
    sampling_spec_phase(torch, np, lm, served, params, KERNELS, device, runs)
    del params, runs
    torch.cuda.empty_cache()

    # ---- phase 4: teacher-forced, card bf16 vs CPU fp32 -------------------
    t_phase = time.perf_counter()
    for kv_dtype in (None, "int8", "int4"):
        t0 = time.perf_counter()
        cfg4 = dataclasses.replace(cfg, num_layers=4, kv_dtype=kv_dtype)
        label = f"{cfg.name}, 4 layers at full width, {kv_dtype or 'fp'} KV"
        if kv_dtype == "int4":
            tf, shared = teacher_forced(torch, np, lm, cfg4, device, shared_codes=True)
            log_teacher_forced(label, tf, False, time.perf_counter() - t0)
            log_teacher_forced(label + ", the CPU on the card's codes", shared, True,
                               time.perf_counter() - t0)
            assert teacher_forced_ok(shared), (kv_dtype, shared)
            continue
        tf = teacher_forced(torch, np, lm, cfg4, device)
        log_teacher_forced(label, tf, True, time.perf_counter() - t0)
        assert teacher_forced_ok(tf), (kv_dtype, tf)
    log(f"[time] phase 4 ({cfg.name} teacher-forced): "
        f"{time.perf_counter() - t_phase:.1f} s")

    # ---- phase 3, MLA + MoE: serve full-width deepseek-v2-lite-16B --------
    # depth cut to MLA_SERVE_LAYERS to keep the script in its time limit
    mla = dataclasses.replace(get_config("deepseek_v2_lite_16b"),
                              num_layers=MLA_SERVE_LAYERS)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = lm.init(mla, 0, device=device)
    torch.cuda.synchronize()
    log(f"[serve] {mla.name}, {mla.num_layers} of its 27 layers: "
        f"{lm.param_count(params) / 1e9:.3f} B params "
        f"({mla.dtype}, router fp32) initialised on the card in "
        f"{time.perf_counter() - t0:.1f} s, peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB allocated")
    runs = mla_serving_phase(torch, np, lm, mla, params, KERNELS, device)
    main_launches.update({**{k: runs["fp"][3][k] for k in MLA_FP_KERNELS},
                          **{k: runs["int8"][3][k] for k in MLA_QUANT_KERNELS}})
    del params, runs
    torch.cuda.empty_cache()
    log(f"[time] phase 3 ({mla.name} serving): {time.perf_counter() - t0:.1f} s")
    mla_spec_phase(torch, np, lm, mla, KERNELS, device)

    # ---- phase 4, MLA + MoE: teacher-forced at full width, 2 layers -------
    t_phase = time.perf_counter()
    for kv_dtype in (None, "int8", "int4"):
        t0 = time.perf_counter()
        cfg2 = dataclasses.replace(mla, num_layers=2, kv_dtype=kv_dtype)
        label = (f"{mla.name}, 2 layers (dense prefix + MoE) at full width, "
                 f"{kv_dtype or 'fp'} KV (argmax printed)")
        if kv_dtype == "int4":
            tf, shared = teacher_forced(torch, np, lm, cfg2, device, shared_codes=True)
            log_teacher_forced(label, tf, False, time.perf_counter() - t0)
            log_teacher_forced(label + ", the CPU on the card's codes", shared, True,
                               time.perf_counter() - t0)
            assert teacher_forced_ok(shared, argmax=False), (kv_dtype, shared)
            continue
        tf = teacher_forced(torch, np, lm, cfg2, device)
        log_teacher_forced(label, tf, True, time.perf_counter() - t0)
        assert teacher_forced_ok(tf, argmax=False), (kv_dtype, tf)
    log(f"[time] phase 4 ({mla.name} teacher-forced): "
        f"{time.perf_counter() - t_phase:.1f} s")
    return main_launches


def training_phase(torch, np, lm, cfg, device) -> int:
    """Phase 5: full-width qwen2-1.5B trains TRAIN_STEPS steps through the
    flash kernel (twice a layer a step: the forward, and its recompute under
    the per-layer checkpoint), with two more steps profiled; the depth-2
    card-vs-CPU check of the loss and gradient; and the training CLI on the
    reduced model recovering from injected failures.  Returns the flash
    kernel's launches over the TRAIN_STEPS steps."""
    import tempfile

    t_phase = time.perf_counter()
    launches = train_full_width(torch, np, cfg, device, TRAIN_FLASH, tc_kernels=TRAIN_FLASH)
    log(f"[time] phase 5 ({cfg.name} training): {time.perf_counter() - t_phase:.1f} s")
    depth2_phase(torch, np, lm, cfg, device, TRAIN_FAULTS)

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as ckpt_dir:
        res, cli_launches = recovery_run(torch, device, ckpt_dir)
    loss = res["last_metrics"]["loss"].item()
    log(f"[train] reduced CLI with injected failures: {res['steps']} steps, "
        f"{res['restarts']} restarts, final loss {loss:.4f}, flash_attention "
        f"launches {cli_launches}, {time.perf_counter() - t0:.1f} s")
    assert res["restarts"] >= 1 and res["steps"] == 20 and np.isfinite(loss)
    assert cli_launches > 0 or device.type != "cuda"
    return launches["flash_attention"]


# ---------------------------------------------------------------------------
# phase 6: the Mamba-2 SSM family (mamba2-2.7B)
# ---------------------------------------------------------------------------

SSM_ARCH = "mamba2_2_7b"
SSM_KERNELS = ("chunk_state", "chunk_scan")
SSM_TC_KERNELS = SSM_KERNELS  # every forward launch on tensor cores
# Limits of the SSM's depth-2 check beyond phase 5's (0.02 nats and 5% of
# grad norm against the card's plain path, 5% of grad norm against the CPU):
# the loss within SSM_LOSS_CPU_NATS of the CPU's fp32 one, and the least
# cosine of a ``layers/mamba/*`` gradient with the CPU's.  SSM_FAULTS are run
# in the kernels' place and must each fail the limits.
# On an H100 80GB HBM3 at 700 W the kernel path read 0.999909 (1 - cos
# 9.1e-5) and the faults 0.015, 0.995800 (4.2e-3: the carried state
# dropped, which moves only the first rows of the second chunk) and NaN
# (the first-row decay overflows); 0.9994 (6e-4) sits about 7x from the
# sound reading and from the subtlest fault.  The loss against the CPU read
# 2.9e-5 nats.
SSM_LOSS_CPU_NATS = 0.02
SSM_COS_MIN = 0.9994
SSM_FAULTS = ("scan without the causal mask", "carried state dropped",
              "state decay from the first row")


def ssd_fault(torch, ref, fault):
    """(chunk_state, chunk_scan) plain versions with one planted fault: the
    scan keeps its decay select but not the causal zeroing (later tokens
    leak into earlier outputs); the scan drops the state carried into each
    chunk; or the state weighs each row by its decay from the chunk's first
    row instead of to its last."""
    if fault == "scan without the causal mask":
        return ref.chunk_state, lambda *a: scan_variant(torch, *a, causal=False)
    if fault == "carried state dropped":
        return ref.chunk_state, lambda c, b, x, da, prev: ref.chunk_scan(
            c, b, x, da, torch.zeros_like(prev))
    assert fault == "state decay from the first row", fault

    def state(b, x, da):
        w = torch.exp(da[..., :1] - da)
        return torch.einsum("...cln,...clp->...cnp", b.float() * w[..., None], x.float())
    return state, ref.chunk_scan


@contextlib.contextmanager
def ssd_as(ops, chunk_state, chunk_scan):
    """Inside the block, ``ops.chunk_state``/``ops.chunk_scan`` are the given
    functions on every device (the plain versions, or a planted fault)."""
    saved = ops.chunk_state, ops.chunk_scan
    ops.chunk_state, ops.chunk_scan = chunk_state, chunk_scan
    try:
        yield
    finally:
        ops.chunk_state, ops.chunk_scan = saved


def logit_agreement(torch, got_rows, want_rows):
    """Teacher-forced logits ``got_rows`` against ``want_rows`` (one row a
    step), as phase 4 reads them (:func:`step_agreement`): the worst error,
    the fewest top 10 kept, the steps whose argmax agrees, and each
    disagreeing step's top-2 margin and error (std).  ``argmax_wide`` counts the steps whose reference top-2
    margin exceeds twice the step's max |diff| and ``argmax_wide_ok`` those
    of them that agree: there the error cannot swap the two tokens."""
    res = {"err": 0.0, "top10": TOPK, "argmax": 0, "steps": 0, "swaps": [],
           "argmax_wide": 0, "argmax_wide_ok": 0}
    for step, (got, want) in enumerate(zip(got_rows, want_rows)):
        err, common, hit, margin = step_agreement(torch, got, want)
        if not hit:
            res["swaps"].append((step, margin, err))
        if margin > 2 * err:
            res["argmax_wide"] += 1
            res["argmax_wide_ok"] += hit
        res["err"] = max(res["err"], err)
        res["top10"] = min(res["top10"], common)
        res["argmax"] += hit
        res["steps"] += 1
    return res


def agreement_ok(r) -> bool:
    return (r["err"] <= TF_STD_LIMIT and r["top10"] >= TF_TOP10_MIN
            and r["argmax_wide_ok"] == r["argmax_wide"])


def log_agreement(label, r):
    log(f"[e2e] {label}, {r['steps']} steps: worst max|diff| {r['err']:.3e} "
        f"standard deviations of the reference logits (limit {TF_STD_LIMIT:g}), "
        f"fewest top-{TOPK} tokens kept {r['top10']} (limit {TF_TOP10_MIN}), "
        f"argmax agrees at {r['argmax']}/{r['steps']} steps, at "
        f"{r['argmax_wide_ok']}/{r['argmax_wide']} of those whose top-2 margin "
        "exceeds twice their max|diff| (gated)"
        + "".join(f" (step {i}: top-2 margin {m:.3e} std, max|diff| {e:.3e} std)"
                  for i, m, e in r["swaps"][:8]))


def ssm_forward_vs_decode(torch, np, lm, cfg4, dev, seq=256):
    """The reference's test_decode_matches_forward_ssm (tests/test_models.py:
    112) at full width: one seeded sequence of ``seq`` tokens (two chunks of
    128, so the carried state matters) through ``forward`` on the card (bf16,
    the SSD kernels) and through ``decode_step`` token by token on the card
    (bf16, the plain recurrence, which shares no code with the kernels);
    and the card's bf16 forward against the CPU's fp32 forward of the same
    weights upcast.  Returns the two ``logit_agreement`` readings and the
    kernels' launches in the card's forward."""
    from repro_torch.kernels.ops import KERNELS

    params = lm.init(cfg4, 7, device=dev)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg4.vocab_size, size=(1, seq)), dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    with torch.no_grad():
        for k in KERNELS.values():
            k.launches = 0
        full, _ = lm.forward(params, cfg4, toks)
        launches = {k: KERNELS[k].launches for k in SSM_KERNELS}
        full = full[0].float().cpu()
        cache = lm.init_cache(cfg4, 1, seq, layout="contiguous", device=dev)
        steps = []
        for t in range(seq):
            logits, cache = lm.decode_step(params, cfg4, cache, toks[:, t], t)
            steps.append(logits[0].float().cpu())
        cfg32 = dataclasses.replace(cfg4, dtype="float32")
        full32, _ = lm.forward(_tree_to(torch, params, cpu, torch.float32), cfg32,
                               toks.cpu())
    return (logit_agreement(torch, steps, full),
            logit_agreement(torch, full, full32[0]), launches)


def ssm_serving_phase(torch, np, lm, cfg, params, kernels, device):
    """Phase 6 serving: the phase 3 workload's first SSM_SERVE_REQUESTS
    requests through the contiguous recurrent-state cache (prompts replayed a token a tick, as the
    reference), per tick and with ``sync_every=16`` under the no-host-sync
    check.  The window's outputs are byte-identical to per-tick's, with
    equal ticks and mean TTFT and fewer host dispatches; no kernel launches
    (the SSD kernels serve the full-sequence forward only)."""
    runs = {}
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    kw = dict(cache="contiguous", requests=SSM_SERVE_REQUESTS)
    tick, tick_reqs = run("contiguous, per tick", (), **kw)
    with strict_windows(torch, lm, device):
        win, win_reqs = run("contiguous, sync_every=16", (), sync_every=16, **kw)
    assert tick.prefill_mode == "replay" and tick.pool is None
    assert win.steps_run == tick.steps_run and mean_ttft(win_reqs) == mean_ttft(tick_reqs)
    assert win.decode_windows > 0 and win.dispatches < tick.dispatches
    assert [r.output for r in win_reqs] == [r.output for r in tick_reqs]
    log(f"[serve] {cfg.name} sync_every=16: outputs byte-identical to per-tick; "
        f"{win.dispatches} dispatches ({win.decode_windows} windows, no host "
        f"sync inside) against {tick.dispatches}; SSD kernel launches "
        + ", ".join(f"{k} {runs['contiguous, per tick'][3][k]}" for k in SSM_KERNELS))
    return runs


def train_full_width(torch, np, cfg, device, kernels, tc_kernels=(), per_step=None,
                     batch=TRAIN_BATCH, seq=TRAIN_SEQ, extra=None, shape_text=""):
    """TRAIN_STEPS steps of full-width ``cfg`` at ``batch`` x ``seq`` (with
    ``extra`` inputs, described by ``shape_text``), two more profiled; logs
    them and checks every loss and grad norm finite, the loss falling,
    every launch of ``tc_kernels`` on its tensor-core path, and each of
    ``kernels`` (and no other kernel) launched ``per_step`` times a step on
    a card (default twice a layer: each layer's forward and its recompute).
    Returns the launches by kernel."""
    import statistics

    tr = train_steps(torch, cfg, device, TRAIN_STEPS, batch, seq, profile_steps=2,
                     extra=extra)
    del tr["state"]
    med = statistics.median(tr["seconds"][1:])
    per_step = per_step or 2 * cfg.num_layers
    log(f"[train] {cfg.name} full width, {cfg.dtype}, batch {batch} x seq "
        f"{seq}{shape_text}, AdamW (peak lr 3e-4, warmup 1, {TRAIN_STEPS} steps): step "
        f"time {med * 1e3:.1f} ms (median of steps 2-{TRAIN_STEPS}; first "
        f"{tr['seconds'][0] * 1e3:.1f} ms), {batch * seq / med:.0f} "
        f"tokens/s, peak {tr['peak_gib']:.2f} GiB allocated; losses "
        + " ".join(f"{x:.4f}" for x in tr["losses"]) + "; grad norms "
        + " ".join(f"{x:.3f}" for x in tr["gnorms"])
        + f"; launches {tr['launches']} ({per_step} a step each)"
        + (f", of them on tensor cores {tr['tc_launches']}" if tc_kernels else ""))
    prof = dict(tr["profile"])
    top = prof.pop("top")
    log(f"[train] profile of 2 more steps: wall {tr['profile_wall'] * 1e3:.1f} ms; "
        + ", ".join(f"{k} {v:.1f} ms" for k, v in prof.items()) + "; top kernels: "
        + "; ".join(f"{name} x{n} {ms:.1f} ms" for name, n, ms in top))
    assert all(np.isfinite(tr["losses"])) and all(np.isfinite(tr["gnorms"])), tr
    assert tr["losses"][-1] < tr["losses"][0], tr["losses"]
    want = ({k: per_step * TRAIN_STEPS for k in kernels}
            if device.type == "cuda" else {})
    assert tr["launches"] == want, tr["launches"]
    assert tr["tc_launches"] == {k: want[k] for k in tc_kernels if k in want}, tr
    return {k: tr["launches"].get(k, 0) for k in kernels}


def depth2_phase(torch, np, lm, cfg, device, faults, shared_routing=False):
    """The depth-2 card-vs-CPU check of one training step (full width,
    batch 2 x seq 256; ``shared_routing``: every run on the kernel path's
    MoE routing): logs every run's readings, holds the kernel path to the
    limits and each planted fault of ``faults`` outside them."""
    t0 = time.perf_counter()
    cfg2 = dataclasses.replace(cfg, num_layers=2)
    r = train_card_vs_cpu(torch, np, lm, cfg2, device, shared_routing=shared_routing)
    plain_label, loss_cpu, cos_min, cos_name = depth2_limits(r)
    (loss32, gnorm32, _), (plain, gplain, _) = r["cpu fp32"], r[plain_label]
    log(f"[train] {cfg.name} 2 layers at full width, batch 2 x seq 256, one "
        f"step's loss, grad norm and least {cos_name} with CPU fp32"
        f"{' (every run on the card kernel path MoE routing)' if shared_routing else ''}: "
        + "; ".join(
            f"{label} {lo:.4f} nats (from CPU fp32 {abs(lo - loss32):.4f}, "
            f"{abs(lo - loss32) / abs(loss32):.2e} of it; from card plain "
            f"{abs(lo - plain):.4f}), grad norm {gn:.4f} (ratio to CPU "
            f"{gn / gnorm32:.5f}, to card plain {gn / gplain:.5f}), cosine "
            f"{cos:.6f}" + ("" if label in ("cpu fp32", plain_label)
                            else f", fails {train_limits_failed(r, label) or 'none'}")
            for label, (lo, gn, cos) in ((k, r[k]) for k in r if k != "cosines"))
        + f"; limits: {TRAIN_LOSS_NATS} nats and grad norm {TRAIN_GNORM_RATIO:.0%} "
        f"against card plain, {loss_cpu:.4g} nats and grad norm "
        f"{TRAIN_GNORM_RATIO:.0%} against CPU fp32, {cos_name} >= {cos_min:g}; "
        f"{time.perf_counter() - t0:.1f} s")
    log("[train] per-leaf gradient cosine, card bf16 kernel path vs CPU fp32: "
        + ", ".join(f"{name} {c:.5f}" for name, c in r["cosines"].items()))
    assert train_card_vs_cpu_ok(r), r
    for fault in faults:  # the planted faults must fail the limits
        assert not train_card_vs_cpu_ok(r, f"fault: {fault}"), (fault, r)


def ssm_phase(torch, np, lm, device):
    """Phase 6, full-width mamba2-2.7B (64 layers, d 2560, 80 heads of P 64,
    N 128, bf16 with fp32 a_log/d_skip/dt_bias): training through the two
    SSD kernels (TRAIN_STEPS steps and two profiled), the depth-2 check with
    the SSD faults, forward against decode at depth 4, and serving through
    the contiguous cache at SSM_SERVE_LAYERS of its layers.  Returns the
    kernels' launches over the training steps."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KERNELS

    cfg = get_config(SSM_ARCH)
    t_phase = time.perf_counter()
    launches = train_full_width(torch, np, cfg, device, SSM_KERNELS,
                                tc_kernels=SSM_TC_KERNELS)
    torch.cuda.empty_cache()
    log(f"[time] phase 6 ({cfg.name} training): {time.perf_counter() - t_phase:.1f} s")
    t_phase = time.perf_counter()
    depth2_phase(torch, np, lm, cfg, device, SSM_FAULTS)

    t0 = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, num_layers=4)
    vs_decode, vs_cpu, fwd_launches = ssm_forward_vs_decode(torch, np, lm, cfg4, device)
    log_agreement(f"{cfg.name}, 4 layers at full width, card bf16 forward (SSD "
                  f"kernels, launches {fwd_launches}) vs card bf16 decode_step "
                  "(the recurrence)", vs_decode)
    log_agreement(f"{cfg.name}, 4 layers at full width, card bf16 forward vs CPU "
                  "fp32 forward", vs_cpu)
    log(f"[time] phase 6 ({cfg.name} depth-2 check and forward vs decode): "
        f"{time.perf_counter() - t_phase:.1f} s (forward vs decode "
        f"{time.perf_counter() - t0:.1f} s)")
    assert agreement_ok(vs_decode) and agreement_ok(vs_cpu), (vs_decode, vs_cpu)
    assert all(n == cfg4.num_layers for n in fwd_launches.values()), fwd_launches

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(cfg, num_layers=SSM_SERVE_LAYERS)
    params = lm.init(cfg, 0, device=device)
    log(f"[serve] {cfg.name}, {cfg.num_layers} of its 64 layers: "
        f"{lm.param_count(params) / 1e9:.3f} B params ({cfg.dtype}, "
        "a_log/d_skip/dt_bias fp32) initialised on the card")
    ssm_serving_phase(torch, np, lm, cfg, params, KERNELS, device)
    del params
    torch.cuda.empty_cache()
    log(f"[time] phase 6 ({cfg.name} serving): {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 7: the hybrid family (hymba-1.5B)
# ---------------------------------------------------------------------------

HYBRID_ARCH = "hymba_1_5b"
HYBRID_SERVE_KERNELS = ("paged_attention",)  # replayed prompts: no prefill kernel
HYBRID_SERVE_REQUESTS = 8
# the window check: 4 layers at full width (layer 1 windowed; 0, 2 and 3
# global), one slot over 64 tokens past the window of 1024, read at its
# first 8 positions and its last 64
HYBRID_WINDOW_LAYERS = 4
HYBRID_WINDOW_TOKENS = HYMBA_WINDOW + 64
HYBRID_READ = (range(0, 8), range(HYMBA_WINDOW, HYBRID_WINDOW_TOKENS))
# the fp32 run's limit (std of the reference logits): fp32 on both sides,
# the recurrence against the chunked forward; the window moves the read
# logits by some 3e-2 std, so a decode that ignored it fails
HYBRID_FP32_STD_LIMIT = 1e-3


def hybrid_serving_phase(torch, np, lm, cfg, params, kernels, device):
    """Phase 7 serving: the phase 3 workload's first HYBRID_SERVE_REQUESTS
    requests through the paged cache, prompts replayed a token a tick (no
    prefill kernel, no prefix cache: recurrent state must replay), per tick
    and with ``sync_every=16`` under the no-host-sync check.  Every launch is
    the decode's, once a layer a tick, on its tensor-core path; the window's
    outputs are byte-identical to per-tick's, with equal ticks and mean TTFT
    and fewer host dispatches."""
    runs = {}
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    kw = dict(requests=HYBRID_SERVE_REQUESTS)
    tick, tick_reqs = run("paged, per tick", HYBRID_SERVE_KERNELS, HYBRID_SERVE_KERNELS,
                          **kw)
    with strict_windows(torch, lm, device):
        win, win_reqs = run("paged, sync_every=16", HYBRID_SERVE_KERNELS,
                            HYBRID_SERVE_KERNELS, sync_every=16, **kw)
    assert tick.prefill_mode == "replay" and tick.prefix is None and tick.pool is not None
    assert win.steps_run == tick.steps_run and mean_ttft(win_reqs) == mean_ttft(tick_reqs)
    assert win.decode_windows > 0 and win.dispatches < tick.dispatches
    assert [r.output for r in win_reqs] == [r.output for r in tick_reqs]
    log(f"[serve] {cfg.name} sync_every=16: outputs byte-identical to per-tick; "
        f"{win.dispatches} dispatches ({win.decode_windows} windows, no host sync "
        f"inside) against {tick.dispatches}")
    return runs


def hybrid_window_check(torch, np, lm, cfg4, dev, seq=HYBRID_WINDOW_TOKENS,
                        read=HYBRID_READ):
    """A window that binds: slot 0 decodes ``seq`` seeded tokens through
    ``decode_step`` on the card (the decode kernel over pages, the
    recurrence) in bf16, and again in fp32 on the same weights upcast, while
    slot 1 stays parked (``live`` False) with random recurrent rows; the
    logits at the positions of ``read`` against the CPU's fp32 ``forward``
    of the same tokens on the same weights upcast.  Returns the
    ``logit_agreement`` readings by label: "bf16", "fp32", and "fp32, no
    window" (the fp32 decode's late positions against a CPU forward with no
    window at all: what a decode that ignored the window would read);
    whether the parked slot's rows came back bit-identical in both runs;
    and the kernels' launches and tensor-core launches over the steps."""
    from repro_torch.kernels.ops import KERNELS

    cpu = torch.device("cpu")
    params = lm.init(cfg4, 7, device=dev)
    runs = {"bf16": (cfg4, params),
            "fp32": (dataclasses.replace(cfg4, dtype="float32"),
                     _tree_to(torch, params, dev, torch.float32))}
    toks = np.random.default_rng(5).integers(0, cfg4.vocab_size, size=seq)
    pages = -(-seq // PAGE)
    tables = np.arange(1, 2 * pages + 1, dtype=np.int32).reshape(2, pages)
    tables = torch.as_tensor(tables, device=dev)
    g = torch.Generator(device=dev).manual_seed(3)
    caches, parked = {}, {}
    for label, (c, _) in runs.items():
        cache = lm.init_cache(c, 2, seq, page_size=PAGE, num_blocks=2 * pages + 1,
                              device=dev).with_tables(tables)
        for name in ("ssm", "conv"):
            rows = cache.kv[name][:, 1]
            rows.copy_(torch.randn(rows.shape, generator=g, device=dev))
        caches[label] = cache
        parked[label] = {k: cache.kv[k][:, 1].clone() for k in ("ssm", "conv")}
    live = torch.tensor([True, False], device=dev)
    steps = sorted(t for r in read for t in r)
    got = {label: {} for label in runs}
    for k in KERNELS.values():
        k.launches = k.tc_launches = 0
    with torch.no_grad():
        for t in range(seq):
            tok = torch.tensor([int(toks[t]), 0], dtype=torch.int32, device=dev)
            pos = torch.tensor([t, 0], dtype=torch.int32, device=dev)
            for label, (c, p) in runs.items():
                logits, caches[label] = lm.decode_step(p, c, caches[label], tok, pos,
                                                       live=live)
                if t in steps:
                    got[label][t] = logits[0].float().cpu()
        launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
        tc = {n: k.tc_launches for n, k in KERNELS.items() if k.tc_launches}
        held = all(torch.equal(caches[label].kv[k][:, 1], v)
                   for label in runs for k, v in parked[label].items())
        p32 = _tree_to(torch, params, cpu, torch.float32)
        tokens = torch.as_tensor(toks[None], dtype=torch.int32)
        want = {}
        for label, window in (("windowed", cfg4.sliding_window), ("no window", None)):
            c32 = dataclasses.replace(cfg4, dtype="float32", sliding_window=window)
            full, _ = lm.forward(p32, c32, tokens)
            want[label] = [full[0, t] for t in steps]
            del full
    rows = {label: [got[label][t] for t in steps] for label in runs}
    late = len(read[0])
    return ({"bf16": logit_agreement(torch, rows["bf16"], want["windowed"]),
             "fp32": logit_agreement(torch, rows["fp32"], want["windowed"]),
             "fp32, no window": logit_agreement(torch, rows["fp32"][late:],
                                                want["no window"][late:])},
            held, launches, tc)


def hybrid_window_ok(r) -> bool:
    """Phase 4's limits on both runs; the fp32 run within
    HYBRID_FP32_STD_LIMIT, which a decode that ignored the window exceeds."""
    return (agreement_ok(r["bf16"]) and agreement_ok(r["fp32"])
            and r["fp32"]["err"] <= HYBRID_FP32_STD_LIMIT < r["fp32, no window"]["err"])


def hybrid_phase(torch, np, lm, device):
    """Phase 7, full-width hymba-1.5B (32 layers, d 1600, 25 query heads over
    5 KV heads of 64, a window of 1024 on 29 layers, 64 SSM heads of P 50
    with N 16, bf16 with fp32 a_log/d_skip/dt_bias): serving through the
    paged cache (per tick and in windows), the window check at depth 4,
    training through the two SSD kernels on CUDA cores (TRAIN_STEPS steps
    and two profiled; no flash kernel: every layer's attention carries a
    window, so the plain version runs, as the reference routes it), and the
    depth-2 check with the SSD faults.  Returns each path's kernel launches:
    the per-tick serving run's, the training steps'."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KERNELS

    cfg = get_config(HYBRID_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = dataclasses.replace(cfg, num_layers=HYBRID_SERVE_LAYERS)
    params = lm.init(served, 0, device=device)
    log(f"[serve] {cfg.name}, {served.num_layers} of its {cfg.num_layers} layers: "
        f"{lm.param_count(params) / 1e9:.3f} B params ({cfg.dtype}, "
        "a_log/d_skip/dt_bias fp32) initialised on the card; windows "
        f"{sum(w is not None for w in lm.static_windows(served))} of "
        f"{served.num_layers} layers")
    runs = hybrid_serving_phase(torch, np, lm, served, params, KERNELS, device)
    launches = {k: runs["paged, per tick"][3][k] for k in HYBRID_SERVE_KERNELS}
    del params, runs
    torch.cuda.empty_cache()
    log(f"[time] phase 7 ({cfg.name} serving): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    cfg4 = dataclasses.replace(cfg, num_layers=HYBRID_WINDOW_LAYERS)
    r, held, w_launches, w_tc = hybrid_window_check(torch, np, lm, cfg4, device)
    read_text = " and ".join(f"{rg[0]}-{rg[-1]}" for rg in HYBRID_READ)
    for label in ("bf16", "fp32"):
        log_agreement(f"{cfg.name}, {cfg4.num_layers} layers at full width (windows "
                      f"{lm.static_windows(cfg4)}), card {label} decode_step over "
                      f"{HYBRID_WINDOW_TOKENS} tokens vs CPU fp32 forward, positions "
                      f"{read_text}", r[label])
    log(f"[e2e] {cfg.name} window control: the card's fp32 logits {r['fp32']['err']:.3e} "
        f"std from the CPU's windowed forward (limit {HYBRID_FP32_STD_LIMIT:g}), "
        f"{r['fp32, no window']['err']:.3e} std from a CPU forward with no window at "
        f"positions {read_text.split(' and ')[-1]} (must exceed the limit); the parked "
        f"slot's recurrent rows bit-identical: {held}; launches {w_launches}, on "
        f"tensor cores {w_tc} (the bf16 run's)")
    assert hybrid_window_ok(r) and held, (r, held)
    per_run = HYBRID_WINDOW_TOKENS * cfg4.num_layers
    assert w_launches == {"paged_attention": 2 * per_run}, w_launches
    assert w_tc == {"paged_attention": per_run}, w_tc
    torch.cuda.empty_cache()
    log(f"[time] phase 7 ({cfg.name} window check): {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    launches.update(train_full_width(torch, np, cfg, device, SSM_KERNELS))
    torch.cuda.empty_cache()
    log(f"[time] phase 7 ({cfg.name} training): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    depth2_phase(torch, np, lm, cfg, device, SSM_FAULTS)
    log(f"[time] phase 7 ({cfg.name} depth-2 check): {time.perf_counter() - t0:.1f} s")
    log(f"[launches] {cfg.name}'s paths: {json.dumps(launches)}")
    return launches



# ---------------------------------------------------------------------------
# phase 8: GQA + MoE (granite-moe-3b-a800m)
# ---------------------------------------------------------------------------

GRANITE_ARCH = "granite_moe_3b_a800m"


def granite_serving_phase(torch, np, lm, cfg, params, kernels, device):
    """Phase 8 serving: the phase 3 workload through the paged cache with
    chunked prefill and the prefix cache, fp and int8 pages.  Every decode
    and prefill launch on its tensor-core path; ticks and mean TTFT equal
    across the two (scheduling depends only on the prompt lengths)."""
    runs = {}
    run = make_runner(torch, np, cfg, params, kernels, device, runs)
    fp, fp_reqs = run("fp, default pool", FP_KERNELS, TC_KERNELS)
    q8, q8_reqs = run("int8, default pool", QUANT_KERNELS, QUANT_TC_KERNELS,
                      kv_dtype="int8")
    assert fp.pages_shared > 0 and fp.prefill_mode == "chunked"
    assert q8.steps_run == fp.steps_run and mean_ttft(q8_reqs) == mean_ttft(fp_reqs)
    match = sum(x == y for a, b in zip(q8_reqs, fp_reqs) for x, y in zip(a.output, b.output))
    log(f"[serve] {cfg.name} int8 vs fp: {q8.cache.kv_bytes() / fp.cache.kv_bytes():.3f}x "
        f"the KV bytes; tokens equal to fp's {match}/{sum(len(r.output) for r in fp_reqs)}")
    return runs


def granite_phase(torch, np, lm, device):
    """Phase 8, full-width granite-moe-3b-a800m (32 layers, d 1536, 24
    query heads over 8 KV heads of 64, 40 experts of width 512, top 8,
    tied embeddings; bf16 with an fp32 router): serving at
    GRANITE_SERVE_LAYERS layers (fp and int8 pages); teacher-forced
    logits at depth 4 against the CPU's fp32 on the card's routing (and, printed,
    on its own); training through the flash kernel (TRAIN_STEPS steps and
    two profiled).  Returns each path's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KERNELS

    cfg = get_config(GRANITE_ARCH)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    served = dataclasses.replace(cfg, num_layers=GRANITE_SERVE_LAYERS)
    params = lm.init(served, 0, device=device)
    log(f"[serve] {cfg.name}, {served.num_layers} of its {cfg.num_layers} layers: "
        f"{lm.param_count(params) / 1e9:.3f} B params ({cfg.dtype}, router fp32) "
        "initialised on the card")
    runs = granite_serving_phase(torch, np, lm, served, params, KERNELS, device)
    launches = {**{k: runs["fp, default pool"][3][k] for k in FP_KERNELS},
                **{k: runs["int8, default pool"][3][k] for k in QUANT_KERNELS}}
    del params, runs
    torch.cuda.empty_cache()
    log(f"[time] phase 8 ({cfg.name} serving): {time.perf_counter() - t0:.1f} s")

    t_phase = time.perf_counter()
    for kv_dtype in (None, "int8"):
        t0 = time.perf_counter()
        cfg4 = dataclasses.replace(cfg, num_layers=4, kv_dtype=kv_dtype)
        label = f"{cfg.name}, 4 layers at full width, {kv_dtype or 'fp'} KV"
        own, shared = teacher_forced(torch, np, lm, cfg4, device, shared_routing=True)
        log_teacher_forced(label, own, False, time.perf_counter() - t0)
        log_teacher_forced(label + ", the CPU on the card's routing", shared, True,
                           time.perf_counter() - t0)
        assert shared["route_share"] == 1.0 and shared["agree_steps"] == shared["steps"]
        assert teacher_forced_ok(shared), (kv_dtype, shared)
    log(f"[time] phase 8 ({cfg.name} teacher-forced): {time.perf_counter() - t_phase:.1f} s")

    t0 = time.perf_counter()
    launches.update(train_full_width(torch, np, cfg, device, TRAIN_FLASH,
                                     tc_kernels=TRAIN_FLASH))
    torch.cuda.empty_cache()
    log(f"[time] phase 8 ({cfg.name} training): {time.perf_counter() - t0:.1f} s")
    log(f"[launches] {cfg.name}'s paths: {json.dumps(launches)}")
    return launches


# ---------------------------------------------------------------------------
# phase 9: the encoder-decoder (whisper-tiny)
# ---------------------------------------------------------------------------

WHISPER_ARCH = "whisper_tiny"
WHISPER_DECODE_STEPS = 64


def seeded_embeddings(torch, cfg, batch, rows, dev, seed=11):
    """Seeded N(0, 1) embeddings (batch, rows, d_model) in the model's
    dtype: what a stub frontend hands the model (whisper's frames,
    internvl2's patch rows)."""
    from repro_torch.models.layers import dtype_of

    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((batch, rows, cfg.d_model), generator=g,
                       device=dev).to(dtype_of(cfg))


def whisper_checks(torch, np, encdec, cfg, dev, frames=WHISPER_FRAMES,
                   tokens=WHISPER_TOKENS, steps=WHISPER_DECODE_STEPS):
    """Full width (seeded weights, one sequence of ``frames`` seeded frames):
    the card's bf16 teacher-forced ``decode_full`` over ``tokens`` seeded
    tokens (the encoder and decoder self-attention through the flash
    kernel) against the CPU's fp32 on the same weights upcast; and a greedy
    decode of ``steps`` tokens through ``decode_step`` on the card (the KV
    cache, plain attention) against the card's ``decode_full`` of the
    tokens it fed.  Returns the two ``logit_agreement`` readings and the
    flash kernel's launches and tensor-core launches in the card's
    teacher-forced run."""
    from repro_torch.kernels.flash_attention import KERNEL

    params = encdec.init(cfg, 7, device=dev)
    x = seeded_embeddings(torch, cfg, 1, frames, dev)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(1, tokens)), dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    with torch.no_grad():
        KERNEL.launches = KERNEL.tc_launches = 0
        enc = encdec.encode(params, cfg, x)
        card = encdec.decode_full(params, cfg, toks, enc)[0].float().cpu()
        launches = (KERNEL.launches, KERNEL.tc_launches)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        p32 = _tree_to(torch, params, cpu, torch.float32)
        want = encdec.decode_full(p32, cfg32, toks.cpu(),
                                  encdec.encode(p32, cfg32, x.float().cpu()))[0]
        cross = encdec.cross_kv(params, cfg, enc)
        cache = encdec.init_cache(cfg, 1, steps, device=dev)
        fed, rows = [int(toks[0, 0])], []
        for t in range(steps):
            tok = torch.tensor(fed[-1:], dtype=torch.int32, device=dev)
            logits, cache = encdec.decode_step(params, cfg, cache, tok,
                                               torch.tensor(t, device=dev), cross)
            rows.append(logits[0].float().cpu())
            fed.append(int(logits[0].argmax()))
        full = encdec.decode_full(params, cfg, torch.tensor([fed[:steps]], device=dev),
                                  enc)[0].float().cpu()
    return (logit_agreement(torch, card, want), logit_agreement(torch, rows, full),
            launches)


def whisper_phase(torch, np, device):
    """Phase 9, full-width whisper-tiny (4 encoder and 4 decoder layers, d
    384, 6 heads of 64, d_ff 1536 GELU, vocab 51865; bf16, seeded): 8
    training steps at batch 8 on 1500 seeded frames and 448 tokens (the
    encoder's 4 non-causal and the decoder's 4 causal flash launches a
    step forward, the decoder's again in its recompute), two profiled; the
    teacher-forced and greedy decode checks.  Returns the flash kernel's
    launches over the steps."""
    from repro_torch.configs import get_config
    from repro_torch.models import encdec

    cfg = get_config(WHISPER_ARCH)
    t0 = time.perf_counter()
    per_step = cfg.encoder_layers + 2 * cfg.num_layers
    launches = train_full_width(
        torch, np, cfg, device, TRAIN_FLASH, tc_kernels=TRAIN_FLASH,
        per_step=per_step, seq=WHISPER_TOKENS,
        extra={"frames": seeded_embeddings(torch, cfg, TRAIN_BATCH, WHISPER_FRAMES,
                                           device)},
        shape_text=f" (decoder tokens) over {WHISPER_FRAMES} seeded frames")
    torch.cuda.empty_cache()
    log(f"[time] phase 9 ({cfg.name} training): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tf, dec, (fl, fl_tc) = whisper_checks(torch, np, encdec, cfg, device)
    log_agreement(f"{cfg.name} at full width, card bf16 decode_full over "
                  f"{WHISPER_TOKENS} tokens ({WHISPER_FRAMES} frames; flash launches "
                  f"{fl}, on tensor cores {fl_tc}) vs CPU fp32", tf)
    log_agreement(f"{cfg.name}, card bf16 greedy decode_step (KV cache) over "
                  f"{WHISPER_DECODE_STEPS} tokens vs card decode_full of the tokens fed",
                  dec)
    assert agreement_ok(tf) and agreement_ok(dec), (tf, dec)
    assert fl == fl_tc == cfg.encoder_layers + cfg.num_layers, (fl, fl_tc)
    log(f"[time] phase 9 ({cfg.name} decode checks): {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 10: the frontend family (internvl2-26b), depth cut
# ---------------------------------------------------------------------------

VLM_ARCH = "internvl2_26b"
VLM_LAYERS = 2  # of its 48: ~1.9 B parameters at full width
VLM_TRAIN_STEPS = 2
VLM_CHECK_TEXT = 128


def vlm_forward_check(torch, np, lm, cfg, dev, prefix=VLM_PREFIX, text=VLM_CHECK_TEXT):
    """A teacher-forced forward of one sequence: ``prefix`` seeded patch
    embeddings before ``text`` seeded tokens, on the card (bf16, the flash
    kernel) against the CPU's fp32 on the same weights upcast, over the
    text rows.  Returns the ``logit_agreement`` reading and the flash
    kernel's launches and tensor-core launches in the card's run."""
    from repro_torch.kernels.flash_attention import KERNEL

    params = lm.init(cfg, 7, device=dev)
    pre = seeded_embeddings(torch, cfg, 1, prefix, dev, seed=13)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg.vocab_size, size=(1, text)), dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    with torch.no_grad():
        KERNEL.launches = KERNEL.tc_launches = 0
        card, _ = lm.forward(params, cfg, toks, prefix_embeds=pre)
        launches = (KERNEL.launches, KERNEL.tc_launches)
        card = card[0, prefix:].float().cpu()
        p32 = _tree_to(torch, params, cpu, torch.float32)
        del params
        want, _ = lm.forward(p32, dataclasses.replace(cfg, dtype="float32"), toks.cpu(),
                             prefix_embeds=pre.float().cpu())
    return logit_agreement(torch, card, want[0, prefix:]), launches


def vlm_train_check(torch, np, lm, cfg, dev, steps=VLM_TRAIN_STEPS, batch=VLM_BATCH,
                    prefix=VLM_PREFIX, text=VLM_TEXT):
    """``steps`` training steps on seeded patch prefixes; then, on the
    trained weights and the next, unseen batch, the loss's cross-entropy
    against one computed from the forward's text rows alone: the loss
    leaves the prefix rows out.  Returns the ``train_steps`` result and the
    two cross-entropies."""
    from repro_torch.data import DataConfig, SyntheticTokens

    pre = seeded_embeddings(torch, cfg, batch, prefix, dev, seed=17)
    tr = train_steps(torch, cfg, dev, steps, batch, text, extra={"prefix_embeds": pre})
    params = tr.pop("state")["params"]
    b = SyntheticTokens(DataConfig(batch=batch, seq=text, vocab_size=cfg.vocab_size,
                                   seed=0)).batch_at(steps)
    toks, labels = (torch.as_tensor(b[k], device=dev) for k in ("tokens", "labels"))
    with torch.no_grad():
        _, parts = lm.loss_fn(params, cfg, toks, labels, prefix_embeds=pre)
        logits, _ = lm.forward(params, cfg, toks, prefix_embeds=pre)
        logp = torch.log_softmax(logits[:, prefix:], dim=-1)
        keep = labels >= 0
        nll = -logp.gather(-1, labels.clamp(min=0).long()[..., None])[..., 0]
        text_ce = ((nll * keep).sum() / keep.sum()).item()
    return tr, parts["ce"].item(), text_ce


def vlm_phase(torch, np, lm, device):
    """Phase 10, internvl2-26b at full width (d 6144, 48 query heads over 8
    KV heads of 128, d_ff 16384, vocab 92553, untied) cut to VLM_LAYERS of
    its 48 layers: the prefix forward against the CPU's fp32, and
    VLM_TRAIN_STEPS training steps at batch VLM_BATCH of VLM_PREFIX patch
    rows and VLM_TEXT tokens through the flash kernel."""
    from repro_torch.configs import get_config

    full = get_config(VLM_ARCH)
    cfg = dataclasses.replace(full, num_layers=VLM_LAYERS)
    t0 = time.perf_counter()
    r, (fl, fl_tc) = vlm_forward_check(torch, np, lm, cfg, device)
    log_agreement(f"{cfg.name}, {VLM_LAYERS} of its {full.num_layers} layers at full width, "
                  f"card bf16 forward over {VLM_PREFIX} patch rows and {VLM_CHECK_TEXT} "
                  f"tokens (flash launches {fl}, on tensor cores {fl_tc}) vs CPU fp32, the "
                  "text rows", r)
    assert agreement_ok(r) and fl == fl_tc == VLM_LAYERS, (r, fl, fl_tc)
    torch.cuda.empty_cache()
    log(f"[time] phase 10 ({cfg.name} forward check): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tr, ce, text_ce = vlm_train_check(torch, np, lm, cfg, device)
    log(f"[train] {cfg.name}, {VLM_LAYERS} of its {full.num_layers} layers at full width, "
        f"{cfg.dtype}, batch {VLM_BATCH} x ({VLM_PREFIX} patch rows + {VLM_TEXT} tokens): "
        f"step times " + " ".join(f"{x * 1e3:.1f}" for x in tr["seconds"]) + " ms, peak "
        f"{tr['peak_gib']:.2f} GiB allocated; losses "
        + " ".join(f"{x:.4f}" for x in tr["losses"]) + f"; launches {tr['launches']}, "
        f"on tensor cores {tr['tc_launches']}; trained loss's ce {ce:.4f}, ce of the "
        f"forward's text rows {text_ce:.4f}")
    assert all(np.isfinite(tr["losses"])) and all(np.isfinite(tr["gnorms"])), tr
    assert abs(ce - text_ce) <= 1e-3 * abs(text_ce), (ce, text_ce)
    want = 2 * VLM_LAYERS * VLM_TRAIN_STEPS
    assert tr["launches"] == tr["tc_launches"] == {"flash_attention": want}, tr
    torch.cuda.empty_cache()
    log(f"[time] phase 10 ({cfg.name} training): {time.perf_counter() - t0:.1f} s")


# ---------------------------------------------------------------------------
# phase 11: the dense configs (chatglm3-6b, gemma-7b, deepseek-7b)
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("chatglm3_6b", "gemma_7b", "deepseek_7b")
DENSE_SHAPES = {"chatglm3_6b": CHATGLM_DECODE, "gemma_7b": GEMMA_DECODE,
                "deepseek_7b": DEEPSEEK7B_DECODE}
# Full width at 4 of their 28 / 28 / 30 layers (serving is host-bound and
# its schedule does not depend on depth; gemma's fp32 masters and moments
# alone would need ~136 GB to train, so none of the three trains here), the
# workload's first 8 requests: one batch of slots.
DENSE_LAYERS = 4
DENSE_REQUESTS = SLOTS


def scheduler_reference(torch, np, lm, requests=DENSE_REQUESTS):
    """Ticks and mean TTFT ticks the scheduler gives the workload's first
    ``requests`` requests, served on the CPU by a one-layer reduced
    qwen2-1.5B: the scheduler sees only prompt lengths, shared prefixes and
    block counts, the same for every model of the workload."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KERNELS

    cfg = dataclasses.replace(get_config("qwen2_1_5b").reduced(), num_layers=1)
    cpu = torch.device("cpu")
    engine, reqs, _, _ = serve(torch, np, cfg, lm.init(cfg, 0, device=cpu), KERNELS,
                               cpu, requests=requests)
    return engine.steps_run, mean_ttft(reqs)


def dense_tf_ok(r) -> bool:
    """Phase 4's limits, the argmax agreeing wherever the reference's top-2
    margin exceeds twice the step's error."""
    return (r["err"] <= TF_STD_LIMIT and r["top10"] >= TF_TOP10_MIN
            and all(m <= 2 * e for _, m, e in r["swaps"]))


def dense_phase(torch, np, lm, device, configs=None, requests=DENSE_REQUESTS):
    """Phase 11: each dense config (full width, DENSE_LAYERS layers, seeded
    random bf16 weights; ``configs`` replaces them) serves the workload's
    first ``requests`` requests (fp pages, chunked prefill, prefix cache,
    greedy), with ticks and mean TTFT the scheduler's
    (scheduler_reference), every decode and prefill launch on the tensor
    cores at D 128 and none at gemma's D 256; then its teacher-forced logits
    against the CPU's fp32 within phase 4's limits (dense_tf_ok).  Returns
    each config's kernel launches."""
    from repro_torch.configs import get_config
    from repro_torch.kernels.ops import KERNELS

    t0 = time.perf_counter()
    ticks, ttft = scheduler_reference(torch, np, lm, requests)
    log(f"[serve] the scheduler on the workload's first {requests} requests: {ticks} "
        f"ticks, mean TTFT {ttft:.2f} ticks ({time.perf_counter() - t0:.1f} s)")
    if configs is None:
        configs = [dataclasses.replace(get_config(a), num_layers=DENSE_LAYERS)
                   for a in DENSE_ARCHS]
    launches = {}
    for cfg in configs:
        t0 = time.perf_counter()
        params = lm.init(cfg, 0, device=device)
        log(f"[serve] {cfg.name}, {cfg.num_layers} layers at full width (Hq "
            f"{cfg.num_heads} over Hkv {cfg.num_kv_heads}, D {cfg.head_dim}): "
            f"{lm.param_count(params) / 1e9:.3f} B params ({cfg.dtype})")
        runs = {}
        run = make_runner(torch, np, cfg, params, KERNELS, device, runs)
        tc = TC_KERNELS if cfg.head_dim in GQA_TC_HEAD_DIMS else ()
        eng, reqs = run("fp, default pool", FP_KERNELS, tc, requests=requests)
        on_tc = {k: KERNELS[k].tc_launches for k in FP_KERNELS}
        assert tc or not any(on_tc.values()), on_tc  # D 256: the CUDA-core bodies
        assert eng.steps_run == ticks and mean_ttft(reqs) == ttft, (eng.steps_run, ticks)
        launches[cfg.name] = runs["fp, default pool"][3]
        log(f"[launches] {cfg.name} serving: {json.dumps(launches[cfg.name])}, on tensor "
            f"cores {json.dumps(on_tc)}")
        del params, runs, eng
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        tf = teacher_forced(torch, np, lm, cfg, device)
        log_teacher_forced(f"{cfg.name}, {cfg.num_layers} layers at full width, fp KV "
                           "(argmax gated where the top-2 margin exceeds twice the error)",
                           tf, True, time.perf_counter() - t1)
        assert dense_tf_ok(tf), tf
        if device.type == "cuda":
            torch.cuda.empty_cache()
        log(f"[time] phase 11 ({cfg.name}): {time.perf_counter() - t0:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phase 13: fault tolerance (qwen2-1.5B) and the contiguous cache
# ---------------------------------------------------------------------------

# Phase 13 serves full-width models at FAULT_LAYERS layers: its checks
# (statuses, counters, the ledger, page bytes, ticks) do not depend on depth.
FAULT_LAYERS = 4
# The chaos workload: CHAOS_REQUESTS prompts of a CHAOS_SHARED-token shared
# prefix plus CHAOS_TAIL own tokens, CHAOS_NEW new tokens each, over
# CHAOS_SLOTS slots of CHAOS_MAX_LEN, CHAOS_SYNC-tick windows, greedy, the
# auditor on; a pool of CHAOS_BLOCKS pages, where the fault-free run already
# preempts.  Ticks depend on prompt lengths and block counts only.
CHAOS_REQUESTS, CHAOS_SHARED, CHAOS_TAIL = 12, 64, (8, 96)
CHAOS_SLOTS, CHAOS_NEW, CHAOS_MAX_LEN, CHAOS_SYNC = 4, 16, 256, 4
CHAOS_BLOCKS = 16
# The reference's fixed schedule (serving/faults.py CHAOS_SCHEDULE, written
# for a run of 19 ticks) at CHAOS_SCALE times its ticks, plus two more table
# corruptions (CHAOS_MORE_CORRUPT) so that all three flavors fire, each on a
# dispatch of its own; the speculative pass adds one spec_poison.
CHAOS_SCALE = 4
CHAOS_MORE_CORRUPT = (32, 40)
CHAOS_SPEC_POISON_TICK = 0
# the reference's error texts of the requests a fault hits
FAULT_ERRORS = ("poisoned logits row (no finite value)", "dispatch guard: ",
                "poisoned verify logits (no finite value)")
# the guards-off runs: a corruption at GUARDS_OFF_TICK, each in-pool flavor
# (reserved page 0, another row's page), which the auditor must catch
GUARDS_OFF_TICK = 10
# snapshot / restore: the reference's test_roundtrip_restores_warm_ttft at
# page 16 (its 20-token prompt of 4-token pages is 80 tokens here)
SNAP_PROMPT, SNAP_PAGE = 80, 16
CONTIG_REQUESTS = 8


def chaos_workload(rng, vocab: int):
    """CHAOS_REQUESTS prompts: one shared CHAOS_SHARED-token prefix plus
    CHAOS_TAIL tokens of each request's own, ids folded into ``vocab``."""
    draw = lambda size: (rng.integers(0, WORKLOAD_VOCAB, size=size) % vocab).tolist()  # noqa: E731
    shared = draw(CHAOS_SHARED)
    lo, hi = CHAOS_TAIL
    return [shared + draw(int(rng.integers(lo, hi + 1))) for _ in range(CHAOS_REQUESTS)]


def chaos_schedule(spec: bool):
    from repro_torch.serving import Fault
    from repro_torch.serving.faults import CHAOS_SCHEDULE

    out = [Fault(site, tick=t * CHAOS_SCALE, slot=s) for site, t, s in CHAOS_SCHEDULE]
    out += [Fault("table_corrupt", tick=t, slot=i + 1)
            for i, t in enumerate(CHAOS_MORE_CORRUPT)]
    if spec:
        out.append(Fault("spec_poison", tick=CHAOS_SPEC_POISON_TICK, slot=0))
    return out


def chaos_serve(torch, np, cfg, params, device, injector=None, requests=None, **kw):
    """One run of the chaos workload (its first ``requests``) with the
    auditor on, the windows under no_host_sync, drained and shut down.
    Returns (engine, requests, the kernels' launches, seconds)."""
    from repro_torch.kernels.ops import KERNELS
    from repro_torch.models import lm
    from repro_torch.serving import ServeConfig, ServingEngine

    scfg = ServeConfig(slots=CHAOS_SLOTS, max_len=CHAOS_MAX_LEN, page_size=PAGE,
                       prefill_chunk=CHUNK, max_new_tokens=CHAOS_NEW,
                       sync_every=CHAOS_SYNC, num_blocks=CHAOS_BLOCKS, audit=True, **kw)
    eng = ServingEngine(cfg, params, scfg, injector=injector, device=device)
    prompts = chaos_workload(np.random.default_rng(1), cfg.vocab_size)[:requests]
    reqs = [eng.submit(p) for p in prompts]
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.perf_counter()
    with strict_windows(torch, lm, device), \
            strict_windows(torch, lm, device, "spec_decode_loop"):
        eng.run()
        eng.drain()
        eng.shutdown()
    if device.type == "cuda":
        torch.cuda.synchronize()  # a CUDA error of the run would raise here
    launches = {name: k.launches for name, k in KERNELS.items() if k.launches}
    return eng, reqs, launches, time.perf_counter() - t0


def partings(torch, np, lm, cfg, params, device, reqs, twins, others=("recompute",)):
    """Each request of ``reqs`` whose stream parts from its twin's, at its
    first differing token i: (uid, i, the twin path's top-2 margin there,
    the max |diff| of the other paths' logits against it).  The twin path
    is the prompt's chunked prefill then the decode steps
    (replay_logits); the other paths are "recompute" (the prompt and the
    first i tokens through the chunked prefill, as a preempted request
    resumes), "verify" (the speculative verify's plain attention) and
    "contiguous" (the same replay over the contiguous strips)."""
    out = []
    for r, t in zip(reqs, twins):
        assert r.prompt == t.prompt
        if r.output == t.output[:len(r.output)]:
            continue
        i = next(j for j, (a, b) in enumerate(zip(r.output, t.output)) if a != b)
        emitted = t.output[:i]
        dec = replay_logits(torch, np, lm, cfg, params, device, t.prompt, emitted)[0]
        errs = []
        for other in others:
            if other == "verify":
                errs.append(replay_margin(torch, np, lm, cfg, params, device, t.prompt,
                                          emitted)[1])
                continue
            prompt, em, layout = ((t.prompt + emitted, [], "paged") if other == "recompute"
                                  else (t.prompt, emitted, "contiguous"))
            alt = replay_logits(torch, np, lm, cfg, params, device, prompt, em, layout)[0]
            errs.append((alt - dec).abs().max().item())
        out.append((r.uid, i, top2_margin(dec), max(errs)))
    return out


def partings_text(div) -> str:
    return f"{len(div)} partings" + "".join(
        f" (request {u} at token {i}: top-2 margin {m:.4f}, logit error {e:.4f})"
        for u, i, m, e in div)


def check_chaos(eng, reqs, spec: bool):
    """The fault-tolerance contract of a chaos pass (serving/faults.py): the
    hit requests FAILED with the reference's texts, every other request
    completed, a clean audit every step, every corruption caught by the
    guard, every page back after shutdown.  Returns the failed requests."""
    assert all(r.status in ("completed", "failed") for r in reqs), \
        [(r.uid, r.status, r.error) for r in reqs]
    failed = [r for r in reqs if r.status == "failed"]
    assert all(r.error.startswith(FAULT_ERRORS) for r in failed), \
        [(r.uid, r.error) for r in failed]
    assert len(failed) == eng.poisoned_rows + eng.guard_failures, \
        (len(failed), eng.poisoned_rows, eng.guard_failures)
    fired = eng.injector.fired
    assert fired["pool_alloc"] > 0 and fired["poison"] == 1 and fired["grant"] == 1
    assert eng.table_corruptions == 3 == fired["table_corrupt"]
    assert eng.guard_failures >= eng.table_corruptions > 0
    assert eng.poisoned_rows == 1 + spec and fired["spec_poison"] == spec
    assert eng.audits_run >= eng.dispatches > 0  # one audit after every step()
    assert eng.decode_windows + eng.spec_windows > 0  # no_host_sync had windows
    assert eng.pool.in_use == 0 and eng.prefix.pages == 0
    return failed


def guards_off_check(torch, np, cfg, params, device):
    """With guards off, a table corruption reaches the dispatch and the
    auditor must raise at that tick (tests/test_chaos.py:401), once for each
    in-pool flavor (reserved page 0, another row's page: an out-of-pool id
    is for the guard alone).  The card must raise no CUDA error.  Returns
    the auditor's messages."""
    from repro_torch.serving import (AuditError, Fault, FaultInjector, ServeConfig,
                                     ServingEngine)

    msgs = []
    for flavor in (1, 2):
        eng = ServingEngine(cfg, params, ServeConfig(
            slots=CHAOS_SLOTS, max_len=CHAOS_MAX_LEN, page_size=PAGE,
            prefill_chunk=CHUNK, max_new_tokens=CHAOS_NEW, num_blocks=CHAOS_BLOCKS,
            audit=True, guards=False),
            injector=FaultInjector([Fault("table_corrupt", tick=GUARDS_OFF_TICK)]),
            device=device)
        eng._corrupt_mode = flavor  # the flavors cycle from this one
        for p in chaos_workload(np.random.default_rng(1), cfg.vocab_size):
            eng.submit(p)
        try:
            eng.run()
            raise AssertionError("a corruption with guards off passed the auditor")
        except AuditError as e:
            msgs.append(str(e))
        if device.type == "cuda":
            torch.cuda.synchronize()
        tb = eng.tables.tables()
        assert eng.table_corruptions == 1 and eng.guard_failures == 0
        assert ((tb >= 0) & (tb < eng.pool.base + eng.pool.num_blocks)).all()
        assert "diverged" in msgs[-1], msgs[-1]
    return msgs


def snapshot_check(torch, np, lm, cfg, params, device):
    """The reference's test_roundtrip_restores_warm_ttft at page SNAP_PAGE:
    a cold and a warm request, a snapshot, an engine restored from it; the
    restored engine's pages (re-snapshotted before it serves) equal the
    snapshot's byte for byte, and its warm request has the warm request's
    cached tokens, admission TTFT and stream.  Returns (cold, warm,
    restored, the pages restored, their dtype names)."""
    from repro_torch.serving import ServeConfig, ServingEngine, audit_engine

    kw = dict(slots=1, max_len=2 * SNAP_PROMPT, max_new_tokens=3, page_size=SNAP_PAGE,
              prefill_chunk=SNAP_PAGE, token_budget=SNAP_PAGE + 1)
    prompt = (np.random.default_rng(2).integers(0, WORKLOAD_VOCAB, size=SNAP_PROMPT)
              % cfg.vocab_size).tolist()
    eng = ServingEngine(cfg, params, ServeConfig(**kw), device=device)
    cold, warm = eng.submit(prompt), eng.submit(prompt)
    eng.run()
    assert warm.ttft_admit_ticks < cold.ttft_admit_ticks and warm.cached_tokens > 0
    snap = eng.snapshot()
    eng2 = ServingEngine.restore(cfg, params, ServeConfig(**kw), snap, device=device)
    audit_engine(eng2)  # the grafted pages are ledger-consistent
    again = eng2.snapshot()
    assert again["nodes"] == snap["nodes"] and again["leaf_dtypes"] == snap["leaf_dtypes"]
    assert all(np.array_equal(a, b) for a, b in zip(again["leaves"], snap["leaves"]))
    restored = eng2.submit(prompt)
    eng2.run()
    assert restored.output == warm.output == cold.output
    assert restored.cached_tokens == warm.cached_tokens
    assert restored.ttft_admit_ticks == warm.ttft_admit_ticks
    eng2.shutdown()
    assert eng2.pool.in_use == 0
    return cold, warm, restored, len(snap["nodes"]), snap["leaf_dtypes"]


def contiguous_check(torch, np, lm, cfg, params, device, path, tc, requests):
    """The phase 3 workload's first ``requests`` over the paged cache (its
    kernels, ``path``) and over the contiguous strips (no kernel), per tick
    and with ``sync_every=4`` (no_host_sync): ticks and mean TTFT equal the
    paged run's, strips per tick and windowed give equal bytes, and their
    streams equal the paged run's but where a stream parts at a token whose
    paged top-2 margin lies within twice the max |diff| of the two paths'
    logits there (a one-slot replay).  Returns the partings."""
    from repro_torch.kernels.ops import KERNELS

    runs = {}
    run = make_runner(torch, np, cfg, params, KERNELS, device, runs)
    paged, paged_reqs = run("paged", path, tc, requests=requests)
    strip, strip_reqs = run("contiguous", (), cache="contiguous", requests=requests)
    with strict_windows(torch, lm, device):
        win, win_reqs = run("contiguous, sync_every=4", (), cache="contiguous",
                            sync_every=4, requests=requests)
    assert strip.pool is None and win.decode_windows > 0
    assert strip.steps_run == paged.steps_run == win.steps_run
    assert mean_ttft(strip_reqs) == mean_ttft(paged_reqs) == mean_ttft(win_reqs)
    assert [r.output for r in win_reqs] == [r.output for r in strip_reqs]
    div = partings(torch, np, lm, cfg, params, device, strip_reqs, paged_reqs,
                   others=("contiguous",))
    log(f"[serve] {cfg.name} contiguous vs paged: {strip.steps_run} ticks each, mean TTFT "
        f"{mean_ttft(strip_reqs):.2f}; {strip.cache.kv_bytes()} strip bytes against "
        f"{paged.cache.kv_bytes()} pool bytes; sync_every=4 on the strips byte-identical "
        f"({win.dispatches} dispatches against {strip.dispatches}); "
        f"{sum(a.output == b.output for a, b in zip(strip_reqs, paged_reqs))}/"
        f"{len(strip_reqs)} streams equal the paged run's, {partings_text(div)}")
    assert all(m <= 2 * e for _, _, m, e in div), div
    return div


def fault_phase(torch, np, lm, device, qwen=None, mla=None,
                contig_requests=CONTIG_REQUESTS):
    """Phase 13: the serving engine's fault tolerance on full-width
    qwen2-1.5B at FAULT_LAYERS layers (chaos passes plain and speculative,
    guards off, snapshot and restore), and the contiguous cache on it and on
    deepseek-v2-lite-16B at an MoE capacity with no drops, over the phase 3
    workload's first ``contig_requests`` (``qwen`` and ``mla`` replace the
    configs)."""
    from repro_torch.configs import get_config
    from repro_torch.serving import FaultInjector

    t_phase = time.perf_counter()
    qwen = qwen or dataclasses.replace(get_config("qwen2_1_5b"), num_layers=FAULT_LAYERS)
    params = lm.init(qwen, 0, device=device)

    twin, twin_reqs, _, dt = chaos_serve(torch, np, qwen, params, device)
    assert all(r.status == "completed" for r in twin_reqs) and twin.preemptions > 0
    log(f"[fault] {qwen.name}, {qwen.num_layers} layers, fault-free twin: {twin.steps_run} "
        f"ticks, {twin.preemptions} preemptions, {twin.decode_windows} windows, "
        f"{twin.audits_run} clean audits over {twin.dispatches} dispatches, {dt:.2f} s")
    for spec in (False, True):
        label = "speculative pass" if spec else "chaos pass"
        kw = dict(spec_decode="ngram", draft_len=SPEC_DRAFT) if spec else {}
        eng, reqs, launched, dt = chaos_serve(torch, np, qwen, params, device,
                                              FaultInjector(chaos_schedule(spec)), **kw)
        failed = check_chaos(eng, reqs, spec)
        assert set(launched) == (set(FP_KERNELS) if device.type == "cuda" else set())
        div = partings(torch, np, lm, qwen, params, device, reqs, twin_reqs,
                       others=("recompute", "verify") if spec else ("recompute",))
        log(f"[fault] {label}: {eng.steps_run} ticks, faults fired "
            f"{json.dumps(eng.injector.fired)}; {len(failed)} requests failed ("
            + "; ".join(f"{r.uid}: {r.error[:72]}" for r in failed) + f"), "
            f"{len(reqs) - len(failed)} completed; poisoned rows {eng.poisoned_rows}, "
            f"table corruptions {eng.table_corruptions} caught by the guard "
            f"{eng.guard_failures} times before any launch, {eng.preemptions} preemptions, "
            f"{eng.decode_windows} windows ({eng.window_fallbacks} fallbacks)"
            + (f", {eng.spec_windows} spec windows ({eng.spec_fallbacks} fallbacks)"
               if spec else "")
            + f"; {eng.audits_run} clean audits over {eng.dispatches} dispatches; pool after "
            f"shutdown {eng.pool.in_use} pages; no CUDA error, no host sync in a window; "
            f"launches {json.dumps(launched)}; against the fault-free twin "
            f"{partings_text(div)}; {dt:.2f} s")
        assert all(m <= 2 * e for _, _, m, e in div), div
    msgs = guards_off_check(torch, np, qwen, params, device)
    log("[fault] guards off: the auditor caught both in-pool corruption flavors at "
        "their tick (" + "; ".join(m[:60] for m in msgs) + "), no CUDA error")
    cold, warm, restored, pages, dtypes = snapshot_check(torch, np, lm, qwen, params,
                                                         device)
    log(f"[fault] snapshot / restore: {pages} pages ({sorted(set(dtypes))}) restored byte "
        f"for byte; warm request {warm.cached_tokens} cached tokens, admission TTFT "
        f"{warm.ttft_admit_ticks} ticks (cold {cold.ttft_admit_ticks}); restored "
        f"{restored.cached_tokens} and {restored.ttft_admit_ticks}, its stream the warm "
        "one's")
    log(f"[time] phase 13 ({qwen.name} fault tolerance): {time.perf_counter() - t_phase:.1f} s")
    t0 = time.perf_counter()
    contiguous_check(torch, np, lm, qwen, params, device, FP_KERNELS, TC_KERNELS,
                     contig_requests)
    del params
    mla = moe_no_drops(mla or dataclasses.replace(get_config("deepseek_v2_lite_16b"),
                                                  num_layers=FAULT_LAYERS))
    params = lm.init(mla, 0, device=device)
    contiguous_check(torch, np, lm, mla, params, device, MLA_FP_KERNELS, MLA_FP_KERNELS,
                     contig_requests)
    del params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[time] phase 13 (the contiguous cache): {time.perf_counter() - t0:.1f} s")



# ---------------------------------------------------------------------------
# phase 14: MLA + MoE training (deepseek-v2-lite-16B)
# ---------------------------------------------------------------------------

MLA_ARCH = "deepseek_v2_lite_16b"
# 4 of its 27 layers: the dense layer 0 and 3 MoE layers (~2.26 B parameters,
# ~34 GiB of weights, gradients, fp32 masters and moments before activations)
MLA_TRAIN_LAYERS = 4
MLA_CHECK_TOKENS = 256  # the depth-2 teacher-forced forward's sequence


def mla_forward_check(torch, np, lm, cfg2, dev, seq=MLA_CHECK_TOKENS):
    """A teacher-forced forward of one seeded sequence at ``cfg2``'s depth:
    the card's bf16 run (the flash kernel) against the CPU's fp32 one on the
    same weights upcast, the CPU on the card's MoE routing
    (``replayed_routing``).  Returns the ``logit_agreement`` reading over
    every position and the flash kernel's launches and tensor-core launches
    in the card's run."""
    from repro_torch.kernels.flash_attention import KERNEL
    from repro_torch.models import layers

    params = lm.init(cfg2, 7, device=dev)
    toks = torch.as_tensor(np.random.default_rng(5).integers(
        0, cfg2.vocab_size, size=(1, seq)), dtype=torch.int32, device=dev)
    cpu = torch.device("cpu")
    with torch.no_grad():
        KERNEL.launches = KERNEL.tc_launches = 0
        with recorded_routing(layers) as picks:
            card, _ = lm.forward(params, cfg2, toks)
        launches = (KERNEL.launches, KERNEL.tc_launches)
        card = card[0].float().cpu()
        p32 = _tree_to(torch, params, cpu, torch.float32)
        del params
        with replayed_routing(layers, picks):
            want, _ = lm.forward(p32, dataclasses.replace(cfg2, dtype="float32"), toks.cpu())
    return logit_agreement(torch, card, want[0]), launches


def mla_training_phase(torch, np, lm, device, full=None, layers_=MLA_TRAIN_LAYERS,
                       ckpt_steps=20, batch=TRAIN_BATCH, seq=TRAIN_SEQ):
    """Phase 14, deepseek-v2-lite-16B at full width (d 2048, 16 heads of MLA:
    latent rank 512, keys 128 nope + 64 rope, values 128; 64 routed experts
    top-6 and 2 shared of width 1408, the first layer dense; vocab 102400,
    untied) cut to ``layers_`` of its 27 layers: TRAIN_STEPS steps at batch
    8 x seq 1024 through the flash kernel at Dk 192 / Dv 128 (layer 0 once
    a step, the recomputed MoE layers twice) and two more profiled; the
    depth-2 check (the dense layer and one MoE layer) on the kernel path's
    MoE routing, the planted attention faults failing it; the depth-2
    teacher-forced forward against the CPU's fp32 (phase 4's limits); and
    the reduced training CLI through injected failures.  ``full``,
    ``batch`` and ``seq`` replace the config and the training shape (a
    rehearsal's).  Returns the flash kernel's launches over the TRAIN_STEPS
    steps."""
    import tempfile

    from repro_torch.configs import get_config

    full = full or get_config(MLA_ARCH)
    cfg = dataclasses.replace(full, num_layers=layers_)
    t0 = time.perf_counter()
    per_step = 2 * cfg.num_layers - lm.num_prefix_layers(cfg)
    launches = train_full_width(
        torch, np, cfg, device, TRAIN_FLASH, tc_kernels=TRAIN_FLASH, per_step=per_step,
        batch=batch, seq=seq, shape_text=f", {cfg.num_layers} of its {full.num_layers} layers")
    if device.type == "cuda":
        torch.cuda.empty_cache()
    log(f"[time] phase 14 ({cfg.name} training): {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    depth2_phase(torch, np, lm, full, device, TRAIN_FAULTS, shared_routing=True)
    cfg2 = dataclasses.replace(full, num_layers=2)
    r, (fl, fl_tc) = mla_forward_check(torch, np, lm, cfg2, device)
    log_agreement(f"{cfg.name}, 2 layers (dense prefix + MoE) at full width, card bf16 "
                  f"forward over {MLA_CHECK_TOKENS} tokens (flash launches {fl}, on tensor "
                  f"cores {fl_tc}) vs CPU fp32 on the card's MoE routing", r)
    on_card = device.type == "cuda"
    assert agreement_ok(r) and (fl, fl_tc) == ((2, 2) if on_card else (0, 0)), (r, fl, fl_tc)
    with tempfile.TemporaryDirectory() as ckpt_dir:
        res, cli_launches = recovery_run(torch, device, ckpt_dir, steps=ckpt_steps,
                                         arch=MLA_ARCH)
    loss = res["last_metrics"]["loss"].item()
    log(f"[train] reduced {MLA_ARCH} CLI with injected failures: {res['steps']} steps, "
        f"{res['restarts']} restarts, final loss {loss:.4f}, flash_attention launches "
        f"{cli_launches}")
    assert res["restarts"] >= 1 and res["steps"] == ckpt_steps and np.isfinite(loss)
    assert cli_launches > 0 or not on_card
    if on_card:
        torch.cuda.empty_cache()
    log(f"[time] phase 14 ({cfg.name} checks): {time.perf_counter() - t0:.1f} s")
    log(f"[launches] {cfg.name}'s training path: {json.dumps(launches)}")
    return launches


if __name__ == "__main__":
    sys.exit(main())
