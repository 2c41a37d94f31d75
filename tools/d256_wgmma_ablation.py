#!/usr/bin/env python3
"""Tile shapes of the head-width-256 warpgroup walk, on the card.

    python3 tools/d256_wgmma_ablation.py

Builds the flash forward and the chunked prefill (csrc/flash_attention.cu
and csrc/prefill_attention.cu over csrc/hopper_attention.cuh) at other key
tiles: each a ``build.Kernel`` of its own whose tile macros WG_KEYS and
WG_STAGES differ from the module's (``KERNEL.defines``): the flash forward
(64 keys in 2 stages as it stands: the scores as m64n64k16) at 32 keys in 4
and in 3 stages, the prefill (32 keys in 4 as it stands) at 64 in 2 (its
alternate tiles need an even number of stages).  One nvcc a variant, all
started together; each variant's registers and spills (``-Xptxas -v``) are
printed.  Then it times each beside the kernels as they stand, in turns over
two rounds (L2 flushed before each call), with its error in bf16 ulps of the
plain version: the flash forward at gemma-7b's training shape
(chip_smoke.FLASH_CASES "gemma-7b D 256") and the chunked prefill at its
serving shape (chip_smoke.GEMMA_DECODE, the inputs of check_prefill).  Needs
one CUDA card and nvcc; the variants build under the kernels' git-ignored
``_build/``, each named by its digest.
"""
from __future__ import annotations

import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# kernel: the (keys, stages) it is timed at beside its own
VARIANTS = {"flash_attention": ((32, 4), (32, 3)), "prefill_attention": ((64, 2),)}


def variants(build, kernels):
    """Each variant as a kernel of its own: {label: {kernel name: Kernel}}."""
    out = {}
    for name, shapes in VARIANTS.items():
        k = kernels[name]
        for keys, stages in shapes:
            out.setdefault(f"{keys} x {stages}", {})[name] = build.Kernel(
                k.name, k.entry, k.argtypes, k.replaces, source=k.source.stem,
                defines={**k.defines, "WG_KEYS": keys, "WG_STAGES": stages})
    return out


def registers(log: str) -> str:
    """The warpgroup kernel's line of a ptxas -v log."""
    fn, spill = "", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and "_wg" in fn:
            return f"{line.split(':', 1)[-1].strip()}; {spill}"
    return "not found (built before: no compiler output)"


def build_variants(build, per_label):
    """Builds every variant in parallel (a ``build_all`` each, so each keeps
    its own compiler output) and prints its registers and spills."""
    jobs = [(label, k) for label, per in per_label.items() for k in per.values()]

    def one(job):
        log: dict = {}
        build.build_all([job[1]], log=log)
        return log.get(job[1].source.name, "")

    with ThreadPoolExecutor(len(jobs)) as ex:
        for (label, k), log in zip(jobs, ex.map(one, jobs)):
            print(f"[build] {label} {k.source.name}: {registers(log)}", flush=True)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("d256_wgmma_ablation: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import prefill_attention as PF

    print(cs.gpu_line(), flush=True)
    kernels = {"flash_attention": FA.KERNEL, "prefill_attention": PF.KERNEL}
    per_label = variants(build, kernels)
    build_variants(build, per_label)
    stock = {name: k.function() for name, k in kernels.items()}
    runs = [("as it stands", stock)] + [
        (label, {name: k.function() for name, k in per.items()})
        for label, per in per_label.items()]
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_

    case = next(c for c in cs.FLASH_CASES if c[0] == "gemma-7b D 256")
    q, k, v = cs.flash_inputs(torch, case, torch.bfloat16, dev)
    flash = lambda: FA.flash_attention(q, k, v, causal=True)  # noqa: E731
    flash_want = ref.attention(q, k, v, causal=True)

    sh = cs.GEMMA_DECODE
    rng = np.random.default_rng(3)
    tables, num_pages = cs._tables(torch, rng, dev)
    starts, lens = cs._chunk_starts_lens(np, rng)
    g = torch.Generator(device=dev).manual_seed(4)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    pq = rand(cs.SLOTS, sh.hq, cs.CHUNK, sh.d)
    kn, vn = rand(cs.SLOTS, sh.hkv, cs.CHUNK, sh.d), rand(cs.SLOTS, sh.hkv, cs.CHUNK, sh.d)
    kp, vp = (rand(sh.hkv, num_pages, cs.PAGE, sh.d) for _ in range(2))
    st, ln = torch.as_tensor(starts, device=dev), torch.as_tensor(lens, device=dev)
    prefill = lambda: PF.prefill_attention(pq, kn, vn, kp, vp, tables, st, ln)[0]  # noqa: E731
    prefill_want = ref.paged_prefill_attention(pq, kn, vn, kp.clone(), vp.clone(), tables, st,
                                               ln)[0]
    try:
        for rnd in range(2):
            for label, per in (runs if rnd == 0 else runs[::-1]):
                for name, kern in kernels.items():
                    kern._fn = per.get(name, stock[name])
                for what, name, fn, want in (
                        ("flash gemma-7b D 256", "flash_attention", flash, flash_want),
                        ("prefill gemma-7b serving", "prefill_attention", prefill,
                         prefill_want)):
                    if name not in per:
                        continue
                    ulps = cs.bf16_ulps(torch, fn(), want)
                    ms = cs.time_ms(torch, fn, flush=flush)
                    print(f"[ablation] {what} round {rnd} {label}: {ms:.4f} ms, {ulps:.3g} bf16 "
                          "ulps", flush=True)
    finally:
        for name, kern in kernels.items():
            kern._fn = stock[name]
    return 0


if __name__ == "__main__":
    sys.exit(main())
