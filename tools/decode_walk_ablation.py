#!/usr/bin/env python3
"""The paged decode's bulk-copy walk, on the card: its tile constants, where
its time goes, and the bodies it replaced, read in one call.

    python3 tools/decode_walk_ablation.py

Builds csrc/paged_attention.cu (the walk: csrc/decode_walk.cuh) at other
walk constants, each a ``build.Kernel`` of its own whose macros differ from
the module's (``KERNEL.defines``): 2 and 8 stages (4 as it stands), 64 and
256 keys a split (128), 2 and 8 consumer warps (4); and two ablations of the
walk as it stands (``WALK_ABLATE``): the loads alone (the consumers wait for
each page and release it) and the arithmetic alone (the producer copies
nothing).  One nvcc a variant, all started together; each variant's
registers and spills (``-Xptxas -v``) are printed.  Then it times, in turns
over two rounds (L2 flushed before each call), with the error in bf16 ulps
of the plain version, on chip_smoke.check_decode's inputs:

* gemma-7b's serving shape (chip_smoke.GEMMA_DECODE: 16 over 16 at D 256),
  the fp decode and its int8 and int4 twin, on each walk and on the
  CUDA-core body the walk replaced there (the route with the walk refused);
* deepseek-7b's (DEEPSEEK7B_DECODE: 32 over 32 at D 128, a group of 1), the
  fp decode and its int8 twin, and the fp decode at its heads but D 64, on
  each walk and on the mma.sync body.

A variant's split rule and shared-memory budget read its own constants
(paged_attention.py's module constants are set to them while it runs).
Needs one CUDA card and nvcc; the variants build under the kernels'
git-ignored ``_build/``, each named by its digest.
"""
from __future__ import annotations

import json
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# label: the macros that differ from the module's
VARIANTS = {
    "2 stages": {"WALK_STAGES": 2}, "8 stages": {"WALK_STAGES": 8},
    "64 keys a split": {"WALK_SPLIT_KEYS": 64}, "256 keys a split": {"WALK_SPLIT_KEYS": 256},
    "2 warps": {"WALK_WARPS": 2}, "8 warps": {"WALK_WARPS": 8},
    "loads only": {"WALK_ABLATE": 1}, "compute only": {"WALK_ABLATE": 2},
}
# (label, chip_smoke shape name, head dim, format): the rows timed; the
# last at deepseek-7b's heads but D 64, a group of 1 no model serves
ROWS = (("gemma-7b", "GEMMA_DECODE", 256, None), ("gemma-7b", "GEMMA_DECODE", 256, "int8"),
        ("gemma-7b", "GEMMA_DECODE", 256, "int4"),
        ("deepseek-7b", "DEEPSEEK7B_DECODE", 128, None),
        ("deepseek-7b", "DEEPSEEK7B_DECODE", 128, "int8"),
        ("32 over 32 at D 64", "DEEPSEEK7B_DECODE", 64, None))
BEFORE = "before (gemma: CUDA cores; deepseek-7b: mma.sync)"


def variants(build, kernel):
    """Each variant as a kernel of its own: {label: Kernel}."""
    return {label: build.Kernel(kernel.name, kernel.entry, kernel.argtypes, kernel.replaces,
                                source=kernel.source.stem, defines={**kernel.defines, **extra})
            for label, extra in VARIANTS.items()}


def registers(log: str) -> str:
    """The walk kernels' lines of a ptxas -v log."""
    out, fn, spill = [], "", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and "decode_walk" in fn:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}; {spill}")
    return "\n  ".join(out) or "not found (built before: no compiler output)"


def build_variants(build, per_label):
    """Builds every variant in parallel (a ``build_all`` each, so each keeps
    its compiler output) and prints the walk kernels' registers and spills."""
    def one(k):
        log: dict = {}
        build.build_all([k], log=log)
        return log.get(k.source.name, "")

    with ThreadPoolExecutor(len(per_label)) as ex:
        for (label, k), log in zip(per_label.items(), ex.map(one, per_label.values())):
            print(f"[build] {label}:\n  {registers(log)}", flush=True)


@contextmanager
def patched(mod, **values):
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        yield
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_walk_ablation: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_attention_quant as PAQ

    print(cs.gpu_line(), flush=True)
    log: dict = {}
    build.build_all([PA.KERNEL], log=log)
    print(f"[build] as it stands:\n  {registers(log.get('paged_attention.cu', ''))}", flush=True)
    per_label = variants(build, PA.KERNEL)
    build_variants(build, per_label)
    stock = PA.KERNEL.function(), PAQ.KERNEL.function()
    fns = {"as it stands": stock}
    for label, k in per_label.items():  # one library: the quantized entry point beside
        twin = build.Kernel(PAQ.KERNEL.name, PAQ.KERNEL.entry, PAQ.KERNEL.argtypes,
                            PAQ.KERNEL.replaces, source="paged_attention", defines=k.defines)
        fns[label] = (k.function(), twin.function())
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_

    cases = []
    for model, shape_name, d, fmt in ROWS:
        shape = getattr(cs, shape_name)._replace(d=d)
        q, _, _, args, kw, tables, lens = cs.decode_inputs(torch, np, ref, torch.bfloat16, dev,
                                                          fmt, shape)
        lens_t = torch.as_tensor(lens, device=dev)
        if fmt is None:
            run = lambda q=q, a=args, t=tables, n=lens_t: PA.paged_attention(q, *a, t, n)  # noqa: E731
            want = ref.paged_attention(q, *args, tables, lens_t)
        else:
            run = lambda q=q, a=args, t=tables, n=lens_t, kw=kw: PAQ.paged_attention_quant(  # noqa: E731
                q, *a, t, n, **kw)
            want = ref.paged_attention_quant(q, *args, tables, lens_t, **kw)
        cases.append((f"{model} {fmt or 'bf16'}", run, want))

    labels = [*fns, BEFORE]
    readings: dict = {}
    try:
        for rnd in range(2):
            for label in (labels if rnd == 0 else labels[::-1]):
                PA.KERNEL._fn, PAQ.KERNEL._fn = fns.get(label, stock)
                consts = {k: v for k, v in VARIANTS.get(label, {}).items()
                          if k != "WALK_ABLATE"}
                walk = {"walk_path": (lambda *a: False)} if label == BEFORE else {}
                with patched(PA, **consts, **walk):
                    for what, run, want in cases:
                        before = (PA.KERNEL.walk_launches, PAQ.KERNEL.walk_launches)
                        ulps = cs.bf16_ulps(torch, run(), want)
                        walked = (PA.KERNEL.walk_launches, PAQ.KERNEL.walk_launches) != before
                        assert walked == (label != BEFORE), (label, what)
                        ms = cs.time_ms(torch, run, flush=flush)
                        readings.setdefault(what, {}).setdefault(label, []).append(float(ms))
                        print(f"[ablation] {what} round {rnd} {label}: {ms:.4f} ms, "
                              f"{ulps:.3g} bf16 ulps", flush=True)
    finally:
        PA.KERNEL._fn, PAQ.KERNEL._fn = stock
    print(json.dumps({"decode_walk_ablation": readings}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
