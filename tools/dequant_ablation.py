#!/usr/bin/env python3
"""The dequantized GEMM's wgmma walk (row 14), on the card: where its time
goes and what its tile constants buy, read in one call.

    python3 tools/dequant_ablation.py [--out FILE]

Builds csrc/dequant_matmul.cu (the walk: csrc/dequant_wgmma.cuh) as it stands
and as variants, each a ``build.Kernel`` of its own whose macros differ from
the module's (``KERNEL.defines``): three ablations of the walk
(``DQ_ABLATE``): the loads alone (each stage released as it lands), the
decode alone (no loads: the consumers decode a stale ring) and the products
alone (no loads, no decode); and three tile variants: two consumer
warpgroups at BM <= 64 (four as it stands), a ring of at most 8 stages (16)
and a 192 KB ring (216 KB: four stages at BM 256, where it holds six).  One
nvcc a variant, all started together; each variant's registers, spills and
wgmma serialization notes (``-Xptxas -v``) are printed.  Then it times, in
turns over two rounds (L2 flushed before each call), on chip_smoke's
inputs, W int4 and int2 x A fp16 at (8, 16384, 16384) and W int4 x A fp16
at (256, 8192, 8192), the error against the plain version on the rounded
weight (lib_units) beside each full variant.  A variant's plan in Python
(``tile_plan``, the wrapper's budget check) reads its own constants while it
runs.  Needs one CUDA card and nvcc; the variants build under the kernels'
git-ignored ``_build/``, each named by its digest.
"""
from __future__ import annotations

import argparse
import json
import sys
from concurrent.futures import ThreadPoolExecutor
from contextlib import contextmanager
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

ABLATIONS = {"loads alone": 1, "decode alone": 2, "wgmma alone": 3}
# label: the macros that differ from the module's
VARIANTS = {**{label: {"DQ_ABLATE": v} for label, v in ABLATIONS.items()},
            "2 consumers at BM <= 64": {"DQ_CONSUMERS_SMALL": 2},
            "8 stages at most": {"DQ_MAX_STAGES": 8},
            "a 192 KB ring": {"DQ_RING": 196608}}
# the module constants a variant's macro stands for
CONSTANTS = {"DQ_CONSUMERS_SMALL": "CONSUMERS_SMALL", "DQ_MAX_STAGES": "MAX_STAGES",
             "DQ_RING": "RING"}
# (chip_smoke DEQUANT_SHAPES label, weight format, activations)
CELLS = (("m1_n16384_k16384", "int4", "float16"), ("m1_n16384_k16384", "int2", "float16"),
         ("m256_n8192_k8192", "int4", "float16"))


def variants(build, kernel):
    """Each variant as a kernel of its own: {label: Kernel}."""
    return {label: build.Kernel(kernel.name, kernel.entry, kernel.argtypes, kernel.replaces,
                                source=kernel.source.stem, defines={**kernel.defines, **extra})
            for label, extra in VARIANTS.items()}


def registers(log: str) -> str:
    """The walk kernels' lines of a ptxas -v log, and its serialization notes."""
    out, fn, spill = [], "", ""
    for line in log.splitlines():
        if "Function properties for" in line:
            fn = line.split("Function properties for")[-1].strip()
        elif "spill" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and "dequant_wgmma" in fn:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}; {spill}")
    notes = sum(log.count(f"(C751{i})") for i in range(10))
    out.append(f"wgmma serialization notes (C751x): {notes}")
    return "\n  ".join(out)


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the readings as JSON to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("dequant_ablation: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import dequant_matmul as D

    print(cs.gpu_line(), flush=True)
    per_label = {"as it stands": D.KERNEL, **variants(build, D.KERNEL)}

    def one(k):
        log: dict = {}
        build.build_all([k], log=log)
        return log.get(k.source.name, "")

    with ThreadPoolExecutor(len(per_label)) as ex:
        for (label, k), log in zip(per_label.items(), ex.map(one, per_label.values())):
            print(f"[build] {label}:\n  {registers(log) if log else 'built before'}", flush=True)
    stock = D.KERNEL.function()
    fns = {label: k.function() for label, k in per_label.items()}
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_

    cases = []
    for shape, fmt, adtype in CELLS:
        m, n, k = cs.DEQUANT_SHAPES[shape]
        g = torch.Generator(device=dev).manual_seed(43)
        dt = getattr(torch, adtype)
        a = torch.randn((m, k), generator=g, device=dev).to(dt)
        bq = torch.randint(-128, 128, (n, k // ref.WEIGHT_PACK[fmt]), generator=g, device=dev,
                           dtype=torch.int8)
        w = cs.rounded_weight(torch, ref, bq, fmt, None, 128, dt)
        control = torch.matmul(a.float(), w.float().t()).to(dt)
        sigma = k ** 0.5 * cs.rms(torch, a) * cs.rms(torch, w)
        del w
        cases.append((f"{shape} {fmt} x {adtype}", a, bq, fmt, control, sigma))

    readings: dict = {}
    labels = list(fns)
    try:
        for rnd in range(2):
            for label in (labels if rnd == 0 else labels[::-1]):
                D.KERNEL._fn = fns[label]
                consts = {CONSTANTS[k]: v for k, v in VARIANTS.get(label, {}).items()
                          if k in CONSTANTS}
                with patched(D, **consts):
                    for what, a, bq, fmt, control, sigma in cases:
                        run = lambda a=a, bq=bq, fmt=fmt: D.dequant_matmul(a, bq, fmt)  # noqa: E731
                        tc = D.KERNEL.tc_launches
                        err = cs.lib_units(torch, run(), control, sigma)
                        assert D.KERNEL.tc_launches == tc + 1, (label, what)
                        ms = cs.time_ms(torch, run, flush=flush)
                        readings.setdefault(what, {}).setdefault(label, []).append(float(ms))
                        ok = "" if label in ABLATIONS else f", {err:.3g} lib_units of the control"
                        print(f"[ablation] {what} round {rnd} {label}: {ms:.4f} ms{ok}", flush=True)
    finally:
        D.KERNEL._fn = stock
    line = json.dumps({"dequant_ablation": readings})
    print(line, flush=True)
    if args.out:
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
