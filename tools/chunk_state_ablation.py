#!/usr/bin/env python3
"""Where the tensor-core chunk_state launch spends its time, on the card.

    python3 tools/chunk_state_ablation.py

Builds copies of ``csrc/linear_attention.cu``, each with one part of
``chunk_state_kernel_tc`` taken out or changed by a text edit (the states'
stores, the decayed X's formation into its two bf16 terms, the tensor-core
products, the pair's lo term, the streaming stores made plain ones), one
nvcc a copy, all started together.  Then it times each beside the kernel as
it stands at mamba2-2.7B's training shape (chip_smoke.py's deep-decay SSD
case: batch 8 x seq 1024, 80 heads of P 64, N 128, bf16; L2 flushed before
each call), and the kernel as it stands at 1, 2 and 4 blocks an SM (the
head groups of ``chunk_state.head_group``), in two rounds.  A variant's
states are wrong by design: only its time is read.  Needs one CUDA card
and nvcc; the copies build under the kernels' git-ignored ``_build/``.
"""
from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

STORE = "        __stcs(reinterpret_cast<float2*>("
MMA = """        gc::mma16816<bf16>(acc[j], bt[kk], xh[0], xh[1]);
        gc::mma16816<bf16>(acc[j], bt[kk], xl[0], xl[1]);
        gc::mma16816<bf16>(acc[j + 1], bt[kk], xh[2], xh[3]);
        gc::mma16816<bf16>(acc[j + 1], bt[kk], xl[2], xl[3]);"""
TERMS = "      for (int k = threadIdx.x; k < len * (PT / 8); k += blockDim.x) {\n        const int r"
# name: (what it shows, [(text, replacement)])
VARIANTS = {
    "no stores": ("the states never stored (a store no value takes)", [
        (STORE, "        if (acc[j][0] == 1234.5f) __stcs(reinterpret_cast<float2*>(")]),
    "no terms": ("Xd's terms never formed (the shared memory left as it is)", [
        (TERMS, "      for (int k = threadIdx.x; k < 0; k += blockDim.x) {\n        const int r")]),
    "no mma": ("the fragments loaded, no tensor-core product", [
        (MMA, "        acc[j][0] += __uint_as_float(xh[0] ^ xl[1]);\n"
              "        acc[j + 1][0] += __uint_as_float(xh[2] ^ xl[3]);")]),
    "hi only": ("one bf16 term, Xd rounded once", [
        (MMA, "        gc::mma16816<bf16>(acc[j], bt[kk], xh[0], xh[1]);\n"
              "        gc::mma16816<bf16>(acc[j + 1], bt[kk], xh[2], xh[3]);")]),
    "plain stores": ("st.global in place of the streaming st.global.cs", [
        ("__stcs(reinterpret_cast<float2*>(op + (n0 + g + 8 * rr) * os.l + col),\n"
         "               make_float2(acc[j][2 * rr], acc[j][2 * rr + 1]));",
         "gc::store2(op + (n0 + g + 8 * rr) * os.l + col, acc[j][2 * rr], acc[j][2 * rr + 1]);")]),
}


def build_variants(build, csrc: Path, out: Path):
    """Each variant's library, built in parallel: {name: ctypes function}."""
    procs = {}
    for name, (_, edits) in VARIANTS.items():
        d = out / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(csrc, d)
        text = (d / "linear_attention.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name!r}: its edit no longer matches the source")
            text = text.replace(old, new)
        (d / "linear_attention.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"),
               str(d / "linear_attention.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        fn = ctypes.CDLL(str(d / "lib.so")).chunk_state_launch
        fns[name] = fn
    return fns


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chunk_state_ablation: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ref
    from repro_torch.kernels import chunk_state as CST

    print(cs.gpu_line())
    fns = build_variants(build, build.CSRC, build.BUILD_DIR / "chunk_state_ablation")
    for fn in fns.values():
        fn.argtypes, fn.restype = CST.KERNEL.argtypes, ctypes.c_int
    dev = torch.device("cuda")
    _, bm, x, da, _ = cs.ssd_operands(torch, cs.SSD_CASES[0], torch.bfloat16, dev)
    want = ref.chunk_state(bm, x, da)
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    kernel, per_sm = CST.KERNEL.function(), CST.STATE_BLOCKS_PER_SM
    runs = [("as it stands", kernel, per_sm, "")]
    runs += [(f"as it stands, {n} blocks an SM", kernel, n, "") for n in (1, 4) if n != per_sm]
    runs += [(name, fns[name], per_sm, what) for name, (what, _) in VARIANTS.items()]
    try:
        for rnd in range(2):
            for label, fn, blocks, what in runs:
                CST.KERNEL._fn, CST.STATE_BLOCKS_PER_SM = fn, blocks
                err = (CST.chunk_state(bm, x, da) - want).abs().max().item()
                ms = cs.time_ms(torch, lambda: CST.chunk_state(bm, x, da), flush=flush)
                print(f"[ablation] round {rnd} {label}: {ms:.4f} ms"
                      + (f" ({what}; max abs err {err:.3g})" if what else
                         f" (max abs err {err:.3g})"), flush=True)
    finally:
        CST.KERNEL._fn, CST.STATE_BLOCKS_PER_SM = kernel, per_sm
    return 0


if __name__ == "__main__":
    sys.exit(main())
