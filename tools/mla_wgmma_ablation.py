#!/usr/bin/env python3
"""Where FlashMLA's wgmma walk spends its time, on the card.

    python3 tools/mla_wgmma_ablation.py [--against CHECKOUT]

Builds copies of ``csrc/mla.cu``, each changed by a text edit: the walk at
other tile shapes (32 keys in 3 or 2 stages, 48 keys in 2, where the kernel
as it stands takes 32 keys in 4 stages at Dpe 64), O rescaled on every tile
(the kernel skips it where a warp's maxima did not move), the walk without its
loads (the producer fills the first stages only and the walk reuses them),
and the loads without the walk (the consumers wait for each tile and
release it), one nvcc a copy, all started together.  With ``--against`` it
also builds the ``mla.cu`` of another checkout whose ``mla_launch`` takes no
route argument (the mma.sync FlashMLA before the wgmma one).  Then it times
each through ``ops.mla`` beside the kernel as it stands at the paper's Fig.
14 shapes (chip_smoke.MLA_SHAPES, bf16; L2 flushed before each call), in
turns over two rounds, with its error in bf16 ulps of ``ref.mla``.  The
walk without its loads and the loads without the walk are wrong by design:
only their times are read.  Needs one CUDA card and nvcc; the copies build
under the kernels' git-ignored ``_build/``.
"""
from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

SHAPE = "    return launch_wgmma<CT, 32, 4>(q, q_pe, kv, k_pe, out, batch, heads, kv_heads, seq, pe,"
LOADS = "      for (int u = 0; u < n; ++u) {"
WAIT_OWN = "    hc::mbar_wait(&full[st], (t / STAGES) & 1);"
WAIT_READ = "    hc::mbar_wait(&full[su], (u / STAGES) & 1);"
WALK_START = "  hc::mbar_wait(w.full + 2 * STAGES, 0);  // Q\n"
WALK_END = "  w.store(out, orow0, rows);\n}"
SKIP = "  if (__all_sync(0xffffffffu, a[0] == 1.f && a[1] == 1.f)) return;\n"


def shape(keys: int, stages: int):
    return [(SHAPE, SHAPE.replace("<CT, 32, 4>", f"<CT, {keys}, {stages}>"))]


# name: (what it shows, [(text, replacement)]); "walk" stands for the text
# of the consumers' walk between WALK_START and WALK_END
VARIANTS = {
    "32 x 3": ("32-key tiles in 3 stages", shape(32, 3)),
    "32 x 2": ("32-key tiles in 2 stages", shape(32, 2)),
    "48 x 2": ("48-key tiles in 2 stages (3 do not fit)", shape(48, 2)),
    "rescale always": ("O rescaled where a warp's alphas are all 1 too", [(SKIP, "")]),
    "walk only": ("no load after the first stages: the walk reuses them", [
        (LOADS, "      for (int u = 0; u < (n < STAGES ? n : STAGES); ++u) {"),
        (WAIT_OWN, "    if (t < STAGES) " + WAIT_OWN.lstrip()),
        (WAIT_READ, "    if (u < STAGES) " + WAIT_READ.lstrip())]),
    "loads only": ("the consumers wait for each tile and release it", [
        ("walk", "  for (int t = 0; t < n; ++t) {\n"
                 "    hc::mbar_wait(&w.full[t % STAGES], (t / STAGES) & 1);\n"
                 "    if (w.tid == 0) hc::mbar_arrive(&w.empty[t % STAGES]);\n"
                 "  }\n")]),
}


def edited(text: str, name: str, edits) -> str:
    for old, new in edits:
        if old == "walk":
            start, end = text.find(WALK_START), text.find(WALK_END)
            if start < 0 or end < 0:
                raise RuntimeError(f"variant {name!r}: the walk's bounds no longer match")
            old = text[start + len(WALK_START):end]
        if text.count(old) != 1:
            raise RuntimeError(f"variant {name!r}: its edit no longer matches the source")
        text = text.replace(old, new)
    return text


def build_variants(build, csrc: Path, out: Path, against=None):
    """Each variant's library, built in parallel: {name: ctypes function}."""
    jobs = {name: (csrc, edits) for name, (_, edits) in VARIANTS.items()}
    if against is not None:
        jobs["against"] = (against / "src" / "repro_torch" / "kernels" / "csrc", [])
    procs = {}
    for name, (src, edits) in jobs.items():
        d = out / name.replace(" ", "_")
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        (d / "mla.cu").write_text(edited((d / "mla.cu").read_text(), name, edits))
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(d / "lib.so"), str(d / "mla.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (d, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"variant {name!r} failed to build:\n{log}")
        fns[name] = ctypes.CDLL(str(d / "lib.so")).mla_launch
    return fns


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--against", type=Path, default=None,
                    help="a checkout whose mla.cu (without the route argument) is timed too")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("mla_wgmma_ablation: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import mla as MLA

    print(cs.gpu_line())
    fns = build_variants(build, build.CSRC, build.BUILD_DIR / "mla_wgmma_ablation",
                         args.against)
    kernel = MLA.KERNEL.function()
    for name, fn in fns.items():
        fn.argtypes, fn.restype = MLA.KERNEL.argtypes, ctypes.c_int
    if "against" in fns:  # the same arguments without the route
        fns["against"].argtypes = [MLA.KERNEL.argtypes[0], *MLA.KERNEL.argtypes[2:]]

        def without_route(dtype, _tc, *rest, _fn=fns["against"]):
            return _fn(dtype, *rest)
        fns["against"] = without_route
    runs = [("as it stands", kernel, "")]
    runs += [(name, fns[name], what) for name, (what, _) in VARIANTS.items()]
    if "against" in fns:
        runs.append((f"against {args.against.name}", fns["against"], "the other checkout's"))
    dev = torch.device("cuda")
    flush = torch.empty(64 << 20, dtype=torch.uint8, device=dev).zero_
    try:
        for label, (b, h, hkv, s, d, pe) in cs.MLA_SHAPES.items():
            g = torch.Generator(device=dev).manual_seed(47)
            q = torch.randn((b, h, d), generator=g, device=dev).bfloat16()
            q_pe = torch.randn((b, h, pe), generator=g, device=dev).bfloat16()
            kv = torch.randn((b, s, hkv, d), generator=g, device=dev).bfloat16()
            k_pe = torch.randn((b, s, hkv, pe), generator=g, device=dev).bfloat16()
            want = ref.mla(q, q_pe, kv, k_pe)
            for rnd in range(2):
                for name, fn, what in (runs if rnd == 0 else runs[::-1]):
                    MLA.KERNEL._fn = fn
                    ulps = cs.bf16_ulps(torch, ops.mla(q, q_pe, kv, k_pe), want)
                    ms = cs.time_ms(torch, lambda: ops.mla(q, q_pe, kv, k_pe), flush=flush)
                    print(f"[ablation] {label} round {rnd} {name}: {ms:.4f} ms, {ulps:.3g} bf16 "
                          f"ulps" + (f" ({what})" if what else ""), flush=True)
    finally:
        MLA.KERNEL._fn = kernel
    return 0


if __name__ == "__main__":
    sys.exit(main())
