"""The dry-run and roofline tables from the port's dry-run records
(``experiments/dryrun_torch/*.json``): the port of
``repro.roofline.report``.  A model of 256 (or 512) H100s, computed on the
CPU, not a card measurement.

    PYTHONPATH=src python -m repro_torch.roofline.report [--mesh single_pod]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path

from ..configs import ARCHS, get_config
from ..launch.cells import SHAPES
from .analysis import RooflineTerms, analytic_hbm_bytes, link_bw

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"


def load(arch: str, shape: str, mesh: str, directory: Path = DRYRUN_DIR) -> dict | None:
    p = directory / f"{arch}__{shape}__{mesh}.json"
    if not p.exists():
        return None
    return json.loads(p.read_text())


def terms_of(rec: dict, flash_attention: bool = True) -> RooflineTerms:
    """The record's three terms: its FLOPs and collective bytes a rank, and
    the analytic HBM bytes (``flash_attention``: the card's route, whose
    scores stay on chip; the dry run itself runs the plain version)."""
    coll = rec.get("collective_bytes", {})
    cfg = get_config(rec["arch"])
    cell = SHAPES[rec["shape"]]
    chips = rec.get("chips", 256)
    mesh_shape = rec.get("mesh_shape") or (
        {"pod": 2, "data": 16, "model": 16} if rec["mesh"] == "multi_pod"
        else {"data": 16, "model": 16})
    return RooflineTerms(
        arch=rec["arch"],
        shape=rec["shape"],
        mesh=rec["mesh"],
        flops=rec.get("flops", 0.0),
        hbm_bytes=0.0,
        coll_bytes=float(sum(coll.values())),
        coll_breakdown=coll,
        model_flops=rec.get("model_flops", 0.0),
        chips=chips,
        analytic_bytes=analytic_hbm_bytes(cfg, cell, mesh_shape,
                                          flash_attention=flash_attention),
        link_bw=link_bw(chips),
    )


def fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x*1e6:.0f}us"
    if x < 1:
        return f"{x*1e3:.1f}ms"
    return f"{x:.2f}s"


def dryrun_table(mesh: str, directory: Path = DRYRUN_DIR) -> str:
    lines = [
        "| arch | shape | status | GiB/rank (state / peak) | wall | collectives (counts) |",
        "|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            rec = load(arch, shape, mesh, directory)
            if rec is None:
                lines.append(f"| {arch} | {shape} | *pending* | | | |")
                continue
            if rec["status"] == "skipped":
                lines.append(
                    f"| {arch} | {shape} | skip | — | — | {rec['reason'][:48]} |"
                )
                continue
            if rec["status"] == "error":
                lines.append(
                    f"| {arch} | {shape} | **FAIL** | — | — | "
                    f"{' '.join(rec.get('error', '').split())[:60]} |"
                )
                continue
            state = rec.get("state_bytes", 0) / 2**30
            peak = rec.get("peak_bytes", 0) / 2**30
            counts = rec.get("collective_counts", {})
            cstr = " ".join(
                f"{k.split('-')[-1][:4]}:{v}" for k, v in counts.items() if v
            )
            fits = "" if rec.get("fits_80gb") else " ⚠"
            lines.append(
                f"| {arch} | {shape} | ok | {state:.2f} / {peak:.2f}{fits} | "
                f"{rec.get('wall_s', 0):.0f}s | {cstr} |"
            )
    return "\n".join(lines)


def roofline_table(mesh: str, directory: Path = DRYRUN_DIR) -> str:
    lines = [
        "| arch | shape | compute | memory (analytic) | "
        "collective | dominant | useful frac | MFU@roofline |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for arch in ARCHS:
        for shape in SHAPES:
            rec = load(arch, shape, mesh, directory)
            if rec is None or rec["status"] != "ok":
                continue
            t = terms_of(rec)
            lines.append(
                f"| {arch} | {shape} | {fmt_s(t.compute_s)} | "
                f"{fmt_s(t.memory_s)} | "
                f"{fmt_s(t.collective_s)} | **{t.dominant}** | "
                f"{t.useful_fraction:.0%} | {t.mfu:.1%} |"
            )
    return "\n".join(lines)


def pick_hillclimb(mesh: str = "single_pod", directory: Path = DRYRUN_DIR):
    """The three cells to climb: worst MFU, most collective-bound, and the
    one most representative of the paper (deepseek-v2 MLA decode)."""
    rows = []
    for arch in ARCHS:
        for shape in SHAPES:
            rec = load(arch, shape, mesh, directory)
            if rec and rec["status"] == "ok":
                rows.append(terms_of(rec))
    if not rows:
        return []
    worst_mfu = min((r for r in rows if r.shape == "train_4k"), key=lambda r: r.mfu,
                    default=min(rows, key=lambda r: r.mfu))
    coll = max(rows, key=lambda r: r.collective_s / max(r.step_s, 1e-12))
    mla = next((r for r in rows if r.arch == "deepseek_v2_lite_16b"), rows[0])
    return [worst_mfu, coll, mla]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", default="single_pod",
                    choices=["single_pod", "multi_pod"])
    args = ap.parse_args(argv)
    print("(a model of H100s from the CPU dry run: no card measured these)\n")
    print(f"## Dry-run ({args.mesh})\n")
    print(dryrun_table(args.mesh))
    print(f"\n## Roofline ({args.mesh})\n")
    print(roofline_table(args.mesh))
    picks = pick_hillclimb(args.mesh)
    if picks:
        print("\nhillclimb picks:",
              ", ".join(f"{t.arch}×{t.shape} ({t.dominant}, mfu {t.mfu:.1%})" for t in picks))


if __name__ == "__main__":
    main()
