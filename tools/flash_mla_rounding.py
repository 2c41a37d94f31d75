#!/usr/bin/env python3
"""How far the emitted FlashMLA (Fig. 18 through the CUDA backend) lies from
plain versions of its own arithmetic, element by element, on the card.

    python3 tools/flash_mla_rounding.py [--seeds 47 48 49]

Compiles ``kernels/mla.py``'s ``mla_program`` at chip_smoke's row 5 shape
(b128_s8192: 128 batches, 128 heads over one latent head of 512 plus 64
rope, 8192 keys) in bf16 at chip_smoke's ``COMPILED_FLASH_MLA`` (``block_N``
64, ``block_H`` 32), runs it on
each seed's inputs (drawn as chip_smoke's FlashMLA check draws them) and
holds its output against four plain versions of the program's arithmetic
(the max a tile of 64 keys, ``l`` summing fp32 probabilities, P rounded to
bf16 before P.V):

* ``tile``: each tile's scores and P.V as one fp32 product each, added to
  the rescaled accumulator (``mla.fig18_plain``'s order, chip_smoke's
  gate);
* ``k16 P.V``: P.V summed into the accumulator 16 keys at a time, in key
  order, as the emitted ``wmma`` loop adds its 16-deep products;
* ``k16 both``: the scores summed 16 features at a time too, the latent's
  32 steps and then the rope's 4, as the two emitted GEMMs fill the score
  tile;
* ``fp64``: the same arithmetic in fp64 (P still rounded to bf16): the
  rounding-free value of the program.

For each it prints the count of output elements at 0, 1, 2 and more bf16
ulps (chip_smoke's ``ulps_of``: ulps of the plain value, at least 2^-16,
rounded),
the largest, and where the largest falls (the plain value, the difference).
It also prints how many of the bf16 probabilities each fp32 version rounds
otherwise than the fp64 one.  Needs one CUDA card and nvcc; the kernel
builds under the kernels' git-ignored ``_build/``.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

LOG2E = 1.44269504  # the program's constant


def chain(a: torch.Tensor, b: torch.Tensor, acc: torch.Tensor, step: int) -> torch.Tensor:
    """``acc + a @ b`` with the inner dimension summed ``step`` at a time,
    each partial product added to the running sum in order."""
    for k in range(0, a.shape[-1], step):
        acc = acc + a[..., k:k + step] @ b[..., k:k + step, :]
    return acc


def plain(q, q_pe, kv, k_pe, order: str, dt=torch.float32, probs=None):
    """The program's arithmetic at block_N keys a tile, in ``order`` (the
    module docstring's names) and ``dt``; P rounded to bf16.  With
    ``probs`` a list, each tile's fp32 P (before rounding) is appended."""
    b, hq, d = q.shape
    pe = q_pe.shape[-1]
    s, hkv = kv.shape[1], kv.shape[2]
    n = cs.COMPILED_FLASH_MLA["block_N"]
    scale = 1.0 / math.sqrt(d + pe) * LOG2E
    qf = q.to(dt).reshape(b, hkv, hq // hkv, d)
    qpf = q_pe.to(dt).reshape(b, hkv, hq // hkv, pe)
    acc = torch.zeros_like(qf)
    total = torch.zeros(qf.shape[:-1], dtype=dt, device=q.device)
    prev = torch.full_like(total, -1048576.0)
    for k0 in range(0, s, n):
        kt = kv[:, k0:k0 + n].to(dt).transpose(1, 2)  # (B, Hkv, N, D)
        pt = k_pe[:, k0:k0 + n].to(dt).transpose(1, 2)
        if order == "k16 both":
            sc = chain(qf, kt.transpose(-1, -2), torch.zeros(qf.shape[:-1] + (n,), dtype=dt,
                                                            device=q.device), 16)
            sc = chain(qpf, pt.transpose(-1, -2), sc, 16)
        else:
            sc = qf @ kt.transpose(-1, -2) + qpf @ pt.transpose(-1, -2)
        cur = sc.amax(-1)
        alpha = torch.exp2(prev * scale - cur * scale)
        p = torch.exp2(sc * scale - cur[..., None] * scale)
        if probs is not None:
            probs.append(p)
        total = total * alpha + p.sum(-1)
        pb = p.to(torch.bfloat16).to(dt)
        if order == "tile":
            acc = acc * alpha[..., None] + pb @ kt
        else:
            acc = chain(pb, kt, acc * alpha[..., None], 16)
        prev = cur
    return (acc / total[..., None]).reshape(b, hq, d).to(torch.bfloat16)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[47, 48, 49])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.core import compile as tl_compile
    from repro_torch.kernels import mla

    dev = torch.device("cuda")
    print(cs.gpu_line())
    b, h, hkv, s, d, pe = cs.MLA_SHAPES["b128_s8192"]
    kern = tl_compile(mla.mla_program(b, h, hkv, s, d, pe, dtype="bfloat16",
                                      **cs.COMPILED_FLASH_MLA), target="cuda")
    result = {}
    for seed in args.seeds:
        g = torch.Generator(device=dev).manual_seed(seed)
        q = torch.randn((b, h, d), generator=g, device=dev).to(torch.bfloat16)
        q_pe = torch.randn((b, h, pe), generator=g, device=dev).to(torch.bfloat16)
        kv = torch.randn((b, s, hkv, d), generator=g, device=dev).to(torch.bfloat16)
        k_pe = torch.randn((b, s, hkv, pe), generator=g, device=dev).to(torch.bfloat16)
        out = kern(q, q_pe, kv, k_pe)
        p64 = []
        truth = plain(q, q_pe, kv, k_pe, "tile", torch.float64, p64)
        row = {}
        for order in ("tile", "k16 P.V", "k16 both", "fp64"):
            if order == "fp64":
                want, flips = truth, 0
            else:
                p32 = []
                want = plain(q, q_pe, kv, k_pe, order, probs=p32)
                flips = sum(int((a.to(torch.bfloat16) != c.to(torch.bfloat16)).sum())
                            for a, c in zip(p32, p64))
                del p32
            u = cs.ulps_of(torch, out, want).flatten()
            r = u.round()
            worst = int(u.argmax())
            row[order] = {
                "hist": {"0": int((r == 0).sum()), "1": int((r == 1).sum()),
                         "2": int((r == 2).sum()), ">2": int((r > 2).sum())},
                "max_ulps": u[worst].item(),
                "worst_plain": want.flatten()[worst].float().item(),
                "worst_diff": (out.flatten()[worst].float()
                               - want.flatten()[worst].float()).item(),
                "p_bf16_rounded_otherwise_than_fp64": flips,
                "plain_vs_fp64_max_ulps": cs.bf16_ulps(torch, want, truth),
            }
            print(f"[rounding] seed {seed} {order}: {json.dumps(row[order])}", flush=True)
        result[seed] = row
        del p64, q, q_pe, kv, k_pe, out, truth
        torch.cuda.empty_cache()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "flash_mla_rounding.json").write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
