"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and skip
without a card.  They import neither JAX nor the JAX package, so they run
on the card's machine:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Limits, chip_smoke.py's: max abs error 1e-4 in fp32 (the order of fp32
sums, exp2 against exp); in bf16, two bf16 ulps of the plain value,
element-wise (both sides accumulate in fp32 and round the output once, so a
sound kernel lies within one ulp).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import prefill_attention as PF
from repro_torch.kernels import ref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _tables(rng, b, mp, num_pages):
    t = rng.permutation(num_pages - 1)[: b * mp] + 1  # page 0 reserved
    return t.reshape(b, mp).astype("int32")


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions():
    """On a card: each CUDA kernel against its plain version, bf16 and fp32,
    with a len-0 slot, a window and a partial chunk."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(6)
    b, hq, hkv, d, ps, mp, chunk = 4, 12, 2, 128, 16, 8, 32
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(rng, b, mp, num_pages), device=dev)
    def within_limit(got, want):
        if got.dtype == torch.bfloat16:
            return cs.bf16_ulps(torch, got, want) <= cs.BF16_ULPS
        return (got - want).abs().max().item() <= cs.FP32_ATOL

    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 40):
            g = torch.Generator(device=dev).manual_seed(0)
            rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
            q, kp, vp = rand(b, hq, d), rand(hkv, num_pages, ps, d), rand(hkv, num_pages, ps, d)
            lens = torch.tensor([0, 1, 77, mp * ps], dtype=torch.int32, device=dev)
            n0 = PA.KERNEL.launches
            got = PA.paged_attention(q, kp, vp, tables, lens, window=window)
            assert PA.KERNEL.launches == n0 + 1
            want = ref.paged_attention(q, kp, vp, tables, lens, window=window)
            assert within_limit(got, want)
            qc, kn, vn = rand(b, hq, chunk, d), rand(b, hkv, chunk, d), rand(b, hkv, chunk, d)
            starts = torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev)
            clens = torch.tensor([32, 0, 19, 32], dtype=torch.int32, device=dev)
            out, _, _ = PF.prefill_attention(qc, kn, vn, kp.clone(), vp.clone(),
                                             tables, starts, clens, window=window)
            plain, _, _ = ref.paged_prefill_attention(
                qc, kn, vn, kp.clone(), vp.clone(), tables, starts, clens, window=window)
            assert within_limit(out, plain)
