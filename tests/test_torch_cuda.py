"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so these tests are marked ``cuda`` and skip
without a card.  They import neither JAX nor the JAX package, so they run
on the card's machine:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Limits, chip_smoke.py's: max abs error 1e-4 in fp32 (the order of fp32
sums, exp2 against exp; for the SSD kernels 1e-4 of max(1, the largest plain
element)); in bf16, two bf16 ulps of the plain value, element-wise (both
sides accumulate in fp32 and round the output once, so a sound kernel lies
within one ulp).
"""
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

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
from repro_torch.kernels import ref

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)


def _tables(rng, b, mp, num_pages):
    t = rng.permutation(num_pages - 1)[: b * mp] + 1  # page 0 reserved
    return t.reshape(b, mp).astype("int32")


def _within_limit(got, want):
    if got.dtype == torch.bfloat16:
        return cs.bf16_ulps(torch, got, want) <= cs.BF16_ULPS
    return (got - want).abs().max().item() <= cs.FP32_ATOL


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
            assert _within_limit(got, want)
            qc, kn, vn = rand(b, hq, chunk, d), rand(b, hkv, chunk, d), rand(b, hkv, chunk, d)
            starts = torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev)
            clens = torch.tensor([32, 0, 19, 32], dtype=torch.int32, device=dev)
            tc0 = PF.KERNEL.tc_launches
            out, _, _ = PF.prefill_attention(qc, kn, vn, kp.clone(), vp.clone(),
                                             tables, starts, clens, window=window)
            assert PF.KERNEL.tc_launches == tc0 + (dtype == torch.bfloat16)
            plain, _, _ = ref.paged_prefill_attention(
                qc, kn, vn, kp.clone(), vp.clone(), tables, starts, clens, window=window)
            assert _within_limit(out, plain)


# (hq, hkv, d, page_size): qwen2-1.5B's heads at head dims 128 and 64 (96
# query rows a block: two key groups of 6 warps), a group of 8 (128 rows:
# one key group of 8 warps), a page of 8 positions x a group of 5 (40
# rows: 8 dead rows pad the last warp of 16), and chatglm3-6b's group of 16
# (256 rows a page: split over two blocks of 8 heads, head_split)
PREFILL_TC = [(12, 2, 128, 16), (12, 2, 64, 16), (16, 2, 128, 16), (10, 2, 128, 8),
              (32, 2, 128, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_TC, ids=[str(c) for c in PREFILL_TC])
def test_cuda_prefill_tensor_core_edges(case):
    """On a card: bf16 chunked prefill takes the tensor-core path (one
    tensor-core launch each) on the transposed views the prefill layer
    hands it, with a one-token chunk, an idle (len-0) slot, a partial
    chunk and a chunk whose pages reach the last table entry, with and
    without a window: within two bf16 ulps of the plain version, and both
    write the chunk's K/V at every live position."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    hq, hkv, d, ps = case
    dev = torch.device("cuda")
    b, mp, chunk = 4, 128 // ps, 32
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(9), b, mp, num_pages), device=dev)
    starts = torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev)
    clens = torch.tensor([1, 0, 19, 32], dtype=torch.int32, device=dev)  # 96 + 32 = 128
    g = torch.Generator(device=dev).manual_seed(10)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    kp, vp = rand(hkv, num_pages, ps, d), rand(hkv, num_pages, ps, d)
    qc = rand(b, chunk, hq, d).transpose(1, 2)  # as attention_prefill_paged hands them
    kn, vn = rand(b, chunk, hkv, d).transpose(1, 2), rand(b, chunk, hkv, d).transpose(1, 2)
    tb = tables.cpu().numpy()
    for window in (None, 40):
        p1, p2 = [kp.clone(), vp.clone()], [kp.clone(), vp.clone()]
        n0, tc0 = PF.KERNEL.launches, PF.KERNEL.tc_launches
        out = PF.prefill_attention(qc, kn, vn, *p1, tables, starts, clens, window=window)[0]
        assert (PF.KERNEL.launches, PF.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        assert out.stride() == qc.stride()  # written in the layer's layout
        plain = ref.paged_prefill_attention(qc, kn, vn, *p2, tables, starts, clens,
                                            window=window)[0]
        assert _within_limit(out, plain)
        for bi, (s0, n) in enumerate(zip(starts.tolist(), clens.tolist())):
            for c in range(n):
                pg, of = int(tb[bi, (s0 + c) // ps]), (s0 + c) % ps
                for pool_k, pool_p, new in zip(p1, p2, (kn, vn)):
                    assert torch.equal(pool_k[:, pg, of], new[bi, :, c])
                    assert torch.equal(pool_p[:, pg, of], new[bi, :, c])


# (hq, hkv, chunk, page_size) at D 256 on wgmma: gemma-7b's serving shape
# (16 over 16, a chunk of 64: one 64-row tile, two consumers on alternate
# key tiles), a group of 2 (128 rows: a head a consumer), a chunk of 128 at
# pages of 8, and pages of 32 (a page a key tile); then 64 rows over two
# heads of a 32-position chunk, which the wgmma rule refuses (a query tile
# is one TMA box at one head) and the CUDA-core body takes
PREFILL_WG = [(16, 16, 64, 16), (8, 4, 64, 16), (4, 4, 128, 8), (4, 4, 64, 32), (8, 4, 32, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_WG, ids=[str(c) for c in PREFILL_WG])
def test_cuda_prefill_wgmma_d256_edges(case):
    """On a card: bf16 chunked prefill at D 256 takes the wgmma path (one
    tensor-core launch each) on the transposed views the prefill layer
    hands it, with a one-token chunk, an idle (len-0) slot, a partial chunk
    and a chunk whose pages reach the last table entry, with and without a
    window: within two bf16 ulps of the plain version, both write the
    chunk's K/V at every live position, and the idle slot's pages keep their
    bytes (its dead pages go to the sink page 0).  A chunk below 64
    positions takes the CUDA-core body, held to the same."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    hq, hkv, chunk, ps = case
    dev, d, b, max_len = torch.device("cuda"), 256, 4, 512
    mp = max_len // ps
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(11), b, mp, num_pages), device=dev)
    starts = torch.tensor([0, 32, 256, max_len - chunk], dtype=torch.int32, device=dev)
    clens = torch.tensor([1, 0, min(37, chunk - 1), chunk], dtype=torch.int32, device=dev)
    tc = PF.tensor_core_path(torch.bfloat16, d, ps, hq // hkv, mp, chunk)
    assert tc == (chunk % 64 == 0)
    g = torch.Generator(device=dev).manual_seed(12)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    kp, vp = rand(hkv, num_pages, ps, d), rand(hkv, num_pages, ps, d)
    qc = rand(b, chunk, hq, d).transpose(1, 2)  # as attention_prefill_paged hands them
    kn, vn = rand(b, chunk, hkv, d).transpose(1, 2), rand(b, chunk, hkv, d).transpose(1, 2)
    tb = tables.cpu().numpy()
    idle = [int(tb[1, 32 // ps + i]) for i in range(chunk // ps)]  # slot 1's chunk pages
    for window in (None, 96):
        p1, p2 = [kp.clone(), vp.clone()], [kp.clone(), vp.clone()]
        n0, tc0 = PF.KERNEL.launches, PF.KERNEL.tc_launches
        out = PF.prefill_attention(qc, kn, vn, *p1, tables, starts, clens, window=window)[0]
        assert (PF.KERNEL.launches, PF.KERNEL.tc_launches) == (n0 + 1, tc0 + int(tc))
        assert not tc or out.stride() == qc.stride()  # written in the layer's layout
        plain = ref.paged_prefill_attention(qc, kn, vn, *p2, tables, starts, clens,
                                            window=window)[0]
        assert _within_limit(out, plain)
        for bi, (s0, n) in enumerate(zip(starts.tolist(), clens.tolist())):
            for c in range(n):
                pg, of = int(tb[bi, (s0 + c) // ps]), (s0 + c) % ps
                for pool_k, pool_p, new in zip(p1, p2, (kn, vn)):
                    assert torch.equal(pool_k[:, pg, of], new[bi, :, c])
                    assert torch.equal(pool_p[:, pg, of], new[bi, :, c])
        for pool, orig in zip(p1, (kp, vp)):
            assert torch.equal(pool[:, idle], orig[:, idle])


# (b, hq, hkv, sq, sk, causal) at D 256 on wgmma: gemma-7b's training shape
# at two batch rows, Sq and Sk off the 128-row and 32-key tiles, non-causal
# and ragged, Sq > Sk (the first 200 rows see no key), one partial query
# tile whose second consumer has no row
FLASH_WG = [(2, 16, 16, 1024, 1024, True), (2, 4, 2, 200, 333, True),
            (2, 4, 4, 130, 77, False), (2, 4, 2, 300, 100, True), (1, 2, 1, 17, 70, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_WG, ids=[str(c) for c in FLASH_WG])
def test_cuda_flash_attention_wgmma_d256_edges(case):
    """On a card: bf16 at (256, 256) takes the wgmma path (one tensor-core
    launch each) on the strided (B, H, S, D) views of (B, S, H, D) tensors
    and on contiguous copies, within two bf16 ulps of the plain version; a
    causal query row with no key to see emits zeros; fp32 at D 256 keeps
    the CUDA-core body."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    b, hq, hkv, sq, sk, causal = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    views = (rand(b, sq, hq, 256).transpose(1, 2), rand(b, sk, hkv, 256).transpose(1, 2),
             rand(b, sk, hkv, 256).transpose(1, 2))
    dead = max(0, sq - sk) if causal else 0
    for q, k, v in (views, [t.contiguous() for t in views]):
        n0, tc0 = FA.KERNEL.launches, FA.KERNEL.tc_launches
        got = FA.flash_attention(q, k, v, causal=causal)
        assert (FA.KERNEL.launches, FA.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        assert got.shape == q.shape and got.stride() == q.stride()
        want = ref.attention(q, k, v, causal=causal)
        if dead:
            assert got[:, :, :dead].abs().max().item() == 0.0
        assert _within_limit(got[:, :, dead:], want[:, :, dead:])
    if sq * sk <= 1 << 16:  # the CUDA-core body, slow at the large shapes
        q, k, v = (t.float() for t in views)
        tc0 = FA.KERNEL.tc_launches
        got = FA.flash_attention(q, k, v, causal=causal)
        assert FA.KERNEL.tc_launches == tc0
        want = ref.attention(q, k, v, causal=causal)
        assert _within_limit(got[:, :, dead:], want[:, :, dead:])


# the split decode's edges: lengths empty, one key, a 64-key tile's last key
# and the next, inside the second split, windows past the start, a key short
# of the table and the whole table (so splits past a short length are empty)
SPLIT_LENS = [0, 1, 64, 65, 100, 700, 1023, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_split_decode_edges(dtype, d):
    """On a card: the split decode (bf16 on the tensor cores, fp32 on CUDA
    cores, one grid of 16 splits of 64 keys for any lengths) at pages of 8,
    16 and 32, window None and 256, on SPLIT_LENS: within the limit of its
    plain version, a len-0 slot emitting zeros; the merge without the rescale
    fails the same limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    b, hq, hkv = len(SPLIT_LENS), 12, 2
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    for ps in (8, 16, 32):
        mp = 1024 // ps
        num_pages = b * mp + 1
        tables = torch.as_tensor(_tables(np.random.default_rng(ps), b, mp, num_pages), device=dev)
        g = torch.Generator(device=dev).manual_seed(ps)
        rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa: E731
        q, kp, vp = rand(b, hq, d), rand(hkv, num_pages, ps, d), rand(hkv, num_pages, ps, d)
        kp[:, 0] = float("nan")  # the reserved page, never in a table: never read
        vp[:, 0] = float("nan")
        splits, keys = PA.decode_splits(b, hkv, mp, ps, PA.sm_count(dev.index or 0))
        for window in (None, 256):
            n0, tc0 = PA.KERNEL.launches, PA.KERNEL.tc_launches
            got = PA.paged_attention(q, kp, vp, tables, lens, window=window)
            torch.cuda.synchronize()
            assert (PA.KERNEL.launches, PA.KERNEL.tc_launches) == (
                n0 + 1, tc0 + (dt == torch.bfloat16))
            want = ref.paged_attention(q, kp, vp, tables, lens, window=window)
            assert torch.isfinite(got).all() and torch.all(got[0] == 0)
            assert _within_limit(got, want), (ps, window)
            faulty = PA.split_decode(q, kp, vp, tables, lens, splits, keys, window=window,
                                     pair=dt == torch.bfloat16, rescale=False)
            assert not _within_limit(faulty, want), (ps, window)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_split_decode_edges(fmt, dtype, d):
    """On a card: the quantized split decode (bf16 on the tensor cores, its
    packed tiles staged and dequantized; fp32 on CUDA cores; one grid of 16
    splits of 64 keys for any lengths) at pages of 8, 16 and 32, window
    None and 256, on SPLIT_LENS: within the limit of its plain version, a
    len-0 slot emitting zeros, the reserved page's NaN scales never read;
    the merge without the rescale fails the same limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    b, hq, hkv = len(SPLIT_LENS), 12, 2
    lens = torch.tensor(SPLIT_LENS, dtype=torch.int32, device=dev)
    for ps in (8, 16, 32):
        mp = 1024 // ps
        num_pages = b * mp + 1
        tables = torch.as_tensor(_tables(np.random.default_rng(ps), b, mp, num_pages), device=dev)
        g = torch.Generator(device=dev).manual_seed(ps)
        rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa: E731
        q = rand(b, hq, d)
        (kq, ks), (vq, vs) = (ref.quantize_rows(rand(hkv, num_pages, ps, d), fmt)
                              for _ in range(2))
        ks[:, 0] = float("nan")  # the reserved page, never in a table: never read
        vs[:, 0] = float("nan")
        kp, vp = (ref.dequantize_rows(a, sc, fmt).to(dt) for a, sc in ((kq, ks), (vq, vs)))
        splits, keys = PA.decode_splits(b, hkv, mp, ps, PA.sm_count(dev.index or 0))
        for window in (None, 256):
            n0, tc0 = PAQ.KERNEL.launches, PAQ.KERNEL.tc_launches
            got = PAQ.paged_attention_quant(q, kq, vq, ks, vs, tables, lens, fmt=fmt,
                                            window=window)
            torch.cuda.synchronize()
            assert (PAQ.KERNEL.launches, PAQ.KERNEL.tc_launches) == (
                n0 + 1, tc0 + (dt == torch.bfloat16))
            want = ref.paged_attention_quant(q, kq, vq, ks, vs, tables, lens, fmt=fmt,
                                             window=window)
            assert torch.isfinite(got).all() and torch.all(got[0] == 0)
            assert _within_limit(got, want), (ps, window)
            faulty = PA.split_decode(q, kp, vp, tables, lens, splits, keys, window=window,
                                     pair=dt == torch.bfloat16, rescale=False)
            assert not _within_limit(faulty, want), (ps, window)


# The bulk-copy walk (decode_walk.cuh): (hq, hkv, d, page_size) at gemma-7b's
# MHA at D 256, a group of 2, a group of 3 over pages of 8 (4 rows a warp,
# one dead), pages of 32, and a group of 1 at D 128 (deepseek-7b) and 64;
# lengths empty, one key, a page's last key, a length past a 128-key split's
# end, a window's start inside a page, a full table
WALK = [(16, 16, 256, 16), (8, 4, 256, 16), (12, 4, 256, 8), (4, 4, 256, 32),
        (32, 32, 128, 16), (4, 4, 64, 16)]
WALK_LENS = [0, 1, 15, 16, 200, 555, 1000, 1024]


def _walk_reference(q, kp, vp, tables, lens, window, num_pages):
    """The decode in fp32, rounded once, over pools as given (the quantized
    twin's dequantized to bf16), with the keys of a table entry outside the
    pool left out, as the kernels skip such a page (the plain version clamps
    it into the pool), and a dead key's value never read."""
    b, hq, d = q.shape
    hkv, _, ps, _ = kp.shape
    t = tables.long()
    inside = ((t >= 0) & (t < num_pages)).repeat_interleave(ps, 1)
    t = t.clamp(0, num_pages - 1)
    k = kp[:, t].transpose(0, 1).reshape(b, hkv, -1, d).float()
    v = vp[:, t].transpose(0, 1).reshape(b, hkv, -1, d).float()
    pos = torch.arange(k.shape[2], device=q.device)
    n = lens.long()[:, None]
    live = inside & (pos[None] < n) & (pos[None] >= (n - window if window else 0))
    s = torch.einsum("bhgd,bhsd->bhgs", q.reshape(b, hkv, hq // hkv, d).float(), k) * d ** -0.5
    s = s.masked_fill(~live[:, None, None, :], float("-inf"))
    p = torch.exp(s - s.amax(-1, keepdim=True).clamp_min(-1e30))
    o = p @ v.masked_fill(~live[:, None, :, None], 0.0)
    return (o / p.sum(-1, keepdim=True).clamp_min(1e-30)).reshape(b, hq, d).to(q.dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, "int8", "int4"], ids=["bf16", "int8", "int4"])
@pytest.mark.parametrize("case", WALK, ids=[str(c) for c in WALK])
def test_cuda_decode_walk_edges(case, fmt):
    """On a card: rows 1 and 3 on the bulk-copy walk (one walk launch each,
    none on the tensor cores) on WALK_LENS, with and without a window of
    200: within two bf16 ulps of the plain version, a len-0 slot emitting
    zeros, the reserved page's NaN never read.  Then with a table entry out
    of the pool on a live page and NaN planted in the dead rows of a page a
    length or the window cuts: within two ulps of the decode without those
    keys, every value finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    hq, hkv, d, ps = case
    dev = torch.device("cuda")
    b, mp = len(WALK_LENS), 1024 // ps
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(ps + d), b, mp, num_pages), device=dev)
    lens = torch.tensor(WALK_LENS, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(d + hq)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    q = rand(b, hq, d)
    kf, vf = rand(hkv, num_pages, ps, d), rand(hkv, num_pages, ps, d)
    if fmt is None:
        kp, vp = kf, vf
        pools, mod, kw = [kp, vp], PA, {}
        plain = ref.paged_attention
    else:
        (kq, ks), (vq, vs) = ref.quantize_rows(kf, fmt), ref.quantize_rows(vf, fmt)
        pools, mod, kw = [kq, vq, ks, vs], PAQ, {"fmt": fmt}
        plain = ref.paged_attention_quant
    nan = pools[-2:]  # the values, or the scales, a dead row must never reach
    for t in nan:
        t[:, 0] = float("nan")  # the reserved page, never in a table
    kernel = PA.paged_attention if fmt is None else PAQ.paged_attention_quant
    assert PA.walk_path(torch.bfloat16, d, hq // hkv, ps)
    for window in (None, 200):
        n0 = (mod.KERNEL.launches, mod.KERNEL.tc_launches, mod.KERNEL.walk_launches)
        got = kernel(q, *pools, tables, lens, window=window, **kw)
        torch.cuda.synchronize()
        assert (mod.KERNEL.launches, mod.KERNEL.tc_launches, mod.KERNEL.walk_launches) == (
            n0[0] + 1, n0[1], n0[2] + 1)
        want = plain(q, *pools, tables, lens, window=window, **kw)
        assert torch.isfinite(got).all() and torch.all(got[0] == 0)
        assert _within_limit(got, want), window
    # under a window of 96: slot 5 (555 keys) with table entry 3 out of the
    # pool; NaN in the rows past slot 2's 15 keys and before slot 4's window
    # (its 200 keys from 104)
    bad = tables.clone()
    bad[5, 3] = num_pages + 7
    for slot, page, cut in ((2, 0, slice(15, None)), (4, 104 // ps, slice(0, 104 % ps))):
        for t in nan:  # K and V rows, or both scale columns
            t[:, int(tables[slot, page]), cut] = float("nan")
    if fmt is None:
        kd, vd = pools
    else:
        kd, vd = (ref.dequantize_rows(a, sc, fmt).bfloat16() for a, sc in
                  ((pools[0], pools[2]), (pools[1], pools[3])))
    got = kernel(q, *pools, bad, lens, window=96, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    assert _within_limit(got, _walk_reference(q, kd, vd, bad, lens, 96, num_pages))


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_quant_kernels_match_plain_versions(fmt):
    """On a card: each quantized kernel against its plain version, bf16 and
    fp32, with a len-0 slot, a window and a partial chunk; the pages both
    write hold the same packed bytes and scales at live positions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    b, hq, hkv, d, ps, mp, chunk = 4, 12, 2, 128, 16, 8, 32
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(rng, b, mp, num_pages), device=dev)
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 40):
            g = torch.Generator(device=dev).manual_seed(0)
            rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
            q = rand(b, hq, d)
            pools = [*ref.quantize_rows(rand(hkv, num_pages, ps, d), fmt),
                     *ref.quantize_rows(rand(hkv, num_pages, ps, d), fmt)]
            kq, ks, vq, vs = pools
            lens = torch.tensor([0, 1, 77, mp * ps], dtype=torch.int32, device=dev)
            n0 = PAQ.KERNEL.launches
            got = PAQ.paged_attention_quant(q, kq, vq, ks, vs, tables, lens,
                                            fmt=fmt, window=window)
            assert PAQ.KERNEL.launches == n0 + 1
            want = ref.paged_attention_quant(q, kq, vq, ks, vs, tables, lens,
                                             fmt=fmt, window=window)
            assert _within_limit(got, want)
            qc = rand(b, hq, chunk, d)
            knq, kns = ref.quantize_rows(rand(b, hkv, chunk, d), fmt)
            vnq, vns = ref.quantize_rows(rand(b, hkv, chunk, d), fmt)
            starts = torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev)
            clens = torch.tensor([32, 0, 19, 32], dtype=torch.int32, device=dev)
            p1 = [t.clone() for t in (kq, vq, ks, vs)]
            p2 = [t.clone() for t in (kq, vq, ks, vs)]
            out = PFQ.prefill_attention_quant(qc, knq, vnq, kns, vns, *p1, tables,
                                              starts, clens, fmt=fmt,
                                              window=window)[0]
            plain = ref.paged_prefill_attention_quant(
                qc, knq, vnq, kns, vns, *p2, tables, starts, clens, fmt=fmt,
                window=window)[0]
            assert _within_limit(out, plain)
            tb = tables.cpu().numpy()
            for bi, (s0, n) in enumerate(zip(starts.tolist(), clens.tolist())):
                for c in range(n):
                    pg, of = int(tb[bi, (s0 + c) // ps]), (s0 + c) % ps
                    for pool_k, pool_p, new in zip(p1, p2, (knq, vnq, kns, vns)):
                        assert torch.equal(pool_k[:, pg, of], new[bi, :, c])
                        assert torch.equal(pool_p[:, pg, of], new[bi, :, c])


# (hq, hkv, d, page_size, format): qwen2-1.5B's heads at head dims 128 and
# 64 on pages of 16 (two key groups of 6 warps) and 8, a group of 4 on pages
# of 32 (128 rows: one key group of 8 warps), a group of 5 (pages of 8: 40
# rows, 8 dead rows pad the last warp), and chatglm3-6b's group of 16 (two
# blocks of 8 heads a page, head_split)
PREFILL_QUANT_TC = [(12, 2, 128, 16, "int8"), (12, 2, 128, 16, "int4"), (12, 2, 64, 16, "int8"),
                    (12, 2, 128, 8, "int4"), (8, 2, 128, 32, "int8"), (10, 2, 64, 8, "int4"),
                    (32, 2, 128, 16, "int8"), (32, 2, 128, 16, "int4")]


@pytest.mark.cuda
@pytest.mark.parametrize("case", PREFILL_QUANT_TC, ids=[str(c) for c in PREFILL_QUANT_TC])
def test_cuda_prefill_quant_tensor_core_edges(case):
    """On a card: the bf16 quantized chunked prefill takes the tensor-core
    path (one tensor-core launch each) on the transposed q the prefill layer
    hands it, with a one-token chunk, an idle (len-0) slot, a partial chunk
    and a chunk whose pages reach the last table entry, with and without a
    window: within two bf16 ulps of the plain version, the output in q's
    layout, and the four pools byte-identical to the plain version's at
    every live position (packed bytes and scales)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    hq, hkv, d, ps, fmt = case
    dev = torch.device("cuda")
    b, mp, chunk = 4, 128 // ps, 32
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(12), b, mp, num_pages), device=dev)
    # page-aligned starts (the kernel's contract): pages of 32 start slot 1 at 0
    starts = torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev) // ps * ps
    clens = torch.tensor([1, 0, 19, 32], dtype=torch.int32, device=dev)  # 96 + 32 = 128
    g = torch.Generator(device=dev).manual_seed(13)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    pools = [*ref.quantize_rows(rand(hkv, num_pages, ps, d), fmt),
             *ref.quantize_rows(rand(hkv, num_pages, ps, d), fmt)]
    pools = [pools[0], pools[2], pools[1], pools[3]]  # k, v bytes; k, v scales
    qc = rand(b, chunk, hq, d).transpose(1, 2)  # as attention_prefill_paged hands them
    (knq, kns), (vnq, vns) = (ref.quantize_rows(rand(b, hkv, chunk, d), fmt) for _ in range(2))
    tb = tables.cpu().numpy()
    for window in (None, 40):
        p1, p2 = [t.clone() for t in pools], [t.clone() for t in pools]
        n0, tc0 = PFQ.KERNEL.launches, PFQ.KERNEL.tc_launches
        out = PFQ.prefill_attention_quant(qc, knq, vnq, kns, vns, *p1, tables, starts, clens,
                                          fmt=fmt, window=window)[0]
        assert (PFQ.KERNEL.launches, PFQ.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        assert out.stride() == qc.stride()  # written in the layer's layout
        plain = ref.paged_prefill_attention_quant(qc, knq, vnq, kns, vns, *p2, tables, starts,
                                                  clens, fmt=fmt, window=window)[0]
        assert _within_limit(out, plain)
        for bi, (s0, n) in enumerate(zip(starts.tolist(), clens.tolist())):
            for c in range(n):
                pg, of = int(tb[bi, (s0 + c) // ps]), (s0 + c) % ps
                for pool_k, pool_p, new in zip(p1, p2, (knq, vnq, kns, vns)):
                    assert torch.equal(pool_k[:, pg, of], new[bi, :, c])
                    assert torch.equal(pool_p[:, pg, of], new[bi, :, c])


# ---------------------------------------------------------------------------
# multi-head latent attention: deepseek-v2-lite-16B's widths (16 heads, a
# 512-wide latent, a 64-wide rope part), the model's scale 1 / sqrt(192)
# ---------------------------------------------------------------------------

MLA = dict(b=4, h=16, r=512, pe=64, ps=16, mp=8, chunk=32)
MLA_SCALE = 192 ** -0.5


def _mla_inputs(seed, dtype, fmt=None):
    """Tables, decode lengths (a len-0 slot), chunk starts and lengths (an
    idle slot, a partial chunk), queries, a chunk and pools (quantized per
    row when ``fmt`` is set: then (packed, packed, scales, scales))."""
    dev = torch.device("cuda")
    m = MLA
    rng = np.random.default_rng(seed)
    num_pages = m["b"] * m["mp"] + 1
    tables = torch.as_tensor(_tables(rng, m["b"], m["mp"], num_pages), device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731

    def latent(*lead):
        ckv, kpe = rand(*lead, m["r"]), rand(*lead, m["pe"])
        if fmt is None:
            return [ckv, kpe]
        (cq, cs), (pq, ps) = ref.quantize_rows(ckv, fmt), ref.quantize_rows(kpe, fmt)
        return [cq, pq, cs, ps]

    return dict(
        tables=tables, num_pages=num_pages,
        lens=torch.tensor([0, 1, 77, m["mp"] * m["ps"]], dtype=torch.int32, device=dev),
        starts=torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev),
        clens=torch.tensor([32, 0, 19, 32], dtype=torch.int32, device=dev),
        q=rand(m["b"], m["h"], m["r"]), qpe=rand(m["b"], m["h"], m["pe"]),
        qc=rand(m["b"], m["h"], m["chunk"], m["r"]),
        qpec=rand(m["b"], m["h"], m["chunk"], m["pe"]),
        new=latent(m["b"], m["chunk"]), pools=latent(num_pages, m["ps"]))


def _mla_decode_case(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    mod, plain_fn = (MP, ref.mla_paged) if fmt is None else (MPQ, ref.mla_paged_quant)
    kernel = MP.mla_paged if fmt is None else MPQ.mla_paged_quant
    kw = {} if fmt is None else {"fmt": fmt}
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 40):
            x = _mla_inputs(8, dtype, fmt)
            n0, tc0 = mod.KERNEL.launches, mod.KERNEL.tc_launches
            got = kernel(x["q"], x["qpe"], *x["pools"], x["tables"], x["lens"],
                         sm_scale=MLA_SCALE, window=window, **kw)
            assert mod.KERNEL.launches == n0 + 1
            assert mod.KERNEL.tc_launches == tc0 + (dtype == torch.bfloat16)
            want = plain_fn(x["q"], x["qpe"], *x["pools"], x["tables"], x["lens"],
                            sm_scale=MLA_SCALE, window=window, **kw)
            assert _within_limit(got, want) and got[0].abs().max().item() == 0.0


def _mla_prefill_case(fmt):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    mod, plain_fn = ((MF, ref.paged_mla_prefill) if fmt is None else
                     (MFQ, ref.paged_mla_prefill_quant))
    kernel = MF.mla_prefill if fmt is None else MFQ.mla_prefill_quant
    kw = {} if fmt is None else {"fmt": fmt}
    ps = MLA["ps"]
    for dtype in (torch.float32, torch.bfloat16):
        for window in (None, 40):
            x = _mla_inputs(9, dtype, fmt)
            p1 = [t.clone() for t in x["pools"]]
            p2 = [t.clone() for t in x["pools"]]
            args = (x["tables"], x["starts"], x["clens"])
            n0, tc0 = mod.KERNEL.launches, mod.KERNEL.tc_launches
            out = kernel(x["qc"], x["qpec"], *x["new"], *p1, *args,
                         sm_scale=MLA_SCALE, window=window, **kw)[0]
            assert mod.KERNEL.launches == n0 + 1
            assert mod.KERNEL.tc_launches == tc0 + (dtype == torch.bfloat16)
            plain = plain_fn(x["qc"], x["qpec"], *x["new"], *p2, *args,
                             sm_scale=MLA_SCALE, window=window, **kw)[0]
            assert _within_limit(out, plain)
            tb = x["tables"].cpu().numpy()
            for bi, (s0, n) in enumerate(zip(x["starts"].tolist(), x["clens"].tolist())):
                for c in range(n):
                    pg, of = int(tb[bi, (s0 + c) // ps]), (s0 + c) % ps
                    for pool_k, pool_p, new in zip(p1, p2, x["new"]):
                        assert torch.equal(pool_k[pg, of], new[bi, c])
                        assert torch.equal(pool_p[pg, of], new[bi, c])


# (page_size, fmt): pages of 16 (4 row blocks of 64 a chunk page), 8 (2),
# 32 (8) and 1 (one block of 16 live rows and 48 dead ones), fp and both
# quantized formats
MLA_PREFILL_TC = [(ps, fmt) for ps in (1, 8, 16, 32) for fmt in (None, "int8", "int4")]


@pytest.mark.cuda
@pytest.mark.parametrize("ps,fmt", MLA_PREFILL_TC, ids=[str(c) for c in MLA_PREFILL_TC])
def test_cuda_mla_prefill_tensor_core_edges(ps, fmt):
    """On a card: bf16 MLA chunked prefill (and its quantized twin) at
    deepseek-v2-lite-16B's widths takes the tensor-core path, one
    tensor-core launch each, with a one-token chunk, an idle (len-0) slot, a
    partial chunk and a chunk whose pages reach the last table entry, with
    and without window 96: within two bf16 ulps of the plain version, and
    both write the chunk's rows (packed bytes and both scales) at every live
    position, byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    m = MLA
    dev = torch.device("cuda")
    b, mp, chunk = m["b"], 128 // ps, m["chunk"]
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(12), b, mp, num_pages), device=dev)
    starts = torch.tensor([0, 16, 48, 96], dtype=torch.int32, device=dev) // ps * ps
    clens = torch.tensor([1, 0, 19, 32], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(13)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731

    def latent(*lead):
        ckv, kpe = rand(*lead, m["r"]), rand(*lead, m["pe"])
        if fmt is None:
            return [ckv, kpe]
        (cq, cs_), (pq, ps_) = ref.quantize_rows(ckv, fmt), ref.quantize_rows(kpe, fmt)
        return [cq, pq, cs_, ps_]

    qc, qpec = rand(b, m["h"], chunk, m["r"]), rand(b, m["h"], chunk, m["pe"])
    new, pools = latent(b, chunk), latent(num_pages, ps)
    mod, kernel, plain_fn = ((MF, MF.mla_prefill, ref.paged_mla_prefill) if fmt is None else
                             (MFQ, MFQ.mla_prefill_quant, ref.paged_mla_prefill_quant))
    kw = {} if fmt is None else {"fmt": fmt}
    tb = tables.cpu().numpy()
    for window in (None, 96):
        p1, p2 = [t.clone() for t in pools], [t.clone() for t in pools]
        n0, tc0 = mod.KERNEL.launches, mod.KERNEL.tc_launches
        out = kernel(qc, qpec, *new, *p1, tables, starts, clens, sm_scale=MLA_SCALE,
                     window=window, **kw)[0]
        assert (mod.KERNEL.launches, mod.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        plain = plain_fn(qc, qpec, *new, *p2, tables, starts, clens, sm_scale=MLA_SCALE,
                         window=window, **kw)[0]
        assert torch.isfinite(out).all() and _within_limit(out, plain)
        for bi, (s0, n) in enumerate(zip(starts.tolist(), clens.tolist())):
            for c in range(n):
                pg, of = int(tb[bi, (s0 + c) // ps]), (s0 + c) % ps
                for pool_k, pool_p, rows in zip(p1, p2, new):
                    assert torch.equal(pool_k[pg, of], rows[bi, c])
                    assert torch.equal(pool_p[pg, of], rows[bi, c])


# (page_size, fmt): the split decode's pages of 8, 16 and 32 (a 64-key split
# holds 8, 4 or 2 of them), fp and both quantized formats
MLA_DECODE_TC = [(ps, fmt) for ps in (8, 16, 32) for fmt in (None, "int8", "int4")]
# lengths: empty, one key, a split's last key and the next split's first, one
# inside the second split, windows past the start, the whole table
MLA_DECODE_LENS = [0, 1, 64, 65, 100, 700, 1023, 1024]


@pytest.mark.cuda
@pytest.mark.parametrize("ps,fmt", MLA_DECODE_TC, ids=[str(c) for c in MLA_DECODE_TC])
def test_cuda_mla_decode_tensor_core_edges(ps, fmt):
    """On a card: bf16 paged MLA decode (and its quantized twin) at
    deepseek-v2-lite-16B's widths and serving shape (slots 8, max_len 1024)
    takes the tensor-core path, one tensor-core launch each, over the split
    grid's edges (a len-0 slot, lengths at a split's ends, inside one and
    covering the table), with and without window 256: within two bf16 ulps
    of the plain version, the len-0 slot all zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    m = MLA
    dev = torch.device("cuda")
    b, mp = len(MLA_DECODE_LENS), 1024 // ps
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(14), b, mp, num_pages), device=dev)
    lens = torch.tensor(MLA_DECODE_LENS, dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(15)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    q, qpe = rand(b, m["h"], m["r"]), rand(b, m["h"], m["pe"])
    ckv, kpe = rand(num_pages, ps, m["r"]), rand(num_pages, ps, m["pe"])
    if fmt is None:
        mod, kernel, plain_fn, pools, kw = MP, MP.mla_paged, ref.mla_paged, [ckv, kpe], {}
    else:
        (cq, cs_), (pq, ps_) = ref.quantize_rows(ckv, fmt), ref.quantize_rows(kpe, fmt)
        mod, kernel, plain_fn = MPQ, MPQ.mla_paged_quant, ref.mla_paged_quant
        pools, kw = [cq, pq, cs_, ps_], {"fmt": fmt}
    for window in (None, 256):
        n0, tc0 = mod.KERNEL.launches, mod.KERNEL.tc_launches
        out = kernel(q, qpe, *pools, tables, lens, sm_scale=MLA_SCALE, window=window, **kw)
        assert (mod.KERNEL.launches, mod.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        plain = plain_fn(q, qpe, *pools, tables, lens, sm_scale=MLA_SCALE, window=window, **kw)
        assert torch.isfinite(out).all() and _within_limit(out, plain)
        assert out[0].abs().max().item() == 0.0


@pytest.mark.cuda
def test_cuda_mla_paged_matches_plain_version():
    """On a card: the paged MLA decode kernel against its plain version,
    bf16 and fp32, with a len-0 slot and a window."""
    _mla_decode_case(None)


@pytest.mark.cuda
def test_cuda_mla_prefill_matches_plain_version():
    """On a card: the MLA chunked-prefill kernel against its plain version,
    bf16 and fp32, with an idle slot, a partial chunk and a window; both
    write the chunk's latent and rope rows at its live positions."""
    _mla_prefill_case(None)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_mla_paged_quant_matches_plain_version(fmt):
    _mla_decode_case(fmt)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_cuda_mla_prefill_quant_matches_plain_version(fmt):
    """The quantized twins also write the packed bytes and both scales."""
    _mla_prefill_case(fmt)


# ---------------------------------------------------------------------------
# contiguous flash attention: qwen2-1.5B's heads (12 over 2, D 128)
# ---------------------------------------------------------------------------

FLASH = [  # (b, hq, hkv, sq, sk, d, causal)
    (2, 12, 2, 200, 200, 128, True),  # ragged: partial query and key tiles
    (2, 12, 2, 48, 300, 128, True),  # a suffix block of queries
    (2, 12, 2, 48, 300, 64, False),
    (1, 4, 4, 7, 5, 128, False),  # fewer keys than a tile
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH, ids=[str(c) for c in FLASH])
def test_cuda_flash_attention_matches_plain_version(case):
    """On a card: the flash kernel against its plain version, bf16 and fp32,
    on contiguous inputs and on the (B, H, S, D) views of (B, S, H, D)
    tensors that the full-sequence forward hands it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    b, hq, hkv, sq, sk, d, causal = case
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        g = torch.Generator(device=dev).manual_seed(3)
        rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dtype)  # noqa: E731
        views = (rand(b, sq, hq, d).transpose(1, 2), rand(b, sk, hkv, d).transpose(1, 2),
                 rand(b, sk, hkv, d).transpose(1, 2))
        for q, k, v in (views, [t.contiguous() for t in views]):
            n0, tc0 = FA.KERNEL.launches, FA.KERNEL.tc_launches
            got = FA.flash_attention(q, k, v, causal=causal)
            assert FA.KERNEL.launches == n0 + 1 and got.shape == q.shape
            tc = FA.tensor_core_path(dtype, d)
            assert FA.KERNEL.tc_launches == tc0 + tc
            want = ref.attention(q, k, v, causal=causal)
            assert _within_limit(got, want)


FLASH_TC = [  # (b, hq, hkv, sq, sk, d, causal): the tensor-core path's edges
    (2, 12, 2, 1024, 1024, 128, True),  # qwen2-1.5B's training shape, two batch rows
    (2, 12, 2, 1024, 1024, 64, True),
    (2, 12, 2, 200, 333, 128, True),  # Sq and Sk not multiples of 64
    (2, 12, 2, 130, 77, 64, False),  # non-causal, ragged
    (2, 6, 1, 300, 100, 128, True),  # Sq > Sk: the first 200 rows see no key
    (1, 4, 2, 17, 70, 64, True),  # one partial query tile over two key tiles
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLASH_TC, ids=[str(c) for c in FLASH_TC])
def test_cuda_flash_attention_tensor_core_edges(case):
    """On a card: bf16 at head dims 64 and 128 takes the tensor-core path
    (one tensor-core launch each), on the strided (B, H, S, D) views of
    (B, S, H, D) tensors and on contiguous copies, within two bf16 ulps of
    the plain version; a causal query row with no key to see (Sq > Sk)
    emits zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    b, hq, hkv, sq, sk, d, causal = case
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(8)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).bfloat16()  # noqa: E731
    views = (rand(b, sq, hq, d).transpose(1, 2), rand(b, sk, hkv, d).transpose(1, 2),
             rand(b, sk, hkv, d).transpose(1, 2))
    dead = max(0, sq - sk) if causal else 0  # rows with no key to see
    for q, k, v in (views, [t.contiguous() for t in views]):
        n0, tc0 = FA.KERNEL.launches, FA.KERNEL.tc_launches
        got = FA.flash_attention(q, k, v, causal=causal)
        assert (FA.KERNEL.launches, FA.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        assert got.shape == q.shape and got.stride() == q.stride()
        want = ref.attention(q, k, v, causal=causal)
        if dead:
            assert got[:, :, :dead].abs().max().item() == 0.0
        assert _within_limit(got[:, :, dead:], want[:, :, dead:])


@pytest.mark.cuda
def test_cuda_flash_attention_fn_gradients_match_plain_autograd():
    """On a card: ``FlashAttentionFn`` (the kernel forward, the plain
    version recomputed for the backward) gives autograd's gradients of the
    plain version; the forward launches the kernel once, the backward not."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    shapes = ((2, 12, 96, 128), (2, 2, 96, 128), (2, 2, 96, 128))
    ins = [torch.randn(s, generator=g, device=dev) for s in shapes]
    dout = torch.randn(shapes[0], generator=g, device=dev)
    grads = []
    for fn in (lambda q, k, v: FA.FlashAttentionFn.apply(q, k, v, True, None),
               lambda q, k, v: ref.attention(q, k, v, causal=True)):
        ts = [t.clone().requires_grad_(True) for t in ins]
        n0 = FA.KERNEL.launches
        out = fn(*ts)
        grads.append(torch.autograd.grad(out, ts, dout))
        assert FA.KERNEL.launches - n0 in (0, 1)
    for a, w in zip(*grads):
        assert (a - w).abs().max().item() <= cs.FP32_ATOL


# ---------------------------------------------------------------------------
# Mamba-2 SSD chunk kernels: mamba2-2.7B's and hymba-1.5B's head shapes
# ---------------------------------------------------------------------------

SSD = [  # (batch, heads, chunks, L, N, P, deep decay)
    (2, 80, 2, 128, 128, 64, True),  # mamba2-2.7B
    (2, 64, 2, 128, 16, 50, True),  # hymba-1.5B: rows of 100 bytes in bf16
    (1, 8, 3, 64, 128, 64, False),  # a chunk of 64, growing dA
    (2, 3, 2, 17, 200, 130, True),  # ragged: two N tiles, three P tiles
    (1, 4, 3, 50, 8, 20, False),  # a state of 8 rows: chunk_state's 16-row tile
]


def _ssd_case(case, dtype, dev):
    b, h, c, l, n, p, deep = case
    g = torch.Generator(device=dev).manual_seed(5)
    rand = lambda *s: torch.randn(s, generator=g, device=dev)  # noqa: E731
    cm, bm = (rand(b, 1, c, l, n).to(dtype).expand(b, h, c, l, n) for _ in range(2))
    x = rand(b, h, c, l, p).to(dtype)
    step = rand(b, h, c, l).abs() * (0.7 if deep else 0.1)
    da = torch.cumsum(-step if deep else step, dim=-1)
    return cm, bm, x, da, rand(b, h, c, n, p)


def _ssd_within_limit(got, want):
    if got.dtype == torch.bfloat16:
        return cs.bf16_ulps(torch, got, want) <= cs.BF16_ULPS
    return (got - want).abs().max().item() <= cs.FP32_ATOL * max(
        1.0, want.abs().max().item())


@pytest.mark.cuda
@pytest.mark.parametrize("case", SSD, ids=[str(c) for c in SSD])
def test_cuda_ssd_kernels_match_plain_versions(case):
    """On a card: chunk_state and chunk_scan against their plain versions,
    bf16 and fp32, on head-broadcast (expanded) B and C, on contiguous
    copies, and with the heads folded into the batch (the reference's
    layout)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    for dtype in (torch.float32, torch.bfloat16):
        cm, bm, x, da, prev = _ssd_case(case, dtype, dev)
        b, h = x.shape[:2]
        fold = lambda t: t.reshape(b * h, *t.shape[2:])  # noqa: E731
        for args in ((cm, bm, x, da, prev),
                     tuple(t.contiguous() for t in (cm, bm, x, da, prev)),
                     tuple(fold(t) for t in (cm, bm, x, da, prev))):
            c_, b_, x_, d_, s_ = args
            n0 = (CST.KERNEL.launches, CSC.KERNEL.launches)
            st = CST.chunk_state(b_, x_, d_)
            y = CSC.chunk_scan(c_, b_, x_, d_, s_)
            assert (CST.KERNEL.launches, CSC.KERNEL.launches) == (n0[0] + 1, n0[1] + 1)
            assert st.dtype == torch.float32 and y.dtype == dtype
            assert _ssd_within_limit(st, ref.chunk_state(b_, x_, d_))
            assert _ssd_within_limit(y, ref.chunk_scan(c_, b_, x_, d_, s_))


# (batch, heads, chunks, L, C and B broadcast over the heads, X in rows 2 P
# apart): mamba2-2.7B's N 128 / P 64 at chunks of 128 and 64
SCAN_TC = [(2, 80, 2, 128, True, False), (2, 6, 3, 64, True, True), (1, 5, 2, 128, False, True),
           (1, 3, 2, 64, False, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SCAN_TC, ids=[str(c) for c in SCAN_TC])
def test_cuda_chunk_scan_tensor_core_edges(case):
    """On a card: bf16 chunk_scan at mamba2's N 128 / P 64 takes its
    tensor-core path (every launch counted in tc_launches) on head-broadcast
    and materialised C and B, chunks of 128 and 64 and X read through
    strided rows, a deep decay: within two bf16 ulps of the plain version
    (a growing decay's outputs cancel past what the plain version's fp32
    resolves; chip_smoke.py prints that reading, and the SSD test above
    holds a chunk of 64 under it)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    batch, heads, nc, length, broadcast, strided = case
    dev = torch.device("cuda")
    cm, bm, x, da, prev = _ssd_case((batch, heads, nc, length, 128, 64, True),
                                    torch.bfloat16, dev)
    if not broadcast:
        cm, bm = cm.contiguous(), bm.contiguous()
    if strided:
        x = torch.cat([x, x], -1)[..., :64]
    n0, tc0 = CSC.KERNEL.launches, CSC.KERNEL.tc_launches
    y = CSC.chunk_scan(cm, bm, x, da, prev)
    assert (CSC.KERNEL.launches, CSC.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
    assert _ssd_within_limit(y, ref.chunk_scan(cm, bm, x, da, prev))


# (batch, heads, chunks, L, N, P, B broadcast over the heads): mamba2-2.7B's
# N 128 / P 64 at chunks of 128 and 64, N and P of one m-tile, several head
# groups (80 heads: 40 groups of 2 at batch 2 x 2 chunks on 132 SMs)
STATE_TC = [(2, 80, 2, 128, 128, 64, True), (2, 6, 3, 64, 128, 64, True),
            (1, 5, 2, 128, 16, 64, True), (1, 3, 2, 64, 128, 16, True),
            (1, 4, 2, 128, 128, 64, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STATE_TC, ids=[str(c) for c in STATE_TC])
def test_cuda_chunk_state_tensor_core_edges(case):
    """On a card: bf16 chunk_state at L, N and P multiples of 16 takes its
    tensor-core path (every launch counted in tc_launches), deep and growing
    decay: within 1e-4 of max(1, max |plain|); a head-stride-0 B, whose
    block stages it once for a group of heads, gives states bit-identical
    to a contiguous copy of B (one head a block)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    batch, heads, nc, length, n, p, broadcast = case
    dev = torch.device("cuda")
    for deep in (True, False):
        _, bm, x, da, _ = _ssd_case((batch, heads, nc, length, n, p, deep), torch.bfloat16, dev)
        if not broadcast:
            bm = bm.contiguous()
        n0, tc0 = CST.KERNEL.launches, CST.KERNEL.tc_launches
        st = CST.chunk_state(bm, x, da)
        assert (CST.KERNEL.launches, CST.KERNEL.tc_launches) == (n0 + 1, tc0 + 1)
        assert _ssd_within_limit(st, ref.chunk_state(bm, x, da))
        if broadcast:
            assert torch.equal(st, CST.chunk_state(bm.contiguous(), x, da))


@pytest.mark.cuda
def test_cuda_ssd_functions_gradients_match_plain_autograd():
    """On a card: ``ChunkStateFn`` and ``ChunkScanFn`` give autograd's
    gradients of the plain versions (the backward recomputes them), through
    the expanded B and C; the forwards launch their kernels once each."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    case = (2, 8, 2, 128, 128, 64, True)
    base = [t.clone() for t in _ssd_case(case, torch.float32, dev)]
    base[0], base[1] = base[0][:, :1].contiguous(), base[1][:, :1].contiguous()
    g = torch.Generator(device=dev).manual_seed(6)
    douts = (torch.randn(base[4].shape, generator=g, device=dev),
             torch.randn(base[2].shape, generator=g, device=dev))
    grads = []
    for st_fn, sc_fn in ((CST.ChunkStateFn.apply, CSC.ChunkScanFn.apply),
                         (ref.chunk_state, ref.chunk_scan)):
        leaves = [t.clone().requires_grad_(True) for t in base]
        cm, bm = (t.expand(*base[2].shape[:-1], t.shape[-1]) for t in leaves[:2])
        n0 = (CST.KERNEL.launches, CSC.KERNEL.launches)
        outs = (st_fn(bm, leaves[2], leaves[3]), sc_fn(cm, bm, *leaves[2:]))
        grads.append(torch.autograd.grad(outs, leaves, douts))
        assert (CST.KERNEL.launches - n0[0], CSC.KERNEL.launches - n0[1]) in ((0, 0), (1, 1))
    for a, w in zip(*grads):
        assert (a - w).abs().max().item() <= cs.FP32_ATOL * max(1.0, w.abs().max().item())


# ---------------------------------------------------------------------------
# the kernel library: GEMM, dequantized GEMM, contiguous FlashMLA
# ---------------------------------------------------------------------------

from repro_torch.kernels import ops  # noqa: E402

LIB_GEMM = [(1, 64, 48), (37, 72, 48), (130, 136, 48), (300, 1000, 520), (37, 100, 57),
            (1, 1000, 4096)]


def _lib_within_limit(got, want, sigma):
    if got.dtype == torch.float32:
        return cs.rel_err(torch, got, want) <= cs.FP32_ATOL
    return cs.lib_units(torch, got, want, sigma) <= cs.BF16_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cuda_matmul_matches_plain_version(dtype):
    """Tensor cores (16-bit, K and N multiples of 8) and CUDA cores (fp32,
    ragged K and N), masked edges, M = 1, every output type."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    dt = getattr(torch, dtype)
    for m, n, k in LIB_GEMM:
        a = torch.randn((m, k), generator=g, device=dev).to(dt)
        b = torch.randn((k, n), generator=g, device=dev).to(dt)
        for out_dtype in (dt, torch.float32, torch.bfloat16):
            n0 = ops.KERNELS["matmul"].launches
            got = ops.matmul(a, b, out_dtype=out_dtype)
            assert ops.KERNELS["matmul"].launches == n0 + 1
            want = ref.matmul(a, b, out_dtype)
            assert _lib_within_limit(got, want, k ** 0.5), (m, n, k, out_dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["int8", "int4", "int2", "nf4"])
@pytest.mark.parametrize("adtype", ["float16", "bfloat16", "int8", "float32"])
def test_cuda_dequant_matmul_matches_plain_version(fmt, adtype):
    """Every format and activation type, with and without scale groups that
    match no K tile, M = 1, 5, 8, 12, 64, 70, 129 and 256, ragged N and K: 16-bit activations within 2
    units of the plain version on the weight rounded to their type (the
    kernel's arithmetic, as the TPU kernel's); int8 and fp32 activations
    within 1e-4 of max(1, max |plain|).  Each case takes the route
    ``dequant_matmul.route`` gives it (the wgmma walk counts tc_launches)."""
    from repro_torch.kernels import dequant_matmul as DQ

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    dt = getattr(torch, adtype)
    pack = ref.WEIGHT_PACK[fmt]
    # the walk's activation blocks of 8 to 256 rows (M 129: two of 256's
    # halves empty; N 136 and 200 no multiple of its 64 weight rows); odd K
    # (48 / pack) keeps the CUDA cores
    for m, n, k, group in ((8, 128, 256, None), (70, 200, 512, None), (70, 192, 384, 96),
                           (8, 64, 192, 32), (5, 40, 48, None), (5, 72, 1024, 64),
                           (1, 40, 512, None), (12, 64, 1024, None), (64, 256, 512, None),
                           (129, 136, 1024, None), (256, 200, 2048, None), (256, 130, 768, 48)):
        if dt == torch.int8:
            a = torch.randint(-128, 128, (m, k), generator=g, device=dev, dtype=torch.int8)
        else:
            a = torch.randn((m, k), generator=g, device=dev).to(dt)
        bq = torch.randint(-128, 128, (n, k // pack), generator=g, device=dev, dtype=torch.int8)
        sdt = dt if dt in (torch.bfloat16, torch.float16) else torch.float32
        sc = None if group is None else (
            torch.rand((n, k // group), generator=g, device=dev) + 0.5).to(sdt)
        out_dt = torch.float32 if dt in (torch.int8, torch.float32) else dt
        tc = ops.KERNELS["dequant_matmul"].tc_launches
        got = ops.dequant_matmul(a, bq, fmt=fmt, scales=sc, out_dtype=out_dt)
        took = ops.KERNELS["dequant_matmul"].tc_launches - tc
        assert took == (DQ.route(dt, fmt, k, sc is not None, a, bq) == "wgmma"), (m, n, k, group)
        grp = group or 128
        if out_dt == torch.float32:
            want = ref.dequant_matmul(a, bq, fmt, sc, grp, out_dt)
            assert cs.rel_err(torch, got, want) <= cs.FP32_ATOL, (m, n, k, group)
        else:
            w = cs.rounded_weight(torch, ref, bq, fmt, sc, grp, dt)
            control = torch.matmul(a.float(), w.float().t()).to(out_dt)
            sigma = k ** 0.5 * cs.rms(torch, a) * cs.rms(torch, w)
            assert cs.lib_units(torch, got, control, sigma) <= cs.BF16_ULPS, (m, n, k, group)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_cuda_mla_matches_plain_version(dtype):
    """128 heads over one latent head (the paper's), two latent heads, a
    ragged sequence and a small head dim."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    for b, h, hkv, s, d, pe in ((2, 128, 1, 100, 512, 64), (1, 32, 2, 128, 64, 32),
                                (3, 16, 1, 1000, 512, 64)):
        q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
        q_pe = torch.randn((b, h, pe), generator=g, device=dev).to(dt)
        kv = torch.randn((b, s, hkv, d), generator=g, device=dev).to(dt)
        k_pe = torch.randn((b, s, hkv, pe), generator=g, device=dev).to(dt)
        got = ops.mla(q, q_pe, kv, k_pe)
        want = ref.mla(q, q_pe, kv, k_pe)
        if dt == torch.float16:
            assert cs.lib_units(torch, got, want, 1.0) <= cs.BF16_ULPS, (b, h, hkv, s)
        else:
            assert _within_limit(got, want), (b, h, hkv, s)


# FlashMLA's wgmma path: sequence lengths around its 32-key tiles (one tile,
# so the second consumer only reads; a ragged last tile; an even and an odd
# tile count), a partial head group (deepseek-v2-lite-16B's 16 heads), two
# head groups, two latent heads, and rope widths of 64 and 128 (three
# stages) and 192 (two)
MLA_WGMMA_CASES = [  # (b, h, hkv, s, d, pe)
    (1, 128, 1, 1, 512, 64), (2, 64, 1, 31, 512, 64), (1, 16, 1, 32, 512, 64),
    (3, 16, 1, 33, 512, 64), (2, 128, 1, 64, 512, 64), (1, 128, 1, 65, 512, 64),
    (2, 128, 2, 200, 512, 64), (8, 16, 1, 777, 512, 64), (1, 32, 1, 1000, 512, 128),
    (2, 64, 1, 300, 512, 192),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_cuda_mla_wgmma_edges(dtype):
    """On a card: every case takes the wgmma kernel (one ``tc_launches``
    each) and lies within the limit of the plain version; fp32 at the same
    shapes with Dpe 64 stays on the CUDA cores within FP32_ATOL (their fp32
    tiles hold D + Dpe up to 576)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from repro_torch.kernels import mla as MLA
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(4)
    for dt in (getattr(torch, dtype), torch.float32):
        for b, h, hkv, s, d, pe in MLA_WGMMA_CASES:
            if dt == torch.float32 and pe > 64:
                continue
            q = torch.randn((b, h, d), generator=g, device=dev).to(dt)
            q_pe = torch.randn((b, h, pe), generator=g, device=dev).to(dt)
            kv = torch.randn((b, s, hkv, d), generator=g, device=dev).to(dt)
            k_pe = torch.randn((b, s, hkv, pe), generator=g, device=dev).to(dt)
            before = MLA.KERNEL.tc_launches
            got = ops.mla(q, q_pe, kv, k_pe)
            torch.cuda.synchronize()
            assert MLA.KERNEL.tc_launches - before == int(dt != torch.float32), (dt, b, h, s)
            want = ref.mla(q, q_pe, kv, k_pe)
            if dt == torch.float16:
                assert cs.lib_units(torch, got, want, 1.0) <= cs.BF16_ULPS, (b, h, hkv, s, pe)
            else:
                assert _within_limit(got, want), (dt, b, h, hkv, s, pe)


# the wgmma path's edges: M from its first row (17) to a multiple of the
# 128-row tile and past it, N from one 8-column group to past a 256-column
# tile, K from one 8-element group to a 64-element tile and a ragged 4104
WGMMA_M, WGMMA_N, WGMMA_K = (17, 63, 64, 129, 4096), (8, 136, 264), (8, 72, 4104)


@pytest.mark.cuda
@pytest.mark.parametrize("dtypes", [("bfloat16", "float32"), ("bfloat16", "bfloat16"),
                                    ("float16", "float16")], ids=str)
def test_cuda_matmul_wgmma_edges(dtypes):
    """On a card: every 16-bit shape with M >= 17 takes the wgmma path (one
    ``tc_launches`` each) and lies within the limit of the plain version, for
    every output type; M = 16 stays on mma.sync."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(1)
    dt, od = (getattr(torch, x) for x in dtypes)
    for m in (16, *WGMMA_M):
        for n in WGMMA_N:
            for k in WGMMA_K:
                a = torch.randn((m, k), generator=g, device=dev).to(dt)
                b = torch.randn((k, n), generator=g, device=dev).to(dt)
                tc0 = ops.KERNELS["matmul"].tc_launches
                got = ops.matmul(a, b, out_dtype=od)
                torch.cuda.synchronize()
                assert ops.KERNELS["matmul"].tc_launches == tc0 + (m >= 17), (m, n, k)
                want = ref.matmul(a, b, od)
                assert _lib_within_limit(got, want, k ** 0.5), (m, n, k)


# ---------------------------------------------------------------------------
# hymba-1.5B: the decode at its shape, its training step's kernels
# ---------------------------------------------------------------------------

# tokens a slot and the slots' lengths: the serving run's 8 slots of 1024
# (chip_smoke.py's engine; the window of 1024 never binds there) and 8 slots
# of 2048 (the window drops whole splits of the longer slots)
HYMBA_SHAPES = [(1024, [0, 1, 64, 255, 256, 700, 1000, 1024]),
                (2048, [0, 1, 64, 700, 1024, 1025, 1500, 2048])]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", HYMBA_SHAPES, ids=["serving 1024", "2048"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_cuda_decode_at_hymba_shape_with_a_binding_window(dtype, shape):
    """On a card: the decode at hymba-1.5B's heads (25 query heads over 5
    KV heads of 64, a group of 5) over 8 slots in pages of 16, at the
    serving run's 1024 tokens a slot and at 2048, where its window of 1024
    drops whole splits; with that window and with none: within the limit
    of its plain version, a len-0 slot emitting zeros, bf16 on the tensor
    cores; the merge without the rescale fails the same limit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    dev = torch.device("cuda")
    dt = getattr(torch, dtype)
    max_len, lens = shape
    assert (cs.HYMBA_SERVE_DECODE.slots, cs.HYMBA_SERVE_DECODE.max_len) == (8, 1024)
    b, hq, hkv, d, ps, mp = len(lens), 25, 5, 64, 16, max_len // 16
    num_pages = b * mp + 1
    tables = torch.as_tensor(_tables(np.random.default_rng(9), b, mp, num_pages), device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    rand = lambda *s: torch.randn(s, generator=g, device=dev).to(dt)  # noqa: E731
    q, kp, vp = rand(b, hq, d), rand(hkv, num_pages, ps, d), rand(hkv, num_pages, ps, d)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    splits, keys = PA.decode_splits(b, hkv, mp, ps, PA.sm_count(dev.index or 0))
    assert splits > 1 and splits * keys >= max_len
    if max_len == 2048:
        assert keys <= 1024  # a window of 1024 skips splits
    for window in (1024, None):
        n0, tc0 = PA.KERNEL.launches, PA.KERNEL.tc_launches
        got = PA.paged_attention(q, kp, vp, tables, lens, window=window)
        torch.cuda.synchronize()
        assert (PA.KERNEL.launches, PA.KERNEL.tc_launches) == (
            n0 + 1, tc0 + (dt == torch.bfloat16))
        want = ref.paged_attention(q, kp, vp, tables, lens, window=window)
        assert torch.isfinite(got).all() and torch.all(got[0] == 0)
        assert _within_limit(got, want), window
        faulty = PA.split_decode(q, kp, vp, tables, lens, splits, keys, window=window,
                                 pair=dt == torch.bfloat16, rescale=False)
        assert not _within_limit(faulty, want), window


@pytest.mark.cuda
def test_cuda_hymba_training_step_takes_the_ssd_kernels_off_tensor_cores():
    """On a card: a training step of full-width hymba-1.5B cut to 2 layers
    (batch 1 x seq 256, bf16) launches chunk_state and chunk_scan twice a
    layer (the forward and its recompute), none on the tensor cores (P 50),
    and no flash kernel (every layer's attention carries a window, so the
    plain version runs, as the reference routes it); the loss is finite."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state, make_train_step
    from repro_torch.optim import AdamWConfig

    dev = torch.device("cuda")
    cfg = dataclasses.replace(get_config("hymba_1_5b"), num_layers=2)
    state = build_state(cfg, 0, dev)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=2))
    tokens = torch.randint(0, cfg.vocab_size, (1, 256), generator=torch.Generator().manual_seed(0))
    kernels = (CST.KERNEL, CSC.KERNEL, FA.KERNEL)
    for k in kernels:
        k.launches = k.tc_launches = 0
    state, m = step(state, {"tokens": tokens, "labels": tokens.roll(-1, 1)})
    assert np.isfinite(m["loss"].item()) and np.isfinite(m["grad_norm"].item())
    assert [(k.launches, k.tc_launches) for k in kernels] == [(4, 0), (4, 0), (0, 0)]


@pytest.mark.cuda
def test_cuda_step_breakdown_matches_the_profilers_event_tree():
    """On a card: chip_smoke.py's step breakdown, read from the profiler's
    raw events, equals what the profiler's event tree (``key_averages``)
    gives for one profiled training step of reduced mamba2 (the SSD kernels
    and their plain recompute in the backward, AdamW): the device's busy
    time, each kernel group, and the device time inside each annotated
    range."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    from torch.autograd import DeviceType

    from repro_torch.configs import get_config
    from repro_torch.launch.train import build_state, make_train_step
    from repro_torch.optim import AdamWConfig

    dev = torch.device("cuda")
    cfg = get_config("mamba2_2_7b").reduced()
    state = build_state(cfg, 0, dev)
    step = make_train_step(cfg, AdamWConfig(warmup_steps=1, total_steps=2))
    tokens = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tokens, "labels": tokens.roll(-1, 1)}
    state, m = step(state, batch)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        state, m = step(state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
    got = cs.step_breakdown(torch, prof.profiler.kineto_results.events())
    events = prof.key_averages()
    rows = [e for e in events if e.device_type == DeviceType.CUDA and e.key not in cs.RANGES]
    want = {"device busy": sum(e.self_device_time_total for e in rows) / 1e3}
    for e in rows:
        g = cs._kernel_group(e.key)
        want[g] = want.get(g, 0.0) + e.self_device_time_total / 1e3
    for e in events:
        if e.device_type == DeviceType.CPU and e.key in cs.RANGES:
            want["inside " + e.key] = e.device_time_total / 1e3
    top = got.pop("top")
    assert top and want["device busy"] > 0 and want["inside chunk_scan.backward"] > 0
    assert set(got) == set(want) and all(
        got[k] == pytest.approx(want[k], rel=1e-6, abs=1e-6) for k in want), (got, want)


def _compiled_cases():
    """Every PARITY_CASES entry of the compiler's program modules (the
    paged decode and chunked prefill, fp and quantized, kernels/mla.py's
    FlashMLA, paged MLA decode and MLA chunked prefill, the SSD's chunk_state
    and chunk_scan and the dequantized GEMM's int4, int8, int2 and nf4 (its
    codebook lookup a T.call_tile_lib rewritten into T ops) among them), in
    fp32, and the GEMM's and flash forward's in bf16 (they take wmma for
    their 16-bit GEMMs)."""
    from repro_torch import kernels as K

    out = [(name, "float32", prog) for name, prog in K.parity_programs()]
    out += [(name + " bf16", "bfloat16", K.matmul_program(**cfg, in_dtype="bfloat16",
                                                          out_dtype="bfloat16"))
            for name, cfg in K.matmul.PARITY_CASES]
    out += [(name + " bf16", "bfloat16", K.flash_attention_program(**cfg, dtype="bfloat16"))
            for name, cfg in K.flash_attention.PARITY_CASES]
    return out


def _case_inputs(name, prog, kern, seed, dev, dtype="float32"):
    """A case's inputs on the card: its module's ``parity_inputs`` where it
    has a hook (valid block tables), else seeded normal values (int8 ones
    over the whole byte: the dequantized GEMM's packed codes)."""
    from repro_torch import kernels as K

    args = K.parity_inputs(name, prog, np.random.default_rng(seed))
    if args is not None:
        return [torch.as_tensor(a, device=dev) for a in args]
    g = torch.Generator(device=dev).manual_seed(seed)
    return [torch.randint(-128, 128, p.shape, generator=g, device=dev, dtype=torch.int8)
            if p.dtype == "int8" else
            torch.randn(p.shape, generator=g, device=dev).to(getattr(torch, dtype))
            for p in kern.arg_params]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(34))
def test_cuda_emitted_kernels_match_the_reference_interpreter(case):
    """On a card: each tile program compiled with ``target="cuda"`` (built
    by nvcc from the emitted text) against the ``reference`` interpreter on
    the card on the same seeded inputs, every output (the prefill's pools
    too): fp32 within 1e-5 of max(1, max |reference|), bf16 within two bf16
    ulps; one launch counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch.core import compile as tl_compile

    cases = _compiled_cases()
    assert len(cases) == 34
    name, dtype, prog = cases[case]
    dev = torch.device("cuda")
    kern = tl_compile(prog, target="cuda", use_cache=False)
    args = _case_inputs(name, prog, kern, case, dev, dtype)
    got = cs.as_outputs(kern(*args))
    want = cs.as_outputs(tl_compile(prog, target="reference")(*args))
    assert kern.launches == 1 and len(got) == len(want)
    assert all(g.dtype == w.dtype and g.device.type == "cuda" for g, w in zip(got, want))
    if dtype == "bfloat16":
        assert cs.bf16_ulps(torch, got[0], want[0]) <= cs.BF16_ULPS, name
    else:
        dead = cs.dead_chunk_page(prog, [a.cpu().numpy() for a in args])
        err = cs.emitted_err(torch, kern, got, want, dead)
        assert err <= 1e-5, (name, err)


def _prefill_case(fmt, dtype="float32"):
    """A chunked-prefill program (fp or its quantized twin) at a small shape
    and inputs on the card with dead chunk pages: slot 0 live over its
    whole chunk, slot 1 live over 5 of 32 tokens (its second page dead),
    slot 2 idle at an unaligned start; page 0 reserved."""
    from repro_torch import kernels as K

    cfg = dict(slots=3, heads=4, kv_heads=2, head_dim=32, chunk=32, page_size=16,
               max_pages=4, num_pages=13, dtype=dtype)
    prog = (K.prefill_attention_program(**cfg) if fmt is None
            else K.prefill_attention_quant_program(**cfg, fmt=fmt))
    dev = torch.device("cuda")
    rng = np.random.default_rng(9)
    tables = torch.as_tensor(_tables(rng, 3, 4, 13), device=dev)
    starts = torch.tensor([0, 32, 37], dtype=torch.int32, device=dev)
    lens = torch.tensor([32, 5, 0], dtype=torch.int32, device=dev)
    g = torch.Generator(device=dev).manual_seed(9)
    rest = []
    for p in [*prog.input_params()[3:], *(p for p in prog.output_params() if p.name != "Output")]:
        if p.dtype == "int8":
            rest.append(torch.randint(-128, 128, p.shape, generator=g, device=dev,
                                      dtype=torch.int8))
        elif p.name.endswith(("Scale", "Scales")):
            rest.append(torch.rand(p.shape, generator=g, device=dev).mul(0.1).add(0.05)
                        .to(getattr(torch, dtype)))
        else:
            rest.append(torch.randn(p.shape, generator=g, device=dev).to(getattr(torch, dtype)))
    return prog, [tables, starts, lens, *rest]


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", [None, "int8"])
def test_cuda_emitted_prefill_keeps_the_pages_no_block_writes(fmt):
    """On a card: the emitted prefill's pools start as copies of the given
    pools, so every page no chunk page of any slot maps to keeps its bytes;
    the given tensors are never written; output and pools match the
    reference interpreter, page 0 (the dead pages' sink) excluded."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch.core import compile as tl_compile

    prog, args = _prefill_case(fmt)
    kern = tl_compile(prog, target="cuda", use_cache=False)
    given = [a.clone() for a in args]
    got = kern(*args)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(args, given))
    want = tl_compile(prog, target="reference")(*args)
    assert cs.emitted_err(torch, kern, got, want, dead=True) <= 1e-5
    names = [p.name for p in kern.arg_params]
    tb, st = args[0].cpu().numpy(), args[1].cpu().numpy()
    max_pages = tb.shape[1]
    touched = {int(tb[b, min(int(st[b]) // 16 + c, max_pages - 1)])
               for b in range(3) for c in range(2)} | {0}
    keep = [pg for pg in range(13) if pg not in touched]
    assert keep
    for p, out in zip(kern.out_params, got):
        if p.name != "Output":
            assert torch.equal(out[:, keep], args[names.index(p.name)][:, keep]), p.name


@pytest.mark.cuda
@pytest.mark.parametrize("program", ["decode", "decode int8", "prefill", "prefill int8"])
def test_cuda_emitted_dead_table_entry_changes_no_output(program):
    """On a card: a table entry past a slot's live pages is read (every
    entry of the pipelined axis is) but masked, so moving it to another
    valid page changes no output byte, page 0 of the pools aside (slot 0's
    fourth entry: the decode's slot 0 holds 20 tokens, the prefill's chunk
    starts at 0 and covers two pages; the new page is slot 2's first, which
    no block writes)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch import kernels as K
    from repro_torch.core import compile as tl_compile

    fmt = "int8" if program.endswith("int8") else None
    if program.startswith("prefill"):
        prog, args = _prefill_case(fmt)
    else:
        cfg = dict(slots=3, heads=4, kv_heads=2, head_dim=32, page_size=16, max_pages=4,
                   num_pages=13)
        prog = (K.paged_attention_program(**cfg) if fmt is None
                else K.paged_attention_quant_program(**cfg, fmt=fmt))
        pprog, pargs = _prefill_case(fmt)  # its tables and pools, lengths of its own
        pools = [a for p, a in zip(pprog.input_params() + pprog.output_params(), pargs)
                 if p.name in ("KPages", "VPages", "KScales", "VScales")]
        q = torch.randn((3, 4, 32), device="cuda")
        args = [pargs[0], torch.tensor([20, 64, 1], dtype=torch.int32, device="cuda"), q,
                *pools]
    kern = tl_compile(prog, target="cuda", use_cache=False)
    before = cs.as_outputs(kern(*args))
    moved = args[0].clone()
    moved[0, 3] = args[0][2, 0]
    after = cs.as_outputs(kern(moved, *args[1:]))
    for p, b, a in zip(kern.out_params, before, after, strict=True):
        if p.name != "Output":  # page 0, the dead pages' sink, in no set order
            b, a = b[:, 1:], a[:, 1:]
        assert torch.equal(b, a), p.name


@pytest.mark.cuda
def test_cuda_emitted_workspace_is_byte_equal_to_shared():
    """On a card: kernels/mla.py's small MLA prefill compiled with a
    shared-memory limit that sends buffers to the per-block global
    workspace (the query tile and, in bf16, ``wmma`` accumulators among
    them) gives outputs byte-equal to the same program all in shared
    memory, in fp32 and bf16 (``chip_smoke.workspace_check``, phase 17's
    check); the workspace is allocated at each launch."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch import kernels as K

    compiled = cs.mla_programs(K)  # text only: a kernel builds at its first call
    res = cs.workspace_check(torch, np, compiled, torch.device("cuda"))
    assert set(res) == {"float32", "bfloat16"}
    for names, ws, smem, all_smem in res.values():
        assert names and ws > 0 and smem <= cs.WORKSPACE_SMEM < all_smem


# small ragged shapes: chunk_scan with 48-row chunks (C.B^T on wmma: 48 x 48
# over N 32), P 40; the dequantized GEMM at M 24 (8-row blocks: the CUDA
# cores) and M 48 (16-row blocks: wmma), K 96 in blocks of 32
RAGGED_EMITTED = {
    "chunk_scan bf16": dict(batch=3, nchunks=2, chunk_l=48, dstate=32, headdim=40,
                            dtype="bfloat16"),
    "dequant int4 M 24": dict(M=24, N=48, K=96, fmt="int4", in_dtype="float16",
                              out_dtype="float16", block_M=8, block_N=16, block_K=32),
    "dequant int4 M 48": dict(M=48, N=48, K=96, fmt="int4", in_dtype="float16",
                              out_dtype="float16", block_M=16, block_N=16, block_K=32),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(RAGGED_EMITTED))
def test_cuda_emitted_ssd_and_dequant_match_plain_versions_at_ragged_shapes(case):
    """On a card: the emitted chunk_scan (bf16) and dequantized GEMM (int4 x
    fp16) at small ragged shapes against their plain versions,
    ``ref.chunk_scan`` within two bf16 ulps and ``ref.dequant_matmul``
    within two ``lib_units`` (chip_smoke's limits); the GEMM's output is
    Ct (N, M), compared transposed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch import kernels as K
    from repro_torch.core import compile as tl_compile

    cfg = RAGGED_EMITTED[case]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(29)
    if case.startswith("chunk_scan"):
        kern = tl_compile(K.chunk_scan_program(**cfg), target="cuda", use_cache=False)
        b, nc, ln, n, p = (cfg[k] for k in ("batch", "nchunks", "chunk_l", "dstate", "headdim"))
        c, bm = (torch.randn((b, nc, ln, n), generator=g, device=dev).to(torch.bfloat16)
                 for _ in range(2))
        x = torch.randn((b, nc, ln, p), generator=g, device=dev).to(torch.bfloat16)
        da = torch.cumsum(-0.1 * torch.rand((b, nc, ln), generator=g, device=dev), dim=-1)
        prev = torch.randn((b, nc, n, p), generator=g, device=dev)
        got, want = kern(c, bm, x, da, prev), ref.chunk_scan(c, bm, x, da, prev)
        assert got.dtype == want.dtype and torch.isfinite(got).all()
        assert cs.bf16_ulps(torch, got, want) <= cs.BF16_ULPS
    else:
        kern = tl_compile(K.dequant_matmul_program(**cfg), target="cuda", use_cache=False)
        m, n, k = cfg["M"], cfg["N"], cfg["K"]
        a = torch.randn((m, k), generator=g, device=dev).to(torch.float16)
        bq = torch.randint(-128, 128, (n, k // 2), generator=g, device=dev, dtype=torch.int8)
        got = kern(a, bq).t()
        want = ref.dequant_matmul(a, bq, "int4", out_dtype=torch.float16)
        sigma = k ** 0.5 * cs.rms(torch, a) * cs.rms(torch, ref.dequant_weight(bq, "int4"))
        assert cs.lib_units(torch, got, want, sigma) <= cs.BF16_ULPS
        assert ("nvcuda::wmma::mma_sync" in kern.source) == (cfg["block_M"] == 16)
    assert kern.launches == 1


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(cs.TILE_LANGUAGE))
def test_cuda_emitted_tile_language_matches_the_reference_interpreter(name):
    """On a card: the T language's last ops (chip_smoke's TILE_LANGUAGE:
    atomics from 64 blocks into one tile, scans along either axis, two
    tile-library functions rewritten into T ops, a batched bf16 GEMM on
    wmma) against the reference interpreter on the card, within 1e-5 of
    max(1, max |reference|); an atomic's in-out tensor is a copy, the
    caller's unwritten."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch.core import compile as tl_compile

    dev = torch.device("cuda")
    prog = cs.tile_language_programs()[name]
    kern = tl_compile(prog, target="cuda", use_cache=False)
    args = cs.tile_language_inputs(torch, kern, dev)
    keep = [a.clone() for a in args]
    got = kern(*args)
    want = tl_compile(prog, target="reference")(*args)
    assert kern.launches == 1 and all(torch.equal(a, k) for a, k in zip(args, keep))
    assert cs.emitted_err(torch, kern, got, want, False) <= 1e-5, name


@pytest.mark.cuda
def test_cuda_emitted_batched_gemm_on_the_cuda_cores_broadcasts_b():
    """On a card: an fp32 batched T.gemm (the CUDA cores) with B shared by
    the batches, against the reference interpreter and torch.matmul."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch.core import compile as tl_compile
    from repro_torch.core import lang as T

    @T.prim_func
    def BatchedGemm(A: T.Tensor((2, 4, 32, 16), "float32"), B: T.Tensor((16, 48), "float32"),
                    C: T.Tensor((2, 4, 32, 48), "float32")):
        with T.Kernel(2) as bx:
            a = T.alloc_shared((4, 32, 16), "float32")
            b = T.alloc_shared((16, 48), "float32")
            c = T.alloc_fragment((4, 32, 48), "float32")
            T.copy(A[bx, 0, 0, 0], a)
            T.copy(B[0, 0], b)
            T.clear(c)
            T.gemm(a, b, c)
            T.copy(c, C[bx, 0, 0, 0])

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(5)
    a = torch.randn((2, 4, 32, 16), generator=g, device=dev)
    b = torch.randn((16, 48), generator=g, device=dev)
    kern = tl_compile(BatchedGemm, target="cuda", use_cache=False)
    got = kern(a, b)
    assert "wmma" not in kern.source
    torch.testing.assert_close(got, tl_compile(BatchedGemm, target="reference")(a, b),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(got, torch.matmul(a, b), rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_cuda_custom_kernel_example_and_tune_matmul():
    """On a card: examples/torch_custom_kernel.py through its main (the
    autotuner's winner compiled for the card, within its limit of its
    oracle), and tune_matmul at a small shape against the plain GEMM."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch.kernels import tune_matmul

    res = cs.example_module("torch_custom_kernel").main([])
    assert res["kernel"].backend == "cuda" and res["kernel"].launches >= 1
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    a = torch.randn((256, 512), generator=g, device=dev).to(torch.bfloat16)
    b = torch.randn((512, 384), generator=g, device=dev).to(torch.bfloat16)
    kern, winner = tune_matmul(256, 384, 512, "bfloat16", "bfloat16")
    out = kern(a, b)
    sigma = 512 ** 0.5 * cs.rms(torch, a) * cs.rms(torch, b)
    assert winner.feasible
    assert cs.lib_units(torch, out, ref.matmul(a, b, torch.bfloat16), sigma) <= cs.BF16_ULPS


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "int32"])
@pytest.mark.parametrize("kind", ["add", "max", "min"])
def test_cuda_emitted_atomics_of_each_type(dtype, kind):
    """On a card: T.atomic_add / _max / _min into a bf16, fp16 or int32
    tensor (the 16-bit types' own atomicAdd and a 16-bit compare-and-swap;
    int32's atomicAdd / atomicMax / atomicMin) from 8 blocks, on small
    integers, so every order of the sums is exact: equal to the reference
    interpreter."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the emitted kernels have no CPU mode)")
    from repro_torch.core import compile as tl_compile
    from repro_torch.core import lang as T

    update = getattr(T, f"atomic_{kind}")

    @T.prim_func
    def Atomic(X: T.Tensor((8, 16, 64), dtype), O: T.Tensor((16, 64), dtype)):
        with T.Kernel(8) as bx:
            xs = T.alloc_shared((16, 64), dtype)
            T.copy(X[bx, 0, 0], xs)
            update(O[0, 0], xs)

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(3)
    x, o = (torch.randint(-8, 8, shape, generator=g, device=dev).to(getattr(torch, dtype))
            for shape in ((8, 16, 64), (16, 64)))
    kern = tl_compile(Atomic, target="cuda", use_cache=False)
    assert ("tl_atomic_ext" in kern.source) == (kind != "add" and dtype != "int32")
    assert torch.equal(kern(x, o), tl_compile(Atomic, target="reference")(x, o))
