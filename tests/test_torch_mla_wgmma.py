"""FlashMLA's wgmma path (``repro_torch.kernels.mla``, ``csrc/mla.cu``) on
the CPU.

* The route: ``mla.tensor_core_path`` sends the paper's Fig. 14 shapes in
  bf16 and fp16 and deepseek-v2-lite-16B's 16 heads over one 512-wide
  latent head (both packages' config) to the wgmma kernel, fp32, a latent
  width of 64 and D + Dpe the kernel cannot hold to the CUDA cores.
* The card path (a CUDA tensor), with the kernel's C call replaced by
  ``test_torch_library``'s recorder: each launch hands the kernel its route
  and counts one ``KERNEL.tc_launches`` a wgmma launch; no launch reaches
  the plain version, a refused launch raises, and so does a tensor the
  kernel cannot read.
* A rehearsal of the kernel's walk in plain PyTorch: 32-key tiles, the two
  consumer warpgroups scoring alternate tiles (one fp32 sum over all D +
  Dpe columns) and handing the row max over, each consumer's row sum over
  its own tiles rescaled by every tile's alpha, P as the 16-bit pair hi +
  lo, O in two 256-column halves.  At b 2, h 64, s 200 (a ragged last
  tile), D 512, Dpe 64 it lies within chip_smoke.py's limit (2 bf16 ulps of
  ``ref.mla``, itself within 1 ulp of the JAX package's XLA path); P
  rounded once, a consumer that skips the other's rescale, and a row sum
  of one consumer's tiles all fail it.

The kernel itself runs only on a card (tests/test_torch_cuda.py,
``test_cuda_mla_wgmma_edges``).
"""
import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import mla as MLA
from repro_torch.kernels import ops, ref
from test_torch_library import _card, card_path  # noqa: F401  (the recorder fixture)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


# ---------------------------------------------------------------------------
# the route
# ---------------------------------------------------------------------------


def test_route_takes_the_papers_shapes_and_deepseeks_heads(cs):
    for b, h, hkv, s, d, pe in cs.MLA_SHAPES.values():
        assert (h, hkv, d, pe) == (128, 1, 512, 64)
        for dt in (torch.bfloat16, torch.float16):
            assert MLA.tensor_core_path(dt, d, pe)
    cfg, jcfg = get_config("deepseek_v2_lite_16b"), jconfigs.get_config("deepseek_v2_lite_16b")
    r, pe = cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim
    assert (cfg.num_heads, r, pe) == (jcfg.num_heads, jcfg.mla.kv_lora_rank,
                                      jcfg.mla.qk_rope_head_dim) == (16, 512, 64)
    assert MLA.tensor_core_path(torch.bfloat16, r, pe)
    assert MLA.TC_KEYS == 32 and MLA.TC_RANK == r


@pytest.mark.parametrize("dtype,d,pe", [
    (torch.float32, 512, 64),     # fp32: CUDA cores
    (torch.bfloat16, 64, 32),     # the reference's two-latent-head test width
    (torch.bfloat16, 256, 64),    # a latent width the kernel is not built for
    (torch.bfloat16, 512, 32),    # D + Dpe not a whole number of 64-column boxes
    (torch.float16, 512, 384),    # 896 > TC_MAX_DK: Q and two stages do not fit
], ids=["fp32", "d64", "d256", "pe32", "pe384"])
def test_route_sends_the_rest_to_the_cuda_cores(dtype, d, pe):
    assert not MLA.tensor_core_path(dtype, d, pe)


def test_route_bound_is_the_kernels_shared_memory():
    """TC_MAX_DK is the widest D + Dpe for which Q (64 rows), two stages of
    32 keys, the P pair and the barriers fit a block's 232,448 bytes
    (``wg::Layout::bytes`` in csrc/mla.cu, with 1 KB of room to align); the
    paper's 576 fits four stages."""
    def smem(dk, stages, keys=MLA.TC_KEYS):
        pair = -(-2 * keys // 64) * 8192
        return (64 * dk * 2 + stages * keys * dk * 2 + pair + 8 * (2 * stages + 1)
                + 4 * 4 * 64 + 1024)
    assert smem(MLA.TC_MAX_DK, 2) <= 232448 < smem(MLA.TC_MAX_DK + 64, 2)
    assert smem(576, 4) <= 232448 < smem(576, 5)
    assert MLA.tensor_core_path(torch.bfloat16, 512, MLA.TC_MAX_DK - 512)


# ---------------------------------------------------------------------------
# the card path, with the kernel call recorded
# ---------------------------------------------------------------------------

CARD_CASES = [  # (b, h, hkv, s, d, pe, dtype, wgmma)
    (2, 128, 1, 40, 512, 64, torch.bfloat16, True),   # Fig. 14's heads
    (2, 128, 1, 40, 512, 64, torch.float16, True),
    (3, 16, 1, 33, 512, 64, torch.bfloat16, True),    # deepseek-v2-lite-16B's 16 heads
    (2, 128, 2, 17, 512, 64, torch.bfloat16, True),   # two latent heads
    (2, 32, 2, 40, 64, 32, torch.bfloat16, False),
    (2, 16, 1, 40, 512, 64, torch.float32, False),
]


def _inputs(b, h, hkv, s, d, pe, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn(shape, generator=g).to(dtype)
            for shape in ((b, h, d), (b, h, pe), (b, s, hkv, d), (b, s, hkv, pe))]


def test_card_path_counts_each_wgmma_launch(card_path, monkeypatch):  # noqa: F811
    monkeypatch.setattr(ops.KERNELS["mla"], "tc_launches", 0)
    kern = ops.KERNELS["mla"]
    for i, (b, h, hkv, s, d, pe, dtype, wgmma) in enumerate(CARD_CASES):
        before = kern.launches, kern.tc_launches
        out = ops.mla(*(_card(t) for t in _inputs(b, h, hkv, s, d, pe, dtype)))
        call = card_path["mla"][i]
        assert tuple(out.shape) == (b, h, d) and out.dtype == dtype
        assert call[1] == int(wgmma) and call[7:13] == (b, h, hkv, s, d, pe)
        assert (kern.launches, kern.tc_launches) == (before[0] + 1, before[1] + int(wgmma))
    assert kern.tc_launches == sum(c[-1] for c in CARD_CASES)


def test_card_path_raises_and_never_falls_back(card_path, monkeypatch):  # noqa: F811
    """A launch the kernel refuses raises (nothing retries it elsewhere),
    as does a tensor it cannot read; neither is counted."""
    monkeypatch.setattr(ops.KERNELS["mla"], "tc_launches", 0)
    kern = ops.KERNELS["mla"]
    monkeypatch.setattr(kern, "function", lambda: (lambda *a: 1))  # cudaErrorInvalidValue
    x = [_card(t) for t in _inputs(2, 16, 1, 40, 512, 64, torch.bfloat16)]
    with pytest.raises(RuntimeError, match="CUDA launch failed"):
        ops.mla(*x)
    q = torch.empty(2 * 16 * 512 + 1, dtype=torch.bfloat16)[1:].view(2, 16, 512)
    with pytest.raises(ValueError, match="16-byte aligned"):
        ops.mla(_card(q), *x[1:])
    assert (kern.launches, kern.tc_launches) == (0, 0)


# ---------------------------------------------------------------------------
# the walk, rehearsed
# ---------------------------------------------------------------------------

NEG_CLAMP = -2.0 ** 20
FAULTS = ("p_rounded_once", "reader_skips_rescale", "one_consumers_sum")


def wgmma_walk(q, q_pe, kv, k_pe, keys=MLA.TC_KEYS, fault=None):
    """csrc/mla.cu's wgmma walk in plain PyTorch.  Tile t is scored by
    consumer t % 2: fp32 scores over [latent | rope] in one sum, scaled into
    the log2 domain, keys past the sequence masked; the new row max, alpha
    and P = exp2(S - max) as in attention_core.cuh (NEG_CLAMP); its row sum
    goes to the scorer's own sum.  The other consumer takes the row max
    from the scorer and computes the same alpha from its own previous max.
    Each consumer's O half is rescaled by alpha and takes hi . V + lo . V
    over its 256 columns.  At the end the two row sums meet, and O / max(l,
    1e-30) is rounded once."""
    b, hq, d = q.shape
    pe, s, hkv = q_pe.shape[-1], kv.shape[1], kv.shape[2]
    group, half = hq // hkv, d // 2
    qs = (d + pe) ** -0.5 * math.log2(math.e)
    qf = torch.cat([q, q_pe], -1).float().reshape(b, hkv, group, d + pe)
    kf = torch.cat([kv, k_pe], -1).float().transpose(1, 2)  # (B, Hkv, S, D + Dpe)
    vf = kv.float().transpose(1, 2)
    shape = (b, hkv, group, 1)
    m = [torch.full(shape, -math.inf) for _ in range(2)]
    l = [torch.zeros(shape) for _ in range(2)]
    o = [torch.zeros((b, hkv, group, half)) for _ in range(2)]
    rnd = q.dtype
    for t in range(-(-s // keys)):
        c, r = t % 2, 1 - t % 2  # the scorer, the reader
        k0 = t * keys
        sc = (qf @ kf[:, :, k0:k0 + keys].transpose(-1, -2)) * qs
        sc = sc.masked_fill(torch.arange(sc.shape[-1]) >= s - k0, -math.inf)
        m_cur = torch.maximum(m[c], sc.amax(-1, keepdim=True))
        mc = m_cur.clamp_min(NEG_CLAMP)
        alpha = torch.exp2(m[c].clamp_min(NEG_CLAMP) - mc)
        p = torch.exp2(sc - mc)
        hi = p.to(rnd).float()
        lo = torch.zeros_like(p) if fault == "p_rounded_once" else (p - hi).to(rnd).float()
        l[c] = l[c] * alpha + p.sum(-1, keepdim=True)
        m[c] = m_cur
        # the reader: the scorer's max, its own previous one
        alpha_r = torch.exp2(m[r].clamp_min(NEG_CLAMP) - mc)
        if fault == "reader_skips_rescale":
            alpha_r = torch.ones_like(alpha_r)
        m[r] = m_cur
        l[r] = l[r] * alpha_r
        for w, a in ((c, alpha), (r, alpha_r)):
            v = vf[:, :, k0:k0 + keys, w * half:(w + 1) * half]
            o[w] = o[w] * a + hi @ v + lo @ v
    total = l[0] if fault == "one_consumers_sum" else l[0] + l[1]
    out = torch.cat(o, -1) / total.clamp_min(1e-30)
    return out.reshape(b, hq, d).to(rnd)


@pytest.mark.parametrize("shape", [(2, 64, 1, 200, 512, 64), (1, 128, 2, 97, 512, 64)],
                         ids=["b2_h64_s200", "b1_h128_hkv2_s97"])
def test_walk_meets_the_bf16_limit_and_its_faults_do_not(cs, shape):
    b, h, hkv, s, d, pe = shape
    rng = np.random.default_rng(23)
    x = [torch.as_tensor(rng.standard_normal(sh, dtype=np.float32)).bfloat16()
         for sh in ((b, h, d), (b, h, pe), (b, s, hkv, d), (b, s, hkv, pe))]
    plain = ref.mla(*x)
    # the plain version against the JAX package's XLA path on the same values
    want = np.asarray(jref.mla(*(t.float().numpy() for t in x)))
    assert cs.bf16_ulps(torch, plain, torch.from_numpy(want.copy())) <= 1.0
    got = wgmma_walk(*x)
    assert cs.bf16_ulps(torch, got, plain) <= cs.BF16_ULPS
    for fault in FAULTS:
        assert cs.bf16_ulps(torch, wgmma_walk(*x, fault=fault), plain) > cs.BF16_ULPS, fault


def test_walk_tiles_and_consumers_at_the_edges(cs):
    """One tile (consumer 1 only reads), a tile of one key, and an even
    number of tiles (the last one consumer 1's)."""
    rng = np.random.default_rng(5)
    for s in (1, 33, 64):
        x = [torch.as_tensor(rng.standard_normal(sh, dtype=np.float32)).bfloat16()
             for sh in ((1, 16, 512), (1, 16, 64), (1, s, 1, 512), (1, s, 1, 64))]
        assert cs.bf16_ulps(torch, wgmma_walk(*x), ref.mla(*x)) <= cs.BF16_ULPS, s


# ---------------------------------------------------------------------------
# chip_smoke.py's gate and tile cost
# ---------------------------------------------------------------------------


def _lib_rows(cs, mla_launches=1, ms=(0.15, 0.53)):
    rows = [{"kernel": "matmul", "label": f"M{i} bfloat16", "wgmma_launches": 1}
            for i in range(8)]
    rows += [{"kernel": "mla", "label": label, "wgmma_launches": mla_launches}
             for label in cs.MLA_WGMMA]
    rows += [{"kernel": "mla", "label": "Hkv 2 bfloat16", "wgmma_launches": 0}]
    rows += [{"kernel": "dequant_matmul", "label": f"{shape} {fmt} x {adtype}",
              "wgmma_launches": 1} for shape in cs.DEQUANT_SHAPES for fmt, adtype in cs.DEQUANT_ROWS]
    rows += [{"kernel": "dequant_matmul", "label": label, "wgmma_launches": 0}
             for label in cs.DEQUANT_NO_WGMMA]
    for label, t in zip(("b64_s1024 bfloat16", "b64_s4096 bfloat16"), ms):
        next(r for r in rows if r["label"] == label)["ms"] = t
    return rows


def test_chip_smoke_gates_flashmlas_wgmma_cases(cs):
    assert set(cs.MLA_WGMMA) == {"b64_s1024 bfloat16", "b64_s4096 bfloat16",
                                 "b128_s8192 bfloat16", "Hkv 2 ragged bfloat16",
                                 "16 heads ragged bfloat16"}
    ragged = {label: shape for label, shape, _ in cs.ragged_cases()["mla"]}
    b, h, hkv, s, d, pe = ragged["16 heads ragged"]
    assert (h, hkv, d, pe) == (16, 1, 512, 64) and s % MLA.TC_KEYS
    gemm, mla, _ = cs.wgmma_gate(_lib_rows(cs))
    assert set(mla.values()) == {1} and len(gemm) == 8
    for bad in (0, 2):
        with pytest.raises(AssertionError, match="FlashMLA"):
            cs.wgmma_gate(_lib_rows(cs, mla_launches=bad))
    with pytest.raises(AssertionError, match="FlashMLA"):
        cs.wgmma_gate([r for r in _lib_rows(cs) if r["label"] != "16 heads ragged bfloat16"])


def test_chip_smoke_tile_cost_reads_the_two_b64_launches(cs):
    per, rest, rate = cs.lib_mla_tile_cost(_lib_rows(cs), MLA.TC_KEYS)
    assert per == pytest.approx((0.53 - 0.15) / 96 * 1e3)
    assert rest == pytest.approx(0.15e3 - 32 * per)
    assert rate == pytest.approx(64 * 32 * 2 * 1600 / (per * 1e-6) / 1e12)


# ---------------------------------------------------------------------------
# tools/mla_wgmma_ablation.py's edits
# ---------------------------------------------------------------------------


def test_ablation_edits_match_the_kernel_source():
    """Every variant of the ablation tool applies to csrc/mla.cu as it stands
    (a kernel edit that breaks a pattern makes the tool raise on the card)."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import mla_wgmma_ablation as ab
    finally:
        sys.path.remove(str(ROOT / "tools"))
    from repro_torch.kernels.build import CSRC
    src = (CSRC / "mla.cu").read_text()
    for name, (_, edits) in ab.VARIANTS.items():
        text = ab.edited(src, name, edits)
        assert text != src, name
    assert "launch_wgmma<CT, 48, 2>" in ab.edited(src, "48 x 2", ab.VARIANTS["48 x 2"][1])
    with pytest.raises(RuntimeError, match="no longer matches"):
        ab.edited(src.replace(ab.LOADS, ""), "walk only", ab.VARIANTS["walk only"][1])
