"""The tensor-core paths of the flash-attention forward and the
chunked-prefill kernel, on the CPU.

* The bf16 limit (chip_smoke.py: every element within 2 bf16 ulps of the
  plain value) sees the shortcut the tensor-core kernels avoid: an
  fp32-accumulating online softmax over 64-key tiles passes it with fp32
  probabilities and with the kernels' bf16 pair p = hi + lo, and fails it
  with P rounded once to bf16.  The plain value is the port's
  ``ref.attention``, itself within one bf16 ulp of the JAX package's XLA
  oracle on the same inputs.
* The wrappers pick the tensor-core path from dtype and shape alone: bf16
  at qwen2-1.5B's serving and training shapes takes it, fp32 does not.
* On the card path (a CUDA tensor) the wrappers hand the kernel the
  transposed views the model's layers pass, with no copy, and count the
  tensor-core launches: here the kernel call is replaced by a recorder,
  since this machine has no card.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import math
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import prefill_attention as PF
from repro_torch.kernels import ref

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def cs():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    return chip_smoke


def pair_softmax(q, k, v, mask, scale, tile=64):
    """The tensor-core kernels' arithmetic in plain PyTorch: fp32 scores of
    the bf16 inputs scaled into the log2 domain, exp2, the running max
    clamped at NEG_CLAMP, and P.V as two products of the pair hi = bf16(p),
    lo = bf16(p - hi), accumulated in fp32; the output rounded once."""
    s_all = (q.float() @ k.float().transpose(-1, -2)) * (scale * math.log2(math.e))
    s_all = s_all.masked_fill(~mask, float("-inf"))
    m = torch.full(q.shape[:-1] + (1,), float("-inf"))
    l = torch.zeros(q.shape[:-1] + (1,))
    acc = torch.zeros(q.shape[:-1] + v.shape[-1:])
    clamp = -2.0 ** 20
    for t in range(0, k.shape[-2], tile):
        sc = s_all[..., t:t + tile]
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        mc = m_new.clamp_min(clamp)
        alpha, p = torch.exp2(m.clamp_min(clamp) - mc), torch.exp2(sc - mc)
        hi = p.bfloat16().float()
        lo = (p - hi).bfloat16().float()
        vt = v[..., t:t + tile, :].float()
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + hi @ vt + lo @ vt
        m = m_new
    return (acc / l.clamp_min(1e-30)).to(q.dtype)


def test_bf16_limit_rejects_p_rounded_once_and_passes_the_hi_lo_pair(cs):
    """B 1, H 4, S 512, D 128, causal, bf16 inputs: P in fp32 and P as the
    pair read within the limit, P rounded once to bf16 far outside it."""
    rng = np.random.default_rng(17)
    b, h, s, d = 1, 4, 512, 128
    q, k, v = (rng.standard_normal((b, h, s, d), dtype=np.float32) for _ in range(3))
    qt, kt, vt = (torch.as_tensor(x).bfloat16() for x in (q, k, v))
    plain = ref.attention(qt, kt, vt, causal=True)
    # the plain version against the JAX package's oracle on the same values
    want = jref.attention(*(t.float().numpy() for t in (qt, kt, vt)), causal=True)
    assert cs.bf16_ulps(torch, plain, torch.as_tensor(np.array(want))) <= 1.0
    mask = torch.ones(s, s, dtype=torch.bool).tril()[None, None]
    controls = cs.accumulation_controls(torch, qt, kt, vt, mask, plain, scale=d ** -0.5)
    pair = cs.bf16_ulps(torch, pair_softmax(qt, kt, vt, mask, d ** -0.5), plain)
    assert controls["fp32_acc_ulps"] <= cs.BF16_ULPS and pair <= cs.BF16_ULPS
    assert controls["bf16_p_ulps"] > cs.BF16_ULPS and controls["bf16_acc_ulps"] > cs.BF16_ULPS
    r = {"ulps": pair, **controls}
    assert cs.kernel_ok(r)
    assert not cs.kernel_ok({**r, "bf16_p_ulps": cs.BF16_ULPS})  # the gate reads it


def test_tensor_core_path_rule_at_qwen_shapes():
    """bf16 at qwen2-1.5B's shapes (both packages' config: head dim 128, 12
    heads over 2; serving pages of 16) takes the tensor-core path in both
    kernels; fp32 and a head dim the kernels are not built for take the
    CUDA-core path.  A page's GQA rows past 128 (pages of 32 x a group of
    6) stay on the tensor cores, split over two blocks of three heads."""
    cfg, jcfg = get_config("qwen2_1_5b"), jconfigs.get_config("qwen2_1_5b")
    d, group = cfg.head_dim, cfg.num_heads // cfg.num_kv_heads
    assert (d, group) == (jcfg.head_dim, jcfg.num_heads // jcfg.num_kv_heads) == (128, 6)
    assert FA.tensor_core_path(torch.bfloat16, d)
    assert FA.tensor_core_path(torch.bfloat16, 64)
    assert PF.tensor_core_path(torch.bfloat16, d, 16, group, 1024 // 16, 64)
    assert PF.tensor_core_path(torch.bfloat16, 64, 8, 5, PF.TC_MAX_PAGES, 64)
    assert not FA.tensor_core_path(torch.float32, d)
    assert not FA.tensor_core_path(torch.bfloat16, 96)
    assert not PF.tensor_core_path(torch.float32, d, 16, group, 64, 64)
    assert PF.tensor_core_path(torch.bfloat16, d, 32, group, 32, 64)  # 192 rows: split
    assert PF.head_split(True, group, 32, d) == 2
    assert PF.head_split(True, group, 16, d) == 1
    assert not PF.tensor_core_path(torch.bfloat16, d, 16, group, PF.TC_MAX_PAGES + 1, 64)


# ---------------------------------------------------------------------------
# the card path, with the kernel call recorded
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's: it sends a
    wrapper down its kernel path."""

    @property
    def is_cuda(self):
        return True


def _card(t):
    return t.as_subclass(_OnCard)


@pytest.fixture
def card_path(monkeypatch):
    """Replace the two kernels' C entry points by recorders, the CUDA
    stream by a stand-in, and the plain versions by a failure: returns the
    recorded calls by kernel name."""
    calls = {}
    for name, mod in (("flash_attention", FA), ("prefill_attention", PF)):
        def fn(*args, _name=name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(mod.KERNEL, "function", lambda _fn=fn: _fn)
        monkeypatch.setattr(mod.KERNEL, "launches", 0)
        monkeypatch.setattr(mod.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("attention", "paged_prefill_attention"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


def test_flash_card_path_takes_tensor_cores_for_bf16_views(card_path):
    """qwen2-1.5B's training forward hands the (B, H, S, D) views of (B, S,
    H, D) projections: bf16 goes to the tensor-core kernel with their
    strides (no copy) and an output in the same layout; fp32 goes to the
    CUDA-core kernel."""
    b, s, hq, hkv, d = 2, 96, 12, 2, 128
    for dtype in (torch.bfloat16, torch.float32):
        q = _card(torch.randn(b, s, hq, d).to(dtype)).transpose(1, 2)
        k = _card(torch.randn(b, s, hkv, d).to(dtype)).transpose(1, 2)
        v = _card(torch.randn(b, s, hkv, d).to(dtype)).transpose(1, 2)
        out = FA.flash_attention(q, k, v, causal=True)
        call = card_path["flash_attention"][-1]
        assert out.shape == q.shape and out.stride() == q.stride()
        assert call[2:5] == (q.data_ptr(), k.data_ptr(), v.data_ptr())
        assert call[6:18] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *out.stride()[:3])
        assert call[18:25] == (b, hq, hkv, s, s, d, 1)
        assert call[:2] == ((1, 1) if dtype == torch.bfloat16 else (0, 0))
    assert (FA.KERNEL.launches, FA.KERNEL.tc_launches) == (2, 1)


def test_prefill_card_path_reads_and_writes_the_layer_layout(card_path):
    """The prefill layer hands q (B, Hq, C, D) as a view of (B, C, Hq, D):
    at qwen2-1.5B's serving shapes in bf16 the tensor-core kernel reads it
    and writes the output through their strides (no packing copy either
    way); fp32 packs q chunk-major with its GQA group for the CUDA-core
    kernel and unpacks the output."""
    b, c, hq, hkv, d, ps, mp = 2, 64, 12, 2, 128, 16, 8
    num_pages = b * mp + 1
    tables = _card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    starts = _card(torch.tensor([0, 32], dtype=torch.int32))
    lens = _card(torch.tensor([64, 20], dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float32):
        q = _card(torch.randn(b, c, hq, d).to(dtype)).transpose(1, 2)
        kn = _card(torch.randn(b, hkv, c, d).to(dtype))
        vn = _card(torch.randn(b, hkv, c, d).to(dtype))
        kp = _card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype))
        vp = _card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype))
        out, k_pages, v_pages = PF.prefill_attention(q, kn, vn, kp, vp, tables, starts, lens)
        call = card_path["prefill_attention"][-1]
        assert k_pages is kp and v_pages is vp and out.shape == q.shape
        assert call[11:17] == ((*q.stride()[:3], *out.stride()[:3])
                               if dtype == torch.bfloat16 else (0,) * 6)
        assert call[17:23] == (b, hkv, hq // hkv, c, d, ps)
        if dtype == torch.bfloat16:
            assert call[:3] == (1, 1, q.data_ptr()) and out.stride() == q.stride()
        else:
            assert call[:2] == (0, 0) and call[2] != q.data_ptr()  # the packed copy
    assert (PF.KERNEL.launches, PF.KERNEL.tc_launches) == (2, 1)
