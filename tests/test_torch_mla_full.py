"""The port's full-sequence MLA and deepseek-v2-lite's training path, held
against the JAX package on the CPU: ``layers.mla_full`` (the latent expanded
into per-head keys of nope + rope columns and narrower values, causal
attention, the output projection), the forward's logits and MoE auxiliary
loss through the dense prefix layer and an MoE layer, the loss and every
gradient; ``FlashAttentionFn`` with values narrower than the keys on the
CPU's plain route; and the flash wrapper's contract at (Dk, Dv) pairs.

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; every other input is a
numpy array made from a seed and handed to both sides.  Reduced
``deepseek_v2_lite_16b``: fp32, 2 layers (the dense prefix layer, then 4
experts top-2 of width 32 beside one shared), d 64, 4 heads, latent rank
32, keys 16 nope + 8 rope = 24 wide, values 16, vocab 256.  The reference
reaches ``mla_full``'s attention through ``ref.attention`` (reduced configs
take ``kernel_backend="xla"``: its Pallas program has one head_dim for Q,
K, V and the output).

Tolerances: ``mla_full`` at 1e-5 (fp32 through four projections, a norm
and the attention; the sides differ in the order of fp32 sums); logits, the
aux loss, the loss and every gradient leaf at 1e-4 (of the leaf's largest
element for gradients: fp32 through two layers and their backward, as
tests/test_torch_granite.py); the plain route of ``FlashAttentionFn``
against autograd of ``ref.attention`` exactly, and against the reference's
``ref.attention`` at 1e-5.
"""
import contextlib
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ref as jref
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ref
from repro_torch.models import layers as L
from repro_torch.models import lm

ARCH = "deepseek_v2_lite_16b"
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the module's many small ops (as
    tests/test_torch_hybrid.py); restored for the modules that follow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _flat(tree, path=()):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, path + (str(i),)).items()}
    return {"/".join(path): tree}


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = tconfigs.get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


def test_reduced_widths_differ():
    """The reduced config keeps MLA's shape: keys wider than values, the
    reference on its XLA route, one dense prefix layer before the MoE."""
    cfg = tconfigs.get_config(ARCH).reduced()
    m = cfg.mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (24, 16)
    assert jconfigs.get_config(ARCH).reduced().kernel_backend == "xla"
    assert lm.num_prefix_layers(cfg) == 1 and cfg.num_layers == 2


@pytest.mark.parametrize("layer", ["prefix", "stacked"])
@pytest.mark.parametrize("seq", [24, 7])
def test_mla_full_matches_reference(model, layer, seq):
    """One layer's ``mla_full`` on seeded activations: the dense prefix
    layer's attention and the MoE layer's, at a sequence of 24 and a ragged
    7."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    if layer == "prefix":
        jp, p = jparams["prefix_layers"][0]["attn"], params["prefix_layers"][0]["attn"]
    else:
        jp = jax.tree.map(lambda a: a[0], jparams["layers"]["attn"])
        p = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = np.random.default_rng(seq).standard_normal((2, seq, cfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(seq, dtype=np.int32), (2, seq))
    want = jL.mla_full(jp, jnp.asarray(x), jcfg, jnp.asarray(pos))
    got = L.mla_full(p, _t(x), cfg, _t(pos.copy()))
    assert got.shape == (2, seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER_TOL)


def test_forward_logits_and_aux_match_reference(model):
    """Batch 2 x 24 through the dense prefix layer and the MoE layer: the
    logits and the load-balance loss."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, _ = _batch(0)
    want, jaux = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    got, aux = lm.forward(params, cfg, _t(tokens))
    assert got.shape == (2, 24, cfg.vocab_size) and float(aux) > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_aux_and_every_gradient_match_reference(model, logits_chunk):
    """``ce + aux`` and its gradient with respect to every leaf: the MLA
    projections and latent norm of both layers, the dense prefix MLP, the
    router, experts and shared expert, the untied unembedding; with the
    per-layer recompute, and streamed logits too."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, labels = _batch(1)

    def jloss(p):
        return jlm.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           remat=True, logits_chunk=logits_chunk)

    (jv, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    flat = _flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, parts = lm.loss_fn(params, cfg, _t(tokens), _t(labels), remat=True,
                             logits_chunk=logits_chunk)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jv), **TOL)
    for name in ("ce", "aux"):
        np.testing.assert_allclose(parts[name].item(), float(jparts[name]), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(flat)
    assert {"prefix_layers/0/attn/w_uk", "prefix_layers/0/mlp/w_down",
            "layers/attn/w_uv", "layers/attn/kv_norm", "layers/moe/router",
            "layers/moe/shared/w_up", "embed/unembed"} <= set(flat)
    for key, g in zip(flat, grads):
        want = jflat[key]
        assert np.abs(want).max() > 0, key
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# the flash kernel's wrapper at values narrower than keys
# ---------------------------------------------------------------------------

# (B, Hq, Hkv, Sq, Sk, Dk, Dv, causal): deepseek's reduced heads, a GQA
# group, a suffix of queries, and full width's 192 over 128
NARROW_V = [(2, 4, 4, 24, 24, 24, 16, True), (2, 4, 2, 10, 30, 24, 16, True),
            (1, 2, 1, 9, 9, 16, 24, False), (1, 2, 2, 33, 33, 192, 128, True)]


@pytest.mark.parametrize("case", NARROW_V, ids=[str(c) for c in NARROW_V])
def test_flash_fn_with_narrow_values_takes_the_plain_route_on_the_cpu(case):
    """On CPU tensors ``FlashAttentionFn`` (forward and backward) gives
    autograd's output and gradients of ``ref.attention`` exactly, with
    values Dv wide and the output (B, Hq, Sq, Dv), and the reference's
    ``ref.attention`` at 1e-5; no kernel is launched."""
    b, hq, hkv, sq, sk, dk, dv, causal = case
    rng = np.random.default_rng(sum(case[:7]))
    arrays = [rng.standard_normal(s).astype(np.float32)
              for s in ((b, hq, sq, dk), (b, hkv, sk, dk), (b, hkv, sk, dv), (b, hq, sq, dv))]
    scale = dk ** -0.5
    launches = FA.KERNEL.launches
    outs, grads = [], []
    for fn in (lambda q, k, v: FA.FlashAttentionFn.apply(q, k, v, causal, scale),
               lambda q, k, v: ref.attention(q, k, v, causal=causal, sm_scale=scale)):
        ins = [torch.tensor(a, requires_grad=True) for a in arrays[:3]]
        out = fn(*ins)
        outs.append(out)
        grads.append(torch.autograd.grad(out, ins, torch.as_tensor(arrays[3])))
    assert FA.KERNEL.launches == launches
    assert outs[0].shape == (b, hq, sq, dv)
    assert torch.equal(outs[0], outs[1])
    for a, w in zip(*grads):
        assert torch.equal(a, w)
    want = jref.attention(*(jnp.asarray(a) for a in arrays[:3]), causal=causal, sm_scale=scale)
    np.testing.assert_allclose(outs[0].detach().numpy(), np.asarray(want), **LAYER_TOL)


def test_tensor_core_pairs_and_width_rule():
    """bf16 takes the tensor cores at (64, 64), (128, 128) and MLA's (192,
    128), which deepseek-v2-lite's widths give; any other pair, fp32 and
    values wider than keys take the CUDA cores; a pair neither path takes
    (widths off the 16-byte vector, or a block over the shared memory)
    raises before any CUDA call."""
    m = tconfigs.get_config(ARCH).mla
    assert (m.qk_nope_head_dim + m.qk_rope_head_dim, m.v_head_dim) == (192, 128)
    for dk, dv in ((64, 64), (128, 128), (192, 128)):
        assert FA.tensor_core_path(torch.bfloat16, dk, dv)
        assert not FA.tensor_core_path(torch.float32, dk, dv)
        FA.check_widths(torch.bfloat16, dk, dv)
        FA.check_widths(torch.float32, dk, dv)
    assert FA.tensor_core_path(torch.bfloat16, 128) and FA.TC_HEAD_DIMS == (64, 128)
    for dk, dv in ((128, 192), (192, 192), (256, 256), (96, 96), (192, 64)):
        assert not FA.tensor_core_path(torch.bfloat16, dk, dv)
        FA.check_widths(torch.bfloat16, dk, dv)  # the CUDA cores take it
    for dtype, dk, dv, match in ((torch.bfloat16, 192, 100, "multiples of 8"),
                                 (torch.float32, 24, 18, "multiples of 4"),
                                 (torch.float32, 8192, 64, "exceeds a block's loads"),
                                 (torch.float32, 4096, 4096, "bytes of shared memory")):
        with pytest.raises(ValueError, match=match):
            FA.check_widths(dtype, dk, dv)
    # the rule's shared memory is the kernel's at deepseek's fp32 check:
    # 16-key tiles (192 floats a row), 64 query rows
    assert FA.core_smem_bytes(64, 16, 192, 128) == 108544


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's: it sends the
    wrapper down its kernel path."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def recorded(monkeypatch):
    """The kernel's C entry point replaced by a recorder, the stream by a
    stand-in and the plain version by a failure: returns the calls."""
    calls = []

    def fn(*args):
        calls.append(args)
        return 0
    monkeypatch.setattr(FA.KERNEL, "function", lambda: fn)
    monkeypatch.setattr(FA.KERNEL, "launches", 0)
    monkeypatch.setattr(FA.KERNEL, "tc_launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    monkeypatch.setattr(ref, "attention", no_plain)
    return calls


def test_card_path_passes_both_widths_and_lays_out_the_output(recorded):
    """``mla_full``'s (B, H, S, D) views of its (B, S, H, D) projections
    at deepseek's widths: bf16 goes to the tensor-core kernel with Dk 192
    and Dv 128 beside the causal flag, the output (B, H, S, 128) laid out
    (B, S, H, 128) as q is; fp32 to the CUDA-core kernel; mismatched
    values and an untaken pair raise before any call."""
    b, s, h = 2, 40, 16
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn(b, s, h, d).to(dtype).as_subclass(_OnCard).transpose(1, 2)
                   for d in (192, 192, 128))
        out = FA.flash_attention(q, k, v, causal=True)
        call = recorded[-1]
        assert out.shape == (b, h, s, 128)
        assert out.transpose(1, 2).is_contiguous()
        assert call[:2] == ((1, 1) if dtype == torch.bfloat16 else (0, 0))
        assert call[2:6] == (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
        assert call[6:18] == (*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                              *out.stride()[:3])
        assert call[18:26] == (b, h, h, s, s, 192, 1, 128)
        assert call[26] == pytest.approx(192 ** -0.5)
    assert (FA.KERNEL.launches, FA.KERNEL.tc_launches) == (2, 1)
    q, k = (torch.randn(1, 2, 8, 192).bfloat16().as_subclass(_OnCard) for _ in range(2))
    for v, match in ((torch.randn(1, 2, 9, 128), "shapes"),
                     (torch.randn(1, 1, 8, 128), "shapes"),
                     (torch.randn(1, 2, 8, 100), "multiples of 8")):
        with pytest.raises(ValueError, match=match):
            FA.flash_attention(q, k, v.bfloat16().as_subclass(_OnCard), causal=True)
    assert len(recorded) == 2


# ---------------------------------------------------------------------------
# chip_smoke.py's deepseek flash case and phase 14, rehearsed on the CPU
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_deepseek_flash_case_rehearses_on_the_cpu():
    """Phase 2's deepseek case (16 heads over 16, Dk 192 over Dv 128,
    causal) at a short sequence, bf16 and fp32 on the plain route: its
    widths, its bf16 controls failing, the tensor-core gate's pair."""
    from repro_torch.kernels import ref as tref

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    case = {c[0]: c for c in cs.FLASH_CASES}["deepseek train"]
    assert case[1:6] == (cs.TRAIN_BATCH, 16, 16, cs.TRAIN_SEQ, cs.TRAIN_SEQ) and case[7]
    assert cs.flash_widths(case) == (192, 128) in cs.FLASH_TC_PAIRS
    assert "deepseek train" in cs.FLASH_TIMED
    small = case[:1] + (1,) + case[2:4] + (100, 100) + case[6:]
    r = cs.check_flash(torch, np, tref, FA, torch.bfloat16, small, None, False, cpu)
    assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    r = cs.check_flash(torch, np, tref, FA, torch.float32, small, None, False, cpu)
    assert r["err"] == 0.0 and r["tc_launches"] == 0


def test_chip_smoke_mla_training_phase_rehearses_on_the_cpu():
    """Phase 14 at reduced widths in bf16, with CPU tensors: 8 training
    steps and 2 profiled at batch 2 x seq 128 (the loss falling, no kernel
    launched here), the depth-2 check with every run on the kernel path's
    MoE routing (each planted attention fault failing the attention
    cosine), the depth-2 teacher-forced forward within phase 4's limits on
    replayed routing, and the reduced training CLI through an injected
    failure."""
    cs = _chip_smoke()
    cpu = torch.device("cpu")
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), dtype="bfloat16")
    assert cs.mla_training_phase(torch, np, lm, cpu, full=cfg, layers_=3, ckpt_steps=6,
                                 batch=2, seq=128) == {"flash_attention": 0}
    r = cs.train_card_vs_cpu(torch, np, lm, dataclasses.replace(cfg, num_layers=2), cpu,
                             shared_routing=True)
    faults = {f"fault: {f}" for f in cs.TRAIN_FAULTS}
    assert set(r) == {"card bf16", "card bf16, plain attention", "cpu fp32",
                      "cosines"} | faults
    assert r["card bf16"] == r["card bf16, plain attention"]
    assert {"layers/attn/w_uk", "prefix_layers/0/attn/w_q"} <= set(r["cosines"])
    assert cs.train_card_vs_cpu_ok(r), r
    for label in faults:
        assert "attn grad cosine" in cs.train_limits_failed(r, label), (label, r)
