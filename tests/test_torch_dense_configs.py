"""The three dense configs the port had never run (gemma-7b, chatglm3-6b,
deepseek-7b), at their own head structure, held against the JAX package on
the CPU: teacher-forced logits of the full forward, the chunked prefill and
the paged decode, the loss and every gradient, and the serving engine's
token streams and schedule.

``reduced()`` shrinks all three to 4 query heads over 2 at head dim 16, which
exercises none of their features, so each keeps its own head structure at
small width (``dataclasses.replace`` on both packages' reduced config):

* gemma-7b: MHA at head dim 256 (4 over 4), GeGLU, tied embeddings;
* chatglm3-6b: a GQA group of 16 (16 query heads over 1), QKV bias, RoPE
  over half the head dim;
* deepseek-7b: MHA (4 over 4).

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; tokens, positions,
tables and lengths are the same numpy arrays on both sides.  Tolerances:
logits at atol / rtol 1e-4, gradients at 1e-4 of each leaf's largest
element (fp32 both sides, differing in the order of sums).  Engine streams,
ticks and TTFT ticks are equal exactly; the embedding is scaled by 0.1 in
both packages' parameters for those, so greedy streams vary.

The last test rehearses ``chip_smoke.py``'s phase 11 with CPU tensors.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
EMBED_SCALE = 0.1
# each config's own head structure at small width: (heads, kv heads, head dim)
HEADS = {"gemma_7b": (4, 4, 256), "chatglm3_6b": (16, 1, 16), "deepseek_7b": (4, 4, 16)}
ARCHS = tuple(HEADS)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Small ops on reduced models: one intra-op thread runs them as fast
    and keeps them steady on a loaded machine (as the other model test
    modules); restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _shaped(cfg, arch):
    hq, hkv, d = HEADS[arch]
    return dataclasses.replace(cfg.reduced(), num_heads=hq, num_kv_heads=hkv, head_dim=d)


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(reference config, port config, reference params, port params) of one
    config at its own head structure."""
    arch = request.param
    jcfg = _shaped(jconfigs.get_config(arch), arch)
    cfg = _shaped(tconfigs.get_config(arch), arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jparams = jlm.init(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    return jcfg, cfg, jparams, params


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


def test_the_features_each_config_keeps(model):
    """The head structure kept, and each config's own feature: gemma's
    GeGLU and tied embeddings, chatglm's QKV bias and half-dim RoPE,
    deepseek-7b's untied MHA."""
    _, cfg, _, params = model
    group = cfg.num_heads // cfg.num_kv_heads
    wq = params["layers"]["attn"]["wq"]
    assert wq.shape[-1] == cfg.num_heads * cfg.head_dim
    if "gemma" in cfg.name:
        assert (cfg.head_dim, group, cfg.tie_embeddings) == (256, 1, True)
    elif "chatglm" in cfg.name:
        assert (group, cfg.qkv_bias, lm.rope_fraction(cfg)) == (16, True, 0.5)
    else:
        assert (group, cfg.tie_embeddings, lm.rope_fraction(cfg)) == (1, False, 1.0)


def test_forward_logits_match_reference(model):
    jcfg, cfg, jparams, params = model
    tokens = np.random.default_rng(0).integers(0, 256, size=(2, 24)).astype(np.int32)
    want, _ = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    got, _ = lm.forward(params, cfg, _t(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_every_gradient_match_reference(model):
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    labels = rng.integers(0, 256, size=(2, 24)).astype(np.int32)
    labels[0, :3] = -1

    def jloss(p):
        return jlm.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels))

    (jv, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    flat = _flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, _t(tokens), _t(labels))
    grads = torch.autograd.grad(loss, list(flat.values()))
    for t in flat.values():
        t.requires_grad_(False)
    np.testing.assert_allclose(loss.item(), float(jv), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(flat)
    for key, g in zip(flat, grads):
        want = jflat[key]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


def test_chunked_prefill_and_paged_decode_logits_match_reference(model):
    """Two prefill chunks (a partial one, an idle slot), then decode steps,
    through the paged cache of both packages; the pools agree but for the
    sink page 0."""
    jcfg, cfg, jparams, params = model
    rng = np.random.default_rng(2)
    b, max_len, ps, chunk = 3, 64, 16, 16
    cj = jlm.init_cache(jcfg, b, max_len, layout="paged", page_size=ps, num_blocks=13)
    ct = lm.init_cache(cfg, b, max_len, page_size=ps, num_blocks=13, device="cpu")
    tables = np.zeros((b, 4), np.int32)
    perm = rng.permutation(12)[:9] + 1
    tables[0, :4], tables[1, :3], tables[2, :2] = perm[:4], perm[4:7], perm[7:9]
    cj = cj.with_tables(jnp.asarray(tables))
    ct = ct.with_tables(torch.as_tensor(tables))
    prefill_j = jax.jit(lambda p, c, t, s, n: jlm.prefill_step(p, jcfg, c, t, s, n))
    decode_j = jax.jit(lambda p, c, t, s: jlm.decode_step(p, jcfg, c, t, s))
    for pos, lens in (([0, 0, 0], [16, 16, 9]), ([16, 16, 9], [16, 11, 0])):
        toks = rng.integers(0, cfg.vocab_size, size=(b, chunk)).astype(np.int32)
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        lj, cj = prefill_j(jparams, cj, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(lens))
        lt, ct = lm.prefill_step(params, cfg, ct, _t(toks), _t(pos), _t(lens))
        live = lens > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live], **TOL)
    pos = np.array([32, 27, 9], np.int32)
    for _ in range(4):
        tok = rng.integers(0, cfg.vocab_size, size=b).astype(np.int32)
        lj, cj = decode_j(jparams, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = lm.decode_step(params, cfg, ct, _t(tok), _t(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        pos = pos + 1
    kj = cj.rest["kv"]["k_pages"] if cj.stacked else np.stack(
        [c["kv"]["k_pages"] for c in cj.rest])
    np.testing.assert_allclose(ct.kv["k_pages"].numpy()[:, :, 1:],
                               np.asarray(kj)[:, :, 1:], **TOL)


def _diverse(model):
    """Both packages' parameters with the embedding scaled by EMBED_SCALE."""
    jcfg, cfg, jparams, params = model
    jparams = dict(jparams)
    jparams["embed"] = {k: v * EMBED_SCALE if k == "embedding" else v
                        for k, v in jparams["embed"].items()}
    params = dict(params)
    params["embed"] = {k: v * EMBED_SCALE if k == "embedding" else v
                       for k, v in params["embed"].items()}
    return jcfg, cfg, jparams, params


def _run(cfg, params, prompts, engine_cls=ServingEngine, scfg_cls=ServeConfig, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**kw), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


@pytest.mark.parametrize("sync", [1, 4])
def test_engine_streams_and_schedule_match_reference(model, sync):
    """Five prompts (two sharing a page) over two slots, chunked prefill of
    16, the prefix cache: token streams, ticks, TTFT ticks, shared pages and
    windows equal the reference engine's."""
    jcfg, cfg, jparams, params = _diverse(model)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, size=int(n)).tolist() for n in (21, 7, 30, 12, 5)]
    prompts[3] = prompts[0][:16] + prompts[3]
    kw = dict(slots=2, max_len=64, max_new_tokens=6, page_size=16, sync_every=sync)
    out, rq, ours = _run(cfg, params, prompts, **kw)
    jout, rj, theirs = _run(jcfg, jparams, prompts, JServingEngine, JServeConfig, **kw)
    assert out == jout and any(len(set(o)) > 1 for o in out)
    assert ours.steps_run == theirs.steps_run
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert ours.pages_shared == theirs.pages_shared > 0
    assert ours.decode_windows == theirs.decode_windows
    assert (ours.decode_windows > 0) == (sync > 1)


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's: it sends a
    kernel wrapper down its launch path (whose C call is recorded)."""

    @property
    def is_cuda(self):
        return True


def test_prefill_splits_chatglm_rows_over_blocks(monkeypatch):
    """chatglm3-6b's group of 16 at page 16 is 256 query rows a page: the
    chunked prefill's launch splits them over two blocks of 8 heads
    (``head_split``, the C call's last argument), on the tensor cores in
    bf16 and on the CUDA cores in fp32, whose packing puts block part p's
    heads h * 16 + p * 8 + g in rows i * 8 + g of q's (B, Hkv * 2, C * 8, D)
    view and back; a page of one head that does not fit a block's shared
    memory raises a ValueError naming the bytes before any C call."""
    import contextlib
    import types

    from repro_torch.kernels import prefill_attention as PF

    full = tconfigs.get_config("chatglm3_6b")
    group = full.num_heads // full.num_kv_heads
    assert (group, full.head_dim) == (16, 128)
    assert PF.tensor_core_path(torch.bfloat16, 128, 16, group, 64, 64)
    assert PF.head_split(True, group, 16, 128) == 2
    assert PF.core_smem_bytes(256, 16, 128) == 302336 > PF.MAX_SMEM
    assert PF.head_split(False, group, 16, 128) == 2  # 159,488 bytes a block
    calls = []
    monkeypatch.setattr(PF.KERNEL, "function", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    b, hkv, chunk, d, ps, mp = 2, 2, 32, 128, 16, 4
    num_pages = b * mp + 1
    card = lambda t: t.as_subclass(_OnCard)  # noqa: E731
    tables = card(torch.arange(1, num_pages, dtype=torch.int32).reshape(b, mp))
    starts = card(torch.tensor([0, 16], dtype=torch.int32))
    lens = card(torch.tensor([32, 7], dtype=torch.int32))
    for dtype in (torch.bfloat16, torch.float32):
        q = card(torch.randn(b, hkv * group, chunk, d).to(dtype))
        kn, vn = (card(torch.randn(b, hkv, chunk, d).to(dtype)) for _ in range(2))
        kp, vp = (card(torch.zeros(hkv, num_pages, ps, d, dtype=dtype)) for _ in range(2))
        PF.prefill_attention(q, kn, vn, kp, vp, tables, starts, lens)
        assert calls[-1][1] == int(dtype == torch.bfloat16) and calls[-1][-1] == 2
        assert calls[-1][17:20] == (b, hkv, group)
    q = torch.randn(b, hkv * group, chunk, d)
    packed = PF.packed_queries(q, hkv, 2, tc=False)
    assert packed.shape == (b, hkv, 2, chunk, 8, d)
    h, p, i, g = 1, 1, 5, 3
    assert torch.equal(packed[0, h, p, i, g], q[0, h * group + p * 8 + g, i])
    assert torch.equal(PF.unpacked_output(packed, q.shape, hkv, 2, tc=False), q)
    n = len(calls)
    with pytest.raises(ValueError, match="267648 bytes"):
        PF.head_split(False, 1, 32, 512)
    q = card(torch.randn(1, 1, 32, 512))
    kv = card(torch.randn(1, 1, 32, 512))
    pools = card(torch.zeros(1, 3, 32, 512))
    with pytest.raises(ValueError, match="bytes of shared memory"):
        PF.prefill_attention(q, kv, kv, pools, pools.clone(),
                             card(torch.tensor([[1, 2]], dtype=torch.int32)),
                             card(torch.tensor([0], dtype=torch.int32)),
                             card(torch.tensor([32], dtype=torch.int32)))
    assert len(calls) == n


def test_chip_smoke_dense_phase_rehearses_on_the_cpu():
    """chip_smoke.py's phase 11 with CPU tensors, on each config at its own
    head structure at reduced width: the serving run (no kernel launched
    here) at the scheduler's ticks and TTFT, and the teacher-forced check
    within its limits; its shapes are the configs' full-width heads."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for arch in ARCHS:
        full, shape = tconfigs.get_config(arch), cs.DENSE_SHAPES[arch]
        assert (shape.hq, shape.hkv, shape.d) == (full.num_heads, full.num_kv_heads,
                                                 full.head_dim)
    configs = [_shaped(tconfigs.get_config(a), a) for a in ARCHS]
    launches = cs.dense_phase(torch, np, lm, torch.device("cpu"), configs=configs,
                              requests=2)
    assert set(launches) == {c.name for c in configs}
    assert all(n == 0 for run in launches.values() for n in run.values())
