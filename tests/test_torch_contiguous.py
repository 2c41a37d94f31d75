"""The port's contiguous attention cache, held against the JAX package on the
CPU: the per-slot strips of ``models.layers`` (``attention_decode`` and
``attention_prefill`` over plain and ring strips, with a soft cap and with
RoPE over half the head dim; ``mla_decode`` and ``mla_prefill`` over the
latent strips) against the reference's functions at 1e-5 on numpy-seeded
inputs, outputs and written strips alike; ``lm.init_cache(layout=
"contiguous")``'s bytes; and the engine over the strips: the reference's six
attention variants (tests/test_serving.py:652-682) where the port's
contiguous streams equal its paged ones and the reference's contiguous
ones, the four MLA layout x prefill combinations (:690-722), ``sync_every``
1 / 4 / 16 byte-identical on the strips with the reference's ticks and
windows, and ngram speculation on the strips equal to plain greedy decode.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as jL
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced-model engine runs are small ops: one intra-op thread, as the
    other model test modules; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _t(a):
    return torch.from_numpy(np.array(a))


def _layer_params(init, cfg, seed=0):
    """A layer's reference parameters (numpy) and the same as tensors."""
    p = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed), cfg))
    return p, {k: _t(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _qwen(**kw):
    return (dataclasses.replace(jconfigs.get_config("qwen2_1_5b").reduced(), **kw),
            dataclasses.replace(tconfigs.get_config("qwen2_1_5b").reduced(), **kw))


GQA_CASES = {
    "plain": (dict(), None, 1.0),
    "ring": (dict(), 8, 1.0),
    "soft_cap": (dict(logit_soft_cap=5.0), None, 1.0),
    "ring_soft_cap": (dict(logit_soft_cap=5.0), 8, 1.0),
    "rope_half": (dict(), None, 0.5),
}
MAX_LEN = 24


def _strips(rng, shape, n):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


@pytest.mark.parametrize("case", list(GQA_CASES))
def test_attention_decode_matches_the_reference(case):
    over, window, rf = GQA_CASES[case]
    jcfg, cfg = _qwen(**over)
    pj, pt = _layer_params(jL.init_attention, jcfg)
    rng = np.random.default_rng(1)
    size = min(MAX_LEN, window) if window else MAX_LEN
    b = 4
    k0, v0 = _strips(rng, (b, cfg.num_kv_heads, size, cfg.head_dim), 2)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 17, 23], np.int32)  # the ring wraps at 8
    want, jc = jL.attention_decode(pj, jnp.asarray(x), jcfg,
                                   {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                   jnp.asarray(pos), window=window, rope_fraction=rf)
    cache = {"k": _t(k0), "v": _t(v0)}
    got = L.attention_decode(pt, _t(x), cfg, cache, _t(pos), window=window,
                             rope_fraction=rf)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("case", list(GQA_CASES))
@pytest.mark.parametrize("chunk", [6, 10])  # 10 > the ring of 8: keeps its tail
def test_attention_prefill_matches_the_reference(case, chunk):
    over, window, rf = GQA_CASES[case]
    jcfg, cfg = _qwen(**over)
    pj, pt = _layer_params(jL.init_attention, jcfg)
    rng = np.random.default_rng(2)
    size = min(MAX_LEN, window) if window else MAX_LEN
    b = 4
    k0, v0 = _strips(rng, (b, cfg.num_kv_heads, size, cfg.head_dim), 2)
    x = rng.standard_normal((b, chunk, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 4, 11, 9], np.int32)
    lens = np.array([chunk, 3, chunk - 1, 0], np.int32)
    want, jc = jL.attention_prefill(pj, jnp.asarray(x), jcfg,
                                    {"k": jnp.asarray(k0), "v": jnp.asarray(v0)},
                                    jnp.asarray(pos), jnp.asarray(lens),
                                    window=window, rope_fraction=rf)
    cache = {"k": _t(k0), "v": _t(v0)}
    got = L.attention_prefill(pt, _t(x), cfg, cache, _t(pos), _t(lens),
                              window=window, rope_fraction=rf)
    live = np.arange(chunk)[None, :] < lens[:, None]  # rows past lens: garbage
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **TOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]), **TOL)


def _mla():
    return (jconfigs.get_config("deepseek_v2_lite_16b").reduced(),
            tconfigs.get_config("deepseek_v2_lite_16b").reduced())


def _latent_strips(rng, cfg, b):
    m = cfg.mla
    return (rng.standard_normal((b, MAX_LEN, 1, m.kv_lora_rank)).astype(np.float32),
            rng.standard_normal((b, MAX_LEN, 1, m.qk_rope_head_dim)).astype(np.float32))


@pytest.mark.parametrize("window", [None, 6])
def test_mla_decode_matches_the_reference(window):
    jcfg, cfg = _mla()
    pj, pt = _layer_params(jL.init_mla, jcfg)
    rng = np.random.default_rng(3)
    b = 4
    c0, p0 = _latent_strips(rng, cfg, b)
    x = rng.standard_normal((b, 1, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 7, 23, MAX_LEN], np.int32)  # a dead slot at max_len: clamped
    want, jc = jL.mla_decode(pj, jnp.asarray(x), jcfg,
                             {"c_kv": jnp.asarray(c0), "k_pe": jnp.asarray(p0)},
                             jnp.asarray(pos), window=window)
    cache = {"c_kv": _t(c0), "k_pe": _t(p0)}
    got = L.mla_decode(pt, _t(x), cfg, cache, _t(pos), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]), **TOL)


@pytest.mark.parametrize("window", [None, 6])
def test_mla_prefill_matches_the_reference(window):
    jcfg, cfg = _mla()
    pj, pt = _layer_params(jL.init_mla, jcfg)
    rng = np.random.default_rng(4)
    b, chunk = 4, 8
    c0, p0 = _latent_strips(rng, cfg, b)
    x = rng.standard_normal((b, chunk, cfg.d_model)).astype(np.float32)
    pos = np.array([0, 5, 12, 3], np.int32)
    lens = np.array([4, 8, 7, 0], np.int32)
    want, jc = jL.mla_prefill(pj, jnp.asarray(x), jcfg,
                              {"c_kv": jnp.asarray(c0), "k_pe": jnp.asarray(p0)},
                              jnp.asarray(pos), jnp.asarray(lens), window=window)
    cache = {"c_kv": _t(c0), "k_pe": _t(p0)}
    got = L.mla_prefill(pt, _t(x), cfg, cache, _t(pos), _t(lens), window=window)
    live = np.arange(chunk)[None, :] < lens[:, None]
    np.testing.assert_allclose(got.numpy()[live], np.asarray(want)[live], **TOL)
    for name in ("c_kv", "k_pe"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jc[name]), **TOL)


def test_contiguous_layers_reach_no_kernel_wrapper(monkeypatch):
    """The strips' attention is the plain version by construction: no
    ``kernels.ops`` attention entry point is called, and no plain prefill
    is counted (``ops.PLAIN_PREFILL`` counts only paged verify chunks)."""
    for name in ("attention", "paged_attention", "prefill_attention", "mla_paged",
                 "mla_prefill", "mla"):
        def refuse(*a, _name=name, **kw):
            raise AssertionError(f"ops.{_name} called on the contiguous path")
        monkeypatch.setattr(ops, name, refuse)
    before = dict(ops.PLAIN_PREFILL)
    for arch in ("qwen2_1_5b", "deepseek_v2_lite_16b"):
        cfg = tconfigs.get_config(arch).reduced()
        params = lm.init(cfg, 0, device="cpu")
        eng = ServingEngine(cfg, params, ServeConfig(
            slots=2, max_len=32, max_new_tokens=4, cache="contiguous",
            spec_decode="ngram", sync_every=2), device="cpu")
        reqs = [eng.submit([3, 1, 4, 1, 5, 9, 2]), eng.submit([2, 7, 1])]
        eng.run()
        assert all(r.status == "completed" for r in reqs)
    assert ops.PLAIN_PREFILL == before


# ---------------------------------------------------------------------------
# caches
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen2_1_5b", "deepseek_v2_lite_16b", "hymba_1_5b"])
def test_contiguous_cache_bytes_equal_the_reference(arch):
    cfg = tconfigs.get_config(arch).reduced()
    jcfg = jconfigs.get_config(arch).reduced()
    if arch == "hymba_1_5b":  # 5 layers, so windowed rings beside global strips
        cfg, jcfg = (dataclasses.replace(c, num_layers=5) for c in (cfg, jcfg))
    cache = lm.init_cache(cfg, 3, 48, layout="contiguous", device="cpu")
    assert cache.tables is None and cache.layout == "contiguous"
    assert cache.kv_bytes() == jlm.init_cache(jcfg, 3, 48).kv_bytes()
    with pytest.raises(ValueError, match="requires a paged cache layout"):
        lm.init_cache(dataclasses.replace(cfg, kv_dtype="int8"), 3, 48,
                      layout="contiguous", device="cpu")


# ---------------------------------------------------------------------------
# the engine over the strips
# ---------------------------------------------------------------------------

def _variant_configs(name):
    q = (jconfigs.get_config("qwen2_1_5b").reduced(),
         tconfigs.get_config("qwen2_1_5b").reduced())
    over = {"gqa": {}, "mqa": dict(num_kv_heads=1),
            "sliding_window": dict(sliding_window=12, global_attn_every=2),
            "soft_cap": dict(logit_soft_cap=5.0)}
    if name in over:
        return tuple(dataclasses.replace(c, **over[name]) for c in q)
    arch = {"hybrid_windowed": "hymba_1_5b", "mla": "deepseek_v2_lite_16b"}[name]
    return jconfigs.get_config(arch).reduced(), tconfigs.get_config(arch).reduced()


VARIANTS = ("gqa", "mqa", "sliding_window", "soft_cap", "hybrid_windowed", "mla")
_MODELS = {}


def _model(name):
    if name not in _MODELS:
        jcfg, cfg = _variant_configs(name)
        tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
        tree["embed"]["embedding"] = tree["embed"]["embedding"] * 0.1
        _MODELS[name] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                         params_from_numpy(tree, cfg, device="cpu"))
    return _MODELS[name]


def _prompts(sizes=(6, 3, 9, 2), seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, size=n).tolist() for n in sizes]


def _serve(name, prompts, reference=False, **kw):
    jcfg, cfg, jparams, params = _model(name)
    if reference:
        eng = JServingEngine(jcfg, jparams, JServeConfig(**kw))
    else:
        eng = ServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.done for r in reqs)
    return [r.output for r in reqs], eng


@pytest.mark.parametrize("name", VARIANTS)
def test_paged_matches_contiguous_and_the_reference(name):
    """tests/test_serving.py:666 in the port: contiguous == paged, token for
    token, and both equal the reference's contiguous streams and ticks."""
    prompts = _prompts()
    kw = dict(slots=2, max_len=48, max_new_tokens=5, page_size=16)
    contig, eng = _serve(name, prompts, cache="contiguous", **kw)
    paged, _ = _serve(name, prompts, cache="paged", **kw)
    want, ref = _serve(name, prompts, reference=True, cache="contiguous", **kw)
    assert contig == paged == want
    assert eng.pool is None and eng.steps_run == ref.steps_run
    assert eng.kv_cache_bytes() == ref.kv_cache_bytes()


@pytest.mark.parametrize("cache,prefill", [("contiguous", "replay"), ("contiguous", "chunked"),
                                           ("paged", "replay"), ("paged", "chunked")])
def test_mla_layouts_and_prefills_match_contiguous_replay(cache, prefill):
    """tests/test_serving.py:690: every MLA layout x prefill combination
    equals the contiguous replay path, in the port as in the reference, and
    the paged runs keep only the prefix index's pages."""
    prompts = _prompts(sizes=(22, 3, 17, 9), seed=1)
    kw = dict(slots=2, max_len=48, max_new_tokens=5, prefill_chunk=16, page_size=16)
    base, _ = _serve("mla", prompts, cache="contiguous", prefill="replay", **kw)
    out, eng = _serve("mla", prompts, cache=cache, prefill=prefill, **kw)
    want, ref = _serve("mla", prompts, reference=True, cache=cache, prefill=prefill, **kw)
    assert out == base == want and eng.prefill_mode == prefill
    assert eng.steps_run == ref.steps_run
    if cache == "paged":
        assert eng.pool.in_use == eng.prefix.pages == 2


@pytest.mark.parametrize("name", ["gqa", "sliding_window", "mla"])
def test_sync_every_is_byte_identical_on_the_strips(name):
    """sync_every 1 / 4 / 16 over the strips: equal streams, the window
    engaged, and ticks, windows and dispatches equal the reference's."""
    prompts = _prompts(sizes=(6, 3, 9, 2, 7), seed=2)
    kw = dict(slots=2, max_len=48, max_new_tokens=9, cache="contiguous")
    outs = []
    for sync in (1, 4, 16):
        out, eng = _serve(name, prompts, sync_every=sync, **kw)
        want, ref = _serve(name, prompts, reference=True, sync_every=sync, **kw)
        assert out == want
        for attr in ("steps_run", "decode_windows", "window_fallbacks", "dispatches"):
            assert getattr(eng, attr) == getattr(ref, attr), attr
        assert (eng.decode_windows > 0) == (sync > 1)
        outs.append(out)
    assert outs[0] == outs[1] == outs[2]


@pytest.mark.parametrize("name", ["gqa", "mla"])
def test_ngram_speculation_on_the_strips_equals_greedy(name):
    """Greedy ngram speculation over the strips (the verify chunk written by
    the gather-select from any position) equals plain greedy decode, drafts
    accepted and rejected, with the reference's counters."""
    prompts = _prompts(sizes=(5, 7, 3, 6), seed=0)
    kw = dict(slots=2, max_len=64, max_new_tokens=6, cache="contiguous")
    if name == "mla":  # no capacity drops: routing independent of the batch
        _model(name)
        jcfg, cfg, jparams, params = _MODELS[name]
        _MODELS["mla_no_drops"] = tuple(
            dataclasses.replace(c, moe=dataclasses.replace(c.moe, capacity_factor=4.0))
            for c in (jcfg, cfg)) + (jparams, params)
        name = "mla_no_drops"
    plain, _ = _serve(name, prompts, **kw)
    spec = dict(kw, spec_decode="ngram", draft_len=2, sync_every=4)
    out, eng = _serve(name, prompts, **spec)
    want, ref = _serve(name, prompts, reference=True, **spec)
    assert out == plain == want
    assert eng.spec_windows > 0 and 0 < eng.spec_accepted < eng.spec_proposed
    for attr in ("spec_windows", "spec_rounds", "spec_proposed", "spec_accepted",
                 "steps_run"):
        assert getattr(eng, attr) == getattr(ref, attr), attr
