"""The port's temperature sampling, held against the JAX package on the CPU:
the threefry key stream (``serving.prng``) against jax's own, bit for bit;
``sample`` / ``sample_step`` on the cases of tests/test_sampling.py (the
top-k and top-p clamps, poisoned rows, mixed batches); and the serving
engine's sampled token streams against the reference engine's, per tick and
with the multi-step window.

What is exact: keys, ``split``, the random bits, ``uniform`` (bit for bit)
and ``categorical``'s indices.  The gumbel noise agrees within 1e-6: its
``-log(-log(u))`` goes through XLA's and torch's own ``log``, which round
differently in the last bit.  Engine streams, ticks and the key after a run
are equal exactly.  The tied embedding is scaled by 0.1 in both packages'
parameters, so sampled streams vary.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro.serving import sampling as jsampling
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine, prng
from repro_torch.serving import sampling

SEEDS = (0, 7, 123456789, -1)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced-model engine runs are small ops: one intra-op thread, as the
    other model test modules; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(a) -> np.ndarray:
    return np.asarray(a).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_split_bits_and_uniform_equal_jax_bit_for_bit(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.key(seed)
    np.testing.assert_array_equal(_words(kj), kt.numpy())
    for n in (2, 3, 6):
        np.testing.assert_array_equal(_words(jax.random.split(kj, n)),
                                      prng.split(kt, n).numpy())
    # a split of a split: the engine's carry, several steps deep
    cj, ct = kj, kt
    for _ in range(4):
        cj, ct = jax.random.split(cj)[0], prng.split(ct)[0]
    np.testing.assert_array_equal(_words(cj), ct.numpy())
    for shape in ((7,), (3, 1000), (2, 5, 33)):
        np.testing.assert_array_equal(
            _words(jax.random.bits(kj, shape, jnp.uint32)),
            prng.random_bits(kt, shape).numpy())
        uj = np.asarray(jax.random.uniform(kj, shape))
        np.testing.assert_array_equal(uj.view(np.int32),
                                      prng.uniform(kt, shape).numpy().view(np.int32))
    tiny = float(np.finfo(np.float32).tiny)
    uj = np.asarray(jax.random.uniform(kj, (4, 999), minval=tiny, maxval=1.0))
    np.testing.assert_array_equal(
        uj.view(np.int32), prng.uniform(kt, (4, 999), tiny, 1.0).numpy().view(np.int32))


@pytest.mark.parametrize("seed", SEEDS)
def test_gumbel_within_a_log_rounding_and_categorical_exact(seed):
    kj, kt = jax.random.PRNGKey(seed), prng.key(seed)
    gj = np.asarray(jax.random.gumbel(kj, (4, 5000)))
    np.testing.assert_allclose(prng.gumbel(kt, (4, 5000)).numpy(), gj, rtol=0,
                               atol=1e-6)
    rng = np.random.default_rng(seed & 0xFF)
    for v in (8, 256, 5000):
        logits = rng.standard_normal((8, v)).astype(np.float32) * 3
        np.testing.assert_array_equal(
            prng.categorical(kt, torch.from_numpy(logits)).numpy(),
            np.asarray(jax.random.categorical(kj, jnp.asarray(logits))))


# the cases of tests/test_sampling.py: (logits, temperature, top_k, top_p)
def _cases():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(4, 8)).astype(np.float32)
    wide = rng.normal(size=(6, 300)).astype(np.float32) * 2
    nan_row = base.copy()
    nan_row[1] = np.nan
    inf_row = rng.normal(size=(2, 8)).astype(np.float32)
    inf_row[0] = -np.inf
    head = np.array([[10.0, 0.0, 0.0, 0.0]], np.float32).repeat(16, axis=0)
    return {
        "top_k = V": (base, 1.0, 8, None),
        "top_k > V": (base, 1.0, 100, None),
        "top_k 1": (base, 1.0, 1, None),
        "flat, top_k V + 1": (np.zeros((64, 8), np.float32), 1.0, 9, None),
        "top_p 1": (base, 1.0, None, 1.0),
        "top_p small": (head, 1.0, None, 0.1),
        "top_k and top_p": (wide, 0.8, 50, 0.95),
        "temperature 0.8": (wide, 0.8, None, None),
        "all -inf": (np.full((2, 8), -np.inf, np.float32), 1.0, None, None),
        "all NaN": (np.full((2, 8), np.nan, np.float32), 1.0, None, None),
        "mixed batch, NaN row": (nan_row, 1.0, None, None),
        "-inf row under top_k, top_p": (inf_row, 0.7, 4, 0.9),
        "greedy, NaN row": (nan_row, 0.0, None, None),
    }


@pytest.mark.parametrize("name", list(_cases()))
def test_sample_and_sample_step_match_reference(name):
    logits, temperature, top_k, top_p = _cases()[name]
    for seed in (0, 3):
        kj, kt = jax.random.PRNGKey(seed), prng.key(seed)
        kw = dict(temperature=temperature, top_k=top_k, top_p=top_p)
        want = np.asarray(jsampling.sample(jnp.asarray(logits), kj, **kw))
        got = sampling.sample(torch.from_numpy(logits), kt, **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        jtok, jkey = jsampling.sample_step(jnp.asarray(logits), kj, **kw)
        tok, key = sampling.sample_step(torch.from_numpy(logits), kt, **kw)
        np.testing.assert_array_equal(tok.numpy(), np.asarray(jtok))
        np.testing.assert_array_equal(key.numpy(), _words(jkey))
        if temperature <= 0.0:
            assert key is kt  # greedy never splits
    if "NaN" in name or "inf" in name:
        assert got[int(np.argmax(~np.isfinite(logits).any(-1)))] == 0


def test_gate_leaves_the_key_unadvanced_without_a_host_sync():
    kt = prng.key(9)
    logits = torch.zeros(2, 8)
    for gate, want in ((torch.tensor(True), prng.split(kt)[0]),
                       (torch.tensor(False), kt)):
        _, key = sampling.sample_step(logits, kt, temperature=1.0, gate=gate)
        assert key.tolist() == want.tolist()
        _, key = sampling.spec_sample_step(logits[:, None].expand(2, 3, 8), kt,
                                           temperature=1.0, gate=gate)
        want_spec = prng.split(kt, 4)[0] if gate else kt
        assert key.tolist() == want_spec.tolist()


def test_spec_sample_step_and_accept_match_reference():
    rng = np.random.default_rng(5)
    logits = rng.normal(size=(3, 5, 40)).astype(np.float32) * 2
    kj, kt = jax.random.PRNGKey(11), prng.key(11)
    for temperature in (0.0, 0.8):
        jt, jk = jsampling.spec_sample_step(jnp.asarray(logits), kj,
                                            temperature=temperature)
        tt, tk = sampling.spec_sample_step(torch.from_numpy(logits), kt,
                                           temperature=temperature)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tk.numpy(), _words(jk))
    drafts = rng.integers(0, 4, size=(6, 4)).astype(np.int32)
    targets = rng.integers(0, 4, size=(6, 5)).astype(np.int32)
    targets[0, :4] = drafts[0]  # one slot accepting every draft
    np.testing.assert_array_equal(
        sampling.spec_accept(torch.from_numpy(drafts), torch.from_numpy(targets)).numpy(),
        np.asarray(jsampling.spec_accept(jnp.asarray(drafts), jnp.asarray(targets))))


# ---------------------------------------------------------------------------
# the engine's key carry
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    """qwen2-1.5B reduced in both packages, the tied embedding scaled by 0.1
    (at full scale each token's own logit dominates, and even sampled
    streams repeat one token)."""
    cfg_j = jget_config("qwen2_1_5b").reduced()
    cfg_t = get_config("qwen2_1_5b").reduced()
    pj = dict(jlm.init(cfg_j, jax.random.PRNGKey(0)))
    pj["embed"] = {"embedding": pj["embed"]["embedding"] * 0.1}
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, pj, cfg_t, pt


def _prompts(seed=0, sizes=(5, 7, 3, 6, 21)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=n).tolist() for n in sizes]
    prompts[4] = prompts[0] + prompts[4]  # a shared prefix
    return prompts


def _run(engine_cls, scfg_cls, cfg, params, prompts, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**kw), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


@pytest.mark.parametrize("sync", [1, 4])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_temperature_streams_match_reference(model, sync, kv_dtype):
    """Sampled streams, ticks, TTFT ticks, windows and the key after the run
    equal the reference engine's: the key is split once a decode step, once
    a prefill step and once a window iteration while any slot lives."""
    cfg_j, pj, cfg_t, pt = model
    prompts = _prompts()
    kw = dict(slots=2, max_len=64, max_new_tokens=8, page_size=4, temperature=0.8,
              seed=3, sync_every=sync, kv_dtype=kv_dtype)
    want, rj, theirs = _run(JServingEngine, JServeConfig, cfg_j, pj, prompts, **kw)
    got, rt, ours = _run(ServingEngine, ServeConfig, cfg_t, pt, prompts, **kw)
    assert got == want
    greedy, _, _ = _run(ServingEngine, ServeConfig, cfg_t, pt, prompts,
                        **{**kw, "temperature": 0.0})
    assert got != greedy and any(len(set(o)) > 2 for o in got)
    assert ours.steps_run == theirs.steps_run
    assert ours.decode_windows == theirs.decode_windows and (ours.decode_windows > 0) == (sync > 1)
    assert [r.ttft_ticks for r in rt] == [r.ttft_ticks for r in rj]
    np.testing.assert_array_equal(ours._key.numpy(), _words(theirs._key))


def test_greedy_engine_never_splits_the_key(model):
    _, _, cfg_t, pt = model
    _, _, eng = _run(ServingEngine, ServeConfig, cfg_t, pt, _prompts(), slots=2,
                     max_len=64, max_new_tokens=4, seed=7, sync_every=4)
    assert eng.decode_windows > 0 and eng._key.tolist() == prng.key(7).tolist()


def test_sampled_window_stays_on_the_device(model, monkeypatch):
    """``lm.decode_loop`` at temperature makes no host transfer: the key is
    split and gated by device-side masks."""
    _, _, cfg, params = model
    cache = lm.init_cache(cfg, 3, 32, page_size=8, num_blocks=13, device="cpu")
    cache = cache.with_tables(torch.tensor(
        [[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], dtype=torch.int32))
    key0 = prng.key(1)
    feed = torch.tensor([7, 9, 0], dtype=torch.int32)
    pos = torch.tensor([5, 29, 0], dtype=torch.int32)
    live = torch.tensor([True, True, False])
    remaining = torch.tensor([2, 10, 0], dtype=torch.int32)
    calls = []
    for name in ("item", "cpu", "tolist", "numpy", "nonzero", "__bool__",
                 "__int__", "__float__"):
        orig = getattr(torch.Tensor, name)

        def wrapped(t, *a, _orig=orig, _name=name, **kw):
            calls.append(_name)
            return _orig(t, *a, **kw)

        monkeypatch.setattr(torch.Tensor, name, wrapped)
    for name in ("tensor", "as_tensor"):  # a host value copied to the device
        orig = getattr(torch, name)

        def made(data, *a, _orig=orig, _name=name, **kw):
            if not isinstance(data, torch.Tensor):
                calls.append(_name)
            return _orig(data, *a, **kw)

        monkeypatch.setattr(torch, name, made)

    toks, emitted, key = lm.decode_loop(
        params, cfg, cache, feed, pos, key0, live, remaining, n_steps=5,
        sample_fn=lambda lg, k, g: sampling.sample_step(lg, k, temperature=0.8, gate=g),
        eos_id=-1, max_len=32)
    assert calls == []
    monkeypatch.undo()
    # slots live for 3 iterations (slot 1 reaches max_len): 3 splits, then gated
    want = key0
    for _ in range(3):
        want = prng.split(want)[0]
    assert key.tolist() == want.tolist()
    assert emitted[:, 1].tolist() == [True, True, True, False, False]
