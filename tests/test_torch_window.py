"""The port's multi-step decode window (``sync_every > 1``) and
``lm.decode_loop`` on the CPU.

The window is an optimisation, never a behaviour change: within the port,
outputs are byte-identical across ``sync_every`` in {1, 4, 16}, fp and int8
pages, prefix cache on and off (as the reference's TestMultiStepDecode pins
for itself).  Its scheduling is the reference engine's: on the same
workload ``steps_run``, ``dispatches``, windows taken and TTFT ticks are
equal.  Inside the loop nothing waits for the host: no ``.item()``,
``.cpu()``, ``.tolist()``, ``.numpy()`` or ``nonzero`` (a sync on a card),
and the engine downloads once per window.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.sampling import guarded_argmax


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_config("qwen2_1_5b").reduced()
    cfg_t = get_config("qwen2_1_5b").reduced()
    pj = jlm.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, pj, cfg_t, pt


@pytest.fixture(scope="module")
def diverse(model):
    """The port's parameters with the tied embedding scaled by 0.1: each
    token's own logit no longer dominates, so greedy streams vary from token
    to token (a byte-identity check over constant streams would prove
    little, and EOS could fire only on a stream's first token)."""
    params = dict(model[3])
    params["embed"] = {"embedding": params["embed"]["embedding"] * 0.1}
    return model[2], params


def _prompts(seed=0):
    """Five prompts for two slots, so admission waits on windows; the first
    and the fourth share a 16-token prefix (one full page), which the fourth
    finds in the prefix cache."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=16).tolist()
    own = [rng.integers(0, 256, size=n).tolist() for n in (3, 9, 2, 6, 5)]
    own[0], own[3] = shared + own[0], shared + own[3]
    return own


BASE = dict(slots=2, max_len=48, max_new_tokens=5, page_size=16)


def _run(cfg, params, prompts, engine_cls=ServingEngine, scfg_cls=ServeConfig,
         **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**{**BASE, **kw}), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_outputs_byte_identical_across_sync_every_and_prefix_cache(diverse, kv_dtype):
    cfg, params = diverse
    prompts = _prompts()
    base, _, eng1 = _run(cfg, params, prompts, kv_dtype=kv_dtype)
    assert eng1.decode_windows == 0 and eng1.pages_shared > 0
    assert all(len(set(o)) > 1 for o in base)
    for prefix_cache in (True, False):
        for sync in (1, 4, 16):
            out, _, eng = _run(cfg, params, prompts, kv_dtype=kv_dtype,
                               sync_every=sync, prefix_cache=prefix_cache)
            assert out == base, (sync, prefix_cache)
            assert (eng.decode_windows > 0) == (sync > 1)
            # grow-ahead pages all recycled; only the prefix index holds any
            assert eng.pool.in_use == (eng.prefix.pages if prefix_cache else 0)


@pytest.mark.parametrize("sync,kv_dtype", [(4, None), (16, "int8")])
def test_window_scheduling_matches_reference_engine(model, sync, kv_dtype):
    cfg_j, pj, cfg_t, pt = model
    prompts = _prompts(1)
    _, rq, ours = _run(cfg_t, pt, prompts, sync_every=sync, kv_dtype=kv_dtype)
    _, rj, theirs = _run(cfg_j, pj, prompts, JServingEngine, JServeConfig,
                         sync_every=sync, kv_dtype=kv_dtype)
    assert ours.decode_windows == theirs.decode_windows > 0
    assert ours.steps_run == theirs.steps_run
    assert ours.dispatches == theirs.dispatches < ours.steps_run
    assert ours.window_fallbacks == theirs.window_fallbacks
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]


def test_tight_pool_falls_back_and_preemption_at_boundary_is_lossless(model):
    """A pool that fits only the per-tick footprint denies the grow-ahead
    (fallback, never preemption); a pool too small for two requests preempts
    at a window boundary and recompute-resume stays lossless
    (tests/test_serving.py:572, :600)."""
    cfg_j, pj, cfg, params = model
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, 256, size=3).tolist() for _ in range(2)]
    tight = dict(max_len=16, max_new_tokens=6, page_size=1, num_blocks=16,
                 prefix_cache=False)
    ref, _, _ = _run(cfg, params, prompts, **tight)
    out, _, eng = _run(cfg, params, prompts, sync_every=8, **tight)
    _, _, theirs = _run(cfg_j, pj, prompts, JServingEngine, JServeConfig,
                        sync_every=8, **tight)
    assert out == ref
    assert eng.window_fallbacks == theirs.window_fallbacks > 0
    assert eng.preemptions == 0 and eng.pool.in_use == 0
    p1, p2 = (rng.integers(0, 256, size=6).tolist() for _ in range(2))
    small = dict(max_len=16, max_new_tokens=6, page_size=4)
    (ref1,), _, _ = _run(cfg, params, [p1], slots=1, **small)
    (ref2,), _, _ = _run(cfg, params, [p2], slots=1, **small)
    out, reqs, eng = _run(cfg, params, [p1, p2], num_blocks=4, sync_every=4,
                          prefix_cache=False, **small)
    assert eng.preemptions >= 1 and reqs[1].preemptions >= 1
    assert out == [ref1, ref2]
    assert eng.pool.in_use == 0


def test_eos_mid_window_matches_per_tick(diverse):
    cfg, params = diverse
    prompts = _prompts()
    free, _, _ = _run(cfg, params, prompts, max_new_tokens=8)
    eos = next(o[3] for o in free if o[3] not in o[:3])
    ref, _, _ = _run(cfg, params, prompts, max_new_tokens=8, eos_id=eos)
    out, _, eng = _run(cfg, params, prompts, max_new_tokens=8, eos_id=eos,
                       sync_every=8)
    assert out == ref and eng.decode_windows > 0
    assert any(len(o) < 8 for o in out)


class _SyncCounter:
    """Counts the tensor methods that make the host wait for a card."""

    NAMES = ("item", "cpu", "tolist", "numpy", "nonzero", "__bool__",
             "__int__", "__float__")

    def __init__(self, monkeypatch):
        self.calls = []
        for name in self.NAMES:
            orig = getattr(torch.Tensor, name)

            def wrapped(t, *a, _orig=orig, _name=name, **kw):
                self.calls.append(_name)
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, wrapped)


@pytest.mark.parametrize("kv_dtype", [None, "int4"])
def test_decode_loop_stays_on_the_device(model, monkeypatch, kv_dtype):
    """``lm.decode_loop`` makes no host transfer, and its stop rule is the
    per-tick engine's: EOS, the allowance, or ``max_len``."""
    import dataclasses
    _, _, cfg, params = model
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    cache = lm.init_cache(cfg, 3, 32, page_size=8, num_blocks=13, device="cpu")
    tables = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], dtype=torch.int32)
    cache = cache.with_tables(tables)
    feed = torch.tensor([7, 9, 0], dtype=torch.int32)
    pos = torch.tensor([5, 29, 0], dtype=torch.int32)
    live = torch.tensor([True, True, False])
    remaining = torch.tensor([3, 10, 0], dtype=torch.int32)
    counter = _SyncCounter(monkeypatch)
    toks, emitted, key = lm.decode_loop(
        params, cfg, cache, feed, pos, None, live, remaining, n_steps=5,
        sample_fn=lambda logits, key, gate: (guarded_argmax(logits), key),
        eos_id=-1, max_len=32)
    assert counter.calls == []
    monkeypatch.undo()
    assert toks.shape == emitted.shape == (5, 3) and toks.dtype == torch.int32
    # slot 0 stops on its allowance (3), slot 1 at max_len (29 + 3 = 32)
    assert emitted[:, 0].tolist() == [True, True, True, False, False]
    assert emitted[:, 1].tolist() == [True, True, True, False, False]
    assert not emitted[:, 2].any() and (toks[:, 2] == 0).all()
    assert (toks[3:, 0] == toks[2, 0]).all()  # a stopped slot re-feeds its token


def test_engine_downloads_once_per_window(model, monkeypatch):
    _, _, cfg, params = model
    eng = ServingEngine(cfg, params, ServeConfig(**BASE, sync_every=16),
                        device="cpu")
    for p in _prompts()[:2]:
        eng.submit(p)
    while eng.decode_windows == 0:
        eng.step()
    counter = _SyncCounter(monkeypatch)
    while eng.slot_req[0] is not None or eng.slot_req[1] is not None:
        windows = eng.decode_windows
        eng.step()
        assert eng.decode_windows == windows + 1
    assert counter.calls.count("cpu") == eng.decode_windows - 1
    assert set(counter.calls) <= {"cpu", "numpy"}


def test_temperature_with_the_window_still_raises(diverse):
    """Temperature sampling with the window is ported (it raised until the
    key stream was): the window's sampled streams equal per-tick stepping's
    when no request waits in the queue, and the engine's key after the run
    is the same (tests/test_torch_sampling.py holds both against the
    reference engine)."""
    cfg, params = diverse
    prompts = _prompts()[:2]
    outs, keys = [], []
    for sync in (1, 4):
        eng = ServingEngine(cfg, params, ServeConfig(
            **BASE, sync_every=sync, temperature=0.8, seed=5), device="cpu")
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        outs.append([r.output for r in reqs])
        keys.append(eng._key.tolist())
        assert (eng.decode_windows > 0) == (sync > 1)
    assert outs[0] == outs[1] and keys[0] == keys[1]
