"""The port's speculative decoding, held against the JAX package on the CPU:
``lm.ngram_propose``, ``lm.verify_step`` (its attention on the plain path at
every chunk width), ``lm.spec_decode_loop`` and the engine's draft-verify
window, on the reference's three modes (tests/test_serving.py:1250: paged
GQA, MLA, int8 KV pages) at draft lengths 1, 2, 4 and sync_every 1, 4.

What is exact: greedy spec streams equal the port's own plain decode byte for
byte and the reference engine's spec streams; the spec counters (windows,
rounds, drafts proposed and accepted, all-rejected rounds) and ticks equal
the reference's; a sampled spec run's stream and key equal the reference's;
no page leaks (the pool holds only the prefix cache's pages after a run).
A verify chunk of 16 at page 16 (``draft_len`` 15), which starts off a page
boundary, equals the reference too.  The tied embedding is scaled by 0.1 in
both packages' parameters, so streams vary and drafts are rejected as well
as accepted.

The MLA mode's model is deepseek-v2-lite-16B, an MoE: its GShard dispatch
drops tokens by group, and the groups follow the batch shape (a verify
chunk is ``draft_len + 1`` tokens a slot, a decode step one), so where
capacity binds, spec and plain decode route some tokens differently, in
the reference as in the port (ROADMAP Queue 3).  Its byte-identity cases
raise the capacity factor in both packages so that no token drops; at the
configured capacity the port's spec streams still equal the reference's.
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
from repro_torch.kernels import ops
from repro_torch.kernels import prefill_attention as PF
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine, prng
from repro_torch.serving import sampling

MODES = {"gqa_paged": ("qwen2_1_5b", {}), "mla": ("deepseek_v2_lite_16b", {}),
         "int8_kv": ("qwen2_1_5b", {"kv_dtype": "int8"})}
BASE = dict(slots=2, max_len=64, max_new_tokens=6, page_size=4)
COUNTERS = ("spec_windows", "spec_rounds", "spec_proposed", "spec_accepted",
            "spec_all_rejected", "spec_fallbacks", "steps_run", "dispatches")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Reduced-model engine runs are small ops: one intra-op thread, as the
    other model test modules; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_MODELS = {}
NO_DROPS = 4.0  # an MoE capacity factor at which no expert drops a token


def _model(arch, capacity=None):
    """(reference config, port config, reference params, port params), the
    embedding scaled by 0.1 in both; ``capacity`` replaces the MoE's
    capacity factor in both configs."""
    if (arch, capacity) not in _MODELS:
        jcfg = jconfigs.get_config(arch).reduced()
        cfg = tconfigs.get_config(arch).reduced()
        if capacity is not None:
            jcfg, cfg = (dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, capacity_factor=capacity)) for c in (jcfg, cfg))
        tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
        tree["embed"]["embedding"] = tree["embed"]["embedding"] * 0.1
        _MODELS[arch, capacity] = (jcfg, cfg, jax.tree.map(jnp.asarray, tree),
                                   params_from_numpy(tree, cfg, device="cpu"))
    return _MODELS[arch, capacity]


def _prompts(seed=0, sizes=(5, 7, 3, 6)):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=n).tolist() for n in sizes]


def _run(arch, prompts, reference=False, capacity=None, **kw):
    jcfg, cfg, jparams, params = _model(arch, capacity)
    if reference:
        eng = JServingEngine(jcfg, jparams, JServeConfig(**kw))
    else:
        eng = ServingEngine(cfg, params, ServeConfig(**kw), device="cpu")
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


_PLAIN = {}


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("draft", [1, 2, 4])
@pytest.mark.parametrize("sync", [1, 4])
def test_greedy_spec_equals_plain_decode_and_the_reference(mode, draft, sync):
    arch, extra = MODES[mode]
    prompts = _prompts()
    if mode == "mla":  # no capacity drops: routing independent of the batch
        extra = {**extra, "capacity": NO_DROPS}
    if mode not in _PLAIN:
        _PLAIN[mode] = _run(arch, prompts, **BASE, **extra)[0]
    kw = dict(**BASE, **extra, sync_every=sync, spec_decode="ngram", draft_len=draft)
    out, reqs, ours = _run(arch, prompts, **kw)
    want, jreqs, theirs = _run(arch, prompts, reference=True, **kw)
    assert out == _PLAIN[mode] == want
    assert ours.spec_windows > 0 and ours.spec_accepted > 0  # drafts land
    assert ours.spec_accepted < ours.spec_proposed  # and some are rejected
    for name in COUNTERS:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert [r.ttft_ticks for r in reqs] == [r.ttft_ticks for r in jreqs]
    assert ours.pool.in_use == ours.prefix.pages  # rollback leaked nothing


def test_mla_spec_at_the_configured_capacity_matches_the_reference():
    """At deepseek's own capacity factor the verify chunks' groups drop
    other tokens than the decode steps' (so spec and plain streams part, in
    both packages), and the port's spec streams and counters still equal
    the reference's."""
    prompts = _prompts()
    kw = dict(**BASE, sync_every=4, spec_decode="ngram", draft_len=2)
    plain = _run("deepseek_v2_lite_16b", prompts, **BASE)[0]
    out, _, ours = _run("deepseek_v2_lite_16b", prompts, **kw)
    want, _, theirs = _run("deepseek_v2_lite_16b", prompts, reference=True, **kw)
    assert out == want != plain
    for name in COUNTERS:
        assert getattr(ours, name) == getattr(theirs, name), name


@pytest.mark.parametrize("mode", ["gqa_paged", "mla"])
def test_sampled_spec_stream_and_key_match_reference(mode):
    """At temperature 0.8 a round splits the key draft_len + 2 ways whatever
    it accepts: the streams and the key after the run equal the
    reference's."""
    arch, extra = MODES[mode]
    kw = dict({**BASE, "max_new_tokens": 10}, **extra, sync_every=4,
              spec_decode="ngram", draft_len=3, temperature=0.8, seed=7)
    prompts = _prompts(1)
    out, _, ours = _run(arch, prompts, **kw)
    want, _, theirs = _run(arch, prompts, reference=True, **kw)
    assert out == want and any(len(set(o)) > 3 for o in out)
    for name in COUNTERS:
        assert getattr(ours, name) == getattr(theirs, name), name
    np.testing.assert_array_equal(ours._key.numpy(), np.asarray(theirs._key).astype(np.int64))


@pytest.mark.parametrize("mode", ["gqa_paged", "int8_kv"])
def test_draft_15_at_page_16_matches_the_reference(mode):
    """A verify chunk of 16 at page 16, starting off a page boundary: the
    prefill kernels' rule would take a width that is a whole number of
    pages, but verify's attention is plain by construction, so it writes
    only its own positions; streams equal plain decode's and the
    reference's."""
    arch, extra = MODES[mode]
    prompts = _prompts(2, sizes=(21, 9))
    kw = dict(slots=2, max_len=96, max_new_tokens=24, page_size=16, prefill_chunk=16,
              **extra)
    plain, _, _ = _run(arch, prompts, **kw)
    kw.update(sync_every=2, spec_decode="ngram", draft_len=15)
    before = dict(ops.PLAIN_PREFILL)
    out, _, ours = _run(arch, prompts, **kw)
    want, _, theirs = _run(arch, prompts, reference=True, **kw)
    assert out == plain == want and ours.spec_windows > 0
    for name in COUNTERS:
        assert getattr(ours, name) == getattr(theirs, name), name
    name = "prefill_attention" if mode == "gqa_paged" else "prefill_attention_quant"
    rounds = ours.spec_rounds  # every verify layer went the plain way
    assert ops.PLAIN_PREFILL[name] - before[name] >= rounds * 2


def test_verify_takes_the_plain_path_even_at_a_whole_page(monkeypatch):
    """``verify_step``'s attention never reaches a kernel wrapper, even for
    a chunk the kernel's rule takes (a whole page, here 16 wide at page 16
    from an unaligned start), and each call is counted; ``prefill_step``
    at the same shape does reach the wrapper."""
    _, cfg, _, params = _model("qwen2_1_5b")
    calls = []
    real = PF.prefill_attention

    def recording(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(PF, "prefill_attention", recording)
    cache = lm.init_cache(cfg, 1, 64, page_size=16, num_blocks=5, device="cpu")
    cache = cache.with_tables(torch.tensor([[1, 2, 3, 4]], dtype=torch.int32))
    toks = torch.randint(0, 256, (1, 16), dtype=torch.int32)
    lm.prefill_step(params, cfg, cache, toks, torch.tensor([0]), torch.tensor([16]))
    assert len(calls) == cfg.num_layers
    before = ops.PLAIN_PREFILL["prefill_attention"]
    logits, _ = lm.verify_step(params, cfg, cache, toks, torch.tensor([5]),
                               torch.tensor([16]))
    assert len(calls) == cfg.num_layers  # no further wrapper call
    assert ops.PLAIN_PREFILL["prefill_attention"] - before == cfg.num_layers
    assert logits.shape == (1, 16, cfg.vocab_size) and logits.dtype == torch.float32


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "deepseek_v2_lite_16b"])
def test_verify_step_logits_match_reference(arch):
    jcfg, cfg, jparams, params = _model(arch)
    rng = np.random.default_rng(3)
    cj = jlm.init_cache(jcfg, 2, 32, layout="paged", page_size=4, num_blocks=17)
    ct = lm.init_cache(cfg, 2, 32, page_size=4, num_blocks=17, device="cpu")
    tables = (np.arange(16, dtype=np.int32) + 1).reshape(2, 8)
    cj, ct = cj.with_tables(jnp.asarray(tables)), ct.with_tables(torch.as_tensor(tables))
    toks = rng.integers(0, 256, size=(2, 8)).astype(np.int32)
    pos, lens = np.array([0, 0], np.int32), np.array([8, 6], np.int32)
    prefill_j = jax.jit(lambda p, c, t, s, n: jlm.prefill_step(p, jcfg, c, t, s, n))
    verify_j = jax.jit(lambda p, c, t, s, n: jlm.verify_step(p, jcfg, c, t, s, n))
    _, cj = prefill_j(jparams, cj, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(lens))
    _, ct = lm.prefill_step(params, cfg, ct, torch.as_tensor(toks), torch.as_tensor(pos),
                            torch.as_tensor(lens))
    chunk = rng.integers(0, 256, size=(2, 5)).astype(np.int32)
    pos, lens = np.array([8, 6], np.int32), np.array([5, 5], np.int32)
    want, _ = verify_j(jparams, cj, jnp.asarray(chunk), jnp.asarray(pos), jnp.asarray(lens))
    got, _ = lm.verify_step(params, cfg, ct, torch.as_tensor(chunk), torch.as_tensor(pos),
                            torch.as_tensor(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


def test_ngram_propose_matches_reference():
    rng = np.random.default_rng(4)
    for _ in range(20):
        b, h = 4, 24
        hist = rng.integers(0, 5, size=(b, h)).astype(np.int32)
        pos = rng.integers(0, h, size=b).astype(np.int32)
        pos[0] = 0
        feed = hist[np.arange(b), pos]
        for k in (1, 3, 6):
            want = jlm.ngram_propose(jnp.asarray(hist), jnp.asarray(pos),
                                     jnp.asarray(feed), k)
            got = lm.ngram_propose(torch.as_tensor(hist), torch.as_tensor(pos),
                                   torch.as_tensor(feed), k)
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert set(lm.DRAFT_PROPOSERS) == set(jlm.DRAFT_PROPOSERS) == {"ngram"}


def test_spec_decode_loop_stays_on_the_device(monkeypatch):
    """Rounds with no host transfer: proposals, verify, acceptance, the key
    and the history all stay device-side masks and scatters."""
    _, cfg, _, params = _model("qwen2_1_5b")
    cache = lm.init_cache(cfg, 2, 32, page_size=4, num_blocks=17, device="cpu")
    cache = cache.with_tables((torch.arange(16, dtype=torch.int32) + 1).reshape(2, 8))
    hist = torch.zeros((2, 32), dtype=torch.int32)
    hist[0, :6] = torch.tensor([3, 4, 5, 3, 4, 5])
    hist[1, :4] = torch.tensor([9, 8, 9, 8])
    feed = torch.tensor([5, 8], dtype=torch.int32)
    pos = torch.tensor([5, 3], dtype=torch.int32)
    key0, live = prng.key(0), torch.tensor([True, True])
    remaining = torch.tensor([6, 2], dtype=torch.int32)
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
    toks, emitted, bad, key = lm.spec_decode_loop(
        params, cfg, cache, feed, pos, key0, live, remaining, hist, n_rounds=3,
        draft_len=3,
        propose_fn=lm.ngram_propose,
        sample_fn=lambda lg, k, g: sampling.spec_sample_step(lg, k, temperature=0.8, gate=g),
        accept_fn=sampling.spec_accept, eos_id=-1, max_len=32)
    assert calls == []
    monkeypatch.undo()
    assert toks.shape == emitted.shape == (3, 2, 4) and bad.shape == (3, 2)
    assert int(emitted[:, 1].sum()) == 2  # slot 1's allowance
    assert not bad.any() and key.tolist() != key0.tolist()


def test_spec_composes_with_the_window_and_survives_preemption():
    """On self-similar prompts drafts land, so speculation takes fewer host
    dispatches than the plain window for the same output; a pool too small
    for both requests preempts one while its drafts are in flight, and the
    recompute resume is lossless (tests/test_serving.py:1300, :1371)."""
    rng = np.random.default_rng(5)
    motif = rng.integers(0, 256, size=4).tolist()
    base = dict(slots=2, max_len=96, max_new_tokens=16, page_size=4, sync_every=4,
                prefix_cache=False)
    plain, _, ref_eng = _run("qwen2_1_5b", [motif * 3] * 2, **base)
    out, _, eng = _run("qwen2_1_5b", [motif * 3] * 2, spec_decode="ngram",
                       draft_len=4, **base)
    assert out == plain and eng.spec_accepted > 0
    assert eng.dispatches < ref_eng.dispatches and eng.pool.in_use == 0
    p1, p2 = _prompts(6, sizes=(6, 6))
    solo = dict(slots=1, max_len=16, max_new_tokens=6, page_size=4)
    refs = [_run("qwen2_1_5b", [p], **solo)[0][0] for p in (p1, p2)]
    out, _, eng = _run("qwen2_1_5b", [p1, p2], slots=2, max_len=16, max_new_tokens=6,
                       page_size=4, num_blocks=4, sync_every=4, spec_decode="ngram",
                       draft_len=4, prefix_cache=False)
    assert eng.preemptions >= 1 and out == refs and eng.pool.in_use == 0


def test_spec_needs_a_chunked_prefill_model_and_a_known_proposer():
    cfg = tconfigs.get_config("mamba2_2_7b").reduced()
    params = lm.init(cfg, 0, device="cpu")
    with pytest.raises(ValueError, match="spec_decode"):
        ServingEngine(cfg, params, ServeConfig(
            slots=1, max_len=16, max_new_tokens=2, cache="contiguous",
            spec_decode="ngram"), device="cpu")
    with pytest.raises(ValueError, match="spec_decode"):
        ServeConfig(spec_decode="crystal_ball")


def test_serve_cli_prints_the_acceptance_line(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "6",
                       "--prompt-len", "12", "--max-len", "48", "--sync-every", "2",
                       "--spec-decode", "ngram", "--draft-len", "3",
                       "--temperature", "0.8", "--seed", "4"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    assert "spec windows:" in out and "drafts accepted" in out
    assert "multi-step windows" in out


def test_chip_smoke_sampling_and_spec_checks_rehearse_on_the_cpu():
    """chip_smoke.py's phase 12 with CPU tensors at reduced widths: the
    threefry and ``sample`` checks (the card's side is the CPU here), the
    sampled runs per tick and with the window, greedy speculation against a
    plain run with its divergence replay, and the MLA speculation at an
    MoE capacity with no drops."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels.ops import KERNELS

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cpu = torch.device("cpu")
    assert cs.prng_check(torch, cpu) > 0
    rows, differ, _ = cs.sample_check(torch, cpu, keys=1)
    assert rows == cs.SLOTS and differ == 0
    cfg = dataclasses.replace(tconfigs.get_config("qwen2_1_5b").reduced(), num_layers=1)
    params = lm.init(cfg, 0, device="cpu")
    params["embed"] = {"embedding": params["embed"]["embedding"] * 0.1}
    runs = {}
    run = cs.make_runner(torch, np, cfg, params, KERNELS, cpu, runs)
    _, plain = run("fp", cs.FP_KERNELS, cs.TC_KERNELS, requests=4)
    eng = cs.spec_run(torch, np, lm, cfg, params, cpu, run, "spec", cs.FP_KERNELS,
                      cs.TC_KERNELS, plain)
    assert eng.spec_accepted > 0 and [r.output for r in runs["spec"][1]] == [
        r.output for r in plain]
    cs.sampled_runs(run, runs["fp"][1] * 2, cs.FP_KERNELS, cs.TC_KERNELS)
    margin, err = cs.replay_margin(torch, np, lm, cfg, params, cpu, plain[0].prompt,
                                   plain[0].output[:3])
    assert margin > 0 and err < 1e-4
    mla = dataclasses.replace(tconfigs.get_config("deepseek_v2_lite_16b").reduced(),
                              num_layers=2)
    assert cs.moe_no_drops(mla).moe.capacity_factor == 4.0
    cs.mla_spec_phase(torch, np, lm, mla, KERNELS, cpu, requests=2)
