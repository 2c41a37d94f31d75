"""The port's hybrid family (hymba-1.5B: GQA attention and Mamba-2 side by
side in every block), held against the JAX package on the CPU: the
parameter tree, the forward, the loss and every gradient, the paged decode
with its recurrent state, the serving engine (replayed prompts, the
multi-step window, preemption), the cache's page copies and bytes, int8
pages, and the CLIs.

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; every other input is a
numpy array made from a seed and handed to both sides.  Reduced
``hymba_1_5b`` with 5 layers (``reduced()`` gives 2, and with 2 every layer
is global: the first, middle and last stay global, lm.py:93), so layers 1
and 3 attend within the reduced window of 32 and every sequence below runs
past it: fp32, d 64, 4 query heads over 2 KV heads of 16, 8 SSM heads of P
16, state N 16, chunk 16, vocab 256.

Tolerances: logits, the loss and every gradient leaf at 1e-4 (of the
leaf's largest element for gradients: fp32 through five layers and their
backward); decode logits and state at 1e-4; the port's forward against its
own decode at the reference's 5e-3 (test_models.py:200); int8 pages at 2e-3
a step, each step from the reference's pools and state (as
tests/test_torch_quant.py: a code can land one step apart across the two
frameworks).  Engine schedules (ticks, TTFT ticks, windows, preemptions)
and token streams are equal exactly.
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
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "hymba_1_5b"
LAYERS = 5


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


def _configs(**kw):
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(),
                               num_layers=LAYERS, **kw)
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(),
                              num_layers=LAYERS, **kw)
    return jcfg, cfg


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's CPU work is thousands of small ops (replayed ticks of a
    reduced model): one intra-op thread runs them as fast, and keeps them
    from slowing down under a loaded machine; the setting is restored for
    the modules that follow in the process."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model():
    """Reduced 5-layer hymba in both packages, from the reference's init."""
    jcfg, cfg = _configs()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree


# ---------------------------------------------------------------------------
# the parameter tree and the windows
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_shapes_and_leaf_dtypes_match_reference(dtype):
    """Leaf by leaf, ``norm_m`` included: the reference's ``lm.init``, the
    port's own ``init`` and the bridge give the same paths, shapes and
    dtypes (fp32 a_log, d_skip and dt_bias in bf16, the rest the model's)."""
    jcfg, cfg = _configs(dtype=dtype)
    jtree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(jtree).items()}
    assert "layers/norm_m" in want and want["layers/norm_m"][1] == dtype
    for tree in (lm.init(cfg, 0, device="cpu"),
                 params_from_numpy(jtree, cfg, device="cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(tree).items()}
        assert got == want


def test_windows_bind_on_the_windowed_layers():
    jcfg, cfg = _configs()
    assert lm.static_windows(cfg) == jlm.static_windows(jcfg) == [None, 32, None, 32, None]
    assert lm.layer_windows(cfg) == np.asarray(jlm.layer_windows(jcfg)).tolist()
    assert not lm.supports_chunked_prefill(cfg)
    lm.require_full_forward(cfg)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def _batch(seed, b=2, s=48):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_logits_match_reference(model, backend):
    """Sequence 48 over a window of 32: the windowed layers drop keys; the
    SSD through the reference's XLA oracle and its Pallas programs in
    interpret mode."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, _ = _batch(0)
    jcfg = dataclasses.replace(jcfg, kernel_backend=backend)
    want, _ = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    got, aux = lm.forward(params, cfg, _t(tokens))
    assert got.shape == (2, 48, cfg.vocab_size) and float(aux) == 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_every_gradient_match_reference(model):
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, labels = _batch(1)

    def jloss(p):
        return jlm.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           remat=True)

    (jv, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    flat = _flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = lm.loss_fn(params, cfg, _t(tokens), _t(labels), remat=True)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jv), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(flat)
    assert "layers/norm_m" in flat and "layers/attn/wq" in flat
    for key, g in zip(flat, grads):
        want = jflat[key]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# paged decode with the recurrent state
# ---------------------------------------------------------------------------

SLOT_PAGES = 4  # max_len 64 of pages of 16


def _paged_pair(jcfg, cfg, b=2, num_blocks=9, seed=0):
    """Both packages' paged caches over one block table: slot i holds pages
    drawn from a permutation of 1..num_blocks - 1."""
    perm = np.random.default_rng(seed).permutation(num_blocks - 1) + 1
    tables = perm[:b * SLOT_PAGES].reshape(b, SLOT_PAGES).astype(np.int32)
    cj = jlm.init_cache(jcfg, b, 64, layout="paged", page_size=16,
                        num_blocks=num_blocks).with_tables(jnp.asarray(tables))
    ct = lm.init_cache(cfg, b, 64, page_size=16, num_blocks=num_blocks,
                       device="cpu").with_tables(_t(tables))
    return cj, ct


def _ref_leaf(cj, group, name):
    """The reference's per-layer leaf ``group/name`` stacked over layers."""
    return np.stack([np.asarray(c[group][name]) for c in cj.rest])


def test_paged_decode_logits_pools_and_state_match_reference(model):
    """Two slots, 40 steps (past the window of 32): slot 1 parks (``live``
    False) for steps 10-14, then restarts a new sequence at ``pos == 0``
    at step 25 (its state zeroed by the mask, its pages overwritten).
    Logits, every page pool and every layer's ssm/conv rows after each
    step."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    cj, ct = _paged_pair(jcfg, cfg)
    assert not cj.stacked and sorted(ct.kv) == ["conv", "k_pages", "ssm", "v_pages"]
    step_j = jax.jit(lambda p, c, t, s, l: jlm.decode_step(p, jcfg, c, t, s, live=l))
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 40)).astype(np.int32)
    pos = np.zeros(2, np.int32)
    for t in range(40):
        live = np.array([True, not 10 <= t < 15])
        if t == 25:
            pos[1] = 0
        jlog, cj = step_j(jparams, cj, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                          jnp.asarray(live))
        got, ct = lm.decode_step(params, cfg, ct, _t(toks[:, t]), _t(pos),
                                 live=_t(live))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"step {t}")
        for group, name in (("ssm", "ssm"), ("ssm", "conv"), ("kv", "k_pages"),
                            ("kv", "v_pages")):
            np.testing.assert_allclose(ct.kv[name].numpy(), _ref_leaf(cj, group, name),
                                       **TOL, err_msg=f"{name} after step {t}")
        pos += live
    assert pos.tolist() == [40, 15]


def test_decode_matches_forward_within_the_port(model):
    """The paged decode (attention over pages, the recurrence) against the
    full forward (the plain attention, the SSD), token by token over 48
    positions, at the reference's 5e-3 (test_models.py:200)."""
    _, cfg, _, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    toks = _t(np.random.default_rng(6).integers(0, 256, size=(2, 48)).astype(np.int32))
    full, _ = lm.forward(params, cfg, toks)
    cache = lm.init_cache(cfg, 2, 64, page_size=16, num_blocks=9, device="cpu")
    cache = cache.with_tables(torch.arange(1, 9, dtype=torch.int32).reshape(2, 4))
    live = torch.ones(2, dtype=torch.bool)
    for t in range(48):
        step, cache = lm.decode_step(params, cfg, cache, toks[:, t],
                                     torch.full((2,), t, dtype=torch.int32), live=live)
        np.testing.assert_allclose(step.numpy(), full[:, t].numpy(), atol=5e-3,
                                   err_msg=f"position {t}")


def test_int8_pages_decode_within_quantized_tolerance_a_step(model):
    """int8 KV pages, two slots, 40 steps: each step's logits within 2e-3 of
    the reference's, from one state (the port's pools, scales and
    recurrent rows take the reference's after every step); the packed
    codes within one code, at most two apart a step."""
    jcfg, cfg, jparams, tree = model
    jcfg, cfg = (dataclasses.replace(c, kv_dtype="int8") for c in (jcfg, cfg))
    params = params_from_numpy(tree, cfg, device="cpu")
    cj, ct = _paged_pair(jcfg, cfg, seed=1)
    assert sorted(ct.kv) == ["conv", "k_pages", "k_scale_pages", "ssm",
                             "v_pages", "v_scale_pages"]
    step_j = jax.jit(lambda p, c, t, s, l: jlm.decode_step(p, jcfg, c, t, s, live=l))
    toks = np.random.default_rng(7).integers(0, 256, size=(2, 40)).astype(np.int32)
    live = np.ones(2, bool)
    for t in range(40):
        pos = np.full(2, t, np.int32)
        jlog, cj = step_j(jparams, cj, jnp.asarray(toks[:, t]), jnp.asarray(pos),
                          jnp.asarray(live))
        got, ct = lm.decode_step(params, cfg, ct, _t(toks[:, t]), _t(pos),
                                 live=_t(live))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), rtol=1e-4,
                                   atol=2e-3, err_msg=f"step {t}")
        apart = 0
        for name, leaf in ct.kv.items():
            want = _ref_leaf(cj, "ssm" if name in ("ssm", "conv") else "kv", name)
            if name in ("k_pages", "v_pages"):
                diff = (leaf.int() - _t(want).int())[:, :, 1:]
                assert diff.abs().max().item() <= 1, name
                apart += int((diff != 0).sum())
            leaf.copy_(_t(want))
        assert apart <= 2, apart


def test_copy_pages_copies_pools_and_leaves_the_state():
    _, cfg = _configs()
    cache = lm.init_cache(cfg, 2, 32, page_size=4, num_blocks=6, device="cpu")
    for leaf in cache.kv.values():
        leaf.copy_(torch.randn(leaf.shape))
    before = {k: v.clone() for k, v in cache.kv.items()}
    assert lm.copy_pages(cache, [1, 2], [4, 5]) is cache
    for k in ("k_pages", "v_pages"):
        v = cache.kv[k]
        assert torch.equal(v[:, :, 4], before[k][:, :, 1])
        assert torch.equal(v[:, :, 5], before[k][:, :, 2])
        assert torch.equal(v[:, :, :4], before[k][:, :, :4])
    for k in ("ssm", "conv"):
        assert torch.equal(cache.kv[k], before[k])


def test_cache_layout_and_bytes_follow_the_reference():
    jcfg, cfg = _configs()
    cache = lm.init_cache(cfg, 3, 64, page_size=16, num_blocks=11, device="cpu")
    sm = cfg.ssm
    nh, conv_dim = sm.num_heads(cfg.d_model), sm.d_inner(cfg.d_model) + 2 * sm.state_dim
    assert tuple(cache.kv["ssm"].shape) == (LAYERS, 3, nh, sm.state_dim, sm.head_dim)
    assert tuple(cache.kv["conv"].shape) == (LAYERS, 3, sm.conv_width - 1, conv_dim)
    assert cache.kv["ssm"].dtype == torch.float32 and cache.num_pages == 11
    jc = jlm.init_cache(jcfg, 3, 64, layout="paged", page_size=16, num_blocks=11)
    assert cache.kv_bytes() == jc.kv_bytes()
    # the contiguous layout (item 4, once a raise): ring strips of the
    # window on the windowed layers, max_len strips on the global ones,
    # the state beside them, the reference's bytes
    strips = lm.init_cache(cfg, 3, 64, layout="contiguous", device="cpu")
    sizes = [k.shape[2] for k in strips.kv["k"]]
    want = [64 if w is None else min(64, w) for w in lm.static_windows(cfg)]
    assert sizes == want and len(set(sizes)) == 2
    assert tuple(strips.kv["ssm"].shape) == tuple(cache.kv["ssm"].shape)
    assert strips.kv_bytes() == jlm.init_cache(jcfg, 3, 64).kv_bytes()


# ---------------------------------------------------------------------------
# the serving engine: paged cache, replayed prompts
# ---------------------------------------------------------------------------


def _prompts(seed=0, n=5):
    """Prompts of 5-40 tokens: the longer ones run past the window of 32."""
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(k)).tolist()
            for k in rng.integers(5, 41, size=n)]


BASE = dict(slots=2, max_len=64, max_new_tokens=6, page_size=16)


def _run(cfg, params, prompts, engine_cls=ServingEngine, scfg_cls=ServeConfig, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**{**BASE, **kw}), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


@pytest.mark.parametrize("sync", [1, 4])
def test_engine_schedule_and_tokens_match_reference(model, sync):
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(1)
    assert max(map(len, prompts)) > 32
    out, rq, ours = _run(cfg, params, prompts, sync_every=sync)
    jout, rj, theirs = _run(jcfg, jparams, prompts, JServingEngine, JServeConfig,
                            sync_every=sync)
    assert ours.pool is not None and ours.prefix is None
    assert ours.prefill_mode == theirs.prefill_mode == "replay"
    assert ours.steps_run == theirs.steps_run
    assert ours.dispatches == theirs.dispatches
    assert ours.decode_windows == theirs.decode_windows
    assert (ours.decode_windows > 0) == (sync > 1)
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert out == jout
    assert ours.kv_cache_bytes() == theirs.kv_cache_bytes()
    assert ours.pool.page_bytes == theirs.pool.page_bytes
    assert ours.pool.in_use == 0


def test_outputs_byte_identical_across_sync_every(model):
    _, cfg, _, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(2, n=4)
    base, _, _ = _run(cfg, params, prompts)
    assert any(len(set(o)) > 1 for o in base)
    out, _, eng = _run(cfg, params, prompts, sync_every=4)
    assert out == base and eng.decode_windows > 0


def test_tight_pool_preempts_losslessly_as_the_reference(model):
    """Four 8-token pages for two requests that each grow to four: the pool
    preempts, and the preempted request resumes by recompute from position
    0 (the ``pos == 0`` mask zeroes its slot's state): its output equals a
    run alone, and the engine preempts on the reference's ticks."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    rng = np.random.default_rng(3)
    p1, p2 = (rng.integers(0, 256, size=14).tolist() for _ in range(2))
    small = dict(max_len=32, max_new_tokens=12, page_size=8)
    alone = [_run(cfg, params, [p], slots=1, **small)[0][0] for p in (p1, p2)]
    out, reqs, eng = _run(cfg, params, [p1, p2], num_blocks=5, **small)
    jout, jreqs, theirs = _run(jcfg, jparams, [p1, p2], JServingEngine, JServeConfig,
                               num_blocks=5, **small)
    assert eng.preemptions >= 1 and eng.preemptions == theirs.preemptions
    assert out == alone == jout
    assert eng.steps_run == theirs.steps_run
    assert [r.preemptions for r in reqs] == [r.preemptions for r in jreqs]
    assert eng.pool.in_use == 0


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_and_serve_clis_run_hymba_on_the_cpu(tmp_path, capsys):
    res = train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                      "--batch", "2", "--seq", "48", "--log-every", "2",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["steps"] == 4 and np.isfinite(res["last_metrics"]["loss"].item())
    assert "done: 4 steps" in out and "kernel launches on cpu: none" in out
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--prompt-len", "36", "--sync-every", "4"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    assert "paged cache" in out and "[replay prefill]" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's hybrid checks, rehearsed with CPU tensors
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_hybrid_kernel_checks_rehearse_on_the_cpu():
    """The decode shapes phase 2 checks are hymba's (its serving run's:
    the engine's slots and tokens a slot, its heads and head dim; and
    slots of 2048 tokens, where a window of 1024 drops whole splits); the
    decode check at hymba's group of 5 and head dim 64 (fewer tokens a
    slot) with a window that drops whole splits, its bf16 controls and the
    merge without the rescale; the SSD check on a full-width hymba layer's
    operands at a short sequence (CUDA cores expected: no tensor-core
    launch)."""
    from repro_torch.kernels import chunk_scan as CSC
    from repro_torch.kernels import chunk_state as CST
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    cfg = tconfigs.get_config(ARCH)
    serve_shape = cs.HYMBA_SERVE_DECODE
    assert (serve_shape.slots, serve_shape.max_len) == (cs.SLOTS, cs.MAX_LEN)
    assert (serve_shape.hq, serve_shape.hkv, serve_shape.d) == (
        cfg.num_heads, cfg.num_kv_heads, cfg.head_dim)
    assert cs.HYMBA_DECODE == serve_shape._replace(max_len=2048)
    assert cs.HYMBA_WINDOW == cfg.sliding_window
    splits, keys = cs.decode_grid(torch, PA, cpu, cs.HYMBA_DECODE)
    assert keys <= cs.HYMBA_WINDOW < splits * keys
    shape = cs.HYMBA_DECODE._replace(max_len=256)
    splits, keys = cs.decode_grid(torch, PA, cpu, shape)
    assert splits > 1 and keys <= 128
    for window in (128, None):
        r = cs.check_decode(torch, np, ref, PA, torch.float32, window, None, False, cpu,
                            shape=shape)
        assert r["err"] == 0.0 and cs.kernel_ok(r), r
        r = cs.check_decode(torch, np, ref, PA, torch.bfloat16, window, None, False, cpu,
                            shape=shape)
        assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    case = ("hymba", cs.HYBRID_ARCH, 1, 48, "deep")
    assert not cs.ssd_takes_tensor_cores(cs.HYMBA_SSD_CASE, "bfloat16")
    for dtype in (torch.float32, torch.bfloat16):
        rs = cs.check_ssd_case(torch, np, ref, (CST, CSC), dtype, case, None, False, cpu)
        assert all(r["err"] == 0.0 for r in rs.values()), rs


def test_chip_smoke_hybrid_phase_rehearses_on_the_cpu(monkeypatch):
    """chip_smoke.py's phase 7 at reduced widths, with CPU tensors: the two
    serving runs (replayed prompts over the paged cache, the window
    byte-identical with fewer dispatches, no kernel launched here) on
    prompts of 20-60 tokens in place of the workload's 100-600 (a replayed
    prompt costs a tick a token), the window check at depth 4 over 8
    tokens past a window of 32 with a parked slot (bf16 and fp32; the fp32
    run within its limit, which its reading against a forward with no
    window exceeds), and the depth-2 training comparison, each planted SSD
    fault failing the mamba gradient cosine."""
    from repro_torch.kernels.ops import KERNELS

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    monkeypatch.setattr(cs, "workload", lambda rng, vocab: [
        rng.integers(0, vocab, size=int(n)).tolist() for n in rng.integers(20, 61, size=16)])
    cfg = tconfigs.get_config(ARCH).reduced()  # 2 layers, as the depth-2 check
    runs = cs.hybrid_serving_phase(torch, np, lm, cfg, lm.init(cfg, 0, device="cpu"),
                                   KERNELS, cpu)
    assert len(runs) == 2 and lm.decode_loop.__name__ == "decode_loop"
    assert all(n == 0 for run in runs.values() for n in run[3].values())
    cfg4 = dataclasses.replace(cfg, num_layers=cs.HYBRID_WINDOW_LAYERS, dtype="bfloat16")
    assert lm.static_windows(cfg4) == [None, 32, None, None]
    r, held, launches, tc = cs.hybrid_window_check(
        torch, np, lm, cfg4, cpu, seq=40, read=(range(0, 8), range(32, 40)))
    assert cs.hybrid_window_ok(r) and held and launches == tc == {}, r
    assert r["bf16"]["steps"] == r["fp32"]["steps"] == 16
    assert r["fp32, no window"]["steps"] == 8
    # the control: read against a forward with no window, the fp32 decode
    # fails the fp32 limit, so a decode that ignored the window would too
    assert not cs.hybrid_window_ok(dict(r, fp32=r["fp32, no window"])), r
    r = cs.train_card_vs_cpu(torch, np, lm, dataclasses.replace(cfg, dtype="bfloat16"),
                             cpu, seq=64)
    faults = {f"fault: {f}" for f in cs.SSM_FAULTS}
    assert set(r) == {"card bf16", "card bf16, plain SSD", "cpu fp32", "cosines"} | faults
    assert cs.train_card_vs_cpu_ok(r), r
    for label in faults:
        assert "mamba grad cosine" in cs.train_limits_failed(r, label), (label, r)
