"""The port's Mamba-2 SSM family (mamba2-2.7B), held against the JAX package
on the CPU: the SSD's plain pieces, the reduced model's forward, loss,
gradients, AdamW steps and decode, the serving engine's contiguous mode,
and the training and serving CLIs.

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; every other input is a
numpy array made from a seed and handed to both sides.  Reduced
``mamba2_2_7b``: fp32, 2 layers, d 64, 8 SSM heads of P 16, state N 16,
chunk 16, vocab 256.

Tolerances: the plain SSD pieces against the reference's Pallas programs in
interpret mode and its XLA oracle at 1e-5 of max(1, the largest reference
element) (fp32, sums in another order); logits, the loss and every gradient
leaf at 1e-4 (relative to the leaf's largest element: fp32 through two
layers and their backward); three AdamW steps at 1e-6 (the same fp32
arithmetic); decode logits and state at 1e-4; the port's forward against
its own decode at the reference's 5e-3 (test_models.py:112).  Engine
schedules (ticks, TTFT ticks, windows) and token streams are equal exactly.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.core import Schedule
from repro.core import compile as tl_compile
from repro.kernels import linear_attention as jla
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch import configs as tconfigs
from repro_torch import optim
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.kernels import chunk_scan as CSC
from repro_torch.kernels import chunk_state as CST
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve, train
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)
ARCH = "mamba2_2_7b"


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _close_scaled(got, want, tol=1e-5):
    """max |got - want| <= tol * max(1, max |want|)."""
    want = np.asarray(want, np.float64)
    err = np.abs(np.asarray(got, np.float64) - want).max()
    assert err <= tol * max(1.0, np.abs(want).max()), err


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
    """Reduced mamba2-2.7B in both packages, from the reference's init."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = tconfigs.get_config(ARCH).reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree


# ---------------------------------------------------------------------------
# the SSD's plain pieces against the Pallas programs and the XLA oracle
# ---------------------------------------------------------------------------


def _ssd_inputs(rng, b, c, l, n, p):
    f = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    da = np.cumsum(np.abs(f(b, c, l)) * 0.1, axis=-1).astype(np.float32)
    return f(b, c, l, n), f(b, c, l, n), f(b, c, l, p), da, f(b, c, n, p)


SSD_SHAPES = [(cfg["batch"], cfg["nchunks"], cfg["chunk_l"], cfg["dstate"],
               cfg["headdim"]) for _, (_, cfg) in jla.PARITY_CASES]
SSD_SHAPES += [(2, 4, 32, 16, 32), (2, 3, 64, 32, 64)]  # test_kernels.py:367


@pytest.mark.parametrize("shape", SSD_SHAPES, ids=[str(s) for s in SSD_SHAPES])
def test_plain_chunk_state_and_scan_match_pallas_and_xla(shape):
    b, c, l, n, p = shape
    cm, bm, x, da, prev = _ssd_inputs(np.random.default_rng(7), *shape)
    kst = tl_compile(jla.chunk_state_program(b, c, l, n, p), Schedule(interpret=True))
    ksc = tl_compile(jla.chunk_scan_program(b, c, l, n, p), Schedule(interpret=True))
    st = ref.chunk_state(_t(bm), _t(x), _t(da))
    assert st.dtype == torch.float32
    _close_scaled(st, kst(bm, x, da))
    _close_scaled(st, jref.chunk_state(bm, x, da))
    y = ref.chunk_scan(_t(cm), _t(bm), _t(x), _t(da), _t(prev))
    _close_scaled(y, ksc(cm, bm, x, da, prev))
    _close_scaled(y, jref.chunk_scan(cm, bm, x, da, prev))


def test_plain_chunk_scan_selects_before_the_exp():
    """A steep decay (dA falling 20 a step) makes dA_l - dA_m large and
    positive above the diagonal, where exp overflows to inf; the select
    before the exp keeps every output finite."""
    cm, bm, x, da, prev = _ssd_inputs(np.random.default_rng(1), 1, 2, 16, 8, 8)
    da = np.cumsum(np.full((1, 2, 16), -20.0, np.float32), axis=-1)
    y = ref.chunk_scan(_t(cm), _t(bm), _t(x), _t(da), _t(prev))
    assert torch.isfinite(y).all()
    _close_scaled(y, jref.chunk_scan(cm, bm, x, da, prev))


def test_plain_cumsum_recurrence_and_ssd_match_reference():
    rng = np.random.default_rng(2)
    states = rng.standard_normal((2, 5, 8, 16), dtype=np.float32)
    dchunk = -np.abs(rng.standard_normal((2, 5), dtype=np.float32))
    _close_scaled(ref.state_recurrence(_t(states), _t(dchunk)),
                  jref.state_recurrence(states, dchunk))
    dt3 = np.abs(rng.standard_normal((2, 4, 16), dtype=np.float32))
    a_log = rng.standard_normal(4).astype(np.float32)
    for got, want in zip(ref.chunk_cumsum(_t(dt3), _t(a_log)),
                         jref.chunk_cumsum(dt3, a_log)):
        _close_scaled(got, want)
    bz, s, n, p, chunk = 2, 128, 16, 32, 32  # test_kernels.py:396
    c = rng.standard_normal((bz, s, n), dtype=np.float32)
    bm = rng.standard_normal((bz, s, n), dtype=np.float32)
    x = rng.standard_normal((bz, s, p), dtype=np.float32)
    dt = np.abs(rng.standard_normal((bz, s), dtype=np.float32)) * 0.1
    want = jref.ssd(c, bm, x, dt, np.float32(0.5), chunk=chunk)
    for fn in (ref.ssd, lambda *a, chunk: ops.ssd(*a, chunk=chunk)):
        got = fn(_t(c), _t(bm), _t(x), _t(dt), 0.5, chunk=chunk)
        _close_scaled(got, want)
    _close_scaled(ref.ssd(_t(c), _t(bm), _t(x), _t(dt), 0.5, chunk=chunk),
                  jops.ssd(c, bm, x, dt, np.float32(0.5), chunk=chunk,
                           backend="pallas"))


def test_plain_ssd_matches_naive_recurrence():
    """The chunked SSD equals the per-step recurrence h_t = exp(dA_t)
    h_{t-1} + B_t^T x_t, y_t = C_t h_t (test_kernels.py:406)."""
    rng = np.random.default_rng(0)
    bz, s, n, p, chunk = 1, 64, 8, 16, 16
    c = rng.standard_normal((bz, s, n), dtype=np.float32) * 0.5
    bm = rng.standard_normal((bz, s, n), dtype=np.float32) * 0.5
    x = rng.standard_normal((bz, s, p), dtype=np.float32)
    dt = np.abs(rng.standard_normal((bz, s), dtype=np.float32)) * 0.1
    y = ref.ssd(_t(c), _t(bm), _t(x), _t(dt), 0.3, chunk=chunk).numpy()
    da = dt * (-np.exp(np.float32(0.3)))
    h = np.zeros((bz, n, p), np.float32)
    for t in range(s):
        h = np.exp(da[:, t])[:, None, None] * h + np.einsum("bn,bp->bnp", bm[:, t], x[:, t])
        np.testing.assert_allclose(y[:, t], np.einsum("bn,bnp->bp", c[:, t], h), atol=2e-2)


def test_autograd_functions_give_plain_autograds_gradients():
    """``ChunkStateFn``/``ChunkScanFn`` (the kernel forward, the plain
    version recomputed for the backward) against autograd through the plain
    versions, on the (B, H, ...) layout with head-broadcast (expanded) B and
    C; on the CPU neither launches a kernel."""
    rng = np.random.default_rng(3)
    b, h, c, l, n, p = 2, 3, 2, 16, 8, 4
    f = lambda *s: torch.as_tensor(rng.standard_normal(s, dtype=np.float32))  # noqa: E731
    base = [f(b, 1, c, l, n), f(b, 1, c, l, n), f(b, h, c, l, p),
            -torch.cumsum(f(b, h, c, l).abs(), -1), f(b, h, c, n, p)]
    douts = (f(b, h, c, n, p), f(b, h, c, l, p))
    grads = []
    for st_fn, sc_fn in ((CST.ChunkStateFn.apply, CSC.ChunkScanFn.apply),
                         (ref.chunk_state, ref.chunk_scan)):
        leaves = [t.clone().requires_grad_(True) for t in base]
        cm, bm = (t.expand(b, h, c, l, n) for t in leaves[:2])
        x, da, prev = leaves[2:]
        n0 = (CST.KERNEL.launches, CSC.KERNEL.launches)
        outs = (st_fn(bm, x, da), sc_fn(cm, bm, x, da, prev))
        assert (CST.KERNEL.launches, CSC.KERNEL.launches) == n0
        grads.append(torch.autograd.grad(outs, leaves, douts))
    for got, want in zip(*grads):
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def test_wrappers_take_the_plain_version_on_the_cpu_only():
    rng = np.random.default_rng(4)
    cm, bm, x, da, prev = (_t(a) for a in _ssd_inputs(rng, 2, 2, 16, 8, 8))
    assert torch.equal(CST.chunk_state(bm, x, da), ref.chunk_state(bm, x, da))
    assert torch.equal(CSC.chunk_scan(cm, bm, x, da, prev),
                       ref.chunk_scan(cm, bm, x, da, prev))
    assert ops.KERNELS["chunk_state"] is CST.KERNEL
    assert ops.KERNELS["chunk_scan"] is CSC.KERNEL
    for k in (CST.KERNEL, CSC.KERNEL):
        assert k.source.name == "linear_attention.cu" and k.source.exists()
    assert CST.KERNEL.replaces == "src/repro/kernels/linear_attention.py:21"
    assert CSC.KERNEL.replaces == "src/repro/kernels/linear_attention.py:58"


# ---------------------------------------------------------------------------
# the reduced model: forward, loss, gradients, AdamW
# ---------------------------------------------------------------------------


def _batch(seed, b=2, s=48, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


@pytest.mark.parametrize("backend,seq", [("xla", 48), ("pallas", 48), ("xla", 24)])
def test_forward_logits_match_reference(model, backend, seq):
    """Three chunks of 16, through the reference's XLA oracle and its Pallas
    programs in interpret mode; and a sequence of 24, which 16 does not
    divide (the chunk falls to gcd(24, 16) = 8)."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, _ = _batch(0, s=seq)
    jcfg = dataclasses.replace(jcfg, kernel_backend=backend)
    want, _ = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    got, aux = lm.forward(params, cfg, _t(tokens))
    assert got.shape == (2, seq, cfg.vocab_size) and float(aux) == 0.0
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
    assert any("a_log" in k for k in flat) and any("dt_bias" in k for k in flat)
    for key, g in zip(flat, grads):
        want = jflat[key]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


def test_adamw_three_steps_match_reference(model):
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    acfg = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5)
    jstate = joptim.init_opt_state(jparams)
    state = optim.init_opt_state(params)
    rng = np.random.default_rng(4)
    jp = jparams
    for _ in range(3):
        gtree = jax.tree.map(
            lambda x: (3.0 * rng.standard_normal(x.shape)).astype(np.float32), tree)
        jp, jstate, _ = joptim.adamw_update(jp, gtree, jstate, joptim.AdamWConfig(**acfg))
        grads = params_from_numpy(gtree, cfg, device="cpu")
        params, state, _ = optim.adamw_update(params, grads, state,
                                              optim.AdamWConfig(**acfg))
    want = _flat(jax.tree.map(np.asarray, {"params": jp, "opt": jstate}))
    got = _flat(tree_to_numpy({"params": params, "opt": state}))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], err_msg=key, **ADAM_TOL)


# ---------------------------------------------------------------------------
# decode over the contiguous recurrent state
# ---------------------------------------------------------------------------


def test_decode_step_logits_and_state_match_reference(model):
    """Eight steps of two slots, the second parked (``live`` False) for the
    middle two; logits and every layer's ssm/conv state after each step."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    toks = np.random.default_rng(5).integers(0, 256, size=(2, 8)).astype(np.int32)
    jcache = jlm.init_cache(jcfg, 2, 16)
    cache = lm.init_cache(cfg, 2, 16, layout="contiguous", device="cpu")
    assert cache.tables is None and cache.kv["ssm"].dtype == torch.float32
    pos = np.zeros(2, np.int32)
    for t in range(8):
        live = np.array([True, t not in (3, 4)])
        jlog, jcache = jlm.decode_step(jparams, jcfg, jcache, jnp.asarray(toks[:, t]),
                                       jnp.asarray(pos), live=jnp.asarray(live))
        got, cache = lm.decode_step(params, cfg, cache, _t(toks[:, t]), _t(pos),
                                    live=_t(live))
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), **TOL)
        for key in ("ssm", "conv"):
            want = np.stack([np.asarray(c["ssm"][key]) for c in jcache.rest]) \
                if not jcache.stacked else np.asarray(jcache.rest["ssm"][key])
            np.testing.assert_allclose(cache.kv[key].numpy(), want, **TOL)
        pos += live


def test_forward_matches_decode_within_the_port(model):
    """The SSD forward (chunk kernels' path) against the recurrence, token by
    token, at the reference's 5e-3 (test_models.py:112); 40 tokens over
    chunks of 8 (gcd(40, 16)), so the carried state matters."""
    _, cfg, _, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    toks = _t(np.random.default_rng(6).integers(0, 256, size=(1, 40)).astype(np.int32))
    full, _ = lm.forward(params, cfg, toks)
    cache = lm.init_cache(cfg, 1, 40, layout="contiguous", device="cpu")
    for t in range(40):
        step, cache = lm.decode_step(params, cfg, cache, toks[:, t], t)
        np.testing.assert_allclose(step[0].numpy(), full[0, t].numpy(), atol=5e-3,
                                   err_msg=f"position {t}")


def test_cache_layouts_follow_the_reference():
    ssm = tconfigs.get_config(ARCH).reduced()
    with pytest.raises(ValueError, match="layout='contiguous'"):
        lm.init_cache(ssm, 1, 16, layout="paged", device="cpu")
    with pytest.raises(ValueError, match="unknown cache layout"):
        lm.init_cache(ssm, 1, 16, layout="ring", device="cpu")
    cache = lm.init_cache(ssm, 3, 16, layout="contiguous", device="cpu")
    sm = ssm.ssm
    nh, conv_dim = sm.num_heads(ssm.d_model), sm.d_inner(ssm.d_model) + 2 * sm.state_dim
    assert tuple(cache.kv["ssm"].shape) == (ssm.num_layers, 3, nh, sm.state_dim, sm.head_dim)
    assert tuple(cache.kv["conv"].shape) == (ssm.num_layers, 3, sm.conv_width - 1, conv_dim)
    jc = jlm.init_cache(jconfigs.get_config(ARCH).reduced(), 3, 16)
    assert cache.kv_bytes() == jc.kv_bytes()
    # the attention models' contiguous strips (item 4, once a raise): the
    # reference's leaves and bytes, the hybrid's state beside its strips
    for arch, names in (("qwen2_1_5b", {"k", "v"}),
                        ("hymba_1_5b", {"k", "v", "ssm", "conv"})):
        cfg = tconfigs.get_config(arch).reduced()
        strips = lm.init_cache(cfg, 3, 16, layout="contiguous", device="cpu")
        assert set(strips.kv) == names and strips.tables is None
        jstrips = jlm.init_cache(jconfigs.get_config(arch).reduced(), 3, 16)
        assert strips.kv_bytes() == jstrips.kv_bytes()
    hymba = tconfigs.get_config("hymba_1_5b").reduced()  # paged KV + state
    assert set(lm.init_cache(hymba, 1, 16, device="cpu").kv) >= {"ssm", "conv"}


# ---------------------------------------------------------------------------
# the serving engine's contiguous mode
# ---------------------------------------------------------------------------


def _prompts(seed=0, n=5):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=int(k)).tolist()
            for k in rng.integers(2, 12, size=n)]


BASE = dict(slots=2, max_len=48, max_new_tokens=6, cache="contiguous")


@pytest.fixture(scope="module")
def diverse(model):
    """The port's parameters with the embedding scaled by 0.1, so greedy
    streams vary from token to token."""
    _, cfg, _, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    params["embed"] = dict(params["embed"], embedding=params["embed"]["embedding"] * 0.1)
    return cfg, params


def _run(cfg, params, prompts, engine_cls=ServingEngine, scfg_cls=ServeConfig, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**{**BASE, **kw}), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


@pytest.mark.parametrize("sync", [1, 4, 16])
def test_engine_schedule_and_tokens_match_reference(model, sync):
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(1)
    out, rq, ours = _run(cfg, params, prompts, sync_every=sync)
    jout, rj, theirs = _run(jcfg, jparams, prompts, JServingEngine, JServeConfig,
                            sync_every=sync)
    assert ours.pool is None and ours.tables is None and ours.prefix is None
    assert ours.prefill_mode == theirs.prefill_mode == "replay"
    assert ours.steps_run == theirs.steps_run
    assert ours.dispatches == theirs.dispatches
    assert ours.decode_windows == theirs.decode_windows
    assert (ours.decode_windows > 0) == (sync > 1)
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert out == jout
    assert ours.peak_kv_blocks() is None and ours.kv_cache_bytes() == theirs.kv_cache_bytes()


def test_outputs_byte_identical_across_sync_every(diverse):
    cfg, params = diverse
    prompts = _prompts(2, n=6)
    base, _, _ = _run(cfg, params, prompts)
    assert any(len(set(o)) > 1 for o in base)
    for sync in (4, 16):
        out, _, eng = _run(cfg, params, prompts, sync_every=sync)
        assert out == base and eng.decode_windows > 0


def test_outputs_do_not_depend_on_a_slots_history(diverse):
    """A request served alone equals the same request served in a slot that
    held other requests before it (pos == 0 zeroes the recurrent state), and
    one whose neighbour is parked mid-run (a dead slot holds its state)."""
    cfg, params = diverse
    prompts = _prompts(3, n=5)
    alone = [_run(cfg, params, [p], slots=1)[0][0] for p in prompts]
    for slots, sync in ((1, 1), (2, 1), (2, 8)):
        out, _, _ = _run(cfg, params, prompts, slots=slots, sync_every=sync)
        assert out == alone, (slots, sync)


def test_engine_rejects_what_the_reference_rejects(model):
    _, cfg, _, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    with pytest.raises(ValueError, match="chunked-prefill arch"):
        ServingEngine(cfg, params, ServeConfig(cache="contiguous", spec_decode="ngram"),
                      device="cpu")
    with pytest.raises(ValueError, match="layout='contiguous'"):
        ServingEngine(cfg, params, ServeConfig(cache="paged"), device="cpu")
    with pytest.raises(ValueError, match="requires cache='paged'"):
        ServeConfig(cache="contiguous", kv_dtype="int8")


# ---------------------------------------------------------------------------
# the parameter bridge's dtypes, every ported family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ["qwen2_1_5b", "deepseek_v2_lite_16b", ARCH])
def test_init_and_bridge_give_each_leaf_the_references_dtype(arch):
    """In bf16, leaf by leaf: the reference's ``lm.init``, the port's own
    ``init`` and the bridge agree on every leaf's dtype (fp32 for the
    router, a_log, d_skip and dt_bias; bf16 for the rest)."""
    jcfg = dataclasses.replace(jconfigs.get_config(arch).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(tconfigs.get_config(arch).reduced(), dtype="bfloat16")
    jtree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = {k: str(v.dtype) for k, v in _flat(jtree).items()}
    for tree in (lm.init(cfg, 0, device="cpu"), params_from_numpy(jtree, cfg, device="cpu")):
        got = {k: str(v.dtype).replace("torch.", "") for k, v in _flat(tree).items()}
        assert got == want
    assert ("float32" in want.values()) == (arch != "qwen2_1_5b")


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_and_serve_clis_run_mamba2_on_the_cpu(tmp_path, capsys):
    res = train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                      "--batch", "2", "--seq", "32", "--log-every", "2",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["steps"] == 4 and np.isfinite(res["last_metrics"]["loss"].item())
    assert "done: 4 steps" in out and "kernel launches on cpu: none" in out
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--cache",
                       "contiguous", "--requests", "3", "--slots", "2",
                       "--max-new", "4", "--sync-every", "4"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    assert "contiguous cache" in out and "[replay prefill]" in out
