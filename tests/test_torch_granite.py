"""The port's GQA + MoE family (granite-moe-3b-a800m: GQA attention and a
40-expert top-8 MoE in every block, tied embeddings, no dense FFN), held
against the JAX package on the CPU: the parameter tree, the forward with
its capacity drops, the MoE auxiliary loss, the loss and every gradient,
the serving engine (chunked prefill, fp and int8 pages, the window) and the
CLIs.

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; every other input is a
numpy array made from a seed and handed to both sides.  Reduced
``granite_moe_3b_a800m``: fp32, 2 layers, d 64, 4 query heads over 2 KV
heads of 16, 4 experts top-2 of width 32, vocab 256.

Tolerances: logits, the aux loss, the loss and every gradient leaf at 1e-4
(of the leaf's largest element for gradients: fp32 through two layers and
their backward, as tests/test_torch_hybrid.py).  The tied embedding is
scaled by 0.1 in both packages' parameters, so greedy streams vary.  Engine
schedules (ticks, TTFT ticks, preemptions, windows) and token streams are
equal exactly.
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
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "granite_moe_3b_a800m"
EMBED_SCALE = 0.1


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The module's CPU work is thousands of small ops on reduced models:
    one intra-op thread runs them as fast, and keeps them from slowing
    down under a loaded machine (as tests/test_torch_hybrid.py); the
    setting is restored for the modules that follow in the process."""
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
    """The reference's parameters, with the tied N(0, 1) embedding scaled by
    EMBED_SCALE in both packages: at full scale each token's own logit
    dwarfs the rest and every greedy stream repeats one token."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = tconfigs.get_config(ARCH).reduced()
    tree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    tree["embed"]["embedding"] = tree["embed"]["embedding"] * EMBED_SCALE
    return jcfg, cfg, jax.tree.map(jnp.asarray, tree), tree


def _batch(seed, b=2, s=24):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, 256, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1
    return tokens, labels


def test_tree_shapes_and_leaf_dtypes_match_reference():
    """No prefix layers, no shared experts, no dense MLP, tied embeddings;
    the router fp32 in bf16, as the reference's."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(), dtype="bfloat16")
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), dtype="bfloat16")
    jtree = jax.tree.map(np.asarray, jlm.init(jcfg, jax.random.PRNGKey(0)))
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(jtree).items()}
    assert want["layers/moe/router"][1] == "float32"
    assert not any(k.startswith(("prefix_layers", "layers/mlp", "layers/moe/shared",
                                 "embed/unembed")) for k in want)
    for tree in (lm.init(cfg, 0, device="cpu"),
                 params_from_numpy(jtree, cfg, device="cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(tree).items()}
        assert got == want


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_forward_logits_and_aux_match_reference_with_drops(model, backend):
    """Batch 2 x 24: 16 dispatch groups of 3 tokens, capacity 1, so experts
    drop (checked from the recorded routing); attention through the
    reference's XLA oracle and its Pallas flash kernel in interpret mode."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, _ = _batch(0)
    want, jaux = jlm.forward(jparams, dataclasses.replace(jcfg, kernel_backend=backend),
                             jnp.asarray(tokens))
    picks, top_k = [], L.top_k
    try:
        L.top_k = lambda x, k: picks.append(top_k(x, k)[1]) or top_k(x, k)
        got, aux = lm.forward(params, cfg, _t(tokens))
    finally:
        L.top_k = top_k
    g, tg = L._moe_groups(48, 2), 48 // L._moe_groups(48, 2)
    cap = max(1, int(cfg.moe.capacity_factor * tg * cfg.moe.experts_per_token
                     / cfg.moe.num_experts))
    assert len(picks) == cfg.num_layers and cap == 1
    per_expert = [torch.bincount(idx.reshape(g, -1)[i], minlength=cfg.moe.num_experts)
                  for idx in picks for i in range(g)]
    assert max(int(c.max()) for c in per_expert) > cap  # some choices dropped
    assert float(aux) > 0.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(jaux), **TOL)


@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_aux_and_every_gradient_match_reference(model, logits_chunk):
    """``ce + aux`` and its gradient through the router, the renormalised
    gates and the expert weights (the dispatch positions carry none), with
    the per-layer recompute; streamed logits too."""
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
    assert parts["aux"].item() > 0
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(flat) and "layers/moe/router" in flat
    for key, g in zip(flat, grads):
        want = jflat[key]
        assert np.abs(want).max() > 0, key
        scale = np.abs(want).max()
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


# ---------------------------------------------------------------------------
# the serving engine: paged cache, chunked prefill, MoE capacity per batch
# ---------------------------------------------------------------------------


def _prompts(seed=0, n=6):
    """Prompts of 5-40 tokens, two sharing an 8-token prefix."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, 256, size=int(k)).tolist()
               for k in rng.integers(5, 41, size=n)]
    prompts[1] = prompts[0][:8] + prompts[1]
    return prompts


BASE = dict(slots=2, max_len=64, max_new_tokens=6, page_size=8)


def _run(cfg, params, prompts, engine_cls=ServingEngine, scfg_cls=ServeConfig, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**{**BASE, **kw}), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return [r.output for r in reqs], reqs, eng


@pytest.mark.parametrize("kv_dtype,sync,blocks", [
    (None, 1, None), ("int8", 1, None), (None, 4, None), (None, 1, 7)],
    ids=["fp", "int8", "fp-window", "fp-tight-pool"])
def test_engine_tokens_and_schedule_match_reference(model, kv_dtype, sync, blocks):
    """Token streams equal the reference engine's exactly, and so do ticks,
    TTFT ticks, preemptions, shared pages and dispatches: the MoE's
    capacity drops, which depend on each step's batch shape (decode at the
    slots, prefill chunks), are the reference's."""
    jcfg, cfg, jparams, tree = model
    jcfg, cfg = (dataclasses.replace(c, kv_dtype=kv_dtype) for c in (jcfg, cfg))
    params = params_from_numpy(tree, cfg, device="cpu")
    prompts = _prompts(1)
    kw = dict(sync_every=sync, num_blocks=blocks)
    out, rq, ours = _run(cfg, params, prompts, **kw)
    jout, rj, theirs = _run(jcfg, jparams, prompts, JServingEngine, JServeConfig, **kw)
    assert ours.prefill_mode == theirs.prefill_mode == "chunked"
    assert ours.steps_run == theirs.steps_run
    assert ours.dispatches == theirs.dispatches
    assert ours.decode_windows == theirs.decode_windows
    assert (ours.decode_windows > 0) == (sync > 1)
    assert ours.preemptions == theirs.preemptions
    assert (ours.preemptions > 0) == (blocks is not None)
    assert ours.pages_shared == theirs.pages_shared
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert out == jout and any(len(set(o)) > 1 for o in out)
    assert ours.kv_cache_bytes() == theirs.kv_cache_bytes()
    assert ours.pool.in_use == theirs.pool.in_use


# ---------------------------------------------------------------------------
# the CLIs
# ---------------------------------------------------------------------------


def test_train_and_serve_clis_run_granite_on_the_cpu(tmp_path, capsys):
    res = train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                      "--batch", "2", "--seq", "16", "--log-every", "2",
                      "--failure-prob", "0.3",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    m = res["last_metrics"]
    assert res["steps"] == 4 and res["restarts"] > 0
    assert np.isfinite(m["loss"].item()) and m["aux"].item() > 0
    assert abs(m["loss"].item() - m["ce"].item() - m["aux"].item()) < 1e-5
    assert "done: 4 steps" in out and "kernel launches on cpu: none" in out
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    assert "paged cache" in out and "[chunked prefill]" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's granite checks, rehearsed with CPU tensors
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_granite_checks_rehearse_on_the_cpu(monkeypatch):
    """Phase 2's granite shapes (its heads and head dim; the chunked
    prefill and its int8 twin at the serving run's 8 slots of 1024, the
    decodes at fewer tokens a slot; the flash kernel's causal case at a
    short sequence), bf16 on the plain path with the controls failing;
    phase 8's two serving runs on a reduced model and shorter prompts (no
    kernel launched here), and its teacher-forced check at depth 4, the
    CPU's fp32 run on the bf16 run's replayed routing holding every step
    to the limits."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_attention_quant as PAQ
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import prefill_attention_quant as PFQ
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import KERNELS

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    full = tconfigs.get_config(ARCH)
    shape = cs.GRANITE_DECODE
    assert (shape.hq, shape.hkv, shape.d) == (full.num_heads, full.num_kv_heads,
                                              full.head_dim)
    assert PF.tensor_core_path(torch.bfloat16, shape.d, cs.PAGE, shape.hq // shape.hkv,
                               shape.max_len // cs.PAGE, cs.CHUNK)
    short = shape._replace(max_len=256)
    for check, mod, fmt, at in ((cs.check_decode, PA, None, short),
                                (cs.check_prefill, PF, None, shape),
                                (cs.check_decode, PAQ, "int8", short),
                                (cs.check_prefill, PFQ, "int8", shape)):
        r = check(torch, np, ref, mod, torch.bfloat16, None, None, False, cpu, fmt=fmt,
                  shape=at)
        assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    case = next(c for c in cs.FLASH_CASES if c[0] == "granite train")
    assert case[2:4] + case[6:] == (full.num_heads, full.num_kv_heads, 64, True)
    r = cs.check_flash(torch, np, ref, FA, torch.bfloat16,
                       case[:1] + (1,) + case[2:4] + (96, 96) + case[6:], None, False, cpu)
    assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    # the serving runs on prompts of 20-60 tokens, every other one behind a
    # shared 16-token prefix, in place of the workload's 100-600 and 256
    full_workload = cs.workload
    monkeypatch.setattr(cs, "workload", lambda rng, vocab: [
        p[:int(n)] for p, n in zip(full_workload(rng, vocab, shared_len=16),
                                   rng.integers(20, 61, size=16))])
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), num_layers=1)
    runs = cs.granite_serving_phase(torch, np, lm, cfg, lm.init(cfg, 0, device="cpu"),
                                    KERNELS, cpu)
    assert set(runs) == {"fp, default pool", "int8, default pool"}
    assert all(n == 0 for run in runs.values() for n in run[3].values())
    for kv_dtype in (None, "int8"):
        cfg4 = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), num_layers=4,
                                   dtype="bfloat16", kv_dtype=kv_dtype)
        own, shared = cs.teacher_forced(torch, np, lm, cfg4, cpu, shared_routing=True)
        assert shared["route_share"] == 1.0 and shared["agree_steps"] == shared["steps"]
        assert cs.teacher_forced_ok(shared), shared
        assert own["steps"] == shared["steps"] == 10
