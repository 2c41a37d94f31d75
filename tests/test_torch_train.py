"""The port's full-sequence forward and training path, held against the JAX
package on the CPU.

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; tokens, labels, gradients
and attention inputs are the same numpy arrays on both sides, made from a
seed.  Reduced ``qwen2_1_5b`` (fp32, 2 layers, d 64, vocab 256).

Tolerances: the plain attention against the reference's flash kernel in
Pallas interpret mode and against its XLA oracle at 1e-5 (fp32, O(1)
outputs; the sides differ in the order of fp32 sums and exp against exp2);
logits at 1e-4 and the loss and every gradient leaf at 1e-4 relative to the
leaf's largest element (fp32 through two layers, the unembedding and their
backward); three AdamW steps fed the same gradients at 1e-6 (the same fp32
arithmetic, element by element).  The data stream, the checkpoint layout and
the injected failures are equal exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro import optim as joptim
from repro.checkpoint import manager as jckpt
from repro.core import Schedule
from repro.core import compile as tl_compile
from repro.data import pipeline as jdata
from repro.distributed import fault as jfault
from repro.kernels import ref as jref
from repro.kernels.flash_attention import PARITY_CASES, flash_attention_program
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch import optim
from repro_torch.checkpoint import CheckpointManager, manager as ckpt
from repro_torch.convert import params_from_numpy, tree_to_numpy
from repro_torch.data import pipeline as data
from repro_torch.distributed import fault
from repro_torch.kernels import flash_attention as FA
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import lm

ATTN_TOL = dict(rtol=1e-5, atol=1e-5)
TOL = dict(rtol=1e-4, atol=1e-4)
ADAM_TOL = dict(rtol=1e-6, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _flat(tree, path=()):
    """{"a/b/0": leaf} over dicts (sorted keys) and lists."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], path + (str(key),)).items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree)
                for k, v in _flat(x, path + (str(i),)).items()}
    return {"/".join(path): tree}


@pytest.fixture(scope="module")
def model():
    """Reduced qwen2-1.5B in both packages, from the reference's init."""
    jcfg = jconfigs.get_config("qwen2_1_5b").reduced()
    cfg = tconfigs.get_config("qwen2_1_5b").reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, jparams)
    return jcfg, cfg, jparams, tree


def _batch(seed, b=2, s=24, vocab=256):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels = rng.integers(0, vocab, size=(b, s)).astype(np.int32)
    labels[0, :3] = -1  # masked positions
    return tokens, labels


# ---------------------------------------------------------------------------
# attention: plain version vs the Pallas flash kernel and the XLA oracle
# ---------------------------------------------------------------------------

FLASH_CASES = PARITY_CASES + [
    ("flash_attention_gqa_causal_suffix",
     dict(batch=2, heads=4, kv_heads=2, seq_q=32, seq_kv=64, head_dim=16,
          causal=True, block_M=16, block_N=16)),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_plain_attention_matches_pallas_flash_kernel(case):
    """The reference's flash kernel (Pallas interpret) against the port's
    plain version, reached as ``ref.attention``, through ``ops.attention``,
    through the kernel's wrapper and through ``FlashAttentionFn``, all on
    CPU tensors: a causal GQA case aligns the queries to the keys' suffix."""
    _, kw = case
    kern = tl_compile(flash_attention_program(**kw), Schedule(interpret=True))
    rng = np.random.default_rng(0)
    b, hq, hkv = kw["batch"], kw["heads"], kw["kv_heads"]
    sq, sk, d = kw["seq_q"], kw["seq_kv"], kw["head_dim"]
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    want = np.asarray(kern(q, k, v))
    causal = kw.get("causal", False)
    for got in (ref.attention(_t(q), _t(k), _t(v), causal=causal),
                ops.attention(_t(q), _t(k), _t(v), causal=causal),
                FA.flash_attention(_t(q), _t(k), _t(v), causal=causal),
                FA.FlashAttentionFn.apply(_t(q), _t(k), _t(v), causal, None)):
        np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    assert FA.KERNEL.launches == 0  # CPU tensors never reach the kernel


ORACLE_CASES = [
    # (name, b, hq, hkv, sq, sk, d, kwargs)
    ("window", 2, 4, 2, 24, 24, 16, dict(causal=True, window=5)),
    ("kv_len", 2, 4, 2, 8, 24, 16, dict(kv_len=np.array([24, 9], np.int32))),
    ("soft_cap", 1, 4, 1, 16, 16, 16, dict(causal=True, logit_soft_cap=3.0)),
    ("q_chunk", 1, 2, 2, 32, 48, 16, dict(causal=True, q_chunk=8, sm_scale=0.3)),
    ("noncausal_suffix", 2, 6, 2, 8, 40, 32, dict()),
]


@pytest.mark.parametrize("case", ORACLE_CASES, ids=[c[0] for c in ORACLE_CASES])
def test_plain_attention_matches_xla_oracle(case):
    """``ref.attention`` against the reference's XLA oracle with a window,
    per-row key lengths, a soft cap and query chunking; ``ops.attention``
    routes each to the plain version."""
    _, b, hq, hkv, sq, sk, d, kw = case
    rng = np.random.default_rng(1)
    q = rng.standard_normal((b, hq, sq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, sk, d), dtype=np.float32)
    want = np.asarray(jref.attention(q, k, v, **kw))
    tkw = {n: (_t(x) if isinstance(x, np.ndarray) else x) for n, x in kw.items()}
    np.testing.assert_allclose(ref.attention(_t(q), _t(k), _t(v), **tkw).numpy(),
                               want, **ATTN_TOL)
    np.testing.assert_allclose(ops.attention(_t(q), _t(k), _t(v), **tkw).numpy(),
                               want, **ATTN_TOL)


def test_flash_attention_fn_gradients_match_reference_autodiff():
    """``FlashAttentionFn``'s backward (the plain version recomputed under
    autograd) gives what ``jax.grad`` of the reference's oracle gives."""
    rng = np.random.default_rng(2)
    q = rng.standard_normal((2, 4, 24, 16), dtype=np.float32)
    k = rng.standard_normal((2, 2, 24, 16), dtype=np.float32)
    v = rng.standard_normal((2, 2, 24, 16), dtype=np.float32)
    w = rng.standard_normal((2, 4, 24, 16), dtype=np.float32)
    jg = jax.grad(lambda a, b_, c: jnp.sum(jref.attention(a, b_, c, causal=True) * w),
                  argnums=(0, 1, 2))(q, k, v)
    ts = [_t(x).requires_grad_(True) for x in (q, k, v)]
    out = FA.FlashAttentionFn.apply(*ts, True, None)
    grads = torch.autograd.grad((out * _t(w)).sum(), ts)
    for got, want in zip(grads, jg):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


# ---------------------------------------------------------------------------
# forward, loss and gradients
# ---------------------------------------------------------------------------


def test_forward_logits_match_reference(model):
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, _ = _batch(0)
    want, jaux = jlm.forward(jparams, jcfg, jnp.asarray(tokens))
    got, aux = lm.forward(params, cfg, _t(tokens))
    assert got.shape == (2, 24, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("logits_chunk,prefix", [(0, False), (8, True)])
def test_loss_and_every_gradient_match_reference(model, logits_chunk, prefix):
    """``loss_fn`` with per-layer recompute and its gradient with respect to
    every parameter leaf, against ``jax.value_and_grad(lm.loss_fn)``; once
    with the logits streamed in chunks and a prefix of embeddings."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    tokens, labels = _batch(1)
    pre = (np.random.default_rng(3).standard_normal((2, 4, cfg.d_model))
           .astype(np.float32) if prefix else None)

    def jloss(p):
        return jlm.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           prefix_embeds=pre, remat=True,
                           logits_chunk=logits_chunk)

    (jv, jparts), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    flat = _flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, parts = lm.loss_fn(params, cfg, _t(tokens), _t(labels),
                             prefix_embeds=None if pre is None else _t(pre),
                             remat=True, logits_chunk=logits_chunk)
    grads = torch.autograd.grad(loss, list(flat.values()))
    np.testing.assert_allclose(loss.item(), float(jv), **TOL)
    np.testing.assert_allclose(parts["ce"].item(), float(jparts["ce"]), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(flat)
    for key, g in zip(flat, grads):
        want = jflat[key]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale,
                                   rtol=0, atol=1e-4, err_msg=key)


def test_full_forward_refuses_unported_families():
    """An encoder-decoder's full forward is ``encdec``'s, not ``lm``'s;
    every decoder-only family runs it (granite and internvl2 since item 16,
    MLA + MoE since item 14's ``mla_full``: tests/test_torch_mla_full.py)."""
    with pytest.raises(ValueError, match="encdec"):
        lm.require_full_forward(tconfigs.get_config("whisper_tiny").reduced())
    for arch in ("deepseek_v2_lite_16b", "mamba2_2_7b", "hymba_1_5b",
                 "granite_moe_3b_a800m", "internvl2_26b"):  # ported
        lm.require_full_forward(tconfigs.get_config(arch).reduced())


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def test_adamw_three_steps_match_reference(model):
    """Three updates fed the same gradients (large enough to clip), through
    warmup and into the cosine decay: params, masters, moments and step."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    acfg = dict(peak_lr=3e-3, warmup_steps=2, total_steps=5)
    jstate = joptim.init_opt_state(jparams)
    state = optim.init_opt_state(params)
    assert all(m.data_ptr() != p.data_ptr() for m, p in zip(
        optim.adamw.leaves(state["master"]), optim.adamw.leaves(params)))
    rng = np.random.default_rng(4)
    jp = jparams
    for _ in range(3):
        gtree = jax.tree.map(
            lambda x: (3.0 * rng.standard_normal(x.shape)).astype(np.float32),
            tree)
        jp, jstate, jm = joptim.adamw_update(jp, gtree, jstate,
                                             joptim.AdamWConfig(**acfg))
        grads = params_from_numpy(gtree, cfg, device="cpu")
        params, state, m = optim.adamw_update(params, grads, state,
                                              optim.AdamWConfig(**acfg))
        np.testing.assert_allclose(m["lr"].item(), float(jm["lr"]), rtol=1e-6)
        np.testing.assert_allclose(m["grad_norm"].item(), float(jm["grad_norm"]),
                                   rtol=1e-6)
    assert int(state["step"]) == int(jstate["step"]) == 3
    want = _flat(jax.tree.map(np.asarray, {"params": jp, "opt": jstate}))
    got = _flat(tree_to_numpy({"params": params, "opt": state}))
    assert sorted(got) == sorted(want)
    for key, g in got.items():
        np.testing.assert_allclose(g, want[key], err_msg=key, **ADAM_TOL)


def test_lr_schedule_matches_reference():
    c = dict(peak_lr=1e-3, warmup_steps=3, total_steps=10)
    for step in range(12):
        np.testing.assert_allclose(
            optim.lr_schedule(optim.AdamWConfig(**c), step).item(),
            float(joptim.lr_schedule(joptim.AdamWConfig(**c), step)), rtol=1e-6)


# ---------------------------------------------------------------------------
# data, checkpoints, faults
# ---------------------------------------------------------------------------


def test_data_batches_equal_reference(tmp_path):
    for kw in (dict(batch=3, seq=16, vocab_size=256, seed=5),
               dict(batch=2, seq=32, vocab_size=151936, seed=0, num_hosts=2,
                    host_id=1)):
        mine = data.SyntheticTokens(data.DataConfig(**kw))
        theirs = jdata.SyntheticTokens(jdata.DataConfig(**kw))
        for i in (0, 1, 7, 1000):
            a, b = mine.batch_at(i), theirs.batch_at(i)
            for key in ("tokens", "labels"):
                assert a[key].dtype == b[key].dtype
                np.testing.assert_array_equal(a[key], b[key])
    shard = tmp_path / "shard.bin"
    np.random.default_rng(6).integers(0, 1000, size=500).astype(np.uint16).tofile(shard)
    kw = dict(batch=2, seq=16, vocab_size=300, seed=1)
    mine = data.TokenFileDataset(data.DataConfig(**kw), [str(shard)])
    theirs = jdata.TokenFileDataset(jdata.DataConfig(**kw), [str(shard)])
    np.testing.assert_array_equal(mine.batch_at(3)["tokens"], theirs.batch_at(3)["tokens"])
    loader = data.make_loader(mine, start_step=3)
    np.testing.assert_array_equal(next(loader)["labels"], theirs.batch_at(3)["labels"])
    loader.close()


def test_checkpoints_restore_across_packages(model, tmp_path):
    """An fp32 train state written by the port restores in the reference's
    ``restore`` to the same arrays, and the reverse; both write the same
    leaf keys in the same files.  A bf16 leaf the reference wrote restores
    in the port, and the port's own bf16 leaves round-trip bit for bit (the
    reference's ``restore`` cannot cast a bf16 file back, its own included)."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    state = {"params": params, "opt": optim.init_opt_state(params)}
    state["opt"]["m"]["final_norm"].fill_(0.25)
    state["opt"]["step"].fill_(7)
    jstate = {"params": jparams, "opt": joptim.init_opt_state(jparams)}

    ckpt.save(state, 7, tmp_path / "port")
    assert ckpt.latest_step(tmp_path / "port") == 7
    got = jckpt.restore(jstate, 7, tmp_path / "port")
    want = _flat(tree_to_numpy(state))
    for key, arr in _flat(got).items():
        np.testing.assert_array_equal(np.asarray(arr), want[key], err_msg=key)

    jckpt.save(jax.tree.map(np.asarray, jstate), 3, tmp_path / "ref")
    back = ckpt.restore(state, 3, tmp_path / "ref")
    ref_flat = _flat(jax.tree.map(np.asarray, jstate))
    for key, t in _flat(back).items():
        assert t.dtype == _flat(state)[key].dtype
        np.testing.assert_array_equal(t.numpy(), ref_flat[key], err_msg=key)
    import json
    man = [json.loads((tmp_path / d / "manifest.json").read_text())["keys"]
           for d in ("port/step_00000007", "ref/step_00000003")]
    assert [(e["key"], e["file"]) for e in man[0]] == [(e["key"], e["file"]) for e in man[1]]

    # the reference writes a bf16 leaf as 2-byte voids: the port reads the bits
    jbf = jnp.asarray(np.random.default_rng(5).standard_normal((4, 3)), jnp.bfloat16)
    jckpt.save({"w": jbf}, 1, tmp_path / "ref_bf16")
    got = ckpt.restore({"w": torch.empty(4, 3, dtype=torch.bfloat16)}, 1,
                       tmp_path / "ref_bf16")["w"]
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(jbf, np.float32))

    bf = {"w": torch.randn(5, 3).to(torch.bfloat16), "n": [torch.arange(4)]}
    mgr = CheckpointManager(tmp_path / "bf", interval=2, keep=1)
    assert mgr.maybe_save(bf, 2) and not mgr.maybe_save(bf, 3)
    bf["w"].zero_()  # the save copied to the host before its thread started
    mgr.wait()
    back = mgr.restore({"w": torch.empty(5, 3, dtype=torch.bfloat16),
                        "n": [torch.empty(4, dtype=torch.int64)]})
    assert back["w"].dtype == torch.bfloat16 and back["w"].abs().sum() > 0
    man = json.loads((tmp_path / "bf/step_00000002/manifest.json").read_text())
    assert {e["key"]: e["dtype"] for e in man["keys"]} == {"n/0": "int64", "w": "bfloat16"}


def test_fault_injector_fails_the_same_steps_as_reference():
    kw = dict(failure_prob=0.3, straggler_prob=0.2, straggler_delay_s=0.0, seed=3)
    mine = fault.FaultInjector(fault.FaultConfig(**kw))
    theirs = jfault.FaultInjector(jfault.FaultConfig(**kw))
    fails = [[], []]
    for step in range(40):
        for i, inj in enumerate((mine, theirs)):
            try:
                inj.before_step(step)
            except (fault.SimulatedNodeFailure, jfault.SimulatedNodeFailure):
                fails[i].append(step)
    assert fails[0] == fails[1] and len(fails[0]) > 5
    assert mine.injected_stragglers == theirs.injected_stragglers > 0
    # elastic_remesh re-places a host state on a mesh (multi-rank: test_torch_mesh.py)
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    try:
        mesh = make_debug_mesh(device="cpu")
        host = {"w": np.arange(6, dtype=np.float32).reshape(3, 2), "n": [np.int64(4)]}
        placed = fault.elastic_remesh(host, mesh, {"w": shd.Spec("data", None),
                                                   "n": [shd.Spec()]})
        assert isinstance(placed["w"], shd.DTensor) and placed["w"].device_mesh is mesh
        assert np.array_equal(placed["w"].full_tensor().numpy(), host["w"])
        assert placed["n"][0].full_tensor().item() == 4
    finally:
        torch.distributed.destroy_process_group()


def test_recovery_from_injected_failures_is_deterministic(tmp_path):
    """Training through injected failures (restore the latest checkpoint,
    rebuild the loader at its step) ends byte-identical to training
    without failures."""
    cfg = tconfigs.get_config("qwen2_1_5b").reduced()
    adamw = optim.AdamWConfig(peak_lr=3e-3, warmup_steps=1, total_steps=6)
    ds = data.SyntheticTokens(data.DataConfig(batch=2, seq=16,
                                              vocab_size=cfg.vocab_size, seed=2))
    finals = []
    for prob in (0.0, 0.3):
        state = train.build_state(cfg, 0, "cpu")
        res = fault.run_with_recovery(
            train.make_train_step(cfg, adamw), state,
            lambda s: data.make_loader(ds, s), 6,
            CheckpointManager(tmp_path / str(prob), interval=2),
            fault=fault.FaultConfig(failure_prob=prob, seed=1))
        assert res["steps"] == 6 and (res["restarts"] > 0) == (prob > 0)
        finals.append(_flat(res["state"]))
    for key, t in finals[0].items():
        assert torch.equal(t, finals[1][key]), key


def test_train_cli_recovers_on_the_cpu(tmp_path, capsys, monkeypatch):
    res = train.main(["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu",
                      "--steps", "6", "--batch", "2", "--seq", "16",
                      "--failure-prob", "0.2", "--seed", "1", "--log-every", "2",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["steps"] == 6 and res["restarts"] > 0
    assert np.isfinite(res["last_metrics"]["loss"].item())
    assert not any(t.requires_grad for t in optim.adamw.leaves(res["state"]["params"]))
    assert "step     2  loss" in out and f"done: 6 steps, {res['restarts']} restarts" in out
    assert "kernel launches on cpu: none" in out
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000000", "step_00000006"]
    base = ["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu"]
    # a production mesh needs its 256 ranks: the reference's RuntimeError
    with pytest.raises(RuntimeError, match="needs 256 ranks, found world size 1"):
        train.main(base + ["--mesh", "single_pod"])
    # deepseek, refused here until item 14's mla_full, trains through an
    # injected failure
    res = train.main(base + ["--arch", "deepseek_v2_lite_16b", "--steps", "6",
                             "--batch", "2", "--seq", "16", "--failure-prob", "0.2",
                             "--seed", "1", "--ckpt-dir", str(tmp_path / "deepseek")])
    assert res["steps"] == 6 and res["restarts"] > 0
    assert np.isfinite(res["last_metrics"]["loss"].item())
    assert set(res["last_metrics"]) >= {"loss", "ce", "aux"}
    # whisper, refused here until item 16, trains (tests/test_torch_encdec.py)
    res = train.main(base + ["--arch", "whisper_tiny", "--steps", "1", "--batch", "1",
                             "--seq", "8", "--ckpt-dir", str(tmp_path / "whisper")])
    assert res["steps"] == 1 and set(res["last_metrics"]) >= {"loss", "ce"}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):  # cuda by default
        train.main(["--arch", "qwen2_1_5b", "--reduced"])
