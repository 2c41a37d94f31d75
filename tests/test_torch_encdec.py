"""The port's encoder-decoder (whisper-tiny: a non-causal encoder over stub
frame embeddings, a causal decoder with cross-attention, learned positions)
held against the JAX package on the CPU: the parameter tree, ``encode``,
``decode_full``, ``loss_fn`` (chunked and not) and every gradient, the
KV-cache ``decode_step`` against the reference's and against
``decode_full``, checkpoints of the tree, and the CLIs.

Parameters come from the reference's own ``encdec.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; frames, tokens and labels
are numpy arrays made from a seed and handed to both sides.  Reduced
``whisper_tiny``: fp32, 2 encoder and 2 decoder layers, d 64, 4 heads of
16 (no GQA), d_ff 128 with GELU, vocab 256; 12 frames, 16 tokens.

Tolerances: encoder output, logits, the loss and every gradient leaf at
1e-4 (of the leaf's largest element for gradients), decode logits and
caches at 1e-4 a step; the port's decode against its own ``decode_full``
at the reference's 5e-3 (tests/test_models.py:200).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import encdec as jencdec
from repro_torch import checkpoint
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models import encdec

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "whisper_tiny"
FRAMES, SEQ = 12, 16


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
    return {"/".join(path): tree}


@pytest.fixture(scope="module")
def model():
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = tconfigs.get_config(ARCH).reduced()
    jparams = jencdec.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def _inputs(seed, b=2):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, FRAMES, 64)).astype(np.float32)
    tokens = rng.integers(0, 256, size=(b, SEQ)).astype(np.int32)
    labels = rng.integers(0, 256, size=(b, SEQ)).astype(np.int32)
    labels[1, :4] = -1
    return frames, tokens, labels


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_shapes_and_leaf_dtypes_match_reference(dtype):
    """Leaf by leaf: the reference's ``encdec.init``, the port's own
    ``init`` and the bridge give the same paths, shapes and dtypes (the
    decoder's position table at 2048 rows for the reduced vocab)."""
    jcfg = dataclasses.replace(jconfigs.get_config(ARCH).reduced(), dtype=dtype)
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), dtype=dtype)
    jtree = jax.tree.map(np.asarray, jencdec.init(jcfg, jax.random.PRNGKey(0)))
    want = {k: (v.shape, str(v.dtype)) for k, v in _flat(jtree).items()}
    assert want["dec_pos"][0] == (encdec.max_dec_positions(cfg), 64)
    assert want["enc_pos"][0] == (encdec.MAX_FRAMES, 64)
    for tree in (encdec.init(cfg, 0, device="cpu"),
                 params_from_numpy(jtree, cfg, device="cpu")):
        got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
               for k, v in _flat(tree).items()}
        assert got == want
    assert encdec.max_dec_positions(tconfigs.get_config(ARCH)) == 32768


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_encode_and_decode_full_match_reference(model, backend):
    """The encoder (non-causal) and the teacher-forced decoder (causal)
    self-attention through the reference's XLA oracle and its Pallas flash
    kernel in interpret mode; cross-attention through its plain version."""
    jcfg, cfg, jparams, tree = model
    jcfg = dataclasses.replace(jcfg, kernel_backend=backend)
    params = params_from_numpy(tree, cfg, device="cpu")
    frames, tokens, _ = _inputs(0)
    jenc = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    enc = encdec.encode(params, cfg, _t(frames))
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **TOL)
    want = jencdec.decode_full(jparams, jcfg, jnp.asarray(tokens), jenc)
    got = encdec.decode_full(params, cfg, _t(tokens), enc)
    assert got.shape == (2, SEQ, cfg.vocab_size) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_and_every_gradient_match_reference(model, logits_chunk):
    """The loss with the decoder's per-layer recompute, chunked logits or
    not; ``{"ce"}`` alone as its parts (no auxiliary loss)."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    frames, tokens, labels = _inputs(1)

    def jloss(p):
        return jencdec.loss_fn(p, jcfg, jnp.asarray(frames), jnp.asarray(tokens),
                               jnp.asarray(labels), remat=True,
                               logits_chunk=logits_chunk)

    (jv, _), jgrads = jax.value_and_grad(jloss, has_aux=True)(jparams)
    flat = _flat(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, parts = encdec.loss_fn(params, cfg, _t(frames), _t(tokens), _t(labels),
                                 remat=True, logits_chunk=logits_chunk)
    grads = torch.autograd.grad(loss, list(flat.values()))
    assert sorted(parts) == ["ce"]
    np.testing.assert_allclose(loss.item(), float(jv), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    assert sorted(jflat) == sorted(flat)
    for key, g in zip(flat, grads):
        want = jflat[key]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


def test_decode_step_matches_reference_and_decode_full(model):
    """SEQ steps of the KV-cache decode, the cache written at ``pos``:
    each step's logits and the whole cache against the reference's
    ``decode_step``, and the logits against the port's own ``decode_full``
    of the same tokens."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    frames, tokens, _ = _inputs(2)
    jenc = jencdec.encode(jparams, jcfg, jnp.asarray(frames))
    jcross = jencdec.cross_kv(jparams, jcfg, jenc)
    enc = encdec.encode(params, cfg, _t(frames))
    cross = encdec.cross_kv(params, cfg, enc)
    np.testing.assert_allclose(cross[0].numpy(), np.asarray(jcross[0]), **TOL)
    jcache = jencdec.init_cache(jcfg, 2, SEQ + 4)
    cache = encdec.init_cache(cfg, 2, SEQ + 4, device="cpu")
    full = encdec.decode_full(params, cfg, _t(tokens), enc)
    step_j = jax.jit(lambda c, t, p: jencdec.decode_step(jparams, jcfg, c, t, p, jcross))
    for pos in range(SEQ):
        jlog, jcache = step_j(jcache, jnp.asarray(tokens[:, pos]), pos)
        got, cache = encdec.decode_step(params, cfg, cache, _t(tokens[:, pos]),
                                        torch.tensor(pos), cross)
        np.testing.assert_allclose(got.numpy(), np.asarray(jlog), **TOL,
                                   err_msg=f"step {pos}")
        for name in ("k", "v"):
            np.testing.assert_allclose(cache["self"][name].numpy(),
                                       np.asarray(jcache["self"][name]), **TOL)
        np.testing.assert_allclose(got.numpy(), full[:, pos].numpy(), atol=5e-3)


def test_checkpoint_round_trips_the_encoder_decoder_state(tmp_path):
    """``enc_layers`` / ``dec_layers`` stacked, and the optimizer state,
    saved and restored leaf for leaf, bf16 bit for bit."""
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), dtype="bfloat16")
    state = train.build_state(cfg, 3, "cpu")
    mgr = checkpoint.CheckpointManager(tmp_path, interval=1, async_save=False)
    assert mgr.maybe_save(state, 5) and mgr.latest() == 5
    restored = mgr.restore(train.build_state(cfg, 4, "cpu"))
    want, got = _flat(state["params"]), _flat(restored["params"])
    assert sorted(got) == sorted(want) and "dec_layers/xattn/wq" in got
    for key, t in want.items():
        assert got[key].dtype == t.dtype and torch.equal(got[key], t), key


def test_train_cli_recovers_and_serve_cli_refuses(tmp_path, capsys):
    """The training CLI feeds zero frames, as the reference's, checkpoints
    and restarts through an injected failure; the serving CLI refuses an
    encoder-decoder model with the reference's SystemExit."""
    res = train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                      "--batch", "2", "--seq", "16", "--log-every", "2",
                      "--failure-prob", "0.3", "--ckpt-interval", "2",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["steps"] == 4 and res["restarts"] > 0
    assert sorted(res["last_metrics"]) == ["ce", "grad_norm", "loss", "lr"]
    assert np.isfinite(res["last_metrics"]["loss"].item())
    assert "done: 4 steps" in out and "kernel launches on cpu: none" in out
    assert sorted(p.name for p in tmp_path.iterdir())[-1] == "step_00000004"
    with pytest.raises(SystemExit, match="enc-dec serving demo lives in examples/"):
        serve.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


# ---------------------------------------------------------------------------
# chip_smoke.py's whisper checks, rehearsed with CPU tensors
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_whisper_checks_rehearse_on_the_cpu():
    """Phase 2's whisper shapes (the encoder's non-causal case with a
    length no tile divides, the decoder's causal one), bf16 on the plain
    path with the controls failing; phase 9's checks on a reduced model in
    bf16 (the teacher-forced decode against fp32, the greedy KV-cache
    decode against decode_full: no kernel launched here) and two training
    steps on seeded frames."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    full = tconfigs.get_config(ARCH)
    cases = {c[0]: c for c in cs.FLASH_CASES}
    enc, dec = cases["whisper encoder"], cases["whisper decoder"]
    assert enc[2:] == (6, 6, full.frontend_seq, full.frontend_seq, 64, False)
    assert dec[4] == cs.WHISPER_TOKENS and dec[7]
    for case in (enc, dec):
        small = case[:1] + (1,) + case[2:4] + (100, 100) + case[6:]
        r = cs.check_flash(torch, np, ref, FA, torch.bfloat16, small, None, False, cpu)
        assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), dtype="bfloat16")
    tf, greedy, launches = cs.whisper_checks(torch, np, encdec, cfg, cpu, frames=FRAMES,
                                             tokens=SEQ, steps=8)
    assert cs.agreement_ok(tf) and cs.agreement_ok(greedy), (tf, greedy)
    assert (tf["steps"], greedy["steps"], launches) == (SEQ, 8, (0, 0))
    tr = cs.train_steps(torch, cfg, cpu, 2, 2, SEQ,
                        extra={"frames": cs.seeded_embeddings(torch, cfg, 2, FRAMES, cpu)})
    assert all(np.isfinite(tr["losses"])) and tr["launches"] == {}
