"""The port's frontend family (internvl2-26b: a GQA decoder behind the stub
patch frontend's precomputed embeddings) held against the JAX package on
the CPU: the forward with a prefix of patch embeddings, the loss, which
leaves out the prefix rows, and every gradient; and the CLIs (training on
the stub's zero prefix through checkpoints and an injected failure;
serving text only, as the reference).

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; prefix embeddings,
tokens and labels are numpy arrays made from a seed and handed to both
sides.  Reduced ``internvl2_26b``: fp32, 2 layers, d 64, 4 query heads
over 2 KV heads of 16, d_ff 128, an untied unembedding, vocab 256; a prefix
of 8 patch rows (``frontend_seq``) before 16 tokens.

Tolerances: logits, the loss and every gradient leaf at 1e-4 (of the
leaf's largest element for gradients).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve, train
from repro_torch.models import lm

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "internvl2_26b"
SEQ = 16


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
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = tconfigs.get_config(ARCH).reduced()
    jparams = jlm.init(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jparams, jax.tree.map(np.asarray, jparams)


def _inputs(seed, cfg, b=2):
    rng = np.random.default_rng(seed)
    prefix = rng.standard_normal((b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)
    tokens = rng.integers(0, 256, size=(b, SEQ)).astype(np.int32)
    labels = rng.integers(0, 256, size=(b, SEQ)).astype(np.int32)
    labels[0, :3] = -1
    return prefix, tokens, labels


@pytest.mark.parametrize("backend", ["xla", "pallas"])
def test_prefix_forward_matches_reference(model, backend):
    """Logits over the prefix rows and the tokens, (B, P + S, V), with
    attention through the reference's XLA oracle and its Pallas flash
    kernel in interpret mode."""
    jcfg, cfg, jparams, tree = model
    assert cfg.frontend == "patch" and cfg.frontend_seq == 8 and not cfg.tie_embeddings
    params = params_from_numpy(tree, cfg, device="cpu")
    prefix, tokens, _ = _inputs(0, cfg)
    want, _ = jlm.forward(jparams, dataclasses.replace(jcfg, kernel_backend=backend),
                          jnp.asarray(tokens), prefix_embeds=jnp.asarray(prefix))
    got, aux = lm.forward(params, cfg, _t(tokens), prefix_embeds=_t(prefix))
    assert got.shape == (2, cfg.frontend_seq + SEQ, cfg.vocab_size) and float(aux) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("logits_chunk", [0, 8])
def test_loss_leaves_out_the_prefix_and_every_gradient_matches(model, logits_chunk):
    """The loss over the text rows only (equal to the cross-entropy of the
    forward's last SEQ rows), and its gradient, the prefix embeddings'
    included, against ``jax.value_and_grad``."""
    jcfg, cfg, jparams, tree = model
    params = params_from_numpy(tree, cfg, device="cpu")
    prefix, tokens, labels = _inputs(1, cfg)

    def jloss(p, pre):
        return jlm.loss_fn(p, jcfg, jnp.asarray(tokens), jnp.asarray(labels),
                           prefix_embeds=pre, remat=True, logits_chunk=logits_chunk)

    (jv, _), (jgrads, jgpre) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jparams, jnp.asarray(prefix))
    flat = _flat(params)
    pre = _t(prefix).requires_grad_(True)
    for t in flat.values():
        t.requires_grad_(True)
    loss, parts = lm.loss_fn(params, cfg, _t(tokens), _t(labels), prefix_embeds=pre,
                             remat=True, logits_chunk=logits_chunk)
    grads = torch.autograd.grad(loss, [*flat.values(), pre])
    np.testing.assert_allclose(loss.item(), float(jv), **TOL)
    with torch.no_grad():
        logits, _ = lm.forward(params, cfg, _t(tokens), prefix_embeds=_t(prefix))
        text = torch.log_softmax(logits[:, cfg.frontend_seq:], -1)
        lab = _t(labels).long()
        keep = lab >= 0
        nll = -text.gather(-1, lab.clamp(min=0)[..., None])[..., 0]
        np.testing.assert_allclose(parts["ce"].item(),
                                   (nll * keep).sum().item() / keep.sum().item(), **TOL)
    jflat = _flat(jax.tree.map(np.asarray, jgrads))
    jflat["prefix_embeds"] = np.asarray(jgpre)
    names = [*flat, "prefix_embeds"]
    assert sorted(jflat) == sorted(names) and "embed/unembed" in jflat
    for key, g in zip(names, grads):
        want = jflat[key]
        scale = max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(g.numpy() / scale, want / scale, rtol=0,
                                   atol=1e-4, err_msg=key)


def test_train_cli_recovers_and_serve_cli_serves_text_only(tmp_path, capsys):
    res = train.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "4",
                      "--batch", "2", "--seq", "16", "--log-every", "2",
                      "--failure-prob", "0.3", "--ckpt-interval", "2",
                      "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert res["steps"] == 4 and res["restarts"] > 0
    assert np.isfinite(res["last_metrics"]["loss"].item())
    assert "done: 4 steps" in out and "kernel launches on cpu: none" in out
    done = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "4",
                       "--prompt-len", "20"])
    out = capsys.readouterr().out
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    assert "paged cache" in out and "[chunked prefill]" in out


# ---------------------------------------------------------------------------
# chip_smoke.py's internvl2 checks, rehearsed with CPU tensors
# ---------------------------------------------------------------------------


def _chip_smoke():
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def test_chip_smoke_vlm_checks_rehearse_on_the_cpu():
    """Phase 2's internvl2 case (a group of 6 at D 128), bf16 on the plain
    path with the controls failing; phase 10's checks on a reduced model in
    bf16: the prefix forward against fp32 over the text rows, and two
    training steps whose loss's cross-entropy equals the forward's over the
    text rows alone."""
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    cs = _chip_smoke()
    cpu = torch.device("cpu")
    full = tconfigs.get_config(ARCH)
    case = next(c for c in cs.FLASH_CASES if c[0] == "internvl2 train")
    assert case[2:4] + case[6:] == (full.num_heads, full.num_kv_heads, full.head_dim, True)
    assert case[4] == cs.VLM_PREFIX + cs.VLM_TEXT and cs.VLM_PREFIX == full.frontend_seq
    r = cs.check_flash(torch, np, ref, FA, torch.bfloat16,
                       case[:1] + (1,) + case[2:4] + (80, 80) + case[6:], None, False, cpu)
    assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    cfg = dataclasses.replace(tconfigs.get_config(ARCH).reduced(), dtype="bfloat16")
    r, launches = cs.vlm_forward_check(torch, np, lm, cfg, cpu, prefix=8, text=SEQ)
    assert cs.agreement_ok(r) and r["steps"] == SEQ and launches == (0, 0), r
    tr, ce, text_ce = cs.vlm_train_check(torch, np, lm, cfg, cpu, steps=2, batch=2,
                                         prefix=8, text=SEQ)
    assert all(np.isfinite(tr["losses"])) and tr["launches"] == {}
    assert abs(ce - text_ce) <= 1e-3 * abs(text_ce), (ce, text_ce)
