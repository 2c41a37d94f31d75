"""The port's mixture of experts (GShard capacity dispatch) held against the
JAX package, on the CPU.

``layers.moe`` matches ``repro.models.layers.moe`` at atol 1e-5 / rtol 1e-5
in fp32 (the two differ only in the order of fp32 sums) on inputs where the
capacity drops tokens, padded positions (repeated rows, as an idle slot's
padding brings) included, for the group counts serving meets: one token a
slot at decode, chunks at prefill.  Routing ties break toward the lower
expert, as ``jax.lax.top_k`` does.  Inside the decode window the MoE makes
no host transfer.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.models import layers as jL
from repro.models import lm as jlm
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.models import layers as L
from repro_torch.models import lm
from repro_torch.serving.sampling import guarded_argmax

ARCH = "deepseek_v2_lite_16b"
TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_config(ARCH).reduced()
    cfg_t = get_config(ARCH).reduced()
    pj = jlm.init(cfg_j, jax.random.PRNGKey(3))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    moe_j = jax.tree.map(lambda a: a[0], pj["layers"]["moe"])
    moe_t = lm.layer_params(pt, 0)["moe"]
    return cfg_j, cfg_t, moe_j, moe_t, pt


def _drops(cfg, t):
    """Groups, tokens a group and capacity per expert for ``t`` tokens."""
    g = L._moe_groups(t, 1)
    tg = t // g
    return g, tg, max(1, int(cfg.moe.capacity_factor * tg * cfg.moe.experts_per_token
                             / cfg.moe.num_experts))


# (b, s, drops): decode at 8 slots (8 groups of 1 token: each expert can
# take the one token, nothing drops), a prefill chunk of 3 x 16 (16 groups of
# 3, capacity 1) and 2 x 5 tokens (2 groups of 5, capacity 3)
SHAPES = [(8, 1, False), (3, 16, True), (2, 5, True)]


@pytest.mark.parametrize("b,s,drops", SHAPES, ids=[f"{b}x{s}" for b, s, _ in SHAPES])
def test_moe_matches_reference_with_drops_and_padding(model, b, s, drops):
    cfg_j, cfg_t, moe_j, moe_t, _ = model
    rng = np.random.default_rng(b * 100 + s)
    x = rng.standard_normal((b, s, cfg_t.d_model)).astype("float32")
    x[-1, s // 2:] = x[-1, -1]  # padded positions: one row repeated
    got, aux = L.moe(moe_t, torch.as_tensor(x), cfg_t)
    want, aux_j = jL.moe(moe_j, jnp.asarray(x), cfg_j)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(aux.item(), float(aux_j), **TOL)
    # where the capacity drops tokens, the output differs from a run with a
    # capacity that holds every choice
    wide = dataclasses.replace(cfg_t, moe=dataclasses.replace(
        cfg_t.moe, capacity_factor=100.0))
    assert drops != torch.allclose(L.moe(moe_t, torch.as_tensor(x), wide)[0], got)


def test_top_k_breaks_ties_toward_the_lower_index():
    x = np.array([[0.1, 0.3, 0.3, 0.2, 0.3], [0.5, 0.5, 0.5, 0.5, 0.5]],
                 np.float32)
    vals, idx = L.top_k(torch.as_tensor(x), 3)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    assert idx.tolist() == [[1, 2, 4], [0, 1, 2]]


def test_moe_groups_and_capacity_are_the_reference_s():
    for t in (1, 3, 8, 10, 48, 512, 1024):
        assert L._moe_groups(t, 1) == jL._moe_groups(t, 1)
    cfg = get_config(ARCH)  # full width: 64 experts, top 6
    assert _drops(cfg, 8) == (8, 1, 1)  # decode at 8 slots
    assert _drops(cfg, 512) == (16, 32, 3)  # a 64-token chunk at 8 slots


class _SyncCounter:
    """Counts the tensor methods that make the host wait on a card."""

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


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_mla_moe_decode_loop_stays_on_the_device(model, monkeypatch, kv_dtype):
    """``lm.decode_loop`` over MLA + MoE blocks makes no host transfer."""
    _, cfg, _, _, params = model
    cfg = dataclasses.replace(cfg, kv_dtype=kv_dtype)
    cache = lm.init_cache(cfg, 3, 32, page_size=8, num_blocks=13, device="cpu")
    cache = cache.with_tables(torch.tensor(
        [[1, 2, 3, 4], [5, 6, 7, 8], [0, 0, 0, 0]], dtype=torch.int32))
    counter = _SyncCounter(monkeypatch)
    toks, emitted, _ = lm.decode_loop(
        params, cfg, cache, torch.tensor([7, 9, 0], dtype=torch.int32),
        torch.tensor([5, 29, 0], dtype=torch.int32), None,
        torch.tensor([True, True, False]),
        torch.tensor([3, 10, 0], dtype=torch.int32), n_steps=4,
        sample_fn=lambda logits, key, gate: (guarded_argmax(logits), key),
        eos_id=-1, max_len=32)
    assert counter.calls == []
    monkeypatch.undo()
    assert toks.shape == emitted.shape == (4, 3)
    assert emitted[:, 1].tolist() == [True, True, True, False]
