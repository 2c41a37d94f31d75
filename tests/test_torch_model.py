"""The port's configs and dense GQA model, held against the JAX package.

Parameters come from the reference's own ``lm.init`` and reach the port
through ``repro_torch.convert.params_from_numpy``; tokens, positions, block
tables and lengths are the same numpy arrays on both sides.  Teacher-forced
logits of ``prefill_step`` and ``decode_step`` on reduced configs (fp32, 2
layers, d 64) must agree within atol 1e-4 / rtol 1e-4: fp32 throughout, the
two sides differ only in the order of fp32 sums.
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
from repro_torch.models import encdec, lm

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", jconfigs.ARCHS)
def test_configs_match_reference(arch):
    assert tconfigs.ARCHS == jconfigs.ARCHS
    mine, theirs = tconfigs.get_config(arch), jconfigs.get_config(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
    assert dataclasses.asdict(mine.reduced()) == dataclasses.asdict(theirs.reduced())
    assert mine.param_count() == theirs.param_count()
    assert tconfigs.get_config(arch.replace("_", "-")).name == mine.name


def test_init_matches_reference_tree_and_statistics():
    cfg = tconfigs.get_config("qwen2_1_5b").reduced()
    mine = lm.init(cfg, 0, device="cpu")
    theirs = jlm.init(jconfigs.get_config("qwen2_1_5b").reduced(),
                      jax.random.PRNGKey(0))
    flat_j = {jax.tree_util.keystr(p): np.asarray(x)
              for p, x in jax.tree_util.tree_leaves_with_path(theirs)}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from walk(v, path + f"[{k!r}]")
        elif isinstance(node, list):
            for i, v in enumerate(node):
                yield from walk(v, path + f"[{i}]")
        else:
            yield path, node

    flat_t = dict(walk(mine, ""))
    assert sorted(flat_t) == sorted(flat_j)
    for k, t in flat_t.items():
        assert tuple(t.shape) == flat_j[k].shape, k
        assert t.dtype == torch.float32
        if "bq" in k or "bk" in k or "bv" in k:
            assert torch.all(t == 0)
        elif "norm" in k:
            assert torch.all(t == 1)
    # the same distribution: N(0, 1/fan_in) weights, N(0, 1) embedding
    wq = flat_t["['layers']['attn']['wq']"]
    assert abs(wq.std().item() - 1 / np.sqrt(cfg.d_model)) < 0.01
    assert abs(flat_t["['embed']['embedding']"].std().item() - 1.0) < 0.05


def _variants():
    q = jconfigs.get_config("qwen2_1_5b").reduced()
    return [
        ("gqa", q),
        ("mqa", dataclasses.replace(q, num_kv_heads=1)),
        ("sliding_window", dataclasses.replace(q, sliding_window=12,
                                               global_attn_every=2)),
    ]


@pytest.mark.parametrize("name,cfg_j", _variants(), ids=[n for n, _ in _variants()])
def test_teacher_forced_logits_match_reference(name, cfg_j):
    cfg_t = tconfigs.get_config("qwen2_1_5b").reduced()
    cfg_t = dataclasses.replace(cfg_t, num_kv_heads=cfg_j.num_kv_heads,
                                sliding_window=cfg_j.sliding_window,
                                global_attn_every=cfg_j.global_attn_every)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    pj = jlm.init(cfg_j, jax.random.PRNGKey(1))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    rng = np.random.default_rng(0)
    b, max_len, ps, chunk = 3, 64, 16, 16
    cj = jlm.init_cache(cfg_j, b, max_len, layout="paged", page_size=ps,
                        num_blocks=13)
    ct = lm.init_cache(cfg_t, b, max_len, page_size=ps, num_blocks=13,
                       device="cpu")
    tables = np.zeros((b, 4), np.int32)
    perm = rng.permutation(12)[:9] + 1
    tables[0, :4], tables[1, :3], tables[2, :2] = perm[:4], perm[4:7], perm[7:9]
    cj = cj.with_tables(jnp.asarray(tables))
    ct = ct.with_tables(torch.as_tensor(tables))
    prefill_j = jax.jit(lambda p, c, t, s, n: jlm.prefill_step(p, cfg_j, c, t, s, n))
    decode_j = jax.jit(lambda p, c, t, s: jlm.decode_step(p, cfg_j, c, t, s))
    # two prefill chunks (slot 2 idle in the second), then decode steps
    for pos, lens in (([0, 0, 0], [16, 16, 9]), ([16, 16, 9], [16, 11, 0])):
        toks = rng.integers(0, cfg_t.vocab_size, size=(b, chunk)).astype(np.int32)
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        lj, cj = prefill_j(pj, cj, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(lens))
        lt, ct = lm.prefill_step(pt, cfg_t, ct, torch.as_tensor(toks),
                                 torch.as_tensor(pos), torch.as_tensor(lens))
        live = lens > 0
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live], **TOL)
    pos = np.array([32, 27, 9], np.int32)
    for _ in range(4):
        tok = rng.integers(0, cfg_t.vocab_size, size=b).astype(np.int32)
        lj, cj = decode_j(pj, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = lm.decode_step(pt, cfg_t, ct, torch.as_tensor(tok),
                                torch.as_tensor(pos))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        pos = pos + 1
    # the pools agree everywhere but the sink page 0
    kj = cj.rest["kv"]["k_pages"] if cj.stacked else np.stack(
        [c["kv"]["k_pages"] for c in cj.rest])
    np.testing.assert_allclose(ct.kv["k_pages"].numpy()[:, :, 1:],
                               np.asarray(kj)[:, :, 1:], **TOL)


def test_decode_append_drops_out_of_range_writes():
    """A position past the table (logical page >= max_pages) gathers INT_MIN
    in the reference and its scatter is dropped; the port sends it to the
    sink page 0 (no host sync to count dropped rows), so no other page
    changes."""
    cfg = tconfigs.get_config("qwen2_1_5b").reduced()
    params = lm.init(cfg, 0, device="cpu")
    cache = lm.init_cache(cfg, 2, 32, page_size=16, num_blocks=5, device="cpu")
    cache = cache.with_tables(torch.tensor([[1, 2], [3, 4]], dtype=torch.int32))
    logits, cache = lm.decode_step(params, cfg, cache,
                                   torch.tensor([5, 6], dtype=torch.int32),
                                   torch.tensor([3, 32], dtype=torch.int32))
    assert torch.isfinite(logits).all()
    k = cache.kv["k_pages"]
    assert k[:, :, 1, 3].abs().sum() > 0  # slot 0 wrote page 1, offset 3
    assert k[:, :, 2:].abs().sum() == 0  # slot 1's write was dropped


def test_copy_pages_copies_every_pool_in_place():
    cfg = tconfigs.get_config("qwen2_1_5b").reduced()
    cache = lm.init_cache(cfg, 2, 32, page_size=4, num_blocks=6, device="cpu")
    for leaf in cache.kv.values():
        leaf.copy_(torch.randn(leaf.shape))
    before = {k: v.clone() for k, v in cache.kv.items()}
    out = lm.copy_pages(cache, [1, 2], [4, 5])
    assert out is cache
    for k, v in cache.kv.items():
        assert torch.equal(v[:, :, 4], before[k][:, :, 1])
        assert torch.equal(v[:, :, 5], before[k][:, :, 2])
        assert torch.equal(v[:, :, :4], before[k][:, :, :4])


@pytest.mark.parametrize("arch,item", [
    ("granite_moe_3b_a800m", "item 16"),
    ("whisper_tiny", "item 16"), ("internvl2_26b", "item 16"),
])
def test_unported_families_raise_naming_their_roadmap_item(arch, item):
    """The families ROADMAP Queue 1 ``item`` ported, whose raise named it
    until then, now run: granite (GQA + MoE) and internvl2 (a frontend
    model, served text only) take ``lm``'s parameters and paged cache; the
    encoder-decoder whisper is ``encdec``'s, and ``lm`` refuses it with a
    ValueError that says so.  Only MLA without MoE still raises, naming
    its own item."""
    assert item == "item 16"
    cfg = tconfigs.get_config(arch).reduced()
    if cfg.is_encoder_decoder:
        with pytest.raises(ValueError, match="encdec"):
            lm.init(cfg, 0, device="cpu")
        params = encdec.init(cfg, 0, device="cpu")
        cache = encdec.init_cache(cfg, 1, 16, device="cpu")
        assert tuple(cache["self"]["k"].shape) == (cfg.num_layers, 1, cfg.num_kv_heads,
                                                   16, cfg.head_dim)
        assert params["dec_layers"]["xattn"]["wq"].shape[0] == cfg.num_layers
        return
    params = lm.init(cfg, 0, device="cpu")
    cache = lm.init_cache(cfg, 2, 16, device="cpu")
    logits, _ = lm.decode_step(params, cfg, cache, torch.tensor([1, 2]),
                               torch.tensor([0, 0]))
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
    mla_dense = dataclasses.replace(tconfigs.get_config("deepseek_v2_lite_16b").reduced(),
                                    family="dense")
    with pytest.raises(NotImplementedError, match="item 13"):
        lm.init(mla_dense, 0, device="cpu")


@pytest.mark.parametrize("arch", ["mamba2_2_7b", "hymba_1_5b"])
def test_formerly_unported_families_now_run(arch):
    """The SSM and hybrid families (ROADMAP Queue 1 item 15) initialise,
    take their caches (the SSM's contiguous recurrent state; the hybrid's
    paged pools plus recurrent rows) and decode a step."""
    cfg = tconfigs.get_config(arch).reduced()
    params = lm.init(cfg, 0, device="cpu")
    layout = "paged" if cfg.attends else "contiguous"
    cache = lm.init_cache(cfg, 2, 16, layout=layout, device="cpu")
    logits, _ = lm.decode_step(params, cfg, cache, torch.tensor([1, 2]),
                               torch.tensor([0, 0]))
    assert logits.shape == (2, cfg.vocab_size) and torch.isfinite(logits).all()
