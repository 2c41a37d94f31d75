"""The port's multi-head latent attention (MLA) serving path held against
the JAX package, on the CPU.

* The plain versions of the four MLA kernels (paged decode, chunked prefill
  and their int8 / int4 twins) match the reference's tile kernels in Pallas
  interpret mode (``backend="pallas"``) and its XLA path on every
  ``repro.kernels.mla.PARITY_CASES`` entry but the contiguous ``mla``, at
  atol 1e-4 / rtol 1e-4 in fp32 (the order of fp32 sums, exp against exp2).
  The pages and scales they write are equal.
* Teacher-forced logits of ``prefill_step``/``decode_step`` on reduced
  ``deepseek_v2_lite_16b`` (one dense prefix layer, one MoE layer, MoE
  capacity dropping tokens) match ``repro.models.lm``: fp pages at 1e-4;
  int8 / int4 pages at 2e-3 with the pools resynced each step and one code
  apart allowed, as for quantized GQA (tests/test_torch_quant.py: a latent
  element within an ulp of a rounding tie lands one code apart).
* On a deepseek workload the port's engine takes the reference engine's
  decisions tick for tick; outputs are byte-identical across ``sync_every``.
* Preemption: the reference's ``test_mla_paged_preemption_lossless`` fails
  because MoE capacity dispatch drops tokens by how they are grouped, and
  the grouping follows the batch shape; both packages show it.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import mla as jmla
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import mla_paged as MP
from repro_torch.kernels import mla_paged_quant as MPQ
from repro_torch.kernels import mla_prefill as MF
from repro_torch.kernels import mla_prefill_quant as MFQ
from repro_torch.kernels import ops, ref
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "deepseek_v2_lite_16b"


def _t(a):
    return torch.as_tensor(np.array(a))


def _fp_or_quantized(rng, shape, fmt):
    """Random fp32 rows, or their quantization by the reference as
    (packed, scales)."""
    x = rng.standard_normal(shape).astype("float32")
    if fmt is None:
        return (x,)
    return tuple(np.asarray(a) for a in jref.quantize_rows(x, fmt))


# ---------------------------------------------------------------------------
# the kernels' plain versions against PARITY_CASES
# ---------------------------------------------------------------------------

CASES = [(n, c) for n, c in jmla.PARITY_CASES if n != "mla"]


@pytest.mark.parametrize("name,cfg", CASES, ids=[n for n, _ in CASES])
def test_plain_mla_kernels_match_reference_parity_cases(name, cfg):
    rng = np.random.default_rng(0)
    slots, h, r, pe = cfg["slots"], cfg["heads"], cfg["dim"], cfg["pe_dim"]
    ps, mp, num_pages = cfg["page_size"], cfg["max_pages"], cfg["num_pages"]
    fmt, window = cfg.get("fmt"), cfg.get("window")
    tables = (rng.permutation(num_pages - 1)[: slots * mp] + 1).reshape(
        slots, mp).astype("int32")  # page 0 reserved, each page one slot's
    pools = [*_fp_or_quantized(rng, (num_pages, ps, r), fmt),
             *_fp_or_quantized(rng, (num_pages, ps, pe), fmt)]
    if fmt is not None:  # (ckv, ckv_scale, kpe, kpe_scale) -> pools, scales
        pools = [pools[0], pools[2], pools[1], pools[3]]
    qkw = {} if fmt is None else {"fmt": fmt}
    if name.startswith("mla_paged"):
        lens = rng.integers(1, mp * ps + 1, size=slots).astype("int32")
        q = rng.standard_normal((slots, h, r)).astype("float32")
        qpe = rng.standard_normal((slots, h, pe)).astype("float32")
        fn, jfn = ((ops.mla_paged, jops.mla_paged) if fmt is None else
                   (ops.mla_paged_quant, jops.mla_paged_quant))
        got = fn(_t(q), _t(qpe), *map(_t, pools), _t(tables), _t(lens),
                 window=window, **qkw).numpy()
        for be in ("pallas", "xla"):
            want = jfn(q, qpe, *pools, tables, lens, window=window, backend=be,
                       block_h=cfg["block_H"], **qkw)
            np.testing.assert_allclose(got, np.asarray(want), err_msg=be, **TOL)
        return
    chunk = cfg["chunk"]
    starts = (rng.integers(0, mp - chunk // ps + 1, size=slots) * ps).astype("int32")
    lens = rng.integers(chunk - ps + 1, chunk + 1, size=slots).astype("int32")
    q = rng.standard_normal((slots, h, chunk, r)).astype("float32")
    qpe = rng.standard_normal((slots, h, chunk, pe)).astype("float32")
    ckv = rng.standard_normal((slots, chunk, r)).astype("float32")
    kpe = rng.standard_normal((slots, chunk, pe)).astype("float32")
    fn, jfn = ((ops.mla_prefill, jops.mla_prefill) if fmt is None else
               (ops.mla_prefill_quant, jops.mla_prefill_quant))
    given = [_t(p) for p in pools]
    out, *written = fn(_t(q), _t(qpe), _t(ckv), _t(kpe), *given, _t(tables),
                       _t(starts), _t(lens), window=window, **qkw)
    assert all(w is g for w, g in zip(written, given))  # written in place
    got = {"torch": (out.numpy(), *[w.numpy() for w in written])}
    for be in ("pallas", "xla"):
        o, *pj = jfn(q, qpe, ckv, kpe, *pools, tables, starts, lens,
                     window=window, backend=be, **qkw)
        got[be] = (np.asarray(o), *[np.asarray(p) for p in pj])
        np.testing.assert_allclose(got["torch"][0], got[be][0], err_msg=be, **TOL)
    # what every path stores at a live position: the chunk's rows (packed
    # bytes and scales by the reference's quantization when quantized) ...
    new = [ckv, kpe] if fmt is None else [
        *(np.asarray(a) for a in jref.quantize_rows(ckv, fmt)),
        *(np.asarray(a) for a in jref.quantize_rows(kpe, fmt))]
    if fmt is not None:
        new = [new[0], new[2], new[1], new[3]]
    written_pages = {int(tables[b, min((int(starts[b]) + c) // ps, mp - 1)])
                     for b in range(slots) for c in range(chunk)} | {0}
    for path, (_, *pw) in got.items():
        for b in range(slots):
            for c in range(int(lens[b])):
                p = int(starts[b]) + c
                for pool, rows in zip(pw, new):
                    np.testing.assert_array_equal(
                        pool[tables[b, p // ps], p % ps], rows[b, c], err_msg=path)
        # ... and pages no chunk writes keep their contents
        for pg in set(range(num_pages)) - written_pages:
            for pool, old in zip(pw, pools):
                np.testing.assert_array_equal(pool[pg], old[pg], err_msg=path)
    # the plain path's pools equal the XLA path's on every page but the sink
    for mine, theirs in zip(got["torch"][1:], got["xla"][1:]):
        np.testing.assert_array_equal(mine[1:], theirs[1:])


def test_soft_cap_and_unaligned_chunks_take_the_plain_path():
    """The reference's routing (ops.py:489, :529, :628): a soft-capped model
    and a chunk that is not a whole number of pages take the plain path,
    which matches the reference's XLA path; no kernel is launched."""
    rng = np.random.default_rng(1)
    b, h, r, pe, ps, mp, num_pages = 2, 4, 16, 8, 4, 6, 14
    tables = (rng.permutation(num_pages - 1)[: b * mp] + 1).reshape(b, mp).astype("int32")
    ckv = rng.standard_normal((num_pages, ps, r)).astype("float32")
    kpe = rng.standard_normal((num_pages, ps, pe)).astype("float32")
    lens = np.array([20, 7], np.int32)
    q = rng.standard_normal((b, h, r)).astype("float32") * 4
    qpe = rng.standard_normal((b, h, pe)).astype("float32")
    counts = {k: v.launches for k, v in ops.KERNELS.items()}
    got = ops.mla_paged(_t(q), _t(qpe), _t(ckv), _t(kpe), _t(tables), _t(lens),
                        logit_soft_cap=2.0, sm_scale=0.3)
    want = jops.mla_paged(q, qpe, ckv, kpe, tables, lens, logit_soft_cap=2.0,
                          sm_scale=0.3, backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    chunk = 6
    starts, clens = np.array([0, 12], np.int32), np.array([6, 4], np.int32)
    qc = rng.standard_normal((b, h, chunk, r)).astype("float32")
    qpec = rng.standard_normal((b, h, chunk, pe)).astype("float32")
    cn = rng.standard_normal((b, chunk, r)).astype("float32")
    pn = rng.standard_normal((b, chunk, pe)).astype("float32")
    cq, cs = (np.asarray(a) for a in jref.quantize_rows(ckv, "int4"))
    pq, pqs = (np.asarray(a) for a in jref.quantize_rows(kpe, "int4"))
    out, cw, _, csw, _ = ops.mla_prefill_quant(
        _t(qc), _t(qpec), _t(cn), _t(pn), _t(cq), _t(pq), _t(cs), _t(pqs),
        _t(tables), _t(starts), _t(clens), fmt="int4")
    o, cj, _, csj, _ = jops.mla_prefill_quant(
        qc, qpec, cn, pn, cq, pq, cs, pqs, tables, starts, clens, fmt="int4",
        backend="pallas")  # the reference routes this shape to XLA too
    np.testing.assert_allclose(out.numpy(), np.asarray(o), **TOL)
    np.testing.assert_array_equal(cw.numpy()[1:], np.asarray(cj)[1:])
    np.testing.assert_array_equal(csw.numpy()[1:], np.asarray(csj)[1:])
    assert counts == {k: v.launches for k, v in ops.KERNELS.items()}


def test_mla_wrappers_take_the_plain_version_only_for_cpu_tensors():
    assert MP.KERNEL.replaces == "src/repro/kernels/mla.py:110"
    assert MF.KERNEL.replaces == "src/repro/kernels/mla.py:180"
    assert MPQ.KERNEL.replaces == "src/repro/kernels/mla.py:301"
    assert MFQ.KERNEL.replaces == "src/repro/kernels/mla.py:374"
    assert MP.KERNEL.source.name == MPQ.KERNEL.source.name == "mla_paged.cu"
    assert MF.KERNEL.source.name == MFQ.KERNEL.source.name == "mla_prefill.cu"
    assert MP.head_block(16) == 16 and MP.head_block(12) == 12
    assert MF.row_block(16, 16) == 32 and MF.row_block(16, 2) == 32
    rng = np.random.default_rng(5)
    q, qpe = _t(rng.standard_normal((2, 4, 32)).astype("float32")), \
        _t(rng.standard_normal((2, 4, 16)).astype("float32"))
    ckv = _t(rng.standard_normal((5, 4, 32)).astype("float32"))
    kpe = _t(rng.standard_normal((5, 4, 16)).astype("float32"))
    tables, lens = _t(np.array([[1, 2], [3, 4]], np.int32)), _t(np.array([5, 8], np.int32))
    before = MP.KERNEL.launches
    got = MP.mla_paged(q, qpe, ckv, kpe, tables, lens)
    assert torch.equal(got, ref.mla_paged(q, qpe, ckv, kpe, tables, lens))
    assert MP.KERNEL.launches == before


# ---------------------------------------------------------------------------
# the model: teacher-forced logits against repro.models.lm
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_config(ARCH).reduced()
    cfg_t = get_config(ARCH).reduced()
    pj = jlm.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, pj, cfg_t, pt


def test_init_and_bridge_keep_the_reference_tree(model):
    """One unstacked dense prefix layer with the widened MLP, the rest
    stacked with the MoE; the router stays fp32 in a bf16 model."""
    cfg_j, pj, cfg_t, pt = model
    mine = lm.init(cfg_t, 0, device="cpu")
    for tree in (mine, pt):
        assert len(tree["prefix_layers"]) == 1
        assert tree["prefix_layers"][0]["mlp"]["w_up"].shape == (64, 32 * 3)
        assert tree["layers"]["moe"]["w_gate"].shape == (1, 4, 64, 32)
        assert sorted(tree["layers"]["attn"]) == sorted(pj["layers"]["attn"])
    assert lm.param_count(mine) == jlm.param_count(pj)
    bf = dataclasses.replace(cfg_t, dtype="bfloat16")
    p16 = lm.init(bf, 0, device="cpu")
    assert p16["layers"]["moe"]["router"].dtype == torch.float32
    assert p16["layers"]["moe"]["w_up"].dtype == torch.bfloat16
    jbf = dataclasses.replace(cfg_j, dtype="bfloat16")
    conv = params_from_numpy(jax.tree.map(np.asarray, jlm.init(jbf, jax.random.PRNGKey(0))),
                             bf, device="cpu")
    assert conv["layers"]["moe"]["router"].dtype == torch.float32
    assert conv["prefix_layers"][0]["attn"]["w_q"].dtype == torch.bfloat16


def _pools_j(cache):
    """The reference cache's MLA pools stacked over all layers, in the port's
    layout (prefix layers first)."""
    rest = cache.rest["mla"] if cache.stacked else {
        k: np.stack([np.asarray(c["mla"][k]) for c in cache.rest])
        for k in cache.rest[0]["mla"]}
    return {k: np.concatenate([np.stack([np.asarray(c["mla"][k]) for c in cache.prefix]),
                               np.asarray(rest[k])]) for k in rest}


@pytest.mark.parametrize("fmt", [None, "int8", "int4"])
def test_teacher_forced_logits_match_reference(model, fmt):
    cfg_j, pj, cfg_t, pt = model
    cfg_j = dataclasses.replace(cfg_j, kv_dtype=fmt)
    cfg_t = dataclasses.replace(cfg_t, kv_dtype=fmt)
    rng = np.random.default_rng(0)
    b, max_len, ps, chunk = 3, 64, 16, 16
    cj = jlm.init_cache(cfg_j, b, max_len, layout="paged", page_size=ps,
                        num_blocks=13)
    ct = lm.init_cache(cfg_t, b, max_len, page_size=ps, num_blocks=13,
                       device="cpu")
    want_leaves = ["ckv_pages", "kpe_pages"] + (
        [] if fmt is None else ["ckv_scale_pages", "kpe_scale_pages"])
    assert sorted(ct.kv) == sorted(want_leaves) and ct.num_pages == 13
    tables = np.zeros((b, 4), np.int32)
    perm = rng.permutation(12)[:9] + 1
    tables[0, :4], tables[1, :3], tables[2, :2] = perm[:4], perm[4:7], perm[7:9]
    cj = cj.with_tables(jnp.asarray(tables))
    ct = ct.with_tables(torch.as_tensor(tables))
    prefill_j = jax.jit(lambda p, c, t, s, n: jlm.prefill_step(p, cfg_j, c, t, s, n))
    decode_j = jax.jit(lambda p, c, t, s: jlm.decode_step(p, cfg_j, c, t, s))
    atol = 1e-4 if fmt is None else 2e-3

    def compare_and_resync(lt, lj, live=slice(None)):
        """Logits within the limit; fp pools equal, quantized pools within
        one code, few codes apart; then the port's pools take the
        reference's, so each step starts from one state."""
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   rtol=1e-4, atol=atol)
        apart = 0
        for name, want in _pools_j(cj).items():
            leaf = ct.kv[name]
            if fmt is None or name.endswith("scale_pages"):
                np.testing.assert_allclose(leaf.numpy()[:, 1:], want[:, 1:],
                                           rtol=1e-5, atol=1e-6, err_msg=name)
            else:
                codes = (lambda t: ref.unpack_int4(t) if fmt == "int4" else t)
                diff = (codes(leaf).int() - codes(_t(want)).int())[:, 1:]
                assert diff.abs().max().item() <= 1, name
                apart += int((diff != 0).sum())
            leaf.copy_(_t(want))
        assert apart <= 2, apart

    # two chunks (slot 2 idle in the second: padded positions ride through
    # the MoE and take capacity), then decode steps
    for pos, lens in (([0, 0, 0], [16, 16, 9]), ([16, 16, 9], [16, 11, 0])):
        toks = rng.integers(0, cfg_t.vocab_size, size=(b, chunk)).astype(np.int32)
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        lj, cj = prefill_j(pj, cj, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(lens))
        lt, ct = lm.prefill_step(pt, cfg_t, ct, torch.as_tensor(toks),
                                 torch.as_tensor(pos), torch.as_tensor(lens))
        compare_and_resync(lt, lj, lens > 0)
    pos = np.array([32, 27, 9], np.int32)
    for _ in range(3):
        tok = rng.integers(0, cfg_t.vocab_size, size=b).astype(np.int32)
        lj, cj = decode_j(pj, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = lm.decode_step(pt, cfg_t, ct, torch.as_tensor(tok),
                                torch.as_tensor(pos))
        compare_and_resync(lt, lj)
        pos = pos + 1


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _workload(seed=0):
    """A shared 8-token prefix on three prompts plus two unrelated prompts;
    with 6 blocks of 4 tokens the pool preempts."""
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, 256, size=8).tolist()
    return ([shared + rng.integers(0, 256, size=t).tolist() for t in (5, 2, 9)]
            + [rng.integers(0, 256, size=n).tolist() for n in (11, 6)])


SCFG = dict(slots=3, max_len=32, max_new_tokens=5, page_size=4,
            prefill_chunk=8, num_blocks=6)


def _run(engine_cls, scfg_cls, cfg, params, prompts, **kw):
    extra = {"device": "cpu"} if engine_cls is ServingEngine else {}
    eng = engine_cls(cfg, params, scfg_cls(**{**SCFG, **kw}), **extra)
    reqs = [eng.submit(p) for p in prompts]
    eng.run()
    assert all(r.status == "completed" for r in reqs)
    return eng, reqs


@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_engine_ticks_match_reference_engine(model, kv_dtype):
    cfg_j, pj, cfg_t, pt = model
    prompts = _workload()
    ours, rq = _run(ServingEngine, ServeConfig, cfg_t, pt, prompts,
                    kv_dtype=kv_dtype)
    theirs, rj = _run(JServingEngine, JServeConfig, cfg_j, pj, prompts,
                      kv_dtype=kv_dtype)
    assert ours.prefill_mode == theirs.prefill_mode == "chunked"
    assert ours.steps_run == theirs.steps_run
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert [r.preemptions for r in rq] == [r.preemptions for r in rj]
    assert ours.preemptions == theirs.preemptions > 0
    assert ours.pages_shared == theirs.pages_shared > 0
    assert ours.pool.page_bytes == theirs.pool.page_bytes
    assert ours.kv_cache_bytes() == theirs.kv_cache_bytes()


def test_outputs_byte_identical_across_sync_every(model):
    _, _, cfg, params = model
    prompts = _workload(1)
    base = dict(num_blocks=None, max_new_tokens=6)
    _, ref_reqs = _run(ServingEngine, ServeConfig, cfg, params, prompts, **base)
    for sync in (4, 16):
        eng, reqs = _run(ServingEngine, ServeConfig, cfg, params, prompts,
                         sync_every=sync, **base)
        assert eng.decode_windows > 0
        assert [r.output for r in reqs] == [r.output for r in ref_reqs]


# ---------------------------------------------------------------------------
# the reference's failing preemption test: MoE capacity, not MLA paging
# ---------------------------------------------------------------------------


def test_mla_preemption_follows_moe_capacity_in_both_packages(model):
    """The scenario of tests/test_serving.py::test_mla_paged_preemption_lossless
    in both packages.  At the default capacity factor (1.25) the preempted
    two-slot run and the single-request runs group tokens differently
    (``_moe_groups`` follows the token count, layers.py:764; capacity is
    ``int(1.25 * tokens_per_group * k / E)``, layers.py:790; padded
    positions and idle slots take capacity too), so their outputs differ in
    the reference; the port reproduces the reference's preempted outputs.
    With a capacity that drops nothing both packages are lossless."""
    cfg_j, _, cfg_t, _ = model
    rng = np.random.default_rng(0)  # the reference test's `rng` fixture
    prompt1 = rng.integers(0, cfg_t.vocab_size, size=6).tolist()
    prompt2 = rng.integers(0, cfg_t.vocab_size, size=6).tolist()
    pj = jlm.init(cfg_j, jax.random.PRNGKey(0))

    def outputs(engine_cls, scfg_cls, cfg, params):
        extra = {"device": "cpu"} if engine_cls is ServingEngine else {}

        def alone(prompt):
            e = engine_cls(cfg, params, scfg_cls(
                slots=1, max_len=16, max_new_tokens=6, page_size=4), **extra)
            r = e.submit(prompt)
            e.run()
            return r.output

        eng = engine_cls(cfg, params, scfg_cls(
            slots=2, max_len=16, max_new_tokens=6, page_size=4, num_blocks=4),
            **extra)
        r1, r2 = eng.submit(prompt1), eng.submit(prompt2)
        eng.run()
        assert eng.preemptions >= 1
        return [r1.output, r2.output], [alone(prompt1), alone(prompt2)]

    results = {}
    for factor in (1.25, 100.0):
        cj = dataclasses.replace(cfg_j, moe=dataclasses.replace(
            cfg_j.moe, capacity_factor=factor))
        ct = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, capacity_factor=factor))
        pt = params_from_numpy(jax.tree.map(np.asarray, pj), ct, device="cpu")
        results[factor] = (outputs(JServingEngine, JServeConfig, cj, pj),
                           outputs(ServingEngine, ServeConfig, ct, pt))
    (jpre, jalone), (tpre, talone) = results[1.25]
    assert tpre == jpre  # the port's preempted run is the reference's
    assert talone == jalone
    assert jpre != jalone  # the default capacity drops tokens here
    for pre, alone in results[100.0]:
        assert pre == alone  # nothing dropped: preemption is lossless
