"""The port's quantized KV cache (int8 / int4 pages) held against the JAX
package, on the CPU.

* The quantization primitives give bytes and scales exactly equal to the
  reference's on the same fp32 inputs (both round half to even).
* The quantized decode and chunked-prefill kernels' plain versions match
  the reference's tile kernels in Pallas interpret mode
  (``backend="pallas"``) and its XLA path at atol 1e-4 / rtol 1e-4, fp32,
  with the written pools and scales compared too.
* Teacher-forced logits of ``prefill_step``/``decode_step`` on reduced
  ``qwen2_1_5b`` with quantized pages match ``repro.models.lm`` at atol
  2e-3, step by step from one cache state: a K or V element within an ulp
  of a rounding tie can land one code apart across the two frameworks
  (their fp32 projections differ in the last bit), which moves it by a
  whole scale step.  The written pools agree within one code, with at most
  two codes apart per step.  Measured on this test: int8 has one V code
  apart in the second prefill chunk, where the logits differ by 8.4e-4;
  every other step differs by at most 1.5e-5 (int4: no code apart, at most
  1.3e-5).  Carried over later steps, the one code apart moved the logits
  by up to 6.9e-3, which is why each step starts from the reference's
  pools.
* The engine under int8 takes the reference engine's decisions tick for
  tick; the pools shrink as the reference's do (TestQuantizedKV).

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import lm as jlm
from repro.serving import ServeConfig as JServeConfig
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention_quant as PAQ
from repro_torch.kernels import prefill_attention_quant as PFQ
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine
from repro_torch.serving.paged_cache import blocks_for_bytes

TOL = dict(rtol=1e-4, atol=1e-4)
FMTS = ["int8", "int4"]


def _t(a):
    return torch.as_tensor(np.array(a))


def _tables(rng, b, mp, num_pages):
    t = rng.permutation(num_pages - 1)[: b * mp] + 1  # page 0 reserved
    return t.reshape(b, mp).astype("int32")


def _quantized(rng, shape, fmt):
    """Random fp32 rows quantized by the reference: (packed, scales)."""
    q, s = jref.quantize_rows(rng.standard_normal(shape).astype("float32"), fmt)
    return np.asarray(q), np.asarray(s)


# ---------------------------------------------------------------------------
# quantization primitives: exactly the reference's bytes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", FMTS)
def test_quantize_rows_bytes_and_scales_equal_reference(fmt):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 32)) * 3).astype("float32")
    x[0, 1] = 0.0  # an all-zero row gets scale 1
    qmax = ref.KV_QMAX[fmt]
    # rows whose scale is 1, so x / scale lands on exact .5 ties
    x[1, 2] = 0.0
    x[1, 2, :8] = [qmax, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5]
    x[2, 3] = -x[1, 2]
    got_q, got_s = ref.quantize_rows(_t(x), fmt)
    want_q, want_s = jref.quantize_rows(jnp.asarray(x), fmt)
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_s[0, 1].item() == 1.0
    np.testing.assert_array_equal(
        ref.dequantize_rows(got_q, got_s, fmt).numpy(),
        np.asarray(jref.dequantize_rows(want_q, want_s, fmt)))


def test_pack_int4_low_nibble_first_and_unpack_equal_reference():
    vals = np.array([[-8, 7, -1, 0, 3, -5, 6, -2]], np.int8)
    packed = ref.pack_int4(_t(vals))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(jref.pack_int4(jnp.asarray(vals))))
    assert packed[0, 0].item() == np.uint8(0x78).view(np.int8)  # 7 << 4 | 8
    np.testing.assert_array_equal(ref.unpack_int4(packed).numpy(), vals)
    np.testing.assert_array_equal(ref.unpack_int4(packed).numpy(),
                                  np.asarray(jref.unpack_int4(jnp.asarray(packed.numpy()))))


# ---------------------------------------------------------------------------
# quantized decode: paged_attention_quant
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # (name, fmt, b, hq, hkv, d, ps, mp, num_pages, window); ragged lengths
    # with an empty slot in every case
    ("gqa_int8", "int8", 3, 4, 2, 16, 16, 4, 14, None),
    ("mqa_int4", "int4", 3, 2, 1, 16, 16, 4, 14, None),
    ("window_int4", "int4", 3, 4, 2, 16, 16, 4, 14, 20),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_paged_attention_quant_matches_reference(case):
    _, fmt, b, hq, hkv, d, ps, mp, num_pages, window = case
    rng = np.random.default_rng(0)
    tables = _tables(rng, b, mp, num_pages)
    lens = rng.integers(1, mp * ps + 1, size=b).astype("int32")
    lens[1] = 0  # an empty slot emits zeros
    q = rng.standard_normal((b, hq, d)).astype("float32")
    kp, ks = _quantized(rng, (hkv, num_pages, ps, d), fmt)
    vp, vs = _quantized(rng, (hkv, num_pages, ps, d), fmt)
    got = ops.paged_attention_quant(_t(q), _t(kp), _t(vp), _t(ks), _t(vs),
                                    _t(tables), _t(lens), fmt=fmt,
                                    window=window).numpy()
    assert np.all(got[1] == 0.0)
    for be in ("pallas", "xla"):
        want = np.asarray(jops.paged_attention_quant(
            q, kp, vp, ks, vs, tables, lens, fmt=fmt, window=window, backend=be))
        np.testing.assert_allclose(got, want, err_msg=be, **TOL)


def test_paged_attention_quant_soft_cap_routes_to_plain_path():
    rng = np.random.default_rng(1)
    b, hq, hkv, d, ps, mp, num_pages = 2, 4, 2, 16, 16, 2, 6
    tables = _tables(rng, b, mp, num_pages)
    lens = np.array([20, 7], np.int32)
    q = rng.standard_normal((b, hq, d)).astype("float32") * 4
    kp, ks = _quantized(rng, (hkv, num_pages, ps, d), "int8")
    vp, vs = _quantized(rng, (hkv, num_pages, ps, d), "int8")
    got = ops.paged_attention_quant(_t(q), _t(kp), _t(vp), _t(ks), _t(vs),
                                    _t(tables), _t(lens), logit_soft_cap=2.0)
    want = jops.paged_attention_quant(q, kp, vp, ks, vs, tables, lens,
                                      logit_soft_cap=2.0, backend="pallas")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ---------------------------------------------------------------------------
# quantized chunked prefill: prefill_attention_quant
# ---------------------------------------------------------------------------

PREFILL_CASES = [
    # (name, fmt, b, hq, hkv, d, chunk, ps, mp, num_pages, window, lens)
    ("gqa_multi_page_chunk_int8", "int8", 2, 4, 2, 16, 32, 16, 4, 10, None, None),
    ("mqa_window_partial_chunk_int4", "int4", 2, 2, 1, 16, 32, 16, 4, 10, 20, (32, 19)),
    ("idle_slot_int8", "int8", 2, 4, 2, 16, 16, 16, 4, 10, None, (0, 11)),
]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_prefill_attention_quant_matches_reference_and_writes_pools(case):
    _, fmt, b, hq, hkv, d, chunk, ps, mp, num_pages, window, lens = case
    rng = np.random.default_rng(2)
    tables = _tables(rng, b, mp, num_pages)
    starts = (rng.integers(0, mp - chunk // ps + 1, size=b) * ps).astype("int32")
    if lens is None:
        lens = rng.integers(1, chunk + 1, size=b)
    lens = np.asarray(lens, np.int32)
    q = rng.standard_normal((b, hq, chunk, d)).astype("float32")
    kn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    vn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    pools = [*_quantized(rng, (hkv, num_pages, ps, d), fmt),
             *_quantized(rng, (hkv, num_pages, ps, d), fmt)]
    kp, ks, vp, vs = pools
    given = [_t(p) for p in (kp, vp, ks, vs)]
    out, *written = ops.prefill_attention_quant(
        _t(q), _t(kn), _t(vn), *given, _t(tables), _t(starts), _t(lens),
        fmt=fmt, window=window)
    assert all(w is g for w, g in zip(written, given))  # written in place
    got = {"torch": (out.numpy(), *[w.numpy() for w in written])}
    for be in ("pallas", "xla"):
        o, *pj = jops.prefill_attention_quant(
            q, kn, vn, kp, vp, ks, vs, tables, starts, lens, fmt=fmt,
            window=window, backend=be)
        got[be] = (np.asarray(o), *[np.asarray(p) for p in pj])
        np.testing.assert_allclose(got["torch"][0], got[be][0], err_msg=be, **TOL)
    kq, ksn = (np.asarray(a) for a in jref.quantize_rows(kn, fmt))
    vq, vsn = (np.asarray(a) for a in jref.quantize_rows(vn, fmt))
    written_pages = {int(tables[bi, min((int(starts[bi]) + c) // ps, mp - 1)])
                     for bi in range(b) for c in range(chunk)} | {0}
    for name, (_, kw, vw, ksw, vsw) in got.items():
        # every path stores the chunk's packed bytes and scales at its live
        # positions, exactly the reference's quantization of the chunk ...
        for bi in range(b):
            for c in range(int(lens[bi])):
                pos = int(starts[bi]) + c
                pg, of = tables[bi, pos // ps], pos % ps
                for pool, new in ((kw, kq), (vw, vq), (ksw, ksn), (vsw, vsn)):
                    np.testing.assert_array_equal(pool[:, pg, of], new[bi, :, c],
                                                  err_msg=name)
        # ... and pages no chunk writes keep their bytes and scales
        for pg in range(num_pages):
            if pg not in written_pages:
                for pool, old in ((kw, kp), (vw, vp), (ksw, ks), (vsw, vs)):
                    np.testing.assert_array_equal(pool[:, pg], old[:, pg], err_msg=name)


def test_prefill_quant_unaligned_chunk_routes_to_plain_path():
    """``chunk % page_size != 0`` takes the plain path, whose output and
    pools match the reference's XLA path."""
    rng = np.random.default_rng(4)
    b, hq, hkv, d, chunk, ps, mp, num_pages = 2, 4, 2, 16, 6, 4, 6, 14
    tables = _tables(rng, b, mp, num_pages)
    starts, lens = np.array([0, 12], np.int32), np.array([6, 4], np.int32)
    q = rng.standard_normal((b, hq, chunk, d)).astype("float32")
    kn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    vn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    kp, ks = _quantized(rng, (hkv, num_pages, ps, d), "int4")
    vp, vs = _quantized(rng, (hkv, num_pages, ps, d), "int4")
    before = PFQ.KERNEL.launches
    out, kw, _, ksw, _ = ops.prefill_attention_quant(
        _t(q), _t(kn), _t(vn), _t(kp), _t(vp), _t(ks), _t(vs), _t(tables),
        _t(starts), _t(lens), fmt="int4")
    o, kj, _, ksj, _ = jops.prefill_attention_quant(
        q, kn, vn, kp, vp, ks, vs, tables, starts, lens, fmt="int4",
        backend="pallas")  # the reference routes this shape to XLA too
    np.testing.assert_allclose(out.numpy(), np.asarray(o), **TOL)
    np.testing.assert_array_equal(kw.numpy()[:, 1:], np.asarray(kj)[:, 1:])
    np.testing.assert_array_equal(ksw.numpy()[:, 1:], np.asarray(ksj)[:, 1:])
    assert PFQ.KERNEL.launches == before


def test_quant_wrappers_take_the_plain_version_only_for_cpu_tensors():
    assert PAQ.KERNEL.replaces == "src/repro/kernels/paged_attention.py:93"
    assert PFQ.KERNEL.replaces == "src/repro/kernels/prefill_attention.py:157"
    assert PAQ.KERNEL.source.name == "paged_attention.cu"
    assert PFQ.KERNEL.source.name == "prefill_attention.cu"
    assert set(ops.KERNELS) == {"paged_attention", "prefill_attention",
                                "paged_attention_quant", "prefill_attention_quant",
                                "mla_paged", "mla_prefill", "mla_paged_quant",
                                "mla_prefill_quant", "flash_attention",
                                "chunk_state", "chunk_scan", "matmul",
                                "dequant_matmul", "mla"}
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 4, 16)).astype("float32"))
    kp, ks = (_t(a) for a in _quantized(rng, (2, 5, 4, 16), "int8"))
    tables, lens = _t(np.array([[1, 2], [3, 4]], np.int32)), _t(np.array([5, 8], np.int32))
    before = PAQ.KERNEL.launches
    got = PAQ.paged_attention_quant(q, kp, kp, ks, ks, tables, lens)
    assert torch.equal(got, ref.paged_attention_quant(q, kp, kp, ks, ks, tables, lens))
    assert PAQ.KERNEL.launches == before


# ---------------------------------------------------------------------------
# the model and the engine with quantized pages
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def model():
    cfg_j = jget_config("qwen2_1_5b").reduced()
    cfg_t = get_config("qwen2_1_5b").reduced()
    pj = jlm.init(cfg_j, jax.random.PRNGKey(0))
    pt = params_from_numpy(jax.tree.map(np.asarray, pj), cfg_t, device="cpu")
    return cfg_j, pj, cfg_t, pt


@pytest.mark.parametrize("fmt", FMTS)
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
    assert sorted(ct.kv) == ["k_pages", "k_scale_pages", "v_pages", "v_scale_pages"]
    assert ct.kv["k_pages"].dtype == torch.int8
    tables = np.zeros((b, 4), np.int32)
    perm = rng.permutation(12)[:9] + 1
    tables[0, :4], tables[1, :3], tables[2, :2] = perm[:4], perm[4:7], perm[7:9]
    cj = cj.with_tables(jnp.asarray(tables))
    ct = ct.with_tables(torch.as_tensor(tables))
    prefill_j = jax.jit(lambda p, c, t, s, n: jlm.prefill_step(p, cfg_j, c, t, s, n))
    decode_j = jax.jit(lambda p, c, t, s: jlm.decode_step(p, cfg_j, c, t, s))
    worst = []

    def compare_and_resync(lt, lj, live=slice(None)):
        """Logits within 2e-3; pools within one code of each other, few
        codes apart; then the port's pools take the reference's, so that
        each step starts from one state and a tie's flip is counted once."""
        worst.append(float(np.abs(lt.numpy()[live] - np.asarray(lj)[live]).max()))
        np.testing.assert_allclose(lt.numpy()[live], np.asarray(lj)[live],
                                   rtol=1e-4, atol=2e-3)
        kv_j = cj.rest["kv"]
        apart = 0
        for name, leaf in ct.kv.items():
            want = np.asarray(kv_j[name])
            if name.endswith("scale_pages"):
                np.testing.assert_allclose(leaf.numpy()[:, :, 1:],
                                           want[:, :, 1:], rtol=1e-5, atol=0)
            else:
                codes = (lambda t: ref.unpack_int4(t) if fmt == "int4" else t)
                diff = (codes(leaf).int() - codes(_t(want)).int())[:, :, 1:]
                assert diff.abs().max().item() <= 1, name
                apart += int((diff != 0).sum())
            leaf.copy_(_t(want))
        assert apart <= 2, apart

    for pos, lens in (([0, 0, 0], [16, 16, 9]), ([16, 16, 9], [16, 11, 0])):
        toks = rng.integers(0, cfg_t.vocab_size, size=(b, chunk)).astype(np.int32)
        pos, lens = np.asarray(pos, np.int32), np.asarray(lens, np.int32)
        lj, cj = prefill_j(pj, cj, jnp.asarray(toks), jnp.asarray(pos),
                           jnp.asarray(lens))
        lt, ct = lm.prefill_step(pt, cfg_t, ct, torch.as_tensor(toks),
                                 torch.as_tensor(pos), torch.as_tensor(lens))
        compare_and_resync(lt, lj, lens > 0)
    pos = np.array([32, 27, 9], np.int32)
    for _ in range(4):
        tok = rng.integers(0, cfg_t.vocab_size, size=b).astype(np.int32)
        lj, cj = decode_j(pj, cj, jnp.asarray(tok), jnp.asarray(pos))
        lt, ct = lm.decode_step(pt, cfg_t, ct, torch.as_tensor(tok),
                                torch.as_tensor(pos))
        compare_and_resync(lt, lj)
        pos = pos + 1
    print(f"{fmt}: largest logit difference {max(worst):.2e}")


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


def test_engine_int8_ticks_match_reference_engine(model):
    cfg_j, pj, cfg_t, pt = model
    prompts = _workload()
    ours, rq = _run(ServingEngine, ServeConfig, cfg_t, pt, prompts, kv_dtype="int8")
    theirs, rj = _run(JServingEngine, JServeConfig, cfg_j, pj, prompts,
                      kv_dtype="int8")
    assert ours.cfg.kv_dtype == "int8" and cfg_t.kv_dtype is None
    assert ours.steps_run == theirs.steps_run
    assert [r.ttft_ticks for r in rq] == [r.ttft_ticks for r in rj]
    assert [r.preemptions for r in rq] == [r.preemptions for r in rj]
    assert ours.preemptions == theirs.preemptions > 0
    assert ours.pages_shared == theirs.pages_shared > 0
    assert ours.pool.page_bytes == theirs.pool.page_bytes
    assert ours.kv_cache_bytes() == theirs.kv_cache_bytes()


def test_kv_bytes_ratios_and_byte_budget_sizing(model):
    """int8 pools are <= 0.55x and int4 <= 0.30x of fp's bytes; at a fixed
    byte budget the quantized pool affords strictly more pages."""
    _, _, cfg, params = model
    mk = lambda kv: ServingEngine(cfg, params, ServeConfig(  # noqa: E731
        slots=2, max_len=64, max_new_tokens=1, page_size=8, kv_dtype=kv),
        device="cpu")
    fp, q8, q4 = mk(None), mk("int8"), mk("int4")
    assert sorted(fp.cache.kv) == ["k_pages", "v_pages"]
    assert fp.cache.kv["k_pages"].dtype == torch.float32
    assert q8.cache.kv_bytes() / fp.cache.kv_bytes() <= 0.55
    assert q4.cache.kv_bytes() / fp.cache.kv_bytes() <= 0.30
    assert q4.pool.page_bytes < q8.pool.page_bytes < fp.pool.page_bytes
    budget = 64 * fp.pool.page_bytes
    assert blocks_for_bytes(budget, q8.pool.page_bytes) > \
        blocks_for_bytes(budget, fp.pool.page_bytes) == 64


def test_copy_on_write_copies_scale_pages_with_packed_pages(model):
    """A write into a shared quantized page copies packed bytes and scales
    together: outputs stay those of an unshared run."""
    _, _, cfg, params = model
    cache = lm.init_cache(dataclasses.replace(cfg, kv_dtype="int4"), 2, 32,
                          page_size=4, num_blocks=6, device="cpu")
    for leaf in cache.kv.values():
        leaf.copy_(torch.randint(-100, 100, leaf.shape).to(leaf.dtype))
    before = {k: v.clone() for k, v in cache.kv.items()}
    lm.copy_pages(cache, [1, 2], [4, 5])
    for k, v in cache.kv.items():
        assert torch.equal(v[:, :, 4], before[k][:, :, 1]), k
        assert torch.equal(v[:, :, 5], before[k][:, :, 2]), k
    prompt = list(range(3, 9))
    _, (r0,) = _run(ServingEngine, ServeConfig, cfg, params, [prompt],
                    slots=1, num_blocks=None, kv_dtype="int8")
    eng = ServingEngine(cfg, params, ServeConfig(
        slots=2, max_len=32, max_new_tokens=5, page_size=4, prefill_chunk=8,
        prefix_cache=False, kv_dtype="int8"), device="cpu")
    r1, r2 = eng.submit(prompt), eng.submit(prompt)
    eng.step()  # prefill tick: both slots to gen
    eng.tables.repoint(1, 1, eng.tables.blocks(0)[1])
    eng._tables_dirty = True
    eng.run()
    assert eng.pages_copied >= 1
    assert r1.output == r0.output and r2.output == r0.output


def test_rejects_contiguous_cache_and_unknown_formats():
    with pytest.raises(ValueError, match="paged"):
        ServeConfig(slots=1, max_len=16, cache="contiguous", kv_dtype="int8")
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeConfig(kv_dtype="int2")
