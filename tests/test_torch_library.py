"""The port's kernel library (``repro_torch.kernels.ops.matmul``,
``dequant_matmul`` and ``mla``) held against the JAX package, on the CPU.

* The plain versions, which every CPU tensor takes, match the reference's
  tile kernels in Pallas interpret mode (``backend="pallas"``) and its XLA
  path on every ``PARITY_CASES`` entry of ``repro/kernels/matmul.py``,
  ``dequant_matmul.py`` and ``mla.py``'s ``"mla"``, on the reference tests'
  scaled and multi-latent-head cases, at M = 1, and with fp16 and int8
  activations (against ``backend="xla"``): atol 1e-4 / rtol 1e-4 in fp32
  (the order of fp32 sums; exp against exp2 for MLA).
* Unpacked int2, int4 and nf4 codes equal the reference's byte for byte.
* On the card path (a CUDA tensor) the wrappers launch their kernel and
  never the plain version, and a scale group the dequant kernel cannot take
  raises: here the kernel call is replaced by a recorder, since this
  machine has no card.
* chip_smoke.py's library phase rehearses at reduced shapes.

The CUDA kernels themselves run only on a card (tests/test_torch_cuda.py).
"""
import contextlib
import sys
import types
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import dequant_matmul as jdq
from repro.kernels import matmul as jmm
from repro.kernels import mla as jmla
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch import kernels
from repro_torch.kernels import ops, ref

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=1e-4, atol=1e-4)
PACK = {"int4": 2, "int2": 4, "nf4": 2, "int8": 1}


def _t(a):
    return torch.as_tensor(np.array(a))


def _both(fn, *args, **kw):
    """The reference op through its Pallas kernel (interpret mode) and its
    XLA path, as numpy."""
    return [np.asarray(fn(*args, backend=be, **kw)) for be in ("pallas", "xla")]


def test_library_is_exported_as_the_reference_exports_it():
    assert kernels.ops is ops and kernels.ref is ref
    assert {"matmul", "dequant_matmul", "mla"} <= set(ops.KERNELS)
    assert len(ops.KERNELS) == 14
    assert ops.KERNELS["matmul"].replaces == "src/repro/kernels/matmul.py:15"
    assert ops.KERNELS["dequant_matmul"].replaces == "src/repro/kernels/dequant_matmul.py:25"
    assert ops.KERNELS["mla"].replaces == "src/repro/kernels/mla.py:33"
    np.testing.assert_array_equal(ref.NF4_CODEBOOK.numpy(), jref.NF4_CODEBOOK)


# ---------------------------------------------------------------------------
# the plain versions against the reference's kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,cfg", jmm.PARITY_CASES, ids=[n for n, _ in jmm.PARITY_CASES])
def test_matmul_matches_reference_parity_cases(name, cfg):
    rng = np.random.default_rng(0)
    a = rng.standard_normal((cfg["M"], cfg["K"]), dtype=np.float32)
    b = rng.standard_normal((cfg["K"], cfg["N"]), dtype=np.float32)
    got = ops.matmul(_t(a), _t(b)).numpy()
    for want in _both(jops.matmul, a, b, block_m=cfg["block_M"], block_n=cfg["block_N"],
                      block_k=cfg["block_K"]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("m,n,k", [(1, 64, 48), (1, 40, 96), (37, 24, 48), (64, 32, 128)])
def test_matmul_matches_reference_at_any_shape(m, n, k):
    """M = 1 (the paper's GEMV rows) and shapes no power-of-two block
    divides: the reference falls back to whole extents (``_pick_block``)."""
    rng = np.random.default_rng(m * 1000 + n + k)
    a = rng.standard_normal((m, k), dtype=np.float32)
    b = rng.standard_normal((k, n), dtype=np.float32)
    got = ops.matmul(_t(a), _t(b)).numpy()
    for want in _both(jops.matmul, a, b):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_matmul_16bit_operands_round_once_as_the_reference(dtype):
    """16-bit operands, fp32 sums: the fp32 result at 1e-4, and the 16-bit
    one within one ulp of the output type (the two fp32 sums, in different
    orders, may straddle a rounding)."""
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, 48), dtype=np.float32)
    b = rng.standard_normal((48, 24), dtype=np.float32)
    ja, jb = jnp.asarray(a, dtype), jnp.asarray(b, dtype)
    tdt = getattr(torch, dtype)
    ta, tb = _t(ja.astype(jnp.float32)).to(tdt), _t(jb.astype(jnp.float32)).to(tdt)
    ulp = 2.0 ** -7 if dtype == "bfloat16" else 2.0 ** -10  # relative, at worst
    for out in (tdt, torch.float32):
        got = ops.matmul(ta, tb, out_dtype=out).float().numpy()
        want = np.asarray(jops.matmul(ja, jb, backend="xla",
                                      out_dtype=jnp.dtype(str(out)[6:])).astype(jnp.float32))
        if out == torch.float32:
            np.testing.assert_allclose(got, want, **TOL)
        else:
            np.testing.assert_allclose(got, want, rtol=ulp, atol=1e-6)


def _dq_inputs(rng, m, n, k, fmt, groups=None, adtype=np.float32):
    if adtype == np.int8:
        a = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    else:
        a = rng.standard_normal((m, k), dtype=np.float32)
    bp = rng.integers(-128, 128, size=(n, k // PACK[fmt])).astype(np.int8)
    sc = None
    if groups:
        sc = (rng.standard_normal((n, groups), dtype=np.float32) * 0.1).astype(np.float32)
    return a, bp, sc


@pytest.mark.parametrize("name,cfg", jdq.PARITY_CASES, ids=[n for n, _ in jdq.PARITY_CASES])
def test_dequant_matmul_matches_reference_parity_cases(name, cfg):
    """Every format, and the odd K (48: three 16-wide K blocks)."""
    rng = np.random.default_rng(1)
    a, bp, _ = _dq_inputs(rng, cfg["M"], cfg["N"], cfg["K"], cfg["fmt"])
    got = ops.dequant_matmul(_t(a), _t(bp), fmt=cfg["fmt"]).numpy()
    for want in _both(jops.dequant_matmul, a, bp, fmt=cfg["fmt"], block_m=cfg["block_M"],
                      block_n=cfg["block_N"], block_k=cfg["block_K"]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt,block_k", [("int4", 32), ("int2", 32), ("nf4", 64), ("int8", 16)])
def test_dequant_matmul_with_scales_matches_reference(fmt, block_k):
    """Per-group scales (tests/test_kernels.py:167-178): one group a K block,
    the layout the reference's kernel takes (its ops take the plain path for
    any other)."""
    rng = np.random.default_rng(2)
    m, n, k = 32, 32, 128
    a, bp, sc = _dq_inputs(rng, m, n, k, fmt, groups=k // block_k)
    got = ops.dequant_matmul(_t(a), _t(bp), fmt=fmt, scales=_t(sc)).numpy()
    for want in _both(jops.dequant_matmul, a, bp, fmt=fmt, scales=sc, block_k=block_k):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("fmt", ["int4", "int2", "nf4", "int8"])
@pytest.mark.parametrize("adtype", ["float16", "int8"])
def test_dequant_matmul_fp16_and_int8_activations_match_reference(fmt, adtype):
    """The paper's W_INTx A_FP16 and W_INT2/INT4 A_INT8 rows, M = 1 and 8,
    float32 out (bench_dequant.py:42), against the reference's XLA path."""
    rng = np.random.default_rng(4)
    for m in (1, 8):
        a, bp, _ = _dq_inputs(rng, m, 24, 64, fmt,
                              adtype=np.int8 if adtype == "int8" else np.float32)
        ja = jnp.asarray(a, adtype)
        ta = _t(ja.astype(jnp.float32)).to(getattr(torch, adtype))
        got = ops.dequant_matmul(ta, _t(bp), fmt=fmt, out_dtype=torch.float32).numpy()
        want = np.asarray(jops.dequant_matmul(ja, bp, fmt=fmt, backend="xla",
                                              out_dtype=jnp.float32))
        np.testing.assert_allclose(got, want, **TOL)
        if adtype == "int8" and fmt != "nf4":  # integer products: the sum is exact
            np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("fmt", ["int4", "int2", "nf4"])
def test_unpacked_codes_equal_the_reference_byte_for_byte(fmt):
    rng = np.random.default_rng(5)
    packed = rng.integers(-128, 128, size=(7, 33)).astype(np.int8)
    packed[0, :16] = np.arange(-128, 128, 16)  # every high nibble and sign
    fn = {"int4": "unpack_int4", "int2": "unpack_int2", "nf4": "unpack_nf4"}[fmt]
    got = getattr(ref, fn)(_t(packed)).numpy()
    want = np.asarray(getattr(jref, fn)(packed))
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_mla_matches_reference_parity_case():
    cfg = dict(jmla.PARITY_CASES)["mla"]
    b, h, hkv, s = cfg["batch"], cfg["heads"], cfg["kv_head_num"], cfg["seqlen_kv"]
    d, pe = cfg["dim"], cfg["pe_dim"]
    rng = np.random.default_rng(6)
    q, qp = (rng.standard_normal((b, h, x), dtype=np.float32) for x in (d, pe))
    kv, kp = (rng.standard_normal((b, s, hkv, x), dtype=np.float32) for x in (d, pe))
    got = ops.mla(_t(q), _t(qp), _t(kv), _t(kp)).numpy()
    for want in _both(jops.mla, q, qp, kv, kp, block_n=cfg["block_N"], block_h=cfg["block_H"]):
        np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("b,h,hkv,s,d,pe,bn,bh", [
    (1, 16, 1, 128, 64, 16, 32, 16), (2, 8, 1, 64, 32, 8, 32, 8),
    (1, 32, 2, 128, 64, 32, 64, 16)])
def test_mla_matches_reference_tests_shapes(b, h, hkv, s, d, pe, bn, bh):
    """tests/test_kernels.py:123-128, two latent heads included, with an
    explicit scale on the XLA side."""
    rng = np.random.default_rng(7)
    q, qp = (rng.standard_normal((b, h, x), dtype=np.float32) for x in (d, pe))
    kv, kp = (rng.standard_normal((b, s, hkv, x), dtype=np.float32) for x in (d, pe))
    got = ops.mla(_t(q), _t(qp), _t(kv), _t(kp)).numpy()
    want = np.asarray(jops.mla(q, qp, kv, kp, backend="pallas", block_n=bn, block_h=bh))
    np.testing.assert_allclose(got, want, **TOL)
    got = ops.mla(_t(q), _t(qp), _t(kv), _t(kp), sm_scale=0.05).numpy()
    want = np.asarray(jops.mla(q, qp, kv, kp, backend="xla", sm_scale=0.05))
    np.testing.assert_allclose(got, want, **TOL)


# ---------------------------------------------------------------------------
# the card path, with the kernel call recorded
# ---------------------------------------------------------------------------


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's: it sends a
    wrapper down its kernel path."""

    @property
    def is_cuda(self):
        return True


@pytest.fixture
def card_path(monkeypatch):
    """Replace each library kernel's C entry point by a recorder, the CUDA
    stream by a stand-in, and every plain version by a failure: returns the
    recorded calls by kernel name."""
    calls = {}
    for name in ("matmul", "dequant_matmul", "mla"):
        def fn(*args, _name=name):
            calls.setdefault(_name, []).append(args)
            return 0
        monkeypatch.setattr(ops.KERNELS[name], "function", lambda _fn=fn: _fn)
        monkeypatch.setattr(ops.KERNELS[name], "launches", 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))

    def no_plain(*a, **kw):
        raise AssertionError("a CUDA tensor reached the plain version")
    for fn in ("matmul", "dequant_matmul", "mla"):
        monkeypatch.setattr(ref, fn, no_plain)
    return calls


def _card(t):
    return t.as_subclass(_OnCard)


def test_card_path_launches_the_kernels_and_never_the_plain_versions(card_path):
    a, b = _card(torch.randn(8, 64).bfloat16()), _card(torch.randn(64, 40).bfloat16())
    ops.matmul(a, b)
    ops.matmul(_card(torch.randn(3, 5)), _card(torch.randn(5, 7)), out_dtype=torch.float16)
    (dt, odt, *_, m, n, k, tc, _stream), (dt2, odt2, *_, tc2, _s) = card_path["matmul"]
    assert (dt, odt, m, n, k) == (1, 1, 8, 40, 64) and dt2 == 0 and odt2 == 2
    assert tc2 == 0  # fp32 operands take the CUDA-core GEMM
    bq = _card(torch.randint(-128, 128, (40, 32), dtype=torch.int8))
    ops.dequant_matmul(_card(torch.randn(8, 64).half()), bq, fmt="int4")
    ops.dequant_matmul(_card(torch.randint(-128, 128, (8, 64), dtype=torch.int8)), bq,
                       fmt="int4", out_dtype=torch.float32)
    sc = _card(torch.rand(40, 2))
    ops.dequant_matmul(_card(torch.randn(8, 64).bfloat16()), bq, fmt="nf4", scales=sc)
    (c0, c1, c2) = card_path["dequant_matmul"]
    assert c0[:3] == (2, 2, 1) and c1[:3] == (3, 0, 1) and c2[:3] == (1, 1, 3)
    assert c2[-3] == 32 and c2[5] is not None  # a group of 32, scales handed over
    q, qp = _card(torch.randn(2, 32, 512).bfloat16()), _card(torch.randn(2, 32, 64).bfloat16())
    kv = _card(torch.randn(2, 100, 2, 512).bfloat16())
    kp = _card(torch.randn(2, 100, 2, 64).bfloat16())
    out = ops.mla(q, qp, kv, kp)
    (call,) = card_path["mla"]
    assert tuple(out.shape) == (2, 32, 512) and call[7:14] == (2, 32, 2, 100, 512, 64, 16)
    assert call[:2] == (1, 1)  # bf16 at D 512, Dpe 64: the wgmma kernel
    assert abs(call[14] - (512 + 64) ** -0.5) < 1e-9
    assert [ops.KERNELS[n].launches for n in ("matmul", "dequant_matmul", "mla")] == [2, 3, 1]


@pytest.mark.parametrize("fmt,k,groups", [
    ("int4", 48, 5),    # 48 / 5 is no whole group
    ("int2", 48, 16),   # a group of 3 splits int2's four codes a byte
    ("nf4", 64, 64),    # a group of 1 splits nf4's two codes a byte
])
def test_card_path_raises_for_a_scale_group_the_kernel_cannot_take(card_path, fmt, k, groups):
    """The reference's ops take the plain path here (ops.py:709-713); the
    port's card path raises instead, and never reaches the plain version."""
    a = _card(torch.randn(4, k).half())
    bq = _card(torch.randint(-128, 128, (16, k // PACK[fmt]), dtype=torch.int8))
    with pytest.raises(ValueError, match="scale groups"):
        ops.dequant_matmul(a, bq, fmt=fmt, scales=_card(torch.rand(16, groups)))
    assert "dequant_matmul" not in card_path
    # a group the kernel takes though it matches no K tile of the kernel's
    ops.dequant_matmul(a, bq, fmt=fmt, scales=_card(torch.rand(16, 1)))
    assert card_path["dequant_matmul"][0][-3] == k


# ---------------------------------------------------------------------------
# chip_smoke.py's library phase, rehearsed
# ---------------------------------------------------------------------------


def test_chip_smoke_library_phase_rehearses_on_the_cpu():
    """The library phase at reduced shapes with CPU tensors (the plain
    versions; untimed): every kernel reads 0 from its plain version, the
    controls are computed, and every planted fault fails its limit."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    cpu = torch.device("cpu")
    gemm = {"M0": (64, 32, 256), "V0": (1, 48, 512)}
    dequant = {"m8": (8, 32, 256), "m24": (24, 16, 192)}
    mla = {"b2_s64": (2, 32, 1, 64, 64, 16)}
    res, launches = cs.library_phase(torch, ref, None, cpu, gemm=gemm, dequant=dequant,
                                     mla=mla, ragged=cs.reduced_ragged(), timed=False)
    assert launches == {"matmul": 0, "dequant_matmul": 0, "mla": 0}
    rows = [r for r in res if r["kernel"] == "dequant_matmul"]
    assert len(rows) == 2 * len(cs.DEQUANT_ROWS) + len(cs.reduced_ragged()["dequant_matmul"])
    for r in res:
        assert cs.library_ok(r), r
        assert r["err"] == 0.0, r
        for fault in r.get("faults", {}).values():
            assert fault > r["limit"], r
    assert any(r.get("faults") for r in res if r["kernel"] == "matmul")
    assert any(r.get("faults") for r in res if r["kernel"] == "dequant_matmul")
    assert {r["label"] for r in res if r["kernel"] == "mla"} >= {"b2_s64 bfloat16"}
