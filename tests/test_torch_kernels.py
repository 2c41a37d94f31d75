"""The port's paged-attention and chunked-prefill kernels on the CPU, held
against the JAX package.

On the CPU the port's wrappers run their kernels' plain PyTorch versions;
the reference runs its tile kernels in Pallas interpret mode
(``backend="pallas"``, as tests/test_kernels.py does) and its XLA oracle
(``backend="xla"``).  The same numpy inputs, made from a seed, go to both.
Tolerance: atol 1e-4 / rtol 1e-4 in fp32 (the two sides differ only in the
order of fp32 sums and exp versus exp2).  The CUDA kernels themselves run
only on a card: tests/test_torch_cuda.py holds them against their plain
versions there and skips elsewhere.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import paged_attention as PA
from repro_torch.kernels import prefill_attention as PF

TOL = dict(rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _tables(rng, b, mp, num_pages):
    t = rng.permutation(num_pages - 1)[: b * mp] + 1  # page 0 reserved
    return t.reshape(b, mp).astype("int32")


# ---------------------------------------------------------------------------
# decode: paged_attention
# ---------------------------------------------------------------------------

DECODE_CASES = [
    # (name, b, hq, hkv, d, ps, mp, num_pages, window)
    ("mqa", 3, 2, 1, 16, 16, 4, 14, None),
    ("gqa", 3, 4, 2, 16, 16, 4, 14, None),
    ("sliding_window", 3, 4, 2, 16, 16, 4, 14, 20),
]


@pytest.mark.parametrize("case", DECODE_CASES, ids=[c[0] for c in DECODE_CASES])
def test_paged_attention_matches_reference(case):
    _, b, hq, hkv, d, ps, mp, num_pages, window = case
    rng = np.random.default_rng(0)
    tables = _tables(rng, b, mp, num_pages)
    lens = rng.integers(1, mp * ps + 1, size=b).astype("int32")
    lens[1] = 0  # an empty slot emits zeros
    q = rng.standard_normal((b, hq, d)).astype("float32")
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                              window=window).numpy()
    assert np.all(got[1] == 0.0)
    for be in ("pallas", "xla"):
        want = np.asarray(jops.paged_attention(
            q, jnp.asarray(kp), jnp.asarray(vp), tables, lens, window=window,
            backend=be))
        np.testing.assert_allclose(got, want, err_msg=be, **TOL)


def test_paged_attention_soft_cap_routes_to_plain_path():
    """The reference's routing rule (ops.py:247): soft-capped scores take the
    plain path, whatever the backend or device."""
    rng = np.random.default_rng(1)
    b, hq, hkv, d, ps, mp, num_pages = 2, 4, 2, 16, 16, 2, 6
    tables = _tables(rng, b, mp, num_pages)
    lens = np.array([20, 7], np.int32)
    q = rng.standard_normal((b, hq, d)).astype("float32") * 4
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    got = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                              logit_soft_cap=2.0).numpy()
    want = np.asarray(jops.paged_attention(
        q, jnp.asarray(kp), jnp.asarray(vp), tables, lens, logit_soft_cap=2.0,
        backend="pallas"))
    np.testing.assert_allclose(got, want, **TOL)
    uncapped = ops.paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens)).numpy()
    assert not np.allclose(got, uncapped, atol=1e-3)


# ---------------------------------------------------------------------------
# chunked prefill: prefill_attention (mirrors tests/test_prefill.py:39-121)
# ---------------------------------------------------------------------------

PREFILL_CASES = [
    # (name, b, hq, hkv, d, chunk, ps, mp, num_pages, window, lens)
    ("mqa", 2, 2, 1, 16, 16, 16, 4, 10, None, None),
    ("gqa_multi_page_chunk", 2, 4, 2, 16, 32, 16, 4, 10, None, None),
    ("sliding_window", 2, 2, 2, 16, 16, 16, 4, 10, 20, None),
    ("partial_final_chunk", 2, 4, 2, 16, 32, 16, 4, 10, None, (32, 19)),
    ("idle_slot", 2, 4, 2, 16, 32, 16, 4, 10, None, (0, 21)),
]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_prefill_attention_matches_reference_and_writes_pages(case):
    _, b, hq, hkv, d, chunk, ps, mp, num_pages, window, lens = case
    rng = np.random.default_rng(2)
    tables = _tables(rng, b, mp, num_pages)
    starts = (rng.integers(0, mp - chunk // ps + 1, size=b) * ps).astype("int32")
    if lens is None:
        lens = rng.integers(1, chunk + 1, size=b)
    lens = np.asarray(lens, np.int32)
    q = rng.standard_normal((b, hq, chunk, d)).astype("float32")
    kn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    vn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    k_t, v_t = _t(kp.copy()), _t(vp.copy())
    out, k2, v2 = ops.prefill_attention(
        _t(q), _t(kn), _t(vn), k_t, v_t, _t(tables), _t(starts), _t(lens),
        window=window)
    assert k2 is k_t and v2 is v_t  # the pools are written in place
    got = {"torch": (out.numpy(), k2.numpy(), v2.numpy())}
    for be in ("pallas", "xla"):
        o, kj, vj = jops.prefill_attention(
            q, kn, vn, jnp.asarray(kp), jnp.asarray(vp), tables, starts, lens,
            window=window, backend=be)
        got[be] = (np.asarray(o), np.asarray(kj), np.asarray(vj))
        np.testing.assert_allclose(got["torch"][0], got[be][0], err_msg=be, **TOL)
    # every path places the chunk's live K/V in the table-mapped pages ...
    for name, (_, kq, vq) in got.items():
        for bi in range(b):
            for c in range(int(lens[bi])):
                pos = int(starts[bi]) + c
                pg, of = tables[bi, pos // ps], pos % ps
                np.testing.assert_array_equal(kq[:, pg, of], kn[bi, :, c], err_msg=name)
                np.testing.assert_array_equal(vq[:, pg, of], vn[bi, :, c], err_msg=name)
        # ... and pages no chunk writes keep their contents
        written = {int(tables[bi, min((int(starts[bi]) + c) // ps, mp - 1)])
                   for bi in range(b) for c in range(chunk)} | {0}
        for pg in range(num_pages):
            if pg not in written:
                np.testing.assert_array_equal(kq[:, pg], kp[:, pg], err_msg=name)
                np.testing.assert_array_equal(vq[:, pg], vp[:, pg], err_msg=name)


def test_prefill_idle_slot_at_unaligned_position_never_clobbers():
    """A lens=0 slot at an arbitrary, non-page-aligned position beyond its
    table writes only into the sink page 0 (tests/test_prefill.py:92)."""
    rng = np.random.default_rng(3)
    b, hq, hkv, d, chunk, ps, mp, num_pages = 2, 2, 1, 16, 16, 16, 4, 10
    tables = _tables(rng, b, mp, num_pages)
    starts = np.array([0, 61], np.int32)
    lens = np.array([chunk, 0], np.int32)
    q = rng.standard_normal((b, hq, chunk, d)).astype("float32")
    kn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    vn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    _, k2, v2 = ops.prefill_attention(
        _t(q), _t(kn), _t(vn), _t(kp.copy()), _t(vp.copy()), _t(tables),
        _t(starts), _t(lens))
    slot0 = {int(tables[0, c // ps]) for c in range(chunk)}
    for pg in range(1, num_pages):
        if pg not in slot0:
            np.testing.assert_array_equal(k2.numpy()[:, pg], kp[:, pg])
            np.testing.assert_array_equal(v2.numpy()[:, pg], vp[:, pg])


def test_prefill_unaligned_chunk_routes_to_plain_path():
    """``chunk % page_size != 0`` takes the plain path (ops.py:290), whose
    output matches the reference's XLA path."""
    rng = np.random.default_rng(4)
    b, hq, hkv, d, chunk, ps, mp, num_pages = 2, 4, 2, 16, 6, 4, 6, 14
    tables = _tables(rng, b, mp, num_pages)
    starts = np.array([0, 12], np.int32)
    lens = np.array([6, 4], np.int32)
    q = rng.standard_normal((b, hq, chunk, d)).astype("float32")
    kn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    vn = rng.standard_normal((b, hkv, chunk, d)).astype("float32")
    kp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    vp = rng.standard_normal((hkv, num_pages, ps, d)).astype("float32")
    out, k2, _ = ops.prefill_attention(
        _t(q), _t(kn), _t(vn), _t(kp.copy()), _t(vp.copy()), _t(tables),
        _t(starts), _t(lens))
    o, kj, _ = jops.prefill_attention(
        q, kn, vn, jnp.asarray(kp), jnp.asarray(vp), tables, starts, lens,
        backend="pallas")  # the reference routes this shape to XLA too
    np.testing.assert_allclose(out.numpy(), np.asarray(o), **TOL)
    np.testing.assert_array_equal(k2.numpy()[:, 1:], np.asarray(kj)[:, 1:])


def test_wrappers_take_the_plain_version_only_for_cpu_tensors():
    """A CPU tensor runs the plain version and counts no launch; the launch
    counters move only where a kernel launches."""
    rng = np.random.default_rng(5)
    q = _t(rng.standard_normal((2, 4, 16)).astype("float32"))
    kp = _t(rng.standard_normal((2, 5, 4, 16)).astype("float32"))
    tables = _t(np.array([[1, 2], [3, 4]], np.int32))
    lens = _t(np.array([5, 8], np.int32))
    before = (PA.KERNEL.launches, PF.KERNEL.launches)
    got = PA.paged_attention(q, kp, kp, tables, lens)
    want = ref.paged_attention(q, kp, kp, tables, lens)
    assert torch.equal(got, want)
    assert (PA.KERNEL.launches, PF.KERNEL.launches) == before
    assert PA.KERNEL.replaces == "src/repro/kernels/paged_attention.py:32"
    assert PF.KERNEL.replaces == "src/repro/kernels/prefill_attention.py:44"
    assert PA.KERNEL.source.exists() and PF.KERNEL.source.exists()
