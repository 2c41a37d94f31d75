"""The paged tile programs of the port (the decode and the chunked prefill,
fp and quantized; ``repro_torch.kernels.paged_attention`` and
``prefill_attention``) against the JAX package's, on the CPU:

* the verifier's obligations of all four programs: only the kinds the
  dispatch guard discharges, each naming the block table, field for field
  the JAX package's (``tests/test_verify.py:165``);
* the chunked prefill's page writes through the port's reference and
  sanitizing interpreters against the JAX package's reference interpreter on
  the same numpy inputs (``tests/test_prefill.py:39`` and ``:92``): the
  chunk's live K/V land in its table-mapped pages, pages no chunk owns keep
  their contents, an idle slot at an unaligned start never clobbers a live
  page; page 0, the sink several cells write, excluded;
* the shared-memory plan of the prefill at qwen2-1.5B's serving shape,
  reckoned by hand, and the plan's rule that two buffers share bytes only
  where their live ranges do not meet.
"""
import numpy as np
import pytest
import torch

from repro.core import Schedule as JSchedule
from repro.core import analyze as janalyze
from repro.core import compile as jcompile
from repro.kernels import paged_attention as jpaged
from repro.kernels import prefill_attention as jprefill
from repro_torch.core import Schedule, analyze
from repro_torch.core import compile as tl_compile
from repro_torch.core.schedule import SMEM_BYTES, live_ranges
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import parity_programs
from repro_torch.kernels import prefill_attention as prefill

GUARDED_KINDS = {"table_in_range", "table_writes_disjoint"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# The verifier's obligations
# ---------------------------------------------------------------------------

_DECODE = dict(slots=2, heads=2, kv_heads=1, head_dim=128, page_size=8, max_pages=4,
               num_pages=9)
_PREFILL = dict(slots=2, heads=4, kv_heads=2, head_dim=128, chunk=16, page_size=8,
                max_pages=4, num_pages=9)
_PROGRAMS = {
    "paged_attention_program": (paged, jpaged, _DECODE),
    "paged_attention_quant_program": (paged, jpaged, dict(_DECODE, fmt="int4")),
    "prefill_attention_program": (prefill, jprefill, _PREFILL),
    "prefill_attention_quant_program": (prefill, jprefill, dict(_PREFILL, fmt="int8")),
}


@pytest.mark.parametrize("maker", sorted(_PROGRAMS))
def test_paged_program_obligations(maker):
    """Each paged program owes runtime checks on its block table, of the
    kinds ``ops.guard_dispatch`` discharges, and the same ones as the JAX
    package's program: the decode reads through the table, the prefill also
    writes its pools through it."""
    port, jmod, cfg = _PROGRAMS[maker]
    m = analyze(getattr(port, maker)(**cfg), Schedule())
    jm = janalyze(getattr(jmod, maker)(**cfg), JSchedule())
    assert m.obligations, "a paged program must owe runtime checks"
    assert {ob.kind for ob in m.obligations} <= GUARDED_KINDS
    assert all("Tables" in ob.tables for ob in m.obligations)
    assert ([(o.kind, o.param, o.tables, o.axis, o.describe()) for o in m.obligations]
            == [(o.kind, o.param, o.tables, o.axis, o.describe()) for o in jm.obligations])
    written = {o.param for o in m.obligations if o.kind == "table_writes_disjoint"}
    pools = {"KPages", "VPages"} | ({"KScales", "VScales"} if "quant" in maker else set())
    assert written == (pools if maker.startswith("prefill") else set())


# ---------------------------------------------------------------------------
# The chunked prefill's page writes (tests/test_prefill.py:39 and :92)
# ---------------------------------------------------------------------------

# (slots, heads, kv_heads, head_dim, chunk, page_size, max_pages, num_pages,
#  window): MQA, GQA over a multi-page chunk, a sliding window
_WRITE_CASES = {
    "mqa": (2, 2, 1, 16, 16, 16, 4, 10, None),
    "gqa_multipage": (2, 4, 2, 16, 32, 16, 4, 10, None),
    "windowed": (2, 2, 2, 16, 16, 16, 4, 10, 20),
}


def _program(port, slots, hq, hkv, d, chunk, ps, mp, num_pages, window, fmt):
    kw = dict(slots=slots, heads=hq, kv_heads=hkv, head_dim=d, chunk=chunk, page_size=ps,
              max_pages=mp, num_pages=num_pages, window=window)
    if fmt is None:
        return port.prefill_attention_program(**kw)
    return port.prefill_attention_quant_program(**kw, fmt=fmt)


def _inputs(prog, rng, starts, lens):
    """The program's arguments in ``arg_params`` order: tables of distinct
    pages with page 0 reserved, the given starts and lengths, then every
    other input and the in-out pools (random bytes and positive scales for
    the quantized twin)."""
    slots, mp = prog.params[0].shape
    num_pages = next(p for p in prog.params if p.name == "KPages").shape[1]
    tables = (rng.permutation(num_pages - 1)[: slots * mp] + 1).reshape(slots, mp)

    def fill(p):
        if p.dtype == "int8":
            return rng.integers(-128, 128, size=p.shape).astype(np.int8)
        if p.name.endswith(("Scale", "Scales")):
            return rng.uniform(0.05, 0.2, size=p.shape).astype(np.float32)
        return rng.standard_normal(p.shape).astype(np.float32)

    args = [tables.astype(np.int32), np.asarray(starts, np.int32), np.asarray(lens, np.int32)]
    args += [fill(p) for p in prog.input_params()[3:]]
    args += [fill(p) for p in prog.output_params() if p.name != "Output"]
    return args


def _assert_close(got, want):
    """Within 1e-5 of max(1, max |want|), the limit phase 17 of
    ``chip_smoke.py`` holds the emitted kernels to: the int8 twin's
    dequantized keys and values reach 127 x 0.2, its outputs 25, where fp32
    sums in another order move an element by 3e-5 (``_JAX_BACKENDS_APART``
    of ``tests/test_torch_pipeline.py``)."""
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * max(1.0, np.abs(want).max()))


def _run_both(port_prog, jax_prog, args):
    """The port's reference and sanitizing interpreters and the JAX
    package's reference interpreter on the same numpy inputs; the port's
    two agree bit for bit.  Returns (port outputs, JAX outputs) by name."""
    rk = tl_compile(port_prog, target="reference")
    ts = [torch.from_numpy(a.copy()) for a in args]
    got = rk(*ts)
    for g, s in zip(got, tl_compile(port_prog, target="sanitize")(*ts), strict=True):
        assert torch.equal(g, s)
    want = jcompile(jax_prog, target="reference")(*args)
    names = [p.name for p in rk.out_params]
    return (dict(zip(names, (g.numpy() for g in got), strict=True)),
            dict(zip(names, (np.asarray(w) for w in want), strict=True)))


@pytest.mark.parametrize("fmt", [None, "int8"])
@pytest.mark.parametrize("case", sorted(_WRITE_CASES))
def test_prefill_program_writes_its_pages(case, fmt, rng):
    """The chunk's live K/V (packed bytes and scales, for the twin) land in
    the table-mapped pages, pages owned by no chunk keep their contents, and
    the output and every pool equal the JAX package's, page 0 excluded (the
    lengths are ragged, so dead chunk pages write the sink)."""
    cfg = _WRITE_CASES[case]
    slots, chunk, ps, mp, num_pages = cfg[0], cfg[4], cfg[5], cfg[6], cfg[7]
    prog = _program(prefill, *cfg, fmt)
    starts = rng.integers(0, mp - chunk // ps + 1, size=slots) * ps
    lens = rng.integers(1, chunk + 1, size=slots)
    args = _inputs(prog, rng, starts, lens)
    got, want = _run_both(prog, _program(jprefill, *cfg, fmt), args)
    _assert_close(got["Output"], want["Output"])
    given = dict(zip([p.name for p in tl_compile(prog, target="reference").arg_params], args))
    tables = args[0]
    new = {"KPages": "K", "VPages": "V", "KScales": "KScale", "VScales": "VScale"}
    owned = {int(tables[b, (int(starts[b]) + c) // ps]) for b in range(slots)
             for c in range(chunk)}
    for pool in (n for n in got if n != "Output"):
        np.testing.assert_array_equal(got[pool][:, 1:], want[pool][:, 1:], err_msg=pool)
        for b in range(slots):
            for c in range(int(lens[b])):
                pos = int(starts[b]) + c
                pg, of = tables[b, pos // ps], pos % ps
                np.testing.assert_array_equal(got[pool][:, pg, of], given[new[pool]][b, :, c])
        for pg in range(1, num_pages):
            if pg not in owned:
                np.testing.assert_array_equal(got[pool][:, pg], given[pool][:, pg],
                                              err_msg=f"{pool}: unowned page {pg} clobbered")


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_prefill_program_idle_slot_never_clobbers(fmt, rng):
    """A slot with no live token riding in the batch, at an unaligned start
    whose chunk would run past its table row, writes only the reserved page
    0 (its table index clamped in range): every page slot 0 does not own
    keeps its contents, as in the JAX package."""
    cfg = (2, 2, 1, 16, 16, 16, 4, 10, None)
    chunk, ps, num_pages = cfg[4], cfg[5], cfg[7]
    prog = _program(prefill, *cfg, fmt)
    args = _inputs(prog, rng, [0, 61], [chunk, 0])
    got, want = _run_both(prog, _program(jprefill, *cfg, fmt), args)
    given = dict(zip([p.name for p in tl_compile(prog, target="reference").arg_params], args))
    slot0 = {int(args[0][0, c // ps]) for c in range(chunk)}
    for pool in (n for n in got if n != "Output"):
        np.testing.assert_array_equal(got[pool][:, 1:], want[pool][:, 1:], err_msg=pool)
        for pg in range(1, num_pages):
            if pg not in slot0:
                np.testing.assert_array_equal(got[pool][:, pg], given[pool][:, pg],
                                              err_msg=f"{pool}: idle slot clobbered page {pg}")
    _assert_close(got["Output"], want["Output"])


# ---------------------------------------------------------------------------
# The shared-memory plan
# ---------------------------------------------------------------------------

# qwen2-1.5B's serving shape: 8 slots, 12 query heads over 2 KV heads of 128,
# pages of 16, 1024 tokens a slot (64 pages), chunks of 64, bf16
QWEN = dict(slots=8, heads=12, kv_heads=2, head_dim=128, chunk=64, page_size=16,
            max_pages=64, num_pages=8 * 64 + 1, dtype="bfloat16")


def test_prefill_shared_memory_plan_at_qwen_serving_shape_reckoned_by_hand():
    """The fp prefill's block at qwen2-1.5B's serving shape: a query tile of
    page 16 x group 6 = 96 rows, the chunk's K and V, one prior page of K and
    V, the prior and chunk score tiles, the output accumulator and five fp32
    rows.  Tensor-core operands whose rows are whole 128-byte lines are one
    vector wider; the chunk's scores, first touched after the prior loop,
    lie over the loop's page tiles and scores."""
    m = analyze(prefill.prefill_attention_program(**QWEN))
    q = 96 * 136 * 2  # Q . K^T operand
    kc, vc = 64 * 136 * 2, 64 * 128 * 2  # the chunk's K (operand) and V (P . V: CUDA cores)
    kp, vp, acc_s = 16 * 136 * 2, 16 * 128 * 2, 96 * 16 * 4  # the loop's tiles
    acc_c = 96 * 68 * 4  # the chunk's scores, over kp + vp + acc_s (14,592 bytes)
    acc_o, rows = 96 * 128 * 4, 5 * 96 * 4
    assert kp + vp + acc_s < acc_c
    assert m.vmem.total_bytes == q + kc + vc + acc_c + acc_o + rows == 137088
    # in allocation order: Q, Kc, Vc, Kp, Vp, acc_s, acc_c, acc_o, five rows
    assert [b.offset for b in m.vmem.buffers[3:7]] == [q + kc + vc, q + kc + vc + kp,
                                                     q + kc + vc + kp + vp, q + kc + vc]
    assert m.vmem.ok and m.vmem.total_bytes <= SMEM_BYTES
    # every buffer one after another: 151,680 bytes
    assert sum(b.bytes for b in m.vmem.buffers) == 137088 + kp + vp + acc_s == 151680


def test_quantized_prefill_fits_only_by_sharing_bytes():
    """The int8 twin at the same shape stages the chunk's packed bytes,
    their unpack scratch and dequantized tiles, and the same for each prior
    page: 236,160 bytes one after another, over the block's 232,448.  The
    chunk's unpack scratch and dequantized tiles are dead before the prior
    loop begins, so the loop's tiles take their bytes and the plan fits."""
    m = analyze(prefill.prefill_attention_quant_program(**QWEN, fmt="int8"))
    stage = lambda rows, out: rows * 128 + rows * 128 + rows * 8 * 2 + rows * 128 * 2 + out  # noqa: E731
    one_after_another = (96 * 136 * 2 + stage(64, 64 * 136 * 2) + stage(64, 64 * 128 * 2)
                         + stage(16, 16 * 136 * 2) + stage(16, 16 * 128 * 2)
                         + 96 * 16 * 4 + 96 * 68 * 4 + 96 * 128 * 4 + 5 * 96 * 4)
    assert sum(b.bytes for b in m.vmem.buffers) == one_after_another == 236160 > SMEM_BYTES
    assert m.vmem.ok and m.vmem.total_bytes == 194304


@pytest.mark.parametrize("name", sorted(dict(parity_programs())))
def test_buffers_share_bytes_only_when_their_live_ranges_do_not_meet(name):
    """The plan's rule on every parity program: two buffers whose bytes
    meet are never live at one top-level op; every buffer 16-byte aligned
    and inside the plan's total."""
    m = analyze(dict(parity_programs())[name])
    live = live_ranges(m.program)  # the analysis cache may hold another trace's names
    bufs = m.vmem.buffers
    for i, a in enumerate(bufs):
        assert a.offset % 16 == 0 and a.offset + a.bytes <= m.vmem.total_bytes
        for b in bufs[:i]:
            if a.offset < b.offset + b.bytes and b.offset < a.offset + a.bytes:
                (la, ha), (lb, hb) = live[a.name], live[b.name]
                assert ha < lb or hb < la, (a.name, b.name)
