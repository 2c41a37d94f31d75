"""The MLA tile programs of the port (``repro_torch.kernels.mla``: FlashMLA,
the paged MLA decode and chunked prefill, fp and quantized) and the
shared-memory plan's per-block global workspace, against the JAX package's
programs on the CPU:

* the verifier's obligations of the four paged programs: only the kinds the
  dispatch guard discharges, each naming the block table, field for field
  the JAX package's (``tests/test_verify.py:165``);
* the chunked prefills' page writes through the port's reference and
  sanitizing interpreters against the JAX package's reference interpreter
  on the same numpy inputs: the chunk's live latent and rope rows (packed
  bytes and scales for the twin) land in their table-mapped pages, pages no
  chunk owns keep their contents, an idle slot at an unaligned start never
  clobbers a live page; page 0, the sink several cells write, excluded;
* the plans at deepseek-v2-lite-16B's serving shape reckoned by hand: the
  decodes fit with nothing in the workspace; the prefills are refused
  without ``Schedule(workspace=True)`` and fit with it, their largest
  buffers in the workspace; a plan that fits moves nothing (the paged
  programs at qwen2-1.5B's serving shape, every parity case); FlashMLA at
  row 5's shape with blocks 64 x 32;
* ``mla.fig18_plain``, the plain version of Fig. 18's own arithmetic,
  against the JAX package's ``mla_program`` in bf16 through its reference
  interpreter;
* the CUDA text of the prefill at full width (no nvcc here): the workspace
  operand, each moved buffer at its offset in the block's part, the shared
  memory the plan asks for; the launch allocating the workspace (the C call
  recorded).
"""
import contextlib
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import Schedule as JSchedule
from repro.core import analyze as janalyze
from repro.core import compile as jcompile
from repro.kernels import mla as jmla
from repro_torch.core import Schedule, ScheduleError, analyze
from repro_torch.core import compile as tl_compile
from repro_torch.core.schedule import SMEM_BYTES, WORKSPACE, plan_vmem
from repro_torch.kernels import mla, parity_programs, ref
from repro_torch.kernels import paged_attention as paged
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

_DECODE = dict(slots=2, heads=4, dim=64, pe_dim=16, page_size=8, max_pages=4, num_pages=9,
               block_H=2)
_PREFILL = dict(slots=2, heads=2, dim=64, pe_dim=16, chunk=16, page_size=8, max_pages=4,
                num_pages=9)
_PROGRAMS = {
    "mla_paged_program": _DECODE,
    "mla_paged_quant_program": dict(_DECODE, fmt="int4"),
    "mla_prefill_program": _PREFILL,
    "mla_prefill_quant_program": dict(_PREFILL, fmt="int8"),
}


@pytest.mark.parametrize("maker", sorted(_PROGRAMS))
def test_mla_program_obligations(maker):
    """Each paged MLA program owes runtime checks on its block table, of
    the kinds ``ops.guard_dispatch`` discharges, and the same ones as the
    JAX package's program: the decode reads its latent and rope pools
    through the table, the prefill also writes them through it."""
    cfg = _PROGRAMS[maker]
    m = analyze(getattr(mla, maker)(**cfg), Schedule())
    jm = janalyze(getattr(jmla, maker)(**cfg), JSchedule())
    assert m.obligations, "a paged program must owe runtime checks"
    assert {ob.kind for ob in m.obligations} <= GUARDED_KINDS
    assert all("Tables" in ob.tables for ob in m.obligations)
    assert ([(o.kind, o.param, o.tables, o.axis, o.describe()) for o in m.obligations]
            == [(o.kind, o.param, o.tables, o.axis, o.describe()) for o in jm.obligations])
    written = {o.param for o in m.obligations if o.kind == "table_writes_disjoint"}
    pools = {"KVPages", "KPePages"} | ({"KVScales", "KPeScales"} if "quant" in maker else set())
    assert written == (pools if "prefill" in maker else set())


# ---------------------------------------------------------------------------
# The chunked prefills' page writes
# ---------------------------------------------------------------------------

# (slots, heads, dim, pe_dim, chunk, page_size, max_pages, num_pages,
#  window): one chunk page, a multi-page chunk, a sliding window
_WRITE_CASES = {
    "one_page": (2, 2, 16, 8, 16, 16, 4, 10, None),
    "multipage": (2, 4, 16, 8, 32, 16, 4, 10, None),
    "windowed": (2, 2, 16, 8, 16, 16, 4, 10, 20),
}
# each pool and the chunk input whose rows it receives
_NEW = {"KVPages": "CKV", "KPePages": "KPE", "KVScales": "CKVScale", "KPeScales": "KPEScale"}


def _program(module, slots, heads, dim, pe, chunk, ps, mp, num_pages, window, fmt):
    kw = dict(slots=slots, heads=heads, dim=dim, pe_dim=pe, chunk=chunk, page_size=ps,
              max_pages=mp, num_pages=num_pages, window=window)
    if fmt is None:
        return module.mla_prefill_program(**kw)
    return module.mla_prefill_quant_program(**kw, fmt=fmt)


def _inputs(prog, rng, starts, lens):
    """The program's arguments in ``arg_params`` order: tables of distinct
    pages with page 0 reserved, the given starts and lengths, then every
    other input and the in-out pools (random bytes and positive scales for
    the quantized twin)."""
    slots, mp = prog.params[0].shape
    num_pages = next(p for p in prog.params if p.name == "KVPages").shape[0]
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
    ``chip_smoke.py`` holds the emitted kernels to (the int8 twin's
    dequantized latents reach 127 x 0.2, its outputs 25)."""
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
def test_mla_prefill_program_writes_its_pages(case, fmt, rng):
    """The chunk's live latent and rope rows (packed bytes and scales, for
    the twin) land in the table-mapped pages, pages owned by no chunk keep
    their contents, and the output and every pool equal the JAX package's,
    page 0 excluded (the lengths are ragged, so dead chunk pages write the
    sink)."""
    cfg = _WRITE_CASES[case]
    slots, chunk, ps, mp, num_pages = cfg[0], cfg[4], cfg[5], cfg[6], cfg[7]
    prog = _program(mla, *cfg, fmt)
    starts = rng.integers(0, mp - chunk // ps + 1, size=slots) * ps
    lens = rng.integers(1, chunk + 1, size=slots)
    args = _inputs(prog, rng, starts, lens)
    got, want = _run_both(prog, _program(jmla, *cfg, fmt), args)
    _assert_close(got["Output"], want["Output"])
    given = dict(zip([p.name for p in tl_compile(prog, target="reference").arg_params], args))
    tables = args[0]
    owned = {int(tables[b, (int(starts[b]) + c) // ps]) for b in range(slots)
             for c in range(chunk)}
    pools = [n for n in got if n != "Output"]
    assert len(pools) == (2 if fmt is None else 4)
    for pool in pools:
        np.testing.assert_array_equal(got[pool][1:], want[pool][1:], err_msg=pool)
        for b in range(slots):
            for c in range(int(lens[b])):
                pos = int(starts[b]) + c
                pg, of = tables[b, pos // ps], pos % ps
                np.testing.assert_array_equal(got[pool][pg, of], given[_NEW[pool]][b, c])
        for pg in range(1, num_pages):
            if pg not in owned:
                np.testing.assert_array_equal(got[pool][pg], given[pool][pg],
                                              err_msg=f"{pool}: unowned page {pg} clobbered")


@pytest.mark.parametrize("fmt", [None, "int8"])
def test_mla_prefill_program_idle_slot_never_clobbers(fmt, rng):
    """A slot with no live token riding in the batch, at an unaligned start
    whose chunk would run past its table row, writes only the reserved page
    0 (its table index clamped in range): every page slot 0 does not own
    keeps its contents, as in the JAX package."""
    cfg = (2, 2, 16, 8, 16, 16, 4, 10, None)
    chunk, ps, num_pages = cfg[4], cfg[5], cfg[7]
    prog = _program(mla, *cfg, fmt)
    args = _inputs(prog, rng, [0, 61], [chunk, 0])
    got, want = _run_both(prog, _program(jmla, *cfg, fmt), args)
    given = dict(zip([p.name for p in tl_compile(prog, target="reference").arg_params], args))
    slot0 = {int(args[0][0, c // ps]) for c in range(chunk)}
    for pool in (n for n in got if n != "Output"):
        np.testing.assert_array_equal(got[pool][1:], want[pool][1:], err_msg=pool)
        for pg in range(1, num_pages):
            if pg not in slot0:
                np.testing.assert_array_equal(got[pool][pg], given[pool][pg],
                                              err_msg=f"{pool}: idle slot clobbered page {pg}")
    _assert_close(got["Output"], want["Output"])


# ---------------------------------------------------------------------------
# The plans at deepseek-v2-lite-16B's serving shape, and the workspace
# ---------------------------------------------------------------------------

# deepseek-v2-lite-16B's serving shape: 8 slots, 16 heads over a 512-wide
# latent plus 64 rope, pages of 16, 1024 tokens a slot (64 pages), chunks of
# 64, bf16
DEEPSEEK = dict(slots=8, heads=16, dim=512, pe_dim=64, page_size=16, max_pages=64,
                num_pages=8 * 64 + 1, dtype="bfloat16")
WS = Schedule(workspace=True)


def _layout(plan):
    return [(b.name, b.offset, b.bytes, b.space) for b in plan.buffers]


def test_mla_decode_plans_fit_with_nothing_in_the_workspace():
    """The decode's block at deepseek-v2-lite-16B's serving shape holds 16
    heads: the query and rope tiles, one page of latent and rope, the
    scores, the output accumulator and five fp32 rows; the tensor-core
    operands whose rows are whole 128-byte lines one vector wider.  The
    int8 twin adds two dequant stages (packed bytes, their unpack scratch,
    scales, the dequantized tile and the operand), one buffer after another.
    Both fit: the workspace field moves nothing."""
    q, qpe = 16 * 520 * 2, 16 * 72 * 2  # Q . KV^T and Q_pe . K_pe^T operands
    kv, kpe = 16 * 520 * 2, 16 * 72 * 2  # the page's latent (also P.V's V) and rope
    acc_s, acc_o, rows = 16 * 16 * 4, 16 * 512 * 4, 5 * 16 * 4
    dec = analyze(mla.mla_paged_program(**DEEPSEEK))
    assert dec.vmem.total_bytes == q + qpe + kv + kpe + acc_s + acc_o + rows == 72000
    stage = lambda rows_, feat, out: rows_ * feat * 2 + rows_ * 8 * 2 + rows_ * feat * 2 + out  # noqa
    quant = analyze(mla.mla_paged_quant_program(**DEEPSEEK, fmt="int8"))
    assert quant.vmem.total_bytes == (q + qpe + stage(16, 512, kv) + stage(16, 64, kpe)
                                      + acc_s + acc_o + rows) == 109376
    for prog in (mla.mla_paged_program(**DEEPSEEK),
                 mla.mla_paged_quant_program(**DEEPSEEK, fmt="int8")):
        plain, ws = plan_vmem(prog, Schedule()), plan_vmem(prog, WS)
        assert ws.workspace_bytes == 0 and not ws.workspace() and ws.ok
        assert _layout(ws) == _layout(plain) and ws.total_bytes <= SMEM_BYTES


def test_mla_prefill_plans_need_the_workspace():
    """The prefill's block packs a page's 16 positions with all 16 heads,
    256 query rows: its output accumulator alone (256 x 512 fp32) is
    524,288 bytes.  Without the workspace field the plan is refused; with
    it the largest buffers move to the block's part of the workspace until
    the rest fits: the accumulator and the query tile for the fp prefill,
    and for the int8 twin also the chunk's score tile and its dequantized
    latent.  The moved buffers are live together, so they follow one
    another."""
    q = 256 * 520 * 2  # the query tile, a Q . K^T operand: 266,240
    acc_o = 256 * 512 * 4  # 524,288
    acc_c = 256 * 68 * 4  # the chunk's scores (a wmma accumulator): 69,632
    kc = 64 * 520 * 2  # the chunk's dequantized latent (an operand): 66,560
    for prog, moved, ws_bytes, shared in (
            (mla.mla_prefill_program(**DEEPSEEK, chunk=64), [q, acc_o], 790528, 187392),
            (mla.mla_prefill_quant_program(**DEEPSEEK, chunk=64, fmt="int8"),
             [q, kc, acc_c, acc_o], 926720, 184320)):
        with pytest.raises(ScheduleError, match="shared-memory budget exceeded"):
            plan_vmem(prog, Schedule())
        with pytest.raises(ScheduleError, match="shared-memory budget exceeded"):
            tl_compile(prog, target="cuda", use_cache=False)
        plan = plan_vmem(prog, WS)
        inws = [b for b in plan.buffers if b.space == WORKSPACE]
        assert [b.bytes for b in inws] == moved  # in allocation order
        assert [b.name for b in inws] == plan.workspace()
        # the query tile is the first allocation, the accumulator the
        # online softmax's first
        names = [b.name for b in prog.allocs]
        assert plan.workspace()[0] == names[0]
        assert [b.offset for b in inws] == [sum(moved[:i]) for i in range(len(moved))]
        assert plan.workspace_bytes == sum(moved) == ws_bytes
        assert plan.total_bytes == shared <= SMEM_BYTES and plan.ok
        # every buffer left in shared memory is smaller than every moved one
        assert max(b.bytes for b in plan.buffers if b.space != WORKSPACE) < min(moved)
        assert "workspace: " in plan.summary() and "[workspace]" in plan.summary()


def test_the_fp_prefills_shared_part_reckoned_by_hand():
    """What stays in shared memory in the fp prefill: the rope query tile,
    the chunk's latent and rope, one prior page of each, the prior and
    chunk score tiles and five fp32 rows; the chunk's scores, first touched
    after the prior loop, lie over the loop's page tiles and scores."""
    plan = plan_vmem(mla.mla_prefill_program(**DEEPSEEK, chunk=64), WS)
    qpe, kc, pc = 256 * 72 * 2, 64 * 520 * 2, 64 * 72 * 2
    kp, pp, acc_s = 16 * 520 * 2, 16 * 72 * 2, 256 * 16 * 4
    acc_c, rows = 256 * 68 * 4, 5 * 256 * 4
    assert kp + pp + acc_s < acc_c
    assert plan.total_bytes == qpe + kc + pc + acc_c + rows == 187392


@pytest.mark.parametrize("maker", ["decode", "decode int8", "prefill", "prefill int8"])
def test_plans_that_fit_move_nothing(maker):
    """The paged programs at qwen2-1.5B's serving shape keep their plans
    byte for byte with the workspace field on (the prefill's 137,088 bytes,
    its int8 twin's 194,304), and so does every parity program."""
    qwen = dict(slots=8, heads=12, kv_heads=2, head_dim=128, page_size=16, max_pages=64,
                num_pages=8 * 64 + 1, dtype="bfloat16")
    fmt = {"fmt": "int8"} if maker.endswith("int8") else {}
    if maker.startswith("decode"):
        make = paged.paged_attention_quant_program if fmt else paged.paged_attention_program
        prog = make(**qwen, **fmt)
    else:
        make = prefill.prefill_attention_quant_program if fmt else prefill.prefill_attention_program
        prog = make(**qwen, chunk=64, **fmt)
    plain, ws = plan_vmem(prog, Schedule()), plan_vmem(prog, WS)
    assert _layout(ws) == _layout(plain) and ws.workspace_bytes == 0
    assert ws.total_bytes == plain.total_bytes == {"prefill": 137088, "prefill int8": 194304}.get(
        maker, plain.total_bytes)
    for name, p in parity_programs():
        assert _layout(plan_vmem(p, WS)) == _layout(plan_vmem(p, Schedule())), name


def test_flash_mla_plan_at_row_5s_shape_reckoned_by_hand():
    """FlashMLA at b128_s8192 (128 heads over one latent head of 512 plus
    64 rope, 8192 keys), bf16: at blocks of 64 keys and 32 heads its tiles
    fit one block; at 64 heads they do not.  Every GEMM takes ``wmma`` (the
    scores, and P.V from the bf16 ``S_shared``), so every operand and
    accumulator whose rows are whole 128-byte lines is one vector wider."""
    def plan(block_N, block_H):
        return analyze(mla.mla_program(128, 128, 1, 8192, 512, 64, block_N=block_N,
                                       block_H=block_H, dtype="bfloat16")).vmem

    def by_hand(n, h):
        q, s, qpe = h * 520 * 2, h * 72 * 2, h * 72 * 2
        kv, kpe = n * 520 * 2, n * 72 * 2
        acc_s, acc_o, rows = h * (n + 4) * 4, h * 516 * 4, 5 * h * 4
        return q + s + qpe + kv + kpe + acc_s + acc_o + rows

    fits = plan(64, 32)
    assert fits.total_bytes == by_hand(64, 32) == 193664 <= SMEM_BYTES and fits.ok
    assert plan(64, 64).total_bytes == by_hand(64, 64) == 311552 and not plan(64, 64).ok
    grid = analyze(mla.mla_program(128, 128, 1, 8192, 512, 64, block_N=64, block_H=32,
                                   dtype="bfloat16")).grid
    assert grid == (4, 128, 128)  # 4 x 128 = 512 blocks, 128 key tiles each


# ---------------------------------------------------------------------------
# Fig. 18's own arithmetic
# ---------------------------------------------------------------------------


def _bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (an ulp of at least
    2^-16), as chip_smoke.py's bf16_ulps."""
    w = want.astype(np.float64)
    _, e = np.frexp(w)
    ulp = np.maximum(np.ldexp(1.0, e - 8), 2.0 ** -16)
    return float((np.abs(got.astype(np.float64) - w) / ulp).max())


@pytest.mark.parametrize("block_N", [16, 32])
def test_fig18_plain_is_the_jax_programs_arithmetic(block_N):
    """``mla.fig18_plain`` (the max a tile of keys, P rounded to bf16 before
    P.V) against the JAX package's ``mla_program`` in bf16 through its
    reference interpreter (which keeps the program's bf16 ``S_shared``), and
    the port's reference interpreter, on the same inputs: within one bf16
    ulp.  ``ref.mla``, which keeps P in fp32, lies farther from the
    program."""
    b, h, hkv, s, d, pe = 2, 8, 2, 128, 32, 16
    rng = np.random.default_rng(3)
    arrays = [rng.standard_normal(shape).astype(np.float32) for shape in
              ((b, h, d), (b, h, pe), (b, s, hkv, d), (b, s, hkv, pe))]
    cfg = dict(block_N=block_N, block_H=4, dtype="bfloat16")
    jout = jcompile(jmla.mla_program(b, h, hkv, s, d, pe, **cfg), target="reference")(
        *[a.astype(ml_dtypes.bfloat16) for a in arrays])
    jout = np.asarray(jout).astype(np.float32)
    ts = [torch.from_numpy(a).to(torch.bfloat16) for a in arrays]
    port = tl_compile(mla.mla_program(b, h, hkv, s, d, pe, **cfg), target="reference")(*ts)
    plain = mla.fig18_plain(*ts, block_N=block_N)
    assert plain.dtype == torch.bfloat16 and plain.shape == (b, h, d)
    assert _bf16_ulps(plain.float().numpy(), jout) <= 1.0
    assert _bf16_ulps(port.float().numpy(), jout) <= 1.0
    assert _bf16_ulps(ref.mla(*ts).float().numpy(), jout) > 1.0
    # in fp32 the arithmetic is the softmax's: within fp32 rounding of ref.mla
    t32 = [torch.from_numpy(a) for a in arrays]
    torch.testing.assert_close(mla.fig18_plain(*t32, block_N=block_N), ref.mla(*t32),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The CUDA text and launch with a workspace (no nvcc, no card)
# ---------------------------------------------------------------------------


def test_emitted_prefill_at_full_width_carries_the_workspace():
    """The fp prefill at deepseek-v2-lite-16B's serving shape, compiled with
    the workspace: the kernel takes one more operand, each block's part
    starts at its block id times the plan's workspace bytes, every moved
    buffer sits at its offset there and every other one in shared memory,
    and the launch asks for the plan's shared memory, at most 232,448
    bytes."""
    prog = mla.mla_prefill_program(**DEEPSEEK, chunk=64)
    kern = tl_compile(prog, WS, target="cuda", use_cache=False)
    plan = kern.info.vmem
    src = kern.source
    assert kern.workspace_bytes == plan.workspace_bytes == 790528
    assert kern.smem_bytes == plan.total_bytes <= SMEM_BYTES
    assert ", unsigned char* tl_ws)" in src
    assert "tl_block_ws = tl_ws + (size_t)blockIdx.x * 790528ULL;" in src
    assert f"<<<32, 128, {plan.total_bytes}, " in src
    assert "void* ws, void* stream)" in src and "static_cast<unsigned char*>(ws)" in src
    for i, b in enumerate(prog.allocs):
        p = plan.buffers[i]
        base = "tl_block_ws" if p.space == WORKSPACE else "tl_smem"
        assert f"* const s{i} = " in src and f"({base} + {p.offset});" in src, b.name
    # a program whose plan fits has no workspace operand
    fit = tl_compile(mla.mla_paged_program(**DEEPSEEK), WS, target="cuda", use_cache=False)
    assert fit.workspace_bytes == 0 and "tl_ws" not in fit.source


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's."""

    @property
    def is_cuda(self):
        return True


def test_cuda_launch_allocates_the_workspace(monkeypatch):
    """The launch of a kernel with a workspace hands the C entry point one
    more pointer, to ``blocks * workspace_bytes`` bytes allocated for the
    launch on the inputs' device, after the operands and before the stream.
    The kernel's C call is recorded (no card here)."""
    cfg = dict(dict(mla.PARITY_CASES)["mla_prefill"])
    prog = mla.mla_prefill_program(**cfg)
    kern = tl_compile(prog, Schedule(workspace=True, smem_limit=4096), target="cuda",
                      use_cache=False)
    assert kern.workspace_bytes > 0 and kern.smem_bytes <= 4096
    assert len(kern.kernel.argtypes) == len(prog.params) + 2
    calls, sizes = [], []
    empty = torch.empty

    def recording_empty(*shape, **kw):
        t = empty(*shape, **kw)
        if kw.get("dtype") is torch.uint8:
            sizes.append(t.numel())
        return t

    monkeypatch.setattr(kern.kernel, "function", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    monkeypatch.setattr(torch, "empty", recording_empty)
    args = [torch.from_numpy(a).as_subclass(_OnCard)
            for a in mla.parity_inputs("mla_prefill", prog, np.random.default_rng(0))]
    kern(*args)
    (call,) = calls
    assert len(call) == len(prog.params) + 2 and call[-1] == 0  # the stream last
    assert sizes == [kern.blocks * kern.workspace_bytes]
    assert kern.launches == 1
