"""The port's pass pipeline, backend registry and backends (``repro_torch.
core``) against the JAX package's (``tests/test_pipeline.py``).

* the per-pass unit tests of the JAX suite on the port, and every prefix of
  ``PIPELINE`` run on ``small_gemm_program`` in both packages, the fields
  each prefix fills equal;
* across the packages, for every PARITY_CASES entry of ``kernels/matmul.py``,
  ``kernels/flash_attention.py``, ``kernels/mla.py`` (FlashMLA and the
  paged MLA decode and chunked prefill, fp and quantized),
  ``kernels/paged_attention.py``, ``kernels/prefill_attention.py``,
  ``kernels/linear_attention.py`` (the Mamba-2 SSD's chunk_state and
  chunk_scan) and ``kernels/dequant_matmul.py`` (int4, int8, int2, nf4)
  plus the quickstart's and
  ``small_gemm_program``: phases, windows (index maps evaluated at sample
  grid points), grid, dimension semantics, stages, params, cost FLOPs and
  HBM bytes and the verifier's obligations equal exactly; the shared-memory
  plan (the port's own, for the card) against bytes reckoned by hand;
* the port's ``reference`` and ``sanitize`` backends against the JAX
  package's ``reference`` backend and its ``pallas`` backend in interpret
  mode, on the same numpy inputs from a seed, at 1e-5, every output of a
  tuple (the prefill's pools too);
* the CUDA backend here, without ``nvcc`` or a card: its text exists for
  every case, is identical for two independent traces, asks for the plan's
  shared memory, keeps Python's floor rule, reads block tables from int32
  operands and seeds in-out outputs from their inputs; it takes every op of
  the T language (``T.call_tile_lib`` rewritten into T ops, nf4's codebook
  lookup among them, atomics, ``T.cumsum``, a batched ``T.gemm``), and a
  tile-library function with an aten op outside the rewrite's set raises at
  compile time without running; a ``cuda`` kernel called on CPU tensors
  raises; the SSD programs at mamba2-2.7B's training shape and the
  dequantized GEMM at Fig. 15's shape plan within the block's shared memory.
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import Schedule as JSchedule
from repro.core import compile as jcompile
from repro.core.lowering import LoweredModule as JLoweredModule
from repro.core.lowering import PIPELINE as JPIPELINE
from repro.core.lowering import make_index_map as jmake_index_map
from repro.kernels import dequant_matmul as jdequant
from repro.kernels import flash_attention as jflash
from repro.kernels import linear_attention as jlinear
from repro.kernels import matmul as jmatmul
from repro.kernels import mla as jmla
from repro.kernels import paged_attention as jpaged
from repro.kernels import prefill_attention as jprefill
from repro_torch.core import (
    LoweringError,
    Schedule,
    analyze,
    available_backends,
    compile as tl_compile,
    get_backend,
    program_fingerprint,
    register_backend,
)
from repro_torch.core import lang as T
from repro_torch.core.backends.tile_lib import lower_tile_lib
from repro_torch.core.lowering import (
    LOOP,
    PIPELINE,
    POST,
    LoweredModule,
    make_index_map,
    run_pipeline,
    schedule_key,
)
from repro_torch.core.lowering.pipeline import (
    pass_collect_windows,
    pass_estimate_cost,
    pass_plan_grid,
    pass_plan_params,
    pass_plan_stages,
    pass_plan_vmem,
    pass_split_phases,
)
from repro_torch.kernels import dequant_matmul as dequant
from repro_torch.kernels import linear_attention as linear
from repro_torch.kernels import mla
from repro_torch.kernels import paged_attention as paged
from repro_torch.kernels import parity_inputs, parity_programs
from repro_torch.kernels import prefill_attention as prefill
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_program
from repro_torch.kernels.matmul import matmul_program

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_gemm_program(T=T, bm=16, bn=16, bk=16, kext=2):
    """Hand-built pipelined GEMM used by the per-pass unit tests (the JAX
    suite's, traced with either package's ``T``)."""
    M, N, K = 2 * bm, 2 * bn, kext * bk

    @T.prim_func
    def SmallGemm(
        A: T.Tensor((M, K), "float32"),
        B: T.Tensor((K, N), "float32"),
        C: T.Tensor((M, N), "float32"),
    ):
        with T.Kernel(N // bn, M // bm) as (bx, by):
            A_s = T.alloc_shared((bm, bk))
            B_s = T.alloc_shared((bk, bn))
            C_l = T.alloc_fragment((bm, bn))
            T.clear(C_l)
            for k in T.Pipelined(kext, num_stages=2):
                T.copy(A[by * bm, k * bk], A_s)
                T.copy(B[k * bk, bx * bn], B_s)
                T.gemm(A_s, B_s, C_l)
            T.copy(C_l, C[by * bm, bx * bn])

    return SmallGemm


def _example(name):
    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jax_quickstart():
    """The JAX quickstart's program without running its script: its
    ``Matmul`` body at its shapes."""
    from repro.core import lang as JT

    M = N = K = 512
    bM = bN = bK = 128

    @JT.prim_func
    def Matmul(A: JT.Tensor((M, K), "float32"), B: JT.Tensor((K, N), "float32"),
               C: JT.Tensor((M, N), "float32")):
        with JT.Kernel(JT.ceildiv(N, bN), JT.ceildiv(M, bM), threads=128) as (bx, by):
            A_shared = JT.alloc_shared((bM, bK), "float32")
            B_shared = JT.alloc_shared((bK, bN), "float32")
            C_local = JT.alloc_fragment((bM, bN), "float32")
            JT.clear(C_local)
            for k in JT.Pipelined(JT.ceildiv(K, bK), num_stages=2):
                JT.copy(A[by * bM, k * bK], A_shared)
                JT.copy(B[k * bK, bx * bN], B_shared)
                JT.gemm(A_shared, B_shared, C_local)
            JT.copy(C_local, C[by * bM, bx * bN])

    return Matmul


def _pairs():
    """(name, port program factory, JAX program factory) of every case."""
    from repro.core import lang as JT

    out = [(n, lambda c=c: matmul_program(**c), lambda c=c: jmatmul.matmul_program(**c))
           for n, c in jmatmul.PARITY_CASES]
    out += [(n, lambda c=c: flash_attention_program(**c),
             lambda c=c: jflash.flash_attention_program(**c)) for n, c in jflash.PARITY_CASES]
    # the paged programs: the decode and the chunked prefill, fp and quantized
    for port, jmod in ((paged, jpaged), (prefill, jprefill)):
        for n, c in jmod.PARITY_CASES:
            maker = "_quant_program" if "quant" in n else "_program"
            name = jmod.__name__.rsplit(".", 1)[-1] + maker
            out.append((n, lambda c=c, f=getattr(port, name): f(**c),
                        lambda c=c, f=getattr(jmod, name): f(**c)))
    # FlashMLA (Fig. 18) and the paged MLA decode and chunked prefill, fp
    # and quantized
    for n, c in jmla.PARITY_CASES:
        name = next(m for m in _MLA_MAKERS if n.startswith(m)) + "_program"
        out.append((n, lambda c=c, f=getattr(mla, name): f(**c),
                    lambda c=c, f=getattr(jmla, name): f(**c)))
    # the Mamba-2 SSD's chunk_state and chunk_scan
    for (n, (jf, c)), (_, (f, _)) in zip(jlinear.PARITY_CASES, linear.PARITY_CASES, strict=True):
        out.append((n, lambda c=c, f=f: f(**c), lambda c=c, f=jf: f(**c)))
    # the dequantized GEMM in its four formats (nf4 through T.call_tile_lib)
    out += [(n, lambda c=c: dequant.dequant_matmul_program(**c),
             lambda c=c: jdequant.dequant_matmul_program(**c)) for n, c in jdequant.PARITY_CASES]
    out.append(("quickstart", lambda: _example("torch_quickstart").Matmul, _jax_quickstart))
    out.append(("small_gemm", small_gemm_program, lambda: small_gemm_program(JT)))
    return out


# each MLA case's program by the longest prefix of its name
_MLA_MAKERS = ("mla_paged_quant", "mla_prefill_quant", "mla_paged", "mla_prefill", "mla")
PAIRS = {n: (p, j) for n, p, j in _pairs()}


# ---------------------------------------------------------------------------
# Per-pass unit tests
# ---------------------------------------------------------------------------


class TestPasses:
    def _module(self, *passes, schedule=None):
        m = LoweredModule(small_gemm_program(), schedule or Schedule())
        for p in passes:
            p(m)
        return m

    def test_split_phases(self):
        m = self._module(pass_split_phases)
        assert len(m.phases.pre) == 1  # the clear
        assert m.phases.pipeline is not None and m.phases.pipeline.extent == 2
        assert len(m.phases.post) == 1  # the store copy

    def test_collect_windows(self):
        m = self._module(pass_split_phases, pass_collect_windows)
        assert len(m.in_windows) == 2 and len(m.out_windows) == 1
        assert all(w.phase == LOOP for w in m.in_windows)
        assert m.out_windows[0].phase == POST
        assert set(m.fed_by) == {w.onchip.name for w in m.in_windows}

    def test_plan_grid_orders_axes(self):
        m = self._module(pass_split_phases, pass_collect_windows, pass_plan_grid)
        # (by, bx) reversed + the pipelined axis innermost
        assert m.grid == (2, 2, 2)
        assert m.grid_plan.dimension_semantics == ("parallel", "parallel", "arbitrary")
        assert m.grid_plan.kdim == 2
        env = m.grid_plan.env_builder(1, 0, 1)
        assert env["bx"] == 0 and env["by"] == 1

    def test_plan_stages_schedule_override(self):
        m = self._module(pass_split_phases, pass_plan_stages)
        assert m.num_stages == 2  # from T.Pipelined
        m2 = self._module(pass_split_phases, pass_plan_stages, schedule=Schedule(num_stages=3))
        assert m2.num_stages == 3

    def test_plan_vmem_lays_out_shared_memory(self):
        m = self._module(pass_split_phases, pass_collect_windows, pass_plan_stages,
                         pass_plan_vmem)
        # one copy a tile (the backend stages one at a time), 16-byte aligned
        assert [b.copies for b in m.vmem.buffers] == [1, 1, 1]
        assert [b.offset for b in m.vmem.buffers] == [0, 1024, 2048]
        assert m.vmem.total_bytes == 3 * 16 * 16 * 4 and m.vmem.ok

    def test_plan_params(self):
        m = self._module(pass_split_phases, pass_collect_windows, pass_plan_params)
        assert [p.name for p in m.arg_params] == ["A", "B"]
        assert [p.name for p in m.out_params] == ["C"]
        assert m.window_param_idx == [0, 1]
        # the fragment accumulator is scratch (not window-backed)
        assert [b.name for b in m.scratch_bufs] == [m.phases.pre[0].buffer.name]

    def test_estimate_cost(self):
        m = self._module(pass_split_phases, pass_collect_windows, pass_plan_grid,
                         pass_plan_stages, pass_plan_vmem, pass_plan_params,
                         pass_estimate_cost)
        # 2*M*N*K flops for the full problem
        assert m.cost.flops == 2 * 32 * 32 * 32
        assert m.cost.hbm_bytes > 0
        assert m.cost.grid == (2, 2, 2)
        # judged against the H100's peaks (roofline.analysis.HW_H100)
        assert m.cost.compute_seconds() == pytest.approx(m.cost.flops / 989e12)
        assert m.cost.memory_seconds() == pytest.approx(m.cost.hbm_bytes / 3.35e12)

    def test_run_pipeline_fills_everything(self):
        m = run_pipeline(small_gemm_program(), Schedule())
        for field in ("phases", "inference", "grid_plan", "vmem", "cost"):
            assert getattr(m, field) is not None, field
        assert PIPELINE[0][0] == "split_phases" and PIPELINE[-1][0] == "estimate_cost"


# the fields each pass fills, read the same way in both packages
_FIELDS = {
    "split_phases": lambda m: (len(m.phases.pre), m.phases.pipeline.extent, len(m.phases.post)),
    "infer_layouts": lambda m: ([(g.m, g.n, g.k) for g in m.inference.gemms],
                                [p.extents for p in m.inference.parallels]),
    "collect_windows": lambda m: [(w.param.name, w.phase, w.is_output, w.aliased, w.block_shape)
                                  for w in (*m.in_windows, *m.out_windows)],
    "plan_grid": lambda m: (m.grid, m.dimension_semantics, m.grid_plan.kdim),
    "plan_stages": lambda m: m.num_stages,
    "plan_vmem": lambda m: [(b.scope, b.logical_shape)
                            for b in m.vmem.buffers],
    "plan_params": lambda m: ([p.name for p in m.arg_params], [p.name for p in m.out_params],
                              m.window_param_idx, len(m.scratch_bufs)),
    "verify": lambda m: [(o.kind, o.param, o.tables, o.axis) for o in m.obligations],
    "estimate_cost": lambda m: (m.cost.flops, m.cost.hbm_bytes, m.cost.grid),
}


@pytest.mark.parametrize("upto", range(1, len(PIPELINE) + 1),
                         ids=[name for name, _ in PIPELINE])
def test_pipeline_prefix_equals_the_jax_packages(upto):
    """Every prefix of PIPELINE on small_gemm_program in both packages: the
    same passes in the same order, and the fields each fills equal."""
    from repro.core import lang as JT

    assert [n for n, _ in PIPELINE] == [n for n, _ in JPIPELINE]
    m = LoweredModule(small_gemm_program(), Schedule())
    jm = JLoweredModule(small_gemm_program(JT), JSchedule())
    for (name, p), (_, jp) in zip(PIPELINE[:upto], JPIPELINE[:upto]):
        p(m)
        jp(jm)
    name = PIPELINE[upto - 1][0]
    assert _FIELDS[name](m) == _FIELDS[name](jm), name


class TestFingerprintAndCache:
    def test_fingerprint_stable_across_retrace(self):
        assert program_fingerprint(small_gemm_program()) == program_fingerprint(
            small_gemm_program())

    def test_fingerprint_distinguishes_structure(self):
        assert program_fingerprint(small_gemm_program(bk=16)) != program_fingerprint(
            small_gemm_program(bk=8, kext=4))

    def test_schedule_key_excludes_notes(self):
        a, b = Schedule(), Schedule()
        b.notes["advisory"] = 1
        assert schedule_key(a) == schedule_key(b)
        assert schedule_key(Schedule(num_stages=3)) != schedule_key(a)

    def test_analysis_cache_shared_across_retrace(self):
        sched = Schedule()
        assert analyze(small_gemm_program(), sched) is analyze(small_gemm_program(), sched)

    def test_compile_cache_returns_same_kernel(self):
        k1 = tl_compile(small_gemm_program(), target="reference")
        k2 = tl_compile(small_gemm_program(), target="ref")
        assert k1 is k2
        # a different target is a different cache entry
        k3 = tl_compile(small_gemm_program(), target="cuda")
        assert k3 is not k1 and k3.backend == "cuda"


class TestRegistry:
    def test_builtins_registered(self):
        assert set(available_backends()) >= {"cuda", "reference", "sanitize"}

    def test_aliases(self):
        assert get_backend("ref") is get_backend("reference")
        assert get_backend("interp") is get_backend("reference")
        assert get_backend("gpu") is get_backend("cuda")

    def test_default_target_is_cuda(self):
        from repro_torch.core.compiler import DEFAULT_TARGET

        assert DEFAULT_TARGET == "cuda"
        assert tl_compile(small_gemm_program()).backend == "cuda"

    def test_unknown_backend_raises(self):
        with pytest.raises(LoweringError, match="Unknown backend"):
            tl_compile(small_gemm_program(), target="pallas")

    def test_register_third_party_backend(self):
        calls = {}

        @register_backend("_test_counting")
        def emit(module):
            calls["module"] = module
            return get_backend("reference")(module)

        try:
            kern = tl_compile(small_gemm_program(), target="_test_counting")
            assert calls["module"].program is kern.program
            a = torch.ones((32, 32))
            torch.testing.assert_close(kern(a, a), a @ a, rtol=1e-5, atol=0)
        finally:
            from repro_torch.core.backends import _REGISTRY

            _REGISTRY.pop("_test_counting", None)


# ---------------------------------------------------------------------------
# Across the packages: the analysis, field by field
# ---------------------------------------------------------------------------


def _index_points(m, jm, w, jw, tables):
    """Each window's index map at every grid point (the JAX package's and
    the port's), on tiny grids every point, else a sample; a map whose
    starts load a block table reads ``tables`` (the scalar-prefetch refs,
    in declaration order)."""
    import itertools

    pts = list(itertools.product(*[range(e) for e in m.grid]))[:64]
    scalars = [p for p in m.program.params if p.scope == "scalar"]
    jscalars = [p for p in jm.program.params if p.scope == "scalar"]
    f = make_index_map(w.region, m.grid_plan.env_builder, scalars)
    jf = jmake_index_map(jw.region, jm.grid_plan.env_builder, jscalars)
    return ([tuple(int(v) for v in f(*p, *tables)) for p in pts],
            [tuple(int(v) for v in jf(*p, *tables)) for p in pts])


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_analysis_equals_the_jax_packages(name):
    port, jax_prog = PAIRS[name]
    prog = port()
    m, jm = analyze(prog, Schedule()), _jax_analyze(jax_prog())
    args = parity_inputs(name, prog, np.random.default_rng(0)) or []
    tables = args[:len([p for p in prog.params if p.scope == "scalar"])]
    phase = lambda ph: ([type(o).__name__ for o in ph.pre],  # noqa: E731
                        [type(o).__name__ for o in ph.pipeline.body] if ph.pipeline else None,
                        [type(o).__name__ for o in ph.post])
    assert phase(m.phases) == phase(jm.phases)
    windows = lambda mm: [(w.param.name, w.phase, w.is_output, w.aliased, w.block_shape,  # noqa
                           w.onchip is not None) for w in (*mm.in_windows, *mm.out_windows)]
    assert windows(m) == windows(jm)
    for w, jw in zip((*m.in_windows, *m.out_windows), (*jm.in_windows, *jm.out_windows)):
        got, want = _index_points(m, jm, w, jw, tables)
        assert got == want, w.param.name
    assert m.grid == jm.grid and m.dimension_semantics == jm.dimension_semantics
    assert m.grid_plan.kdim == jm.grid_plan.kdim and m.num_stages == jm.num_stages
    assert _FIELDS["plan_params"](m) == _FIELDS["plan_params"](jm)
    assert (m.cost.flops, m.cost.hbm_bytes, m.cost.grid) == (
        jm.cost.flops, jm.cost.hbm_bytes, jm.cost.grid)
    assert _FIELDS["verify"](m) == _FIELDS["verify"](jm)
    assert [(g.m, g.n, g.k) for g in m.inference.gemms] == [
        (g.m, g.n, g.k) for g in jm.inference.gemms]


def _jax_analyze(prog):
    from repro.core import analyze as janalyze

    return janalyze(prog, JSchedule())


def test_shared_memory_plan_reckoned_by_hand():
    """The card's plan: every shared and fragment buffer once, rows padded
    to whole 16-byte vectors, a tensor-core operand whose rows are whole
    128-byte bank lines one vector wider, offsets 16-byte aligned."""
    qs = analyze(_example("torch_quickstart").Matmul)
    # A, B and C at 128 x 128 fp32, the GEMM on the CUDA cores
    assert [b.offset for b in qs.vmem.buffers] == [0, 65536, 131072]
    assert qs.vmem.total_bytes == 3 * 128 * 128 * 4 == 196608
    fl = analyze(flash_attention_program(8, 12, 2, 1024, 1024, 128, True, 64, 64,
                                         dtype="bfloat16"))
    # Q and K (the scores' tensor-core operands) 64 x (128 + 8) bf16, V
    # 64 x 128 bf16 (P.V takes fp32 P: CUDA cores), the scores 64 x (64 + 4)
    # fp32, the output accumulator 64 x 128 fp32, five fp32 rows of 64
    by_hand = 2 * 64 * 136 * 2 + 64 * 128 * 2 + 64 * 68 * 4 + 64 * 128 * 4 + 5 * 64 * 4
    assert fl.vmem.total_bytes == by_hand == 102656 and fl.vmem.ok
    m7 = analyze(matmul_program(8192, 8192, 28672, "bfloat16", "bfloat16"))
    assert m7.vmem.total_bytes == 128 * 72 * 2 + 64 * 136 * 2 + 128 * 132 * 4 == 103424
    # flash at 128 x 128: over the block's 232,448 bytes, so the card refuses
    big = analyze(flash_attention_program(8, 12, 2, 1024, 1024, 128, True, 128, 128,
                                          dtype="bfloat16"))
    assert big.vmem.total_bytes == 2 * 128 * 136 * 2 + 128 * 128 * 2 + 128 * 132 * 4 \
        + 128 * 128 * 4 + 5 * 128 * 4 == 238080 and not big.vmem.ok


# ---------------------------------------------------------------------------
# Backend parity: the port's interpreters against the JAX package's backends
# ---------------------------------------------------------------------------

_CASES = dict(parity_programs())


def _make_input(param, rng):
    if param.dtype.startswith(("int", "uint")):
        return rng.integers(-4, 4, size=param.shape).astype(param.dtype)
    return rng.standard_normal(param.shape).astype(param.dtype)


# Cases whose inputs the JAX package's reference and Pallas-interpret
# backends do not agree on within 1e-5: the int8 prefill's dequantized keys
# and values reach 127 x 0.2, its outputs 23, and the two differ by 2.97e-5
# where sums cancel (an element of 0.4), 1.29 times the limit.
_JAX_BACKENDS_APART = {"prefill_attention_quant_int8"}
# Cases whose output both of the JAX package's backends compute farther than
# 1e-5 from the same program run in fp64: the int8 MLA prefill's dequantized
# latents reach 127 x 0.2 and its scores 100, so an fp32 ulp of an exp2
# argument near 30 moves an output element of 0.2 by 2e-5.  The fp64 run is
# the JAX package's own program (``dtype`` and ``accum_dtype`` float64)
# through the JAX package's reference interpreter with x64 on, on the same
# inputs widened to fp64; its GEMMs still round their products to fp32
# (``preferred_element_type``), and it lies within 1e-5 of the case's value
# computed wholly in fp64 (test_jax_fp64_run_is_the_int8_mla_prefills_value).
# The port is held to the fp64 run at 1e-5, must lie nearer to it than either
# JAX backend, and no farther from the JAX package's reference than the JAX
# package's Pallas-interpret is.
_JAX_BACKENDS_OFF_FP64 = {"mla_prefill_quant_int8"}


def _widened(args):
    return [a.astype(np.float64) if a.dtype == np.float32 else a for a in args]


def _jax_fp64_outputs(name, args):
    """A case's outputs from the JAX package's program built in fp64, run
    by the JAX package's reference interpreter with x64 on, on ``args``
    widened to fp64; floating outputs returned in fp64."""
    import jax

    cfg = dict(jmla.PARITY_CASES)[name]
    maker = next(m for m in _MLA_MAKERS if name.startswith(m)) + "_program"
    with jax.enable_x64(True):
        prog = getattr(jmla, maker)(**cfg, dtype="float64", accum_dtype="float64")
        out = _outputs(jcompile(prog, target="reference")(*_widened(args)))
    assert all(o.dtype == np.float64 for o in out if o.dtype.kind == "f")
    return out


def _outputs(out):
    """Every output of a kernel as numpy arrays: a tuple's elements each
    (the prefill's pools beside its output)."""
    return [np.asarray(o) for o in (out if isinstance(out, (tuple, list)) else (out,))]


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_backend_parity_with_the_jax_package(name):
    port, jax_prog = PAIRS[name]
    prog, jprog = port(), jax_prog()
    rk, sk = tl_compile(prog, target="reference"), tl_compile(prog, target="sanitize")
    jr = jcompile(jprog, target="reference")
    jp = jcompile(jprog, JSchedule(interpret=True), target="pallas")
    assert [p.name for p in rk.arg_params] == [p.name for p in jr.arg_params]
    rng = np.random.default_rng(0)
    args = parity_inputs(name, prog, rng)
    if args is None:
        args = [_make_input(p, rng) for p in rk.arg_params]
    ts = [torch.from_numpy(a) for a in args]
    got = _outputs(rk(*ts))
    for s, g in zip(_outputs(sk(*ts)), got, strict=True):
        np.testing.assert_array_equal(s, g)
    apart = []
    if name in _JAX_BACKENDS_OFF_FP64:
        far = []
        for g, r, p, t in zip(got, _outputs(jr(*args)), _outputs(jp(*args)),
                              _jax_fp64_outputs(name, args), strict=True):
            np.testing.assert_allclose(g, t, rtol=1e-5, atol=1e-5)
            g, r, p = (x.astype(np.float64) for x in (g, r, p))
            d = np.abs(g - t).max()
            assert d <= np.abs(r - t).max() and d <= np.abs(p - t).max()
            assert np.abs(g - r).max() <= np.abs(p - r).max()
            far += [not np.allclose(r, t, rtol=1e-5, atol=1e-5),
                    not np.allclose(p, t, rtol=1e-5, atol=1e-5)]
        assert all(far[-2:])  # both JAX backends miss the fp64 run on Output, the last
        return
    for g, r, p in zip(got, _outputs(jr(*args)), _outputs(jp(*args)), strict=True):
        np.testing.assert_allclose(g, r, rtol=1e-5, atol=1e-5)
        if np.allclose(r, p, rtol=1e-5, atol=1e-5):
            np.testing.assert_allclose(g, p, rtol=1e-5, atol=1e-5)
        else:
            # the JAX package's own two backends differ by more than the
            # limit: the port may be no farther from Pallas-interpret than
            # the JAX package's reference is
            apart.append(np.abs(g - p).max() <= np.abs(r - p).max())
    assert all(apart) and bool(apart) == (name in _JAX_BACKENDS_APART)


def _mla_prefill_quant_fp64(cfg, args):
    """The int8 MLA chunked prefill's output, computed wholly in fp64 with
    numpy from its parity inputs: every prior position below the slot's
    start, then the chunk's own latents causally up to its live length,
    keys and values dequantized as code x scale, the softmax over
    ``q.latent + q_pe.rope`` at 1 / sqrt(dim + pe_dim); rows chunk-major with
    their head, a row with no live key zeros."""
    tables, starts, lens, q, qpe, ckv, kpe, cs, ps_, kvp, kpp, kvs, kps = args
    heads, dim, pe, chunk = cfg["heads"], cfg["dim"], cfg["pe_dim"], cfg["chunk"]
    f = np.float64
    out = np.zeros(q.shape)
    for b in range(cfg["slots"]):
        prior = slice(0, int(starts[b]))
        lat = np.concatenate([(kvp[tables[b]].astype(f) * kvs[tables[b]]).reshape(-1, dim)[prior],
                              ckv[b].astype(f) * cs[b]])
        rope = np.concatenate([(kpp[tables[b]].astype(f) * kps[tables[b]]).reshape(-1, pe)[prior],
                               kpe[b].astype(f) * ps_[b]])
        s = (q[b].astype(f) @ lat.T + qpe[b].astype(f) @ rope.T) / np.sqrt(dim + pe)
        i = np.arange(chunk * heads)[:, None] // heads
        j = np.arange(chunk)[None, :]
        live = np.concatenate([np.ones((chunk * heads, int(starts[b])), bool),
                               (j <= i) & (j < lens[b])], axis=1)
        s = np.where(live, s, -np.inf)
        top = s.max(axis=1, keepdims=True)
        e = np.where(live, np.exp(s - np.where(np.isfinite(top), top, 0.0)), 0.0)
        den = e.sum(axis=1, keepdims=True)
        out[b] = (e / np.where(den > 0, den, 1.0)) @ lat
    return out


def test_jax_fp64_run_is_the_int8_mla_prefills_value():
    """The oracle of the int8 MLA prefill's parity case (the JAX package's
    program in fp64 through its reference interpreter, whose GEMMs round to
    fp32) within 1e-5 of the case's value computed wholly in fp64 by numpy,
    where both JAX backends in fp32 are not."""
    name = "mla_prefill_quant_int8"
    cfg = dict(jmla.PARITY_CASES)[name]
    jprog = jmla.mla_prefill_quant_program(**cfg)
    args = jmla.parity_inputs(name, jprog, np.random.default_rng(0))
    want = _mla_prefill_quant_fp64(cfg, args)
    np.testing.assert_allclose(_jax_fp64_outputs(name, args)[-1], want, rtol=1e-5, atol=1e-5)
    for kern in (jcompile(jprog, target="reference"),
                 jcompile(jprog, JSchedule(interpret=True), target="pallas")):
        assert not np.allclose(np.asarray(kern(*args)[-1]), want, rtol=1e-5, atol=1e-5)


def test_parity_registry_mirrors_the_jax_packages():
    names = [n for n, _ in parity_programs()]
    assert names == [n for mod in (jdequant, jflash, jlinear, jmatmul, jmla, jpaged, jprefill)
                     for n, _ in mod.PARITY_CASES]
    # the paged modules' hooks give the JAX package's inputs (MLA's for its
    # paged cases, none for FlashMLA), the others none
    hooked = {n for mod in (jmla, jpaged, jprefill) for n, _ in mod.PARITY_CASES} - {"mla"}
    jprogs = {n: p for mod in (jmla, jpaged, jprefill) for n, p in mod.parity_programs()}
    for n, p in _CASES.items():
        args = parity_inputs(n, p, np.random.default_rng(0))
        if n not in hooked:
            assert args is None, n
            continue
        jmod = next(m for m in (jmla, jpaged, jprefill) if n in dict(m.PARITY_CASES))
        want = jmod.parity_inputs(n, jprogs[n], np.random.default_rng(0))
        assert len(args) == len(want)
        for a, w in zip(args, want):
            np.testing.assert_array_equal(a, w)


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_dequant_stage_scratch_is_vector_aligned(fmt):
    """The attention core's quantized KV source: its local unpack scratch
    rows are whole 16-byte vectors (the TPU's: whole 128 lanes), its window
    mirrors the page layout, and it dequantizes as the plain rule does."""
    from repro_torch.kernels import attention_core as AC

    rows, feat = 8, 24
    cols = feat // AC.KV_PACK[fmt]

    @T.prim_func
    def Deq(P: T.Tensor((rows, cols), "int8"), S: T.Tensor((rows, 1), "float32"),
            O: T.Tensor((rows, feat), "float32")):
        with T.Kernel(1) as bx:
            st = AC.DequantStage(rows, feat, fmt)
            T.copy(st.load(P[0, 0], S[0, 0]), O[0, 0])

    m = run_pipeline(Deq, Schedule())
    scratch = [b for b in m.scratch_bufs if b.dtype == "int8"]
    assert scratch and all(b.shape[-1] % 16 == 0 for b in scratch)
    assert [w.onchip.shape[-1] for w in m.in_windows if w.onchip.dtype == "int8"] == [cols]
    rng = np.random.default_rng(1)
    packed = rng.integers(-128, 128, (rows, cols)).astype(np.int8)
    scale = rng.standard_normal((rows, 1)).astype(np.float32)
    got = tl_compile(Deq, target="reference")(torch.from_numpy(packed), torch.from_numpy(scale))
    if fmt == "int4":
        lo, hi = packed & 15, (packed >> 4) & 15
        codes = np.stack([lo, hi], -1).reshape(rows, feat).astype(np.int32)
        codes = np.where(codes >= 8, codes - 16, codes)
    else:
        codes = packed.astype(np.int32)
    np.testing.assert_allclose(got.numpy(), codes * scale, rtol=1e-6)


# ---------------------------------------------------------------------------
# The CUDA backend without a card
# ---------------------------------------------------------------------------


def _cuda(prog):
    return tl_compile(prog, target="cuda", use_cache=False)


# the cases the CUDA backend emits: all of them (nf4's codebook lookup, a
# T.call_tile_lib, rewritten into T ops)
EMITS = sorted(PAIRS)


@pytest.mark.parametrize("name", EMITS)
def test_cuda_source_is_deterministic_and_asks_for_the_plan(name):
    port, _ = PAIRS[name]
    k1, k2 = _cuda(port()), _cuda(port())
    assert k1.backend == "cuda" and k1.source and k1.source == k2.source
    m = analyze(port())
    blocks = int(np.prod([e for i, e in enumerate(m.grid) if i != m.grid_plan.kdim]))
    threads = port().threads or 128
    assert k1.smem_bytes == m.vmem.total_bytes
    assert f"<<<{blocks}, {threads}, {m.vmem.total_bytes}, " in k1.source
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in k1.source
    assert 'extern "C" int tl_launch(' in k1.source
    # every shared buffer at its planned offset
    for i, b in enumerate(m.vmem.buffers):
        assert f"(tl_smem + {b.offset});" in k1.source
    assert k1.kernel.text == k1.source and k1.launches == 0


def test_cuda_source_keeps_python_floor_semantics():
    """An index that may be negative goes through the floor helpers; one
    that cannot stays C's ``/`` and ``%``."""

    @T.prim_func
    def Shift(X: T.Tensor((4, 32), "float32"), O: T.Tensor((4, 32), "float32")):
        with T.Kernel(1) as bx:
            xs = T.alloc_shared((4, 32), "float32")
            ys = T.alloc_fragment((4, 32), "float32")
            T.copy(X[0, 0], xs)
            for i, j in T.Parallel(4, 32):
                ys[i, j] = xs[(i - 2) % 4, (j - 5) // 2 + 3]
            T.copy(ys, O[0, 0])

    src = _cuda(Shift).source
    assert "tl_mod((v" in src and "tl_floordiv((v" in src
    x = torch.arange(128, dtype=torch.float32).reshape(4, 32)
    got = tl_compile(Shift, target="reference")(x)
    want = torch.stack([x[(i - 2) % 4, [(j - 5) // 2 + 3 for j in range(32)]]
                        for i in range(4)])
    torch.testing.assert_close(got, want)


def test_cuda_source_types_and_literals():
    """bf16 tiles load and store through conversions, a value of a 16-bit
    type rounds to nearest even, -inf is INFINITY, and NEG_CLAMP stays a
    float literal."""
    from repro_torch.kernels.attention_core import NEG_CLAMP

    src = _cuda(flash_attention_program(1, 2, 1, 32, 32, 16, True, 16, 16,
                                        dtype="bfloat16")).source
    assert "__nv_bfloat16" in src and "__float2bfloat16_rn(" in src
    assert "__bfloat162float(" in src and "(-INFINITY)" in src
    assert f"{NEG_CLAMP!r}f" in src and "exp2f(" in src
    assert "nvcuda::wmma::mma_sync" in src  # Q.K^T on the tensor cores


def _last_ops():
    """Programs of the T language's last four ops: a tile-library function
    (``T.call_tile_lib``), an atomic add, a scan and a batched GEMM (fp32,
    on the CUDA cores, and bf16, on ``wmma``)."""

    @T.prim_func
    def Custom(X: T.Tensor((8, 32), "float32"), O: T.Tensor((8, 32), "float32")):
        with T.Kernel(1) as bx:
            xs = T.alloc_shared((8, 32), "float32")
            sm = T.alloc_fragment((8, 32), "float32")
            T.copy(X[0, 0], xs)
            T.call_tile_lib(lambda v: v * 2, sm, xs, name="double")
            T.copy(sm, O[0, 0])

    @T.prim_func
    def Atomic(X: T.Tensor((4, 8, 32), "float32"), O: T.Tensor((8, 32), "float32")):
        with T.Kernel(4) as bx:
            xs = T.alloc_shared((8, 32), "float32")
            T.copy(X[bx, 0, 0], xs)
            T.atomic_add(O[0, 0], xs)

    @T.prim_func
    def Cumsum(X: T.Tensor((8, 32), "float32"), O: T.Tensor((8, 32), "float32")):
        with T.Kernel(1) as bx:
            xs = T.alloc_shared((8, 32), "float32")
            cs = T.alloc_fragment((8, 32), "float32")
            T.copy(X[0, 0], xs)
            T.cumsum(xs, cs, dim=1)
            T.copy(cs, O[0, 0])

    return {"CustomOp 'double'": Custom, "AtomicOp atomic_add": Atomic, "CumsumOp": Cumsum,
            "batched T.gemm fp32": batched_gemm_program("float32"),
            "batched T.gemm bf16": batched_gemm_program("bfloat16")}


def batched_gemm_program(dtype, T=T):
    """C[g, h] = A[g, h] . B[h] over (2, 4) batches of 32 x 16 by 16 x 32:
    A's batch a grid cell's, B's broadcast over the cells."""

    @T.prim_func
    def BatchedGemm(A: T.Tensor((2, 4, 32, 16), dtype), B: T.Tensor((4, 16, 32), dtype),
                    C: T.Tensor((2, 4, 32, 32), "float32")):
        with T.Kernel(2) as bx:
            a = T.alloc_shared((4, 32, 16), dtype)
            b = T.alloc_shared((4, 16, 32), dtype)
            c = T.alloc_fragment((4, 32, 32), "float32")
            T.copy(A[bx, 0, 0, 0], a)
            T.copy(B[0, 0, 0], b)
            T.clear(c)
            T.gemm(a, b, c)
            T.copy(c, C[bx, 0, 0, 0])

    return BatchedGemm


@pytest.mark.parametrize("what", sorted(_last_ops()))
def test_cuda_backend_emits_the_last_ops(what):
    """Each of the T language's last four ops emits, deterministically, a
    kernel that asks for its program's shared-memory plan; the reference
    interpreter still runs the program (nothing falls back)."""
    prog = _last_ops()[what]
    k1, k2 = _cuda(prog), _cuda(_last_ops()[what])
    assert k1.source and k1.source == k2.source
    m = analyze(lower_tile_lib(prog))
    assert k1.smem_bytes == m.vmem.total_bytes
    assert f", {m.vmem.total_bytes}, " in k1.source and "NotImplemented" not in k1.source
    assert tl_compile(prog, target="reference").backend == "reference"


def test_cuda_backend_emits_each_ops_code():
    """What each op becomes: the tile-library call a ``T.Parallel`` over its
    output, the atomic an ``atomicAdd`` into the in-out window (seeded from
    the caller's tensor), the scan a thread a line, the fp32 batched GEMM a
    loop over the batches on the CUDA cores and the bf16 one on ``wmma``."""
    ops = _last_ops()
    custom = _cuda(ops["CustomOp 'double'"]).source
    assert "] * (float)(2))" in custom and "tl_atomic" not in custom
    atomic = _cuda(ops["AtomicOp atomic_add"])
    assert "atomicAdd(&g1[" in atomic.source and atomic.aliased == ("O",)
    scan = _cuda(ops["CumsumOp"]).source
    assert "for (int _r" in scan and "+= s0[" in scan
    f32, bf16 = (_cuda(ops[f"batched T.gemm {t}"]).source for t in ("fp32", "bf16"))
    assert "for (int _bt" in f32 and "wmma" not in f32
    assert "for (int _bt" in bf16 and "nvcuda::wmma::mma_sync" in bf16


def test_nf4_program_emits_and_its_interpreter_run_equals_the_plain_version():
    """dequant_matmul_nf4's codebook lookup (a ``T.call_tile_lib``) is
    emitted as a select tree over the 16 codebook values, no call to torch;
    the reference interpreter runs the program, equal to the plain
    version."""
    cfg = dict(dequant.PARITY_CASES)["dequant_matmul_nf4"]
    prog = dequant.dequant_matmul_program(**cfg)
    src = _cuda(prog).source
    assert src.count(" ? ") >= 15 and "-0.6961928009986877f" in src
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.standard_normal((cfg["M"], cfg["K"])).astype(np.float32))
    b = torch.from_numpy(rng.integers(-128, 128, (cfg["N"], cfg["K"] // 2)).astype(np.int8))
    got = tl_compile(prog, target="reference")(a, b)
    torch.testing.assert_close(got.t(), ref.dequant_matmul(a, b, "nf4"), rtol=1e-5, atol=1e-5)


# mamba2-2.7B's training shape (B 8 x S 1024, 80 heads of P 64, N 128,
# chunks of 128) as the programs take it: (batch x heads) rows of 8 chunks
SSD_TRAIN = dict(batch=8 * 80, nchunks=8, chunk_l=128, dstate=128, headdim=64)
# Fig. 15's m1_n16384_k16384 (M padded to 8) as row 14 runs it: fp16
# activations and output, 8 x 128 x 128 blocks
DEQUANT_ROW14 = dict(M=8, N=16384, K=16384, in_dtype="float16", out_dtype="float16",
                     block_M=8, block_N=128, block_K=128)


def test_cuda_source_at_the_card_shapes_fits_the_plan():
    """The new programs at the card's shapes, emitted here without nvcc:
    chunk_state and chunk_scan at mamba2-2.7B's training shape in bf16, and
    fp32 chunk_scan under ``Schedule(workspace=True)`` (its 262,656 B do not
    fit all in shared memory, so without the workspace it raises); the
    dequantized GEMM at row 14's shape in int4, int8 and int2 (the 8-row
    product on the CUDA cores) and int4 at m256_n8192_k8192 on ``wmma``;
    each plan within the block's 232,448 bytes, one block a grid cell."""
    from repro_torch.core import ScheduleError

    budget = 232448
    emitted = {
        "chunk_state bf16": _cuda(linear.chunk_state_program(**SSD_TRAIN, dtype="bfloat16")),
        "chunk_scan bf16": _cuda(linear.chunk_scan_program(**SSD_TRAIN, dtype="bfloat16")),
        "chunk_scan fp32": tl_compile(linear.chunk_scan_program(**SSD_TRAIN),
                                      Schedule(workspace=True), target="cuda", use_cache=False),
    }
    for fmt in ("int4", "int8", "int2"):
        emitted[fmt] = _cuda(dequant.dequant_matmul_program(**DEQUANT_ROW14, fmt=fmt))
    emitted["int4 m256"] = _cuda(dequant.dequant_matmul_program(
        256, 8192, 8192, "int4", "float16", "float16"))
    for name, k in emitted.items():
        assert k.smem_bytes <= budget and k.info.vmem.ok, name
    assert {n: k.blocks for n, k in emitted.items()} == {
        "chunk_state bf16": 5120, "chunk_scan bf16": 5120, "chunk_scan fp32": 5120,
        "int4": 128, "int8": 128, "int2": 128, "int4 m256": 512}
    assert emitted["chunk_state bf16"].smem_bytes == 115200
    assert emitted["chunk_scan bf16"].smem_bytes == 186880
    assert (emitted["chunk_scan fp32"].smem_bytes, emitted["chunk_scan fp32"].workspace_bytes) \
        == (197120, 65536)
    assert emitted["int4"].smem_bytes == 55296 and emitted["int4 m256"].smem_bytes == 39936
    # C.B^T and the m256 product on wmma; the 8-row products on the CUDA cores
    wmma = {n for n, k in emitted.items() if "nvcuda::wmma::mma_sync" in k.source}
    assert wmma == {"chunk_scan bf16", "int4 m256"}
    with pytest.raises(ScheduleError, match="shared-memory budget exceeded"):
        _cuda(linear.chunk_scan_program(**SSD_TRAIN))


def _gather():
    @T.prim_func
    def Gather(Tbl: T.ScalarTensor((4,), "int32"), Src: T.Tensor((4, 8, 32), "float32"),
               Out: T.Tensor((4, 8, 32), "float32")):
        with T.Kernel(4) as bx:
            s = T.alloc_shared((8, 32), "float32")
            T.copy(Src[Tbl[bx], 0, 0], s)
            T.copy(s, Out[bx, 0, 0])

    return Gather


def test_cuda_backend_reads_a_block_table_from_an_int32_operand():
    """A ``T.ScalarTensor`` is an int32 operand of the kernel, and a copy's
    region start loads its entry for the block."""
    gather = _gather()
    src = _cuda(gather).source
    assert "tl_Gather(const int* __restrict__ g0, const float* __restrict__ g1, " in src
    assert re.search(r"const int _os\d+ = g0\[\(long long\)\(v\d+\)\];", src)
    assert "static_cast<const int*>(p0)" in src
    tbl = torch.tensor([2, 0, 3, 1], dtype=torch.int32)
    x = torch.randn(4, 8, 32)
    torch.testing.assert_close(tl_compile(gather, target="reference")(tbl, x), x[tbl.long()])


_PAGED = sorted(n for mod in (jmla, jpaged, jprefill) for n, _ in mod.PARITY_CASES
                if n != "mla")


@pytest.mark.parametrize("name", _PAGED)
def test_cuda_source_of_a_paged_program_reads_its_tables(name):
    """Each paged program's block tables (``Tables``, ``Lens``, and the
    prefill's ``Starts``) are int32 operands its text reads."""
    prog = PAIRS[name][0]()
    src = _cuda(prog).source
    body = src[src.index("tl_smem[];"):src.index('extern "C" int tl_launch(')]
    tables = [(i, p) for i, p in enumerate(prog.params) if p.name in ("Tables", "Starts", "Lens")]
    prefill = name.startswith(("prefill", "mla_prefill"))
    assert [p.name for _, p in tables] == (
        ["Tables", "Starts", "Lens"] if prefill else ["Tables", "Lens"])
    for i, p in tables:
        assert f"const int* __restrict__ g{i}" in src and f"g{i}[" in body, p.name
    # the paged gather: the page index a region start, loaded from the table
    assert re.search(r"const int _os\d+ = g0\[\(long long\)\(v\d+\) \* \d+LL "
                     r"\+ \(long long\)\(v\d+\)\];", body)
    if prefill:
        # the page write: the clamped table entry, page 0 for a dead page
        assert re.search(r"const int _od\d+ = \(.* \? \(int\)\(g0\[.*min\(.*\) : "
                         r"\(int\)\(0\)\);", body)


class _OnCard(torch.Tensor):
    """A CPU tensor that answers ``is_cuda`` like a card's."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("name", ["paged_attention_gqa_ragged", "prefill_attention_mqa",
                                  "prefill_attention_quant_int8"])
def test_cuda_kernel_seeds_in_out_outputs_from_their_inputs(name, monkeypatch):
    """The pools the prefill writes through its table are in-out outputs:
    the wrapper hands the kernel a copy of each (pages no block writes keep
    their contents, the caller's tensor is never written) and zeros for a
    pure output, and returns them in out_params order.  The kernel's C call
    is recorded (no card here)."""
    import contextlib
    import types

    prog = PAIRS[name][0]()
    kern = _cuda(prog)
    pools = [p.name for p in prog.output_params() if p.name != "Output"]
    assert kern.aliased == tuple(pools)
    assert [p.name for p in kern.out_params] == pools + ["Output"]
    calls = []
    monkeypatch.setattr(kern.kernel, "function", lambda: lambda *a: calls.append(a) or 0)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda: types.SimpleNamespace(cuda_stream=0))
    args = [torch.from_numpy(a).as_subclass(_OnCard)
            for a in parity_inputs(name, prog, np.random.default_rng(0))]
    outs = kern(*args)
    outs = outs if isinstance(outs, tuple) else (outs,)
    (call,) = calls
    ptr = {p.name: call[i] for i, p in enumerate(prog.params)}
    given = dict(zip([p.name for p in kern.arg_params], args))
    for p, o in zip(kern.out_params, outs, strict=True):
        assert ptr[p.name] == o.data_ptr()
        if p.name in pools:  # a copy of the input, at another address
            assert torch.equal(o, given[p.name]) and o.data_ptr() != given[p.name].data_ptr()
        else:
            assert not o.any()
    assert kern.launches == 1


def test_cuda_kernel_without_a_card_raises():
    kern = _cuda(small_gemm_program())
    a = torch.ones((32, 32))
    with pytest.raises(RuntimeError, match="compiled for target 'cuda'"):
        kern(a, a)
    assert kern.launches == 0


def test_quickstart_runs_on_the_cpu_only_when_asked(monkeypatch, capsys):
    qs = _example("torch_quickstart")
    res = qs.main(["--device", "cpu"])
    assert res["kernel"].backend == "reference" and res["err"] <= 1e-4
    assert "matmul matches torch" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        qs.main([])
