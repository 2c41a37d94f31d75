"""The port's kernel guardrails against the JAX package's
(``tests/test_verify.py``): the static verifier pass, the sanitizing
reference interpreter and the dispatch guard, on the port's compiler
(``repro_torch.core``) and its programs.  Each planted defect raises the
error the JAX package raises, with the same message; every program's
obligations, the paged decode's and chunked prefill's among them, are the
kinds the dispatch guard discharges."""
import numpy as np
import pytest
import torch

from repro.core import compile as jcompile
from repro.core import lang as JT
from repro.core.errors import SanitizeError as JSanitizeError
from repro.core.errors import VerifyError as JVerifyError
from repro_torch.core import Schedule, analyze, compile as tl_compile
from repro_torch.core import lang as T
from repro_torch.core.backends.reference import _check_region_starts, _check_scalar_index
from repro_torch.core.errors import GuardError, SanitizeError, VerifyError
from repro_torch.core.lowering.verify import alias_wiring, interval
from repro_torch.kernels import parity_inputs, parity_programs
from repro_torch.kernels.ops import guard_dispatch

GUARDED_KINDS = {"table_in_range", "table_writes_disjoint"}


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


# ---------------------------------------------------------------------------
# Planted-defect programs, traced with either package's T
# ---------------------------------------------------------------------------


def racy_program(T=T):
    """Both grid cells store to O[0:16] — a proven write race."""

    @T.prim_func
    def Racy(A: T.Tensor((32, 128), "float32"), O: T.Tensor((16, 128), "float32")):
        with T.Kernel(2) as bx:
            s = T.alloc_shared((16, 128), "float32")
            T.copy(A[bx * 16, 0], s)
            T.copy(s, O[0, 0])

    return Racy


def escaping_program(T=T):
    """bx=1 reads rows [24, 48) of a 32-row buffer — provably OOB."""

    @T.prim_func
    def Escape(A: T.Tensor((32, 128), "float32"), O: T.Tensor((48, 128), "float32")):
        with T.Kernel(2) as bx:
            s = T.alloc_shared((24, 128), "float32")
            T.copy(A[bx * 24, 0], s)
            T.copy(s, O[bx * 24, 0])

    return Escape


def dup_write_program(T=T):
    """(bx // 2) * 16 defeats the affine disjointness proof but lands both
    cells on O[0:16] at runtime — the sanitizer's catch."""

    @T.prim_func
    def DupWrite(A: T.Tensor((32, 128), "float32"), O: T.Tensor((16, 128), "float32")):
        with T.Kernel(2) as bx:
            s = T.alloc_shared((16, 128), "float32")
            T.copy(A[bx * 16, 0], s)
            T.copy(s, O[(bx // 2) * 16, 0])

    return DupWrite


def half_written_program(T=T):
    """Only rows [0, 16) of a 32-row output are ever written."""

    @T.prim_func
    def HalfOut(A: T.Tensor((16, 128), "float32"), O: T.Tensor((32, 128), "float32")):
        with T.Kernel(1) as bx:
            s = T.alloc_shared((16, 128), "float32")
            T.copy(A[0, 0], s)
            T.copy(s, O[0, 0])

    return HalfOut


def gather_program(T=T, pages=4, rows=8):
    """A table-directed kernel: the static verifier cannot bound the page
    axis and must emit a ``table_in_range`` obligation."""

    @T.prim_func
    def Gather(Tbl: T.ScalarTensor((pages,), "int32"),
               Src: T.Tensor((pages, rows, 128), "float32"),
               Out: T.Tensor((pages, rows, 128), "float32")):
        with T.Kernel(pages) as bx:
            s = T.alloc_shared((rows, 128), "float32")
            T.copy(Src[Tbl[bx], 0, 0], s)
            T.copy(s, Out[bx, 0, 0])

    return Gather


def _same_error(make, target, exc, jexc, *args):
    """Compile (and with ``args`` run) ``make`` in both packages: both raise,
    the port's ``exc`` and the JAX package's ``jexc``, with one message."""
    with pytest.raises(exc) as got:
        k = tl_compile(make(), target=target)
        k(*_t(*args))
    with pytest.raises(jexc) as want:
        k = jcompile(make(JT), target=target)
        k(*args)
    assert str(got.value) == str(want.value)
    return got.value


# ---------------------------------------------------------------------------
# Layer 1: the static verifier pass
# ---------------------------------------------------------------------------


class TestStaticVerifier:
    def test_every_kernel_verifies_clean(self):
        count = 0
        for name, prog in parity_programs():
            m = analyze(prog, Schedule())
            count += 1
            for ob in m.obligations:
                assert ob.kind in GUARDED_KINDS, (name, ob)
        assert count > 0

    def test_planted_write_race_rejected(self):
        err = _same_error(racy_program, "reference", VerifyError, JVerifyError)
        assert "write race" in str(err)

    def test_planted_oob_window_rejected(self):
        err = _same_error(escaping_program, "reference", VerifyError, JVerifyError)
        assert "escape" in str(err)

    def test_error_context_names_program_and_pass(self):
        with pytest.raises(VerifyError) as ei:
            tl_compile(racy_program(), target="cuda")  # before any emission
        assert ei.value.context is not None
        assert "Racy" in ei.value.context and "verify" in ei.value.context
        assert "Racy" in str(ei.value)

    def test_unprovable_affine_pattern_accepted(self):
        m = analyze(dup_write_program(), Schedule())
        assert m.obligations == []

    def test_table_directed_axis_becomes_obligation(self):
        from repro.core import analyze as janalyze

        m = analyze(gather_program(), Schedule())
        kinds = {ob.kind for ob in m.obligations}
        assert "table_in_range" in kinds
        ob = next(o for o in m.obligations if o.kind == "table_in_range")
        assert ob.tables == ("Tbl",) and ob.param == "Src" and ob.axis == 0
        assert "Tbl" in ob.describe()
        jm = janalyze(gather_program(JT))
        assert [o.describe() for o in m.obligations] == [o.describe() for o in jm.obligations]

    def test_alias_wiring_matches_the_jax_packages(self):
        """For an atomic kernel the aliased operand sits after scalars +
        input windows, in both packages."""
        from repro.core import analyze as janalyze

        def col_sum(T=T):
            @T.prim_func
            def ColSum(X: T.Tensor((4, 16, 128), "float32"), O: T.Tensor((16, 128), "float32")):
                with T.Kernel(4) as bx:
                    xs = T.alloc_shared((16, 128), "float32")
                    T.copy(X[bx, 0, 0], xs)
                    T.atomic_add(O[0, 0], xs)

            return ColSum

        m = analyze(col_sum(), Schedule())
        wiring = alias_wiring(m)
        assert wiring == {len(m.scalar_params) + len(m.in_windows): 0}
        from repro.core.lowering.verify import alias_wiring as jalias_wiring

        assert wiring == jalias_wiring(janalyze(col_sum(JT)))

    def test_interval_arithmetic(self):
        from repro_torch.core.expr import VarExpr

        v = VarExpr("i", extent=8)
        assert interval(v * 4 + 2) == (2.0, 30.0)
        assert interval((v - 4) * -1) == (-3.0, 4.0)
        assert interval(v % 3) == (0.0, 2.0)
        assert interval(v // 2) == (0.0, 3.0)
        lo, hi = interval(VarExpr("free"))
        assert lo == -np.inf and hi == np.inf


# ---------------------------------------------------------------------------
# Layer 2: the sanitizing interpreter
# ---------------------------------------------------------------------------

_CASES = dict(parity_programs())


def _make_input(param, rng):
    if param.dtype.startswith(("int", "uint")):
        return rng.integers(-4, 4, size=param.shape).astype(param.dtype)
    return rng.standard_normal(param.shape).astype(param.dtype)


class TestSanitizer:
    @pytest.mark.parametrize("name", sorted(_CASES))
    def test_sanitize_parity(self, name, rng):
        """Every program runs clean under the sanitizer and matches the plain
        reference interpreter bit for bit (the sanitizer observes only)."""
        prog = _CASES[name]
        sk = tl_compile(prog, target="sanitize")
        rk = tl_compile(prog, target="reference")
        assert sk.backend == "sanitize"
        args = parity_inputs(name, prog, rng)
        if args is None:
            args = [_make_input(p, rng) for p in sk.arg_params]
        got, want = sk(*_t(*args)), rk(*_t(*args))
        got, want = (x if isinstance(x, tuple) else (x,) for x in (got, want))
        for g, w in zip(got, want, strict=True):  # the prefill's pools too
            np.testing.assert_array_equal(g.numpy(), w.numpy())

    def test_duplicate_write_detected(self, rng):
        a = rng.standard_normal((32, 128)).astype(np.float32)
        err = _same_error(dup_write_program, "sanitize", SanitizeError, JSanitizeError, a)
        assert "duplicate write" in str(err)
        # the plain reference interpreter runs the same program silently
        tl_compile(dup_write_program(), target="reference")(*_t(a))

    def test_unwritten_output_detected(self, rng):
        a = rng.standard_normal((16, 128)).astype(np.float32)
        err = _same_error(half_written_program, "sanitize", SanitizeError, JSanitizeError, a)
        assert "never written" in str(err)

    def test_nonfinite_output_named_with_origin(self, rng):
        @T.prim_func
        def Copy(X: T.Tensor((16, 128), "float32"), O: T.Tensor((16, 128), "float32")):
            with T.Kernel(1) as bx:
                s = T.alloc_shared((16, 128), "float32")
                T.copy(X[0, 0], s)
                T.copy(s, O[0, 0])

        kern = tl_compile(Copy, target="sanitize")
        x = rng.standard_normal((16, 128)).astype(np.float32)
        x[3, 7] = np.nan
        with pytest.raises(SanitizeError, match="non-finite.*CopyOp at cell 0"):
            kern(*_t(x))

    def test_gather_parity_with_valid_table(self, rng):
        kern = tl_compile(gather_program(), target="sanitize")
        tbl = np.array([2, 0, 3, 1], np.int32)
        src = rng.standard_normal((4, 8, 128)).astype(np.float32)
        np.testing.assert_array_equal(kern(*_t(tbl, src)).numpy(), src[tbl])

    @pytest.mark.parametrize("target", ["reference", "sanitize"])
    def test_negative_table_entry_rejected(self, rng, target):
        """A negative dynamic start would wrap to the end of the buffer:
        both interpreters reject it as the JAX package's do."""
        src = rng.standard_normal((4, 8, 128)).astype(np.float32)
        bad = np.array([2, -1, 3, 1], np.int32)
        err = _same_error(gather_program, target, SanitizeError, JSanitizeError, bad, src)
        assert "out of bounds" in str(err)

    def test_oversized_table_entry_rejected(self, rng):
        src = rng.standard_normal((4, 8, 128)).astype(np.float32)
        bad = np.array([2, 9, 3, 1], np.int32)  # page 9 of 4
        err = _same_error(gather_program, "reference", SanitizeError, JSanitizeError, bad, src)
        assert "out of bounds" in str(err)

    def test_region_start_checks_unit(self):
        buf = type("B", (), {"name": "X", "shape": (8, 16)})()
        _check_region_starts(buf, (0, 8), (8, 8), "copy")  # in bounds
        with pytest.raises(SanitizeError, match="out of bounds"):
            _check_region_starts(buf, (-1, 0), (4, 4), "copy")
        with pytest.raises(SanitizeError, match="out of bounds"):
            _check_region_starts(buf, (6, 0), (4, 4), "copy")
        _check_scalar_index(buf, (7, 15))
        with pytest.raises(SanitizeError, match="scalar load"):
            _check_scalar_index(buf, (8, 0))
        with pytest.raises(SanitizeError, match="scalar load"):
            _check_scalar_index(buf, (0, -2))


# ---------------------------------------------------------------------------
# Layer 3: the dispatch guard (the port's kernels.ops.guard_dispatch)
# ---------------------------------------------------------------------------


def _tables(rows, max_pages, fill):
    tb = np.zeros((rows, max_pages), np.int32)
    for r, pages in enumerate(fill):
        tb[r, : len(pages)] = pages
    return tb


class TestDispatchGuard:
    PS = 4  # page size
    NP = 9  # pool pages: valid ids [1, 9)

    def test_clean_dispatch_passes(self):
        tb = _tables(2, 4, [[1, 2, 3], [4, 5]])
        guard_dispatch(tb, self.NP, self.PS, [(0, 10, 9, 10), (1, 6, 5, 6)])

    def test_out_of_range_entry_blames_the_row(self):
        tb = _tables(2, 4, [[1, 99, 3], [4, 5]])
        with pytest.raises(GuardError) as ei:
            guard_dispatch(tb, self.NP, self.PS, [(0, 10, 9, 10), (1, 6, 5, 6)])
        assert {r for r, _, _ in ei.value.violations} == {0}
        assert {k for _, k, _ in ei.value.violations} == {"table_in_range"}
        assert "99" in str(ei.value)

    def test_reserved_page0_in_live_prefix_rejected(self):
        tb = _tables(1, 4, [[1, 0, 3]])
        with pytest.raises(GuardError, match="reserved"):
            guard_dispatch(tb, self.NP, self.PS, [(0, 10, 9, 10)])

    def test_capacity_overflow_rejected(self):
        tb = _tables(1, 4, [[1, 2, 3, 4]])
        with pytest.raises(GuardError, match="capacity"):
            guard_dispatch(tb, self.NP, self.PS, [(0, 17, 16, 17)])

    def test_duplicate_writable_page_blames_both_rows(self):
        tb = _tables(2, 4, [[1, 2, 7], [4, 5, 7]])
        with pytest.raises(GuardError) as ei:
            guard_dispatch(tb, self.NP, self.PS, [(0, 10, 9, 10), (1, 10, 9, 10)])
        assert {r for r, _, _ in ei.value.violations} == {0, 1}
        assert {k for _, k, _ in ei.value.violations} == {"table_writes_disjoint"}

    def test_readonly_prefix_sharing_is_legal(self):
        tb = _tables(2, 4, [[1, 2, 3], [1, 2, 6]])
        guard_dispatch(tb, self.NP, self.PS, [(0, 10, 9, 10), (1, 10, 9, 10)])
