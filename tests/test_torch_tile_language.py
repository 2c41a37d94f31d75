"""The port's tile language (``repro_torch.core``) against the JAX package's
``tests/test_tile_language.py``: expressions, layouts, tracing, inference
and scheduling assert what the JAX tests assert, on the card's geometry
where the JAX tests read the TPU's (a warp of 32 lanes, 16-byte vectors,
the m16n8k tensor-core tile, a 232,448-byte shared-memory budget).  Programs
run through ``target="reference"`` (the trace interpreter over torch
tensors); the tests that compared the Pallas lowering compare the JAX
package's Pallas program in interpret mode instead.  The autotuner's tests
are tests/test_torch_autotune.py.  The ops the JAX package's language lacks
(``T.atomic_max`` / ``T.atomic_min``) are held to its IR's ``AtomicOp``
through its Pallas lowering; ``T.call_tile_lib`` as the CUDA backend emits
it (its function rewritten into T ops) is held to the function itself."""
import numpy as np
import pytest
import torch

from repro_torch.core import (
    LoweringError,
    Schedule,
    ScheduleError,
    TraceError,
    compile as tl_compile,
    infer_layouts,
    padded,
    row_major,
    warp_fragment,
)
from repro_torch.core import lang as T
from repro_torch.core.expr import ConstExpr, VarExpr, evaluate, linear_decompose, static_eval
from repro_torch.core.layout import IterVar, Layout
from repro_torch.core.schedule import physical_tile_shape, swizzle_decode
from repro_torch.core.backends.tile_lib import lower_tile_lib


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _run(kernel, *arrays):
    out = kernel(*[torch.from_numpy(np.ascontiguousarray(a)) for a in arrays])
    return out.numpy()


def _atomic_program(L, update):
    """Four grid cells each combining a (16, 128) tile into one output, in
    either package's language (``L``); ``update(dst, src)`` records the
    atomic."""

    @L.prim_func
    def Atomic(X: L.Tensor((4, 16, 128), "float32"), O: L.Tensor((16, 128), "float32")):
        with L.Kernel(4) as bx:
            xs = L.alloc_shared((16, 128), "float32")
            L.copy(X[bx, 0, 0], xs)
            update(O[0, 0], xs)

    return Atomic


def _cumsum_program(L, dim, reverse):
    @L.prim_func
    def Cumsum(X: L.Tensor((2, 16, 64), "float32"), O: L.Tensor((2, 16, 64), "float32")):
        with L.Kernel(2) as bx:
            xs = L.alloc_shared((16, 64), "float32")
            cs = L.alloc_fragment((16, 64), "float32")
            L.copy(X[bx, 0, 0], xs)
            L.cumsum(xs, cs, dim=dim, reverse=reverse)
            L.copy(cs, O[bx, 0, 0])

    return Cumsum


def _batched_gemm_program(L, b_shape):
    """A (2, 4, 32, 16) batch a cell times B (``b_shape``: (16, 32) shared by
    the batches, or (4, 16, 32) one a batch) into C (2, 4, 32, 32)."""

    @L.prim_func
    def BatchedGemm(A: L.Tensor((2, 4, 32, 16), "float32"), B: L.Tensor(b_shape, "float32"),
                    C: L.Tensor((2, 4, 32, 32), "float32")):
        with L.Kernel(2) as bx:
            a = L.alloc_shared((4, 32, 16), "float32")
            b = L.alloc_shared(b_shape, "float32")
            c = L.alloc_fragment((4, 32, 32), "float32")
            L.copy(A[bx, 0, 0, 0], a)
            L.copy(B[(0,) * len(b_shape)], b)
            L.clear(c)
            L.gemm(a, b, c)
            L.copy(c, C[bx, 0, 0, 0])

    return BatchedGemm


def _tile_lib_program(fn, name):
    @T.prim_func
    def Custom(X: T.Tensor((8, 128), "float32"), O: T.Tensor((8, 128), "float32")):
        with T.Kernel(1) as bx:
            xs = T.alloc_shared((8, 128), "float32")
            sm = T.alloc_fragment((8, 128), "float32")
            T.copy(X[0, 0], xs)
            T.call_tile_lib(fn, sm, xs, name=name)
            T.copy(sm, O[0, 0])

    return Custom


# the functions the repo passes to T.call_tile_lib, but nf4's (a program of
# its own): the doubling of tests/test_torch_pipeline.py, the softmax below,
# the torch custom-kernel example's gelu; and one through a comparison, a
# select, a row minimum, a reshape and a permute (index maps, no copies)
_TILE_LIB = {
    "double": lambda v: v * 2,
    "softmax": lambda v: torch.softmax(v, dim=-1),
    "gelu": lambda x: 0.5 * x * (1 + torch.tanh(0.7978845608 * (x + 0.044715 * x**3))),
    "permuted": lambda v: torch.where(v > 0, v, -v.amin(-1, keepdim=True))
    .reshape(8, 2, 64).permute(1, 0, 2).reshape(8, 128),
}


# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class TestExpr:
    def test_arithmetic_tree_and_eval(self):
        x, y = VarExpr("x"), VarExpr("y")
        e = (x * 3 + y) // 2 - 1
        val = evaluate(e, {"x": 5, "y": 7}, load_fn=None)
        assert val == (5 * 3 + 7) // 2 - 1

    def test_floor_semantics_on_tensors(self):
        """``//`` and ``%`` keep Python's floor rule on tensors too (the CUDA
        backend's floor helpers mirror it)."""
        x = VarExpr("x")
        xs = torch.arange(-7, 8)
        got = evaluate(x // 3 + x % 4, {"x": xs}, load_fn=None)
        assert got.tolist() == [v // 3 + v % 4 for v in range(-7, 8)]

    def test_static_eval(self):
        e = ConstExpr(6) * 7 + 2
        assert static_eval(e) == 44
        assert static_eval(VarExpr("k") + 1) is None

    def test_linear_decompose(self):
        x, y = VarExpr("x"), VarExpr("y")
        dec = linear_decompose(2 * x + y * 3 + 5)
        assert dec == {"x": 2, "y": 3, "": 5}
        assert linear_decompose(x * y) is None

    def test_bool_coercion_raises(self):
        with pytest.raises(TraceError):
            bool(VarExpr("x") + 1)


# ---------------------------------------------------------------------------
# Layout algebra (paper §4.1, Fig. 5/6)
# ---------------------------------------------------------------------------


class TestLayout:
    def test_row_major_linearization(self):
        lay = row_major((4, 8))
        assert lay.map_concrete(2, 3) == (2 * 8 + 3,)
        assert lay.out_shape() == (32,)
        assert lay.is_bijective()

    def test_padding_layout_non_bijective(self):
        lay = padded((5, 100), (8, 128))
        assert lay.out_shape() == (8, 128)
        assert lay.map_concrete(4, 99) == (4, 99)
        assert not lay.is_bijective()  # padded box has holes

    def test_compose(self):
        inner = row_major((4, 8))  # 2d -> 1d
        outer = Layout([IterVar.make("f", 32)], (VarExpr("f", extent=32) % 32,))
        comp = outer.compose(inner)
        assert comp.map_concrete(1, 2) == ((1 * 8 + 2) % 32,)

    def test_fragment_repeat_grows_locals(self):
        # paper Fig. 6: repeat tiles new rows into the same partitions
        base = warp_fragment((16, 32))
        assert base.threads() == 1
        rep = base.repeat(4, axis=0)
        assert rep.in_shape == (64, 32)
        assert rep.threads() == 1
        assert rep.locals_per_thread() == 4 * base.locals_per_thread()

    def test_fragment_repeat_on_thread_grows_partitions(self):
        base = warp_fragment((16, 32))
        rep = base.repeat_on_thread(4, axis=0)
        assert rep.in_shape == (64, 32)
        assert rep.threads() == 4 * base.threads()
        assert rep.locals_per_thread() == base.locals_per_thread()

    def test_fragment_replicate(self):
        # paper Fig. 7: broadcast operands live in several partitions
        base = warp_fragment((16, 32)).repeat_on_thread(2, axis=0)
        rep = base.replicate(3)
        assert rep.replication == 3
        assert rep.threads() == 3 * base.threads()
        cond = rep.condense()
        assert cond.replication == 1
        assert cond.threads() == base.threads()

    def test_card_geometry_by_dtype(self):
        from repro_torch.core.layout import BANKS, MMA, WARP, mma_k, vector_elems

        assert (WARP, BANKS, MMA) == (32, 32, (16, 8, 16))
        assert [mma_k(d) for d in ("float32", "bfloat16", "int8")] == [8, 16, 32]
        assert [vector_elems(d) for d in ("float32", "bfloat16", "int8")] == [4, 8, 16]
        # a warp tile: 16 rows by 32 lanes, raster-ordered
        frag = warp_fragment((32, 64))
        assert frag.out_shape() == (4, 16 * 32)
        assert frag.map_concrete(17, 33) == (3, 1 * 32 + 1)

    def test_physical_tile_padding(self):
        assert physical_tile_shape((5, 100), "float32") == (5, 100)
        assert physical_tile_shape((16, 250), "bfloat16") == (16, 256)
        assert physical_tile_shape((64,), "float32") == (64,)
        # a tensor-core operand with whole 128-byte rows: one vector more
        assert physical_tile_shape((64, 128), "bfloat16", tensor_core=True) == (64, 136)
        assert physical_tile_shape((64, 64), "float32", tensor_core=True) == (64, 68)
        assert physical_tile_shape((64, 40), "bfloat16", tensor_core=True) == (64, 40)


# ---------------------------------------------------------------------------
# Tracing / program construction
# ---------------------------------------------------------------------------


def _simple_program(m=64, n=64):
    @T.prim_func
    def AddOne(X: T.Tensor((m, n), "float32"), Y: T.Tensor((m, n), "float32")):
        with T.Kernel(1) as bx:
            xs = T.alloc_shared((m, n), "float32")
            ys = T.alloc_fragment((m, n), "float32")
            T.copy(X[0, 0], xs)
            for i, j in T.Parallel(m, n):
                ys[i, j] = xs[i, j] + 1.0
            T.copy(ys, Y[0, 0])

    return AddOne


class TestTracing:
    def test_program_classification(self):
        prog = _simple_program()
        assert [p.name for p in prog.input_params()] == ["X"]
        assert [p.name for p in prog.output_params()] == ["Y"]

    def test_elementwise_program_runs(self, rng):
        prog = _simple_program(16, 128)
        kern = tl_compile(prog, target="reference")
        x = rng.standard_normal((16, 128), dtype=np.float32)
        np.testing.assert_allclose(_run(kern, x), x + 1.0, rtol=1e-6)

    def test_primitive_outside_kernel_raises(self):
        with pytest.raises(TraceError):
            T.alloc_shared((8, 128), "float32")

    def test_gemm_shape_mismatch_raises(self):
        with pytest.raises(TraceError):

            @T.prim_func
            def Bad(A: T.Tensor((8, 16), "float32"), C: T.Tensor((8, 8), "float32")):
                with T.Kernel(1) as bx:
                    a = T.alloc_shared((8, 16), "float32")
                    b = T.alloc_shared((8, 16), "float32")  # K mismatch
                    c = T.alloc_fragment((8, 8), "float32")
                    T.gemm(a, b, c)

    def test_global_gemm_operand_raises(self):
        with pytest.raises(TraceError):

            @T.prim_func
            def Bad(A: T.Tensor((8, 8), "float32"), C: T.Tensor((8, 8), "float32")):
                with T.Kernel(1) as bx:
                    c = T.alloc_fragment((8, 8), "float32")
                    T.gemm(A, A, c)

    def test_two_kernels_raise(self):
        with pytest.raises(TraceError):

            @T.prim_func
            def Bad(A: T.Tensor((8, 8), "float32")):
                with T.Kernel(1) as bx:
                    pass
                with T.Kernel(1) as by:
                    pass

    def test_threads_is_a_cuda_block(self):
        with pytest.raises(TraceError, match="CUDA block"):
            T.Kernel(1, threads=2048)
        prog = _simple_program(16, 128)
        assert prog.threads is None  # the backend's default block

    def test_double_pipelined_lowering_error(self):
        @T.prim_func
        def TwoLoops(A: T.Tensor((64, 64), "float32"), B: T.Tensor((64, 64), "float32")):
            with T.Kernel(1) as bx:
                s = T.alloc_shared((64, 64), "float32")
                f = T.alloc_fragment((64, 64), "float32")
                for k in T.Pipelined(2):
                    T.copy(A[0, 0], s)
                for k in T.Pipelined(2):
                    T.copy(s, f)
                T.copy(f, B[0, 0])

        with pytest.raises(LoweringError):
            tl_compile(TwoLoops, target="reference")

    def test_smem_budget_enforced(self):
        @T.prim_func
        def Huge(A: T.Tensor((256, 256), "float32"), B: T.Tensor((256, 256), "float32")):
            with T.Kernel(1) as bx:
                s = T.alloc_shared((256, 256), "float32")  # 256 KiB > 227 KiB
                T.copy(A[0, 0], s)
                T.copy(s, B[0, 0])

        with pytest.raises(ScheduleError, match="budget exceeded"):
            tl_compile(Huge, target="cuda")
        # the reference interpreter has no shared memory: it runs
        assert tl_compile(Huge, target="reference").backend == "reference"


# ---------------------------------------------------------------------------
# Layout inference (paper §4.2): priority, replication, vectorization
# ---------------------------------------------------------------------------


class TestInference:
    def test_bias_replication_fig7(self):
        """The Fig. 7 scenario: bias D indexed only by j must be replicated
        across the i-axis partitions."""

        @T.prim_func
        def BiasAdd(D: T.Tensor((1, 64), "float32"), O: T.Tensor((32, 64), "float32")):
            with T.Kernel(1) as bx:
                d = T.alloc_shared((1, 64), "float32", name="d")
                c = T.alloc_fragment((32, 64), "float32", name="c")
                T.copy(D[0, 0], d)
                T.fill(c, 1.0)
                for i, j in T.Parallel(32, 64):
                    c[i, j] = c[i, j] + d[0, j]
                T.copy(c, O[0, 0])

        res = infer_layouts(BiasAdd)
        binding = res.parallels[0]
        assert binding.replication["d"] == 32  # replicated across all i
        assert binding.replication["c"] == 1

    def test_gemm_pins_layouts_first(self):
        from repro_torch.kernels.matmul import matmul_program

        prog = matmul_program(256, 256, 256, block_M=128, block_N=128, block_K=64)
        res = infer_layouts(prog)
        assert res.gemms[0].mma_utilization == 1.0  # whole m16n8k8 tiles
        assert len(res.layouts) >= 3

    def test_mma_utilization_penalizes_ragged_tiles(self):
        from repro_torch.kernels.matmul import matmul_program

        prog = matmul_program(48, 48, 48, block_M=24, block_N=24, block_K=24)
        res = infer_layouts(prog)
        # M pads 24 -> 32 on m16 tiles; N (n8) and K (k8 in fp32) fit
        assert res.gemms[0].mma_utilization == pytest.approx(24 / 32)

    def test_vectorization_inferred(self):
        prog = _simple_program(16, 128)
        res = infer_layouts(prog)
        assert res.parallels[0].vector_width == 32  # the lanes of a warp


# ---------------------------------------------------------------------------
# Schedule: swizzle + shared-memory plan
# ---------------------------------------------------------------------------


class TestSchedule:
    @pytest.mark.parametrize("g0,g1,factor", [(8, 4, 2), (8, 8, 4), (16, 2, 8)])
    def test_swizzle_decode_is_permutation(self, g0, g1, factor):
        seen = set()
        for flat in range(g0 * g1):
            i0, i1 = swizzle_decode(flat, g0, g1, factor)
            assert 0 <= i0 < g0 and 0 <= i1 < g1
            seen.add((i0, i1))
        assert len(seen) == g0 * g1

    def test_swizzle_panel_locality(self):
        # within a panel, consecutive steps keep the same column block
        g0, g1, f = 8, 4, 4
        cols = [swizzle_decode(i, g0, g1, f)[1] for i in range(f)]
        assert len(set(cols)) == 1

    @pytest.mark.parametrize("g0,g1,factor", [(6, 3, 4), (10, 2, 4), (7, 5, 3)])
    def test_swizzle_ragged_int_path_is_permutation(self, g0, g1, factor):
        seen = {swizzle_decode(f, g0, g1, factor) for f in range(g0 * g1)}
        assert seen == {(i0, i1) for i0 in range(g0) for i1 in range(g1)}

    @pytest.mark.parametrize("g0,g1,factor", [(8, 4, 2), (6, 3, 3), (16, 2, 8)])
    def test_swizzle_traced_matches_int_when_divisible(self, g0, g1, factor):
        """Under ``g0 % factor == 0`` the tensor (traced) decode, the
        arithmetic the CUDA backend prints, agrees with the int decode."""
        from repro_torch.core.schedule import validate_swizzle

        validate_swizzle(g0, g1, factor)
        flat = torch.arange(g0 * g1, dtype=torch.int32)
        ti0, ti1 = swizzle_decode(flat, g0, g1, factor)
        for f in range(g0 * g1):
            assert (int(ti0[f]), int(ti1[f])) == swizzle_decode(f, g0, g1, factor)

    def test_swizzle_ragged_traced_precondition_rejected(self):
        from repro_torch.core.schedule import validate_swizzle

        with pytest.raises(ScheduleError, match="multiple of the factor"):
            validate_swizzle(6, 3, 4)

    def test_swizzled_matmul_correct(self, rng):
        from repro_torch.kernels.matmul import matmul_program

        prog = matmul_program(128, 128, 64, block_M=32, block_N=32, block_K=32, swizzle=2)
        kern = tl_compile(prog, target="reference")
        a = rng.standard_normal((128, 64), dtype=np.float32)
        b = rng.standard_normal((64, 128), dtype=np.float32)
        np.testing.assert_allclose(_run(kern, a, b), a @ b, atol=1e-3)

    def test_num_stages_is_recorded_not_multiplied(self):
        """The CUDA backend stages one copy of each tile (a ring honouring
        num_stages is later work): the stage count is recorded, the plan is
        the same."""
        from repro_torch.kernels.matmul import matmul_program

        prog2 = matmul_program(256, 256, 256, block_M=64, block_N=64, block_K=64, num_stages=2)
        prog4 = matmul_program(256, 256, 256, block_M=64, block_N=64, block_K=64, num_stages=4)
        k2 = tl_compile(prog2, target="reference")
        k4 = tl_compile(prog4, target="reference")
        assert k4.info.vmem.total_bytes == k2.info.vmem.total_bytes == 3 * 64 * 64 * 4
        c2, c4 = (tl_compile(p, target="cuda") for p in (prog2, prog4))
        assert (c2.info.num_stages, c4.info.num_stages) == (2, 4)


# ---------------------------------------------------------------------------
# Remaining operator coverage: atomics, cumsum, annotate_layout,
# serial/unroll loops, custom ops
# ---------------------------------------------------------------------------


class TestMoreOps:
    def test_atomic_add_accumulates_into_global(self, rng):
        """T.atomic lowers to an aliased in-out window."""

        @T.prim_func
        def ColSum(X: T.Tensor((4, 16, 128), "float32"), O: T.Tensor((16, 128), "float32")):
            with T.Kernel(4) as bx:
                xs = T.alloc_shared((16, 128), "float32")
                T.copy(X[bx, 0, 0], xs)
                T.atomic_add(O[0, 0], xs)

        kern = tl_compile(ColSum, target="reference")
        x = rng.standard_normal((4, 16, 128), dtype=np.float32)
        o0 = np.ones((16, 128), np.float32)
        out = _run(kern, x, o0)
        np.testing.assert_allclose(out, o0 + x.sum(0), atol=1e-5)
        assert (o0 == 1).all()  # the caller's tensor is not written

    def test_cumsum(self, rng):
        @T.prim_func
        def Cumsum(X: T.Tensor((8, 128), "float32"), O: T.Tensor((8, 128), "float32")):
            with T.Kernel(1) as bx:
                xs = T.alloc_shared((8, 128), "float32")
                cs = T.alloc_fragment((8, 128), "float32")
                T.copy(X[0, 0], xs)
                T.cumsum(xs, cs, dim=1)
                T.copy(cs, O[0, 0])

        kern = tl_compile(Cumsum, target="reference")
        x = rng.standard_normal((8, 128), dtype=np.float32)
        np.testing.assert_allclose(_run(kern, x), np.cumsum(x, 1), atol=1e-4)

    def test_serial_unroll_loop(self, rng):
        @T.prim_func
        def FourX(X: T.Tensor((8, 128), "float32"), O: T.Tensor((8, 128), "float32")):
            with T.Kernel(1) as bx:
                acc = T.alloc_fragment((8, 128), "float32")
                xs = T.alloc_shared((8, 128), "float32")
                T.copy(X[0, 0], xs)
                T.clear(acc)
                for _ in T.unroll(4):
                    for i, j in T.Parallel(8, 128):
                        acc[i, j] = acc[i, j] + xs[i, j]
                T.copy(acc, O[0, 0])

        kern = tl_compile(FourX, target="reference")
        x = rng.standard_normal((8, 128), dtype=np.float32)
        np.testing.assert_allclose(_run(kern, x), 4 * x, atol=1e-5)

    def test_annotate_layout_override(self):
        @T.prim_func
        def Annotated(X: T.Tensor((8, 100), "float32"), O: T.Tensor((8, 100), "float32")):
            with T.Kernel(1) as bx:
                xs = T.alloc_shared((8, 100), "float32", name="xs")
                T.annotate_layout({xs: padded((8, 100), (8, 256))})
                T.copy(X[0, 0], xs)
                T.copy(xs, O[0, 0])

        res = infer_layouts(Annotated)
        assert res.layouts["xs"].out_shape() == (8, 256)  # user layout won

    def test_custom_op_tile_library(self, rng):
        @T.prim_func
        def Softmaxed(X: T.Tensor((8, 128), "float32"), O: T.Tensor((8, 128), "float32")):
            with T.Kernel(1) as bx:
                xs = T.alloc_shared((8, 128), "float32")
                sm = T.alloc_fragment((8, 128), "float32")
                T.copy(X[0, 0], xs)
                T.call_tile_lib(lambda v: torch.softmax(v, dim=-1), sm, xs)
                T.copy(sm, O[0, 0])

        kern = tl_compile(Softmaxed, target="reference")
        x = rng.standard_normal((8, 128), dtype=np.float32)
        e = np.exp(x)
        np.testing.assert_allclose(_run(kern, x), e / e.sum(-1, keepdims=True), atol=1e-5)

    @pytest.mark.parametrize("kind", ["max", "min"])
    def test_atomic_max_and_min_against_the_jax_package(self, rng, kind):
        """``T.atomic_max`` / ``T.atomic_min`` (the JAX package's IR has the
        ops, its language only ``atomic_add``): the port's interpreter equals
        the JAX package's Pallas lowering in interpret mode and numpy, the
        caller's tensor unwritten."""
        from repro.core import Schedule as JSchedule
        from repro.core import compile as jcompile
        from repro.core import lang as JT
        from repro.core.program import _builder as jbuilder
        from repro.core.tile_ops import AtomicOp as JAtomicOp
        from repro.core.tile_ops import _resolve_against, as_region

        def jatomic(dst, src):
            jbuilder().record(JAtomicOp(kind, _resolve_against(as_region(dst), as_region(src)),
                                        src))

        port = _atomic_program(T, getattr(T, f"atomic_{kind}"))
        jprog = _atomic_program(JT, jatomic)
        x = rng.standard_normal((4, 16, 128), dtype=np.float32)
        o0 = rng.standard_normal((16, 128), dtype=np.float32)
        keep = o0.copy()
        want = np.asarray(jcompile(jprog, JSchedule(interpret=True))(x, o0))
        got = _run(tl_compile(port, target="reference"), x, o0)
        np.testing.assert_array_equal(got, want)
        combine = np.maximum if kind == "max" else np.minimum
        np.testing.assert_array_equal(got, combine.reduce([o0, *x]))
        np.testing.assert_array_equal(o0, keep)

    @pytest.mark.parametrize("dim,reverse", [(1, False), (1, True), (0, True)])
    def test_cumsum_against_the_jax_package(self, rng, dim, reverse):
        """``T.cumsum`` forward and reversed, along either axis: the port's
        interpreter against the JAX package's Pallas lowering (interpret
        mode) and numpy."""
        from repro.core import Schedule as JSchedule
        from repro.core import compile as jcompile
        from repro.core import lang as JT

        x = rng.standard_normal((2, 16, 64), dtype=np.float32)
        got = _run(tl_compile(_cumsum_program(T, dim, reverse), target="reference"), x)
        want = np.asarray(jcompile(_cumsum_program(JT, dim, reverse),
                                   JSchedule(interpret=True))(x))
        np.testing.assert_allclose(got, want, atol=1e-5)
        flip = (lambda a: np.flip(a, dim + 1)) if reverse else (lambda a: a)
        np.testing.assert_allclose(got, flip(np.cumsum(flip(x), dim + 1)), atol=1e-5)

    def test_batched_gemm_against_the_jax_package(self, rng):
        """A batched ``T.gemm`` with B shared by the batches: the port's
        interpreter against the JAX package's Pallas lowering (interpret
        mode); with B one a batch, against ``numpy.matmul``'s broadcast (the
        JAX package's ``dot_general`` with no batch dims takes that case's
        outer product over both batch axes, ROADMAP Queue 3)."""
        from repro.core import Schedule as JSchedule
        from repro.core import compile as jcompile
        from repro.core import lang as JT

        a = rng.standard_normal((2, 4, 32, 16), dtype=np.float32)
        b = rng.standard_normal((16, 32), dtype=np.float32)
        got = _run(tl_compile(_batched_gemm_program(T, (16, 32)), target="reference"), a, b)
        want = np.asarray(jcompile(_batched_gemm_program(JT, (16, 32)),
                                   JSchedule(interpret=True))(a, b))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        bb = rng.standard_normal((4, 16, 32), dtype=np.float32)
        got = _run(tl_compile(_batched_gemm_program(T, (4, 16, 32)), target="reference"), a, bb)
        np.testing.assert_allclose(got, np.matmul(a, bb), rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("name", ["nf4", *_TILE_LIB])
    def test_tile_lib_rewrite_equals_the_function(self, rng, name):
        """``T.call_tile_lib`` as the CUDA backend emits it: the program with
        its function rewritten into T ops (``lower_tile_lib``), run through
        the reference interpreter, equals the program whose interpreter calls
        the function: nf4's codebook lookup bit for bit, the others within
        1e-6."""
        if name == "nf4":
            from repro_torch.kernels import dequant_matmul as dequant

            cfg = dict(dequant.PARITY_CASES)["dequant_matmul_nf4"]
            prog = dequant.dequant_matmul_program(**cfg)
            args = (rng.standard_normal((cfg["M"], cfg["K"]), dtype=np.float32),
                    rng.integers(-128, 128, (cfg["N"], cfg["K"] // 2)).astype(np.int8))
        else:
            prog = _tile_lib_program(_TILE_LIB[name], name)
            args = (rng.standard_normal((8, 128), dtype=np.float32) * 3,)
        low = lower_tile_lib(prog)
        assert low is not prog and not any(type(op).__name__ == "CustomOp" for op in low._walk())
        want = _run(tl_compile(prog, target="reference"), *args)
        got = _run(tl_compile(low, target="reference"), *args)
        if name == "nf4":
            np.testing.assert_array_equal(got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

    def test_tile_lib_op_outside_the_set_raises_at_compile_time(self):
        """A tile-library function with an aten op the rewrite does not take
        (``torch.sort``) raises ``LoweringError`` naming the op and the
        ``CustomOp`` when compiled for the card; it was only traced, over
        fake tensors, never run on data."""
        from torch._subclasses.fake_tensor import FakeTensor

        seen = []

        def sorted_rows(v):
            seen.append(type(v))
            return torch.sort(v, dim=-1).values

        prog = _tile_lib_program(sorted_rows, "sorted_rows")
        with pytest.raises(LoweringError, match=r"custom op sorted_rows .*aten\.sort"):
            tl_compile(prog, target="cuda", use_cache=False)
        assert seen and all(issubclass(t, FakeTensor) for t in seen)

    def test_reference_backend_flash_attention(self, rng):
        """The port's trace interpreter agrees with the JAX package's Pallas
        lowering (interpret mode) on a stateful online-softmax kernel."""
        from repro.core import Schedule as JSchedule
        from repro.core import compile as jcompile
        from repro.kernels.flash_attention import flash_attention_program as jflash
        from repro_torch.kernels.flash_attention import flash_attention_program

        args = (1, 2, 2, 32, 64, 16, True, 16, 32)
        rk = tl_compile(flash_attention_program(*args), target="reference")
        pk = jcompile(jflash(*args), JSchedule(interpret=True))
        q = rng.standard_normal((1, 2, 32, 16), dtype=np.float32)
        k = rng.standard_normal((1, 2, 64, 16), dtype=np.float32)
        v = rng.standard_normal((1, 2, 64, 16), dtype=np.float32)
        np.testing.assert_allclose(np.asarray(pk(q, k, v)), _run(rk, q, k, v), atol=1e-5)
