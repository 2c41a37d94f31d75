"""The port's tile language (``repro_torch.core``) against the JAX package's
``tests/test_tile_language.py``: expressions, layouts, tracing, inference
and scheduling assert what the JAX tests assert, on the card's geometry
where the JAX tests read the TPU's (a warp of 32 lanes, 16-byte vectors,
the m16n8k tensor-core tile, a 232,448-byte shared-memory budget).  Programs
run through ``target="reference"`` (the trace interpreter over torch
tensors); the tests that compared the Pallas lowering compare the JAX
package's Pallas program in interpret mode instead.  The autotuner is not
ported yet (ROADMAP Queue 1 item 19, second half)."""
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
