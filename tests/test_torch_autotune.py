"""The port's cost-model autotuner (``repro_torch.core.autotune``), its
``tune_matmul``, the ``core.lower`` compatibility names and the torch
custom-kernel example, against the JAX package's (``repro.core.autotune``,
``tests/test_tile_language.py``'s ``TestAutotune``, ``repro.core.lower``,
``examples/custom_kernel.py``).

The score is the card's: ``roofline.analysis.HW_H100``'s peaks (bf16,
int8, fp32 by the GEMMs' operands) derated by ``GemmReport.
mma_utilization``, the block's 232,448 bytes of shared memory the
feasibility test.  Nothing here needs a card: the winner is compiled for
``cuda`` (its text emitted, built at a first call that never comes) or run
through the reference interpreter.
"""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import grid_configs as jgrid_configs
from repro.core import lang as JT
from repro.core import lower as jlower
from repro.kernels.matmul import default_configs as jdefault_configs
from repro_torch.core import LoweringError, analyze, autotune, compile as tl_compile, grid_configs
from repro_torch.core import lang as T
from repro_torch.core import lower
from repro_torch.core.autotune import _CACHE, peak_for, score_module
from repro_torch.kernels.matmul import default_configs, matmul_program, tune_matmul
from repro_torch.roofline.analysis import HW_H100

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example():
    spec = importlib.util.spec_from_file_location(
        "torch_custom_kernel", ROOT / "examples" / "torch_custom_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("shape", [(1024, 1024, 1024), (96, 384, 160), (8192, 8192, 28672)])
def test_configs_equal_the_jax_packages(shape):
    assert default_configs(*shape) == jdefault_configs(*shape)
    axes = dict(block_M=[64, 128], block_N=[shape[1]], block_K=[32, 64, 128], num_stages=[2, 3])
    assert grid_configs(**axes) == jgrid_configs(**axes)


def test_tune_matmul_prefers_larger_blocks():
    """The JAX package's test on the card's model: at 1024^3 in bf16 the
    winner takes 128-row blocks or more at full tensor-core use, compiled
    for the card."""
    kern, cand = tune_matmul(1024, 1024, 1024, "bfloat16", "bfloat16")
    assert cand.feasible and kern.backend == "cuda"
    assert cand.config["block_M"] >= 128
    assert cand.mma_util == 1.0


def test_autotune_rejects_infeasible():
    """The JAX package's two configs at 8192^3: blocks of 8192 x 8192 do not
    fit the block's shared memory, 128 x 128 x 64 does and wins."""

    def build(**cfg):
        return matmul_program(8192, 8192, 8192, **cfg)

    kern, cand, allc = autotune(
        build,
        [dict(block_M=8192, block_N=8192, block_K=64), dict(block_M=128, block_N=128, block_K=64)],
        return_all=True,
    )
    assert cand.config["block_M"] == 128
    assert not allc[0].feasible and "shared-memory budget" in allc[0].reason
    assert analyze(build(block_M=128, block_N=128, block_K=64)).vmem.limit == 232448


def test_score_is_the_roofline_at_the_cards_peaks():
    """One candidate's score by hand from its KernelCost: the FLOPs at the
    bf16 tensor-core peak over the worst tile's use against the HBM bytes
    at 3.35 TB/s, the larger of the two (two stages overlap them)."""
    cfg = dict(block_M=128, block_N=128, block_K=64, num_stages=2)
    _, _, allc = autotune(lambda **c: matmul_program(1024, 1024, 1024, "bfloat16", "bfloat16",
                                                     "float32", **c),
                          [cfg], return_all=True)
    m = analyze(matmul_program(1024, 1024, 1024, "bfloat16", "bfloat16", "float32", **cfg))
    mma = min(g.mma_utilization for g in m.inference.gemms)
    compute = m.cost.flops / HW_H100["peak_flops_bf16"] / mma
    memory = m.cost.hbm_bytes / HW_H100["hbm_bw"]
    assert allc[0].score == pytest.approx(max(compute, memory), rel=1e-12)
    assert (allc[0].compute_s, allc[0].memory_s) == pytest.approx((compute, memory), rel=1e-12)
    assert score_module(m)[0] == allc[0].score
    assert peak_for("int8") == HW_H100["peak_ops_int8"]
    assert peak_for("float32") == peak_for(None) == HW_H100["peak_flops_fp32"]


def _elementwise(sort: bool, width: int = 64):
    """Doubles a tile, by a ``T.Parallel`` or (``sort``) by a tile-library
    sort the CUDA backend cannot emit: a config that analyzes and scores
    (a custom op counts no FLOPs) but fails at emission."""

    @T.prim_func
    def Twice(X: T.Tensor((8, width), "float32"), O: T.Tensor((8, width), "float32")):
        with T.Kernel(1) as bx:
            xs = T.alloc_shared((8, width), "float32")
            ys = T.alloc_fragment((8, width), "float32")
            T.copy(X[0, 0], xs)
            if sort:
                T.call_tile_lib(lambda v: torch.sort(v, dim=-1).values, ys, xs, name="sorted")
            else:
                for i, j in T.Parallel(8, width):
                    ys[i, j] = xs[i, j] * 2
            T.copy(ys, O[0, 0])

    return Twice


def test_a_winner_failing_at_emission_is_demoted():
    """The best-scoring config fails the CUDA backend's emission: it is
    demoted (and cached so), the next compiled; the reference target takes
    the first."""
    key = ("twice", 8)
    kern, cand, allc = autotune(_elementwise, grid_configs(sort=[True, False]), cache_key=key,
                                return_all=True)
    assert cand.config == {"sort": False} and kern.backend == "cuda"
    assert not allc[0].feasible and "aten.sort" in allc[0].reason
    cached = [c for k, c in _CACHE.items() if k[0] == key and k[2] == "cuda"]
    assert {c.config["sort"]: c.feasible for c in cached} == {True: False, False: True}
    kern, cand = autotune(_elementwise, grid_configs(sort=[True, False]), cache_key=key,
                          target="reference")
    assert cand.config == {"sort": True} and kern.backend == "reference"
    with pytest.raises(LoweringError, match="aten.sort"):
        tl_compile(_elementwise(True), target="cuda", use_cache=False)


def test_lower_names_equal_the_jax_packages():
    assert lower.__all__ == jlower.__all__
    for name in lower.__all__:
        assert getattr(lower, name) is not None, name
    assert lower.compile is tl_compile and lower.analyze is analyze


def _jax_fused(block_M, block_N, block_K, num_stages=2):
    """examples/custom_kernel.py's program without running its script: its
    ``Fused`` body at its shapes, the gelu in jnp."""
    M, N, K = 128, 256, 512

    @JT.prim_func
    def Fused(A: JT.Tensor((M, K), "float32"), B: JT.Tensor((N, K // 2), "int8"),
              C: JT.Tensor((N, M), "float32")):
        with JT.Kernel(JT.ceildiv(N, block_N), JT.ceildiv(M, block_M)) as (bx, by):
            A_s = JT.alloc_shared((block_M, block_K), "float32")
            B_s = JT.alloc_shared((block_N, block_K // 2), "int8")
            B_q = JT.alloc_fragment((block_N, block_K), "float32")
            acc = JT.alloc_fragment((block_N, block_M), "float32")
            JT.use_swizzle(2)
            JT.clear(acc)
            for k in JT.Pipelined(JT.ceildiv(K, block_K), num_stages=num_stages):
                JT.copy(A[by * block_M, k * block_K], A_s)
                JT.copy(B[bx * block_N, k * (block_K // 2)], B_s)
                for i, j in JT.Parallel(block_N, block_K):
                    v = (B_s[i, j // 2] >> ((j % 2) * 4)) & 15
                    B_q[i, j] = JT.cast(JT.if_then_else(v >= 8, v - 16, v), "float32")
                JT.gemm(B_q, A_s, acc, transpose_B=True)
            act = JT.alloc_fragment((block_N, block_M), "float32")
            JT.call_tile_lib(
                lambda x: 0.5 * x * (1 + jnp.tanh(0.7978845608 * (x + 0.044715 * x**3))),
                act, acc, name="gelu")
            JT.copy(act, C[bx * block_N, by * block_M])

    return Fused


def test_custom_kernel_example_matches_the_jax_examples_program():
    """The torch example's program at one config, run on the CPU through the
    reference interpreter (the gelu as torch) and as the CUDA backend would
    emit it (the gelu rewritten into T ops), against the JAX example's
    program through Pallas interpret, on the example's seeded inputs: within
    1e-5 of max |JAX|."""
    from repro.core import Schedule as JSchedule
    from repro.core import compile as jcompile
    from repro_torch.core.backends.tile_lib import lower_tile_lib

    ex = _example()
    cfg = dict(block_M=128, block_N=128, block_K=256)
    a, bp = ex.inputs("cpu")
    want = np.asarray(jcompile(_jax_fused(**cfg), JSchedule(interpret=True))(a.numpy(),
                                                                           bp.numpy()))
    prog = ex.fused_dequant_gelu_matmul(**cfg)
    scale = np.abs(want).max()
    for p in (prog, lower_tile_lib(prog)):
        got = tl_compile(p, target="reference")(a, bp).numpy()
        assert np.abs(got - want).max() <= 1e-5 * scale


def test_custom_kernel_example_runs_on_the_cpu_only_when_asked(capsys):
    """``main(["--device", "cpu"])`` tunes for the reference interpreter and
    meets the example's limit; the winner fits the card's shared memory."""
    ex = _example()
    res = ex.main(["--device", "cpu"])
    assert res["kernel"].backend == "reference" and res["err"] <= ex.LIMIT
    assert res["winner"].feasible and res["winner"].config in ex.CONFIGS
    assert analyze(ex.fused_dequant_gelu_matmul(**res["winner"].config)).vmem.ok
    assert "autotuner picked" in capsys.readouterr().out
