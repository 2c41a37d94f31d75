"""Quickstart on the PyTorch port: write a tile-DSL kernel, compile it for
the card, run it, inspect the schedule the compiler derived.  The port's
counterpart of examples/quickstart.py: ``target="cuda"`` emits CUDA C++ for
``sm_90a``, built with ``nvcc`` at the first call; ``--device cpu`` runs the
same program through the reference interpreter (``target="reference"``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import compile as tl_compile
from repro_torch.core import lang as T
from repro_torch.core import resolve_device

# ---------------------------------------------------------------------------
# 1. Dataflow only: a tiled matmul (paper Fig. 16).  No thread binding, no
#    layouts, no pipelining code — those are the compiler's job.
# ---------------------------------------------------------------------------
M = N = K = 512
bM = bN = bK = 128


@T.prim_func
def Matmul(
    A: T.Tensor((M, K), "float32"),
    B: T.Tensor((K, N), "float32"),
    C: T.Tensor((M, N), "float32"),
):
    with T.Kernel(T.ceildiv(N, bN), T.ceildiv(M, bM), threads=128) as (bx, by):
        A_shared = T.alloc_shared((bM, bK), "float32")
        B_shared = T.alloc_shared((bK, bN), "float32")
        C_local = T.alloc_fragment((bM, bN), "float32")
        T.clear(C_local)
        for k in T.Pipelined(T.ceildiv(K, bK), num_stages=2):
            T.copy(A[by * bM, k * bK], A_shared)
            T.copy(B[k * bK, bx * bN], B_shared)
            T.gemm(A_shared, B_shared, C_local)
        T.copy(C_local, C[by * bM, bx * bN])


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # -----------------------------------------------------------------------
    # 2. Compile: on the card the CUDA backend; on the CPU, asked for, the
    #    reference interpreter.
    # -----------------------------------------------------------------------
    target = "cuda" if device.type == "cuda" else "reference"
    kernel = tl_compile(Matmul, target=target)

    print("target:", kernel.backend)
    print("grid:", kernel.info.grid)
    print("dimension semantics:", kernel.info.dimension_semantics)
    print(kernel.info.vmem.summary())
    print(kernel.info.inference.summary())
    cost = kernel.info.cost
    print(f"cost model: {cost.flops:.3g} FLOPs, {cost.hbm_bytes:.3g} HBM bytes, "
          f"AI = {cost.arithmetic_intensity:.1f} FLOP/B")

    # -----------------------------------------------------------------------
    # 3. Run and check.
    # -----------------------------------------------------------------------
    g = torch.Generator(device=device).manual_seed(0)
    a = torch.randn((M, K), generator=g, device=device)
    b = torch.randn((K, N), generator=g, device=device)
    c = kernel(a, b)
    want = a @ b
    max_abs_err = (c - want).abs().max().item()
    err = max_abs_err / max(1.0, want.abs().max().item())
    assert err <= 1e-4, err
    print(f"matmul matches torch within {err:.2e} of max|a @ b| ✓")
    return {"kernel": kernel, "err": err, "max_abs_err": max_abs_err}


if __name__ == "__main__":
    main()
