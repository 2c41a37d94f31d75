"""Advanced tile-DSL usage on the PyTorch port: a fused dequantize-GEMM with
an int4 unpack in a ``T.Parallel``, a tile-library escape hatch written in
torch, grid swizzling, and the cost-model autotuner on the card's peaks.
The port's counterpart of examples/custom_kernel.py: ``target="cuda"``
emits CUDA C++ for ``sm_90a`` (the gelu rewritten into the T language's own
ops, built with ``nvcc`` at the first call); ``--device cpu`` runs the same
program through the reference interpreter (``target="reference"``).

    PYTHONPATH=src python examples/torch_custom_kernel.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.core import autotune, grid_configs, resolve_device
from repro_torch.core import lang as T
from repro_torch.kernels import ref

M, N, K = 128, 256, 512
CONFIGS = grid_configs(block_M=[64, 128], block_N=[64, 128], block_K=[128, 256])
LIMIT = 1e-4  # of max(1, max |oracle|): fp32 sums in another order


def gelu(x):
    """tanh gelu: the tile-library function, on torch tensors."""
    return 0.5 * x * (1 + torch.tanh(0.7978845608 * (x + 0.044715 * x**3)))


def fused_dequant_gelu_matmul(block_M, block_N, block_K, num_stages=2):
    """C = gelu(A @ dequant(B)^T): weight-only int4 + fused activation."""

    @T.prim_func
    def Fused(
        A: T.Tensor((M, K), "float32"),
        B: T.Tensor((N, K // 2), "int8"),
        C: T.Tensor((N, M), "float32"),
    ):
        with T.Kernel(T.ceildiv(N, block_N), T.ceildiv(M, block_M)) as (bx, by):
            A_s = T.alloc_shared((block_M, block_K), "float32")
            B_s = T.alloc_shared((block_N, block_K // 2), "int8")
            B_q = T.alloc_fragment((block_N, block_K), "float32")
            acc = T.alloc_fragment((block_N, block_M), "float32")
            T.use_swizzle(2)  # rasterize the parallel grid for L2 reuse
            T.clear(acc)
            for k in T.Pipelined(T.ceildiv(K, block_K), num_stages=num_stages):
                T.copy(A[by * block_M, k * block_K], A_s)
                T.copy(B[bx * block_N, k * (block_K // 2)], B_s)
                # the int4 unpack, two codes a byte, low nibble first
                for i, j in T.Parallel(block_N, block_K):
                    v = (B_s[i, j // 2] >> ((j % 2) * 4)) & 15
                    B_q[i, j] = T.cast(T.if_then_else(v >= 8, v - 16, v), "float32")
                T.gemm(B_q, A_s, acc, transpose_B=True)
            # tile-library escape hatch: the activation, written in torch
            act = T.alloc_fragment((block_N, block_M), "float32")
            T.call_tile_lib(gelu, act, acc, name="gelu")
            T.copy(act, C[bx * block_N, by * block_M])

    return Fused


def inputs(device):
    """The example's operands, from numpy's generator seeded 0 (the JAX
    example's)."""
    rng = np.random.default_rng(0)
    a = rng.standard_normal((M, K), dtype=np.float32)
    bp = rng.integers(-128, 128, size=(N, K // 2)).astype(np.int8)
    return torch.from_numpy(a).to(device), torch.from_numpy(bp).to(device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    target = "cuda" if device.type == "cuda" else "reference"

    # --- autotune over block shapes with the static cost model ---------------
    kernel, winner = autotune(fused_dequant_gelu_matmul, CONFIGS, target=target)
    print(f"autotuner picked {winner.config} for target {kernel.backend} (predicted "
          f"{winner.score * 1e6:.1f} us, tensor-core use {winner.mma_util:.0%})")

    a, bp = inputs(device)
    out = kernel(a, bp)
    expect = gelu(ref.dequant_matmul(a, bp, "int4").t())
    max_abs_err = (out - expect).abs().max().item()
    err = max_abs_err / max(1.0, expect.abs().max().item())
    assert err <= LIMIT, err
    print(f"fused dequant+gelu matmul matches the oracle within {err:.2e} of max|oracle| ✓")
    return {"kernel": kernel, "winner": winner, "err": err, "max_abs_err": max_abs_err}


if __name__ == "__main__":
    main()
