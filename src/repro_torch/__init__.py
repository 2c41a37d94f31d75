"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``models.lm``, ``kernels.ops``, ``serving.engine``, ...) and never
imports it or JAX.  Every tile kernel on a ported path is a CUDA C++ kernel
written by hand for ``sm_90a`` (``kernels/csrc``), built with ``nvcc`` at
first use and bound with ctypes; its plain PyTorch twin serves CPU tensors
and the tests.

fp32 matrix products stay in full fp32 (no TF32), like XLA:CPU's, so fp32
results on the card compare with the reference at fp32 tolerances.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
