"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers (``paged_attention``, ``prefill_attention`` and their
quantized twins ``paged_attention_quant``, ``prefill_attention_quant``),
the latent (MLA) kernels ``mla_paged``, ``mla_prefill`` and their twins
``mla_paged_quant``, ``mla_prefill_quant``, the contiguous
``flash_attention`` of the full-sequence forward (with its autograd
function), the Mamba-2 SSD's ``chunk_state`` and ``chunk_scan`` (each with
its autograd function), the kernel library's ``matmul``,
``dequant_matmul`` and contiguous ``mla``, the plain PyTorch versions
(``ref``) and the dispatch layer (``ops``), exported here as
``repro.kernels`` exports its ``ops`` and ``ref``."""
from . import ops, ref

__all__ = ["ops", "ref"]
