"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers (``paged_attention``, ``prefill_attention`` and their
quantized twins ``paged_attention_quant``, ``prefill_attention_quant``),
the plain PyTorch versions (``ref``) and the dispatch layer (``ops``)."""
