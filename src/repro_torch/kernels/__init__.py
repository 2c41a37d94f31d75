"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
ctypes wrappers (``paged_attention``, ``prefill_attention``), the plain
PyTorch versions (``ref``) and the dispatch layer (``ops``)."""
