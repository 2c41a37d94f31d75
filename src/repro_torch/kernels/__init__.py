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
``repro.kernels`` exports its ``ops`` and ``ref``.

Beside the wrappers, the tile programs that the port's compiler
(``repro_torch.core``) compiles: ``matmul_program`` (``matmul``),
``flash_attention_program`` (``flash_attention``), the paged decode
``paged_attention_program`` and its twin ``paged_attention_quant_program``
(``paged_attention``), the chunked prefill ``prefill_attention_program``
and its twin ``prefill_attention_quant_program`` (``prefill_attention``),
FlashMLA's ``mla_program`` (the paper's Fig. 18) with the paged MLA decode
``mla_paged_program``, the MLA chunked prefill ``mla_prefill_program`` and
their twins ``mla_paged_quant_program``, ``mla_prefill_quant_program``
(``mla``), the Mamba-2 SSD's ``chunk_state_program`` and
``chunk_scan_program`` (``linear_attention``), the weight-only dequantized
GEMM's ``dequant_matmul_program`` (``dequant_matmul``), the autotuned
``tune_matmul`` (``matmul``), and the attention
core they compose (``attention_core``), each module with its
``PARITY_CASES``; :func:`parity_programs` and :func:`parity_inputs` are
the registry of ``repro.kernels`` (repro/kernels/__init__.py:36-80) over
them."""
from . import (attention_core, dequant_matmul, flash_attention, linear_attention, matmul, mla,
               ops, paged_attention, prefill_attention, ref)
from .dequant_matmul import dequant_matmul_program
from .flash_attention import flash_attention_program
from .linear_attention import chunk_scan_program, chunk_state_program
from .matmul import matmul_program, tune_matmul
from .mla import (mla_paged_program, mla_paged_quant_program, mla_prefill_program,
                  mla_prefill_quant_program, mla_program)
from .paged_attention import paged_attention_program, paged_attention_quant_program
from .prefill_attention import prefill_attention_program, prefill_attention_quant_program

# the modules that declare PARITY_CASES, sorted by name as the JAX
# package's discovery sorts them (the other modules here hold no program)
PARITY_MODULES = (dequant_matmul, flash_attention, linear_attention, matmul, mla,
                  paged_attention, prefill_attention)


def parity_modules():
    """Every module here that declares ``PARITY_CASES``."""
    return list(PARITY_MODULES)


def parity_programs():
    """Yield ``(name, TileProgram)`` for every program at tiny shapes: one
    entry per ``PARITY_CASES`` item of each module."""
    for mod in parity_modules():
        yield from mod.parity_programs()


def parity_inputs(name, program, rng):
    """Inputs for one parity case, or ``None`` for the generic random fill
    (a module whose params carry semantic constraints defines a
    ``parity_inputs(name, program, rng)`` hook: the paged programs' block
    tables must hold valid page ids)."""
    for mod in parity_modules():
        hook = getattr(mod, "parity_inputs", None)
        if hook is not None and name in dict(mod.PARITY_CASES):
            return hook(name, program, rng)
    return None


__all__ = ["ops", "ref", "attention_core", "matmul_program", "flash_attention_program",
           "paged_attention_program", "paged_attention_quant_program",
           "prefill_attention_program", "prefill_attention_quant_program",
           "mla_program", "mla_paged_program", "mla_paged_quant_program", "mla_prefill_program",
           "mla_prefill_quant_program", "dequant_matmul_program", "chunk_state_program",
           "chunk_scan_program", "tune_matmul", "parity_modules", "parity_programs",
           "parity_inputs"]
