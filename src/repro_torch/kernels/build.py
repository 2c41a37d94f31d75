"""Build and load the hand-written CUDA kernels.

Each ``csrc/<source>.cu`` compiles on its own, with ``nvcc`` for
``sm_90a``, into a shared library with a plain C interface that ctypes loads
(no PyTorch headers, so a build takes seconds, not minutes).  One source may
hold several kernels (an fp kernel and its quantized twin share a body), each
an entry point of the same library.  Libraries land in ``_build/`` beside
this file (listed in .gitignore), named by a digest of the sources and
flags, so an edited kernel rebuilds and an unchanged one loads from disk.
A kernel's tile constants may be stated once, in its Python module, and
reach its source as ``-D`` macros (``Kernel(defines=...)``).  Nothing is
built at import: the first launch builds, or a caller builds every kernel
at once, in parallel, with :func:`build_all`.  A kernel may also be
generated text (the tile compiler's CUDA backend, ``core/backends/cuda.py``):
``Kernel(text=...)`` writes it under ``_build/`` at build time and builds it
with the same flags and rules.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().with_name("_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if home:
        candidates.append(str(Path(home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


class Kernel:
    """One hand-written kernel: its source, its C entry point, its ctypes
    signature, and the count of launches its wrapper has made.

    ``launches`` is a plain integer that the wrapper adds one to where it
    launches the kernel, and nowhere else; a caller resets it to 0 before a
    run and reads it after to show the run went through the kernel.  A
    kernel with a tensor-core path beside its CUDA-core one also counts the
    launches that took it in ``tc_launches``; the GQA decodes count the
    launches that took their bulk-copy walk in ``walk_launches``.

    ``defines`` (optional) are macros the source is compiled with, each
    ``-DNAME=value``: constants its wrapper's shape rule reads too, so they
    are stated in one place.  Kernels of one source pass the same ones.

    ``text`` (optional) is a whole generated source in place of a
    ``csrc/`` file; the library is named by a digest of it and the flags.
    """

    def __init__(self, name: str, entry: str, argtypes: Sequence,
                 replaces: str, source: Optional[str] = None,
                 defines: Optional[Dict[str, int]] = None,
                 text: Optional[str] = None):
        self.name = name
        self.entry = entry
        self.argtypes = list(argtypes)
        self.replaces = replaces
        self.launches = 0
        self.tc_launches = 0
        self.walk_launches = 0
        self._stem = source or name
        self.defines = dict(defines or {})
        self.text = text
        self._fn = None

    def _digest(self) -> str:
        h = hashlib.sha256()
        if self.text is not None:
            h.update(self.text.encode())
        else:
            for src in [self.source, *sorted(CSRC.glob("*.cuh"))]:
                h.update(src.read_bytes())
        h.update(" ".join(self.flags()).encode())
        return h.hexdigest()[:16]

    @property
    def source(self) -> Path:
        if self.text is not None:
            return BUILD_DIR / f"{self._stem}_{self._digest()}.cu"
        return CSRC / f"{self._stem}.cu"

    def library_path(self) -> Path:
        return BUILD_DIR / f"lib{self._stem}_{self._digest()}.so"

    def flags(self) -> List[str]:
        return [*NVCC_FLAGS, *(f"-D{k}={v}" for k, v in sorted(self.defines.items()))]

    def build_command(self, out: Path) -> List[str]:
        return [nvcc_path(), *self.flags(), "-o", str(out), str(self.source)]

    def function(self):
        """The ctypes entry point, building the library first if needed."""
        if self._fn is None:
            path = self.library_path()
            if not path.exists():
                build_all([self])
            fn = getattr(ctypes.CDLL(str(path)), self.entry)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        return self._fn


def build_all(kernels: Sequence[Kernel], log: Optional[Dict[str, str]] = None):
    """Compile every kernel whose library is missing, one ``nvcc`` process
    per source, all started together.  Raises with the compiler's output if
    any build fails.  ``log`` (optional) receives each build's compiler
    output (``-Xptxas -v``: registers, shared memory, spills), keyed by
    source file name."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    wanted = set()
    for k in kernels:
        out = k.library_path()
        if out.exists() or out in wanted:  # kernels of one source build once
            continue
        wanted.add(out)
        if k.text is not None:
            k.source.write_text(k.text)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs.append((k, out, tmp, subprocess.Popen(
            k.build_command(tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    failed = []
    for k, out, tmp, p in procs:
        text, _ = p.communicate()
        if log is not None:
            log[k.source.name] = text
        if p.returncode != 0:
            failed.append(f"{k.name} (nvcc exit {p.returncode}):\n{text}")
            continue
        os.replace(tmp, out)  # atomic: a reader never sees half a library
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))


def check(rc: int, name: str):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")
