"""Checkpointing: atomic, versioned, async-capable; the port of
``repro.checkpoint.manager`` with the reference's on-disk layout.

Layout:
    <dir>/step_00000042/
        manifest.json      {step, keys, complete: true}; one entry a leaf:
                           {key, file, shape, dtype}
        000000.npy ...     one file per leaf, in the reference's leaf order

Leaf keys join the path with "/" (dict keys, list indices: "params/embed/
embedding", "opt/step"), and leaves go in the reference's order (dict keys
sorted, list items in order), so either package restores the other's
checkpoints.  numpy has no bfloat16: a bf16 leaf is stored as its raw 16-bit
patterns (uint16) and named "bfloat16" in the manifest.

Atomicity: leaves are written into ``step_X.tmp``, and the directory is
renamed only after the manifest (with ``complete=true``) is flushed; a
crashed writer leaves a ``.tmp`` that restore ignores.  Restart picks the
newest complete manifest (``latest_step``).  Restore places each leaf on the
device and in the dtype of the state it restores into, and on a mesh by
``shardings`` (or a DTensor leaf's own placement).  A DTensor leaf is saved
whole: every rank gathers it, and rank 0 writes it.
"""
from __future__ import annotations

import json
import shutil
import threading
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from ..convert import bits_to_bfloat16, leaf_to_numpy
from ..distributed import sharding as shd


def _flatten_with_paths(tree, path: Tuple[str, ...] = ()) -> List[Tuple[str, Any]]:
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _flatten_with_paths(tree[k], path + (str(k),))]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _flatten_with_paths(v, path + (str(i),))]
    return [("/".join(path), tree)]


def _host_leaf(leaf) -> Tuple[np.ndarray, str]:
    if isinstance(leaf, torch.Tensor):
        return leaf_to_numpy(_whole(leaf))
    a = np.asarray(leaf)
    return a, str(a.dtype)


def _whole(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's whole value (gathered from every rank), else ``t``."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def save(state, step: int, directory: str | Path, keep: Optional[int] = None):
    """Write ``state`` (a tree of tensors, on any device, or numpy arrays) as
    ``directory/step_XXXXXXXX``; keep the newest ``keep`` checkpoints."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f"step_{step:08d}.tmp"
    final = directory / f"step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest: Dict[str, Any] = {"step": step, "keys": [], "complete": False}
    for i, (key, leaf) in enumerate(_flatten_with_paths(state)):
        arr, dtype = _host_leaf(leaf)
        np.save(tmp / f"{i:06d}.npy", arr)
        manifest["keys"].append(
            {"key": key, "file": f"{i:06d}.npy", "shape": list(arr.shape),
             "dtype": dtype}
        )
    manifest["complete"] = True
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)
    if keep:
        steps = sorted(p for p in directory.glob("step_????????") if p.is_dir())
        for p in steps[:-keep]:
            shutil.rmtree(p)
    return final


def latest_step(directory: str | Path) -> Optional[int]:
    directory = Path(directory)
    if not directory.exists():
        return None
    best = None
    for p in sorted(directory.glob("step_????????")):
        man = p / "manifest.json"
        if man.exists():
            try:
                m = json.loads(man.read_text())
                if m.get("complete"):
                    best = m["step"]
            except (json.JSONDecodeError, KeyError):
                continue
    return best


def restore(state_like, step: int, directory: str | Path, shardings=None):
    """Load ``step`` into the structure of ``state_like`` (shapes validated):
    a new tree whose leaves have the device and dtype of ``state_like``'s.
    ``shardings`` (a matching tree of ``distributed.sharding.NamedSharding``)
    places each leaf on its mesh as a DTensor of its spec, as the
    reference's ``device_put`` does; without it, a DTensor leaf of
    ``state_like`` comes back in its own placement."""
    directory = Path(directory) / f"step_{step:08d}"
    manifest = json.loads((directory / "manifest.json").read_text())
    if not manifest.get("complete"):
        raise ValueError(f"checkpoint at {directory} is incomplete")
    by_key = {e["key"]: e for e in manifest["keys"]}

    def load(like, path, sharding):
        if isinstance(like, dict):
            return {k: load(v, path + (str(k),), sharding and sharding[k])
                    for k, v in like.items()}
        if isinstance(like, (list, tuple)):
            return [load(v, path + (str(i),), sharding and sharding[i])
                    for i, v in enumerate(like)]
        key = "/".join(path)
        entry = by_key.get(key)
        if entry is None:
            raise KeyError(f"checkpoint missing leaf {key!r}")
        arr = np.load(directory / entry["file"])
        if tuple(arr.shape) != tuple(like.shape):
            raise ValueError(
                f"{key}: checkpoint shape {arr.shape} != expected {tuple(like.shape)}")
        t = (bits_to_bfloat16(arr) if entry["dtype"] == "bfloat16"
             else torch.from_numpy(np.array(arr)))
        t = t.to(device=like.device, dtype=like.dtype)
        if sharding is not None:
            return shd.place(t, sharding.mesh, sharding.spec)
        if isinstance(like, DTensor):
            return distribute_tensor(t, like.device_mesh, like.placements,
                                     src_data_rank=None)
        return t

    return load(state_like, (), shardings)


def _to_host(tree):
    """An owned host copy of every leaf (bf16 stays bf16)."""
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return _whole(tree.detach()).to("cpu", copy=True)
    return np.array(tree)


class CheckpointManager:
    """Periodic async checkpointing + restart bookkeeping."""

    def __init__(self, directory: str | Path, interval: int = 100,
                 keep: int = 3, async_save: bool = True):
        self.directory = Path(directory)
        self.interval = interval
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None

    def maybe_save(self, state, step: int, force: bool = False):
        if not force and (self.interval <= 0 or step % self.interval != 0):
            return False
        self.wait()  # one in-flight save at a time
        # snapshot to host NOW, so training can update the state in place
        # (every rank gathers its DTensors; rank 0 alone writes)
        host_state = _to_host(state)
        if dist.is_initialized() and dist.get_rank() != 0:
            return True
        if self.async_save:
            self._thread = threading.Thread(
                target=save, args=(host_state, step, self.directory, self.keep),
                daemon=True,
            )
            self._thread.start()
        else:
            save(host_state, step, self.directory, self.keep)
        return True

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def latest(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore(self, state_like, shardings=None, step: Optional[int] = None):
        step = step if step is not None else self.latest()
        if step is None:
            return None
        return restore(state_like, step, self.directory, shardings)
