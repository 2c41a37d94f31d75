"""Meshes: the port of ``repro.launch.mesh`` on ``torch.distributed``.

``MeshSpec`` describes a mesh without a process group (the counterpart of
JAX's ``AbstractMesh``): the sharding rules and the tests read it.
``make_debug_mesh`` and ``make_production_mesh`` build a ``DeviceMesh``
over the ranks of the process group, and are functions (never module
constants), so importing this module opens no group.
"""
from __future__ import annotations

import math
import os
from typing import Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..core.device import resolve_device

DEBUG_AXES = ("data", "model")
SINGLE_POD = ((16, 16), ("data", "model"))
MULTI_POD = ((2, 16, 16), ("pod", "data", "model"))


class MeshSpec:
    """A mesh's axis sizes and names, with ``DeviceMesh``'s accessors
    (``mesh_dim_names``, ``size(dim)``, ``shape``)."""

    def __init__(self, sizes: Tuple[int, ...], names: Tuple[str, ...]):
        if len(sizes) != len(names):
            raise ValueError(f"sizes {sizes} and names {names} differ in length")
        self.sizes, self.mesh_dim_names = tuple(sizes), tuple(names)

    @property
    def shape(self) -> Tuple[int, ...]:
        return self.sizes

    def size(self, dim: int | None = None) -> int:
        return math.prod(self.sizes) if dim is None else self.sizes[dim]

    def __repr__(self):
        return f"MeshSpec({self.sizes}, {self.mesh_dim_names})"


def production_spec(multi_pod: bool = False) -> MeshSpec:
    return MeshSpec(*(MULTI_POD if multi_pod else SINGLE_POD))


def _backend(device: torch.device) -> str:
    if device.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("a mesh on the card needs NCCL, which this "
                               "torch does not have")
        return "nccl"
    return "gloo"


def _mesh(device_type: str, sizes, names) -> DeviceMesh:
    need = math.prod(sizes)
    if dist.get_world_size() == need:
        return init_device_mesh(device_type, tuple(sizes), mesh_dim_names=tuple(names))
    # more ranks than the mesh needs (a single pod on 512): the first ones
    return DeviceMesh(device_type, torch.arange(need).reshape(sizes),
                      mesh_dim_names=tuple(names))


def make_debug_mesh(data: int = 1, model: int = 1, device="cuda") -> DeviceMesh:
    """A (data, model) mesh over the ranks that exist (tests, the CLI's
    ``--mesh debug``): NCCL on the card, gloo on the CPU.  With no process
    group yet, a one-rank group over an in-process store is opened; the
    caller that opened it destroys it (``dist.destroy_process_group``)."""
    dev = resolve_device(device)
    if dev.type == "cuda":  # NCCL's communicator binds the current card
        torch.cuda.set_device(dev.index or 0)
    if not dist.is_initialized():
        dist.init_process_group(_backend(dev), store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if world < data * model:
        raise RuntimeError(f"mesh ({data}, {model}) needs {data * model} ranks, "
                           f"found {world}")
    if dev.type == "cuda" and dist.get_backend() != "nccl":
        raise RuntimeError(f"a mesh on the card needs an NCCL group, found "
                           f"{dist.get_backend()}")
    return _mesh(dev.type, (data, model), DEBUG_AXES)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    """The (16, 16) single-pod or (2, 16, 16) multi-pod mesh.  Needs that
    many ranks: an initialised group (the dry run's fake backend, or
    ``torchrun`` at that world size, whose group this opens)."""
    spec = production_spec(multi_pod)
    need = spec.size()
    world = (dist.get_world_size() if dist.is_initialized()
             else int(os.environ.get("WORLD_SIZE", "1")))
    if world < need:
        raise RuntimeError(
            f"mesh {spec.shape} needs {need} ranks, found world size {world} — "
            f"launch it under torchrun at world size {need}, or model it on "
            "the CPU with the dry run's fake backend "
            "(python -m repro_torch.launch.dryrun)."
        )
    if not dist.is_initialized():
        dist.init_process_group(_backend(resolve_device(device_type)),
                                init_method="env://")
    return _mesh(device_type, spec.shape, spec.mesh_dim_names)
