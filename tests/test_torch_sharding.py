"""The port's sharding rules (``repro_torch.distributed.sharding``,
``repro_torch.launch.cells``) against the JAX package's, leaf by leaf: the
parameter, ZeRO-1, cache and data specs of all 10 archs at full width on the
production meshes (16, 16) and (2, 16, 16), described without devices
(the reference's ``AbstractMesh``, the port's ``MeshSpec``); the hints'
choices (heads, sequence or none; EP or capacity); the supported matrix.
Shapes only: no process group, no device."""
import types

import jax
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.distributed import sharding as rshd
from repro.launch import cells as RC
from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import cells as C
from repro_torch.launch.mesh import MeshSpec
from repro_torch.models import lm

MESHES = {"single_pod": ((16, 16), ("data", "model")),
          "multi_pod": ((2, 16, 16), ("pod", "data", "model"))}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def meshes(name):
    sizes, names = MESHES[name]
    try:
        ref = AbstractMesh(sizes, names)
    except TypeError:  # older JAX: AbstractMesh(((name, size), ...))
        ref = AbstractMesh(tuple(zip(names, sizes)))
    return ref, MeshSpec(sizes, names)


def ref_leaves(tree):
    """{"a/b/0": spec} of a reference tree of PartitionSpecs."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree, is_leaf=lambda x: isinstance(x, P))
    return {rshd._path_str(path): tuple(spec) for path, spec in flat}


def port_leaves(tree):
    return {k: tuple(v) for k, v in shd.spec_leaves(tree).items()}


def test_archs_are_the_references():
    assert list(ARCHS) == list(JARCHS)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_zero1_specs_equal_the_references(arch, mesh):
    ref_mesh, port_mesh = meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    jstate = RC.train_state_shapes(jcfg)
    state = C.train_state_shapes(cfg)
    jp = rshd.param_specs(jstate["params"], jcfg, ref_mesh)
    pp = shd.param_specs(state["params"], cfg, port_mesh)
    assert port_leaves(pp) == ref_leaves(jp)
    jz = rshd.zero1_specs(jstate["opt"], jp, ref_mesh)
    pz = shd.zero1_specs(state["opt"], pp, port_mesh)
    assert port_leaves(pz) == ref_leaves(jz)
    # the shapes the rules read are the reference's, leaf by leaf
    jshapes = {rshd._path_str(p): tuple(x.shape) for p, x in
               jax.tree_util.tree_flatten_with_path(jstate["params"])[0]}
    shapes = {k: tuple(v.shape) for k, v in shd.spec_leaves(state["params"]).items()}
    assert shapes == jshapes


def _ref_cache_by_layer(cfg, tree_specs, tree_shapes):
    """The reference's cache specs as {(leaf, layer): trailing spec}: its
    Cache holds per-layer dicts (prefix) and stacked or per-layer ones."""
    specs = jax.tree_util.tree_flatten_with_path(tree_specs, is_leaf=lambda x: isinstance(x, P))[0]
    shapes = jax.tree.leaves(tree_shapes)
    out = {}
    n_prefix = len(tree_shapes.prefix)
    for (path, spec), shape in zip(specs, shapes):
        keys = [str(getattr(k, "key", getattr(k, "idx", ""))) for k in path]
        part, name = int(keys[0]), keys[-1]
        spec = tuple(spec)
        if part == 0:  # prefix[i]
            out[(name, int(keys[1]))] = spec
        elif tree_shapes.stacked:  # rest, stacked over its layers
            for i in range(shape.shape[0]):
                out[(name, n_prefix + i)] = spec[1:]
        else:  # rest[i]
            out[(name, n_prefix + int(keys[1]))] = spec
    return out


def _port_cache_by_layer(cfg, specs):
    out = {}
    for path, spec in shd.spec_leaves(specs).items():
        keys = path.split("/")
        if len(keys) == 2:  # a list of one strip a layer
            out[(keys[0], int(keys[1]))] = tuple(spec)
        else:  # stacked over every layer
            for i in range(cfg.num_layers):
                out[(keys[0], i)] = tuple(spec)[1:]
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_equal_the_references(arch, mesh):
    ref_mesh, port_mesh = meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    cell = C.SHAPES["decode_32k"]
    jshapes = RC.cache_shapes(jcfg, cell.batch, cell.seq)
    jspecs = RC.cache_specs(jcfg, jshapes, ref_mesh, cell.batch)
    cache = C.cache_shapes(cfg, cell.batch, cell.seq)
    specs = C.cache_specs(cfg, cache, port_mesh, cell.batch)
    if cfg.is_encoder_decoder:
        assert port_leaves(specs) == ref_leaves(jspecs)
        return
    assert isinstance(cache, lm.Cache)
    # the port keeps the SSM's conv window as "conv" beside "ssm"
    got = _port_cache_by_layer(cfg, specs)
    want = _ref_cache_by_layer(cfg, jspecs, jshapes)
    assert got == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_data_specs_and_supported_equal_the_references(arch, mesh):
    ref_mesh, port_mesh = meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    for name, cell in C.SHAPES.items():
        jcell = RC.SHAPES[name]
        assert (cell.kind, cell.seq, cell.batch) == (jcell.kind, jcell.seq, jcell.batch)
        got = {k: tuple(v) for k, v in C.data_specs(cfg, cell, port_mesh).items()}
        want = {k: tuple(v) for k, v in RC.data_specs(jcfg, jcell, ref_mesh).items()}
        assert got == want, name
        assert C.supported(cfg, cell) == RC.supported(jcfg, jcell)
        jin = RC.input_specs(jcfg, jcell)
        assert {k: v.shape for k, v in C.input_specs(cfg, cell).items()} == \
            {k: tuple(v.shape) for k, v in jin.items()}


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("batch,seq", [(256, 4096), (256, 1000), (32, 32768), (1, 524288),
                                       (128, 1), (24, 4096), (16, 48)])
def test_batch_tokens_and_residual_specs_equal_the_references(mesh, batch, seq):
    ref_mesh, port_mesh = meshes(mesh)
    assert tuple(shd.batch_spec(port_mesh, batch)) == tuple(rshd.batch_spec(ref_mesh, batch))
    assert tuple(shd.tokens_spec(port_mesh, batch, 2)) == \
        tuple(rshd.tokens_spec(ref_mesh, batch, 2))
    assert tuple(shd.residual_spec(port_mesh, batch, seq)) == \
        tuple(rshd.residual_spec(ref_mesh, batch, seq))


def _ref_choice(hook, shape):
    """The spec a reference hook constrains a tensor of ``shape`` to (its
    ``constrain`` recorded), or None."""
    x = types.SimpleNamespace(shape=shape)
    out = hook(x)
    return None if out is x else tuple(out)


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_hint_choices_equal_the_references(arch, mesh, monkeypatch):
    """Heads or the sequence fallback (or nothing) for attention, EP or the
    capacity groups for the MoE, and at the reference's opt_level 1 the
    block outputs' and attention inputs' specs."""
    monkeypatch.setattr(rshd, "constrain", lambda x, mesh, spec: spec)
    ref_mesh, port_mesh = meshes(mesh)
    jcfg, cfg = jget_config(arch), get_config(arch)
    checked = 0
    for name, cell in C.SHAPES.items():
        jhooks = RC.make_hints(jcfg, ref_mesh, RC.SHAPES[name], opt_level=1)
        hooks = C.make_hints(cfg, port_mesh, cell)
        shapes = {
            "attn_q": (cell.batch, cfg.num_heads, cell.seq, cfg.head_dim),
            "attn_kv": (cell.batch, cfg.num_kv_heads, cell.seq, cfg.head_dim),
            "block_out": (cell.batch, cell.seq, cfg.d_model),
            "attn_in": (cell.batch, cell.seq, cfg.d_model),
        }
        if cfg.moe:
            for e in (cfg.moe.num_experts, 16, 48):
                shapes[f"moe_expert/{e}"] = (16, e, 64, cfg.d_model)
        for key, shape in shapes.items():
            hook = key.split("/")[0]
            assert (hook in jhooks) <= (hook in hooks), hook
            if hook not in jhooks:
                continue
            got = hooks[hook].spec_of(shape)
            assert (None if got is None else tuple(got)) == _ref_choice(jhooks[hook], shape), \
                (name, key)
            checked += 1
    assert checked >= (8 if cfg.attends else 4)


@pytest.mark.parametrize("mesh", MESHES)
def test_placements_follow_the_spec(mesh):
    _, port_mesh = meshes(mesh)
    from torch.distributed.tensor import Replicate, Shard

    names = port_mesh.mesh_dim_names
    got = shd.to_placements(shd.batch_spec(port_mesh, 256) + (None, "model"), port_mesh)
    want = {"pod": Shard(0), "data": Shard(0), "model": Shard(2)}
    assert got == tuple(want[n] for n in names)
    assert shd.to_placements(shd.Spec(None, None), port_mesh) == (Replicate(),) * len(names)
    assert shd.axes_size(port_mesh, ("pod", "data")) == (32 if mesh == "multi_pod" else 16)
