"""The port's dry run (``repro_torch.launch.dryrun``) on the fake backend:
reduced qwen2 (dense), granite (GQA + MoE) and mamba2 (SSD) on a (2, 2)
mesh of 4 fake ranks, for train, prefill and decode: every cell runs, its
FLOPs a rank over the ranks cover the model's, and its state a rank is
what the JAX package's specs give on the same mesh; the report's tables.
The three cells that ended in error at full size (whisper's decode and
prefill, deepseek-v2-lite's decode) run on the production single-pod mesh
of 256 fake ranks."""
import dataclasses
import math

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P

from repro.configs import get_config as jget_config
from repro.distributed import sharding as rshd
from repro.launch import cells as RC
from repro_torch.configs import get_config
from repro_torch.launch import cells as C
from repro_torch.launch import dryrun as D
from repro_torch.roofline import report

ARCHS = ("qwen2_1_5b", "granite_moe_3b_a800m", "mamba2_2_7b")
KINDS = ("train_4k", "prefill_32k", "decode_32k")
SEQ, BATCH = 64, 4


def cell_of(shape):
    return dataclasses.replace(C.SHAPES[shape], seq=SEQ, batch=BATCH)


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    """Every cell's record, run once on one fake group of 4 ranks, which
    is destroyed afterwards."""
    from torch.distributed.device_mesh import init_device_mesh

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    out = tmp_path_factory.mktemp("dryrun")
    D.open_fake_group(4)
    try:
        mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
        recs = {(a, s): D.run_cell(a, s, "debug22", force=True, cfg=get_config(a).reduced(),
                                   cell=cell_of(s), mesh=mesh, out_dir=out)
                for a in ARCHS for s in KINDS}
        recs["long"] = D.run_cell("qwen2_1_5b", "long_500k", "debug22", force=True,
                                  cfg=get_config("qwen2_1_5b").reduced(),
                                  mesh=mesh, out_dir=out)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
    return recs, out


def _ref_local_bytes(shapes, specs, mesh) -> int:
    """Bytes a rank holds of a reference tree under its specs."""
    flat_shapes = jax.tree.leaves(shapes)
    flat_specs = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(flat_shapes, flat_specs):
        spec = tuple(spec) + (None,) * (len(leaf.shape) - len(tuple(spec)))
        n = 1
        for dim, ax in zip(leaf.shape, spec):
            names = () if ax is None else (ax if isinstance(ax, tuple) else (ax,))
            n *= dim // math.prod(mesh.shape[a] for a in names)
        total += n * leaf.dtype.itemsize
    return total


def _ref_state_bytes(arch, shape) -> int:
    mesh = AbstractMesh((2, 2), ("data", "model"))
    jcfg = jget_config(arch).reduced()
    cell = cell_of(shape)
    jcell = RC.Cell(cell.name, cell.kind, cell.seq, cell.batch)
    if cell.kind == "train":
        st = RC.train_state_shapes(jcfg)
        ps = rshd.param_specs(st["params"], jcfg, mesh)
        return _ref_local_bytes(st, {"params": ps, "opt": rshd.zero1_specs(st["opt"], ps, mesh)},
                                mesh)
    p = RC.params_shapes(jcfg)
    total = _ref_local_bytes(p, rshd.param_specs(p, jcfg, mesh), mesh)
    if cell.kind == "decode":
        cache = RC.cache_shapes(jcfg, jcell.batch, jcell.seq)
        total += _ref_local_bytes(cache, RC.cache_specs(jcfg, cache, mesh, jcell.batch), mesh)
    return total


@pytest.mark.parametrize("shape", KINDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_cell_runs_and_covers_the_model(records, arch, shape):
    rec = records[0][(arch, shape)]
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 4 and rec["mesh_shape"] == {"data": 2, "model": 2}
    assert "fake backend" in rec["device"]
    cfg, cell = get_config(arch).reduced(), cell_of(shape)
    need = rec["model_flops"]
    if cell.kind == "prefill":
        # the step unembeds the last position only, and the counter counts
        # products, not the SSM's elementwise conv (0.4% of mamba2's here)
        need -= 2.0 * cfg.vocab_size * cfg.d_model * cell.batch * (cell.seq - 1)
        need *= 0.99
    assert rec["flops"] * rec["chips"] >= need > 0
    assert rec["state_bytes"] == _ref_state_bytes(arch, shape)
    assert rec["peak_bytes"] >= rec["state_bytes"] and rec["fits_80gb"]
    moved = sum(rec["collective_bytes"].values())
    assert moved > 0 and set(rec["collective_bytes"]) == set(rec["collective_counts"])


def test_unsupported_cell_is_skipped_with_the_references_reason(records):
    rec = records[0]["long"]
    jcfg = jget_config("qwen2_1_5b").reduced()
    assert rec["status"] == "skipped"
    assert rec["reason"] == RC.supported(jcfg, RC.SHAPES["long_500k"])[1]


def test_report_tables_read_the_records(records):
    recs, out = records
    for arch in ARCHS:
        for shape in KINDS:
            (out / f"{arch}__{shape}__single_pod.json").write_text(
                (out / f"{arch}__{shape}__debug22.json").read_text())
    table = report.dryrun_table("single_pod", out)
    assert table.count("| ok |") == len(ARCHS) * len(KINDS)
    roof = report.roofline_table("single_pod", out)
    assert roof.count("\n") == 1 + len(ARCHS) * len(KINDS)
    picks = report.pick_hillclimb("single_pod", out)
    assert len(picks) == 3 and picks[0].shape == "train_4k"
    t = report.terms_of(recs[("qwen2_1_5b", "train_4k")])
    assert t.flops > 0 and t.analytic_bytes > 0 and t.link_bw == 450e9


# the three cells that ended in error before their placements were repaired:
# whisper's 6 heads and 1500 frames over `model` 16, deepseek's latent strips
REPAIRED = [("whisper_tiny", "decode_32k"), ("whisper_tiny", "prefill_32k"),
            ("deepseek_v2_lite_16b", "decode_32k")]


@pytest.mark.parametrize("arch,shape", REPAIRED, ids=["-".join(c) for c in REPAIRED])
def test_repaired_single_pod_cell_runs_at_full_size(tmp_path, arch, shape):
    """The named config and cell on the production single-pod mesh (a fake
    group of 256 ranks): the step runs, and a rank's peak fits 80 GB."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    D.open_fake_group(256)
    try:
        rec = D.run_cell(arch, shape, "single_pod", force=True, out_dir=tmp_path)
    finally:
        dist.destroy_process_group()
        torch.set_num_threads(threads)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["chips"] == 256 and rec["fits_80gb"]
    assert rec["flops"] > 0 and rec["peak_bytes"] >= rec["state_bytes"] > 0
