"""The port's roofline (``repro_torch.roofline``) against the JAX package's:
the attention and model FLOPs, the chunked-attention correction and the
analytic HBM bytes to rel 1e-12 for every arch and shape; the three terms
with the H100's constants; ``kernel_bound`` against PERF.md §6's bound
column; the collective tally on the fake backend."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro.configs import get_config as jget_config
from repro.launch.cells import SHAPES as JSHAPES
from repro.roofline import analysis as janalysis
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch.cells import SHAPES
from repro_torch.roofline import analysis as A

REL = 1e-12
MESH_SHAPES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
               {"data": 1, "model": 1})


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_flops_and_bytes_equal_the_references(arch, shape):
    cfg, jcfg = get_config(arch), jget_config(arch)
    cell, jcell = SHAPES[shape], JSHAPES[shape]
    for passes in (1, 3):
        assert A.attention_flops(cfg, cell, passes) == pytest.approx(
            janalysis.attention_flops(jcfg, jcell, passes), rel=REL, abs=0)
    assert A.model_flops(cfg, cell) == pytest.approx(
        janalysis.model_flops(jcfg, jcell), rel=REL, abs=0)
    for chips in (1, 256, 512):
        assert A.chunked_attention_correction(cfg, cell, chips) == pytest.approx(
            janalysis.chunked_attention_correction(jcfg, jcell, chips), rel=REL, abs=0)
    for mesh in MESH_SHAPES:
        for flash in (False, True):
            assert A.analytic_hbm_bytes(cfg, cell, mesh, flash_attention=flash) == \
                pytest.approx(janalysis.analytic_hbm_bytes(jcfg, jcell, mesh,
                                                           flash_attention=flash),
                              rel=REL, abs=0)


def test_chunk_constants_are_the_ports_own():
    from repro_torch.kernels import ref

    assert (A.CHUNKED_THRESHOLD, A.Q_CHUNK) == (ref.CHUNKED_THRESHOLD, ref.Q_CHUNK)
    cfg = get_config("gemma_7b")
    assert A.chunked_attention_correction(cfg, SHAPES["train_4k"], 256) == 0
    assert A.chunked_attention_correction(cfg, SHAPES["prefill_32k"], 256) > 0


def test_terms_follow_the_h100_constants():
    hw = A.HW_H100
    assert (hw["peak_flops_bf16"], hw["peak_ops_int8"], hw["peak_flops_fp32"]) == \
        (989e12, 1979e12, 67e12)
    assert (hw["hbm_bw"], hw["hbm_bytes"], hw["nvlink_bw"], hw["ib_bw"]) == \
        (3.35e12, 80e9, 450e9, 50e9)
    t = A.RooflineTerms(
        arch="x", shape="y", mesh="m", flops=989e12, hbm_bytes=3.35e12 * 3,
        coll_bytes=450e9 * 0.5, coll_breakdown={}, model_flops=989e12 * 128, chips=256)
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(3.0) and t.memory_ub_s == pytest.approx(3.0)
    assert t.collective_s == pytest.approx(0.5)
    assert t.dominant == "memory" and t.step_s == pytest.approx(3.0)
    assert t.useful_fraction == pytest.approx(0.5)
    assert t.mfu == pytest.approx(128 / (3.0 * 256))
    t = dataclasses.replace(t, analytic_bytes=3.35e12, link_bw=A.link_bw(256))
    assert t.memory_s == pytest.approx(1.0) and t.memory_ub_s == pytest.approx(3.0)
    assert t.collective_s == pytest.approx(450e9 * 0.5 / 50e9)
    assert A.link_bw(8) == 450e9 and A.link_bw(9) == 50e9
    assert set(t.row()) >= {"compute_s", "memory_s", "collective_s", "dominant", "mfu_at_roofline"}
    assert A.measured_mfu(989e12, 2.0, chips=1) == pytest.approx(0.5)


def _decode_bytes():
    """Row 1 at qwen2-1.5B's serving shape, as chip_smoke.check_decode
    counts it: q and the output once, the live K/V rows, the lengths and
    the live table entries (bf16; chip_smoke.decode_inputs' seeded lengths)."""
    slots, max_len, page, hq, hkv, d, isz = 8, 1024, 16, 12, 2, 128, 2
    rng = np.random.default_rng(1)
    rng.permutation(slots * max_len // page)
    lens = rng.integers(1, max_len + 1, size=slots).astype("int32")
    lens[2], lens[5] = 0, max_len
    live = int(lens.sum())
    return (slots * hq * d * isz * 2 + 2 * hkv * live * d * isz + slots * 4
            + sum(-(-int(n) // page) for n in lens) * 4), 4.0 * hq * d * live


@pytest.mark.parametrize("row,args,want", [
    ("1, qwen2-1.5B serving", _decode_bytes() + (A.HW_H100["peak_flops_bf16"],),
     ("0.0012", "bytes")),
    ("13, M7 bf16", ((8192 * 28672 + 28672 * 8192 + 8192 * 8192) * 2,
                     2.0 * 8192 * 8192 * 28672, A.HW_H100["peak_flops_bf16"]),
     ("3.8911", "operations")),
    ("14, (8, 16384, 16384) int4 x fp16", (8 * 16384 * 2 + 16384 * 16384 // 2 + 8 * 16384 * 2,
                                           2.0 * 8 * 16384 * 16384,
                                           A.HW_H100["peak_flops_bf16"]),
     ("0.0402", "bytes")),
])
def test_kernel_bound_reproduces_perf_md(row, args, want):
    ms, by = A.kernel_bound(*args)
    assert (f"{ms:.4f}", by) == want, row


@pytest.fixture
def fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    yield
    dist.destroy_process_group()


def test_collective_tally_reads_the_references_units(fake_group):
    """An all-gather counts the gathered tensor, a reduce-scatter the
    shard, an all-reduce the reduced tensor; a send its tensor."""
    from torch.distributed.device_mesh import init_device_mesh

    mesh = init_device_mesh("cpu", (4,), mesh_dim_names=("model",))
    shard = DTensor.from_local(torch.ones(2, 8), mesh, [Shard(0)])
    part = DTensor.from_local(torch.ones(8, 8, dtype=torch.bfloat16), mesh, [Partial()])
    with A.CollectiveTally() as tally:
        shard.redistribute(mesh, [Replicate()])
        part.redistribute(mesh, [Replicate()])
        part.redistribute(mesh, [Shard(0)])
        dist.send(torch.ones(5), dst=1)
    assert tally.bytes == {"all-gather": 8 * 8 * 4, "all-reduce": 8 * 8 * 2,
                           "reduce-scatter": 2 * 8 * 2, "all-to-all": 0,
                           "collective-permute": 5 * 4}
    assert tally.counts == {"all-gather": 1, "all-reduce": 1, "reduce-scatter": 1,
                            "all-to-all": 0, "collective-permute": 1}
    assert tally.total == sum(tally.bytes.values())
