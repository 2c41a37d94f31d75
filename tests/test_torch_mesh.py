"""The port's multi-rank paths on gloo processes on the CPU (NCCL refuses two
ranks on one card): the GPipe pipeline on 4 ranks against the JAX package's
sequential stack; the sharded training step at (data, model) = (2, 1) and
(1, 2) against one process's, on a reduced qwen2 whose 3 q heads do not
divide 2 (the sequence fallback and its causal cut); a reduced whisper whose
3 heads and 7 encoder frames do not divide `model` 2 (prefill, cross K/V and
decode steps on sequence-sharded strips) and reduced deepseek-v2-lite's
decode on latent strips sharded over `model` against one process; a
checkpoint restored
onto a mesh (``restore(shardings=)``) and a state re-placed from data 1 to
data 2 (``elastic_remesh``), every leaf byte for byte; the training CLI's
1x1 mesh against the step without one, byte for byte; the meshes' refusals.
Each test that opens a process group destroys it."""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.distributed import pipeline
from repro_torch.distributed import sharding as shd
from repro_torch.distributed.fault import elastic_remesh
from repro_torch.launch import train
from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
from repro_torch.optim import AdamWConfig
from repro_torch.roofline.analysis import HW_H100, kernel_bound

STEPS, BATCH, SEQ = 2, 4, 16
TOL = 1e-5


def small_cfg():
    """Reduced qwen2 with 3 q heads over 1 kv head: 3 do not divide 2."""
    return dataclasses.replace(get_config("qwen2_1_5b").reduced(), num_heads=3,
                               num_kv_heads=1)


# the dense family on its sequence fallback, GQA + MoE (the routing and the
# capacity dispatch through local_map) and the SSD
CONFIGS = {"qwen2, 3 heads": small_cfg,
           "granite": lambda: get_config("granite_moe_3b_a800m").reduced(),
           "mamba2": lambda: get_config("mamba2_2_7b").reduced()}


def whisper_cfg():
    """Reduced whisper with 3 heads and 7 frames: neither divides 2."""
    return dataclasses.replace(get_config("whisper_tiny").reduced(), num_heads=3,
                               num_kv_heads=3, frontend_seq=7)


W_BATCH, W_SEQ, W_CACHE, W_STEPS = 2, 6, 8, 3


def whisper_run(cfg, mesh=None):
    """Last-position prefill logits, then W_STEPS decode steps' logits and
    the written self-attention strips, on ``mesh`` (the port's cells: hints,
    ``cache_specs``) or in one process."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch import cells
    from repro_torch.models import encdec
    from repro_torch.models import layers as L

    params = encdec.init(cfg, 0, device="cpu")
    g = np.random.default_rng(0)
    frames = torch.from_numpy(
        g.standard_normal((W_BATCH, cfg.frontend_seq, cfg.d_model)).astype(np.float32))
    tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, (W_BATCH, W_SEQ)).astype(np.int32))
    enc = encdec.encode(params, cfg, frames)
    cache = encdec.init_cache(cfg, W_BATCH, W_CACHE, device="cpu")
    if mesh is None:
        x = encdec.decode_hidden(params, cfg, tokens, enc)
        prefill = L.unembed(params["embed"], x[:, -1:], cfg)[:, 0].float()
        cross = encdec.cross_kv(params, cfg, enc)
        logits = [encdec.decode_step(params, cfg, cache, tokens[:, i], i, cross)[0]
                  for i in range(W_STEPS)]
    else:
        params = shd.place_tree(params, shd.named(mesh, shd.param_specs(params, cfg, mesh)))
        prefill = cells.make_prefill_step(cfg, mesh, cells.Cell("p", "prefill", W_SEQ, W_BATCH))(
            params, {"frames": frames, "tokens": tokens})
        cache = shd.place_tree(cache, shd.named(mesh, cells.cache_specs(cfg, cache, mesh,
                                                                         W_BATCH)))
        enc = shd.place(enc, mesh, shd.Spec(*shd.batch_spec(mesh, W_BATCH), None, None))
        with implicit_replication():
            cross = encdec.cross_kv(params, cfg, enc)
        step = cells.make_serve_step(cfg, mesh, cells.Cell("d", "decode", W_CACHE, W_BATCH))
        logits = [step(params, cache, cross, tokens[:, i], torch.tensor(i, dtype=torch.int32))[0]
                  for i in range(W_STEPS)]
    return {"prefill": _numpy(prefill), "logits": np.stack([_numpy(t) for t in logits]),
            **{f"cache/{k}": _numpy(v) for k, v in cache["self"].items()}}


def mla_decode_run(mesh=None):
    """W_STEPS decode steps of reduced deepseek-v2-lite (MLA + MoE) over the
    contiguous latent strips, whose latent width ``cache_specs`` shards over
    `model`: the logits and the written strips, on ``mesh`` or in one
    process."""
    from repro_torch.launch import cells
    from repro_torch.models import lm

    cfg = get_config("deepseek_v2_lite_16b").reduced()
    params = lm.init(cfg, 0, device="cpu")
    cache = lm.init_cache(cfg, W_BATCH, W_CACHE, layout="contiguous", device="cpu")
    g = np.random.default_rng(2)
    tokens = torch.from_numpy(g.integers(0, cfg.vocab_size, (W_BATCH, W_STEPS)).astype(np.int32))
    if mesh is None:
        logits = [lm.decode_step(params, cfg, cache, tokens[:, i],
                                 torch.full((W_BATCH,), i, dtype=torch.int32))[0]
                  for i in range(W_STEPS)]
    else:
        params = shd.place_tree(params, shd.named(mesh, shd.param_specs(params, cfg, mesh)))
        cache.kv = shd.place_tree(cache.kv, shd.named(mesh, cells.cache_specs(
            cfg, cache, mesh, W_BATCH)))
        step = cells.make_serve_step(cfg, mesh, cells.Cell("d", "decode", W_CACHE, W_BATCH))
        logits = [step(params, cache, tokens[:, i], torch.tensor(i, dtype=torch.int32))[0]
                  for i in range(W_STEPS)]
    return {"logits": np.stack([_numpy(t) for t in logits]),
            **{k: _numpy(v) for k, v in _flat(cache.kv).items()}}


def single_process(cfg):
    state = train.build_state(cfg, 0, "cpu")
    step = train.make_train_step(cfg, adamw(), logits_chunk=0)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, data().batch_at(i))
        metrics.append((m["loss"].item(), m["grad_norm"].item()))
    return metrics, {k: v.numpy() for k, v in _flat(state).items()}


def adamw():
    return AdamWConfig(warmup_steps=1, total_steps=4)


def data():
    return SyntheticTokens(DataConfig(batch=BATCH, seq=SEQ, vocab_size=256, seed=0))


def _flat(tree):
    return shd.spec_leaves(tree)


def _numpy(t):
    t = t.full_tensor() if isinstance(t, shd.DTensor) else t
    return t.detach().cpu().numpy()


def _mesh_worker(rank, world, port, ckpt_dir, host_state, queue):
    """Rank ``rank`` of 2: each config's training step at (2, 1) and (1, 2), the
    checkpoint restored onto the (2, 1) mesh, and the data-1 state
    re-placed on it."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import cells

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        out = {}
        cell = cells.Cell("t", "train", SEQ, BATCH)
        for name, make_cfg in CONFIGS.items():
            cfg = make_cfg()
            for shape in ((2, 1), (1, 2)):
                mesh = DeviceMesh("cpu", torch.arange(2).reshape(shape),
                                  mesh_dim_names=("data", "model"))
                state = train.build_state(cfg, 0, "cpu")
                shardings = shd.named(mesh, train.state_specs(cfg, mesh, state))
                state = shd.place_tree(state, shardings)
                step = cells.make_train_step(cfg, mesh, cell, adamw(), logits_chunk=0)
                metrics = []
                for i in range(STEPS):
                    state, m = step(state, data().batch_at(i))
                    metrics.append((m["loss"].item(), m["grad_norm"].item()))
                out[name, shape] = (metrics, {k: _numpy(v) for k, v in _flat(state).items()})
        model2 = DeviceMesh("cpu", torch.arange(2).reshape(1, 2),
                            mesh_dim_names=("data", "model"))
        out["whisper"] = whisper_run(whisper_cfg(), model2)
        out["mla decode"] = mla_decode_run(model2)
        cfg = small_cfg()
        # the checkpoint back onto the data-2 mesh, and the host state re-placed
        mesh = DeviceMesh("cpu", torch.arange(2).reshape(2, 1),
                          mesh_dim_names=("data", "model"))
        like = train.build_state(cfg, 0, "cpu")
        specs = train.state_specs(cfg, mesh, like)
        restored = checkpoint.restore(like, 0, ckpt_dir, shardings=shd.named(mesh, specs))
        remeshed = elastic_remesh(host_state, mesh, specs)
        for name, tree in (("restored", restored), ("remeshed", remeshed)):
            leaves_ = _flat(tree)
            out[name] = ({k: _numpy(v) for k, v in leaves_.items()},
                         {k: tuple(v.to_local().shape) for k, v in leaves_.items()})
        if rank == 0:
            queue.put(out)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One spawn of 2 gloo ranks; the step of one process and the
    checkpoint it restores are made here, beside them."""
    import torch.multiprocessing as mp

    ckpt_dir = tmp_path_factory.mktemp("ckpt")
    cfg = small_cfg()
    state = train.build_state(cfg, 0, "cpu")
    checkpoint.save(state, 0, ckpt_dir)
    host_np = shd.tree_map_with_path(lambda _, t: t.numpy().copy(), state)
    singles = {name: single_process(make_cfg()) for name, make_cfg in CONFIGS.items()}
    singles["whisper"] = whisper_run(whisper_cfg())
    singles["mla decode"] = mla_decode_run()
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = pipeline.free_port()
    procs = [ctx.Process(target=_mesh_worker, args=(r, 2, port, str(ckpt_dir), host_np, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        out = queue.get(timeout=240)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
    assert all(p.exitcode == 0 for p in procs)
    return out, singles, {k: v.numpy() for k, v in _flat(state).items()}


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)], ids=["data2", "model2"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sharded_training_step_equals_one_process(two_ranks, name, shape):
    out, singles, _ = two_ranks
    metrics, single = singles[name]
    got_metrics, got = out[name, shape]
    np.testing.assert_allclose(got_metrics, metrics, rtol=TOL, atol=0)
    assert got.keys() == single.keys() and len(got) > 20
    for k in single:
        np.testing.assert_allclose(got[k], single[k], rtol=TOL, atol=TOL, err_msg=k)


def test_whisper_heads_not_dividing_model_equal_one_process(two_ranks):
    """3 heads and 7 frames over `model` 2: the cross K/V's heads gathered
    before their view, the frames left whole, the decode strips written and
    scored on their sequence shards; values within 1e-5 of one process."""
    out, singles, _ = two_ranks
    got, want = out["whisper"], singles["whisper"]
    assert got.keys() == want.keys() and want["logits"].shape[0] == W_STEPS
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    assert np.abs(want["cache/k"][:, :, :, :W_STEPS]).min() > 0  # the steps wrote


def test_mla_decode_on_latent_strips_sharded_over_model_equals_one_process(two_ranks):
    """The latent strips' in-place write on each rank's shard of the latent
    width (``layers._write_latent``), then the scores summed over the shards
    before the softmax: logits and strips within 1e-5 of one process."""
    out, singles, _ = two_ranks
    got, want = out["mla decode"], singles["mla decode"]
    assert got.keys() == want.keys() and any(k.startswith("c_kv") for k in want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=TOL, atol=TOL, err_msg=k)
    ckv = next(v for k, v in want.items() if k.startswith("c_kv"))
    assert np.abs(ckv[:, :W_STEPS]).min() > 0  # the steps wrote


@pytest.mark.parametrize("how", ["restored", "remeshed"])
def test_state_placed_on_a_data_2_mesh_reads_back_byte_for_byte(two_ranks, how):
    out, _, saved = two_ranks
    values, local = out[how]
    assert values.keys() == saved.keys()
    for k in saved:
        assert np.array_equal(values[k], saved[k]), k
    # ZeRO-1 shards the fp32 state over the 2 ranks of `data`
    master = "opt/master/layers/mlp/w_up"
    assert local[master][0] * 2 == saved[master].shape[0] or \
        local[master][1] * 2 == saved[master].shape[1]


def test_pipeline_on_4_gloo_ranks_equals_the_references_sequential_stack():
    import jax.numpy as jnp

    w, x = pipeline.smoke_inputs()
    out = pipeline.run_on_gloo(w, x)
    ref = jnp.asarray(x)
    for i in range(w.shape[0]):
        ref = jnp.tanh(ref @ jnp.asarray(w[i]))
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=1e-5)
    assert pipeline.bubble_fraction(6, 4) == pytest.approx(3 / 9)
    assert pipeline.bubble_fraction(64, 2) < 0.02


def test_train_cli_mesh_equals_the_step_without_a_mesh(tmp_path, capsys):
    cfg = get_config("qwen2_1_5b").reduced()
    res = train.main(["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu",
                      "--steps", "3", "--batch", "2", "--seq", "16", "--mesh", "debug",
                      "--ckpt-dir", str(tmp_path)])
    assert not dist.is_initialized()  # the CLI closed the group it opened
    state = train.build_state(cfg, 0, "cpu")
    step = train.make_train_step(cfg, AdamWConfig(peak_lr=3e-3, warmup_steps=1,
                                                  total_steps=3))
    ds = SyntheticTokens(DataConfig(batch=2, seq=16, vocab_size=cfg.vocab_size, seed=0))
    for i in range(3):
        state, m = step(state, ds.batch_at(i))
    got = _flat(res["state"])
    for k, v in _flat(state).items():
        assert isinstance(got[k], shd.DTensor)
        assert torch.equal(got[k].full_tensor(), v), k
    assert torch.equal(res["last_metrics"]["loss"], m["loss"])
    assert "kernel launches on cpu: none" in capsys.readouterr().out


def test_meshes_refuse_what_they_cannot_build(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    for multi, n in ((False, 256), (True, 512)):
        with pytest.raises(RuntimeError, match=f"needs {n} ranks, found world size 1"):
            make_production_mesh(multi_pod=multi)
    assert not dist.is_initialized()
    try:
        mesh = make_debug_mesh(device="cpu")
        assert dist.get_backend() == "gloo" and dist.get_world_size() == 1
        assert mesh.mesh_dim_names == ("data", "model") and tuple(mesh.shape) == (1, 1)
        with pytest.raises(RuntimeError, match="needs 2 ranks, found 1"):
            make_debug_mesh(2, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_chip_smoke_mesh_phase_rehearses_on_the_cpu(capsys):
    """chip_smoke.py's phase 16 at a reduced width on the CPU (a gloo 1x1
    mesh, the kernels' plain versions): step 1 byte-identical to the step
    without a mesh, training through the mesh, the roofline lines."""
    import sys
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(root))
    from repro_torch.models import lm

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        launches = cs.mesh_phase(torch, np, lm, torch.device("cpu"), "cpu",
                                 full=get_config("qwen2_1_5b").reduced(), layers_=2,
                                 batch=2, seq=64, steps=8)
    finally:
        torch.set_num_threads(threads)
    out = capsys.readouterr().out
    assert launches == {"flash_attention": 0} and not dist.is_initialized()
    assert "byte-identical (loss, grad norm, every gradient)" in out
    assert "measured MFU" in out and "[time] phase 16" in out
    # the card's peaks and the kernels' bound are the roofline's own
    assert cs.bound is kernel_bound and cs.BF16_FLOPS == HW_H100["peak_flops_bf16"]
