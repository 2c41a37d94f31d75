"""Pipeline parallelism: a GPipe schedule of microbatches over a `stage`
mesh axis, with point-to-point sends: the port of
``repro.distributed.pipeline``.

At the assigned model sizes (1.5–26B on 256 chips), TP×DP covers memory and
compute comfortably, so PP is not enabled by default (DESIGN.md §5) — but a
1000+-node deployment adds a stage axis.  Each stage holds a contiguous
slice of layers; each tick, stage ``i`` runs microbatch ``t - i`` and sends
its activations to stage ``i + 1`` (``batch_isend_irecv``); the GPipe
schedule runs M microbatches in M + P - 1 ticks, and the last stage's
outputs are broadcast to every stage.

``bubble_fraction`` quantifies the schedule's idle time — the number the
1F1B/interleaved variants improve on.
"""
from __future__ import annotations

import socket
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist


def bubble_fraction(num_microbatches: int, num_stages: int) -> float:
    """GPipe bubble: (P-1) / (M + P - 1)."""
    m, p = num_microbatches, num_stages
    return (p - 1) / (m + p - 1)


def _slice(tree, lo: int, hi: int):
    if isinstance(tree, dict):
        return {k: _slice(v, lo, hi) for k, v in tree.items()}
    return tree[lo:hi]


def _layer(tree, i: int):
    if isinstance(tree, dict):
        return {k: _layer(v, i) for k, v in tree.items()}
    return tree[i]


def _num_layers(tree) -> int:
    if isinstance(tree, dict):
        return _num_layers(next(iter(tree.values())))
    return tree.shape[0]


def pipeline_forward(layer_params, x, block_fn: Callable, mesh,
                     stage_axis: str = "stage"):
    """Run the stacked layers as the mesh's ``stage_axis`` pipeline stages
    over microbatches.  ``layer_params`` (a tensor or a dict of tensors,
    every rank holding them whole) is stacked on a leading layer axis
    divisible by the stage count; ``x`` is (M, micro_batch, ...), whole on
    every rank.  Returns the (M, micro_batch, ...) outputs on every rank."""
    group = mesh.get_group(stage_axis)
    ranks = dist.get_process_group_ranks(group)
    p = len(ranks)
    idx = mesh.get_local_rank(stage_axis)
    per = _num_layers(layer_params) // p
    mine = _slice(layer_params, idx * per, (idx + 1) * per)
    m = x.shape[0]
    buf = torch.zeros_like(x[0])
    outs = torch.zeros_like(x)
    for t in range(m + p - 1):
        mb = t - idx  # the microbatch this stage runs at tick t
        if 0 <= mb < m:
            if idx == 0:
                buf = x[mb]
            for j in range(per):
                buf = block_fn(_layer(mine, j), buf)
            if idx == p - 1:
                outs[mb] = buf
        ops = []
        if idx < p - 1 and 0 <= mb < m:  # hand this microbatch on
            ops.append(dist.P2POp(dist.isend, buf.contiguous(), ranks[idx + 1], group))
        if idx > 0 and 0 <= t + 1 - idx < m:  # the next tick's input
            buf = torch.empty_like(x[0])
            ops.append(dist.P2POp(dist.irecv, buf, ranks[idx - 1], group))
        for work in (dist.batch_isend_irecv(ops) if ops else ()):
            work.wait()
    dist.broadcast(outs, src=ranks[-1], group=group)
    return outs


# the reference's smoke sizes: 8 layers on 4 stages, 6 microbatches of 4 x 16
SMOKE = dict(layers=8, microbatches=6, batch=4, width=16, stages=4)


def smoke_inputs(seed: int = 0):
    """The smoke's weights (L, D, D) and microbatches (M, B, D), from a
    seed, as numpy."""
    rng = np.random.default_rng(seed)
    s = SMOKE
    w = (rng.standard_normal((s["layers"], s["width"], s["width"])) * 0.1).astype(np.float32)
    x = rng.standard_normal((s["microbatches"], s["batch"], s["width"])).astype(np.float32)
    return w, x


def _smoke_block(p, x):
    return torch.tanh(x @ p)


def _smoke_worker(rank: int, world: int, port: int, w, x, queue):
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    try:
        mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("stage",))
        out = pipeline_forward(torch.from_numpy(w), torch.from_numpy(x), _smoke_block, mesh)
        if rank == 0:
            queue.put(out.numpy())
    finally:
        dist.destroy_process_group()


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_on_gloo(w, x, world: int = SMOKE["stages"], timeout: float = 120.0):
    """:func:`pipeline_forward` of the smoke's block (``tanh(x @ w_i)``)
    on ``world`` gloo processes on this host; returns rank 0's outputs."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_smoke_worker, args=(r, world, port, w, x, queue))
             for r in range(world)]
    for pr in procs:
        pr.start()
    try:
        out = queue.get(timeout=timeout)
    finally:
        for pr in procs:
            pr.join(timeout=timeout)
            if pr.is_alive():
                pr.kill()
    if any(pr.exitcode != 0 for pr in procs):
        raise RuntimeError(f"a pipeline rank failed: {[pr.exitcode for pr in procs]}")
    return out


def pipeline_smoke() -> dict:
    """Numeric check of the GPipe wrapper on 4 gloo processes: pipelined
    layers must equal the sequential stack."""
    w, x = smoke_inputs()
    out = run_on_gloo(w, x)
    ref = torch.from_numpy(x)
    for i in range(w.shape[0]):
        ref = torch.tanh(ref @ torch.from_numpy(w[i]))
    err = float(np.max(np.abs(out - ref.numpy())))
    ok = err < 1e-5
    s = SMOKE
    bubble = bubble_fraction(s["microbatches"], s["stages"])
    print(f"[pipeline] {s['stages']} stages x {s['layers']} layers, {s['microbatches']} "
          f"microbatches: max err {err:.2e} ({'ok' if ok else 'FAIL'}), bubble={bubble:.0%}")
    return {"status": "ok" if ok else "error", "max_err": err, "bubble_fraction": bubble}
