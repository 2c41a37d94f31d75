"""Multi-pod dry run on the CPU: every (arch × shape × mesh) cell's step,
run once on DTensors over a fake process group of 256 or 512 ranks under
``FakeTensorMode``: shapes only, no memory, no card, no communication.

The reference lowers and compiles each cell on 512 forced host devices;
the port instead opens ``init_process_group("fake", world_size=256 or
512)`` (``torch.testing._internal.distributed.fake_pg``), places the
cell's state and inputs by the sharding rules, and runs the real step as
rank 0.  Running it proves the distribution config is coherent (every op
has a placement), and it records, for rank 0:

* ``flops``: FLOPs a rank (``FlopCounterMode``'s formulas over the local
  ops each rank runs);
* ``collective_bytes`` / ``collective_counts``: by kind
  (``roofline.CollectiveTally``);
* ``state_bytes``: the train state's (or parameters' and cache's) local
  shards, exact;
* ``peak_bytes`` / ``activation_bytes``: the peak the step allocates
  (``MemTracker``) and its excess over the state; ``fits_80gb``;
* ``model_flops``.

Nothing here runs on a card: these are a model of 256 (or 512) H100s, not
a measurement.  Results are cached as JSON under
``experiments/dryrun_torch/``.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2_1_5b --mesh single_pod
    PYTHONPATH=src python -m repro_torch.launch.dryrun --force   # everything
    PYTHONPATH=src python -m repro_torch.launch.dryrun --pipeline-smoke
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed._tools.mem_tracker import MemTracker
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..configs import ARCHS, get_config
from ..distributed import sharding as shd
from ..models import encdec
from ..optim import AdamWConfig
from ..roofline.analysis import HW_H100, CollectiveTally, model_flops
from . import cells as C
from .mesh import make_production_mesh, production_spec

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
MESHES = ("single_pod", "multi_pod")


class LocalFlops(TorchDispatchMode):
    """FLOPs of the ops a rank runs itself: a DTensor op is left to DTensor
    (``NotImplemented``), which runs the local ops this mode then counts
    with ``FlopCounterMode``'s formulas.  (``FlopCounterMode`` alone counts
    a DTensor op at its global shapes.)  The ops DTensor's sharding
    propagation runs at global shapes on fake tensors, to learn an output's
    shape, are not counted."""

    def __init__(self):
        super().__init__()
        self._counter = FlopCounterMode(display=False)
        self._inside_propagation = 0
        self.flops = 0

    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import ShardingPropagator

        cls, name = ShardingPropagator, "_propagate_tensor_meta_non_cached"
        self._patched = (cls, name, getattr(cls, name))

        def propagate(prop, *args, **kwargs):
            self._inside_propagation += 1
            try:
                return self._patched[2](prop, *args, **kwargs)
            finally:
                self._inside_propagation -= 1

        setattr(cls, name, propagate)
        return super().__enter__()

    def __exit__(self, *exc):
        cls, name, original = self._patched
        setattr(cls, name, original)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not self._inside_propagation:
            before = self._counter.get_total_flops()
            self._counter._count_flops(func._overloadpacket, out, args, kwargs or {})
            self.flops += self._counter.get_total_flops() - before
        return out


def _leaves(tree):
    out = []
    shd.tree_map_with_path(lambda _, t: out.append(t), tree)
    return [t for t in out if isinstance(t, torch.Tensor)]


def local_bytes(tree) -> int:
    """Bytes a rank holds of a tree of (D)tensors: its local shards."""
    return sum(shd.local(t).numel() * shd.local(t).element_size() for t in _leaves(tree))


def _zeros(shapes: Dict[str, C.ShapeDtype]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(v.shape, dtype=v.dtype) for k, v in shapes.items()}


def build_cell(cfg, cell, mesh, mode: FakeTensorMode):
    """The cell's placed state and a thunk that runs its step once (inside
    ``mode``).  Returns ``(state, run)``."""
    dshapes = C.input_specs(cfg, cell)
    if cell.kind == "train":
        st = C.train_state_shapes(cfg, mode)
        pspecs = shd.param_specs(st["params"], cfg, mesh)
        specs = {"params": pspecs, "opt": shd.zero1_specs(st["opt"], pspecs, mesh)}
        state = shd.place_tree(st, shd.named(mesh, specs))
        step = C.make_train_step(cfg, mesh, cell, AdamWConfig())
        return state, lambda: step(state, _zeros(dshapes))
    params = C.params_shapes(cfg, mode)
    params = shd.place_tree(params, shd.named(mesh, shd.param_specs(params, cfg, mesh)))
    if cell.kind == "prefill":
        step = C.make_prefill_step(cfg, mesh, cell)
        return params, lambda: step(params, _zeros(dshapes))
    cache = C.cache_shapes(cfg, cell.batch, cell.seq, mode)
    cspecs = C.cache_specs(cfg, cache, mesh, cell.batch)
    if cfg.is_encoder_decoder:
        cache = placed = shd.place_tree(cache, shd.named(mesh, cspecs))
    else:
        cache.kv = placed = shd.place_tree(cache.kv, shd.named(mesh, cspecs))
    step = C.make_serve_step(cfg, mesh, cell)
    inputs = _zeros(dshapes)
    if cfg.is_encoder_decoder:
        enc = torch.zeros((cell.batch, cfg.frontend_seq, cfg.d_model),
                          dtype=params["dec_pos"].dtype)
        enc = shd.place(enc, mesh, shd.Spec(*shd.batch_spec(mesh, cell.batch), None, None))
        with implicit_replication():
            cross = encdec.cross_kv(params, cfg, enc)
        return {"params": params, "cache": placed}, lambda: step(
            params, cache, cross, inputs["token"], inputs["pos"])
    return {"params": params, "cache": placed}, lambda: step(
        params, cache, inputs["token"], inputs["pos"])


def run_cell(arch: str, shape: str, mesh_name: str, force: bool = False,
             cfg=None, cell=None, mesh=None, out_dir: Optional[Path] = None):
    """One cell's record (cached unless ``force``).  ``cfg``, ``cell`` and
    ``mesh`` replace the named config, shape and production mesh (a test's
    reduced ones); the process group must be open (:func:`main` opens the
    fake one)."""
    out_dir = out_dir or OUT_DIR
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{arch}__{shape}__{mesh_name}.json"
    if out_path.exists() and not force:
        rec = json.loads(out_path.read_text())
        print(f"[cached] {arch} × {shape} × {mesh_name}: {rec['status']}")
        return rec
    cfg = cfg or get_config(arch)
    cell = cell or C.SHAPES[shape]
    mesh = mesh or make_production_mesh(multi_pod=mesh_name == "multi_pod",
                                        device_type="cpu")
    chips = mesh.size()
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name, "chips": chips,
           "mesh_shape": dict(zip(mesh.mesh_dim_names, mesh.shape)),
           "status": "error", "device": f"cpu: fake backend, a model of {chips} H100s"}
    ok, reason = C.supported(cfg, cell)
    if not ok:
        rec.update(status="skipped", reason=reason)
        out_path.write_text(json.dumps(rec, indent=1))
        print(f"[skip]   {arch} × {shape} × {mesh_name}: {reason}")
        return rec
    t0 = time.time()
    try:
        with FakeTensorMode(allow_non_fake_inputs=True) as mode:
            state, run = build_cell(cfg, cell, mesh, mode)
            state_b = local_bytes(state)
            tracker = MemTracker()
            tracker.track_external(*[shd.local(t) for t in _leaves(state)])
            with LocalFlops() as flops, CollectiveTally() as tally, tracker:
                run()
        peak = _peak(tracker)
        rec.update(
            status="ok",
            wall_s=round(time.time() - t0, 1),
            flops=float(flops.flops),
            collective_bytes=dict(tally.bytes),
            collective_counts=dict(tally.counts),
            state_bytes=state_b,
            peak_bytes=peak,
            activation_bytes=max(peak - state_b, 0),
            model_flops=model_flops(cfg, cell),
        )
        rec["fits_80gb"] = max(peak, state_b) <= HW_H100["hbm_bytes"]
        print(f"[ok]     {arch} × {shape} × {mesh_name}: {rec['wall_s']:.0f} s, "
              f"{max(peak, state_b) / 2**30:.2f} GiB a rank, "
              f"flops a rank {rec['flops']:.3g}, "
              f"collectives {sum(tally.bytes.values()) / 2**30:.2f} GiB")
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="error", error=f"{type(e).__name__}: {str(e)[:500]}",
                   traceback=traceback.format_exc()[-2000:])
        print(f"[FAIL]   {arch} × {shape} × {mesh_name}: {rec['error'][:200]}")
    out_path.write_text(json.dumps(rec, indent=1))
    return rec


def _peak(tracker) -> int:
    """The tracker's peak, summed over its categories, on every device."""
    snap = tracker.get_tracker_snapshot("peak")
    return max((sum(v for k, v in cats.items() if k != "Total") for cats in snap.values()),
               default=0)


def open_fake_group(world: int):
    """The fake process group of ``world`` ranks, this process rank 0."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch id (default: all)")
    ap.add_argument("--shape", default=None, choices=[None, *C.SHAPES])
    ap.add_argument("--mesh", default=None, choices=[None, *MESHES])
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--pipeline-smoke", action="store_true",
                    help="run the GPipe numeric check on 4 gloo processes and exit")
    args = ap.parse_args(argv)

    if args.pipeline_smoke:
        from ..distributed.pipeline import pipeline_smoke
        rec = pipeline_smoke()
        OUT_DIR.mkdir(parents=True, exist_ok=True)
        (OUT_DIR / "pipeline_smoke.json").write_text(json.dumps(rec))
        if rec["status"] != "ok":
            raise SystemExit(1)
        return

    archs = [args.arch] if args.arch else ARCHS
    shapes = [args.shape] if args.shape else list(C.SHAPES)
    meshes = [args.mesh] if args.mesh else list(MESHES)
    print("dry run on the CPU: a fake process group stands in for the H100s; "
          "nothing here is a card measurement")
    results = []
    try:
        for mesh_name in meshes:
            open_fake_group(production_spec(mesh_name == "multi_pod").size())
            for arch in archs:
                for shape in shapes:
                    results.append(run_cell(arch, shape, mesh_name, force=args.force))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\ndry-run summary: {n_ok} ok, {n_skip} skipped, {n_err} errors")
    if n_err:
        for r in results:
            if r["status"] == "error":
                print(f"  FAIL {r['arch']} × {r['shape']} × {r['mesh']}: {r.get('error')}")
        raise SystemExit(1)


if __name__ == "__main__":
    main()
