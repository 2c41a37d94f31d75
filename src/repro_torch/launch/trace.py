"""Trace a window of serving ticks on the card with torch.profiler.

    PYTHONPATH=src python -m repro_torch.launch.trace --arch qwen2_1_5b \
        --requests 16 --slots 8 --max-len 1024 --prompt-len 400 \
        --prefill-chunk 64 --max-new 32 --trace-from 20 --trace-ticks 10

It traces any model serve.py serves (the hybrid too: ``--arch hymba_1_5b``,
its prompts replayed a token a tick).  It takes ``launch/serve.py``'s
flags, plus ``--kv-dtype`` (the KV storage format, which serve.py leaves to
``ServeConfig`` as the reference does).  It
serves the workload once untraced, timing every tick (the first tick also
builds the kernels), then serves it again on a fresh engine with the same
parameters and traces ticks ``[--trace-from, --trace-from +
--trace-ticks)``; a negative ``--trace-from`` counts from the end.  With
``--sync-every`` > 1 a "tick" here is one ``engine.step()``, and a
multi-step window is one step however many decode ticks it covers.  The schedule depends only
on the prompt lengths, so both runs tick alike.  It prints the device's busy
time in the window (the traced kernels and copies, each counted once) beside
the untraced wall time of the same ticks, and the largest device consumers.
Tracing a window and not the run keeps the profiler's post-processing short.
"""
from __future__ import annotations

import time

import torch
from torch.autograd import DeviceType

from ..core.device import resolve_device
from .serve import make_engine, parser


def _ticks(engine, n: int, device, times=None) -> None:
    """Up to ``n`` ticks of ``engine``, stopping where ``engine.run`` would,
    each ended by a device sync; their wall times go to ``times``."""
    for _ in range(n):
        t0 = time.perf_counter()
        active = engine.step()
        torch.cuda.synchronize(device)
        if times is not None:
            times.append(time.perf_counter() - t0)
        if active == 0 and not engine.queue:
            return


def main(argv=None):
    ap = parser()
    ap.add_argument("--trace-from", type=int, default=20,
                    help="first traced tick")
    ap.add_argument("--trace-ticks", type=int, default=10,
                    help="number of ticks traced")
    ap.add_argument("--kv-dtype", choices=["int8", "int4"], default=None,
                    help="quantized KV pages (default: the model's dtype)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if device.type != "cuda":
        raise SystemExit("trace: this script measures the card (--device cuda)")

    engine, params = make_engine(args, device, kv_dtype=args.kv_dtype)
    times: list = []
    _ticks(engine, 10_000, device, times)
    wall = sum(times)
    toks = sum(len(r.output) for r in engine.completed)
    print(f"untraced: {len(times)} ticks, {toks} tokens in {wall:.3f} s "
          f"({toks / wall:.1f} tok/s); first tick {times[0] * 1e3:.1f} ms "
          f"(kernel build), later ticks {sum(times[1:]) / (len(times) - 1) * 1e3:.2f} "
          "ms on average")
    lo = args.trace_from + (len(times) if args.trace_from < 0 else 0)
    hi = lo + args.trace_ticks
    if not 0 < lo < hi <= len(times):
        raise SystemExit(f"trace: window [{lo}, {hi}) not within ticks "
                         f"[1, {len(times)})")
    window_wall = sum(times[lo:hi])

    engine, _ = make_engine(args, device, params, kv_dtype=args.kv_dtype)
    _ticks(engine, lo, device)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        _ticks(engine, args.trace_ticks, device)
        traced_wall = time.perf_counter() - t0
    events = prof.key_averages()
    rows = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e6
    if busy <= 0:
        raise SystemExit("trace: the profiler recorded no device time")
    n_ops = sum(e.count for e in events if e.key.startswith("aten::"))
    print(f"ticks [{lo}, {hi}): untraced wall {window_wall * 1e3:.2f} ms, "
          f"traced wall {traced_wall * 1e3:.2f} ms; device busy "
          f"{busy * 1e3:.2f} ms = {100 * busy / window_wall:.1f}% of the "
          f"untraced wall; {n_ops} aten ops ({n_ops / args.trace_ticks:.0f} "
          "per tick, nested ones included)")
    rows.sort(key=lambda e: -e.self_device_time_total)
    for e in rows[:12]:
        print(f"  {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d}x  "
              f"{e.key[:90]}")


if __name__ == "__main__":
    main()
