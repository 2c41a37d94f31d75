"""Boundaries of the port: it imports neither JAX nor the JAX package, its
entry points run on the card unless asked for the CPU, the serve options
that once raised now serve, and chip_smoke.py refuses to run without a
card."""
import importlib.util
import os
import pkgutil
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.serving import ServeConfig, ServingEngine

ROOT = Path(__file__).resolve().parents[1]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_port_imports_neither_jax_nor_repro():
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
    assert "repro_torch.serving.engine" in names and len(names) > 20
    assert {"repro_torch.kernels.flash_attention", "repro_torch.optim.adamw",
            "repro_torch.data.pipeline", "repro_torch.checkpoint.manager",
            "repro_torch.distributed.fault", "repro_torch.launch.train",
            "repro_torch.distributed.sharding", "repro_torch.distributed.pipeline",
            "repro_torch.launch.mesh", "repro_torch.launch.cells",
            "repro_torch.launch.dryrun", "repro_torch.roofline.analysis",
            "repro_torch.roofline.report",
            # the tile-DSL compiler and its programs
            "repro_torch.core.expr", "repro_torch.core.buffer", "repro_torch.core.layout",
            "repro_torch.core.tile_ops", "repro_torch.core.program",
            "repro_torch.core.schedule", "repro_torch.core.infer",
            "repro_torch.core.compiler", "repro_torch.core.errors",
            "repro_torch.core.lowering.phases", "repro_torch.core.lowering.windows",
            "repro_torch.core.lowering.indexing", "repro_torch.core.lowering.grid",
            "repro_torch.core.lowering.cost", "repro_torch.core.lowering.fingerprint",
            "repro_torch.core.lowering.verify", "repro_torch.core.lowering.module",
            "repro_torch.core.lowering.pipeline", "repro_torch.core.backends.reference",
            "repro_torch.core.backends.cuda", "repro_torch.kernels.attention_core"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for n in {names!r}:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    subprocess.run([sys.executable, "-c", code], check=True, env=_env(),
                   timeout=120)
    # chip_smoke.py cannot run here without a card: read its imports
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro." not in src
    assert "from repro import" not in src


def test_tf32_is_off_in_the_port():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("qwen2_1_5b").reduced()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init(cfg, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        lm.init_cache(cfg, 1, 16)
    params = lm.init(cfg, 0, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(cfg, params, ServeConfig(slots=1, max_len=16))
    from repro_torch.launch import serve
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "qwen2_1_5b", "--reduced"])
    eng = ServingEngine(cfg, params, ServeConfig(slots=1, max_len=16,
                                                 max_new_tokens=2), device="cpu")
    assert eng.cache.tables.device.type == "cpu"


@pytest.mark.parametrize("kw,item", [
    (dict(spec_decode="ngram"), "item 12"), (dict(cache="contiguous"), "item 4"),
    (dict(audit=True), "item 11"), (dict(temperature=0.7), "item 5"),
])
def test_unported_serve_options_raise(kw, item):
    """Each row once raised (ServeConfig, or engine init); all four items are
    ported, so each row serves two requests and checks what the option
    does: a sampled stream repeats under its seed and differs from greedy
    (item 5); speculation engages and equals greedy plain decode (item 12);
    the contiguous strips serve greedy's paged streams with no pool (item
    4); the auditor runs after every tick (item 11)."""
    cfg = get_config("qwen2_1_5b").reduced()
    params = lm.init(cfg, 0, device="cpu")
    params["embed"] = {"embedding": params["embed"]["embedding"] * 0.1}
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [5, 3, 5, 8, 9]]

    def run(**over):
        eng = ServingEngine(cfg, params, ServeConfig(
            slots=2, max_len=48, max_new_tokens=6, **over), device="cpu")
        reqs = [eng.submit(p) for p in prompts]
        eng.run()
        assert all(r.status == "completed" for r in reqs)
        return [r.output for r in reqs], eng

    out, eng = run(**kw)
    greedy, paged = run()
    if item == "item 5":
        assert run(**kw)[0] == out != greedy
    elif item == "item 12":
        assert out == greedy and eng.spec_windows > 0
    elif item == "item 4":
        assert out == greedy and eng.pool is None and eng.tables is None
        assert eng.steps_run == paged.steps_run
    else:
        assert out == greedy and eng.audits_run >= eng.steps_run > 0


def test_reference_validation_still_raises_value_errors():
    with pytest.raises(ValueError):
        ServeConfig(slots=0)
    with pytest.raises(ValueError):
        ServeConfig(cache="ring")
    with pytest.raises(ValueError):
        ServeConfig(slots=4, token_budget=2)


def test_fault_injection_and_temperature_sampling_raise():
    """Both once raised; both are ported.  Fault injection (item 11): an
    injector binds to the engine's tick clock and to its pool's allocation
    site.  Temperature sampling (item 5): ``sample_step`` draws under the
    key and splits it, and leaves it where greedy."""
    from repro_torch.serving import Fault, FaultInjector, prng
    from repro_torch.serving.sampling import sample_step
    cfg = get_config("qwen2_1_5b").reduced()
    params = lm.init(cfg, 0, device="cpu")
    inj = FaultInjector([Fault("pool_alloc", tick=2)])
    eng = ServingEngine(cfg, params, ServeConfig(slots=1, max_len=16),
                        injector=inj, device="cpu")
    assert eng.injector is inj and eng.pool.injector is inj
    assert inj.fire("pool_alloc") is None  # the engine's clock reads tick 0
    eng.steps_run = 2
    assert inj.fire("pool_alloc").fired_at == 2
    key = prng.key(0)
    tok, new_key = sample_step(torch.zeros(2, 8), key, temperature=1.0)
    assert tok.dtype == torch.int32 and ((tok >= 0) & (tok < 8)).all()
    assert new_key.tolist() == prng.split(key)[0].tolist() != key.tolist()
    assert sample_step(torch.zeros(2, 8), key)[1] is key


def test_serve_cli_runs_on_the_cpu_and_reports_launches(capsys):
    from repro_torch.launch import serve
    done = serve.main(["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu",
                       "--requests", "3", "--slots", "2", "--max-new", "3",
                       "--prompt-len", "20", "--max-len", "48"])
    assert len(done) == 3 and all(r.status == "completed" for r in done)
    out = capsys.readouterr().out
    assert "served 3 requests, 9 tokens" in out
    # CPU tensors run the kernels' plain versions: no kernel launched
    assert "paged_attention=0, prefill_attention=0" in out


def test_trace_measures_the_card_only():
    from repro_torch.launch import trace
    with pytest.raises(SystemExit, match="measures the card"):
        trace.main(["--arch", "qwen2_1_5b", "--reduced", "--device", "cpu"])


def test_chip_smoke_phases_rehearse_on_the_cpu():
    """chip_smoke.py's phases, run here with CPU tensors (its kernels'
    plain versions; untimed): the checks at the main path's shapes, fp and
    quantized, and the controls of the bf16 limit; the six serving runs on
    a reduced model (their scheduling depends only on the prompt lengths,
    so preemption, sharing, tick equality across KV formats and the byte
    budget's fewer preemptions hold as on the card); and the teacher-forced
    comparison on a reduced 4-layer model, fp and int8."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.kernels import paged_attention as PA
    from repro_torch.kernels import paged_attention_quant as PAQ
    from repro_torch.kernels import prefill_attention as PF
    from repro_torch.kernels import prefill_attention_quant as PFQ
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import KERNELS

    cpu = torch.device("cpu")
    for window in (None, 256):
        r = cs.check_decode(torch, np, ref, PA, torch.float32, window, None, False, cpu)
        assert r["err"] == 0.0
    r = cs.check_prefill(torch, np, ref, PF, torch.float32, 96, None, False, cpu)
    assert r["err"] == 0.0
    for fmt in ("int8", "int4"):
        r = cs.check_decode(torch, np, ref, PAQ, torch.float32, 256, None, False,
                            cpu, fmt=fmt)
        assert r["err"] == 0.0
        r = cs.check_prefill(torch, np, ref, PFQ, torch.float32, None, None,
                             False, cpu, fmt=fmt)
        assert r["err"] == 0.0
    # the bf16 limit passes a sound online softmax and rejects bf16 sums and
    # P rounded once to bf16 (the shortcut the tensor-core kernels avoid)
    for check, mod, fmt in ((cs.check_decode, PA, None), (cs.check_prefill, PF, None),
                            (cs.check_decode, PAQ, "int8"),
                            (cs.check_prefill, PFQ, "int4")):
        r = check(torch, np, ref, mod, torch.bfloat16, None, None, False, cpu,
                  fmt=fmt)
        assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
        assert r["bf16_p_ulps"] > cs.BF16_ULPS, r
    cfg = dataclasses.replace(get_config("qwen2_1_5b").reduced(), num_layers=1)
    params = lm.init(cfg, 0, device="cpu")
    runs = cs.serving_phase(torch, np, lm, cfg, params, KERNELS, cpu)
    assert runs["fp, 199 blocks"][0].preemptions > 0
    assert all(n == 0 for run in runs.values() for n in run[3].values())
    assert lm.decode_loop.__name__ == "decode_loop"  # restored after the run
    for kv_dtype in (None, "int8"):
        cfg4 = dataclasses.replace(get_config("qwen2_1_5b").reduced(),
                                   num_layers=4, dtype="bfloat16",
                                   kv_dtype=kv_dtype)
        tf = cs.teacher_forced(torch, np, lm, cfg4, cpu)
        assert cs.teacher_forced_ok(tf), tf


def test_chip_smoke_mla_phases_rehearse_on_the_cpu():
    """chip_smoke.py's MLA phases, run here with CPU tensors: the four MLA
    kernel checks at deepseek-v2-lite-16B's full-width shapes, fp and
    quantized, with the controls of the bf16 limit; the four deepseek
    serving runs on a reduced model (one dense prefix layer, one MoE layer:
    ticks and TTFT equal across KV formats, the window byte-identical and
    with fewer dispatches); and the teacher-forced comparison with its
    routing agreement, fp and int8."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.kernels import mla_paged as MP
    from repro_torch.kernels import mla_paged_quant as MPQ
    from repro_torch.kernels import mla_prefill as MF
    from repro_torch.kernels import mla_prefill_quant as MFQ
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import KERNELS

    cpu = torch.device("cpu")
    for check, mod, fmt, window in ((cs.check_mla_decode, MP, None, 256),
                                    (cs.check_mla_prefill, MF, None, 96),
                                    (cs.check_mla_decode, MPQ, "int4", None),
                                    (cs.check_mla_prefill, MFQ, "int8", 96)):
        r = check(torch, np, ref, mod, torch.float32, window, None, False, cpu,
                  fmt=fmt)
        assert r["err"] == 0.0
        r = check(torch, np, ref, mod, torch.bfloat16, None, None, False, cpu,
                  fmt=fmt)
        assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    base = get_config("deepseek_v2_lite_16b").reduced()
    params = lm.init(base, 0, device="cpu")
    runs = cs.mla_serving_phase(torch, np, lm, base, params, KERNELS, cpu)
    assert set(runs) == {"fp", "int8", "int4", "int8, sync_every=16"}
    assert all(n == 0 for run in runs.values() for n in run[3].values())
    assert lm.decode_loop.__name__ == "decode_loop"  # restored after the run
    for kv_dtype in (None, "int8"):
        cfg2 = dataclasses.replace(base, dtype="bfloat16", kv_dtype=kv_dtype)
        tf = cs.teacher_forced(torch, np, lm, cfg2, cpu)
        assert tf["route_share"] > 0.9 and cs.teacher_forced_ok(tf), tf


def test_chip_smoke_training_phases_rehearse_on_the_cpu(tmp_path):
    """chip_smoke.py's flash-attention check and training phase, run here
    with CPU tensors (the plain versions) at small sizes: the kernel check
    with its bf16 controls on a causal suffix block and a ragged length; a
    few steps of the train step with one profiled; the depth-2 comparison
    (its runs, on the CPU all plain, the planted faults failing its
    limits); the CLI recovering from
    injected failures."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref

    cpu = torch.device("cpu")
    for case in (("suffix", 2, 4, 2, 16, 64, 32, True), ("ragged", 2, 4, 2, 50, 50, 16, True),
                 ("non-causal", 1, 2, 1, 8, 40, 16, False)):
        assert cs.flash_pairs(case) == _pairs(case)
        r = cs.check_flash(torch, np, ref, FA, torch.float32, case, None, False, cpu)
        assert r["err"] == 0.0
        r = cs.check_flash(torch, np, ref, FA, torch.bfloat16, case, None, False, cpu)
        assert r["ulps"] == 0.0 and cs.kernel_ok(r), r
    cfg = get_config("qwen2_1_5b").reduced()
    tr = cs.train_steps(torch, cfg, cpu, 3, 2, 16, profile_steps=1)
    assert len(tr["losses"]) == 3 and all(np.isfinite(tr["losses"]))
    assert tr["launches"] == {} and "device busy" in tr["profile"]
    r = cs.train_card_vs_cpu(torch, np, lm, dataclasses.replace(cfg, dtype="bfloat16"),
                             cpu, seq=64)
    faults = {f"fault: {f}" for f in cs.TRAIN_FAULTS}
    assert set(r) == {"card bf16", "card bf16, plain attention", "cpu fp32",
                      "cosines"} | faults
    assert r["card bf16"] == r["card bf16, plain attention"]
    assert set(r["cosines"]) >= {"embed/embedding", "layers/attn/wq", "final_norm"}
    assert min(r["cosines"].values()) > 0.99
    assert cs.train_card_vs_cpu_ok(r), r
    for label in faults:  # each planted fault fails the attention cosine
        assert "attn grad cosine" in cs.train_limits_failed(r, label), (label, r)
    res, launches = cs.recovery_run(torch, cpu, tmp_path, steps=6,
                                    failure_prob="0.2", seed="1")
    assert res["restarts"] == 1 and res["steps"] == 6 and launches == 0


def test_chip_smoke_ssm_phases_rehearse_on_the_cpu():
    """chip_smoke.py's SSM phases, run here with CPU tensors (the plain
    versions; untimed): the chunk_state/chunk_scan check on a full-width
    layer's operands at a short sequence (deep decay, hymba's N 16 / P 50,
    the shallow case); three training steps of reduced mamba2 with one
    profiled; the depth-2 comparison, each planted SSD fault failing its
    limits; forward against decode and against the fp32 forward; and the
    two serving runs over the contiguous cache (windows byte-identical to
    per tick, no kernel launched)."""
    import dataclasses

    import numpy as np

    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke as cs
    finally:
        sys.path.remove(str(ROOT))
    from repro_torch.kernels import chunk_scan as CSC
    from repro_torch.kernels import chunk_state as CST
    from repro_torch.kernels import ref
    from repro_torch.kernels.ops import KERNELS

    cpu = torch.device("cpu")
    for case in (("deep", "mamba2_2_7b", 1, 64, "deep"),
                 ("shallow", "mamba2_2_7b", 1, 64, "shallow"),
                 ("growing", "mamba2_2_7b", 1, 64, "growing"),
                 ("hymba", "hymba_1_5b", 1, 48, "deep")):
        for dtype in (torch.float32, torch.bfloat16):
            rs = cs.check_ssd(torch, np, ref, (CST, CSC), dtype, case, None, False, cpu)
            assert set(rs) == {"chunk_state", "chunk_scan"}
            assert all(r["err"] == 0.0 and cs.ssd_ok(r) for r in rs.values()), rs
            if dtype == torch.bfloat16:  # the control the bf16 limit rejects
                assert rs["chunk_scan"]["bf16_scores_ulps"] > cs.BF16_ULPS
            if case[-1] == "deep":
                assert rs["chunk_scan"]["da_min"] < -30
    x = torch.zeros(4, 1, 3).expand(4, 5, 3)
    assert cs.handed_bytes(x) == 4 * 3 * 4
    cfg = get_config("mamba2_2_7b").reduced()
    tr = cs.train_steps(torch, cfg, cpu, 3, 2, 32, profile_steps=1)
    assert all(np.isfinite(tr["losses"])) and tr["launches"] == {}
    assert "inside chunk_scan.backward" in tr["profile"]
    r = cs.train_card_vs_cpu(torch, np, lm, dataclasses.replace(cfg, dtype="bfloat16"),
                             cpu, seq=64)
    faults = {f"fault: {f}" for f in cs.SSM_FAULTS}
    assert set(r) == {"card bf16", "card bf16, plain SSD", "cpu fp32", "cosines"} | faults
    # the same arithmetic; the autograd functions' recompute sums the
    # broadcast B and C gradients in another order
    np.testing.assert_allclose(r["card bf16"], r["card bf16, plain SSD"], rtol=1e-6)
    assert cs.train_card_vs_cpu_ok(r), r
    for label in faults:
        assert "mamba grad cosine" in cs.train_limits_failed(r, label), (label, r)
    vs_decode, vs_cpu, launches = cs.ssm_forward_vs_decode(
        torch, np, lm, dataclasses.replace(cfg, dtype="bfloat16"), cpu, seq=48)
    assert cs.agreement_ok(vs_decode) and cs.agreement_ok(vs_cpu), (vs_decode, vs_cpu)
    assert vs_decode["steps"] == 48 and launches == {"chunk_state": 0, "chunk_scan": 0}
    runs = cs.ssm_serving_phase(torch, np, lm, cfg, lm.init(cfg, 0, device="cpu"),
                                KERNELS, cpu)
    assert len(runs) == 2 and lm.decode_loop.__name__ == "decode_loop"
    assert all(n == 0 for run in runs.values() for n in run[3].values())


def _pairs(case):
    """Live (query, key) pairs of a flash case, counted from its mask."""
    _, b, hq, _, sq, sk, _, causal = case
    qi = torch.arange(sq)[:, None] + (sk - sq)
    ki = torch.arange(sk)[None, :]
    return b * hq * int(((ki <= qi) if causal else torch.ones(sq, sk, dtype=torch.bool)).sum())


def test_chip_smoke_refuses_to_run_without_a_card_or_the_port(
        tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py would run for real")
    r = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                       capture_output=True, text=True, env=_env(), timeout=120)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
    # alone in a directory, with a card: no result either
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    spec = importlib.util.spec_from_file_location("chip_smoke_alone", alone)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    assert cs.SRC == tmp_path / "src"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert cs.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out
