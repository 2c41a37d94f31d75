"""The port's examples (``examples/torch_*.py``), each run on the CPU at its
reduced config: the serving one's summary line against the reference
example's (examples/serve_llm.py: the same engine schedule, which depends
only on prompt lengths and blocks), the speculative one's counts, and the
training one through an injected failure and its recovery."""
import importlib.util
import re
import runpy
from pathlib import Path

import numpy as np
import pytest
import torch

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
SERVED = re.compile(
    r"served (\d+) requests, (\d+) tokens in [\d.]+s \([\d.]+ tok/s, (\d+) engine steps "
    r"\[(\w+) prefill\], paged cache: peak (\d+) blocks, (\d+) preemptions, (\d+) "
    r"multi-step windows \((\d+) fallbacks\)(.*), mean TTFT ([\d.]+) ticks\)")
SPEC = re.compile(r", (\d+) spec windows: (\d+)/(\d+) drafts accepted \(([\d.]+)\)")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for the reduced models (as
    tests/test_torch_hybrid.py); restored for the modules that follow."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _example(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(out):
    line = next(x for x in out.splitlines() if x.startswith("served "))
    m = SERVED.fullmatch(line)
    assert m, line
    return m


def test_serve_example_runs_the_reference_examples_schedule(capsys):
    """12 requests of 6 prompt tokens, 12 new each, over 4 slots with the
    8-tick window: every field of the summary but the speed equals the
    reference example's; no kernel launches on the CPU."""
    done = _example("torch_serve_llm").main(["--device", "cpu"])
    out = capsys.readouterr().out
    got = _summary(out)
    assert len(done) == 12 and all(r.status == "completed" for r in done)
    assert (got[1], got[2], got[4]) == ("12", "144", "chunked")
    assert int(got[7]) > 0 and got[8] == "0"
    assert "kernel launches on cpu: paged_attention=0" in out
    runpy.run_path(str(EXAMPLES / "serve_llm.py"), run_name="__main__")
    want = _summary(capsys.readouterr().out)
    assert got.group(1, 2, 3, 4, 5, 6, 7, 8, 9, 10) == want.group(1, 2, 3, 4, 5, 6, 7, 8, 9, 10)


def test_spec_decode_example_accepts_drafts(capsys):
    """The ngram speculation example: 12 requests of 24 new tokens each,
    completed; drafts proposed and accepted in spec windows, the rate the
    ratio of the two."""
    done = _example("torch_spec_decode").main(["--device", "cpu"])
    out = capsys.readouterr().out
    got = _summary(out)
    assert (got[1], got[2]) == ("12", "288") and len(done) == 12
    spec = SPEC.fullmatch(got[9])
    assert spec, got[9]
    windows, accepted, proposed, rate = (int(spec[1]), int(spec[2]), int(spec[3]),
                                         float(spec[4]))
    assert windows > 0 and 0 < accepted <= proposed
    assert rate == pytest.approx(accepted / proposed, abs=0.005)


def test_train_example_recovers_from_an_injected_failure(capsys):
    """Fewer steps than the example's 200, a failure probability that
    fires: the run restarts from its checkpoint and reaches its last step
    with a finite loss, and prints the reference's lines."""
    res = _example("torch_train_lm").run(steps=6, device="cpu", failure_prob=0.2, seed=1)
    out = capsys.readouterr().out
    assert res["steps"] == 6 and res["restarts"] > 0
    loss = float(res["last_metrics"]["loss"])
    assert np.isfinite(loss)
    assert f"done: 6 steps, {res['restarts']} restarts, final loss {loss:.4f}" in out
    assert "kernel launches on cpu: none" in out
    assert re.search(r"loss decreased from ~ln\(V\)≈5\.5: [✓✗]", out)
