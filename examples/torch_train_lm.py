"""End-to-end training with the PyTorch port: train a reduced
qwen2-family LM for a few hundred steps with checkpointing and
injected-failure recovery; the port's counterpart of examples/train_lm.py,
on the card by default.

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] [--device cpu]
"""
import argparse
import tempfile

from repro_torch.launch.train import main as train_main


def run(steps: int = 200, device: str = "cuda", failure_prob: float = 0.005,
        seed: int = 0):
    with tempfile.TemporaryDirectory() as d:
        result = train_main([
            "--arch", "qwen2_1_5b",
            "--reduced",
            "--device", device,
            "--steps", str(steps),
            "--batch", "8",
            "--seq", "64",
            "--lr", "3e-3",
            "--ckpt-dir", d,
            "--ckpt-interval", "50",
            "--failure-prob", str(failure_prob),  # exercise the recovery path
            "--seed", str(seed),
            "--log-every", "20",
        ])
    losses_ok = float(result["last_metrics"]["loss"]) < 6.0
    print("loss decreased from ~ln(V)≈5.5:", "✓" if losses_ok else "✗")
    return result


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args()
    run(args.steps, args.device)
