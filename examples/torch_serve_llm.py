"""Serve a small model with batched requests through the PyTorch port's
continuous-batching engine (per-slot positions, slot recycling), with the
multi-step decode window running 8 decode ticks per host dispatch: the
port's counterpart of examples/serve_llm.py, on the card by default.

    PYTHONPATH=src python examples/torch_serve_llm.py [--device cpu]
"""
import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    return serve_main([
        "--arch", "qwen2_1_5b",
        "--reduced",
        "--requests", "12",
        "--slots", "4",
        "--max-new", "12",
        "--prompt-len", "6",
        "--sync-every", "8",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
