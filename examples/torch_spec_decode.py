"""Speculative decoding via n-gram self-speculation on the PyTorch port:
each round drafts 4 tokens from the slot's own history, verifies all of
them in one chunked-prefill pass, and commits the accepted prefix on the
device, composing with the multi-step window (sync_every) so one host
dispatch covers up to sync_every * (draft_len + 1) tokens.  Greedy output
is byte-identical to plain decode; the printed stats show the draft
acceptance rate.  The port's counterpart of examples/spec_decode.py, on the
card by default.

    PYTHONPATH=src python examples/torch_spec_decode.py [--device cpu]
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
        "--max-new", "24",
        "--prompt-len", "6",
        "--sync-every", "4",
        "--spec-decode", "ngram",
        "--draft-len", "4",
        "--device", args.device,
    ])


if __name__ == "__main__":
    main()
