"""chatglm3-6b [arXiv:2406.12793; hf]: 28L d=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2d RoPE (rotary over half the head dim), strong GQA."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="chatglm3-6b",
    family="dense",
    num_layers=28,
    d_model=4096,
    num_heads=32,
    num_kv_heads=2,
    d_ff=13696,
    vocab_size=65024,
    act="silu",
    qkv_bias=True,  # chatglm adds qkv bias
)
