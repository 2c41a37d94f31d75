"""qwen2-1.5b [arXiv:2407.10671; hf]: 28L d=1536 12H (GQA kv=2) d_ff=8960
vocab=151936 — GQA with QKV bias."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-1.5b",
    family="dense",
    num_layers=28,
    d_model=1536,
    num_heads=12,
    num_kv_heads=2,
    d_ff=8960,
    vocab_size=151936,
    act="silu",
    qkv_bias=True,
    tie_embeddings=True,
)
