"""gemma-7b [arXiv:2403.08295; hf]: 28L d=3072 16H (kv=16) d_ff=24576
vocab=256000 — GeGLU activation, head_dim=256 (q dim 4096 > d_model)."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=16,
    num_kv_heads=16,
    head_dim=256,
    d_ff=24576,
    vocab_size=256000,
    act="geglu",
    tie_embeddings=True,
    rope_theta=10000.0,
)
