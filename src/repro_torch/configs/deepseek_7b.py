"""deepseek-7b [arXiv:2401.02954; hf]: 30L d=4096 32H (kv=32) d_ff=11008
vocab=102400 — llama architecture."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-7b",
    family="dense",
    num_layers=30,
    d_model=4096,
    num_heads=32,
    num_kv_heads=32,
    d_ff=11008,
    vocab_size=102400,
    act="silu",
)
