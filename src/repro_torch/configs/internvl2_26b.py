"""internvl2-26b [arXiv:2404.16821; hf]: InternViT frontend (STUB per the
assignment — input_specs provides precomputed patch embeddings) + InternLM2
backbone: 48L d=6144 48H (GQA kv=8) d_ff=16384 vocab=92553."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-26b",
    family="vlm",
    num_layers=48,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    d_ff=16384,
    vocab_size=92553,
    act="silu",
    frontend="patch",
    frontend_seq=256,  # ViT patch tokens delivered by the stub frontend
)
