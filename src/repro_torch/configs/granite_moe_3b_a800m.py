"""granite-moe-3b-a800m [hf:ibm-granite]: 32L d=1536 24H (GQA kv=8)
d_ff(expert)=512, vocab=49155, 40 experts top-8."""
from repro_torch.models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=0,  # all FFN capacity lives in the experts
    vocab_size=49155,
    act="silu",
    tie_embeddings=True,
    moe=MoEConfig(num_experts=40, experts_per_token=8, d_ff_expert=512),
)
