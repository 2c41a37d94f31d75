"""hymba-1.5b [arXiv:2411.13676; hf]: 32L d=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention+mamba heads per block;
sliding-window attention except first/middle/last global layers.
(Meta-token prompt tuning is out of scope — noted in DESIGN.md.)"""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    num_layers=32,
    d_model=1600,
    num_heads=25,
    num_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,
    act="silu",
    sliding_window=1024,
    ssm=SSMConfig(state_dim=16, head_dim=50, expand=2, chunk=128),
)
