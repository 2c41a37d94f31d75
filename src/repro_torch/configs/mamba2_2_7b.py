"""mamba2-2.7b [arXiv:2405.21060]: 64L d=2560 attention-free,
ssm_state=128 — SSD (state-space duality), expand=2, head_dim=64."""
from repro_torch.models.config import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b",
    family="ssm",
    num_layers=64,
    d_model=2560,
    num_heads=0,
    num_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab_size=50280,
    attention="none",
    ssm=SSMConfig(state_dim=128, head_dim=64, expand=2, chunk=128),
)
