"""deepseek-v2-lite-16b [arXiv:2405.04434; hf]: 27L d=2048 16H MLA
(kv_lora=512, rope_dim=64) — MoE 64 routed experts top-6 + 2 shared,
d_ff(expert)=1408, first layer dense, vocab=102400.

Assignment header says "64e top-6"; the bracket note "160 routed" refers to
the full V2 — we follow the headline lite config (64 routed)."""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,
    vocab_size=102400,
    attention="mla",
    act="silu",
    mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                  v_head_dim=128),
    moe=MoEConfig(num_experts=64, experts_per_token=6, d_ff_expert=1408,
                  num_shared_experts=2, first_dense_layers=1),
)
