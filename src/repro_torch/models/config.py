"""Unified model configuration covering all assigned architecture families.

One dataclass; family-specific fields are ignored by families that don't use
them.  Every assigned architecture instantiates this in
``repro_torch/configs/<id>.py``; ``reduced()`` derives the CPU smoke-test
config.  A framework-free copy of ``repro.models.config`` (same fields, same
defaults, same ``reduced()``), so configs compare field for field.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class MoEConfig:
    num_experts: int = 0
    experts_per_token: int = 0
    d_ff_expert: int = 0
    num_shared_experts: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01


@dataclasses.dataclass
class SSMConfig:
    state_dim: int = 128
    head_dim: int = 64
    expand: int = 2
    conv_width: int = 4
    chunk: int = 128

    def num_heads(self, d_model: int) -> int:
        return self.expand * d_model // self.head_dim

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model


@dataclasses.dataclass
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0  # 0 = full-rank q projection
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclasses.dataclass
class ModelConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # default d_model // num_heads
    attention: str = "gqa"  # gqa | mla | none
    act: str = "silu"  # silu | gelu | geglu(=gelu-gated)
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    logit_soft_cap: Optional[float] = None
    sliding_window: Optional[int] = None  # applied to non-global attn layers
    global_attn_every: int = 0  # 0 = all layers global (no windowing)
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    mla: Optional[MLAConfig] = None
    # encoder-decoder (audio family)
    encoder_layers: int = 0
    is_encoder_decoder: bool = False
    # modality frontend stub: inputs arrive as precomputed embeddings
    frontend: str = "none"  # none | patch(vlm) | audio(frames)
    frontend_seq: int = 0  # prefix length delivered by the stub frontend
    dtype: str = "bfloat16"
    # pallas | xla | auto: kept so that a config equals the reference's
    # field for field.  The port never reads it: CUDA tensors always take the
    # hand kernels and CPU tensors their plain versions (kernels/ops.py).
    kernel_backend: str = "auto"
    # Paged-KV storage format: None = store cfg.dtype; "int8"/"int4" = packed
    # symmetric per-token quantization with per-row scales kept in the page
    # pools (see kernels.ref.quantize_rows / DESIGN.md §5.6).  Only the paged
    # layouts support this; contiguous caches reject it loudly.
    kv_dtype: Optional[str] = None

    # -- derived -----------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            self.head_dim = self.d_model // max(self.num_heads, 1)

    @property
    def attends(self) -> bool:
        return self.attention != "none"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token decode? (SSM / hybrid / windowed.)"""
        if self.family in ("ssm",):
            return True
        if self.family == "hybrid":
            return True
        return False

    def window_for_layer(self, layer: int) -> Optional[int]:
        if self.sliding_window is None:
            return None
        if self.global_attn_every and (layer + 1) % self.global_attn_every == 0:
            return None  # periodic global layer
        return self.sliding_window

    # -- parameter counting (roofline MODEL_FLOPS = 6*N*D uses these) --------
    def param_count(self, active_only: bool = False) -> int:
        d, f, v = self.d_model, self.d_ff, self.vocab_size
        hd = self.head_dim
        n = 0
        n += v * d  # embedding
        if not self.tie_embeddings:
            n += v * d
        per_layer = 0
        if self.attends and self.attention == "gqa":
            per_layer += d * self.num_heads * hd  # q
            per_layer += 2 * d * self.num_kv_heads * hd  # kv
            per_layer += self.num_heads * hd * d  # o
        elif self.attention == "mla":
            m = self.mla
            qd = self.num_heads * (m.qk_nope_head_dim + m.qk_rope_head_dim)
            per_layer += d * qd if not m.q_lora_rank else d * m.q_lora_rank + m.q_lora_rank * qd
            per_layer += d * (m.kv_lora_rank + m.qk_rope_head_dim)
            per_layer += m.kv_lora_rank * self.num_heads * (m.qk_nope_head_dim + m.v_head_dim)
            per_layer += self.num_heads * m.v_head_dim * d
        if self.ssm is not None:
            di = self.ssm.d_inner(d)
            nh = self.ssm.num_heads(d)
            per_layer += d * (2 * di + 2 * self.ssm.state_dim * (1 if self.family == "ssm" else 1) + nh)
            per_layer += di * d
        if self.moe is not None and self.moe.num_experts:
            fe = self.moe.d_ff_expert
            experts = self.moe.experts_per_token if active_only else self.moe.num_experts
            per_layer += experts * 3 * d * fe
            per_layer += self.moe.num_shared_experts * 3 * d * fe
            per_layer += d * self.moe.num_experts  # router
        elif f:
            mult = 3 if self.act in ("silu", "geglu") else 2
            per_layer += mult * d * f
        per_layer += 2 * d  # norms
        n += self.num_layers * per_layer
        if self.is_encoder_decoder:
            # encoder self-attn + ffn, and decoder cross-attention extras
            n += self.encoder_layers * (
                2 * d * self.num_heads * hd
                + 2 * d * self.num_kv_heads * hd
                + 2 * d * f
                + 2 * d
            )
            n += self.num_layers * (
                2 * d * self.num_heads * hd  # cross-attn q & o
                + 2 * d * self.num_kv_heads * hd  # cross-attn k & v
                + 2 * d
            )
        return n

    # -- smoke-test reduction -------------------------------------------------
    def reduced(self) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        cfg = dataclasses.replace(
            self,
            num_layers=2,
            d_model=64,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) or 1,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab_size=256,
            encoder_layers=2 if self.is_encoder_decoder else 0,
            sliding_window=32 if self.sliding_window else None,
            frontend_seq=8 if self.frontend != "none" else 0,
            dtype="float32",
            kernel_backend="xla",
        )
        if cfg.moe is not None:
            cfg.moe = dataclasses.replace(
                cfg.moe, num_experts=4, experts_per_token=2, d_ff_expert=32,
                num_shared_experts=min(cfg.moe.num_shared_experts, 1),
                first_dense_layers=min(cfg.moe.first_dense_layers, 1),
            )
        if cfg.ssm is not None:
            cfg.ssm = dataclasses.replace(
                cfg.ssm, state_dim=16, head_dim=16, conv_width=4, chunk=16
            )
        if cfg.mla is not None:
            cfg.mla = MLAConfig(
                kv_lora_rank=32, q_lora_rank=0, qk_nope_head_dim=16,
                qk_rope_head_dim=8, v_head_dim=16,
            )
        return cfg
