"""whisper-tiny [arXiv:2212.04356]: enc-dec, 4L each, d=384 6H d_ff=1536
vocab=51865 — conv audio frontend is a STUB (input_specs provides frame
embeddings); decoder position table sized for the 32k decode cells."""
from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    num_layers=4,
    d_model=384,
    num_heads=6,
    num_kv_heads=6,
    d_ff=1536,
    vocab_size=51865,
    act="gelu",
    is_encoder_decoder=True,
    encoder_layers=4,
    frontend="audio",
    frontend_seq=1500,
    tie_embeddings=True,
)
