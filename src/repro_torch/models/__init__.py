"""Model definitions of the port: the config, the layers, the decoder-only
LM (``lm``) and the encoder-decoder (``encdec``)."""
from . import encdec, lm
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig", "encdec", "lm"]
