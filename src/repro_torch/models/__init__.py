"""Model definitions of the port: config, dense GQA layers, the LM."""
from .config import MLAConfig, ModelConfig, MoEConfig, SSMConfig

__all__ = ["MLAConfig", "ModelConfig", "MoEConfig", "SSMConfig"]
