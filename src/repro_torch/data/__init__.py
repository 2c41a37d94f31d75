from .pipeline import DataConfig, SyntheticTokens, TokenFileDataset, make_loader

__all__ = ["DataConfig", "SyntheticTokens", "TokenFileDataset", "make_loader"]
