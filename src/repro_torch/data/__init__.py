"""The deterministic synthetic token pipeline (`pipeline`)."""
from .pipeline import DataConfig, SyntheticTokens, make_batch

__all__ = ["DataConfig", "SyntheticTokens", "make_batch"]
