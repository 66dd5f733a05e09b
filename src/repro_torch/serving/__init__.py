"""Serving of the port's language models: the batched ServeEngine."""
from .engine import ServeEngine
