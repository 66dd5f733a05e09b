"""Minitron-4B — pruned Nemotron [arXiv:2407.14679; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab_size=256_000, act="silu_glu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="minitron-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act="silu_glu", tie_embeddings=False,
    attn_chunk_q=16, param_dtype="float32", compute_dtype="float32",
)
