"""Qwen1.5-4B — dense MHA with QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b", family="dense",
    n_layers=40, d_model=2560, n_heads=20, n_kv_heads=20, head_dim=128,
    d_ff=6912, vocab_size=151_936, act="silu_glu", qkv_bias=True,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen1.5-4b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, act="silu_glu", qkv_bias=True,
    tie_embeddings=False, attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
