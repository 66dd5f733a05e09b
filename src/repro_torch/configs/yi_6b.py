"""Yi-6B — llama-arch GQA [arXiv:2403.04652; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="yi-6b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab_size=64_000, act="silu_glu", tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="yi-6b-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=512, act="silu_glu", tie_embeddings=False,
    attn_chunk_q=16, param_dtype="float32", compute_dtype="float32",
)
