"""RecurrentGemma-2B — Griffin: RG-LRU + local attention, 2:1 pattern
[arXiv:2402.19427; hf]. 26 layers cycle (rglru, rglru, local_attn);
sub-quadratic => long_500k runs."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab_size=256_000, act="gelu_glu",
    block_pattern=("rglru", "rglru", "local_attn"), local_window=2048,
    lru_width=2560, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="recurrentgemma-2b-smoke", family="hybrid",
    n_layers=3, d_model=64, n_heads=2, n_kv_heads=1, head_dim=32,
    d_ff=128, vocab_size=512, act="gelu_glu",
    block_pattern=("rglru", "rglru", "local_attn"), local_window=16,
    lru_width=64, attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
