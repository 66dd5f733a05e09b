"""SmolLM-360M — llama-arch small [hf:HuggingFaceTB/SmolLM-135M; hf]."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab_size=49_152, act="silu_glu", tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="smollm-360m-smoke", family="dense",
    n_layers=2, d_model=60, n_heads=3, n_kv_heads=1, head_dim=20,
    d_ff=128, vocab_size=512, act="silu_glu", attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
