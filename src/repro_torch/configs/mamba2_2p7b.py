"""Mamba2-2.7B — SSD (state-space duality), attention-free
[arXiv:2405.21060; unverified]. 64 SSD layers, no MLP (d_ff=0);
O(1)-state decode => long_500k runs."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-2.7b", family="ssm",
    n_layers=64, d_model=2560, n_heads=0, n_kv_heads=0, head_dim=64,
    d_ff=0, vocab_size=50_280, act="silu_glu",
    block_pattern=("ssd",), ssm_state=128, ssm_headdim=64, ssm_expand=2,
    ssm_chunk=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="mamba2-2.7b-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=0, n_kv_heads=0, head_dim=16,
    d_ff=0, vocab_size=512, act="silu_glu",
    block_pattern=("ssd",), ssm_state=16, ssm_headdim=16, ssm_expand=2,
    ssm_chunk=8, param_dtype="float32", compute_dtype="float32",
)
