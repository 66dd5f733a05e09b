"""Qwen2-MoE-A2.7B — 60 routed experts top-4 + 4 shared
[hf:Qwen/Qwen1.5-MoE-A2.7B; hf]. Experts padded 60 -> 64 as in the JAX
package, where the expert count must divide its 16-way model axis; the
padding experts are routed like the others."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b", family="moe",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=0, vocab_size=151_936, act="silu_glu",
    n_experts=64, top_k=4, n_shared_experts=4, expert_d_ff=1408,
    tie_embeddings=False,
)

SMOKE = ModelConfig(
    name="qwen2-moe-a2.7b-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=0, vocab_size=512, act="silu_glu",
    n_experts=8, top_k=2, n_shared_experts=1, expert_d_ff=32,
    moe_group_size=32, tie_embeddings=False, attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
