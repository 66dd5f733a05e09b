"""DeepSeek-V3-671B — MLA + 1 shared + 256 routed top-8 MoE, first 3 layers
dense [arXiv:2412.19437; hf]. MTP head is optional and off, as in the JAX
package. Router is softmax top-k (the paper uses sigmoid + bias), as in
the JAX package."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128, head_dim=128,
    d_ff=18432, vocab_size=129_280, act="silu_glu",
    n_experts=256, top_k=8, n_shared_experts=1, expert_d_ff=2048,
    first_dense_layers=3,
    use_mla=True, q_lora_rank=1536, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    tie_embeddings=False, fsdp=True,
)

SMOKE = ModelConfig(
    name="deepseek-v3-671b-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=512, act="silu_glu",
    n_experts=8, top_k=2, n_shared_experts=1, expert_d_ff=32,
    first_dense_layers=1, moe_group_size=32,
    use_mla=True, q_lora_rank=32, kv_lora_rank=16,
    qk_nope_dim=16, qk_rope_dim=8, v_head_dim=16,
    tie_embeddings=False, attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
