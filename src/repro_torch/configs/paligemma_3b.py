"""PaliGemma-3B — SigLIP + Gemma VLM [arXiv:2407.07726; hf].

The transformer backbone only (a Gemma-2B-style decoder), as in the JAX
package: the SigLIP vision frontend is not modelled, and 256 precomputed
patch embeddings enter as a bidirectional prefix (the prefix-LM mask,
`Transformer.forward(tokens, prefix_embeds=...)`)."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257_216, act="gelu_glu",
    block_pattern=("attn",), prefix_len=256, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=512, act="gelu_glu",
    block_pattern=("attn",), prefix_len=8, attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
