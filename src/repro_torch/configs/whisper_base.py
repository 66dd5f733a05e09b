"""Whisper-base — encoder-decoder [arXiv:2212.04356; unverified].

Backbone only: the conv/mel frontend is a STUB — the encoder takes
precomputed frame embeddings (B, S_enc, d_model). Vocab padded
51,865 -> 51,968; RoPE replaces sinusoidal positions (the JAX package's
design notes, §5/§7). Copied from the JAX package's config."""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base", family="audio",
    n_layers=6, n_enc_layers=6, d_model=512, n_heads=8, n_kv_heads=8,
    head_dim=64, d_ff=2048, vocab_size=51_865, act="gelu",
    tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-base-smoke", family="audio",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    head_dim=16, d_ff=128, vocab_size=512, act="gelu",
    tie_embeddings=True, attn_chunk_q=16,
    param_dtype="float32", compute_dtype="float32",
)
