"""Unified model configuration covering the 10 assigned architectures.

The same fields as the JAX package's `ModelConfig`, so a config module
carries over unchanged; `dtype()` and `pdtype()` return torch dtypes. The
port runs decoders of the layer kinds "attn", "local_attn", "rglru" and
"ssd": dense, mixture-of-experts, SSM (Mamba-2) and hybrid (Griffin). The
other families' fields are kept for the configs that declare them."""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def pad_to_multiple(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"   # dense | moe | ssm | hybrid | encdec | vlm

    # --- trunk ---
    n_layers: int = 12
    d_model: int = 512
    n_heads: int = 8
    n_kv_heads: int = 8
    head_dim: Optional[int] = None        # default d_model // n_heads
    d_ff: int = 2048
    vocab_size: int = 32_000
    vocab_round_to: int = 128             # pad so TP=16 divides (DESIGN §5)
    act: str = "silu_glu"                 # silu_glu | gelu_glu | gelu
    qkv_bias: bool = False                # qwen1.5
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    logit_softcap: Optional[float] = None

    # layer pattern, cycled across n_layers: "attn", "local_attn",
    # "rglru", "ssd"
    block_pattern: Tuple[str, ...] = ("attn",)
    local_window: int = 2048

    # --- MoE ---
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 2
    expert_d_ff: int = 0
    first_dense_layers: int = 0           # deepseek: first k layers dense
    capacity_factor: float = 1.25
    moe_group_size: int = 512             # tokens per dispatch group

    # --- MLA (deepseek) ---
    use_mla: bool = False
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # --- SSM (mamba2 SSD) ---
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_state: int = 128
    ssm_chunk: int = 256
    ssm_conv: int = 4

    # --- hybrid (recurrentgemma) ---
    lru_width: Optional[int] = None       # default d_model

    # --- encoder-decoder (whisper) ---
    n_enc_layers: int = 0                 # >0 => encoder-decoder
    enc_seq_ratio: float = 1.0            # encoder frames per decoder token

    # --- vlm (paligemma) ---
    prefix_len: int = 0                   # image-patch prefix (stub frontend)

    # --- dtypes ---
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"

    # --- distribution knobs (see DESIGN §6) ---
    scan_layers: bool = True
    remat: bool = True
    attn_chunk_q: int = 512               # jnp chunked-attention q block
    # FSDP/ZeRO-3: additionally shard params over the DP axis (needed when
    # params/chip exceeds HBM under TP-only sharding, e.g. 671B)
    fsdp: bool = False
    # how attention weights/compute shard over the model axis:
    #   auto -> "heads" when n_heads % tp == 0 and n_kv_heads % tp == 0,
    #   else "seq" (context-parallel with KV all-gather)
    attn_sharding: str = "auto"
    # explicit q/k/v activation constraints (§Perf hillclimb): heads-sharded
    # q with replicated KV when kv-heads don't divide tp, else context
    # parallel — replaces whatever GSPMD infers
    attn_explicit_sharding: bool = False

    # ---------------- derived ----------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        return pad_to_multiple(self.vocab_size, self.vocab_round_to)

    @property
    def d_inner(self) -> int:             # ssd
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def lru_width_(self) -> int:
        return self.lru_width if self.lru_width else self.d_model

    @property
    def is_encdec(self) -> bool:
        return self.n_enc_layers > 0

    def layer_kinds(self) -> Tuple[str, ...]:
        pat = self.block_pattern
        return tuple(pat[i % len(pat)] for i in range(self.n_layers))

    def moe_layer(self, idx: int) -> bool:
        return (self.n_experts > 0) and (idx >= self.first_dense_layers)

    def supports_shape(self, shape_name: str) -> Tuple[bool, str]:
        """Which of the dry run's shapes (`launch.specs.SHAPES`) run for
        this arch, as the JAX package decides: the 500k-token decode only
        for archs whose every layer is subquadratic in its history."""
        if shape_name == "long_500k":
            subquad = all(k in ("ssd", "rglru", "local_attn")
                          for k in self.layer_kinds())
            if not subquad:
                return False, ("full-attention arch: 500k dense-KV decode "
                               "is quadratic-history; skipped per DESIGN §5")
        return True, ""

    def dtype(self) -> torch.dtype:
        return _DTYPES[self.compute_dtype]

    def pdtype(self) -> torch.dtype:
        return _DTYPES[self.param_dtype]
