"""Attention: GQA/MQA/MHA projections, the full, the local-window and the
prefix-LM prefill self-attention through the flash-attention kernel, an
encoder-decoder's cross attention over the encoder's output,
DeepSeek's multi-head latent attention (MLA), and one-token attention
over a KV cache (the cross cache among them) or MLA's latent cache.

Two compute paths, as in the JAX package:
  * `gqa_attention`, `cross_attention` and `mla_attention` — prefill and
    training:
    `kernels.flash_attention.attention`, which launches the hand-written
    CUDA kernel for CUDA tensors (the JAX package runs `flash_attn_jnp`
    here and names its Pallas kernel as the 1:1 replacement on the TPU;
    both are the same top-left causal function, and the kernel takes
    `_mask`'s local window and prefix and MLA's value head dim as well);
  * `decode_attn` and `mla_decode` — one query token over a cache, einsums
    over T with masking (MLA's absorbed into the latent space).
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..kernels.flash_attention import attention
from .blocks import rmsnorm, rmsnorm_def, rope
from .config import ModelConfig
from .param import ParamDef

NEG_INF = -1e30


# --------------------------------------------------------------- params ----
def attn_defs(cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    D, H, Hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    d = {
        "wq": ParamDef((D, H * dh), dt),
        "wk": ParamDef((D, Hkv * dh), dt),
        "wv": ParamDef((D, Hkv * dh), dt),
        "wo": ParamDef((H * dh, D), dt),
    }
    if cfg.qkv_bias:
        d["bq"] = ParamDef((H * dh,), dt, init="zeros")
        d["bk"] = ParamDef((Hkv * dh,), dt, init="zeros")
        d["bv"] = ParamDef((Hkv * dh,), dt, init="zeros")
    return d


def mla_defs(cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    D, H = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope_dim + cfg.qk_rope_dim
    return {
        "w_dq": ParamDef((D, cfg.q_lora_rank), dt),
        "q_norm": rmsnorm_def(cfg.q_lora_rank, dt),
        "w_uq": ParamDef((cfg.q_lora_rank, H * qk), dt),
        "w_dkv": ParamDef((D, cfg.kv_lora_rank), dt),
        "kv_norm": rmsnorm_def(cfg.kv_lora_rank, dt),
        "w_kr": ParamDef((D, cfg.qk_rope_dim), dt),
        "w_ukv": ParamDef(
            (cfg.kv_lora_rank, H * (cfg.qk_nope_dim + cfg.v_head_dim)), dt),
        "wo": ParamDef((H * cfg.v_head_dim, D), dt),
    }


# ---------------------------------------------------------------- masks ----
def _mask(rows: torch.Tensor, cols: torch.Tensor, causal: bool,
          window: Optional[int], prefix_len: int) -> torch.Tensor:
    """rows/cols: global positions, broadcastable. True = attend."""
    ok = torch.ones(torch.broadcast_shapes(rows.shape, cols.shape),
                    dtype=torch.bool, device=rows.device)
    if causal:
        ok = cols <= rows
        if prefix_len:
            ok = ok | (cols < prefix_len)
    if window is not None:
        ok = ok & (cols > rows - window)
    return ok


# ----------------------------------------------------------- decode step ---
def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, *, cache_len: int,
                window: Optional[int] = None,
                scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, 1, Dk); caches: (B, Hkv, T, D*). cache_len: filled length
    (the new token is at position cache_len - 1)."""
    B, H, _, Dk = q.shape
    _, Hkv, T, _ = k_cache.shape
    G = H // Hkv
    scale = (Dk ** -0.5) if scale is None else scale
    qg = q.reshape(B, Hkv, G, Dk)
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(), k_cache.float()) * scale
    pos = torch.arange(T, device=q.device)
    row = torch.full((), cache_len - 1, device=q.device)
    ok = _mask(row, pos, True, window, 0)
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p, v_cache.float())
    return o.reshape(B, H, 1, -1).to(q.dtype)


# ---------------------------------------------------------- GQA wrapper ----
def gqa_project(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig):
    """x: (B, S, D) -> q (B,H,S,dh), k/v (B,Hkv,S,dh) with rope applied by
    the caller (positions differ between prefill and decode)."""
    B, S, _ = x.shape
    H, Hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim_
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    q = q.reshape(B, S, H, dh).transpose(1, 2)
    k = k.reshape(B, S, Hkv, dh).transpose(1, 2)
    v = v.reshape(B, S, Hkv, dh).transpose(1, 2)
    return q, k, v


def gqa_attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, *, positions: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  prefix_len: int = 0, impl: str = "auto") -> torch.Tensor:
    """Prefill self-attention for one layer, full or within a local
    `window` (row i sees positions (i - window, i]); with `prefix_len`
    every row also sees the first prefix_len positions (a prefix-LM). On a
    CUDA tensor (impl "auto" or "cuda") it launches the flash-attention
    kernel once."""
    B, S, _ = x.shape
    q, k, v = gqa_project(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, window=window, prefix_len=prefix_len,
                  impl=impl)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim_)
    return o @ p["wo"]


# -------------------------------------------------------- cross attention --
def cross_kv(p: Mapping[str, torch.Tensor], enc_out: torch.Tensor,
             cfg: ModelConfig):
    """k, v (B, Hkv, S_enc, dh) of the encoder's output enc_out (B, S_enc,
    D): no bias, no rope (the JAX package's `_cross_attention`)."""
    B, Se, _ = enc_out.shape
    Hkv, dh = cfg.n_kv_heads, cfg.head_dim_
    k = (enc_out @ p["wk"]).reshape(B, Se, Hkv, dh).transpose(1, 2)
    v = (enc_out @ p["wv"]).reshape(B, Se, Hkv, dh).transpose(1, 2)
    return k, v


def cross_attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                    enc_out: torch.Tensor, cfg: ModelConfig, *,
                    impl: str = "auto") -> torch.Tensor:
    """A decoder layer's attention over the encoder's output: q from the
    normed decoder state x (B, S, D), k and v from enc_out (B, S_enc, D),
    no rope, not causal: every decoder position sees every frame. On a
    CUDA tensor (impl "auto" or "cuda") one flash launch, S over T =
    S_enc."""
    B, S, _ = x.shape
    H, dh = cfg.n_heads, cfg.head_dim_
    q = (x @ p["wq"]).reshape(B, S, H, dh).transpose(1, 2)
    k, v = cross_kv(p, enc_out, cfg)
    o = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=False, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, H * dh)
    return o @ p["wo"]


# ------------------------------------------------------------------ MLA ----
def mla_attention(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                  cfg: ModelConfig, *, positions: torch.Tensor,
                  impl: str = "auto") -> torch.Tensor:
    """DeepSeek multi-head latent attention, prefill form: q and kv through
    their low-rank projections, the one rope'd key of dr dims broadcast
    over the H heads beside each head's dn, and causal attention with key
    head dim dn + dr over value head dim dv, scaled by (dn + dr) ** -0.5.
    On a CUDA tensor (impl "auto" or "cuda") it launches the
    flash-attention kernel once (bf16 at (192, 128): the tensor cores)."""
    B, S, _ = x.shape
    H = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim

    cq = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, S, H, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions, cfg.rope_theta)

    c_kv = rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # (B,S,r)
    k_rope = rope((x @ p["w_kr"])[:, None], positions,
                  cfg.rope_theta)                                # (B,1,S,dr)
    kv = (c_kv @ p["w_ukv"]).reshape(B, S, H, dn + dv).transpose(1, 2)
    k_nope, v = kv[..., :dn], kv[..., dn:]

    k = torch.cat([k_nope, k_rope.expand(B, H, S, dr)], dim=-1)
    qh = torch.cat([q_nope, q_rope], dim=-1)
    o = attention(qh, k, v.contiguous(), causal=True,
                  scale=(dn + dr) ** -0.5, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, H * dv)
    return o @ p["wo"]


def mla_decode(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig, *, c_cache: torch.Tensor,
               kr_cache: torch.Tensor, length: int) -> torch.Tensor:
    """Absorbed-matrix MLA decode: attention runs in the latent space, the
    cache stores kv_lora_rank + qk_rope_dim numbers per token.

    x: (B, 1, D) normed input of the token at position length - 1;
    c_cache: (B, T, r); kr_cache: (B, T, dr). Writes the token's latent
    and rope'd key into slot min(length - 1, T - 1) of the caches in place
    (past T the last slot is overwritten, as the JAX package's clamped
    dynamic_update_slice does) and attends over the slots < length.
    Returns the output (B, 1, D)."""
    B = x.shape[0]
    H = cfg.n_heads
    dn, dr, dv, r = (cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim,
                     cfg.kv_lora_rank)
    pos = length - 1
    position = torch.arange(pos, pos + 1, device=x.device)

    cq = rmsnorm(x @ p["w_dq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["w_uq"]).reshape(B, 1, H, dn + dr).transpose(1, 2)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, position, cfg.rope_theta)

    w_ukv = p["w_ukv"].reshape(r, H, dn + dv)
    w_uk = w_ukv[..., :dn]                    # (r, H, dn)
    w_uv = w_ukv[..., dn:]                    # (r, H, dv)
    # absorb W_uk into the query: q_lat = q_nope @ W_uk^T  -> (B,H,1,r)
    q_lat = torch.einsum("bhqd,rhd->bhqr", q_nope, w_uk)

    new_c = rmsnorm(x @ p["w_dkv"], p["kv_norm"], cfg.norm_eps)  # (B,1,r)
    new_kr = rope(x @ p["w_kr"], position, cfg.rope_theta)       # (B,1,dr)
    T = c_cache.shape[1]
    slot = min(pos, T - 1)
    c_cache[:, slot] = new_c[:, 0]
    kr_cache[:, slot] = new_kr[:, 0]

    c32 = c_cache.float()
    s = (torch.einsum("bhqr,btr->bhqt", q_lat.float(), c32)
         + torch.einsum("bhqd,btd->bhqt", q_rope.float(), kr_cache.float())
         ) * ((dn + dr) ** -0.5)
    valid = torch.arange(T, device=x.device) < length
    s = s.masked_fill(~valid, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhqt,btr->bhqr", w, c32)
    o = torch.einsum("bhqr,rhd->bhqd", o_lat.to(x.dtype), w_uv)
    o = o.transpose(1, 2).reshape(B, 1, H * dv)
    return o @ p["wo"]
