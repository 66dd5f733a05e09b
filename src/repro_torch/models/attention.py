"""Attention for the decoder: GQA/MQA/MHA projections, the full and the
local-window prefill self-attention through the flash-attention kernel,
and one-token attention over a KV cache.

Two compute paths, as in the JAX package:
  * `gqa_attention` — prefill: `kernels.flash_attention.attention`, which
    launches the hand-written CUDA kernel for CUDA tensors (the JAX package
    runs `flash_attn_jnp` here and names its Pallas kernel as the 1:1
    replacement on the TPU; both are the same top-left causal function,
    and the kernel takes `_mask`'s local window as well);
  * `decode_attn` — one query token over a cache, an einsum over T with
    masking.

Prefix-LM masks, query offsets and MLA are not ported yet (ROADMAP.md,
Queue 1 item 10): they raise rather than run a plain path.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..kernels.flash_attention import attention
from .blocks import rope
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
    `window` (row i sees positions (i - window, i]). On a CUDA tensor
    (impl "auto" or "cuda") it launches the flash-attention kernel once."""
    if prefix_len:
        raise NotImplementedError(
            "prefix-LM masks are not ported yet (ROADMAP.md, Queue 1 "
            "item 10)")
    B, S, _ = x.shape
    q, k, v = gqa_project(p, x, cfg)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    o = attention(q.contiguous(), k.contiguous(), v.contiguous(),
                  causal=causal, window=window, impl=impl)
    o = o.transpose(1, 2).reshape(B, S, cfg.n_heads * cfg.head_dim_)
    return o @ p["wo"]
