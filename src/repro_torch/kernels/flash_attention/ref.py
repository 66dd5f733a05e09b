"""Plain PyTorch version of the flash-attention kernel: the same function,
in one pass over the full score matrix."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Hkv, T, D) with H % Hkv == 0; query head h
    reads kv head h // (H // Hkv). Math in float32; the causal mask is
    aligned top-left (`cols <= rows`) for any S and T; masked scores are
    -1e30 and a row whose denominator is 0 divides by 1. Returns
    (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    _, Hkv, T, _ = k.shape
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    if T == 0:
        return torch.zeros_like(q)
    qg = q.float().reshape(B, Hkv, G, S, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * scale
    if causal:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        s = s.masked_fill(cols > rows, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float()) / l
    return o.reshape(B, H, S, D).to(q.dtype)
