"""Plain PyTorch version of the flash-attention kernel: the same function,
in one pass over the full score matrix."""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def check_window(S: int, T: int, window: Optional[int]) -> None:
    """Raise for a window the kernels do not take: window < 1, or one so
    narrow that a row sees no column (row i sees j > i - window, j < T, so
    every row sees one only while S <= T + window - 1)."""
    if window is None:
        return
    if window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if S > T + window - 1:
        raise ValueError(f"window {window} leaves rows >= {T + window - 1} "
                         f"of S = {S} without a column (T = {T})")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Hkv, T, D) with H % Hkv == 0; query head h
    reads kv head h // (H // Hkv). Math in float32; the causal mask is
    aligned top-left (`cols <= rows`) for any S and T, and a window keeps
    only `cols > rows - window` (the JAX package's `_mask`); masked scores
    are -1e30 and a row whose denominator is 0 divides by 1. Returns
    (B, H, S, D) in q's dtype."""
    B, H, S, D = q.shape
    _, Hkv, T, _ = k.shape
    G = H // Hkv
    scale = D ** -0.5 if scale is None else scale
    if T == 0:
        return torch.zeros_like(q)
    check_window(S, T, window)
    qg = q.float().reshape(B, Hkv, G, S, D)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * scale
    if causal or window is not None:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        masked = torch.zeros((S, T), dtype=torch.bool, device=q.device)
        if causal:
            masked |= cols > rows
        if window is not None:
            masked |= cols <= rows - window
        s = s.masked_fill(masked, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float()) / l
    return o.reshape(B, H, S, D).to(q.dtype)
