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


def check_prefix(prefix_len: int) -> None:
    """Raise for a negative prefix length."""
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, scale: Optional[float] = None,
                        window: Optional[int] = None,
                        prefix_len: int = 0) -> torch.Tensor:
    """q: (B, H, S, Dk); k: (B, Hkv, T, Dk); v: (B, Hkv, T, Dv) with
    H % Hkv == 0; query head h reads kv head h // (H // Hkv). Math in
    float32. The mask is the JAX package's `_mask`: causal keeps
    `cols <= rows` (aligned top-left for any S and T) or, with a prefix,
    `cols < prefix_len` too (a prefix-LM: the prefix attends both ways);
    a window then keeps only `cols > rows - window`; without causal the
    prefix changes nothing. Masked scores are -1e30 and a row whose
    denominator is 0 divides by 1. Returns (B, H, S, Dv) in q's dtype."""
    B, H, S, Dk = q.shape
    _, Hkv, T, _ = k.shape
    Dv = v.shape[-1]
    G = H // Hkv
    scale = Dk ** -0.5 if scale is None else scale
    check_prefix(prefix_len)
    if T == 0:
        return q.new_zeros((B, H, S, Dv))
    check_window(S, T, window)
    qg = q.float().reshape(B, Hkv, G, S, Dk)
    s = torch.einsum("bhgsd,bhtd->bhgst", qg, k.float()) * scale
    if causal or window is not None:
        rows = torch.arange(S, device=q.device)[:, None]
        cols = torch.arange(T, device=q.device)[None, :]
        ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
        if causal:
            ok = cols <= rows
            if prefix_len:
                ok = ok | (cols < prefix_len)
        if window is not None:
            ok = ok & (cols > rows - window)
        s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    l = p.sum(dim=-1, keepdim=True)
    l = torch.where(l == 0.0, torch.ones_like(l), l)
    o = torch.einsum("bhgst,bhtd->bhgsd", p, v.float()) / l
    return o.reshape(B, H, S, Dv).to(q.dtype)
