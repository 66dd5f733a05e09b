"""The attention entry point: dispatch between the CUDA kernel and its
plain version.

`impl`: "cuda" launches the hand-written kernel and needs CUDA tensors;
"ref" runs the plain PyTorch version on any device; "auto" picks "cuda"
for CUDA tensors and "ref" for CPU tensors. A CUDA tensor under "auto"
always goes to the kernel: there is no fallback.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_impl
from .flash_attention import flash_attention
from .ref import flash_attention_ref


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None, prefix_len: int = 0,
              impl: str = "auto") -> torch.Tensor:
    """q: (B, H, S, Dk); k: (B, Hkv, T, Dk); v: (B, Hkv, T, Dv). Returns
    (B, H, S, Dv) in q's dtype; causal masks top-left (row i sees columns
    j <= i, and with a prefix every column j < prefix_len), and a window
    keeps columns j > i - window."""
    fn = (flash_attention if resolve_impl(impl, q) == "cuda"
          else flash_attention_ref)
    return fn(q, k, v, causal=causal, scale=scale, window=window,
              prefix_len=prefix_len)
