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
              window: Optional[int] = None,
              impl: str = "auto") -> torch.Tensor:
    """q: (B, H, S, D); k, v: (B, Hkv, T, D). Returns (B, H, S, D) in q's
    dtype; causal masks top-left (row i sees columns j <= i), and a window
    keeps columns j > i - window."""
    if resolve_impl(impl, q) == "cuda":
        return flash_attention(q, k, v, causal=causal, scale=scale,
                               window=window)
    return flash_attention_ref(q, k, v, causal=causal, scale=scale,
                               window=window)
