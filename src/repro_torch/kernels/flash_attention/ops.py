"""The attention entry point: dispatch between the CUDA kernels and their
plain versions, forward and backward.

`impl`: "cuda" launches the hand-written kernels and needs CUDA tensors;
"ref" runs the plain PyTorch versions on any device; "auto" picks "cuda"
for CUDA tensors, "ref" for CPU tensors and "meta" for meta tensors (the
counting lane of `launch.dryrun`: empty results, one booked launch). A
CUDA tensor under "auto" always goes to the kernels: there is no
fallback.

Where q, k or v requires a gradient (and autograd is on), the call goes
through `FlashAttention`, a torch.autograd.Function whose forward is the
same dispatch and whose backward is the backward kernel under "cuda" and
its plain version (`flash_attention_bwd_ref`) under "ref". The forward
saves each row's log-sum-exp (every lane gives one) and the backward's
lanes read it, so the backward need not rebuild it. Otherwise the forward
is called directly: `FlashAttention.apply` costs the host 7-17 us a call
more on an H100 machine (chip_smoke.py's `attention_dispatch_cost`), and
inference forwards are host-bound.
"""
from __future__ import annotations

from typing import Optional

import torch

from .. import resolve_impl
from .flash_attention import flash_attention, flash_attention_bwd
from .ref import flash_attention_bwd_ref, flash_attention_ref

def _forward(impl: str):
    """The forward of a lane (`kernels.resolve_impl`): the kernel's
    wrapper, which books in place of launching on meta tensors, or the
    plain version."""
    return flash_attention_ref if impl == "ref" else flash_attention


def _backward(impl: str):
    """The backward of a lane."""
    return flash_attention_bwd_ref if impl == "ref" else flash_attention_bwd

class FlashAttention(torch.autograd.Function):
    """Attention with its gradient: apply(q, k, v, causal, scale, window,
    prefix_len, impl) with impl already resolved to "cuda", "ref" or
    "meta". Saves
    q, k, v, the output and each row's log-sum-exp (B, H, S) for the
    backward, which recomputes the scores (no (S, T) residual is kept)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, window, prefix_len, impl):
        kw = dict(causal=causal, scale=scale, window=window,
                  prefix_len=prefix_len)
        o, lse = _forward(impl)(q, k, v, return_lse=True, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.args = kw
        ctx.impl = impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _backward(ctx.impl)(q, k, v, o, do.contiguous(),
                                        lse=lse, **ctx.args)
        return dq, dk, dv, None, None, None, None, None


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, scale: Optional[float] = None,
              window: Optional[int] = None, prefix_len: int = 0,
              impl: str = "auto") -> torch.Tensor:
    """q: (B, H, S, Dk); k: (B, Hkv, T, Dk); v: (B, Hkv, T, Dv). Returns
    (B, H, S, Dv) in q's dtype; causal masks top-left (row i sees columns
    j <= i, and with a prefix every column j < prefix), and a window
    keeps columns j > i - window. Differentiable in q, k and v through
    `FlashAttention` where any of them requires a gradient."""
    impl = resolve_impl(impl, q)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, scale, window,
                                    prefix_len, impl)
    return _forward(impl)(q, k, v, causal=causal, scale=scale,
                          window=window, prefix_len=prefix_len)
