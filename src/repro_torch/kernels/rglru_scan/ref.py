"""Plain PyTorch version of the RG-LRU kernel: the JAX package's
`_lru_coeffs` (repro/models/rglru.py:44-53), then the recurrence
h_t = a_t h_{t-1} + b_t as a Hillis-Steele doubling scan over the (a, b)
pairs, log2(S) elementwise steps: the same algebra as
`jax.lax.associative_scan`, whose tree of products it shares in depth but
not in order, so the two round apart by float32 ulps."""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

C = 8.0  # Griffin's fixed gate exponent


def lru_coeffs(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
               b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, b) of h_t = a_t h + b_t, float32. u: (..., W) the conv output;
    ga, gi: u @ w_a and u @ w_i; b_a, b_i, lam: (W,)."""
    r = torch.sigmoid(ga.float() + b_a)
    i = torch.sigmoid(gi.float() + b_i)
    log_a0 = F.logsigmoid(lam.float())            # log a in (-inf, 0)
    log_a = C * r * log_a0
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    b = mult * (i * u.float())
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along dim 1 of (B, S, W), from h0 (B, W) or
    zeros: Hillis-Steele doubling over the pairs, (a_l, b_l) then (a_r,
    b_r) combining to (a_l a_r, a_r b_l + b_r)."""
    if h0 is not None:
        b = torch.cat([a[:, :1] * h0[:, None] + b[:, :1], b[:, 1:]], dim=1)
    S = a.shape[1]
    d = 1
    while d < S:
        a_prev, b_prev = a[:, :-d], b[:, :-d]
        b = torch.cat([b[:, :d], a[:, d:] * b_prev + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a_prev * a[:, d:]], dim=1)
        d *= 2
    return b


def rglru_scan_ref(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
                   b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                   h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h (B, S, W) float32 of the RG-LRU recurrence over u (B, S, W), its
    gate pre-activations ga = u @ w_a and gi = u @ w_i, the biases b_a,
    b_i and lam (W,), from h0 (B, W) float32 or zeros."""
    a, b = lru_coeffs(u, ga, gi, b_a, b_i, lam)
    return linear_scan(a, b, None if h0 is None else h0.float())
