"""Plain PyTorch version of the RG-LRU kernel: the JAX package's
`_lru_coeffs` (repro/models/rglru.py:44-53), then the recurrence
h_t = a_t h_{t-1} + b_t as a Hillis-Steele doubling scan over the (a, b)
pairs, log2(S) elementwise steps: the same algebra as
`jax.lax.associative_scan`, whose tree of products it shares in depth but
not in order, so the two round apart by float32 ulps.

The backward (`rglru_scan_bwd_ref`) is the gradient written out, not
autograd: the gates recomputed, the reverse recurrence
g_t = dh_t + a_{t+1} g_{t+1} as the same doubling scan over time
reversed, then the chain rule through the gates elementwise."""
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


def rglru_gate_grads(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
                     b_a: torch.Tensor, b_i: torch.Tensor, lam: torch.Tensor,
                     h: torch.Tensor, g: torch.Tensor,
                     h0: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, ...]:
    """The chain rule back through the gates, elementwise, from g (B, S,
    W) float32, the gradient reaching h_t with every later step's path
    included: (du in u's dtype, dga, dgi, d(log a) r (B, S, W) float32,
    dh0 (B, W) or None without h0), as `rglru_scan_bwd_ref` states them."""
    uf = u.float()
    r = torch.sigmoid(ga.float() + b_a)
    i = torch.sigmoid(gi.float() + b_i)
    log_a0 = F.logsigmoid(lam.float())
    log_a = C * r * log_a0
    a = torch.exp(log_a)
    a2 = torch.exp(2.0 * log_a)
    one_minus = 1.0 - a2
    m = torch.sqrt(torch.clamp(one_minus, min=1e-12))
    h_prev = torch.cat([torch.zeros_like(h[:, :1]) if h0 is None
                        else h0.float()[:, None], h[:, :-1]], dim=1)
    dm_dlog_a = torch.where(one_minus >= 1e-12, -a2 / m,
                            torch.zeros_like(m))
    dlog_a = g * h_prev * a + g * i * uf * dm_dlog_a
    dga = dlog_a * C * log_a0 * r * (1.0 - r)
    dgi = g * m * uf * i * (1.0 - i)
    du = (g * m * i).to(u.dtype)
    dh0 = None if h0 is None else a[:, 0] * g[:, 0]
    return du, dga, dgi, dlog_a * r, dh0


def rglru_scan_bwd_ref(u: torch.Tensor, ga: torch.Tensor, gi: torch.Tensor,
                       b_a: torch.Tensor, b_i: torch.Tensor,
                       lam: torch.Tensor, h: torch.Tensor, dh: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, ...]:
    """The gradient of `rglru_scan_ref` for the arguments of the forward,
    its output h (B, S, W) float32 and the output's gradient dh (B, S, W)
    float32. Returns (du in u's dtype, dga, dgi (B, S, W), db_a, db_i,
    dlam (W,), dh0 (B, W) or None without h0), all but du float32:

      g_t = dh_t + a_{t+1} g_{t+1} (0 past the last step); db = g and
      da = g h_{t-1} (h_{-1} = h0 or 0); dh0 = a_0 g_0; du = db m i;
      d(log a) = da a + (db i u) dm/d(log a), dm/d(log a) = -a^2 / m
      (0 where the clamp of m holds); dga = d(log a) 8 log_sigmoid(lam)
      r (1 - r); dgi = db m u i (1 - i); db_a, db_i and dlam
      (= d(log a) 8 r sigmoid(-lam)) summed over B and S,
    with r, i, a and m = sqrt(max(1 - a^2, 1e-12)) as in `lru_coeffs`
    (a^2 computed as exp(2 log a), as there)."""
    a, _ = lru_coeffs(u, ga, gi, b_a, b_i, lam)
    # g over time reversed: g'_s = dh'_s + a_next'_s g'_{s-1}, from 0
    a_next = torch.cat([a[:, 1:], torch.zeros_like(a[:, :1])], dim=1)
    g = linear_scan(a_next.flip(1), dh.float().flip(1)).flip(1)
    du, dga, dgi, dlr, dh0 = rglru_gate_grads(u, ga, gi, b_a, b_i, lam, h,
                                              g, h0)
    dlam = dlr.sum((0, 1)) * C * torch.sigmoid(-lam.float())
    return du, dga, dgi, dga.sum((0, 1)), dgi.sum((0, 1)), dlam, dh0
