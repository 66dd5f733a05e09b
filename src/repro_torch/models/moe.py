"""Mixture-of-Experts: GShard-style grouped dispatch and combine einsums
(the JAX package's models/moe.py).

Tokens are reshaped into (G groups, tg tokens) so the dispatch tensors stay
bounded. Routing: softmax over experts in float32, top-k, gates
renormalized (Qwen2-MoE style). Each expert takes at most `capacity(cfg)`
assignments a group, filled in (token, k) raster order; the rest are
dropped (GShard). The Switch load-balance loss is returned beside the
output.

The JAX package shards groups over the data axis and experts over the
model axis with sharding constraints; on one card there is nothing to
constrain, and the einsums run as they are (`torch.einsum`, the card's
matrix products).
"""
from __future__ import annotations

from typing import Mapping, Tuple

import torch
import torch.nn.functional as F

from .blocks import mlp_apply, mlp_defs
from .config import ModelConfig
from .param import ParamDef


def moe_defs(cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    D, E, Fe = cfg.d_model, cfg.n_experts, cfg.expert_d_ff
    d = {
        "router": ParamDef((D, E), torch.float32, scale=0.02),
        "w_gate": ParamDef((E, D, Fe), dt),
        "w_up": ParamDef((E, D, Fe), dt),
        "w_down": ParamDef((E, Fe, D), dt),
    }
    if cfg.n_shared_experts:
        d["shared"] = mlp_defs(cfg, D, cfg.n_shared_experts * Fe)
    return d


def capacity(cfg: ModelConfig) -> int:
    """Assignments an expert takes per group: tg * top_k / E times the
    capacity factor, rounded up to a multiple of 4, at least 4."""
    tg = cfg.moe_group_size
    c = int(tg * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(4, -(-c // 4) * 4)


def route(p: Mapping[str, torch.Tensor], xg: torch.Tensor,
          cfg: ModelConfig):
    """The router of (G, tg, D) tokens: float32 probabilities (G, tg, E),
    the top-k gate values renormalized to sum to 1 (G, tg, K), and the
    chosen experts (G, tg, K), best first."""
    logits = xg.float() @ p["router"]                        # (G, t, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = torch.topk(probs, cfg.top_k, dim=-1)    # (G, t, K)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, idx


def assign(idx: torch.Tensor, cfg: ModelConfig):
    """Capacity of the chosen experts (G, tg, K): the kept assignments'
    one-hot mask (G, tg, K, E) and each assignment's position within its
    expert (G, tg, K, E), float32. An expert keeps its first
    `capacity(cfg)` assignments of a group in (token, k) raster order."""
    G, tg, K = idx.shape
    E = cfg.n_experts
    mask = F.one_hot(idx, E).float()
    flat = mask.reshape(G, tg * K, E)
    pos = (torch.cumsum(flat, dim=1) - flat).reshape(G, tg, K, E)
    return mask * (pos < capacity(cfg)), pos


def moe_experts(p: Mapping[str, torch.Tensor], xg: torch.Tensor,
                cfg: ModelConfig, probs: torch.Tensor,
                gate_vals: torch.Tensor, idx: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The layer's output for (G, tg, D) tokens routed by `route`'s
    (probs, gate_vals, idx): dispatch to the experts within capacity, the
    expert MLPs, the gated combine and the shared experts; and the aux
    loss. Returns ((G, tg, D) in xg's dtype, float32 0-d aux)."""
    E = cfg.n_experts
    tg = xg.shape[1]
    C = capacity(cfg)
    mask, pos = assign(idx, cfg)

    # aux load-balance loss (Switch): E * sum_e f_e * P_e
    frac_tokens = mask.sum(dim=(1, 2)) / tg                  # (G, E)
    frac_probs = probs.mean(dim=1)                           # (G, E)
    aux = E * torch.mean(torch.sum(frac_tokens * frac_probs, dim=-1))

    slot = F.one_hot((pos * mask).sum(-1).long(), C).float()  # (G,t,K,C)
    present = mask.amax(dim=-1, keepdim=True)                # (G, t, K, 1)
    dispatch = torch.einsum("gtke,gtkc->gtec", mask, slot * present)
    combine = torch.einsum("gtke,gtkc,gtk->gtec", mask, slot * present,
                           gate_vals)

    dt = xg.dtype
    ei = torch.einsum("gtec,gtd->egcd", dispatch.to(dt), xg)
    h_g = torch.einsum("egcd,edf->egcf", ei, p["w_gate"])
    h_u = torch.einsum("egcd,edf->egcf", ei, p["w_up"])
    act = (F.silu(h_g) if cfg.act.startswith("silu")
           else F.gelu(h_g, approximate="tanh"))
    eo = torch.einsum("egcf,efd->egcd", act * h_u, p["w_down"])
    out = torch.einsum("gtec,egcd->gtd", combine.to(dt), eo)

    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], xg, cfg.act)
    return out, aux.float()


def moe_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (out (B, S, D) in x's dtype, aux loss, a float32
    0-d tensor). Tokens are routed in groups of min(moe_group_size, B*S)."""
    B, S, D = x.shape
    tg = min(cfg.moe_group_size, B * S)
    xg = x.reshape((B * S) // tg, tg, D)
    out, aux = moe_experts(p, xg, cfg, *route(p, xg, cfg))
    return out.reshape(B, S, D), aux
