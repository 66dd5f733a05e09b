"""Shared building blocks: norms, rope, activations, MLP, embedding.

Weights keep the JAX package's layout, (D_in, D_out) used as `x @ w`, so
parameters carry over without transposes."""
from __future__ import annotations

import math
from typing import Mapping

import torch
import torch.nn.functional as F

from .config import ModelConfig
from .param import ParamDef


# ---------------------------------------------------------------- norms ----
def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6
            ) -> torch.Tensor:
    """RMS norm in float32, scaled by (1 + w), cast back to x's dtype."""
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * (1.0 + w.float())).to(x.dtype)


def rmsnorm_def(dim: int, dtype: torch.dtype) -> ParamDef:
    # stored as offset from 1 (gemma convention); init zeros
    return ParamDef((dim,), dtype, init="zeros")


# ----------------------------------------------------------------- rope ----
def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """x: (..., S, D) with positions (..., S) or (S,). Rotates the two
    halves of the features by angles computed in float32."""
    half = x.shape[-1] // 2
    # built on x's device from Python scalars: no host-to-device copy, which
    # would make the host wait for the card at every call
    freqs = torch.exp(-math.log(theta) * torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions[..., None].float() * freqs          # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:]
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ------------------------------------------------------------------ mlp ----
def mlp_defs(cfg: ModelConfig, d_in: int, d_ff: int) -> dict:
    dt = cfg.pdtype()
    if cfg.act.endswith("_glu"):
        return {
            "w_gate": ParamDef((d_in, d_ff), dt),
            "w_up": ParamDef((d_in, d_ff), dt),
            "w_down": ParamDef((d_ff, d_in), dt),
        }
    return {
        "w_up": ParamDef((d_in, d_ff), dt),
        "w_down": ParamDef((d_ff, d_in), dt),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor, act: str
              ) -> torch.Tensor:
    """act: silu_glu | gelu_glu | gelu."""
    if act.endswith("_glu"):
        g = x @ p["w_gate"]
        u = x @ p["w_up"]
        g = F.silu(g) if act.startswith("silu") else _gelu(g)
        return (g * u) @ p["w_down"]
    return _gelu(x @ p["w_up"]) @ p["w_down"]


# ------------------------------------------------------------ embedding ----
def embed_defs(cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    # ~N(0, 1/sqrt(d)) so the sqrt(d) lookup scaling yields unit-variance
    # activations and tied logits stay O(1) at init
    d = {"tok": ParamDef((cfg.padded_vocab, cfg.d_model), dt,
                         scale=cfg.d_model ** -0.5)}
    if not cfg.tie_embeddings:
        d["out"] = ParamDef((cfg.d_model, cfg.padded_vocab), dt)
    return d


def embed_lookup(emb: torch.Tensor, tokens: torch.Tensor, d_model: int
                 ) -> torch.Tensor:
    """Gather rows, scaled by sqrt(d) rounded to the table's dtype."""
    scale = torch.tensor(d_model ** 0.5, dtype=emb.dtype).item()
    return emb[tokens] * scale


def logits_out(embed: Mapping[str, torch.Tensor], x: torch.Tensor,
               cfg: ModelConfig) -> torch.Tensor:
    """x: (..., D) -> logits (..., padded_vocab), through the tied table or
    the separate output matrix, with the optional tanh softcap."""
    if cfg.tie_embeddings:
        out = x @ embed["tok"].t()
    else:
        out = x @ embed["out"]
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        out = torch.tanh(out / c) * c
    return out
