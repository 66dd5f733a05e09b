"""RG-LRU recurrent block (RecurrentGemma / Griffin).

Temporal-mixing block: two width-W branches; the recurrent branch runs a
causal conv then the Real-Gated LRU; the gate branch is GeLU; merged by
elementwise product and projected out. The gates and the first-order
linear recurrence run through `kernels.rglru_scan`: the hand-written CUDA
kernel for CUDA tensors (gates fused, a chunked sequential scan), its
plain version (the JAX package's `_lru_coeffs` and a doubling scan, the
algebra of its `associative_scan`) for CPU tensors. The two gate products
u @ w_a and u @ w_i stay matrix products. Where an input requires a
gradient the recurrence goes through `RGLRUScan`, whose backward is the
backward kernel (or its plain version); otherwise the forward is called
directly, as `attention` does (`apply` costs the host microseconds a
call).
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

from ..kernels import resolve_impl
from ..kernels.rglru_scan import RGLRUScan, rglru_scan
from .blocks import _gelu
from .config import ModelConfig
from .param import ParamDef
from .ssm import _causal_conv


class LRUCache(NamedTuple):
    h: torch.Tensor          # (B, W) float32
    conv: torch.Tensor       # (B, k-1, W)


def rglru_defs(cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    D, W = cfg.d_model, cfg.lru_width_
    k = cfg.ssm_conv
    return {
        "w_in": ParamDef((D, W), dt),
        "w_gate_branch": ParamDef((D, W), dt),
        "conv": ParamDef((k, W), dt, scale=0.5),
        "w_a": ParamDef((W, W), dt, scale=0.02),
        "b_a": ParamDef((W,), torch.float32, init="zeros"),
        "w_i": ParamDef((W, W), dt, scale=0.02),
        "b_i": ParamDef((W,), torch.float32, init="zeros"),
        "lam": ParamDef((W,), torch.float32, init="ones"),
        "w_out": ParamDef((W, D), dt),
    }


def _recurrence(p: Mapping[str, torch.Tensor], u: torch.Tensor,
                h0, impl: str = "auto") -> torch.Tensor:
    """h (B, S, W) float32 from the conv output u (B, S, W);
    differentiable in u, the gate products and the biases."""
    u = u.contiguous()
    args = (u, (u @ p["w_a"]).float(), (u @ p["w_i"]).float(), p["b_a"],
            p["b_i"], p["lam"], h0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in args):
        return RGLRUScan.apply(*args, resolve_impl(impl, u))
    return rglru_scan(*args, impl=impl)


def rglru_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
                cfg: ModelConfig, impl: str = "auto") -> torch.Tensor:
    """Prefill. x: (B, S, D) -> (B, S, D); one `rglru_scan` call."""
    u = _causal_conv(x @ p["w_in"], p["conv"])
    h = _recurrence(p, u, None, impl)
    gate = _gelu((x @ p["w_gate_branch"]).float())
    y = (h * gate).to(x.dtype)
    return y @ p["w_out"]


def rglru_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                     device: torch.device) -> LRUCache:
    W, k = cfg.lru_width_, cfg.ssm_conv
    return LRUCache(
        h=torch.zeros((batch, W), dtype=torch.float32, device=device),
        conv=torch.zeros((batch, k - 1, W), dtype=dtype, device=device))


def rglru_step(p: Mapping[str, torch.Tensor], x: torch.Tensor,
               cache: LRUCache, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, LRUCache]:
    """O(1) decode. x: (B, 1, D); the recurrence moves one step through
    `rglru_scan` from the cached state (the kernel on the card)."""
    xt = x[:, 0]
    u_raw = xt @ p["w_in"]
    win = torch.cat([cache.conv, u_raw[:, None]], dim=1)
    u = torch.einsum("bkc,kc->bc", win, p["conv"])
    h = _recurrence(p, u[:, None], cache.h)[:, 0]
    gate = _gelu((xt @ p["w_gate_branch"]).float())
    y = (h * gate).to(x.dtype)
    return (y @ p["w_out"])[:, None, :], LRUCache(h=h, conv=win[:, 1:])
