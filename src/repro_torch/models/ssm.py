"""Mamba-2 SSD (state-space duality) block: the chunked prefill form and
the O(1) recurrent decode form.

Within a chunk of Q steps the token mixing is the quadratic masked form;
across chunks an (H, P, N) state is carried. B and C are shared by the
heads (n_groups = 1). The scan runs through `kernels.ssd_scan`: the
hand-written CUDA kernel for CUDA tensors, its plain version (the JAX
package's `_ssd_scan`, line for line) for CPU tensors; where an input
needs a gradient, through `SSDScan`, whose backward is the scan's backward
kernel on the card and its closed-form plain backward elsewhere. The
dtype order is the JAX package's: projections and the causal conv in the
activation dtype, dt, the scan and the state in float32.
"""
from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch
import torch.nn.functional as F

from ..kernels import resolve_impl
from ..kernels.ssd_scan import SSDScan, ssd_scan
from .blocks import rmsnorm
from .config import ModelConfig
from .param import ParamDef


class SSDCache(NamedTuple):
    h: torch.Tensor          # (B, H, P, N) float32 state
    conv_x: torch.Tensor     # (B, k-1, d_inner)
    conv_b: torch.Tensor     # (B, k-1, N)
    conv_c: torch.Tensor     # (B, k-1, N)


def ssd_defs(cfg: ModelConfig) -> dict:
    dt = cfg.pdtype()
    D, DI, N, H = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    return {
        "w_z": ParamDef((D, DI), dt),
        "w_x": ParamDef((D, DI), dt),
        "w_b": ParamDef((D, N), dt),
        "w_c": ParamDef((D, N), dt),
        "w_dt": ParamDef((D, H), dt),
        "dt_bias": ParamDef((H,), torch.float32, init="zeros"),
        "a_log": ParamDef((H,), torch.float32, init="zeros"),
        "d_skip": ParamDef((H,), torch.float32, init="ones"),
        "conv_x": ParamDef((k, DI), dt, scale=0.5),
        "conv_b": ParamDef((k, N), dt, scale=0.5),
        "conv_c": ParamDef((k, N), dt, scale=0.5),
        "norm": ParamDef((DI,), dt, init="zeros"),
        "w_out": ParamDef((DI, D), dt),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: x (B, S, C), w (k, C), summed tap by tap in
    x's dtype as the JAX package sums it."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = torch.zeros_like(x)
    for i in range(k):
        out = out + pad[:, i:i + x.shape[1], :] * w[i]
    return out


def ssd_apply(p: Mapping[str, torch.Tensor], x: torch.Tensor,
              cfg: ModelConfig, impl: str = "auto") -> torch.Tensor:
    """Prefill form. x: (B, S, D) -> (B, S, D); one `ssd_scan` call."""
    B, S, D = x.shape
    H, P = cfg.ssm_heads, cfg.ssm_headdim

    z = x @ p["w_z"]
    xi = F.silu(_causal_conv(x @ p["w_x"], p["conv_x"]))
    b = F.silu(_causal_conv(x @ p["w_b"], p["conv_b"]))
    c = F.silu(_causal_conv(x @ p["w_c"], p["conv_c"]))
    dt_h = F.softplus((x @ p["w_dt"]).float() + p["dt_bias"])

    xh = xi.reshape(B, S, H, P)
    args = (xh.contiguous(), b.contiguous(), c.contiguous(), dt_h,
            p["a_log"])
    if torch.is_grad_enabled() and any(t.requires_grad for t in args):
        y, _ = SSDScan.apply(*args, None, cfg.ssm_chunk,
                             resolve_impl(impl, xh))
    else:
        y, _ = ssd_scan(*args, cfg.ssm_chunk, impl=impl)
    y = y + xh * p["d_skip"].to(x.dtype)[None, None, :, None]
    y = y.reshape(B, S, H * P)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    return y @ p["w_out"]


def ssd_init_cache(cfg: ModelConfig, batch: int, dtype: torch.dtype,
                   device: torch.device) -> SSDCache:
    H, P, N = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    k = cfg.ssm_conv
    return SSDCache(
        h=torch.zeros((batch, H, P, N), dtype=torch.float32, device=device),
        conv_x=torch.zeros((batch, k - 1, cfg.d_inner), dtype=dtype,
                           device=device),
        conv_b=torch.zeros((batch, k - 1, N), dtype=dtype, device=device),
        conv_c=torch.zeros((batch, k - 1, N), dtype=dtype, device=device))


def _conv_step(prev: torch.Tensor, new: torch.Tensor, w: torch.Tensor):
    """prev: (B, k-1, C); new: (B, C); w: (k, C). The conv's output at the
    new step and the window kept for the next."""
    win = torch.cat([prev, new[:, None]], dim=1)              # (B, k, C)
    return torch.einsum("bkc,kc->bc", win, w), win[:, 1:]


def ssd_step(p: Mapping[str, torch.Tensor], x: torch.Tensor,
             cache: SSDCache, cfg: ModelConfig
             ) -> Tuple[torch.Tensor, SSDCache]:
    """O(1) decode. x: (B, 1, D). The state moves one step through
    `ssd_scan` at S = 1 from the cached state (the kernel on the card), in
    float32 as the JAX package's step runs it: h = h decay + dt x B^T,
    y = C . h + d_skip x."""
    B = x.shape[0]
    H, P = cfg.ssm_heads, cfg.ssm_headdim
    xt = x[:, 0]

    z = xt @ p["w_z"]
    xi, cx = _conv_step(cache.conv_x, xt @ p["w_x"], p["conv_x"])
    xi = F.silu(xi)
    b, cb = _conv_step(cache.conv_b, xt @ p["w_b"], p["conv_b"])
    b = F.silu(b)
    c, cc = _conv_step(cache.conv_c, xt @ p["w_c"], p["conv_c"])
    c = F.silu(c)
    dt_h = F.softplus((xt @ p["w_dt"]).float() + p["dt_bias"])  # (B, H)

    xh = xi.reshape(B, H, P).float()
    y, h = ssd_scan(xh[:, None].contiguous(), b.float()[:, None].contiguous(),
                    c.float()[:, None].contiguous(), dt_h[:, None],
                    p["a_log"], cfg.ssm_chunk, h0=cache.h)
    y = y[:, 0] + xh * p["d_skip"][None, :, None]
    y = y.reshape(B, H * P).to(x.dtype)
    y = rmsnorm(y * F.silu(z), p["norm"], cfg.norm_eps)
    out = (y @ p["w_out"])[:, None, :]
    return out, SSDCache(h=h, conv_x=cx, conv_b=cb, conv_c=cc)
