"""The dense decoder: embedding, a stack of attention + MLP layers, final
norm and output projection.

The JAX package stacks layers of one signature and scans over them; here
the layers are an `nn.ModuleList` walked by a Python loop, and the JAX
layout (`stack_plan`) is kept only to carry its parameters across
(`interop.lm_params_from_arrays`). Mixture-of-experts, SSD, RG-LRU, local
windows, MLA, encoder-decoder and prefix-LM models are not ported yet
(ROADMAP.md, Queue 1 item 10): building one raises NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .attention import attn_defs, gqa_attention
from .blocks import (embed_defs, embed_lookup, logits_out, mlp_apply,
                     mlp_defs, rmsnorm, rmsnorm_def)
from .config import ModelConfig
from .param import init_params, match_defs

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1 item 10)"


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.n_experts:
        raise NotImplementedError(f"mixture-of-experts (models/moe.py) "
                                  f"{_NOT_PORTED}")
    if cfg.use_mla:
        raise NotImplementedError(f"multi-head latent attention "
                                  f"{_NOT_PORTED}")
    if cfg.is_encdec:
        raise NotImplementedError(f"encoder-decoder models {_NOT_PORTED}")
    if cfg.prefix_len:
        raise NotImplementedError(f"prefix embeddings (prefix-LM) "
                                  f"{_NOT_PORTED}")
    other = sorted(set(cfg.layer_kinds()) - {"attn"})
    if other:
        raise NotImplementedError(f"layer kinds {other} {_NOT_PORTED}")


# ===================================================================== defs
def layer_defs(cfg: ModelConfig) -> dict:
    """One "attn" layer: norm1, attention, and norm2 + MLP when d_ff > 0."""
    dt = cfg.pdtype()
    d = {"norm1": rmsnorm_def(cfg.d_model, dt), "attn": attn_defs(cfg)}
    if cfg.d_ff > 0:
        d["norm2"] = rmsnorm_def(cfg.d_model, dt)
        d["mlp"] = mlp_defs(cfg, cfg.d_model, cfg.d_ff)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    """The port's parameter tree: `embed`, one entry of `layers` per layer
    in order, and `final_norm`."""
    check_supported(cfg)
    return {
        "embed": embed_defs(cfg),
        "layers": [layer_defs(cfg) for _ in range(cfg.n_layers)],
        "final_norm": rmsnorm_def(cfg.d_model, cfg.pdtype()),
    }


@dataclasses.dataclass(frozen=True)
class StackPlan:
    """How the JAX package maps n_layers onto scanned/unrolled groups."""
    head: Tuple[int, ...]          # unrolled layer indices (prefix)
    repeats: int                   # scan length
    pattern: Tuple[int, ...]       # layer idx offsets inside one scan step
    tail: Tuple[int, ...]          # unrolled layer indices (suffix)


def stack_plan(cfg: ModelConfig, n_layers: int, first_dense: int
               ) -> StackPlan:
    pat = len(cfg.block_pattern)
    head = tuple(range(first_dense))
    rest = n_layers - first_dense
    r = rest // pat if cfg.scan_layers else 0
    tail_start = first_dense + r * pat
    return StackPlan(
        head=head, repeats=r, pattern=tuple(range(pat)),
        tail=tuple(range(tail_start, n_layers)))


# =================================================================== module
def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


def _frozen_dict(d: dict) -> nn.ParameterDict:
    return nn.ParameterDict({k: _frozen(v) for k, v in d.items()})


class DecoderLayer(nn.Module):
    """x + attn(norm1(x)), then + mlp(norm2(x))."""

    def __init__(self, cfg: ModelConfig, params: dict):
        super().__init__()
        self.cfg = cfg
        self.norm1 = _frozen(params["norm1"])
        self.attn = _frozen_dict(params["attn"])
        self.norm2 = _frozen(params["norm2"]) if "norm2" in params else None
        self.mlp = _frozen_dict(params["mlp"]) if "mlp" in params else None

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
        cfg = self.cfg
        h = rmsnorm(x, self.norm1, cfg.norm_eps)
        x = x + gqa_attention(self.attn, h, cfg, positions=positions,
                              impl=impl)
        if self.mlp is not None:
            h = rmsnorm(x, self.norm2, cfg.norm_eps)
            x = x + mlp_apply(self.mlp, h, cfg.act)
        return x


class Transformer(nn.Module):
    """Decoder-only dense transformer for inference.

    params: a tree shaped like `model_defs(cfg)` (from `init_params` or
    `interop.lm_params_from_arrays`), moved to `device` and cast to each
    leaf's dtype; None draws one from `seed` on the device. device=None
    means the CUDA card and raises without one. Parameters do not require
    gradients: training is not ported yet.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 device: DeviceLike = None, seed: int = 0):
        super().__init__()
        dev = resolve_device(device)
        defs = model_defs(cfg)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(defs, gen, dev)
        else:
            params = match_defs(defs, params, lambda d, t: torch.as_tensor(
                t).to(device=dev, dtype=d.dtype))
        self.cfg = cfg
        self.embed = _frozen_dict(params["embed"])
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, p) for p in params["layers"])
        self.final_norm = _frozen(params["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, tokens, impl: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill forward. tokens: (B, S) integer tensor or array.
        Returns (logits (B, S, padded_vocab) in the compute dtype, aux = 0).
        Each layer's attention launches the flash kernel once on the card
        (impl "auto" or "cuda"); impl="ref" runs its plain version."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = embed_lookup(self.embed["tok"], tokens, cfg.d_model)
        x = x.to(cfg.dtype())
        positions = torch.arange(tokens.shape[1], device=self.device)
        for layer in self.layers:
            x = layer(x, positions, impl)
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        return logits_out(self.embed, x, cfg), aux
