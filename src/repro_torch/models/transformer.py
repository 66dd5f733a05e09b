"""The decoder: embedding, a stack of layers, final norm and output
projection. Each layer mixes over time by its kind, "attn" (full causal
attention; DeepSeek's multi-head latent attention where the config has
`use_mla`), "local_attn" (attention within `local_window`), "rglru"
(RecurrentGemma's recurrence) or "ssd" (Mamba-2's scan), then adds an MLP
or a mixture of experts where the config has one (`d_ff > 0`; the first
`first_dense_layers` layers stay dense). A prefix-LM (PaliGemma) takes
precomputed prefix embeddings ahead of the tokens, which every position
attends to.

The JAX package stacks layers of one signature and scans over them; here
the layers are an `nn.ModuleList` walked by a Python loop, and the JAX
layout (`stack_plan`) is kept only to carry its parameters across
(`interop.lm_params_from_arrays`). Encoder-decoder models are not ported
yet (ROADMAP.md, Queue 1 item 10): building one raises
NotImplementedError.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from ..device import DeviceLike, resolve_device
from .attention import attn_defs, gqa_attention, mla_attention, mla_defs
from .blocks import (embed_defs, embed_lookup, logits_out, mlp_apply,
                     mlp_defs, rmsnorm, rmsnorm_def)
from .config import ModelConfig
from .moe import moe_apply, moe_defs
from .param import init_params, match_defs
from .rglru import rglru_apply, rglru_defs
from .ssm import ssd_apply, ssd_defs

_NOT_PORTED = "is not ported yet (ROADMAP.md, Queue 1 item 10)"
KINDS = ("attn", "local_attn", "rglru", "ssd")


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError for what the port does not run yet."""
    if cfg.is_encdec:
        raise NotImplementedError(f"encoder-decoder models {_NOT_PORTED}")
    other = sorted(set(cfg.layer_kinds()) - set(KINDS))
    if other:
        raise NotImplementedError(f"layer kinds {other} {_NOT_PORTED}")


# ===================================================================== defs
def layer_defs(cfg: ModelConfig, kind: str = "attn",
               is_moe: bool = False) -> dict:
    """One layer of `kind`: norm1 and its mixer ("attn" for both attention
    kinds, MLA's projections where cfg.use_mla, "rglru" or "ssd"), then
    norm2 + the mixture of experts (is_moe) or norm2 + MLP when
    d_ff > 0."""
    dt = cfg.pdtype()
    d = {"norm1": rmsnorm_def(cfg.d_model, dt)}
    if kind in ("attn", "local_attn"):
        d["attn"] = mla_defs(cfg) if cfg.use_mla else attn_defs(cfg)
    elif kind == "rglru":
        d["rglru"] = rglru_defs(cfg)
    elif kind == "ssd":
        d["ssd"] = ssd_defs(cfg)
    else:
        raise ValueError(f"unknown layer kind {kind!r}")
    if is_moe:
        d["norm2"] = rmsnorm_def(cfg.d_model, dt)
        d["moe"] = moe_defs(cfg)
    elif cfg.d_ff > 0:
        d["norm2"] = rmsnorm_def(cfg.d_model, dt)
        d["mlp"] = mlp_defs(cfg, cfg.d_model, cfg.d_ff)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    """The port's parameter tree: `embed`, one entry of `layers` per layer
    in order, and `final_norm`."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    return {
        "embed": embed_defs(cfg),
        "layers": [layer_defs(cfg, kinds[i], cfg.moe_layer(i))
                   for i in range(cfg.n_layers)],
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


class MoEParams(nn.Module):
    """A layer's mixture-of-experts parameters: the router and the expert
    stacks, and the shared experts' MLP when the config has them. Read
    like the parameter tree's dict (`p["router"]`, `p["shared"]`)."""

    def __init__(self, params: dict):
        super().__init__()
        self.experts = _frozen_dict(
            {k: v for k, v in params.items() if k != "shared"})
        self.shared = (_frozen_dict(params["shared"]) if "shared" in params
                       else None)

    def __getitem__(self, key: str):
        return self.shared if key == "shared" else self.experts[key]


class DecoderLayer(nn.Module):
    """x + mix(norm1(x)), then + mlp(norm2(x)) or + moe(norm2(x)); mix is
    the layer kind's: attention (windowed for "local_attn"), the RG-LRU
    block or the SSD block, whose parameters are `attn`, `rglru` or `ssd`
    (the other two None)."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm1 = _frozen(params["norm1"])
        self.attn, self.rglru, self.ssd = (
            _frozen_dict(params[k]) if k in params else None
            for k in ("attn", "rglru", "ssd"))
        self.norm2 = _frozen(params["norm2"]) if "norm2" in params else None
        self.mlp = _frozen_dict(params["mlp"]) if "mlp" in params else None
        self.moe = MoEParams(params["moe"]) if "moe" in params else None

    def ffn(self, x: torch.Tensor
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """x + the layer's MLP or mixture of experts of norm2(x), and the
        MoE aux loss (None for a dense layer)."""
        cfg = self.cfg
        if self.moe is not None:
            h = rmsnorm(x, self.norm2, cfg.norm_eps)
            h, aux = moe_apply(self.moe, h, cfg)
            return x + h, aux
        if self.mlp is not None:
            h = rmsnorm(x, self.norm2, cfg.norm_eps)
            x = x + mlp_apply(self.mlp, h, cfg.act)
        return x, None

    def mix(self, h: torch.Tensor, positions: torch.Tensor,
            impl: str = "auto", prefix_len: int = 0) -> torch.Tensor:
        """The time mixing of the normed input h (B, S, D): one flash
        launch, `ssd_scan` or `rglru_scan` call on the card. MLA takes no
        prefix, as in the JAX package."""
        cfg = self.cfg
        if self.kind == "rglru":
            return rglru_apply(self.rglru, h, cfg, impl=impl)
        if self.kind == "ssd":
            return ssd_apply(self.ssd, h, cfg, impl=impl)
        if cfg.use_mla:
            return mla_attention(self.attn, h, cfg, positions=positions,
                                 impl=impl)
        window = cfg.local_window if self.kind == "local_attn" else None
        return gqa_attention(self.attn, h, cfg, positions=positions,
                             window=window, prefix_len=prefix_len,
                             impl=impl)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: str = "auto", prefix_len: int = 0
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The layer's output and its MoE aux loss (None when dense)."""
        h = rmsnorm(x, self.norm1, self.cfg.norm_eps)
        x = x + self.mix(h, positions, impl, prefix_len)
        return self.ffn(x)


class Transformer(nn.Module):
    """Decoder-only model (dense, mixture-of-experts, SSM or hybrid) for
    inference.

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
            DecoderLayer(cfg, kind, p)
            for kind, p in zip(cfg.layer_kinds(), params["layers"]))
        self.final_norm = _frozen(params["final_norm"])

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def forward(self, tokens, prefix_embeds=None, impl: str = "auto"
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill forward. tokens: (B, S) integer tensor or array;
        prefix_embeds: None or (B, P, d_model) precomputed embeddings (a
        VLM's image patches) placed ahead of the tokens, not scaled as the
        token embeddings are, which every position attends to (the
        prefix-LM mask); positions run over all P + S.
        Returns (logits (B, P + S, padded_vocab) in the compute dtype,
        aux): aux is the float32 sum of the MoE layers' load-balance
        losses (0 for a dense model). Each layer's time mixing calls its
        kernel's wrapper once on the card (impl "auto" or "cuda": flash
        attention, one launch; `ssd_scan` or `rglru_scan`, two);
        impl="ref" runs their plain versions."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = embed_lookup(self.embed["tok"], tokens, cfg.d_model)
        x = x.to(cfg.dtype())
        prefix_len = 0
        if prefix_embeds is not None:
            prefix = torch.as_tensor(prefix_embeds, device=self.device)
            x = torch.cat([prefix.to(cfg.dtype()), x], dim=1)
            prefix_len = prefix.shape[1]
        positions = torch.arange(x.shape[1], device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            x, a = layer(x, positions, impl, prefix_len)
            if a is not None:
                aux = aux + a
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return logits_out(self.embed, x, cfg), aux
