"""The transformer: embedding, a stack of layers, final norm and output
projection. Each layer mixes over time by its kind, "attn" (full causal
attention; DeepSeek's multi-head latent attention where the config has
`use_mla`), "local_attn" (attention within `local_window`), "rglru"
(RecurrentGemma's recurrence) or "ssd" (Mamba-2's scan), then adds an MLP
or a mixture of experts where the config has one (`d_ff > 0`; the first
`first_dense_layers` layers stay dense). A prefix-LM (PaliGemma) takes
precomputed prefix embeddings ahead of the tokens, which every position
attends to. An encoder-decoder (Whisper, `n_enc_layers > 0`) runs a
non-causal encoder stack over precomputed frame embeddings, and each
decoder layer adds cross attention over the encoder's output after its
self attention.

The JAX package stacks layers of one signature and scans over them; here
the layers are an `nn.ModuleList` walked by a Python loop, and the JAX
layout (`stack_plan`) is kept only to carry its parameters across
(`interop.lm_params_from_arrays`). Built with `trainable=True` the
parameters require gradients and, where the config has `remat`, each
layer is recomputed in the backward pass (`torch.utils.checkpoint`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..device import DeviceLike, resolve_device
from .attention import (attn_defs, cross_attention, gqa_attention,
                        mla_attention, mla_defs)
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
    """Raise NotImplementedError for a layer kind the port lacks."""
    other = sorted(set(cfg.layer_kinds()) - set(KINDS))
    if other:
        raise NotImplementedError(f"layer kinds {other} {_NOT_PORTED}")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's config: attention layers, dense, as the JAX
    package builds it."""
    return dataclasses.replace(cfg, block_pattern=("attn",), n_experts=0,
                               first_dense_layers=0)


# ===================================================================== defs
def layer_defs(cfg: ModelConfig, kind: str = "attn",
               is_moe: bool = False, cross: bool = False) -> dict:
    """One layer of `kind`: norm1 and its mixer ("attn" for both attention
    kinds, MLA's projections where cfg.use_mla, "rglru" or "ssd"), then
    norm_cross + the cross attention's projections (`cross`, a decoder
    layer of an encoder-decoder), then norm2 + the mixture of experts
    (is_moe) or norm2 + MLP when d_ff > 0."""
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
    if cross:
        d["norm_cross"] = rmsnorm_def(cfg.d_model, dt)
        d["cross"] = attn_defs(cfg)
    if is_moe:
        d["norm2"] = rmsnorm_def(cfg.d_model, dt)
        d["moe"] = moe_defs(cfg)
    elif cfg.d_ff > 0:
        d["norm2"] = rmsnorm_def(cfg.d_model, dt)
        d["mlp"] = mlp_defs(cfg, cfg.d_model, cfg.d_ff)
    return d


def model_defs(cfg: ModelConfig) -> dict:
    """The port's parameter tree: `embed`, one entry of `layers` per layer
    in order, and `final_norm`; an encoder-decoder adds `encoder`, one
    entry per encoder layer, and `enc_norm`."""
    check_supported(cfg)
    kinds = cfg.layer_kinds()
    d = {
        "embed": embed_defs(cfg),
        "layers": [layer_defs(cfg, kinds[i], cfg.moe_layer(i),
                              cross=cfg.is_encdec)
                   for i in range(cfg.n_layers)],
        "final_norm": rmsnorm_def(cfg.d_model, cfg.pdtype()),
    }
    if cfg.is_encdec:
        enc = encoder_config(cfg)
        d["encoder"] = [layer_defs(enc) for _ in range(cfg.n_enc_layers)]
        d["enc_norm"] = rmsnorm_def(cfg.d_model, cfg.pdtype())
    return d


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
def _param(t: torch.Tensor, trainable: bool) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=trainable)


def _param_dict(d: dict, trainable: bool) -> nn.ParameterDict:
    return nn.ParameterDict({k: _param(v, trainable) for k, v in d.items()})


class MoEParams(nn.Module):
    """A layer's mixture-of-experts parameters: the router and the expert
    stacks, and the shared experts' MLP when the config has them. Read
    like the parameter tree's dict (`p["router"]`, `p["shared"]`)."""

    def __init__(self, params: dict, trainable: bool = False):
        super().__init__()
        self.experts = _param_dict(
            {k: v for k, v in params.items() if k != "shared"}, trainable)
        self.shared = (_param_dict(params["shared"], trainable)
                       if "shared" in params else None)

    def __getitem__(self, key: str):
        return self.shared if key == "shared" else self.experts[key]

    def param_tree(self) -> dict:
        d = dict(self.experts)
        if self.shared is not None:
            d["shared"] = dict(self.shared)
        return d


class DecoderLayer(nn.Module):
    """x + mix(norm1(x)), then, with cross attention (a decoder layer of an
    encoder-decoder), + cross(norm_cross(x), enc_out), then + mlp(norm2(x))
    or + moe(norm2(x)); mix is the layer kind's: attention (windowed for
    "local_attn"), the RG-LRU block or the SSD block, whose parameters are
    `attn`, `rglru` or `ssd` (the other two None). The encoder's layers
    are of this class too, run with causal=False."""

    def __init__(self, cfg: ModelConfig, kind: str, params: dict,
                 trainable: bool = False):
        super().__init__()
        self.cfg = cfg
        self.kind = kind
        self.norm1 = _param(params["norm1"], trainable)
        self.attn, self.rglru, self.ssd, self.cross, self.mlp = (
            _param_dict(params[k], trainable) if k in params else None
            for k in ("attn", "rglru", "ssd", "cross", "mlp"))
        self.norm_cross, self.norm2 = (
            _param(params[k], trainable) if k in params else None
            for k in ("norm_cross", "norm2"))
        self.moe = (MoEParams(params["moe"], trainable) if "moe" in params
                    else None)

    def param_tree(self) -> dict:
        """The layer's parameters under `layer_defs`' names (the tensors
        themselves, not copies)."""
        d = {"norm1": self.norm1}
        for k in ("attn", "rglru", "ssd"):
            if getattr(self, k) is not None:
                d[k] = dict(getattr(self, k))
        if self.cross is not None:
            d["norm_cross"] = self.norm_cross
            d["cross"] = dict(self.cross)
        if self.norm2 is not None:
            d["norm2"] = self.norm2
        if self.moe is not None:
            d["moe"] = self.moe.param_tree()
        elif self.mlp is not None:
            d["mlp"] = dict(self.mlp)
        return d

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
            impl: str = "auto", prefix_len: int = 0,
            causal: bool = True) -> torch.Tensor:
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
                             causal=causal, window=window,
                             prefix_len=prefix_len, impl=impl)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                impl: str = "auto", prefix_len: int = 0,
                causal: bool = True,
                enc_out: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """The layer's output and its MoE aux loss (None when dense).
        enc_out (B, S_enc, D): the encoder's output, which a layer with
        cross attention attends to (one flash launch, not causal)."""
        h = rmsnorm(x, self.norm1, self.cfg.norm_eps)
        x = x + self.mix(h, positions, impl, prefix_len, causal)
        if enc_out is not None and self.cross is not None:
            h = rmsnorm(x, self.norm_cross, self.cfg.norm_eps)
            x = x + cross_attention(self.cross, h, enc_out, self.cfg,
                                    impl=impl)
        return self.ffn(x)


class Transformer(nn.Module):
    """Decoder-only model (dense, mixture-of-experts, SSM or hybrid) or
    encoder-decoder (Whisper).

    params: a tree shaped like `model_defs(cfg)` (from `init_params` or
    `interop.lm_params_from_arrays`), moved to `device` and cast to each
    leaf's dtype; None draws one from `seed` on the device. device=None
    means the CUDA card and raises without one. Parameters require
    gradients only with `trainable=True` (then a given tree is copied,
    since training updates the parameters in place); inference leaves them
    frozen.
    """

    def __init__(self, cfg: ModelConfig, params: Optional[dict] = None, *,
                 device: DeviceLike = None, seed: int = 0,
                 trainable: bool = False):
        super().__init__()
        check_supported(cfg)
        dev = resolve_device(device)
        defs = model_defs(cfg)
        if params is None:
            gen = torch.Generator(device=dev).manual_seed(seed)
            params = init_params(defs, gen, dev)
        else:
            params = match_defs(defs, params, lambda d, t: torch.as_tensor(
                t).to(device=dev, dtype=d.dtype, copy=trainable))
        self.cfg = cfg
        self.trainable = trainable
        self.embed = _param_dict(params["embed"], trainable)
        self.layers = nn.ModuleList(
            DecoderLayer(cfg, kind, p, trainable)
            for kind, p in zip(cfg.layer_kinds(), params["layers"]))
        self.final_norm = _param(params["final_norm"], trainable)
        self.encoder = self.enc_norm = None
        if cfg.is_encdec:
            enc = encoder_config(cfg)
            self.encoder = nn.ModuleList(
                DecoderLayer(enc, "attn", p, trainable)
                for p in params["encoder"])
            self.enc_norm = _param(params["enc_norm"], trainable)

    @property
    def device(self) -> torch.device:
        return self.final_norm.device

    def param_tree(self) -> dict:
        """The parameters as a tree shaped like `model_defs(cfg)`, in its
        order, its leaves the module's own tensors (an optimizer updates
        them in place)."""
        d = {"embed": dict(self.embed),
             "layers": [layer.param_tree() for layer in self.layers],
             "final_norm": self.final_norm}
        if self.encoder is not None:
            d["encoder"] = [layer.param_tree() for layer in self.encoder]
            d["enc_norm"] = self.enc_norm
        return match_defs(model_defs(self.cfg), d, lambda _, t: t)

    def _run(self, layer: DecoderLayer, x: torch.Tensor, *args):
        """One layer, recomputed in the backward pass where the model
        trains under `cfg.remat` (the JAX package's jax.checkpoint)."""
        if self.trainable and self.cfg.remat and torch.is_grad_enabled():
            return checkpoint(layer, x, *args, use_reentrant=False)
        return layer(x, *args)

    def encode(self, enc_inputs, impl: str = "auto") -> torch.Tensor:
        """The encoder of an encoder-decoder: enc_inputs (B, S_enc,
        d_model) precomputed frame embeddings (Whisper's audio frontend is
        not modelled) through the encoder stack, not causal, over
        positions 0 .. S_enc - 1, then enc_norm. One flash launch a layer
        on the card."""
        cfg = self.cfg
        if self.encoder is None:
            raise ValueError(f"{cfg.name} has no encoder")
        e = torch.as_tensor(enc_inputs, device=self.device).to(cfg.dtype())
        positions = torch.arange(e.shape[1], device=self.device)
        for layer in self.encoder:
            e, _ = self._run(layer, e, positions, impl, 0, False)
        return rmsnorm(e, self.enc_norm, cfg.norm_eps)

    def forward(self, tokens, prefix_embeds=None, impl: str = "auto",
                enc_inputs=None, return_hidden: bool = False
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Prefill (or training) forward. tokens: (B, S) integer tensor or
        array; prefix_embeds: None or (B, P, d_model) precomputed
        embeddings (a VLM's image patches) placed ahead of the tokens, not
        scaled as the token embeddings are, which every position attends
        to (the prefix-LM mask); positions run over all P + S. enc_inputs:
        (B, S_enc, d_model) frame embeddings, required by an
        encoder-decoder (run through `encode`; each decoder layer attends
        to its output).
        Returns (logits (B, P + S, padded_vocab) in the compute dtype,
        aux): aux is the float32 sum of the MoE layers' load-balance
        losses (0 for a dense model). With return_hidden, the hidden state
        before final_norm (B, P + S, d_model) in place of the logits (the
        chunked loss applies final_norm itself). Each layer's time mixing
        calls its kernel's wrapper once on the card (impl "auto" or
        "cuda": flash attention, one launch, and one more for cross
        attention; `ssd_scan` or `rglru_scan`, two); impl="ref" runs their
        plain versions."""
        cfg = self.cfg
        tokens = torch.as_tensor(tokens, device=self.device).long()
        x = embed_lookup(self.embed["tok"], tokens, cfg.d_model)
        x = x.to(cfg.dtype())
        prefix_len = 0
        if prefix_embeds is not None:
            prefix = torch.as_tensor(prefix_embeds, device=self.device)
            x = torch.cat([prefix.to(cfg.dtype()), x], dim=1)
            prefix_len = prefix.shape[1]
        enc_out = None
        if cfg.is_encdec:
            if enc_inputs is None:
                raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                                 f"enc_inputs (B, S_enc, {cfg.d_model})")
            enc_out = self.encode(enc_inputs, impl)
        positions = torch.arange(x.shape[1], device=self.device)
        aux = torch.zeros((), dtype=torch.float32, device=self.device)
        for layer in self.layers:
            x, a = self._run(layer, x, positions, impl, prefix_len, True,
                             enc_out)
            if a is not None:
                aux = aux + a
        if return_hidden:
            return x, aux
        x = rmsnorm(x, self.final_norm, cfg.norm_eps)
        return logits_out(self.embed, x, cfg), aux
