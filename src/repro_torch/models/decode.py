"""Autoregressive decode for the decoder (dense or mixture-of-experts):
the KV cache and the single-token step.

    logits, cache = decode_step(model, token, cache)

with `cache["length"]` counting tokens *including* the current one after
the step. The cache is updated in place: each step writes its keys and
values into the preallocated (B, Hkv, T_max, dh) buffers and returns the
same dict (the JAX package returns a new pytree instead).

Cache kinds: only "attn" (the full KV cache with rope'd keys and the
absolute position held in each slot) is ported; ring caches for local
windows, MLA's latent cache and the recurrent states wait for their layers
(ROADMAP.md, Queue 1 item 10).
"""
from __future__ import annotations

from typing import Mapping

import torch

from ..device import DeviceLike, resolve_device
from .attention import NEG_INF, _mask, gqa_project
from .blocks import embed_lookup, logits_out, rmsnorm, rope
from .config import ModelConfig
from .transformer import DecoderLayer, Transformer, check_supported


def init_cache(cfg: ModelConfig, batch: int, t_max: int,
               device: DeviceLike = None) -> dict:
    """{"layers": one {"k", "v", "slot_pos"} per layer, "length": 0}.
    k, v: (batch, Hkv, t_max, dh) in the compute dtype; slot_pos: (t_max,)
    int32, the position held in each slot, -1 while empty."""
    check_supported(cfg)
    dev = resolve_device(device)
    shape = (batch, cfg.n_kv_heads, t_max, cfg.head_dim_)
    layers = [{
        "k": torch.zeros(shape, dtype=cfg.dtype(), device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype(), device=dev),
        "slot_pos": torch.full((t_max,), -1, dtype=torch.int32, device=dev),
    } for _ in range(cfg.n_layers)]
    return {"layers": layers, "length": 0}


def _attn_step(p: Mapping[str, torch.Tensor], h: torch.Tensor,
               cache_l: dict, cfg: ModelConfig, length: int) -> torch.Tensor:
    """h: (B, 1, D) normed input. Writes the slot of position length - 1
    into cache_l and returns the attention output (B, 1, D)."""
    B = h.shape[0]
    pos = length - 1                                    # current position
    t_cache = cache_l["k"].shape[2]
    if pos >= t_cache:
        raise ValueError(f"KV cache full: position {pos} needs more than "
                         f"{t_cache} slots")
    q, k, v = gqa_project(p, h, cfg)                    # (B,*,1,dh)
    position = torch.arange(pos, pos + 1, device=h.device)
    q = rope(q, position, cfg.rope_theta)
    k = rope(k, position, cfg.rope_theta)
    kc, vc, slot_pos = cache_l["k"], cache_l["v"], cache_l["slot_pos"]
    kc[:, :, pos] = k[:, :, 0]
    vc[:, :, pos] = v[:, :, 0]
    slot_pos[pos] = pos

    # mask from absolute slot positions
    dh = cfg.head_dim_
    qg = q.reshape(B, cfg.n_kv_heads, -1, dh)
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(), kc.float()) * (dh ** -0.5)
    ok = (slot_pos >= 0) & _mask(position, slot_pos, True, None, 0)
    s = s.masked_fill(~ok, NEG_INF)
    p_att = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p_att, vc.float())
    o = o.reshape(B, 1, cfg.n_heads * dh).to(h.dtype)
    return o @ p["wo"]


def _layer_step(layer: DecoderLayer, cache_l: dict, x: torch.Tensor,
                length: int) -> torch.Tensor:
    cfg = layer.cfg
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    x = x + _attn_step(layer.attn, h, cache_l, cfg, length)
    # the MoE layer routes the B tokens of the step as one group, as the
    # JAX package's decode step does; its aux loss is dropped
    return layer.ffn(x)[0]


def decode_step(model: Transformer, token, cache: dict):
    """token: (B,) integers. Returns (logits (B, padded_vocab), cache),
    the cache updated in place."""
    cfg = model.cfg
    length = cache["length"] + 1
    token = torch.as_tensor(token, device=model.device).long()
    x = embed_lookup(model.embed["tok"], token[:, None], cfg.d_model)
    x = x.to(cfg.dtype())
    for layer, cache_l in zip(model.layers, cache["layers"]):
        x = _layer_step(layer, cache_l, x, length)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    cache["length"] = length
    return logits_out(model.embed, x, cfg)[:, 0], cache
