"""Autoregressive decode for every ported layer kind: the caches and the
single-token step.

    logits, cache = decode_step(model, token, cache)

with `cache["length"]` counting tokens *including* the current one after
the step. The cache is updated in place: each step writes its keys and
values into the preallocated buffers, and the recurrent states are
replaced, in the same dict that is returned (the JAX package returns a new
pytree instead).

Cache kinds, one dict a layer:
  attn        full KV cache (B, Hkv, t_max, dh) with rope'd keys and the
              absolute position held in each slot; past t_max each step
              overwrites the last slot, as the JAX package's clamped
              dynamic_update_slice does
  local_attn  ring KV cache of min(t_max, local_window) slots, slot
              pos % t_cache, and the slot-position vector; never full
  mla         latent cache c (B, t_max, kv_lora_rank) and rope'd key cache
              kr (B, t_max, qk_rope_dim) of DeepSeek's attention layers
              (either kind); past t_max the last slot is overwritten, as
              for "attn"
  ssd         SSDCache's fields: the (B, H, P, N) state and the conv tails
  rglru       LRUCache's fields: the (B, W) state and the conv tail
An encoder-decoder's cache also holds `cross`, one {"k", "v"} per decoder
layer: the encoder output's keys and values (B, Hkv, S_enc, dh), built
once by `init_cache` and never updated. The decode path takes no prefix,
as in the JAX package: a prefix-LM's prefix enters through the prefill
forward only.
"""
from __future__ import annotations

from typing import Mapping, Optional

import torch

from ..device import DeviceLike, resolve_device
from .attention import (NEG_INF, _mask, cross_kv, decode_attn, gqa_project,
                        mla_decode)
from .blocks import embed_lookup, logits_out, rmsnorm, rope
from .config import ModelConfig
from .rglru import LRUCache, rglru_init_cache, rglru_step
from .ssm import SSDCache, ssd_init_cache, ssd_step
from .transformer import DecoderLayer, Transformer, check_supported


def _layer_cache(cfg: ModelConfig, kind: str, batch: int, t_max: int,
                 dev: torch.device) -> dict:
    if kind == "ssd":
        return ssd_init_cache(cfg, batch, cfg.dtype(), dev)._asdict()
    if kind == "rglru":
        return rglru_init_cache(cfg, batch, cfg.dtype(), dev)._asdict()
    if cfg.use_mla:
        return {
            "c": torch.zeros((batch, t_max, cfg.kv_lora_rank),
                             dtype=cfg.dtype(), device=dev),
            "kr": torch.zeros((batch, t_max, cfg.qk_rope_dim),
                              dtype=cfg.dtype(), device=dev),
        }
    t = min(t_max, cfg.local_window) if kind == "local_attn" else t_max
    shape = (batch, cfg.n_kv_heads, t, cfg.head_dim_)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype(), device=dev),
        "v": torch.zeros(shape, dtype=cfg.dtype(), device=dev),
        "slot_pos": torch.full((t,), -1, dtype=torch.int32, device=dev),
    }


def init_cache(cfg: ModelConfig, batch: int, t_max: int,
               device: DeviceLike = None,
               enc_out: Optional[torch.Tensor] = None,
               model: Optional[Transformer] = None) -> dict:
    """{"layers": one cache dict per layer, by its kind, "length": 0}.
    Attention caches: k, v (batch, Hkv, slots, dh) in the compute dtype
    and slot_pos (slots,) int32, the position held in each slot, -1 while
    empty; t_max slots for "attn", min(t_max, local_window) for the ring
    of "local_attn". MLA's: c (batch, t_max, kv_lora_rank) and kr (batch,
    t_max, qk_rope_dim) in the compute dtype. Recurrent states are
    float32, conv tails in the compute dtype.
    An encoder-decoder needs enc_out (batch, S_enc, d_model), the
    encoder's output, and the model whose decoder layers' cross
    projections make `cross`: {"k", "v"} (batch, Hkv, S_enc, dh) per
    layer, computed here once."""
    check_supported(cfg)
    dev = resolve_device(device)
    layers = [_layer_cache(cfg, kind, batch, t_max, dev)
              for kind in cfg.layer_kinds()]
    cache = {"layers": layers, "length": 0}
    if cfg.is_encdec:
        if enc_out is None or model is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its cache "
                             f"needs enc_out and the model")
        enc_out = torch.as_tensor(enc_out, device=dev).to(cfg.dtype())
        with torch.no_grad():
            cache["cross"] = [
                dict(zip(("k", "v"), cross_kv(layer.cross, enc_out, cfg)))
                for layer in model.layers]
    return cache


def _attn_step(p: Mapping[str, torch.Tensor], h: torch.Tensor,
               cache_l: dict, cfg: ModelConfig, length: int,
               kind: str) -> torch.Tensor:
    """h: (B, 1, D) normed input. Writes the slot of position length - 1
    into cache_l (slot pos % slots in the ring of "local_attn"; in a full
    "attn" cache or MLA's latent cache the last slot, min(pos, slots - 1),
    as the JAX package's dynamic_update_slice clamps its start) and
    returns the attention output (B, 1, D)."""
    if cfg.use_mla:
        return mla_decode(p, h, cfg, c_cache=cache_l["c"],
                          kr_cache=cache_l["kr"], length=length)
    B = h.shape[0]
    pos = length - 1                                    # current position
    t_cache = cache_l["k"].shape[2]
    window = cfg.local_window if kind == "local_attn" else None
    slot = pos % t_cache if window is not None else min(pos, t_cache - 1)
    q, k, v = gqa_project(p, h, cfg)                    # (B,*,1,dh)
    position = torch.arange(pos, pos + 1, device=h.device)
    q = rope(q, position, cfg.rope_theta)
    k = rope(k, position, cfg.rope_theta)
    kc, vc, slot_pos = cache_l["k"], cache_l["v"], cache_l["slot_pos"]
    kc[:, :, slot] = k[:, :, 0]
    vc[:, :, slot] = v[:, :, 0]
    slot_pos[slot] = pos

    # mask from absolute slot positions (the ring's too)
    dh = cfg.head_dim_
    qg = q.reshape(B, cfg.n_kv_heads, -1, dh)
    s = torch.einsum("bhgd,bhtd->bhgt", qg.float(), kc.float()) * (dh ** -0.5)
    ok = (slot_pos >= 0) & _mask(position, slot_pos, True, window, 0)
    s = s.masked_fill(~ok, NEG_INF)
    p_att = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgt,bhtd->bhgd", p_att, vc.float())
    o = o.reshape(B, 1, cfg.n_heads * dh).to(h.dtype)
    return o @ p["wo"]


def _cross_step(p: Mapping[str, torch.Tensor], h: torch.Tensor,
                kv: dict, cfg: ModelConfig) -> torch.Tensor:
    """h: (B, 1, D) normed input; attends over all S_enc keys and values
    of the cross cache (not causal)."""
    B = h.shape[0]
    H, dh = cfg.n_heads, cfg.head_dim_
    q = (h @ p["wq"]).reshape(B, 1, H, dh).transpose(1, 2)
    o = decode_attn(q, kv["k"], kv["v"], cache_len=kv["k"].shape[2])
    o = o.reshape(B, 1, H * dh).to(h.dtype)
    return o @ p["wo"]


def _layer_step(layer: DecoderLayer, cache_l: dict, x: torch.Tensor,
                length: int, cross: Optional[dict] = None
                ) -> torch.Tensor:
    cfg = layer.cfg
    h = rmsnorm(x, layer.norm1, cfg.norm_eps)
    if layer.kind == "ssd":
        h, new = ssd_step(layer.ssd, h, SSDCache(**cache_l), cfg)
        cache_l.update(new._asdict())
    elif layer.kind == "rglru":
        h, new = rglru_step(layer.rglru, h, LRUCache(**cache_l), cfg)
        cache_l.update(new._asdict())
    else:
        h = _attn_step(layer.attn, h, cache_l, cfg, length, layer.kind)
    x = x + h
    if cross is not None:
        h = rmsnorm(x, layer.norm_cross, cfg.norm_eps)
        x = x + _cross_step(layer.cross, h, cross, cfg)
    # the MoE layer routes the B tokens of the step as one group, as the
    # JAX package's decode step does; its aux loss is dropped
    return layer.ffn(x)[0]


def decode_step(model: Transformer, token, cache: dict):
    """token: (B,) integers. Returns (logits (B, padded_vocab), cache),
    the cache updated in place. The recurrent layers move their states
    through their scans: the kernels on the card, the plain versions on
    the CPU. An encoder-decoder's layers attend over the cross cache after
    their self attention."""
    cfg = model.cfg
    length = cache["length"] + 1
    token = torch.as_tensor(token, device=model.device).long()
    x = embed_lookup(model.embed["tok"], token[:, None], cfg.d_model)
    x = x.to(cfg.dtype())
    cross = cache.get("cross", [None] * len(model.layers))
    for layer, cache_l, kv in zip(model.layers, cache["layers"], cross):
        x = _layer_step(layer, cache_l, x, length, kv)
    x = rmsnorm(x, model.final_norm, cfg.norm_eps)
    cache["length"] = length
    return logits_out(model.embed, x, cfg)[:, 0], cache
