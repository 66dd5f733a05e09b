"""Stand-ins on the meta device for every (arch x shape) cell (after the
JAX package's launch/specs.py).

Nothing here allocates device memory: the parameters, the optimizer state,
the batches and the caches are tensors on `torch.device("meta")`, which
hold shapes and dtypes and no data, so a 671B model's state "fits" in a
CPU process for the dry run to count its steps (`launch.dryrun`).

Meta parameters come from `model_defs` through `map_defs`, one empty meta
tensor a ParamDef: a model built without parameters draws them from a
torch.Generator on its device, and the meta device has none.

The JAX module's PartitionSpec helpers (`_dp`, `_tp`, `cache_pspecs`,
`attach`) have no counterpart: one card has no mesh to shard over.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..models.config import ModelConfig
from ..models.decode import init_cache
from ..models.param import map_defs
from ..models.transformer import Transformer, model_defs
from ..training.optimizer import OptConfig, init_opt_state

META = torch.device("meta")

SHAPES: Dict[str, dict] = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32_768, batch=32),
    "decode_32k": dict(kind="decode", seq=32_768, batch=128),
    "long_500k": dict(kind="decode", seq=524_288, batch=1),
}


def batch_specs(cfg: ModelConfig,
                shape_name: str) -> Dict[str, torch.Tensor]:
    """The cell's batch on the meta device (`batch_for` at its kind, B
    and S)."""
    sh = SHAPES[shape_name]
    return batch_for(cfg, sh["kind"], sh["batch"], sh["seq"])


def batch_for(cfg: ModelConfig, kind: str, B: int,
              S: int) -> Dict[str, torch.Tensor]:
    """A step's batch on the meta device: for training and prefill, tokens
    (B, S - prefix_len) int32, a prefix-LM's prefix_embeds (B, prefix_len,
    d_model) and an encoder-decoder's enc_inputs (B, S * enc_seq_ratio,
    d_model), both in the compute dtype; for decode, token (B,) int32."""
    dt = cfg.dtype()
    if kind == "decode":
        return {"token": torch.empty((B,), dtype=torch.int32, device=META)}
    out = {"tokens": torch.empty((B, S - cfg.prefix_len), dtype=torch.int32,
                                 device=META)}
    if cfg.prefix_len:
        out["prefix_embeds"] = torch.empty((B, cfg.prefix_len, cfg.d_model),
                                           dtype=dt, device=META)
    if cfg.is_encdec:
        out["enc_inputs"] = torch.empty(
            (B, int(S * cfg.enc_seq_ratio), cfg.d_model), dtype=dt,
            device=META)
    return out


def params_specs_only(cfg: ModelConfig) -> dict:
    """The parameter tree of `model_defs(cfg)` as empty meta tensors of
    each leaf's shape and dtype."""
    return map_defs(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device=META), model_defs(cfg))


def state_specs(cfg: ModelConfig, opt_cfg: OptConfig) -> dict:
    """{"params", "opt"}: the parameters (`params_specs_only`) and the
    AdamW state `init_opt_state` makes beside them (moments in opt_dtype,
    the step count), all on the meta device."""
    params = params_specs_only(cfg)
    return {"params": params, "opt": init_opt_state(params, opt_cfg)}


def meta_model(cfg: ModelConfig, params: dict = None,
               trainable: bool = False) -> Transformer:
    """A Transformer on the meta device over `params` (default: fresh
    `params_specs_only`); trainable=True copies them, as on the card."""
    return Transformer(cfg, params_specs_only(cfg) if params is None
                       else params, device=META, trainable=trainable)


def cache_abstract(cfg: ModelConfig, shape_name: str,
                   model: Transformer = None) -> dict:
    """The cell's decode cache (`cache_for` at its B and S)."""
    sh = SHAPES[shape_name]
    return cache_for(cfg, sh["batch"], sh["seq"], model)


def cache_for(cfg: ModelConfig, B: int, S: int,
              model: Transformer = None) -> dict:
    """A decode cache (`models.decode.init_cache` on the meta device) for
    B sequences of up to S tokens. An encoder-decoder's cross cache is
    made by `model`'s cross projections (default: a fresh meta model) of
    an encoder output of S * enc_seq_ratio frames."""
    if not cfg.is_encdec:
        return init_cache(cfg, B, S, device=META)
    enc_out = torch.empty((B, int(S * cfg.enc_seq_ratio), cfg.d_model),
                          dtype=cfg.dtype(), device=META)
    return init_cache(cfg, B, S, device=META, enc_out=enc_out,
                      model=model or meta_model(cfg))
