"""Workload configs of the port: the PageRank graphs, and the registry of
the JAX package's model architectures, all ported (the dense decoders,
Qwen2-MoE, Mamba2, RecurrentGemma, DeepSeek-V3, PaliGemma and
Whisper)."""
from __future__ import annotations

from typing import Dict

from ..models.config import ModelConfig
from . import (deepseek_v3_671b, mamba2_2p7b, minitron_4b, paligemma_3b,
               qwen1p5_4b, qwen2_moe_a2p7b, recurrentgemma_2b, smollm_360m,
               whisper_base, yi_6b)
from .pagerank import SMALL, STANFORD, PageRankConfig, paper_des_config

_MODULES = [smollm_360m, qwen1p5_4b, minitron_4b, yi_6b, qwen2_moe_a2p7b,
            mamba2_2p7b, recurrentgemma_2b, deepseek_v3_671b, paligemma_3b,
            whisper_base]

REGISTRY: Dict[str, ModelConfig] = {m.CONFIG.name: m.CONFIG for m in _MODULES}
SMOKE_REGISTRY: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.SMOKE for m in _MODULES}

ARCH_NAMES = list(REGISTRY)


def _lookup(name: str, registry: Dict[str, ModelConfig]) -> ModelConfig:
    if name in registry:
        return registry[name]
    raise KeyError(f"unknown arch {name!r}; have {ARCH_NAMES}")


def get_config(name: str) -> ModelConfig:
    return _lookup(name, REGISTRY)


def get_smoke_config(name: str) -> ModelConfig:
    return _lookup(name, SMOKE_REGISTRY)
