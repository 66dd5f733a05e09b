"""Analytic parameter / FLOP accounting for the roofline's MODEL_FLOPS
(the JAX package's analysis/flops.py), over the port's parameter tree
(`models.transformer.model_defs`).

The port's tree keys layers as a list, `layers/<i>/...`, where the JAX
package's keys stacked groups, `decoder/stack/pos<k>/...` with a leading
repeat axis. The MoE key test below matches both layouts the same way, so
the counts are the JAX package's. It matches the shared experts'
`moe/shared/w_{gate,up,down}` as well as the routed stacks, so shared
experts are counted at top_k / n_experts of their size as in the JAX
package (ROADMAP.md, Queue 3: for Qwen2-MoE-A2.7B, 1,288,275,968 active
parameters, ~778 M fewer than with the four shared experts in full).
"""
from __future__ import annotations

import math
from typing import List, Tuple

from ..models.config import ModelConfig
from ..models.param import ParamDef
from ..models.transformer import model_defs


def _leaf_counts(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(key, element count) of every leaf of `model_defs(cfg)`, in the
    tree's order, keys joined by "/"."""
    out: List[Tuple[str, int]] = []

    def walk(node, key: str) -> None:
        if isinstance(node, ParamDef):
            out.append((key, math.prod(node.shape)))
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{key}/{k}" if key else k)
        else:
            for i, v in enumerate(node):
                walk(v, f"{key}/{i}")
    walk(model_defs(cfg), "")
    return out


def _is_expert_weight(key: str) -> bool:
    """The JAX package's test: routed expert stacks, and (through the
    "/moe/" clause) the shared experts' MLP."""
    return ("/moe/w_" in key or key.endswith("moe/w_gate")
            or "/moe/" in key and (key.endswith("w_gate")
                                   or key.endswith("w_up")
                                   or key.endswith("w_down")))


def total_params(cfg: ModelConfig, include_embed: bool = True) -> int:
    return sum(n for k, n in _leaf_counts(cfg)
               if include_embed or not k.startswith("embed"))


def active_params(cfg: ModelConfig, include_embed: bool = False) -> int:
    """MoE: expert weights count at top_k/n_experts utilization."""
    total = 0
    for k, n in _leaf_counts(cfg):
        if not include_embed and k.startswith("embed"):
            continue
        if _is_expert_weight(k):
            n = int(n * cfg.top_k / max(cfg.n_experts, 1))
        total += n
    return total


def model_flops_cell(cfg: ModelConfig, shape: dict) -> float:
    """6*N_active*tokens for training, 2*N_active*new_tokens for decode,
    2*N_active*tokens for prefill."""
    n = active_params(cfg)
    if shape["kind"] == "train":
        tokens = shape["batch"] * shape["seq"]
        return 6.0 * n * tokens
    if shape["kind"] == "prefill":
        tokens = shape["batch"] * shape["seq"]
        return 2.0 * n * tokens
    return 2.0 * n * shape["batch"]  # decode: one token per sequence
