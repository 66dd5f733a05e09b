"""Parameter specification: every parameter leaf is declared once as a
ParamDef (shape, dtype, init scale), in nested dicts and lists; from the
same tree come the materialized parameters (`init_params`) and the count
(`count_params`, from shapes alone, allocating nothing).

The JAX package's partition specs and sharding helpers have no counterpart
here: the port runs on one card.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Mapping, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                   # normal | zeros
    scale: Optional[float] = None          # None -> 1/sqrt(fan_in)


def map_defs(fn: Callable[[ParamDef], Any], defs):
    """Apply fn to every ParamDef of a tree of dicts and lists, keeping the
    tree's structure."""
    if isinstance(defs, ParamDef):
        return fn(defs)
    if isinstance(defs, dict):
        return {k: map_defs(fn, v) for k, v in defs.items()}
    if isinstance(defs, (list, tuple)):
        return [map_defs(fn, v) for v in defs]
    raise TypeError(f"not a ParamDef tree node: {type(defs).__name__}")


def match_defs(defs, tree, leaf: Callable[[ParamDef, Any], Any],
               path: str = ""):
    """Walk `tree` alongside `defs` and return leaf(def, value) for every
    ParamDef. Raises KeyError for a missing or left-over entry and
    ValueError for a leaf whose shape differs from its def's."""
    if isinstance(defs, ParamDef):
        if tree is None:
            raise KeyError(f"parameter {path} missing")
        out = leaf(defs, tree)
        if tuple(out.shape) != defs.shape:
            raise ValueError(f"{path}: shape {tuple(out.shape)}, expected "
                             f"{defs.shape}")
        return out
    if isinstance(defs, dict):
        if not isinstance(tree, Mapping):
            raise KeyError(f"parameter group {path} missing")
        extra = sorted(set(tree) - set(defs))
        if extra:
            raise KeyError(f"parameters left over under {path or '/'}: "
                           f"{extra}")
        return {k: match_defs(d, tree.get(k), leaf, f"{path}/{k}")
                for k, d in defs.items()}
    if len(tree) != len(defs):
        raise KeyError(f"{path}: {len(tree)} entries, expected {len(defs)}")
    return [match_defs(d, t, leaf, f"{path}/{i}")
            for i, (d, t) in enumerate(zip(defs, tree))]


def init_params(defs, generator: torch.Generator,
                device: torch.device):
    """Materialize a tree of ParamDefs on `device`, drawing from
    `generator` (a torch.Generator on that device) leaf by leaf in the
    tree's order.

    "normal" leaves are N(0, 1) in float32 times `scale`, or times
    fan_in ** -0.5 with fan_in = shape[-2] (shape[-1] for a vector), then
    cast to the leaf's dtype; "zeros" leaves are zero. The values
    follow the JAX package's rule but not its random numbers."""
    def one(d: ParamDef) -> torch.Tensor:
        if d.init == "zeros":
            return torch.zeros(d.shape, dtype=d.dtype, device=device)
        fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
        scale = d.scale if d.scale is not None else fan_in ** -0.5
        x = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return x.mul_(scale).to(d.dtype)
    return map_defs(one, defs)


def count_params(defs) -> int:
    total = 0

    def add(d: ParamDef) -> None:
        nonlocal total
        total += math.prod(d.shape)
    map_defs(add, defs)
    return total
