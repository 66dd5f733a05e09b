"""AdamW and its schedule, as plain functions on trees of tensors (nested
dicts and lists, the shape of `models.model_defs`).

The same float32 math as the JAX package's optimizer: the learning-rate
schedule (linear warmup, cosine decay to `end_lr_frac`), the global
gradient norm and clipping, bias-corrected moments kept in `opt_dtype`,
decoupled weight decay, and the elementwise update run slice by slice
over the leading axis of leaves with at least 3 dims and
`update_chunk_min_dim` rows (the stacked experts), which caps its float32
temporaries. Where the JAX package returns new trees, `adamw_update`
writes the parameters and moments in place, as a PyTorch optimizer does:
the parameters are a module's own tensors.

The JAX package's ZeRO-1 rules (`zero1_spec`, `opt_state_pspecs`) shard
the moments over a device mesh's data-parallel axis; one card has no
mesh, so they have no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    peak_lr: float = 3e-4
    end_lr_frac: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    opt_dtype: str = "float32"   # bf16 for deepseek-v3-671b
    accum_steps: int = 1         # gradient-accumulation microbatches
    accum_dtype: str = "float32"
    # update slice by slice over the leading axis of large stacked leaves:
    # caps the f32 temporaries at 1/leading_dim
    update_chunk_min_dim: int = 8


# ------------------------------------------------------------------ trees --
def tree_map(fn: Callable, tree, *rest):
    """fn over the leaves of `tree` and of trees shaped like it, keeping
    the structure (dicts and lists; anything else is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    """The leaves in the tree's order (dict insertion, then list index)."""
    out: List[Any] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree, leaves: List[Any]):
    """A tree shaped like `tree` with `leaves` in its leaves' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


@torch.no_grad()
def tree_copy_(dst, src) -> None:
    """Copy every leaf of src into dst's tensor in place (casting to its
    dtype and device)."""
    tree_map(lambda d, s: d.copy_(s), dst, src)


# ---------------------------------------------------------------- schedule --
def lr_schedule(cfg: OptConfig, step) -> torch.Tensor:
    """Linear warmup to peak_lr over warmup_steps, then cosine decay to
    peak_lr * end_lr_frac at total_steps; float32, on step's device."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.end_lr_frac + (1 - cfg.end_lr_frac) * cos
    return cfg.peak_lr * warm * frac


def init_opt_state(params, cfg: OptConfig) -> dict:
    """Zero moments in opt_dtype beside each parameter, and the step count
    (an int32 scalar on the parameters' device)."""
    dt = getattr(torch, cfg.opt_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def global_norm(tree, chunk_min_dim: int = 8) -> torch.Tensor:
    """sqrt of the float32 sum of squares over every leaf; a leaf of at
    least 3 dims and chunk_min_dim rows is summed slice by slice over its
    leading axis, so no whole-leaf float32 temporary materializes."""
    def sq(leaf: torch.Tensor) -> torch.Tensor:
        if leaf.ndim >= 3 and leaf.shape[0] >= chunk_min_dim:
            return sum(s.float().square().sum() for s in leaf)
        return leaf.float().square().sum()
    total = None
    for leaf in tree_leaves(tree):
        total = sq(leaf) if total is None else total + sq(leaf)
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: dict, cfg: OptConfig
                 ) -> Tuple[Any, dict, Dict[str, torch.Tensor]]:
    """One AdamW step: params, state["m"] and state["v"] updated in place,
    state["step"] replaced by step + 1. Returns (params, state, metrics),
    metrics {"lr", "grad_norm"} (float32 scalars on the device)."""
    step = state["step"] + 1
    lr = lr_schedule(cfg, step)
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                       max=1.0)
    b1, b2 = cfg.b1, cfg.b2
    c1 = 1.0 - b1 ** step.float()
    c2 = 1.0 - b2 ** step.float()

    def upd(p, g, m, v):
        g = g.float() * clip
        m32 = m.float() * b1 + (1 - b1) * g
        v32 = v.float() * b2 + (1 - b2) * g * g
        mhat = m32 / c1
        vhat = v32 / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps)
        delta = delta + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    def upd_leaf(p, g, m, v):
        if p.ndim >= 3 and p.shape[0] >= cfg.update_chunk_min_dim:
            for i in range(p.shape[0]):
                upd(p[i], g[i], m[i], v[i])
        else:
            upd(p, g, m, v)

    tree_map(upd_leaf, params, grads, state["m"], state["v"])
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
