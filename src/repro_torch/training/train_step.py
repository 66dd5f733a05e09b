"""The LM loss and the train step shared by the launcher and the tests.

    model = Transformer(cfg, device=..., trainable=True)
    state = {"params": model.param_tree(),
             "opt": init_opt_state(model.param_tree(), opt_cfg)}
    step = make_train_step(model, opt_cfg)
    state, metrics = step(state, batch)

The model holds its parameters, so the loss and the step take the model
where the JAX package's take a parameter tree and its config; the step
updates the parameters (state["params"], the model's own tensors) and the
optimizer state in place and returns the same state. Gradients come from
torch.autograd: on the card every attention's backward is the
hand-written flash backward kernel (`kernels.flash_attention`).
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ..models.blocks import logits_out, rmsnorm
from ..models.transformer import Transformer
from .optimizer import OptConfig, adamw_update, tree_leaves, tree_unflatten

AUX_LOSS_WEIGHT = 0.01


def _chunk_ce(model: Transformer, h: torch.Tensor, labels: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """The weighted sum of one chunk's token cross-entropies: final_norm,
    logits, and the log-sum-exp in float32."""
    cfg = model.cfg
    h = rmsnorm(h, model.final_norm, cfg.norm_eps)
    logits = logits_out(model.embed, h, cfg)                 # (B, c, V)
    logz = torch.logsumexp(logits.float(), dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0].float()
    return ((logz - gold) * w).sum()


def _chunked_softmax_xent(model: Transformer, hidden: torch.Tensor,
                          labels: torch.Tensor, weights: torch.Tensor,
                          chunk: int = 1024) -> torch.Tensor:
    """Cross-entropy without a full (B, S, V) float32 logits buffer: the
    sequence in chunks of `chunk` positions (zero-padded to a multiple,
    the padding weighted 0), each chunk's logits recomputed in the
    backward pass (torch.utils.checkpoint). Peak memory O(chunk * V), not
    O(S * V). Returns the weighted mean over max(sum of weights, 1)."""
    B, S, D = hidden.shape
    c = min(chunk, S)
    if S % c:
        pad = c - S % c
        hidden = torch.nn.functional.pad(hidden, (0, 0, 0, pad))
        labels = torch.nn.functional.pad(labels, (0, pad))
        weights = torch.nn.functional.pad(weights, (0, pad))
        S += pad
    grad = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for i in range(0, S, c):
        args = (model, hidden[:, i:i + c], labels[:, i:i + c],
                weights[:, i:i + c])
        total = total + (checkpoint(_chunk_ce, *args, use_reentrant=False)
                         if grad else _chunk_ce(*args))
    return total / torch.clamp(weights.sum(), min=1.0)


def lm_loss(model: Transformer, batch: Dict[str, torch.Tensor],
            impl: str = "auto"
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Causal LM loss. batch: tokens (B, S) [+ enc_inputs (an
    encoder-decoder's frames) / prefix_embeds (a prefix-LM's prefix)
    / loss_mask (B, S)].

    Labels are the tokens shifted left, the final position dropped, and
    a prefix-LM's prefix positions dropped; the padded vocab tail can
    never be a label (tokens < vocab_size). Returns (ce + 0.01 aux,
    {"ce", "aux"}), aux the MoE layers' load-balance loss."""
    cfg = model.cfg
    kwargs = {}
    if cfg.is_encdec:
        kwargs["enc_inputs"] = batch["enc_inputs"]
    if cfg.prefix_len:
        kwargs["prefix_embeds"] = batch["prefix_embeds"]
    tokens = torch.as_tensor(batch["tokens"], device=model.device).long()
    hidden, aux = model(tokens, return_hidden=True, impl=impl, **kwargs)
    if cfg.prefix_len:
        hidden = hidden[:, cfg.prefix_len:]
    pred_h = hidden[:, :-1]
    labels = tokens[:, 1:]
    if "loss_mask" in batch:
        w = torch.as_tensor(batch["loss_mask"],
                            device=model.device)[:, 1:].float()
    else:
        w = torch.ones(labels.shape, dtype=torch.float32,
                       device=model.device)
    ce = _chunked_softmax_xent(model, pred_h, labels, w)
    loss = ce + AUX_LOSS_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def _grads(model: Transformer, leaves, batch):
    """(loss, parts, gradients of the loss in leaves' order)."""
    loss, parts = lm_loss(model, batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), {k: v.detach() for k, v in parts.items()}, grads


def make_train_step(model: Transformer, opt_cfg: OptConfig) -> Callable:
    """Returns train_step(state, batch) -> (state, metrics) for a model
    built with trainable=True; state = {"params": model.param_tree(),
    "opt": init_opt_state(...)}, updated in place.

    opt_cfg.accum_steps > 1 splits the batch into that many micro-batches
    (along the batch axis) and sums their gradients in accum_dtype, then
    divides by the count: the activation peak drops by the factor.
    metrics: loss, ce, aux, lr and grad_norm as scalar tensors on the
    device (no host sync)."""
    if not model.trainable:
        raise ValueError("make_train_step needs a model built with "
                         "trainable=True")

    def train_step(state: dict, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(state["params"])
        A = opt_cfg.accum_steps
        if A > 1:
            adt = getattr(torch, opt_cfg.accum_dtype)
            g_acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
                     for p in leaves]
            loss_sum = aux_sum = 0.0
            for a in range(A):
                mb = {k: v.reshape((A, v.shape[0] // A) + v.shape[1:])[a]
                      for k, v in batch.items()}
                loss, parts, grads = _grads(model, leaves, mb)
                for acc, g in zip(g_acc, grads):
                    acc += g.to(adt)
                loss_sum = loss_sum + loss
                aux_sum = aux_sum + parts["aux"]
            grads = [g / A for g in g_acc]
            loss = loss_sum / A
            parts = {"ce": loss, "aux": aux_sum / A}
        else:
            loss, parts, grads = _grads(model, leaves, batch)
        _, _, opt_metrics = adamw_update(
            state["params"], tree_unflatten(state["params"], grads),
            state["opt"], opt_cfg)
        return state, {"loss": loss, **parts, **opt_metrics}

    return train_step


def make_eval_step(model: Transformer) -> Callable:
    """eval_step(batch) -> {"loss", "ce", "aux"}, without gradients."""
    @torch.no_grad()
    def eval_step(batch: Dict[str, torch.Tensor]):
        loss, parts = lm_loss(model, batch)
        return {"loss": loss, **parts}
    return eval_step
