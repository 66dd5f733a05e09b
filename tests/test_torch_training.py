"""Parity of repro_torch's training path with the JAX package's, on the
CPU: the LM loss and its gradients, AdamW and its schedule, and the train
step.

Weights are the JAX package's `init_params(PRNGKey(0))` carried across by
`interop.lm_params_from_arrays` (the optimizer state by
`interop.opt_state_from_arrays`), batches the JAX package's `make_batch`
read as tensors, all in float32. The port's attention backward on the CPU
is the plain backward through the same torch.autograd.Function that
launches the kernel on the card.

Tolerances:
  * loss: 1e-5 relative (float32 sums in another order);
  * gradients: every leaf within 2e-5 of its own largest element (measured
    2.2e-6 at worst over the five smoke configs before RecurrentGemma's);
  * AdamW against the JAX package's update on the same gradients: 1e-6 on
    parameters and moments (elementwise float32 math, the same formula);
  * train steps: parameters within rtol 1e-4 / atol 2e-5 of the JAX
    package's after each of three steps. AdamW's first step moves a
    weight by lr * m/(sqrt(v) + eps) = lr * g/(|g| + eps), about
    lr * sign(g) for any |g| >> eps, so a gradient within rounding of zero
    (|g| at most 1e-5 of its leaf's largest at the first step, where the
    two sides' float32 sums may give it either sign) may move its weight
    the other way: such elements may differ by up to 2 lr per step taken,
    and no other element may differ beyond the tolerance.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JTokens
from repro.data.pipeline import make_batch as j_make_batch
from repro.models.param import init_params as j_init_params
from repro.models.transformer import model_defs as j_model_defs
from repro.training import optimizer as jopt
from repro.training.train_step import lm_loss as j_lm_loss
from repro.training.train_step import make_train_step as j_make_train_step
from repro_torch.interop import lm_params_from_arrays, opt_state_from_arrays
from repro_torch.models import ModelConfig, Transformer
from repro_torch.training.optimizer import (OptConfig, adamw_update,
                                            global_norm, init_opt_state,
                                            lr_schedule, tree_leaves,
                                            tree_map)
from repro_torch.training.train_step import (lm_loss, make_eval_step,
                                             make_train_step)

CPU = torch.device("cpu")
ARCHS = ["smollm-360m", "whisper-base", "qwen2-moe-a2.7b",
         "deepseek-v3-671b", "paligemma-3b", "recurrentgemma-2b",
         "mamba2-2.7b"]
GRAD_TOL = 2e-5


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batch(jcfg, B=2, S=16, step=0, seed=3):
    pipe = JTokens(JDataConfig(vocab_size=jcfg.vocab_size, seq_len=S,
                               global_batch=B, seed=seed))
    jb = j_make_batch(pipe, jcfg, step)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _setup(arch):
    jcfg = J_SMOKE[arch]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = j_init_params(j_model_defs(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, jp


def _model(cfg, jparams):
    return Transformer(cfg, lm_params_from_arrays(cfg, _np(jparams)),
                       device=CPU, trainable=True)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match(arch):
    """lm_loss and the gradient of every parameter leaf against
    jax.value_and_grad of the JAX package's lm_loss: a dense decoder,
    Whisper (encoder, cross attention), Qwen2-MoE (the aux loss),
    DeepSeek-V3 (MLA, Dk != Dv), PaliGemma (the prefix, dropped from
    the labels), RecurrentGemma (the RG-LRU's backward, the local
    window's) and Mamba2 (the SSD scan's backward)."""
    jcfg, cfg, jp = _setup(arch)
    jb, batch = _batch(jcfg)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p: j_lm_loss(p, jcfg, jb), has_aux=True))(jp)
    model = _model(cfg, jp)
    loss, parts = lm_loss(model, batch)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert float(parts["aux"].detach()) == pytest.approx(float(jparts["aux"]),
                                                rel=1e-5, abs=1e-7)
    leaves = tree_leaves(model.param_tree())
    grads = torch.autograd.grad(loss, leaves)
    ref = tree_leaves(lm_params_from_arrays(cfg, _np(jg)))
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        scale = max(float(r.abs().max()), 1e-30)
        assert float((g - r).abs().max()) <= GRAD_TOL * scale


def test_loss_mask_and_eval_step():
    """A loss_mask weights the labels as the JAX package's does; the eval
    step gives the train loss without gradients."""
    jcfg, cfg, jp = _setup("smollm-360m")
    jb, batch = _batch(jcfg, B=2, S=12)
    mask = np.ones((2, 12), np.int32)
    mask[0, 5:] = 0
    jb = dict(jb, loss_mask=jnp.asarray(mask))
    batch = dict(batch, loss_mask=torch.from_numpy(mask))
    jl, _ = j_lm_loss(jp, jcfg, jb)
    out = make_eval_step(_model(cfg, jp))(batch)
    assert float(out["loss"]) == pytest.approx(float(jl), rel=1e-5)
    assert out["loss"].grad_fn is None


# ------------------------------------------------------------ optimizer --
def test_adamw_matches_numpy_oracle():
    """tests/test_optimizer.py's hand-rolled numpy AdamW, 10 steps."""
    cfg = OptConfig(peak_lr=1e-2, warmup_steps=0, total_steps=100,
                    end_lr_frac=1.0, weight_decay=0.1, grad_clip=1e9)
    w = {"a": torch.tensor([1.0, -2.0, 3.0]), "b": torch.tensor([[0.5]])}
    state = init_opt_state(w, cfg)
    rng = np.random.default_rng(0)
    wn = {k: v.numpy().astype(np.float64) for k, v in w.items()}
    m = {k: np.zeros_like(v) for k, v in wn.items()}
    v2 = {k: np.zeros_like(v) for k, v in wn.items()}
    for t in range(1, 11):
        g = {"a": rng.standard_normal(3), "b": rng.standard_normal((1, 1))}
        gt = {k: torch.as_tensor(v, dtype=torch.float32)
              for k, v in g.items()}
        w, state, _ = adamw_update(w, gt, state, cfg)
        lr = float(lr_schedule(cfg, t))
        for k in wn:
            m[k] = 0.9 * m[k] + 0.1 * g[k]
            v2[k] = 0.95 * v2[k] + 0.05 * g[k] ** 2
            mh = m[k] / (1 - 0.9 ** t)
            vh = v2[k] / (1 - 0.95 ** t)
            wn[k] = wn[k] - lr * (mh / (np.sqrt(vh) + cfg.eps)
                                  + 0.1 * wn[k])
    assert int(state["step"]) == 10
    for k in wn:
        np.testing.assert_allclose(w[k].numpy().astype(np.float64), wn[k],
                                   rtol=1e-4, atol=1e-5)


def test_grad_clip_caps_norm():
    cfg = OptConfig(peak_lr=1.0, warmup_steps=0, total_steps=10,
                    end_lr_frac=1.0, weight_decay=0.0, grad_clip=0.5)
    w = {"a": torch.zeros(4)}
    state = init_opt_state(w, cfg)
    w2, state, metrics = adamw_update(w, {"a": torch.full((4,), 100.0)},
                                      state, cfg)
    assert float(metrics["grad_norm"]) == pytest.approx(200.0)
    assert bool(torch.isfinite(w2["a"]).all())


def test_lr_schedule_matches():
    """The schedule's shape (tests/test_optimizer.py) and its float32
    values against the JAX package's at every step."""
    cfg = OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    jcfg = jopt.OptConfig(peak_lr=1e-3, warmup_steps=10, total_steps=100)
    lrs = [float(lr_schedule(cfg, s)) for s in range(0, 101, 5)]
    assert lrs[0] < lrs[2] <= cfg.peak_lr * (1 + 1e-5)
    assert lrs[-1] == pytest.approx(cfg.peak_lr * cfg.end_lr_frac, rel=1e-3)
    for s in range(0, 121):
        assert float(lr_schedule(cfg, torch.tensor(s, dtype=torch.int32))) \
            == pytest.approx(float(jopt.lr_schedule(jcfg, jnp.asarray(s))),
                             rel=1e-6)


def test_global_norm():
    t = {"a": torch.tensor([3.0]), "b": torch.tensor([4.0])}
    assert float(global_norm(t)) == pytest.approx(5.0)
    # a stacked leaf (>= 3 dims, >= chunk_min_dim rows) summed by slices
    x = np.random.default_rng(1).standard_normal((9, 3, 4)).astype(
        np.float32)
    assert float(global_norm({"x": torch.from_numpy(x)})) == pytest.approx(
        float(jopt.global_norm({"x": jnp.asarray(x)})), rel=1e-6)


@pytest.mark.parametrize("opt_dtype", ["float32", "bfloat16"])
def test_adamw_matches_reference(opt_dtype):
    """Three updates against the JAX package's adamw_update on the same
    random gradients: a stacked leaf (updated slice by slice), bf16 and
    float32 parameters, warmup, clipping and weight decay; the moments in
    opt_dtype."""
    kw = dict(peak_lr=1e-2, warmup_steps=2, total_steps=10, grad_clip=0.7,
              opt_dtype=opt_dtype)
    cfg, jcfg = OptConfig(**kw), jopt.OptConfig(**kw)
    rng = np.random.default_rng(2)
    shapes = {"stack": (8, 3, 5), "w": (6, 4), "b": (4,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32)
          for k, s in shapes.items()}
    jp = {k: jnp.asarray(v, jnp.bfloat16 if k == "w" else jnp.float32)
          for k, v in p0.items()}
    p = {k: torch.from_numpy(np.array(v)).to(
        torch.bfloat16 if k == "w" else torch.float32)
        for k, v in p0.items()}
    jstate, state = jopt.init_opt_state(jp, jcfg), init_opt_state(p, cfg)
    for t in range(3):
        g = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
        jp, jstate, jm = jopt.adamw_update(
            jp, {k: jnp.asarray(v) for k, v in g.items()}, jstate, jcfg)
        p, state, m = adamw_update(
            p, {k: torch.from_numpy(v) for k, v in g.items()}, state, cfg)
        assert float(m["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(m["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
        for k in shapes:
            for ours, ref in ((p[k], jp[k]), (state["m"][k],
                                               jstate["m"][k]),
                              (state["v"][k], jstate["v"][k])):
                assert ours.dtype == (torch.bfloat16 if str(ref.dtype) ==
                                      "bfloat16" else torch.float32)
                np.testing.assert_allclose(
                    ours.float().numpy(),
                    np.asarray(ref, np.float32), rtol=1e-6, atol=1e-6,
                    err_msg=f"step {t} leaf {k}")
    assert int(state["step"]) == int(jstate["step"]) == 3


# ------------------------------------------------------------ train step --
def _check_params(model, cfg, jparams, g0, lr_sum):
    """The tolerance of the module docstring: elements outside rtol 1e-4 /
    atol 2e-5 must have had a first-step gradient within 1e-5 of their
    leaf's largest and differ by at most 2 lr a step."""
    ours = tree_leaves(model.param_tree())
    ref = tree_leaves(lm_params_from_arrays(cfg, _np(jparams)))
    grads = tree_leaves(lm_params_from_arrays(cfg, _np(g0)))
    flipped = 0
    for p, r, g in zip(ours, ref, grads):
        p = p.detach()
        off = ~torch.isclose(p, r, rtol=1e-4, atol=2e-5)
        if off.any():
            tiny = g.abs() <= 1e-5 * float(g.abs().max())
            assert bool(tiny[off].all())
            assert float((p - r).abs()[off].max()) <= 2 * lr_sum * 1.001
            flipped += int(off.sum())
    return flipped


@pytest.mark.parametrize("arch,accum", [("smollm-360m", 1),
                                        ("smollm-360m", 2),
                                        ("whisper-base", 2),
                                        ("recurrentgemma-2b", 1),
                                        ("mamba2-2.7b", 1)])
def test_train_steps_match(arch, accum):
    """Three make_train_step steps (accum_steps micro-batches) against the
    JAX package's from the same weights and optimizer state: the loss, ce,
    aux, lr and grad_norm of each step, and the parameters and moments
    after each."""
    jcfg, cfg, jp = _setup(arch)
    kw = dict(peak_lr=1e-3, warmup_steps=2, total_steps=10,
              accum_steps=accum)
    opt_cfg, jopt_cfg = OptConfig(**kw), jopt.OptConfig(**kw)
    jstate = {"params": jp, "opt": jopt.init_opt_state(jp, jopt_cfg)}
    model = _model(cfg, jp)
    params = model.param_tree()
    state = {"params": params,
             "opt": opt_state_from_arrays(cfg, _np(jstate["opt"]))}
    jstep = jax.jit(j_make_train_step(jcfg, jopt_cfg))
    step = make_train_step(model, opt_cfg)
    jb, _ = _batch(jcfg, B=4, S=12, step=0)
    g0 = jax.jit(jax.grad(lambda p: j_lm_loss(p, jcfg, jb)[0]))(jp)
    lr_sum = 0.0
    for t in range(3):
        jb, batch = _batch(jcfg, B=4, S=12, step=t)
        jstate, jm = jstep(jstate, jb)
        state, m = step(state, batch)
        lr_sum += float(m["lr"])
        for key in ("loss", "ce", "aux", "lr", "grad_norm"):
            assert float(m[key]) == pytest.approx(float(jm[key]), rel=1e-4,
                                                  abs=1e-7), (t, key)
        flipped = _check_params(model, cfg, jstate["params"], g0, lr_sum)
        assert flipped <= 1e-3 * sum(p.numel() for p in tree_leaves(params))
        for key in ("m", "v"):
            ours = tree_leaves(state["opt"][key])
            ref = tree_leaves(lm_params_from_arrays(
                cfg, _np(jstate["opt"][key])))
            for a, b in zip(ours, ref):
                scale = max(float(b.abs().max()), 1e-30)
                assert float((a - b).abs().max()) <= 1e-3 * scale
    assert int(state["opt"]["step"]) == int(jstate["opt"]["step"]) == 3


def test_trainable_only_where_asked():
    """Inference models stay frozen; a trainable model's tree is its own
    copy of the given weights, which the step updates in place."""
    jcfg, cfg, jp = _setup("smollm-360m")
    frozen = Transformer(cfg, device=CPU)
    assert not any(p.requires_grad for p in frozen.parameters())
    tree = lm_params_from_arrays(cfg, _np(jp))
    model = Transformer(cfg, tree, device=CPU, trainable=True)
    assert all(p.requires_grad for p in model.parameters())
    before = tree_map(lambda t: t.clone(), tree)
    step = make_train_step(model, OptConfig(warmup_steps=0))
    state = {"params": model.param_tree(),
             "opt": init_opt_state(model.param_tree(), OptConfig())}
    step(state, _batch(jcfg)[1])
    for a, b in zip(tree_leaves(tree), tree_leaves(before)):
        assert torch.equal(a, b)
    assert not torch.equal(model.layers[0].attn["wq"].detach(),
                           tree["layers"][0]["attn"]["wq"])
    with pytest.raises(ValueError, match="trainable"):
        make_train_step(frozen, OptConfig())
