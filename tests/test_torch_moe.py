"""Parity of repro_torch's mixture of experts (`models/moe.py`) and the
Qwen2-MoE-A2.7B smoke model with the JAX package's, on the CPU.

The JAX package's parameters (`init_params(PRNGKey(0))`) are carried
across (`interop.lm_params_from_arrays` for the model), so both sides run
the same float32 weights. Routing is a top-k over float32 softmax
probabilities and capacity drops follow the (token, k) raster order on
both sides, so the same experts are chosen and the same assignments kept
(checked exactly against JAX's own top_k and cumsum): the layer's outputs
agree within 1e-5 of their scale (the einsums sum in another order) and
the aux loss within 1e-6 relative (float32 sums in another order), at the
smoke config's capacity factor 1.25, at 0.01 (most assignments dropped)
and at 64 (none dropped).
The whole smoke model's forward and decode agree within rtol/atol 1e-4,
as the dense configs do (tests/test_torch_lm.py); decode runs with the
capacity factor raised to 64, as the JAX package's decode tests do, since
only drop-free routing makes decode equal the forward.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.models.moe import capacity as j_capacity
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_defs as j_moe_defs
from repro.models.param import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_defs as j_model_defs
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import ModelConfig, Transformer, decode_step
from repro_torch.models.moe import (assign, capacity, moe_apply, moe_defs,
                                     route)
from repro_torch.serving import ServeEngine

ARCH = "qwen2-moe-a2.7b"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
FACTORS = [1.25, 0.01, 64.0]


def _cfgs(capacity_factor=None):
    jcfg = J_SMOKE[ARCH]
    if capacity_factor is not None:
        jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def _torch_tree(tree):
    return jax.tree_util.tree_map(
        lambda a: torch.from_numpy(np.array(a)), tree)


def _layer(capacity_factor):
    jcfg, cfg = _cfgs(capacity_factor)
    jp = j_init_params(j_moe_defs(jcfg), jax.random.PRNGKey(0))
    return jcfg, cfg, jp, _torch_tree(jp)


def _x(B, S, seed):
    return np.random.default_rng(seed).standard_normal(
        (B, S, J_SMOKE[ARCH].d_model)).astype(np.float32)


@pytest.mark.parametrize("capacity_factor", FACTORS)
def test_moe_apply_matches_reference(capacity_factor):
    jcfg, cfg, jp, p = _layer(capacity_factor)
    x = _x(2, 32, seed=1)                     # two groups of 32 tokens
    ref, ref_aux = j_moe_apply(jp, jnp.asarray(x), jcfg)
    ref = np.asarray(ref)
    out, aux = moe_apply(p, torch.from_numpy(x), cfg)
    assert out.shape == ref.shape and aux.dtype == torch.float32
    assert np.abs(out.numpy() - ref).max() <= 1e-5 * np.abs(ref).max()
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)


@pytest.mark.parametrize("capacity_factor", FACTORS)
def test_route_matches_reference(capacity_factor):
    """The router picks the JAX package's experts (its own ops: float32
    softmax, `jax.lax.top_k`, renormalized gates), and capacity keeps the
    same assignments as the reference's (t, k) raster cumsum."""
    jcfg, cfg, jp, p = _layer(capacity_factor)
    x = _x(2, 32, seed=6).reshape(2, 32, -1)
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    j_gates, j_idx = jax.lax.top_k(probs, cfg.top_k)
    j_gates = j_gates / j_gates.sum(-1, keepdims=True)
    mask = jax.nn.one_hot(j_idx, cfg.n_experts, dtype=jnp.float32)
    flat = mask.reshape(2, 32 * cfg.top_k, cfg.n_experts)
    pos = (jnp.cumsum(flat, axis=1) - flat).reshape(mask.shape)
    j_kept = mask * (pos < j_capacity(jcfg))
    t_probs, gates, idx = route(p, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(j_idx))
    np.testing.assert_allclose(gates.numpy(), np.asarray(j_gates),
                               rtol=1e-6)
    np.testing.assert_allclose(t_probs.numpy(), np.asarray(probs),
                               rtol=1e-6, atol=1e-7)
    kept, _ = assign(idx, cfg)
    np.testing.assert_array_equal(kept.numpy(), np.asarray(j_kept))


def test_moe_defs_match_reference():
    jcfg, cfg = _cfgs()
    jd, d = j_moe_defs(jcfg), moe_defs(cfg)
    flat = lambda t: {k: v for k, v in t.items() if k != "shared"}
    assert {k: v.shape for k, v in flat(d).items()} == {
        k: v.shape for k, v in flat(jd).items()}
    assert {k: v.shape for k, v in d["shared"].items()} == {
        k: v.shape for k, v in jd["shared"].items()}
    assert d["router"].dtype == torch.float32


@pytest.mark.parametrize("capacity_factor", FACTORS)
def test_capacity_matches_reference(capacity_factor):
    jcfg, cfg = _cfgs(capacity_factor)
    assert capacity(cfg) == j_capacity(jcfg)
    assert capacity(cfg) >= 4 and capacity(cfg) % 4 == 0


def test_capacity_drop_keeps_raster_order():
    """At capacity factor 0.01 each expert keeps its first C = 4
    assignments of a group in (token, k) order and drops the rest; the
    output is then smaller than at 1.25 (the reference's claim)."""
    _, cfg, _, p = _layer(0.01)
    x = torch.from_numpy(_x(1, 32, seed=3))
    _, _, idx = route(p, x.reshape(1, 32, -1), cfg)
    mask, _ = assign(idx, cfg)
    C = capacity(cfg)
    assert C == 4
    kept = mask.reshape(32 * cfg.top_k, cfg.n_experts)
    full, _ = assign(idx, dataclasses.replace(cfg, capacity_factor=64.0))
    full = full.reshape(32 * cfg.top_k, cfg.n_experts)
    for e in range(cfg.n_experts):
        rows = torch.nonzero(full[:, e])[:, 0]
        assert torch.equal(torch.nonzero(kept[:, e])[:, 0], rows[:C])
    out_tiny, _ = moe_apply(p, x, cfg)
    _, cfg_full, _, _ = _layer(None)
    out_full, _ = moe_apply(p, x, cfg_full)
    assert torch.isfinite(out_tiny).all()
    assert float(out_tiny.abs().mean()) <= float(out_full.abs().mean())


def test_routing_at_capacity_64_drops_nothing():
    _, cfg, _, p = _layer(64.0)
    x = torch.from_numpy(_x(2, 32, seed=4)).reshape(2, 32, -1)
    probs, gates, idx = route(p, x, cfg)
    assert float(assign(idx, cfg)[0].sum()) == 2 * 32 * cfg.top_k
    torch.testing.assert_close(gates.sum(-1), torch.ones(2, 32))
    torch.testing.assert_close(probs.sum(-1), torch.ones(2, 32))


class Pair:
    """The smoke model on both sides over the same weights."""

    def __init__(self, capacity_factor=None, max_len=32):
        self.jcfg, self.cfg = _cfgs(capacity_factor)
        self.jparams = j_init_params(j_model_defs(self.jcfg),
                                     jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.model = Transformer(self.cfg,
                                 lm_params_from_arrays(self.cfg, tree),
                                 device=CPU)
        self.jeng = JServeEngine(self.jcfg, self.jparams, max_len=max_len)
        self.eng = ServeEngine(self.cfg, self.model, max_len=max_len,
                               device=CPU)

    def prompts(self, B, S, seed):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return Pair()


@pytest.fixture(scope="module")
def pair64():
    return Pair(capacity_factor=64.0)


def test_config_resolves_and_matches_reference():
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(J_SMOKE[ARCH])


def test_forward_matches_reference(pair):
    tokens = pair.prompts(2, 16, seed=1)      # one group of 32 tokens
    ref, ref_aux = jax.jit(lambda p, t: j_forward(p, pair.jcfg, t))(
        pair.jparams, jnp.asarray(tokens))
    logits, aux = pair.model(torch.from_numpy(tokens))
    assert logits.shape == ref.shape
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-6)
    assert float(aux) > 0


def test_decode_steps_match_reference(pair64):
    pr = pair64
    tokens = pr.prompts(2, 12, seed=2)
    jcache, cache = pr.jeng.new_cache(2), pr.eng.new_cache(2)
    for t in range(12):
        ref, jcache = pr.jeng._step(pr.jparams, jnp.asarray(tokens[:, t]),
                                    jcache)
        logits, cache = decode_step(pr.model, torch.from_numpy(tokens[:, t]),
                                    cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    assert cache["length"] == int(jcache["length"]) == 12


def test_decode_equals_forward_drop_free(pair64):
    """The JAX package's decode invariant (tests/test_decode.py), held by
    the port: drop-free, step-by-step decode gives the forward's logits."""
    pr = pair64
    tokens = pr.prompts(2, 8, seed=5)
    fwd, _ = pr.model(torch.from_numpy(tokens))
    cache = pr.eng.new_cache(2)
    for t in range(8):
        logits, cache = decode_step(pr.model, torch.from_numpy(tokens[:, t]),
                                    cache)
        np.testing.assert_allclose(logits.numpy(), fwd[:, t].numpy(), **TOL)


def test_greedy_generate_matches_reference(pair64):
    pr = pair64
    prompts = pr.prompts(2, 5, seed=3)
    ref = pr.jeng.generate(jnp.asarray(prompts), 8, temperature=0.0)
    out = pr.eng.generate(torch.from_numpy(prompts), 8, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
