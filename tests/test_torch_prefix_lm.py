"""Parity of repro_torch's prefix-LM (PaliGemma-3B's backbone) with the JAX
package's, on the CPU.

The plain flash version is held against `flash_attn_jnp`, the JAX model
path's attention, with a prefix: the JAX package's own cases of
tests/test_kernels_attention.py, then ragged lengths, S != T, prefix
lengths of 0, 1, a chunk edge and past S, with a window, and without
causal (where the prefix changes nothing). `gqa_attention` with a prefix
is held against the JAX package's on the smoke config's weights; the
PaliGemma smoke model's forward with 8 prefix embeddings (not scaled, as
the token embeddings are) and without, and its decode steps (no prefix,
as in the JAX package), against the JAX package's, its parameters carried
across by `interop.lm_params_from_arrays`; the full config's parameter
count against the JAX package's. Tolerances: 2e-5 for attention alone
(summation order differs) and `TOL` (1e-4) through a model, in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.configs import get_config as j_get_config
from repro.models import attention as j_attention
from repro.models.attention import flash_attn_jnp
from repro.models.param import count_params as j_count_params
from repro.models.param import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_defs as j_model_defs
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.analysis import flops
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.kernels.flash_attention import attention
from repro_torch.models import (ModelConfig, Transformer, count_params,
                                decode_step, model_defs)
from repro_torch.models.attention import gqa_attention
from repro_torch.serving import ServeEngine

ARCH = "paligemma-3b"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def rand_qkv(rng, B, H, Hkv, S, T, D):
    return (rng.standard_normal((B, H, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, D)).astype(np.float32))


def _check_plain(S, T, cq, ck, causal, window, prefix, D=32, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v = rand_qkv(rng, 2, 4, 2, S, T, D)
    ref = flash_attn_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, prefix_len=prefix,
                         chunk_q=cq, chunk_k=ck)
    out = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                    causal=causal, window=window, prefix_len=prefix)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


# tests/test_kernels_attention.py's test_jnp_flash_vs_naive cases
@pytest.mark.parametrize("S,T,cq,ck,causal,window,prefix", [
    (64, 64, 16, 16, True, None, 0),
    (40, 40, 16, 16, True, None, 0),          # non-divisible padding
    (64, 64, 16, 16, True, 24, 0),            # sliding window
    (64, 64, 16, 16, True, None, 8),          # prefix-LM
    (32, 96, 16, 32, False, None, 0),         # cross attention
])
def test_plain_matches_model_path(S, T, cq, ck, causal, window, prefix):
    _check_plain(S, T, cq, ck, causal, window, prefix, seed=S * T)


@pytest.mark.parametrize("S,T,causal,window,prefix", [
    (40, 40, True, None, 1),                  # masks as no prefix does
    (40, 40, True, None, 16),                 # a chunk edge
    (40, 40, True, None, 17),
    (40, 40, True, None, 100),                # past S: all see all
    (37, 53, True, None, 20),                 # S < T
    (53, 37, True, None, 20),                 # S > T
    (40, 40, True, 9, 20),                    # and a window
    (40, 40, False, None, 20),                # not causal: no effect
])
def test_plain_prefix_edges_match_model_path(S, T, causal, window, prefix):
    _check_plain(S, T, 16, 16, causal, window, prefix,
                 seed=S + T + prefix)


def test_prefix_past_s_is_full_attention():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(a) for a in rand_qkv(rng, 1, 2, 1, 30, 30,
                                                       8))
    torch.testing.assert_close(attention(q, k, v, prefix_len=30),
                               attention(q, k, v, causal=False))
    with pytest.raises(ValueError, match="prefix_len"):
        attention(q, k, v, prefix_len=-1)


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


class Pair:
    """The PaliGemma smoke config on both sides over the same weights."""

    def __init__(self, max_len=32):
        self.jcfg = J_SMOKE[ARCH]
        self.cfg = ModelConfig(**dataclasses.asdict(self.jcfg))
        self.jparams = j_init_params(j_model_defs(self.jcfg),
                                     jax.random.PRNGKey(0))
        self.model = Transformer(
            self.cfg, lm_params_from_arrays(self.cfg,
                                            _numpy_tree(self.jparams)),
            device=CPU)
        self.jeng = JServeEngine(self.jcfg, self.jparams, max_len=max_len)
        self.eng = ServeEngine(self.cfg, self.model, max_len=max_len,
                               device=CPU)

    def prompts(self, B, S, seed=1):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)

    def prefix(self, B, seed=2):
        return np.random.default_rng(seed).standard_normal(
            (B, self.cfg.prefix_len, self.cfg.d_model)).astype(np.float32)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_config_copied():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(J_SMOKE[ARCH])


@pytest.mark.parametrize("prefix_len", [0, 5, 8])
def test_gqa_attention_prefix_matches(pair, prefix_len):
    p = pair.jparams["decoder"]["stack"]["pos0"]["attn"]
    jp = {k: v[0] for k, v in p.items()}
    x = np.random.default_rng(prefix_len).standard_normal(
        (2, 21, pair.cfg.d_model)).astype(np.float32)
    ref = j_attention.gqa_attention(jp, jnp.asarray(x), pair.jcfg,
                                    positions=jnp.arange(21),
                                    prefix_len=prefix_len)
    out = gqa_attention(pair.model.layers[0].attn, torch.from_numpy(x),
                        pair.cfg, positions=torch.arange(21),
                        prefix_len=prefix_len)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("with_prefix", [True, False])
def test_forward_matches(pair, with_prefix):
    """The forward over [prefix | tokens]: logits at every one of the
    P + S positions, the prefix embeddings entering unscaled."""
    tokens = pair.prompts(2, 12)
    prefix = pair.prefix(2) if with_prefix else None
    ref, _ = j_forward(pair.jparams, pair.jcfg, jnp.asarray(tokens),
                       prefix_embeds=None if prefix is None
                       else jnp.asarray(prefix))
    logits, aux = pair.model(torch.from_numpy(tokens),
                             prefix_embeds=None if prefix is None
                             else torch.from_numpy(prefix))
    P = 0 if prefix is None else pair.cfg.prefix_len
    assert logits.shape == (2, P + 12, pair.cfg.padded_vocab)
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)


def test_prefix_binds(pair):
    """With the prefix, the prefix's positions see each other both ways
    (their logits differ from a causal run over the same embeddings),
    while the text's own attention stays causal."""
    tokens = torch.from_numpy(pair.prompts(1, 6))
    prefix = torch.from_numpy(pair.prefix(1))
    a, _ = pair.model(tokens, prefix_embeds=prefix)
    b, _ = pair.model(tokens[:, :3], prefix_embeds=prefix)
    P = pair.cfg.prefix_len
    torch.testing.assert_close(a[:, :P + 3], b, **TOL)
    assert not torch.allclose(a[:, :P - 1], pair.model(
        tokens[:, :0], prefix_embeds=prefix[:, :P - 1])[0], **TOL)


def test_decode_steps_match(pair):
    tokens = pair.prompts(2, 10, seed=3)
    jcache, cache = pair.jeng.new_cache(2), pair.eng.new_cache(2)
    for t in range(10):
        ref, jcache = pair.jeng._step(pair.jparams, jnp.asarray(tokens[:, t]),
                                      jcache)
        logits, cache = decode_step(pair.model,
                                    torch.from_numpy(tokens[:, t]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    assert cache["length"] == int(jcache["length"]) == 10


def test_greedy_generate_matches(pair):
    prompts = pair.prompts(2, 5, seed=4)
    ref = pair.jeng.generate(jnp.asarray(prompts), 6, temperature=0.0)
    out = pair.eng.generate(torch.from_numpy(prompts), 6, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_full_width_param_count():
    cfg = get_config(ARCH)
    n = count_params(model_defs(cfg))
    assert n == flops.total_params(cfg) == j_count_params(
        j_model_defs(j_get_config(ARCH))) == 2_508_793_856
