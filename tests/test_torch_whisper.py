"""Parity of repro_torch's encoder-decoder (Whisper-base's backbone) with
the JAX package's, on the CPU.

The Whisper smoke config runs on both sides over the same weights (the
JAX package's `init_params(PRNGKey(0))`, carried across by
`interop.lm_params_from_arrays`, its encoder stack and each decoder
layer's cross block included), in float32. Checked: the encoder's output
against the JAX package's encoder stack; the forward with frame
embeddings against `forward`; `cross_attention` of one layer against
`_cross_attention`; decode with the cross cache (built once by
`init_cache` from the encoder's output) against the JAX package's
`decode_step` over several steps, through `ServeEngine` with frame
embeddings and with its default zero frames; greedy generation; the full
config's parameter count against the JAX package's. Tolerance `TOL` (1e-4)
through a model: summation order differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.configs import get_config as j_get_config
from repro.models.blocks import rmsnorm as j_rmsnorm
from repro.models.param import count_params as j_count_params
from repro.models.param import init_params as j_init_params
from repro.models.transformer import _cross_attention as j_cross_attention
from repro.models.transformer import _run_stack as j_run_stack
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_defs as j_model_defs
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.analysis import flops
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import (ModelConfig, Transformer, count_params,
                                decode_step, init_cache, model_defs)
from repro_torch.models.attention import cross_attention
from repro_torch.serving import ServeEngine

ARCH = "whisper-base"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
S_ENC = 24


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


class Pair:
    """The Whisper smoke config on both sides over the same weights."""

    def __init__(self):
        self.jcfg = J_SMOKE[ARCH]
        self.cfg = ModelConfig(**dataclasses.asdict(self.jcfg))
        self.jparams = j_init_params(j_model_defs(self.jcfg),
                                     jax.random.PRNGKey(0))
        self.model = Transformer(
            self.cfg, lm_params_from_arrays(self.cfg,
                                            _numpy_tree(self.jparams)),
            device=CPU)

    def prompts(self, B, S, seed=1):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)

    def frames(self, B, S=S_ENC, seed=2):
        return np.random.default_rng(seed).standard_normal(
            (B, S, self.cfg.d_model)).astype(np.float32)

    def j_encode(self, frames):
        e, _ = j_run_stack(self.jparams["encoder"], jnp.asarray(frames),
                           self.jcfg, self.jcfg.n_enc_layers, 0,
                           positions=jnp.arange(frames.shape[1]),
                           causal=False)
        return j_rmsnorm(e, self.jparams["enc_norm"], self.jcfg.norm_eps)


@pytest.fixture(scope="module")
def pair():
    return Pair()


def test_config_copied_and_counted():
    """Whisper resolves in the port, equal to the JAX package's config
    field for field (full and smoke), and the full config's parameters
    count as the JAX package counts them: 70,664,192."""
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(J_SMOKE[ARCH])
    cfg = get_config(ARCH)
    assert count_params(model_defs(cfg)) == flops.total_params(cfg) == \
        j_count_params(j_model_defs(j_get_config(ARCH))) == 70_664_192
    assert cfg.padded_vocab == 51_968


def test_encoder_matches(pair):
    frames = pair.frames(2)
    ref = pair.j_encode(frames)
    out = pair.model.encode(torch.from_numpy(frames))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_cross_attention_matches(pair):
    """One decoder layer's cross block: q from 11 decoder rows, k and v
    from 24 encoder frames, not causal."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 11, pair.cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, S_ENC, pair.cfg.d_model)).astype(
        np.float32)
    jp = {k: v[0] for k, v in
          pair.jparams["decoder"]["stack"]["pos0"]["cross"].items()}
    ref = j_cross_attention(jp, jnp.asarray(x), jnp.asarray(enc),
                            pair.jcfg)
    out = cross_attention(pair.model.layers[0].cross, torch.from_numpy(x),
                          torch.from_numpy(enc), pair.cfg)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("B,S,S_enc", [(2, 12, S_ENC), (1, 7, 40)])
def test_forward_matches(pair, B, S, S_enc):
    tokens = pair.prompts(B, S)
    frames = pair.frames(B, S_enc)
    ref, jaux = j_forward(pair.jparams, pair.jcfg, jnp.asarray(tokens),
                          enc_inputs=jnp.asarray(frames))
    logits, aux = pair.model(torch.from_numpy(tokens),
                             enc_inputs=torch.from_numpy(frames))
    assert logits.shape == (B, S, pair.cfg.padded_vocab)
    assert float(aux) == float(jaux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)


def test_forward_needs_frames(pair):
    with pytest.raises(ValueError, match="enc_inputs"):
        pair.model(torch.from_numpy(pair.prompts(1, 4)))
    with pytest.raises(ValueError, match="enc_out"):
        init_cache(pair.cfg, 1, 8, device=CPU)


@pytest.mark.parametrize("with_frames", [True, False])
def test_decode_steps_match(pair, with_frames):
    """decode_step over 10 steps with the cross cache, through both
    engines: with frame embeddings (one row per request) and with the
    engines' default zero frames (one row broadcast over the batch)."""
    frames = pair.frames(2) if with_frames else None
    jeng = JServeEngine(pair.jcfg, pair.jparams, max_len=16,
                        enc_inputs=None if frames is None
                        else jnp.asarray(frames))
    eng = ServeEngine(pair.cfg, pair.model, max_len=16, device=CPU,
                      enc_inputs=None if frames is None
                      else torch.from_numpy(frames))
    np.testing.assert_allclose(eng.enc_out.numpy(),
                               np.asarray(jeng.enc_out), **TOL)
    tokens = pair.prompts(2, 10, seed=3)
    jcache, cache = jeng.new_cache(2), eng.new_cache(2)
    assert len(cache["cross"]) == pair.cfg.n_layers
    k0 = cache["cross"][0]["k"].clone()
    for t in range(10):
        ref, jcache = jeng._step(pair.jparams, jnp.asarray(tokens[:, t]),
                                 jcache)
        logits, cache = decode_step(pair.model,
                                    torch.from_numpy(tokens[:, t]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    assert torch.equal(cache["cross"][0]["k"], k0)  # never updated


def test_decode_matches_forward(pair):
    """The decode path at every position equals the forward over the same
    frames (the port against itself, both in float32)."""
    tokens = pair.prompts(2, 9, seed=4)
    frames = pair.frames(2, seed=6)
    fwd, _ = pair.model(torch.from_numpy(tokens),
                        enc_inputs=torch.from_numpy(frames))
    eng = ServeEngine(pair.cfg, pair.model, max_len=16, device=CPU,
                      enc_inputs=torch.from_numpy(frames))
    cache = eng.new_cache(2)
    for t in range(9):
        logits, cache = decode_step(pair.model,
                                    torch.from_numpy(tokens[:, t]), cache)
        torch.testing.assert_close(logits, fwd[:, t], **TOL)


def test_greedy_generate_matches(pair):
    frames = pair.frames(2, seed=7)
    jeng = JServeEngine(pair.jcfg, pair.jparams, max_len=24,
                        enc_inputs=jnp.asarray(frames))
    eng = ServeEngine(pair.cfg, pair.model, max_len=24, device=CPU,
                      enc_inputs=torch.from_numpy(frames))
    prompts = pair.prompts(2, 4, seed=8)
    ref = jeng.generate(jnp.asarray(prompts), 8, temperature=0.0)
    out = eng.generate(torch.from_numpy(prompts), 8, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
