"""Parity of repro_torch's dense-decoder inference with the JAX package's,
on the CPU, over the four dense smoke configs.

The JAX package's parameters (`init_params(PRNGKey(0))`) are carried across
by `interop.lm_params_from_arrays`, so both sides run the same weights in
float32. Checked: the prefill forward's logits, a 12-token run of
`decode_step`, `ServeEngine.prefill` and greedy `generate`, all within
rtol/atol 1e-4 (summation order differs; the port's attention is the plain
version of the CUDA kernel on the CPU). A bfloat16 case checks top-1
agreement of the forward, and the parameter count of the full-width Yi-6B
is held to the JAX package's from shapes alone.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.configs import get_config as j_get_config
from repro.models.attention import decode_attn as j_decode_attn
from repro.models.param import count_params as j_count_params
from repro.models.param import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_defs as j_model_defs
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.models import (ModelConfig, Transformer, count_params,
                                decode_step, model_defs)
from repro_torch.models.attention import decode_attn
from repro_torch.serving import ServeEngine

ARCHS = ["yi-6b", "smollm-360m", "qwen1.5-4b", "minitron-4b"]
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)
MAX_LEN = 32


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


class Pair:
    """One smoke config on both sides: the JAX params and engine, and the
    port's model and engine over the same weights."""

    def __init__(self, arch, jcfg=None):
        self.jcfg = jcfg or J_SMOKE[arch]
        self.cfg = ModelConfig(**dataclasses.asdict(self.jcfg))
        self.jparams = j_init_params(j_model_defs(self.jcfg),
                                     jax.random.PRNGKey(0))
        self.model = Transformer(
            self.cfg, lm_params_from_arrays(self.cfg,
                                            _numpy_tree(self.jparams)),
            device=CPU)
        self.jeng = JServeEngine(self.jcfg, self.jparams, max_len=MAX_LEN)
        self.eng = ServeEngine(self.cfg, self.model, max_len=MAX_LEN,
                               device=CPU)
        jcfg_ = self.jcfg
        self.jfwd = jax.jit(lambda p, t: j_forward(p, jcfg_, t)[0])

    def prompts(self, B, S, seed=1):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def pairs():
    cache = {}

    def get(arch):
        if arch not in cache:
            cache[arch] = Pair(arch)
        return cache[arch]
    return get


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_config_copied(arch):
    assert dataclasses.asdict(get_smoke_config(arch)) == \
        dataclasses.asdict(J_SMOKE[arch])
    assert dataclasses.asdict(get_config(arch)) == \
        dataclasses.asdict(j_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches(pairs, arch):
    pr = pairs(arch)
    tokens = pr.prompts(2, 12)
    ref = np.asarray(pr.jfwd(pr.jparams, jnp.asarray(tokens)))
    logits, aux = pr.model(torch.from_numpy(tokens))
    assert logits.shape == ref.shape and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), ref, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_match(pairs, arch):
    pr = pairs(arch)
    tokens = pr.prompts(2, 12, seed=2)
    jcache = pr.jeng.new_cache(2)
    cache = pr.eng.new_cache(2)
    for t in range(12):
        ref, jcache = pr.jeng._step(pr.jparams, jnp.asarray(tokens[:, t]),
                                    jcache)
        logits, cache = decode_step(pr.model, torch.from_numpy(tokens[:, t]),
                                    cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    assert cache["length"] == int(jcache["length"]) == 12


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_matches(pairs, arch):
    pr = pairs(arch)
    prompts = pr.prompts(2, 6)
    ref, _ = pr.jeng.prefill(jnp.asarray(prompts))
    logits, cache = pr.eng.prefill(torch.from_numpy(prompts))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    # the reference's invariant: prefill is decode-by-construction, its
    # logits equal the forward's last position
    fwd, _ = pr.model(torch.from_numpy(prompts))
    np.testing.assert_allclose(logits.numpy(), fwd[:, -1].numpy(), **TOL)
    assert cache["length"] == 6


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches(pairs, arch):
    pr = pairs(arch)
    prompts = pr.prompts(2, 5, seed=3)
    ref = pr.jeng.generate(jnp.asarray(prompts), 8, temperature=0.0)
    out = pr.eng.generate(torch.from_numpy(prompts), 8, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sampled_generate_respects_vocab(pairs):
    pr = pairs("smollm-360m")
    cfg = dataclasses.replace(pr.cfg, vocab_size=500)     # pads to 512
    eng = ServeEngine(cfg, pr.model, max_len=MAX_LEN, device=CPU)
    prompts = torch.from_numpy(pr.prompts(3, 4))
    a = eng.generate(prompts, 10, temperature=1.0, seed=7)
    b = eng.generate(prompts, 10, temperature=1.0, seed=7)
    assert a.shape == (3, 10) and torch.equal(a, b)
    assert int(a.min()) >= 0 and int(a.max()) < 500


def test_bf16_forward_top1():
    """bf16 rounds at other places in the two frameworks, and at a vocab
    of 512 the reference's top two logits are often equal in bf16. So the
    port's top-1 token must be a top-1 token of the reference up to one
    bf16 spacing at every position, and the very same token wherever the
    reference's margin exceeds two spacings; the logits agree within 3e-2
    of their scale."""
    jcfg = dataclasses.replace(J_SMOKE["yi-6b"], param_dtype="bfloat16",
                               compute_dtype="bfloat16")
    pr = Pair("yi-6b", jcfg)
    assert pr.model.embed["tok"].dtype == torch.bfloat16
    tokens = pr.prompts(2, 16, seed=5)
    ref = np.asarray(pr.jfwd(pr.jparams, jnp.asarray(tokens)), np.float32)
    logits = pr.model(torch.from_numpy(tokens))[0].float().numpy()
    top = ref.max(-1)
    spacing = 2.0 ** (np.floor(np.log2(np.abs(top))) - 7)
    pick = np.take_along_axis(ref, logits.argmax(-1)[..., None], -1)[..., 0]
    assert np.all(top - pick <= spacing)
    margin = top - np.sort(ref, -1)[..., -2]
    sure = margin > 2 * spacing
    assert sure.mean() > 0.5
    np.testing.assert_array_equal(logits.argmax(-1)[sure],
                                  ref.argmax(-1)[sure])
    assert np.abs(logits - ref).max() <= 3e-2 * np.abs(ref).max()


def test_yi_6b_param_count():
    n = count_params(model_defs(get_config("yi-6b")))
    assert n == j_count_params(j_model_defs(j_get_config("yi-6b")))
    assert n == 6_061_035_520


@pytest.mark.parametrize("window", [None, 5])
def test_decode_attn_matches(window):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((2, 4, 1, 16)).astype(np.float32)
    kc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    vc = rng.standard_normal((2, 2, 12, 16)).astype(np.float32)
    ref = j_decode_attn(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                        cache_len=jnp.asarray(9), window=window)
    out = decode_attn(*(torch.from_numpy(a) for a in (q, kc, vc)),
                      cache_len=9, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_interop_refuses_mismatched_trees(pairs):
    pr = pairs("yi-6b")
    tree = _numpy_tree(pr.jparams)
    extra = dict(tree, extra=np.zeros(3))
    with pytest.raises(KeyError, match="left over"):
        lm_params_from_arrays(pr.cfg, extra)
    embed = dict(tree["embed"])
    del embed["out"]
    with pytest.raises(KeyError, match="embed/out"):
        lm_params_from_arrays(pr.cfg, dict(tree, embed=embed))
    bad = dict(tree, final_norm=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="final_norm"):
        lm_params_from_arrays(pr.cfg, bad)


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "mamba2-2.7b",
                                  "recurrentgemma-2b", "deepseek-v3-671b",
                                  "whisper-base", "paligemma-3b"])
def test_unported_archs_raise(arch):
    with pytest.raises(KeyError, match="ROADMAP"):
        get_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(J_SMOKE[arch]))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Transformer(cfg, device=CPU)


def test_full_kv_cache_raises(pairs):
    """The two packages part at a full KV cache, so parity stays inside
    max_len. The port raises at position >= t_max and leaves the cache as
    it was; the JAX package's dynamic_update_slice clamps the write into
    the last slot, overwriting position t_max - 1 with position t_max."""
    pr = pairs("smollm-360m")
    t_max = 6
    jeng = JServeEngine(pr.jcfg, pr.jparams, max_len=t_max)
    eng = ServeEngine(pr.cfg, pr.model, max_len=t_max, device=CPU)
    tokens = pr.prompts(2, t_max + 1, seed=4)
    jcache, cache = jeng.new_cache(2), eng.new_cache(2)
    for t in range(t_max):
        ref, jcache = jeng._step(pr.jparams, jnp.asarray(tokens[:, t]),
                                 jcache)
        logits, cache = decode_step(pr.model, torch.from_numpy(tokens[:, t]),
                                    cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    keys = [layer["k"].clone() for layer in cache["layers"]]
    with pytest.raises(ValueError, match="KV cache full"):
        decode_step(pr.model, torch.from_numpy(tokens[:, t_max]), cache)
    assert cache["length"] == t_max
    for layer, k in zip(cache["layers"], keys):
        assert torch.equal(layer["k"], k)
        assert layer["slot_pos"].tolist() == list(range(t_max))
    _, jcache = jeng._step(pr.jparams, jnp.asarray(tokens[:, t_max]), jcache)
    assert int(jcache["length"]) == t_max + 1
    # (stacked layers, t_max) slot positions: the last slot now holds t_max
    slot_pos = np.asarray(jcache["stack"]["pos0"]["slot_pos"])
    assert (slot_pos[:, -1] == t_max).all()
    assert (slot_pos[:, :-1] == np.arange(t_max - 1)).all()
