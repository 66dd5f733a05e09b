"""Parity of repro_torch's multi-head latent attention (DeepSeek-V3) with
the JAX package's, on the CPU.

The plain flash version is held against `flash_attn_jnp`, the JAX model
path's attention, with a value head dim of its own (Dk != Dv: MLA's
dn + dr over dv), over the JAX package's own cases of
tests/test_kernels_attention.py (S = T, ragged, a window, a prefix, cross
attention at S != T) and at MLA's widths. `mla_attention` and
`mla_decode` are held against the JAX package's on the smoke config's
weights; the DeepSeek-V3 smoke model's forward and decode steps (its
latent cache, also two steps past t_max, where the write clamps into the
last slot) against the JAX package's, its parameters carried across by
`interop.lm_params_from_arrays`; the full configs' parameter counts
against the JAX package's, from shapes alone. Tolerances: 2e-5 for
attention alone (summation order differs) and `TOL` (1e-4) through a
model, in float32.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.analysis import flops as j_flops
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
from repro_torch.kernels.flash_attention import (attention,
                                                 flash_attention_ref,
                                                 kernel_lane)
from repro_torch.models import (ModelConfig, Transformer, count_params,
                                decode_step, model_defs)
from repro_torch.models.attention import mla_attention, mla_decode, mla_defs
from repro_torch.serving import ServeEngine

ARCH = "deepseek-v3-671b"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def rand_qkv(rng, B, H, Hkv, S, T, Dk, Dv):
    return (rng.standard_normal((B, H, S, Dk)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, Dk)).astype(np.float32),
            rng.standard_normal((B, Hkv, T, Dv)).astype(np.float32))


# tests/test_kernels_attention.py's test_jnp_flash_vs_naive cases, with a
# value head dim of 16 under a key head dim of 32
@pytest.mark.parametrize("S,T,cq,ck,causal,window,prefix", [
    (64, 64, 16, 16, True, None, 0),
    (40, 40, 16, 16, True, None, 0),          # non-divisible padding
    (64, 64, 16, 16, True, 24, 0),            # sliding window
    (64, 64, 16, 16, True, None, 8),          # prefix-LM
    (32, 96, 16, 32, False, None, 0),         # cross attention
])
def test_plain_dv_matches_model_path(S, T, cq, ck, causal, window, prefix):
    rng = np.random.default_rng(S * T + 16)
    q, k, v = rand_qkv(rng, 2, 4, 2, S, T, 32, 16)
    ref = flash_attn_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window, prefix_len=prefix,
                         chunk_q=cq, chunk_k=ck)
    out = attention(*(torch.from_numpy(a) for a in (q, k, v)),
                    causal=causal, window=window, prefix_len=prefix)
    assert tuple(out.shape) == (2, 4, S, 16)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("S,T,Dk,Dv,causal", [
    (40, 40, 192, 128, True),                 # MLA's widths, ragged
    (37, 53, 192, 128, True),                 # causal S < T, top-left
    (53, 37, 24, 16, True),                   # causal S > T, smoke widths
    (33, 70, 24, 16, False),
])
def test_plain_mla_widths_match_model_path(S, T, Dk, Dv, causal):
    """MLA's (192, 128) and its smoke config's (24, 16), S != T and
    lengths that are no multiple of the chunks, at MLA's scale
    (Dk ** -0.5, passed as mla_attention passes it)."""
    rng = np.random.default_rng(S + T + Dk)
    q, k, v = rand_qkv(rng, 1, 4, 4, S, T, Dk, Dv)
    ref = flash_attn_jnp(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, scale=Dk ** -0.5, chunk_q=16,
                         chunk_k=16)
    out = flash_attention_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=causal, scale=Dk ** -0.5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


@pytest.mark.parametrize("dtype,dk,dv,lane", [
    (torch.bfloat16, 192, 128, "wgmma"),      # DeepSeek-V3 at full width
    (torch.float32, 192, 128, "f32"),
    (torch.bfloat16, 24, 16, "f32"),          # its smoke config
    (torch.bfloat16, 128, 64, "f32"),         # no tensor-core pair
    (torch.bfloat16, 192, 192, "f32"),
    (torch.bfloat16, 256, None, "wgmma"),     # v_head_dim defaults to Dk
])
def test_kernel_lane_by_head_dim_pair(dtype, dk, dv, lane):
    assert kernel_lane(dtype, dk, dv) == lane


def _numpy_tree(params):
    return jax.tree_util.tree_map(np.asarray, params)


def _torch_tree(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.fixture(scope="module")
def mla_layer():
    """The smoke config and one MLA layer's parameters from the JAX
    package's init, as JAX and as torch trees."""
    jcfg = J_SMOKE[ARCH]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = j_init_params(j_attention.mla_defs(jcfg), jax.random.PRNGKey(3))
    # the norms' init is zeros: move them off it so that they count
    rng = np.random.default_rng(4)
    jp = dict(jp, **{k: jnp.asarray(0.1 * rng.standard_normal(
        jp[k].shape), jnp.float32) for k in ("q_norm", "kv_norm")})
    return jcfg, cfg, jp, _torch_tree(_numpy_tree(jp))


def test_mla_defs_match(mla_layer):
    jcfg, cfg, jp, p = mla_layer
    defs = mla_defs(cfg)
    assert list(defs) == list(j_attention.mla_defs(jcfg))
    assert {k: d.shape for k, d in defs.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}


def test_mla_attention_matches(mla_layer):
    jcfg, cfg, jp, p = mla_layer
    x = np.random.default_rng(5).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    ref = j_attention.mla_attention(jp, jnp.asarray(x), jcfg,
                                    positions=jnp.arange(21))
    out = mla_attention(p, torch.from_numpy(x), cfg,
                        positions=torch.arange(21))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("length", [1, 7, 12, 14])
def test_mla_decode_matches(mla_layer, length):
    """One absorbed-matrix step over a latent cache of 12 slots partly
    filled (length - 1 earlier tokens), full, and past it (the write
    clamps into the last slot): the output and both caches as the JAX
    package's."""
    jcfg, cfg, jp, p = mla_layer
    rng = np.random.default_rng(length)
    B, T = 2, 12
    x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
    c = rng.standard_normal((B, T, cfg.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((B, T, cfg.qk_rope_dim)).astype(np.float32)
    ref, jc, jkr = j_attention.mla_decode(
        jp, jnp.asarray(x), jcfg, c_cache=jnp.asarray(c),
        kr_cache=jnp.asarray(kr), cache_len=jnp.asarray(length),
        position=jnp.asarray([length - 1]))
    tc, tkr = torch.from_numpy(c.copy()), torch.from_numpy(kr.copy())
    out = mla_decode(p, torch.from_numpy(x), cfg, c_cache=tc, kr_cache=tkr,
                     length=length)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tkr.numpy(), np.asarray(jkr), **TOL)


class Pair:
    """The DeepSeek-V3 smoke config on both sides over the same weights."""

    def __init__(self, max_len):
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


@pytest.fixture(scope="module")
def pair():
    return Pair(max_len=6)


def test_config_copied():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(J_SMOKE[ARCH])


def test_interop_carries_mla_keys(pair):
    """The MLA keys, the dense head layer and the stacked MoE layers land
    where the JAX package's stack_plan put them."""
    cfg, jp = pair.cfg, pair.jparams
    head = pair.model.layers[0]
    assert head.moe is None and head.mlp is not None
    assert all(layer.moe is not None for layer in pair.model.layers[1:])
    assert sorted(head.attn) == sorted(j_attention.mla_defs(pair.jcfg))
    np.testing.assert_array_equal(
        head.attn["w_ukv"].numpy(),
        np.asarray(jp["decoder"]["head"]["layer0"]["attn"]["w_ukv"]))
    for r in range(cfg.n_layers - cfg.first_dense_layers):
        np.testing.assert_array_equal(
            pair.model.layers[1 + r].attn["w_kr"].numpy(),
            np.asarray(jp["decoder"]["stack"]["pos0"]["attn"]["w_kr"][r]))


def test_forward_matches(pair):
    tokens = pair.prompts(2, 16)     # one MoE group of 32 tokens
    ref, ref_aux = j_forward(pair.jparams, pair.jcfg, jnp.asarray(tokens))
    logits, aux = pair.model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)
    assert float(aux) == pytest.approx(float(ref_aux), rel=1e-5)


def test_decode_steps_match_past_t_max(pair):
    """Eight decode steps through a latent cache of t_max = 6 slots: the
    last two write into slot 5, as the JAX package's clamped
    dynamic_update_slice does; logits within TOL at every step."""
    t_max = pair.eng.max_len
    tokens = pair.prompts(2, t_max + 2, seed=2)
    jcache, cache = pair.jeng.new_cache(2), pair.eng.new_cache(2)
    for t in range(t_max + 2):
        ref, jcache = pair.jeng._step(pair.jparams, jnp.asarray(tokens[:, t]),
                                      jcache)
        logits, cache = decode_step(pair.model,
                                    torch.from_numpy(tokens[:, t]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    assert cache["length"] == int(jcache["length"]) == t_max + 2
    layer0 = cache["layers"][0]
    assert tuple(layer0["c"].shape) == (2, t_max, pair.cfg.kv_lora_rank)
    np.testing.assert_allclose(
        layer0["c"].numpy(), np.asarray(jcache["head"]["layer0"]["c"]),
        **TOL)


def test_prefill_and_generate_match(pair):
    eng = ServeEngine(pair.cfg, pair.model, max_len=16, device=CPU)
    jeng = JServeEngine(pair.jcfg, pair.jparams, max_len=16)
    prompts = pair.prompts(2, 5, seed=3)
    last, _ = eng.prefill(torch.from_numpy(prompts))
    fwd, _ = pair.model(torch.from_numpy(prompts))
    np.testing.assert_allclose(last.numpy(), fwd[:, -1].numpy(), **TOL)
    ref = jeng.generate(jnp.asarray(prompts), 6, temperature=0.0)
    out = eng.generate(torch.from_numpy(prompts), 6, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_full_width_param_counts():
    """DeepSeek-V3 in full (61 layers) and cut to the 4 layers the card
    holds, counted from shapes alone: the JAX package's totals, and its
    active count (routed and shared experts at top_k / n_experts)."""
    cfg = get_config(ARCH)
    n = count_params(model_defs(cfg))
    assert n == flops.total_params(cfg) == 671_026_404_352
    jcfg = j_get_config(ARCH)
    assert n == j_count_params(j_model_defs(jcfg))
    assert flops.active_params(cfg) == j_flops.active_params(jcfg)
    cut = dataclasses.replace(cfg, n_layers=4)
    assert flops.total_params(cut) == j_flops.total_params(
        dataclasses.replace(jcfg, n_layers=4)) == 15_111_101_440
    one = dataclasses.replace(cfg, n_layers=1, first_dense_layers=1)
    assert flops.total_params(one) == 2_436_848_640
