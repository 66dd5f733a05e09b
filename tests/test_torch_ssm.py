"""Parity of repro_torch's Mamba-2 SSD layer and the Mamba2 model with the
JAX package's, on the CPU.

The port's plain SSD scan (`kernels.ssd_scan.ssd_scan_ref`, what the
scan runs for CPU tensors) is held against the JAX package's `_ssd_scan`
in float32 at S a multiple of the chunk, S ragged and S below the chunk,
y and the final state within 1e-5 of their largest value (summation order
differs: XLA's einsums against PyTorch's). The layer (`ssd_apply`) is
held against the JAX package's on the same parameters, and `ssd_step`,
token by token, against both the JAX step and the port's own prefill
form. The smoke Mamba2 model, JAX weights carried across by
`interop.lm_params_from_arrays`, matches the JAX `forward` and
`decode_step` within rtol/atol 1e-4 over a ragged 21-token sequence.

One departure from the JAX package, pinned here: the port's decode step
moves the state through the scan (at S = 1, from the cached state; the
kernel on the card) where the JAX package writes the one-step update out,
h decay + dt x B^T then C . h. The two are the same function in float32
and agree within 1e-5 (`test_ssd_step_matches_reference`).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.models import ssm as jssm
from repro.models.param import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_defs as j_model_defs
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.kernels.ssd_scan import ssd_scan, ssd_scan_ref
from repro_torch.models import ModelConfig, Transformer, decode_step
from repro_torch.models import ssm
from repro_torch.serving import ServeEngine

ARCH = "mamba2-2.7b"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def scan_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, S, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((B, S, N))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(
        np.float32)
    a_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    return x, b, c, dt, a_log


def close(a, ref, rel=1e-5):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    err = np.abs(a - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("S,chunk", [(32, 8), (21, 8), (5, 8), (300, 64)],
                         ids=["multiple", "ragged", "below_chunk", "long"])
def test_ssd_scan_matches_reference(S, chunk):
    rng = np.random.default_rng(S)
    args = scan_inputs(rng, 2, S, 4, 16, 16)
    y_ref, h_ref = jssm._ssd_scan(*(jnp.asarray(a) for a in args), chunk)
    y, h = ssd_scan_ref(*(torch.from_numpy(a) for a in args), chunk)
    close(y.numpy(), y_ref)
    close(h.numpy(), h_ref)


def test_ssd_scan_carries_h0():
    """The scan from a state equals the scan of the whole sequence split
    in two, the second half started from the first half's final state
    (the decode step's use of h0)."""
    rng = np.random.default_rng(3)
    x, b, c, dt, a_log = (torch.from_numpy(a)
                          for a in scan_inputs(rng, 2, 40, 4, 16, 16))
    y, h = ssd_scan_ref(x, b, c, dt, a_log, 8)
    y1, h1 = ssd_scan_ref(x[:, :24], b[:, :24], c[:, :24], dt[:, :24],
                          a_log, 8)
    y2, h2 = ssd_scan_ref(x[:, 24:], b[:, 24:], c[:, 24:], dt[:, 24:],
                          a_log, 8, h0=h1)
    close(torch.cat([y1, y2], dim=1).numpy(), y.numpy())
    close(h2.numpy(), h.numpy())


def test_ssd_scan_dispatch_on_cpu():
    rng = np.random.default_rng(4)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, 1, 9, 2, 8, 8)]
    y, h = ssd_scan(*args, 4)
    yr, hr = ssd_scan_ref(*args, 4)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_scan(*args, 4, impl="cuda")


@pytest.fixture(scope="module")
def layer():
    """The smoke config's SSD layer parameters on both sides."""
    jcfg = J_SMOKE[ARCH]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    defs = jssm.ssd_defs(jcfg)
    jp = j_init_params(defs, jax.random.PRNGKey(1))
    # nonzero norm, bias and decay parameters, so that they are exercised
    rng = np.random.default_rng(5)
    for name in ("norm", "dt_bias", "a_log"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape),
                               jp[name].dtype)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def test_ssd_apply_matches_reference(layer):
    jcfg, cfg, jp, p = layer
    x = np.random.default_rng(6).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    ref = jssm.ssd_apply(jp, jnp.asarray(x), jcfg)
    out = ssm.ssd_apply(p, torch.from_numpy(x), cfg)
    close(out.numpy(), ref)


def test_ssd_step_matches_reference(layer):
    """ssd_step token by token against the JAX step (same caches) and
    against the port's prefill form over the same sequence."""
    jcfg, cfg, jp, p = layer
    x = np.random.default_rng(7).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    jcache = jssm.ssd_init_cache(jcfg, 2, jnp.float32)
    cache = ssm.ssd_init_cache(cfg, 2, torch.float32, CPU)
    outs = []
    for t in range(x.shape[1]):
        ref, jcache = jssm.ssd_step(jp, jnp.asarray(x[:, t:t + 1]), jcache,
                                    jcfg)
        out, cache = ssm.ssd_step(p, torch.from_numpy(x[:, t:t + 1]),
                                  cache, cfg)
        close(out.numpy(), ref)
        outs.append(out)
    close(cache.h.numpy(), jcache.h)
    full = ssm.ssd_apply(p, torch.from_numpy(x), cfg)
    close(torch.cat(outs, dim=1).numpy(), full.numpy())


def test_configs_copied():
    from repro.configs import get_config as j_get_config
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(J_SMOKE[ARCH])
    cfg = get_config(ARCH)
    assert (cfg.d_inner, cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state,
            cfg.ssm_chunk, cfg.d_ff) == (5120, 80, 64, 128, 256, 0)


class Pair:
    """The smoke model on both sides over the same float32 weights."""

    def __init__(self, jcfg):
        self.jcfg = jcfg
        self.cfg = ModelConfig(**dataclasses.asdict(jcfg))
        self.jparams = j_init_params(j_model_defs(jcfg),
                                     jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, self.jparams)
        self.model = Transformer(self.cfg,
                                 lm_params_from_arrays(self.cfg, tree),
                                 device=CPU)

    def tokens(self, B, S, seed):
        return np.random.default_rng(seed).integers(
            0, self.cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.fixture(scope="module")
def pair():
    return Pair(J_SMOKE[ARCH])


def test_forward_matches(pair):
    tokens = pair.tokens(2, 21, 1)
    ref, _ = j_forward(pair.jparams, pair.jcfg, jnp.asarray(tokens))
    logits, aux = pair.model(torch.from_numpy(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)


def test_decode_steps_match(pair):
    """decode_step against the JAX package's, step by step, and the last
    step against the forward's last position."""
    tokens = pair.tokens(2, 21, 2)
    jeng = JServeEngine(pair.jcfg, pair.jparams, max_len=32)
    eng = ServeEngine(pair.cfg, pair.model, max_len=32, device=CPU)
    jcache, cache = jeng.new_cache(2), eng.new_cache(2)
    for t in range(tokens.shape[1]):
        ref, jcache = jeng._step(pair.jparams, jnp.asarray(tokens[:, t]),
                                 jcache)
        logits, cache = decode_step(pair.model,
                                    torch.from_numpy(tokens[:, t]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    fwd, _ = pair.model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), fwd[:, -1].numpy(), **TOL)
    assert set(cache["layers"][0]) == {"h", "conv_x", "conv_b", "conv_c"}


def test_generate_matches(pair):
    prompts = pair.tokens(2, 6, 3)
    jeng = JServeEngine(pair.jcfg, pair.jparams, max_len=32)
    eng = ServeEngine(pair.cfg, pair.model, max_len=32, device=CPU)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), 8,
                                   temperature=0.0))
    out = eng.generate(torch.from_numpy(prompts), 8, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), ref)
