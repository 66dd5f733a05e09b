"""The SSD scan's gradient in the port against the JAX package's, on the
CPU.

The JAX package takes the gradient of `_ssd_scan` (repro/models/ssm.py)
by XLA's autodiff; the port writes it out in closed form
(`kernels.ssd_scan.ssd_scan_bwd_ref`, the plain version of its backward
kernel) and runs it through the autograd Function `SSDScan`. Held here,
on the same seeded numpy inputs in float32:

  * the plain backward against `jax.vjp` of `_ssd_scan`, with cotangents
    on y and on the final state, at the smoke shapes, S below the chunk,
    a ragged S % Q, several chunks and head counts of 3, 12 and 81: each
    gradient within 2e-5 of its largest element (training's GRAD_TOL);
  * with an initial state, which the JAX function lacks, against
    torch.autograd through the plain forward `ssd_scan_ref`;
  * `SSDScan.apply(..., "ref")`: the plain backward's gradients, and no
    dh0 without h0;
  * one `ssd_apply` layer's parameter and input gradients against
    `jax.grad` of the JAX package's `ssd_apply`.
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
from repro_torch.kernels.ssd_scan import (SSDScan, ssd_scan_bwd,
                                          ssd_scan_bwd_ref, ssd_scan_ref)
from repro_torch.models import ModelConfig
from repro_torch.models import ssm

GRAD_TOL = 2e-5
GRADS = ("dx", "db", "dc", "ddt", "da_log", "dh0")
# (B, S, H, P, N, chunk): the smoke shapes, S below the chunk, a ragged
# S % Q, several chunks, a P, N, Q off the kernel's tiles, and the head
# counts that the bf16 kernel's head groups and pieces of 16 heads do not
# divide (3, 12, 81) with ragged last chunks (5, 6 and 8 steps). The
# chunks stay short enough that cum stays above -88 inside one: past
# that, exp of the masked upper triangle's cum_t - cum_s overflows in the
# JAX function and its autodiff gives ddt NaN (0 x inf through the where),
# at (1, 300, 4, 16, 16, 64) for one; the closed form never forms it.
SHAPES = [(2, 21, 8, 16, 16, 8), (2, 5, 4, 16, 16, 8), (2, 37, 3, 8, 8, 16),
          (1, 96, 4, 16, 16, 16), (2, 37, 3, 40, 100, 16),
          (2, 45, 3, 16, 24, 20), (1, 70, 12, 16, 16, 32),
          (1, 40, 81, 8, 8, 16)]
IDS = ["smoke", "below_chunk", "ragged", "chunks", "off_tiles", "heads_3",
       "heads_12", "heads_81"]


def scan_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    b = (0.3 * rng.standard_normal((B, S, N))).astype(np.float32)
    c = (0.3 * rng.standard_normal((B, S, N))).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)) - 1.0)).astype(
        np.float32)
    a_log = (0.5 * rng.standard_normal(H)).astype(np.float32)
    return x, b, c, dt, a_log


def cotangents(rng, B, S, H, P, N):
    return (rng.standard_normal((B, S, H, P)).astype(np.float32),
            rng.standard_normal((B, H, P, N)).astype(np.float32))


def assert_close(name, got, ref, tol=GRAD_TOL):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, name
    err, scale = np.abs(got - ref).max(), np.abs(ref).max()
    assert err <= tol * scale, (name, err, scale)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES, ids=IDS)
@pytest.mark.parametrize("d_last", [False, True], ids=["dy", "dy_dh_last"])
def test_bwd_ref_matches_jax_vjp(B, S, H, P, N, chunk, d_last):
    """dx, db, dc, ddt and da_log of the plain backward against jax.vjp of
    the JAX package's `_ssd_scan`, the cotangent on y alone and with one
    on the final state."""
    rng = np.random.default_rng(S + H + N)
    args = scan_inputs(rng, B, S, H, P, N)
    dy, dh = cotangents(rng, B, S, H, P, N)
    dh = dh if d_last else np.zeros_like(dh)
    _, vjp = jax.vjp(lambda *a: jssm._ssd_scan(*a, chunk),
                     *(jnp.asarray(a) for a in args))
    ref = vjp((jnp.asarray(dy), jnp.asarray(dh)))
    got = ssd_scan_bwd_ref(*(torch.from_numpy(a) for a in args), chunk,
                           torch.from_numpy(dy),
                           torch.from_numpy(dh) if d_last else None)
    assert got[5] is None
    for name, g, r in zip(GRADS, got, ref):
        assert_close(name, g.numpy(), r)


@pytest.mark.parametrize("B,S,H,P,N,chunk", SHAPES, ids=IDS)
def test_bwd_ref_with_h0_matches_autograd(B, S, H, P, N, chunk):
    """From an initial state (the JAX function starts from zero): every
    gradient, dh0 among them, against torch.autograd through the plain
    forward."""
    rng = np.random.default_rng(S + 2 * H)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, B, S, H, P, N)]
    h0 = torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32))
    dy, dh = (torch.from_numpy(a) for a in cotangents(rng, B, S, H, P, N))
    leaves = [t.clone().requires_grad_() for t in args + [h0]]
    y, h = ssd_scan_ref(*leaves[:5], chunk, h0=leaves[5])
    ref = torch.autograd.grad((y * dy).sum() + (h * dh).sum(), leaves)
    got = ssd_scan_bwd_ref(*args, chunk, dy, dh, h0)
    for name, g, r in zip(GRADS, got, ref):
        assert_close(name, g, r)


@pytest.mark.parametrize("h0", [False, True], ids=["no_h0", "h0"])
@pytest.mark.parametrize("use_h", [False, True], ids=["y", "y_and_h"])
def test_autograd_function_gives_plain_backward(h0, use_h):
    """SSDScan.apply(..., "ref") returns the plain forward's results and
    backpropagates the plain backward's gradients, bit for bit; a final
    state left unused passes no gradient, and without h0 there is none to
    give."""
    B, S, H, P, N, chunk = 2, 21, 8, 16, 16, 8
    rng = np.random.default_rng(9)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, B, S, H, P, N)]
    state = (torch.from_numpy(rng.standard_normal((B, H, P, N)).astype(
        np.float32)) if h0 else None)
    dy, dh = (torch.from_numpy(a) for a in cotangents(rng, B, S, H, P, N))
    leaves = [t.clone().requires_grad_() for t in args]
    s_leaf = None if state is None else state.clone().requires_grad_()
    y, h = SSDScan.apply(*leaves, s_leaf, chunk, "ref")
    yr, hr = ssd_scan_ref(*args, chunk, h0=state)
    assert torch.equal(y, yr) and torch.equal(h, hr)
    loss = (y * dy).sum() + ((h * dh).sum() if use_h else 0.0)
    wrt = leaves + ([s_leaf] if h0 else [])
    got = torch.autograd.grad(loss, wrt)
    ref = ssd_scan_bwd(*args, chunk, dy, dh if use_h else None, state,
                       impl="ref")
    assert (ref[5] is None) == (not h0)
    for name, g, r in zip(GRADS, got, ref):
        assert torch.equal(g, r), name


@pytest.fixture(scope="module")
def layer():
    """The smoke config's SSD layer parameters on both sides, with nonzero
    norm, bias and decay parameters."""
    jcfg = J_SMOKE["mamba2-2.7b"]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = j_init_params(jssm.ssd_defs(jcfg), jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    for name in ("norm", "dt_bias", "a_log"):
        jp[name] = jnp.asarray(0.3 * rng.standard_normal(jp[name].shape),
                               jp[name].dtype)
    return jcfg, cfg, jp


@pytest.mark.parametrize("S", [21, 5], ids=["ragged", "below_chunk"])
def test_ssd_apply_grads_match_jax(layer, S):
    """The gradient of sum(ssd_apply(x) * w) for every parameter and for x,
    through SSDScan and its plain backward, against jax.grad of the JAX
    package's ssd_apply."""
    jcfg, cfg, jp = layer
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    w = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    jgp, jgx = jax.grad(
        lambda p, xx: jnp.sum(jssm.ssd_apply(p, xx, jcfg) * w),
        argnums=(0, 1))(jp, jnp.asarray(x))
    p = {k: torch.from_numpy(np.array(v)).requires_grad_()
         for k, v in jp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    out = ssm.ssd_apply(p, xt, cfg)
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                                [xt, *p.values()])
    assert_close("x", grads[0].numpy(), jgx)
    for (name, _), g in zip(p.items(), grads[1:]):
        assert_close(name, g.numpy(), jgp[name])
