"""Parity of repro_torch's RG-LRU layer and the RecurrentGemma model with
the JAX package's, on the CPU.

The port's plain gates (`kernels.rglru_scan.lru_coeffs`) are held against
the JAX package's `_lru_coeffs`, and its doubling scan (`linear_scan`,
what the recurrence runs for CPU tensors) against
`jax.lax.associative_scan` over the same (a, b) pairs, within 1e-5 of the
largest value: both are log-depth trees over the same algebra, combined in
another order, so they round apart by float32 ulps. The kernel on the card
runs the recurrence step after step from each segment's carry instead; its
design (segment, chunk and group composites, the carry folded through the
earlier groups and chunks in a fixed order) is rendered plainly here and
held to this plain
version, and the kernel itself in tests/test_torch_gpu.py (1e-5 of the
largest value as well). The layer (`rglru_apply`) and its
decode step are held against the JAX package's, the step also against the
port's own prefill form. The smoke RecurrentGemma model, JAX weights
carried across by `interop.lm_params_from_arrays`, matches the JAX
`forward` and `decode_step` within rtol/atol 1e-4 over 30 tokens, past its
local window of 16, so that the ring KV cache of the local_attn layer
wraps; and at 5 layers, where `stack_plan` leaves a tail of two layers
after one repeat of the 3-layer pattern.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import SMOKE_REGISTRY as J_SMOKE
from repro.configs import get_config as j_get_config
from repro.models import rglru as jrglru
from repro.models.param import init_params as j_init_params
from repro.models.transformer import forward as j_forward
from repro.models.transformer import model_defs as j_model_defs
from repro.serving.engine import ServeEngine as JServeEngine
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.interop import lm_params_from_arrays
from repro_torch.kernels.rglru_scan import (RGLRUScan, linear_scan,
                                            lru_coeffs, rglru_gate_grads,
                                            rglru_scan, rglru_scan_bwd,
                                            rglru_scan_bwd_ref,
                                            rglru_scan_ref)
from repro_torch.models import (ModelConfig, Transformer, decode_step,
                                stack_plan)
from repro_torch.models import rglru
from repro_torch.serving import ServeEngine

ARCH = "recurrentgemma-2b"
CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)


def close(a, ref, rel=1e-5):
    a, ref = np.asarray(a, np.float64), np.asarray(ref, np.float64)
    assert a.shape == ref.shape
    err = np.abs(a - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.fixture(scope="module")
def layer():
    """The smoke config's RG-LRU layer parameters on both sides, with
    nonzero biases and a spread of lam."""
    jcfg = J_SMOKE[ARCH]
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jp = j_init_params(jrglru.rglru_defs(jcfg), jax.random.PRNGKey(1))
    rng = np.random.default_rng(5)
    for name, scale, shift in (("b_a", 0.5, 0.0), ("b_i", 0.5, 0.0),
                               ("lam", 1.0, 1.0)):
        jp[name] = jnp.asarray(
            scale * rng.standard_normal(jp[name].shape) + shift, jnp.float32)
    p = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, p


def test_lru_coeffs_match_reference(layer):
    jcfg, cfg, jp, p = layer
    u = np.random.default_rng(2).standard_normal(
        (2, 17, cfg.lru_width_)).astype(np.float32)
    a_ref, b_ref = jrglru._lru_coeffs(jp, jnp.asarray(u))
    ut = torch.from_numpy(u)
    a, b = lru_coeffs(ut, ut @ p["w_a"], ut @ p["w_i"], p["b_a"], p["b_i"],
                      p["lam"])
    close(a.numpy(), a_ref)
    close(b.numpy(), b_ref)


@pytest.mark.parametrize("S", [1, 2, 7, 64, 1000])
def test_doubling_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (2, S, 33)).astype(np.float32)
    b = rng.standard_normal((2, S, 33)).astype(np.float32)

    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]
    _, ref = jax.lax.associative_scan(combine, (jnp.asarray(a),
                                                jnp.asarray(b)), axis=1)
    close(linear_scan(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
          ref)


def test_scan_carries_h0():
    """From a state h0 the scan equals the scan of the whole sequence split
    in two, the second part from the first part's last state (the decode
    step's use of h0)."""
    rng = np.random.default_rng(9)
    W = 24
    u, ga, gi = (torch.from_numpy(rng.standard_normal((2, 40, W))
                                  .astype(np.float32)) for _ in range(3))
    b_a, b_i = (torch.from_numpy(rng.standard_normal(W).astype(np.float32))
                for _ in range(2))
    lam = torch.from_numpy(rng.standard_normal(W).astype(np.float32) + 1)
    h = rglru_scan_ref(u, ga, gi, b_a, b_i, lam)
    h1 = rglru_scan_ref(u[:, :25], ga[:, :25], gi[:, :25], b_a, b_i, lam)
    h2 = rglru_scan_ref(u[:, 25:], ga[:, 25:], gi[:, 25:], b_a, b_i, lam,
                        h0=h1[:, -1])
    close(torch.cat([h1, h2], dim=1).numpy(), h.numpy())
    assert torch.equal(rglru_scan(u, ga, gi, b_a, b_i, lam), h)
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan(u, ga, gi, b_a, b_i, lam, impl="cuda")


def chunked_scan(a, bb, h0=None, chunk=64, seg=8, warps=8):
    """h_t = a_t h_{t-1} + bb_t along dim 1 of (B, S, W) in the fold order
    of kernels/rglru_scan/csrc/rglru_scan.cu: time in chunks of `chunk`
    steps, each cut into segments of `seg`; a segment's composite (the
    product of a, and h from a zero start) and the chunk's, its segments
    folded in order; past 64 chunks, groups of G = ceil(sqrt(nch)) chunks
    (else one group of all), a group's composite its chunks' folded in
    order; the carry into chunk k is h0 folded through the list of the
    composites of the groups before the last one and then those of every
    chunk since, as `warps` contiguous ranges (ceil(len / warps) words
    each), each range folded in order, then the ranges in order; a segment
    runs its steps from the chunk's carry folded through the segments
    before it."""
    B, S, W = a.shape
    nch = -(-S // chunk)
    G = nch if nch <= 64 else math.isqrt(nch - 1) + 1

    def fold(pairs, h):
        for pa, ph in pairs:
            h = pa * h + ph
        return h

    def composite(pairs):
        ca, ch = torch.ones((B, W)), torch.zeros((B, W))
        for pa, ph in pairs:
            ch = pa * ch + ph
            ca = ca * pa
        return ca, ch

    segs, comps = [], []
    for k in range(nch):
        s_k = []
        for t0 in range(k * chunk, min(S, (k + 1) * chunk), seg):
            s_k.append(composite([(a[:, t], bb[:, t]) for t in
                                  range(t0, min(S, t0 + seg))]))
        segs.append(s_k)
        comps.append(composite(s_k))
    groups = [composite(comps[g0:g0 + G]) for g0 in range(0, nch, G)]
    out = torch.empty((B, S, W))
    for k in range(nch):
        ng = max(k // G - 1, 0)
        words = groups[:ng] + comps[ng * G:k]
        per = -(-len(words) // warps)
        ranges = [composite(words[j * per:(j + 1) * per])
                  for j in range(warps)]
        carry = fold(ranges, torch.zeros((B, W)) if h0 is None else h0)
        for i, t0 in enumerate(range(k * chunk, min(S, (k + 1) * chunk),
                                     seg)):
            h = fold(segs[k][:i], carry)
            for t in range(t0, min(S, t0 + seg)):
                h = a[:, t] * h + bb[:, t]
                out[:, t] = h
    return out


def rglru_chunked(u, ga, gi, b_a, b_i, lam, h0=None):
    """The one-pass RG-LRU of kernels/rglru_scan/csrc/rglru_scan.cu in plain
    PyTorch, its fold order included: `lru_coeffs` once, then
    `chunked_scan`."""
    return chunked_scan(*lru_coeffs(u, ga, gi, b_a, b_i, lam), h0)


def kernel_order_sum(x, chunk=64, seg=8, warps=8):
    """The backward kernel's sum of x (B, S, W) over B and S: each
    segment's steps from the last, the chunk's segments in order, then the
    B nch chunk sums (b-major) as `warps` contiguous ranges, each in
    order, the ranges in order."""
    B, S, W = x.shape
    nch = -(-S // chunk)
    xp = torch.cat([x, torch.zeros((B, nch * chunk - S, W))], dim=1)
    xp = xp.reshape(B, nch, chunk // seg, seg, W)
    segs = torch.zeros((B, nch, chunk // seg, W))
    for i in reversed(range(seg)):
        segs = segs + xp[:, :, :, i]
    rows = torch.zeros((B, nch, W))
    for j in range(chunk // seg):
        rows = rows + segs[:, :, j]
    rows = rows.reshape(B * nch, W)
    per = -(-rows.shape[0] // warps)
    total = torch.zeros(W)
    for j in range(warps):
        part = torch.zeros(W)
        for r in rows[j * per:(j + 1) * per]:
            part = part + r
        total = total + part
    return total


def rglru_bwd_chunked(u, ga, gi, b_a, b_i, lam, h, dh, h0=None, chunk=64):
    """The RG-LRU backward kernel of csrc/rglru_scan.cu in plain PyTorch:
    the reverse step x -> a_t (x + dh_t) (x the carry a_{t+1} g_{t+1}
    from the later steps) is the forward's kind of affine map, so time is
    padded with identity steps to whole chunks, reversed, and folded by
    `chunked_scan` (chunks taken from the last, segments within a chunk
    from the last); g_t = dh_t + the carry into step t; the gates' chain
    rule elementwise (`rglru_gate_grads`); db_a, db_i and dlam summed in
    the kernel's order (`kernel_order_sum`). The results of
    `rglru_scan_bwd_ref`."""
    a, _ = lru_coeffs(u, ga, gi, b_a, b_i, lam)
    B, S, W = a.shape
    pad = -S % chunk
    ap = torch.cat([a, torch.ones((B, pad, W))], dim=1)
    bp = torch.cat([a * dh, torch.zeros((B, pad, W))], dim=1)
    x_out = chunked_scan(ap.flip(1), bp.flip(1), chunk=chunk).flip(1)
    g = dh + torch.cat([x_out[:, 1:], torch.zeros((B, 1, W))],
                       dim=1)[:, :S]
    du, dga, dgi, dlr, dh0 = rglru_gate_grads(u, ga, gi, b_a, b_i, lam, h,
                                              g, h0)
    dlam = kernel_order_sum(dlr) * 8.0 * torch.sigmoid(-lam)
    return (du, dga, dgi, kernel_order_sum(dga), kernel_order_sum(dgi),
            dlam, dh0)


@pytest.mark.parametrize("S,h0", [(7, True), (64, False), (65, True),
                                  (1000, True), (4096, False),
                                  (8192, True)])
def test_one_pass_fold_order_matches_plain(S, h0):
    """The kernel's design (gates once, segment, chunk and group
    composites, the carry folded through the earlier groups and chunks in
    ranges in a fixed order) is the plain version's recurrence: within
    1e-5 of h's largest value, the kernel tests' tolerance, from one
    segment to 64 chunks (one group) and 128 (11 groups of 12), with h0;
    and
    it equals the plain step-by-step recurrence to the same bound."""
    rng = np.random.default_rng(S)
    W = 24
    u, ga, gi = (torch.from_numpy(rng.standard_normal((2, S, W))
                                  .astype(np.float32)) for _ in range(3))
    b_a, b_i = (torch.from_numpy(0.5 * rng.standard_normal(W)
                                 .astype(np.float32)) for _ in range(2))
    lam = torch.from_numpy(rng.standard_normal(W).astype(np.float32) + 1)
    h0_t = (torch.from_numpy(rng.standard_normal((2, W)).astype(np.float32))
            if h0 else None)
    h = rglru_chunked(u, ga, gi, b_a, b_i, lam, h0_t)
    close(h.numpy(), rglru_scan_ref(u, ga, gi, b_a, b_i, lam, h0_t).numpy())
    a, bb = lru_coeffs(u, ga, gi, b_a, b_i, lam)
    hs = torch.zeros((2, W)) if h0_t is None else h0_t
    seq = torch.empty_like(h)
    for t in range(S):
        hs = a[:, t] * hs + bb[:, t]
        seq[:, t] = hs
    close(h.numpy(), seq.numpy())


def _scan_inputs(rng, B, S, W, dtype=torch.float32, h0=False,
                 clamp=False):
    """Seeded operands of the scan; `clamp` drives the first half of the
    steps to ga + b_a <= -30, where r ~ 0, a rounds to 1 and the clamp of
    m = sqrt(max(1 - a^2, 1e-12)) holds."""
    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.standard_normal(shape))
                                .astype(np.float32))
    u, ga, gi = t(B, S, W).to(dtype), t(B, S, W), t(B, S, W)
    b_a, b_i, lam = t(W, scale=0.5), t(W, scale=0.5), t(W) + 1.0
    if clamp:
        ga[:, :S // 2] = -30.0 - b_a - ga[:, :S // 2].abs()
    return u, ga, gi, b_a, b_i, lam, t(B, W) if h0 else None


def grads_close(got, ref, rel=1e-5, du_rel=None):
    """Each gradient within `rel` of its reference's largest element (du
    within `du_rel` where given: one bf16 rounding of each element)."""
    for n, (a, b) in enumerate(zip(got, ref)):
        if b is None:
            assert a is None
            continue
        assert a.dtype == b.dtype and a.shape == b.shape, n
        close(a.float().numpy(), b.float().numpy(),
              du_rel if n == 0 and du_rel else rel)


@pytest.mark.parametrize("dtype,h0,clamp", [
    (torch.float32, False, False), (torch.float32, True, False),
    (torch.bfloat16, False, False), (torch.bfloat16, True, False),
    (torch.float32, True, True), (torch.bfloat16, False, True)])
def test_scan_bwd_ref_matches_autograd(dtype, h0, clamp):
    """The plain backward (the formulas written out, a reverse doubling
    scan) against torch.autograd of the plain forward, float32 sums in
    another order: every gradient within 1e-5 of its largest element, du
    in bf16 within 1e-2 (one bf16 rounding of each side). Where the clamp
    of m holds its gradient is 0, as autograd's. The autograd Function
    under "ref" returns the same bits, and the dispatch refuses "cuda"
    for CPU tensors."""
    rng = np.random.default_rng(31 + 2 * h0 + clamp)
    args = _scan_inputs(rng, 2, 77, 40, dtype, h0, clamp)
    if clamp:
        a, _ = lru_coeffs(*args[:6])
        assert bool((1.0 - a ** 2 < 1e-12).any())
    leaves = [t.clone().requires_grad_() if t is not None else None
              for t in args]
    h = rglru_scan_ref(*leaves)
    dh = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
    auto = torch.autograd.grad(h, [t for t in leaves if t is not None], dh)
    ref = (*auto, None) if not h0 else auto
    got = rglru_scan_bwd_ref(*args[:6], h.detach(), dh, args[6])
    grads_close(got, ref, du_rel=1e-2 if dtype == torch.bfloat16 else None)
    h2 = RGLRUScan.apply(*leaves, "ref")
    assert torch.equal(h2, h.detach())
    fn = torch.autograd.grad(h2, [t for t in leaves if t is not None], dh)
    assert all(torch.equal(a, b) for a, b in zip(fn, got))
    with pytest.raises(ValueError, match="CUDA"):
        rglru_scan_bwd(*args[:6], h.detach(), dh, args[6], impl="cuda")


@pytest.mark.parametrize("S,h0", [(7, True), (64, False), (200, True),
                                  (4097, False), (8192, True)])
def test_bwd_fold_order_matches_plain(S, h0):
    """The backward kernel's design (the reverse carry folded as the
    forward's, chunks from the last, in groups past 64 chunks; the sums in
    its fixed order) against the plain backward: du, dga, dgi and dh0
    within 1e-5 of their largest elements, the kernel tests' limit, and
    db_a, db_i, dlam within 1e-5 too (the card's limit for them is 1e-4):
    from one segment to 64 chunks (one group), 65 (groups of 9, S = 4097)
    and 128 (groups of 12)."""
    rng = np.random.default_rng(S + 1)
    args = _scan_inputs(rng, 2, S, 24, h0=h0)
    h = rglru_scan_ref(*args)
    dh = torch.from_numpy(rng.standard_normal(h.shape).astype(np.float32))
    grads_close(rglru_bwd_chunked(*args[:6], h, dh, args[6]),
                rglru_scan_bwd_ref(*args[:6], h, dh, args[6]))


def _jax_scan_loss(jp, u, dh):
    """sum(h dh) of the JAX package's recurrence over the conv output u."""
    def combine(l, r):
        return l[0] * r[0], r[0] * l[1] + r[1]
    _, h = jax.lax.associative_scan(combine, jrglru._lru_coeffs(jp, u),
                                    axis=1)
    return jnp.sum(h * dh)


def test_scan_grads_match_jax(layer):
    """The recurrence with its gradient (`RGLRUScan` under "ref", the gate
    products by autograd) against jax.grad of the JAX package's
    `_lru_coeffs` and associative scan: the gradients of u, w_a, w_i,
    b_a, b_i and lam within 1e-5 of their largest elements."""
    jcfg, cfg, jp, p = layer
    rng = np.random.default_rng(8)
    u = rng.standard_normal((2, 45, cfg.lru_width_)).astype(np.float32)
    dh = rng.standard_normal(u.shape).astype(np.float32)
    names = ("w_a", "w_i", "b_a", "b_i", "lam")
    jg = jax.jit(jax.grad(
        lambda uu, q: _jax_scan_loss(dict(jp, **q), uu, dh),
        argnums=(0, 1)))(jnp.asarray(u), {k: jp[k] for k in names})
    ut = torch.from_numpy(u).requires_grad_()
    q = {k: p[k].clone().requires_grad_() for k in names}
    h = RGLRUScan.apply(ut, ut @ q["w_a"], ut @ q["w_i"], q["b_a"],
                        q["b_i"], q["lam"], None, "ref")
    got = torch.autograd.grad(h, [ut, *q.values()],
                              torch.from_numpy(dh))
    close(got[0].numpy(), jg[0])
    for k, g in zip(names, got[1:]):
        close(g.numpy(), jg[1][k])


def test_rglru_apply_grads_match_jax(layer):
    """Every gradient of the layer (its nine parameters and the input x)
    against jax.grad of the JAX package's `rglru_apply`, on the same
    seeded inputs and output gradient: within 2e-5 of each one's largest
    element (GRAD_TOL of tests/test_torch_training.py)."""
    jcfg, cfg, jp, p = layer
    rng = np.random.default_rng(9)
    x = rng.standard_normal((2, 33, cfg.d_model)).astype(np.float32)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    jgx, jgp = jax.jit(jax.grad(
        lambda xx, q: jnp.sum(jrglru.rglru_apply(q, xx, jcfg) * dy),
        argnums=(0, 1)))(jnp.asarray(x), jp)
    xt = torch.from_numpy(x).requires_grad_()
    q = {k: v.clone().requires_grad_() for k, v in p.items()}
    y = rglru.rglru_apply(q, xt, cfg)
    got = torch.autograd.grad(y, [xt, *q.values()], torch.from_numpy(dy))
    close(got[0].numpy(), jgx, 2e-5)
    assert set(q) == set(jgp)
    for k, g in zip(q, got[1:]):
        close(g.numpy(), jgp[k], 2e-5)


def test_rglru_apply_matches_reference(layer):
    jcfg, cfg, jp, p = layer
    x = np.random.default_rng(6).standard_normal(
        (2, 21, cfg.d_model)).astype(np.float32)
    ref = jrglru.rglru_apply(jp, jnp.asarray(x), jcfg)
    out = rglru.rglru_apply(p, torch.from_numpy(x), cfg)
    close(out.numpy(), ref)


def test_rglru_step_matches_reference(layer):
    """rglru_step token by token against the JAX step and against the
    port's prefill form over the same sequence."""
    jcfg, cfg, jp, p = layer
    x = np.random.default_rng(7).standard_normal(
        (2, 13, cfg.d_model)).astype(np.float32)
    jcache = jrglru.rglru_init_cache(jcfg, 2, jnp.float32)
    cache = rglru.rglru_init_cache(cfg, 2, torch.float32, CPU)
    outs = []
    for t in range(x.shape[1]):
        ref, jcache = jrglru.rglru_step(jp, jnp.asarray(x[:, t:t + 1]),
                                        jcache, jcfg)
        out, cache = rglru.rglru_step(p, torch.from_numpy(x[:, t:t + 1]),
                                      cache, cfg)
        close(out.numpy(), ref)
        outs.append(out)
    close(cache.h.numpy(), jcache.h)
    full = rglru.rglru_apply(p, torch.from_numpy(x), cfg)
    close(torch.cat(outs, dim=1).numpy(), full.numpy())


def test_configs_copied():
    assert dataclasses.asdict(get_config(ARCH)) == \
        dataclasses.asdict(j_get_config(ARCH))
    assert dataclasses.asdict(get_smoke_config(ARCH)) == \
        dataclasses.asdict(J_SMOKE[ARCH])
    cfg = get_config(ARCH)
    assert cfg.layer_kinds().count("rglru") == 18
    assert cfg.layer_kinds().count("local_attn") == 8
    plan = stack_plan(cfg, cfg.n_layers, cfg.first_dense_layers)
    assert (plan.head, plan.repeats, plan.tail) == ((), 8, (24, 25))


class Pair:
    """A smoke RecurrentGemma on both sides over the same float32
    weights."""

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
def pairs():
    cache = {}

    def get(n_layers):
        if n_layers not in cache:
            jcfg = J_SMOKE[ARCH]
            if n_layers != jcfg.n_layers:
                jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
            cache[n_layers] = Pair(jcfg)
        return cache[n_layers]
    return get


@pytest.mark.parametrize("n_layers", [3, 5], ids=["smoke", "tail"])
def test_forward_matches(pairs, n_layers):
    pr = pairs(n_layers)
    plan = stack_plan(pr.cfg, n_layers, 0)
    assert len(plan.tail) == n_layers % 3
    tokens = pr.tokens(2, 30, 1)
    ref, _ = j_forward(pr.jparams, pr.jcfg, jnp.asarray(tokens))
    logits, aux = pr.model(torch.from_numpy(tokens))
    assert float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n_layers", [3, 5], ids=["smoke", "tail"])
def test_decode_steps_match(pairs, n_layers):
    """decode_step against the JAX package's for 30 steps, past the local
    window of 16: the local_attn layers' ring of 16 slots wraps, holding
    positions 14..29 at the end; the last step also against the
    forward's last position."""
    pr = pairs(n_layers)
    tokens = pr.tokens(2, 30, 2)
    jeng = JServeEngine(pr.jcfg, pr.jparams, max_len=40)
    eng = ServeEngine(pr.cfg, pr.model, max_len=40, device=CPU)
    jcache, cache = jeng.new_cache(2), eng.new_cache(2)
    for t in range(tokens.shape[1]):
        ref, jcache = jeng._step(pr.jparams, jnp.asarray(tokens[:, t]),
                                 jcache)
        logits, cache = decode_step(pr.model,
                                    torch.from_numpy(tokens[:, t]), cache)
        np.testing.assert_allclose(logits.numpy(), np.asarray(ref), **TOL,
                                   err_msg=f"step {t}")
    fwd, _ = pr.model(torch.from_numpy(tokens))
    np.testing.assert_allclose(logits.numpy(), fwd[:, -1].numpy(), **TOL)
    window = pr.cfg.local_window
    for kind, layer in zip(pr.cfg.layer_kinds(), cache["layers"]):
        if kind == "local_attn":
            assert layer["k"].shape[2] == window
            assert sorted(layer["slot_pos"].tolist()) == \
                list(range(30 - window, 30))
            assert layer["slot_pos"][29 % window] == 29
        else:
            assert set(layer) == {"h", "conv"}


def test_generate_matches(pairs):
    pr = pairs(3)
    prompts = pr.tokens(2, 10, 3)
    jeng = JServeEngine(pr.jcfg, pr.jparams, max_len=32)
    eng = ServeEngine(pr.cfg, pr.model, max_len=32, device=CPU)
    ref = np.asarray(jeng.generate(jnp.asarray(prompts), 12,
                                   temperature=0.0))
    out = eng.generate(torch.from_numpy(prompts), 12, temperature=0.0)
    np.testing.assert_array_equal(out.numpy(), ref)
