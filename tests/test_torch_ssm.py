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

The CUDA kernel's design is held here too, rendered plainly: its split of
the scan into chunk states, the carry and y (with its panel-wise W) against
`ssd_scan_ref`, and, at Mamba2-2.7B's chunk shapes, its bf16 path's TF32
split, emulated by rounding float32 to TF32 by its bits as `cvt.rna`
does, within the GPU tests' 1e-4, and its float32 path (float32 products,
W unfactored) within 1e-5.

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


# ---------------------------------------------------------------------------
# the CUDA kernel's algebra and numerics, rendered plainly on the CPU
# ---------------------------------------------------------------------------
def tf32_rna(v: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits) by its bits, to nearest
    with ties away from zero, as `cvt.rna.tf32.f32` does: add half of the
    13 dropped bits' unit to the magnitude, then clear them."""
    bits = v.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_matmul(a, b, exact_a=False, exact_b=False):
    """a @ b as the kernel's tensor cores form it: each float32 operand
    split into TF32 hi and lo (lo = the rounding of a - hi), a product of
    two split operands hi.lo' + lo.hi' + hi.hi' (lo.lo' dropped), one with
    a bf16 operand (exact in TF32) two products. The products are exact
    and summed in float64, then rounded to float32: what is held here is
    the split's own error."""
    def parts(m, exact):
        hi = m.float() if exact else tf32_rna(m)
        lo = torch.zeros_like(hi) if exact else tf32_rna(m.float() - hi)
        return hi.double(), lo.double()
    ah, al = parts(a, exact_a)
    bh, bl = parts(b, exact_b)
    return (al @ bh + ah @ bl + ah @ bh).float()


def f32_matmul(a, b, exact_a=False, exact_b=False):
    return a.float() @ b.float()


def ssd_chunk_parallel(x, b, c, dt, a_log, chunk, h0=None, mm=f32_matmul,
                       exact=False, panel=32, factored=True):
    """The chunk-parallel SSD of kernels/ssd_scan/csrc/ssd_scan.cu in plain
    PyTorch, on the CPU: (a) C B^T of each chunk, shared by the heads;
    (b) each chunk's own state from zero, s_c = (x tail)^T @ B; (c) the
    carry over the chunks in order, h_c = exp(cum_last) h_{c-1} + s_c,
    leaving each chunk's incoming state; (d) y = exp(cum) (C @ h_in^T)
    + W @ x, with W formed panel by panel as the kernel stores it: per
    element exp(cum_t - cum_s) dt_s in a panel's diagonal block, and below
    it, where dt >= 0, exp(cum_t - cum_piv) times exp(cum_piv - cum_s)
    dt_s, piv the panel's last real step (`factored`; the kernel's float32
    path forms every element unfactored). `mm` forms the products (plain
    float32 or `split_matmul`); `exact`: x, b, c hold bf16 values, not
    split. Shapes and results those of `ssd_scan_ref`, in float32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    Q = min(chunk, S)
    nc = -(-S // Q)
    A = -torch.exp(a_log.float())
    h = (torch.zeros((B, H, P, N)) if h0 is None else h0.float()).clone()
    y = torch.zeros((B, S, H, P))
    mono = factored and bool((dt >= 0).all())
    states, cums = [], []
    for ci in range(nc):                     # (b): independent of the carry
        sl = slice(ci * Q, min(S, (ci + 1) * Q))
        cum = torch.cumsum(dt[:, sl].float() * A, dim=1)      # (B, qc, H)
        tail = torch.exp(cum[:, -1:] - cum) * dt[:, sl]
        xw = x[:, sl].float() * tail[..., None]                # (B, qc, H, P)
        st = torch.stack([torch.stack(
            [mm(xw[bi, :, hh].T, b[bi, sl], exact_b=exact)
             for hh in range(H)]) for bi in range(B)])         # (B, H, P, N)
        states.append(st)
        cums.append(cum)
    h_in = []
    for ci in range(nc):                     # (c): the only sequential part
        h_in.append(h.clone())
        h = h * torch.exp(cums[ci][:, -1])[:, :, None, None] + states[ci]
    for ci in range(nc):                     # (d)
        sl = slice(ci * Q, min(S, (ci + 1) * Q))
        qc = sl.stop - sl.start
        cum, dtc = cums[ci], dt[:, sl].float()
        for bi in range(B):
            cb = mm(c[bi, sl], b[bi, sl].T, exact_a=exact, exact_b=exact)
            for hh in range(H):
                cm = cum[bi, :, hh]
                w = torch.zeros((qc, qc))
                for s0 in range(0, qc, panel):
                    piv = min(s0 + panel, qc) - 1
                    cols = torch.arange(s0, piv + 1)
                    for t in range(s0, qc):
                        if mono and t > piv:
                            w[t, cols] = cb[t, cols] * torch.exp(
                                cm[t] - cm[piv]) * (torch.exp(
                                    cm[piv] - cm[cols]) * dtc[bi, cols, hh])
                        else:
                            s_ok = cols[cols <= t]
                            w[t, s_ok] = cb[t, s_ok] * torch.exp(
                                cm[t] - cm[s_ok]) * dtc[bi, s_ok, hh]
                inter = mm(c[bi, sl], h_in[ci][bi, hh].T, exact_a=exact)
                y[bi, sl, hh] = (inter * torch.exp(cm)[:, None]
                                 + mm(w, x[bi, sl, hh], exact_b=exact))
    return y, h


@pytest.mark.parametrize("S,chunk,h0", [(21, 8, False), (37, 16, True),
                                        (70, 32, True)],
                         ids=["smoke", "ragged_h0", "panels"])
def test_chunk_parallel_algebra_matches_plain(S, chunk, h0):
    """The kernel's split of the scan (chunk states from zero, the carry,
    then y from each chunk's incoming state, W panel by panel with the
    factored exp below each panel's diagonal block) is the plain
    version's function: float32 products, held to `ssd_scan_ref` within
    1e-5 of y's and the state's largest value, at the smoke shapes (P = N
    = 16), ragged S, several chunks and panels, with h0."""
    rng = np.random.default_rng(S)
    args = [torch.from_numpy(a) for a in scan_inputs(rng, 2, S, 3, 16, 16)]
    h0_t = (torch.from_numpy(rng.standard_normal((2, 3, 16, 16))
                             .astype(np.float32)) if h0 else None)
    y, h = ssd_chunk_parallel(*args, chunk, h0_t, panel=8)
    yr, hr = ssd_scan_ref(*args, chunk, h0_t)
    close(y.numpy(), yr.numpy())
    close(h.numpy(), hr.numpy())


def test_tf32_rna_rounds_like_cvt():
    """tf32_rna keeps 10 mantissa bits, rounding to nearest with ties away
    from zero, for both signs."""
    one = 1.0 + 2.0 ** -10                   # representable in TF32
    half = 2.0 ** -11                        # half a TF32 unit at 1
    v = torch.tensor([1.0, one, 1.0 + half, -(1.0 + half), 1.0 + half / 2,
                      1.0 + 3 * half], dtype=torch.float32)
    want = torch.tensor([1.0, one, one, -one, 1.0, 1.0 + 2 ** -9],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(v), want)
    w = torch.from_numpy(np.random.default_rng(0).standard_normal(1000)
                         .astype(np.float32))
    r = tf32_rna(w)
    assert bool(((r.view(torch.int32) & 0x1FFF) == 0).all())
    assert float(((r - w).abs() / w.abs()).max()) <= 2.0 ** -11


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tf32_split_holds_the_kernel_tolerance(dtype):
    """The kernel's products at Mamba2-2.7B's chunk shapes (Q = 256,
    P = 64, N = 128; 2 heads, 2 chunks with a ragged one, h0), held to the
    plain float32 version on the same (bf16-valued, for bf16) inputs. bf16
    x, b, c: the kernel's algebra with every product formed as
    `split_matmul` (2 TF32 products with a bf16 operand, 1 for bf16 C B^T)
    within 1e-4 of y's and the state's largest value, the GPU tests'
    tolerance. float32: the kernel's CUDA-core path, float32 products and
    W formed unfactored, within 1e-5. In both, a single unsplit TF32
    product misses 1e-4."""
    rng = np.random.default_rng(7)
    x, b, c, dt, a_log = (torch.from_numpy(a) for a in
                          scan_inputs(rng, 1, 256 + 37, 2, 64, 128))
    if dtype == "bfloat16":
        x, b, c = (t.bfloat16().float() for t in (x, b, c))
    h0 = torch.from_numpy(rng.standard_normal((1, 2, 64, 128))
                          .astype(np.float32))
    exact = dtype == "bfloat16"
    yr, hr = ssd_scan_ref(x, b, c, dt, a_log, 256, h0)
    if exact:
        y, h = ssd_chunk_parallel(x, b, c, dt, a_log, 256, h0,
                                  mm=split_matmul, exact=True)
    else:
        y, h = ssd_chunk_parallel(x, b, c, dt, a_log, 256, h0,
                                  factored=False)
    ey = float((y - yr).abs().max() / yr.abs().max())
    eh = float((h - hr).abs().max() / hr.abs().max())
    tol = 1e-4 if exact else 1e-5
    assert ey <= tol and eh <= tol, (ey, eh)

    def tf32_matmul(a, b, exact_a=False, exact_b=False):
        return (tf32_rna(a).double() @ tf32_rna(b).double()).float()
    y1, h1 = ssd_chunk_parallel(x, b, c, dt, a_log, 256, h0, mm=tf32_matmul)
    e1 = max(float((y1 - yr).abs().max() / yr.abs().max()),
             float((h1 - hr).abs().max() / hr.abs().max()))
    assert e1 > 1e-4 > 10 * max(ey, eh), (e1, ey, eh)


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
